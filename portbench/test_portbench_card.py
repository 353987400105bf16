"""On the card: the program's study, through the fleet_route kernel, equal
bit for bit to the plain reference at a cut size, and the bfloat16
control unequal to it.  Skips without a CUDA device; run on the card
with ``python -m pytest portbench -q -m cuda``."""

import pytest
import torch

from portbench._cut import cut
from portbench.drivers import fleet_study
from portbench.reference import fleet as ref

CELLS = ("rack10k-bp-study", "rack10k-po2-study", "fattree8k-bp-study")
SEED = 2**31 + 13


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_card_study_equals_the_reference(card, name):
    cell = cut(name, horizon=80, warmup=20)
    work = fleet_study.prepare(cell, SEED, card)
    got = work.call()
    want = work.reference()
    assert ref.compare(got, want) == 0
    control = work.reference(dtype=torch.bfloat16)
    assert ref.compare(control, want) > 0

"""The analyzer's count of a train step (`launch.steps.build_train_step`:
forward, backward with remat, gradient sums, AdamW) on ``meta`` equals
its count on CPU tensors, for each of the ten architectures' smoke
configs: flops, bytes, launches by op and peak live bytes, the
microbatch loop folded on both (tests/test_torch_hlo.py holds the fold
against the unfolded count)."""

import pytest

from repro_torch.configs import registry, runtime
from repro_torch.configs.shapes import RunShape
from repro_torch.launch import steps
from repro_torch.utils import hlo
from test_torch_hlo import batch_on, counts, state_on
from _torch_port import single_torch_thread  # noqa: F401


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_train_counts_the_same_on_meta_and_cpu(arch):
    cfg = registry.get_smoke_config(arch)
    plan = runtime.plan_for(cfg, "train_4k", "train")
    shape = RunShape("train", "train", 24, 4)
    got = {}
    for dev in ("meta", "cpu"):
        fn, _, _ = steps.build_train_step(cfg, plan, 4, 24, device=dev)
        got[dev] = counts(hlo.analyze(fn, state_on(cfg, plan, dev),
                                      batch_on(cfg, shape, dev),
                                      fold_loops=True))
    assert got["meta"] == got["cpu"]
    assert got["meta"][0] > 0

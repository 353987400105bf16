"""The port's two training examples on the CPU: `train_100m`'s model is
the reference script's (the same parameter count), its `main` runs 2
steps at seq 32 and batch 2 through `run` (on the same layout cut to 2
layers of width 64: a step of the 109.5M-parameter model takes about
16 s here, most of it in AdamW's float64 multiply-adds), and ``--mesh``
takes only one card's 1x1; `elastic_restart` passes its assert."""

import dataclasses

import pytest

from repro.models import config as rconfig
from repro_torch.examples import elastic_restart, train_100m
from repro_torch.models.config import LayerSpec, param_count, uniform_stages
from _torch_port import single_torch_thread  # noqa: F401


def test_train_100m_model_is_the_reference_scripts():
    cfg = train_100m.model_config()
    theirs = rconfig.ModelConfig(
        name="lm-100m", family="dense", d_model=768, num_heads=12,
        num_kv_heads=12, head_dim=64, d_ff=2048, vocab_size=32_000,
        stages=rconfig.uniform_stages(12, rconfig.LayerSpec(kind="attn")),
        tie_embeddings=True, dtype="float32")
    assert param_count(cfg) == rconfig.param_count(theirs) == 109_529_856
    assert (cfg.num_layers, cfg.d_model, cfg.dtype) == (12, 768, "float32")


def test_train_100m_runs_two_steps(monkeypatch, tmp_path, capsys):
    small = dataclasses.replace(
        train_100m.model_config(), d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512,
        stages=uniform_stages(2, LayerSpec(kind="attn")))
    monkeypatch.setattr(train_100m, "model_config", lambda: small)
    monkeypatch.chdir(tmp_path)
    hist = train_100m.main(["--steps", "2", "--seq-len", "32",
                            "--global-batch", "2"], device="cpu")
    assert [h["step"] for h in hist] == [1]
    out = capsys.readouterr().out
    assert "final loss" in out and "experiments/train_100m_ckpt_torch" in out


@pytest.mark.parametrize("mesh", ("2x1", "1x2", "4x4"))
def test_train_100m_mesh_is_one_card(mesh):
    assert train_100m.parse_mesh("1x1") == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="one card"):
        train_100m.main(["--mesh", mesh], device="cpu")


def test_elastic_restart_passes_its_assert(capsys):
    h1, h2 = elastic_restart.main([], device="cpu")
    out = capsys.readouterr().out
    assert out.rstrip().endswith("elastic restart OK")
    assert "replanned mesh (2, 2) axes ('data', 'model')" in out
    assert "restored step 6" in out
    assert h2[0]["step"] == 7 and h2[-1]["loss"] < h1[0]["loss"]

"""The port's dry run (`launch.dryrun`) against the reference's counts:
the CLI on gemma3-1b decode_32k ends with ``done; 0 failures`` and its
JSON holds the reference's `param_count` and `active_param_count`, the
reference's `abstract_caches` bytes and the reference's model FLOPs
(`model_flops` + `attention_flops`, as its `run_cell` adds them);
gemma3-1b long_500k is skipped with the reference's reason.  The
reference's `launch.dryrun` is not imported: it sets ``XLA_FLAGS`` when
imported."""

import json
import os
import subprocess
import sys

import jax
import numpy as np

from repro.configs import registry as rregistry
from repro.configs.shapes import SHAPES as RSHAPES, applicable as rapplicable
from repro.models import transformer as RT
from repro.models.config import active_param_count, param_count
from repro.utils import roofline as rrl
from repro_torch.launch import dryrun
from repro_torch.utils import roofline as rl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_decode_cell_holds_the_reference_counts(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma3_1b", "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("done; 0 failures")
    r = json.loads((tmp_path / "gemma3_1b__decode_32k.json").read_text())
    cfg = rregistry.get_config("gemma3_1b")
    shape = RSHAPES["decode_32k"]
    assert r["status"] == "ok" and r["mesh"] == "1xH100"
    assert r["params_total"] == param_count(cfg)
    assert r["params_active"] == active_param_count(cfg)
    caches = RT.abstract_caches(cfg, shape.global_batch, shape.seq_len,
                                enc_len=cfg.num_audio_frames)
    cache_b = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                  for x in jax.tree.leaves(caches))
    assert cache_b == 18_729_140_224   # 18.73 GB
    assert dryrun.cache_bytes(dryrun.registry.get_config("gemma3_1b"),
                              dryrun.SHAPES["decode_32k"]) == cache_b
    roof = r["roofline"]
    attn = rrl.attention_flops("serve", cfg, shape.seq_len,
                               shape.global_batch, decode=True)
    assert roof["model_flops_per_device"] == rrl.model_flops(
        "serve", active_param_count(cfg), shape.global_batch, attn)
    assert roof["model_bytes_per_device"] == (
        2.0 * param_count(cfg) + cache_b
        + 2.0 * shape.global_batch * cfg.d_model * 2)
    assert set(roof) == set(rrl.Roofline(1.0, 1.0, 0.0).as_dict())
    assert roof["collective_s"] == 0.0
    mem = r["memory"]
    assert mem["argument_bytes"] >= 2 * param_count(cfg) + cache_b
    assert mem["peak_bytes_per_device"] == (mem["argument_bytes"]
                                            + mem["temp_bytes"])
    assert mem["fits_80gb"] == (mem["peak_bytes_per_device"]
                                <= rl.HBM_PER_CARD)
    assert r["ops"]["flops"] > 0 and r["ops"]["launches"] > 0
    assert r["effective_kv_heads"] is None


def test_long_decode_of_full_attention_is_skipped():
    r = dryrun.run_cell("gemma3_1b", "long_500k")
    cfg = rregistry.get_config("gemma3_1b")
    assert r["status"] == "skipped"
    assert r["reason"] == rapplicable(cfg, RSHAPES["long_500k"])
    assert "SKIP" in dryrun.fmt_row(r)

"""Dry run of the port on one H100: build every (architecture x input
shape) step on the ``meta`` device (no memory, no work), count it op by
op, and reckon its memory and roofline against one NVIDIA H100 80GB
(counterpart of `repro.launch.dryrun`, whose cells are TPU meshes).

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
          --shape all --out experiments/dryrun_torch

For each cell of `configs.shapes.SHAPES` the port's own builders give
the step: `build_train_step` for a train shape (its microbatch loop
counted once and multiplied, `utils.hlo.trips`), `build_prefill_step`
for a prefill (the kernel route: `ops.flash_attention` and `ops.ssd`
count their kernels' cost on ``meta``) and `build_serve_step` for a
decode.  The step runs once under `utils.hlo.OpCounter`, and one JSON a
cell records the parameters, the memory (arguments: parameters, AdamW
state for a train step, caches and batch; temporaries: the counter's
peak live bytes), the counted flops, bytes and launches, and the
`utils.roofline.Roofline` with the reference's model FLOPs and model
bytes.  Every number is reckoned from shapes for the H100's published
rates, not measured; `chip_smoke.py` holds two decode cells and two
prefills against the card.

A cell `configs.shapes.applicable` rules out is skipped with its reason;
a cell that raises is ``FAILED`` with its traceback, and the run exits
1.  Where the reference compiles for a 16 x 16 or 2 x 16 x 16 mesh
(``--mesh``), the port has one card (`launch.mesh.single_card_mesh`):
the mesh is ``1xH100`` and the collective term 0.  The reference's
``lower_cell`` (lower and compile for the mesh) has no counterpart:
`build_cell` builds the step on ``meta``.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import registry, runtime
from repro_torch.configs.shapes import SHAPES, RunShape, applicable
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer as T
from repro_torch.models.config import (ModelConfig, active_param_count,
                                       param_count)
from repro_torch.utils import hlo
from repro_torch.utils import roofline as rl

MESH = "1xH100"
CARD = "NVIDIA H100 80GB HBM3 (SXM), published peak rates at 700 W"


def _tree_bytes(tree) -> int:
    """Bytes of every tensor in a tree of dicts, tuples and tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return 0
    return sum(_tree_bytes(x) for x in tree)


def _meta_batch(specs) -> dict:
    return {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
            for k, s in specs.items()}


def cache_bytes(cfg: ModelConfig, shape: RunShape) -> int:
    """Global cache bytes of a decode cell (k + v + pos + states, read
    once a step; the reference's `_tree_bytes_for`)."""
    return _tree_bytes(T.abstract_caches(cfg, shape.global_batch,
                                         shape.seq_len,
                                         enc_len=cfg.num_audio_frames))


def build_cell(cfg: ModelConfig, shape: RunShape, plan):
    """(step, args, fold_loops) of one cell: the port's step for
    `shape.kind` on ``meta`` and its arguments there, empty tensors of
    the abstract shapes."""
    b, t = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        fn, astate, abatch = steps_lib.build_train_step(cfg, plan, b, t,
                                                         device="meta")
        return fn, (astate, _meta_batch(abatch)), True
    build = (steps_lib.build_prefill_step if shape.kind == "prefill"
             else steps_lib.build_serve_step)
    fn, (aparams, acaches, abatch) = build(cfg, plan, b, t, device="meta")
    return fn, (aparams, acaches, _meta_batch(abatch)), False


def model_terms(cfg: ModelConfig, shape: RunShape):
    """(model FLOPs, model bytes) of a cell, the reference's formulas:
    6ND (train) or 2ND plus attention FLOPs; parameters read once (three
    times to train), caches once, the activation stream."""
    n_active = active_param_count(cfg)
    b, t = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = b * t
        attn = rl.attention_flops("train", cfg, t, b)
    elif shape.kind == "prefill":
        tokens = b * t
        attn = rl.attention_flops("serve", cfg, t, b)
    else:
        tokens = b  # one token per sequence
        attn = rl.attention_flops("serve", cfg, t, b, decode=True)
    mflops = rl.model_flops("train" if shape.kind == "train" else "serve",
                            n_active, tokens, attn)
    p_bytes = 2.0 * param_count(cfg)
    act_stream = 2.0 * tokens * cfg.d_model * max(cfg.num_layers, 1) * 2
    if shape.kind == "train":
        mbytes = 3.0 * p_bytes + 2.0 * act_stream
    elif shape.kind == "prefill":
        mbytes = p_bytes + act_stream
    else:
        mbytes = p_bytes + cache_bytes(cfg, shape) + 2.0 * tokens \
            * cfg.d_model * 2
    return mflops, mbytes


def run_shape(cfg: ModelConfig, shape: RunShape) -> dict:
    """The core of a cell: count `cfg`'s step at `shape` on ``meta`` and
    reckon its memory and roofline (any `RunShape`, on the table or
    off it), under `runtime.plan_for`'s plan."""
    t0 = time.perf_counter()
    plan = runtime.plan_for(cfg, shape.name, shape.kind)
    fn, args, fold = build_cell(cfg, shape, plan)
    arg_b = sum(_tree_bytes(a) for a in args)
    rep = hlo.analyze(fn, *args, fold_loops=fold)
    mflops, mbytes = model_terms(cfg, shape)
    roof = rl.Roofline(flops_per_device=rep.flops,
                       hbm_bytes_per_device=rep.bytes,
                       ici_bytes_per_device=0.0,
                       model_flops_per_device=mflops,
                       model_bytes_per_device=mbytes)
    ctx = steps_lib.make_ctx(cfg, mesh_lib.single_card_mesh())
    peak = arg_b + rep.peak_live_bytes
    return {
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch, "status": "ok", "devices": 1,
        "reckoned_for": CARD,
        "params_total": param_count(cfg),
        "params_active": active_param_count(cfg),
        "effective_kv_heads": steps_lib.effective_kv_heads(cfg, ctx),
        "memory": {
            "argument_bytes": arg_b,
            "temp_bytes": rep.peak_live_bytes,
            "peak_bytes_per_device": peak,
            "fits_80gb": bool(peak <= rl.HBM_PER_CARD),
        },
        "ops": {"flops": rep.flops, "bytes": rep.bytes,
                "launches": rep.launches,
                "microbatches_folded": fold, "by_op": rep.by_op},
        "roofline": roof.as_dict(),
        "dry_s": time.perf_counter() - t0,
    }


def run_cell(arch: str, shape_name: str) -> dict:
    cfg = registry.get_config(arch)
    shape = SHAPES[shape_name]
    head = {"arch": arch, "shape": shape_name, "mesh": MESH}
    skip = applicable(cfg, shape)
    if skip:
        return {**head, "status": "skipped", "reason": skip}
    try:
        return {**head, **run_shape(cfg, shape)}
    except Exception as e:  # a failure here is a bug in the port
        return {**head, "status": "FAILED",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def fmt_row(r: dict) -> str:
    if r["status"] == "skipped":
        return (f"{r['arch']:16s} {r['shape']:12s} {r['mesh']:8s} SKIP "
                f"({r['reason'][:60]}...)")
    if r["status"] == "FAILED":
        return (f"{r['arch']:16s} {r['shape']:12s} {r['mesh']:8s} FAIL "
                f"{r['error'][:80]}")
    ro, mem = r["roofline"], r["memory"]
    return (f"{r['arch']:16s} {r['shape']:12s} {r['mesh']:8s} "
            f"mem={mem['peak_bytes_per_device'] / 1e9:8.2f}GB"
            f"{'✓' if mem['fits_80gb'] else '✗'} "
            f"C={ro['compute_s'] * 1e3:10.3f}ms "
            f"M={ro['memory_s'] * 1e3:10.3f}ms "
            f"dom={ro['dominant'][:4]} "
            f"useful={ro['useful_flops_fraction']:6.1%} "
            f"roof={ro['roofline_fraction']:6.1%} "
            f"[{r['dry_s']:.1f}s dry]")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = registry.ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            r = run_cell(arch, shape)
            n_fail += r["status"] == "FAILED"
            print(fmt_row(r), flush=True)
            (outdir / f"{arch}__{shape}.json").write_text(
                json.dumps(r, indent=1))
    print(f"\ndone; {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()

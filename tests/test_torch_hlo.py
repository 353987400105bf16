"""The port's op-level analyzer (`repro_torch.utils.hlo`) against the
hand-computed truths of the reference's HLO analyzer
(tests/test_hlo_analyzer.py), on the CPU:

  * a matmul's flops exactly, its bytes within [0.9, 3] x the minimum;
    nine matmuls in a loop count nine times;
  * a one-token in-place write into an (8, 4096, 64) cache bills under
    10% of the buffer, a copy at least the buffer; a sliced read bills
    the slice, and a loop reading one row a step from a stacked buffer
    bills about the buffer, not a buffer a step;
  * on ``meta``, `ops.flash_attention` and `ops.ssd` count one launch
    with `attention_cost`'s / `ssd_cost`'s flops and bytes and no plain
    op, return the kernels' shapes, dtypes and strides, and add nothing
    to `LAUNCHES`;
  * the peak of live storages: views share one, a freed one stops
    counting, one that autograd saves counts until the backward;
  * for each of the ten architectures' smoke configs the count of a
    decode step on ``meta`` equals the count on CPU tensors (flops,
    bytes, launches by op and peak live bytes; a train step's in
    tests/test_torch_hlo_train.py); the train step's microbatches folded
    (`hlo.trips`) count what the unfolded step counts;
  * a dense smoke train step's FLOPs within [0.8, 1.25] of the
    reference's `hlo.analyze` of its jitted step on one device (the port
    counts products only, the reference also one flop an element of
    every elementwise op: chatglm3-6b's smoke step reads 0.950).
"""

import pytest
import torch

from repro.configs import registry as rregistry, runtime as rruntime
from repro.launch import mesh as rmesh, steps as rsteps
from repro.utils import hlo as rhlo
from repro_torch.configs import registry, runtime
from repro_torch.configs.shapes import RunShape, input_specs
from repro_torch.kernels import _build, ops
from repro_torch.launch import steps
from repro_torch.models import params as P, transformer as T
from repro_torch.optim import adamw
from repro_torch.utils import hlo
from repro_torch.utils.roofline import attention_cost, ssd_cost
from _torch_port import single_torch_thread  # noqa: F401


def test_plain_matmul_flops_and_bytes():
    a, b = torch.empty(256, 512), torch.empty(512, 128)
    rep = hlo.analyze(lambda: a @ b)
    assert rep.flops == 2 * 256 * 512 * 128
    min_bytes = 4 * (256 * 512 + 512 * 128 + 256 * 128)
    assert min_bytes * 0.9 <= rep.bytes <= min_bytes * 3
    assert rep.launches == 1 and set(rep.by_op) == {"mm"}


def test_loop_of_matmuls_counts_each_trip():
    x, w = torch.empty(64, 128), torch.empty(9, 128, 128)

    def f():
        c = x
        for i in range(9):
            c = c @ w[i]
        return c

    rep = hlo.analyze(f)
    assert rep.flops == 2 * 64 * 128 * 128 * 9
    assert rep.launches == 9


def test_trips_fold_multiplies_the_body():
    x, w = torch.empty(64, 128), torch.empty(128, 128)

    def f():
        for _ in hlo.trips(9):
            x @ w

    full, folded = hlo.analyze(f), hlo.analyze(f, fold_loops=True)
    assert (folded.flops, folded.bytes, folded.launches) == (
        full.flops, full.bytes, full.launches) == (
        2 * 64 * 128 * 128 * 9, full.bytes, 9)
    assert list(hlo.trips(3)) == [0, 1, 2]   # no counter: a range


def test_inplace_cache_update_not_billed_full_buffer():
    cache = torch.zeros(8, 4096, 64)
    tok = torch.ones(8, 1, 64)
    buffer_bytes = 8 * 4096 * 64 * 4

    def write():
        cache[:, 5:6] = tok

    def index_write():
        cache.index_copy_(1, torch.tensor([5]), tok)

    for fn in (write, index_write):
        assert hlo.analyze(fn).bytes < buffer_bytes * 0.1
    assert hlo.analyze(lambda: cache.clone()).bytes >= buffer_bytes
    assert hlo.analyze(lambda: torch.cat([cache, tok], 1)).bytes \
        >= buffer_bytes


def test_sliced_read_bills_the_slice():
    big = torch.empty(64, 512)
    rep = hlo.analyze(lambda: big[:, :16].contiguous())
    assert rep.bytes == 2 * 64 * 16 * 4

    def f():
        c = torch.zeros(512)
        for i in range(64):
            c = c + big[i]
        return c

    assert hlo.analyze(f).bytes < 64 * 512 * 4 * 8


def test_views_and_allocations_bill_nothing():
    x = torch.empty(32, 64)
    rep = hlo.analyze(lambda: (x.view(64, 32).T[1:].unsqueeze(0).detach(),
                               torch.empty(8), torch.empty_like(x)))
    assert (rep.flops, rep.bytes, rep.launches) == (0, 0, 0)


def test_peak_live_bytes():
    n = 1 << 20

    def views():
        a = torch.zeros(n)
        b = a[1:]
        c = a.view(2, -1)
        return b.sum() + c.sum()

    # the views share a's storage: counted once
    assert hlo.analyze(views).peak_live_bytes == 4 * n + 2 * 4 + 4

    def freed():
        for _ in range(4):
            a = torch.zeros(n)
            del a

    assert hlo.analyze(freed).peak_live_bytes == 4 * n

    x = torch.randn(n, requires_grad=True)

    def saved():
        y = x.exp()            # saved for exp's backward
        z = y.sum()
        del y
        big = torch.zeros(n)   # y's storage is still live
        del big
        return torch.autograd.grad(z, [x])

    assert hlo.analyze(saved).peak_live_bytes >= 2 * 4 * n


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_on_meta_counts_the_kernel(dtype):
    b, hq, hkv, t, d = 2, 8, 2, 256, 64
    q = torch.empty(b, hq, t, d, dtype=dtype, device="meta")
    k = torch.empty(b, hkv, t, d, dtype=dtype, device="meta")
    before = dict(ops.LAUNCHES)
    with hlo.OpCounter() as c:
        o = ops.flash_attention(q, k, k, causal=True, window=96,
                                softcap=30.0)
    rep = c.report()
    _, _, nbytes, flops = attention_cost((b, hq, hkv, t, t, d), True, 96,
                                         dtype)
    assert rep.by_op == {"flash_attention": {"launches": 1, "flops": flops,
                                             "bytes": nbytes}}
    assert ops.LAUNCHES == before
    assert o.is_meta and o.shape == q.shape and o.dtype == dtype
    # bf16 writes contiguous storage; float32 a view of (B, T, H, D)
    want = torch.empty(b, hq, t, d) if dtype == torch.bfloat16 else \
        torch.empty(b, t, hq, d).transpose(1, 2)
    assert o.stride() == want.stride()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_on_meta_counts_the_kernel(dtype):
    bsz, t, h, p, n = 2, 300, 4, 64, 128
    x = torch.empty(bsz, t, h, p, dtype=dtype, device="meta")
    a = torch.empty(bsz, t, h, device="meta")
    bc = torch.empty(bsz, t, n, dtype=dtype, device="meta")
    before = dict(ops.LAUNCHES)
    with hlo.OpCounter() as c:
        y, state = ops.ssd(x, a, bc, bc)
    rep = c.report()
    _, _, nbytes, flops = ssd_cost((bsz, t, h, p, n), dtype)
    assert rep.by_op == {"ssd": {"launches": 1, "flops": flops,
                                 "bytes": nbytes}}
    assert ops.LAUNCHES == before
    assert (y.shape, y.dtype, state.shape, state.dtype) == (
        x.shape, dtype, (bsz, h, p, n), torch.float32)


def test_meta_alignment_reads_the_storage_offset():
    s = torch.empty(4, 40, device="meta")
    assert _build.rows_aligned(s[:, :32])
    assert not _build.rows_aligned(s[:, 1:33])   # 4 bytes past 16


def state_on(cfg, plan, dev):
    if dev == "meta":
        return steps.abstract_state(cfg, plan)
    params = P.init_params(cfg, torch.Generator().manual_seed(0),
                           device=dev)
    return steps.TrainState(params, adamw.init(plan.opt, params),
                            torch.zeros((), dtype=torch.int32))


def batch_on(cfg, shape, dev):
    """Zeros of the input specs' shapes (token 0 and label 0 are valid)."""
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
            for k, s in input_specs(cfg, shape).items()}


def counts(rep):
    return rep.flops, rep.bytes, rep.launches, rep.by_op, rep.peak_live_bytes


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_decode_counts_the_same_on_meta_and_cpu(arch):
    cfg = registry.get_smoke_config(arch)
    plan = runtime.plan_for(cfg, "decode_32k", "decode")
    got = {}
    for dev in ("meta", "cpu"):
        fn, _ = steps.build_serve_step(cfg, plan, 2, 48, device=dev)
        params = state_on(cfg, plan, dev).params
        caches = T.init_caches(cfg, 2, 48, device=dev,
                               enc_len=cfg.num_audio_frames)
        batch = {"tokens": torch.zeros((2, 1), dtype=torch.int32,
                                       device=dev),
                 "lengths": torch.full((2,), 7, dtype=torch.int32,
                                       device=dev)}
        got[dev] = counts(hlo.analyze(fn, params, caches, batch))
    assert got["meta"] == got["cpu"]
    assert got["meta"][0] > 0


def test_folded_microbatches_count_the_full_step():
    cfg = registry.get_smoke_config("chatglm3_6b")
    plan = runtime.plan_for(cfg, "train_4k", "train")
    fn, _, _ = steps.build_train_step(cfg, plan, 4, 24, device="meta")
    assert steps.num_microbatches(plan, 4) == 4
    batch = batch_on(cfg, RunShape("train", "train", 24, 4), "meta")
    full = hlo.analyze(fn, steps.abstract_state(cfg, plan), batch)
    folded = hlo.analyze(fn, steps.abstract_state(cfg, plan), batch,
                         fold_loops=True)
    assert (folded.flops, folded.bytes, folded.launches, folded.by_op) == (
        full.flops, full.bytes, full.launches, full.by_op)


def test_train_flops_against_the_reference_analyzer():
    arch, b, t = "chatglm3_6b", 4, 32
    rcfg = rregistry.get_smoke_config(arch)
    mesh = rmesh.make_test_mesh((1, 1))
    rplan = rruntime.plan_for(rcfg, "train_4k", "train",
                              dp_axes=rmesh.dp_axes(mesh))
    with mesh:
        rfn, rstate, rbatch, _ = rsteps.build_train_step(rcfg, mesh, rplan,
                                                         b, t)
        text = rfn.lower(rstate, rbatch).compile().as_text()
    ref = rhlo.analyze(text)
    cfg = registry.get_smoke_config(arch)
    plan = runtime.plan_for(cfg, "train_4k", "train")
    fn, _, _ = steps.build_train_step(cfg, plan, b, t, device="meta")
    rep = hlo.analyze(fn, steps.abstract_state(cfg, plan),
                      batch_on(cfg, RunShape("train", "train", t, b), "meta"),
                      fold_loops=True)
    ratio = rep.flops / ref.flops
    assert 0.8 <= ratio <= 1.25, ratio

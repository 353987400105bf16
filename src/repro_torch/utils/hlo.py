"""Op-level analyzer: FLOPs, HBM bytes, launches and peak live memory of
one call, counted op by op (counterpart of `repro.utils.hlo`).

The reference walks the compiled HLO of a jitted step: XLA fuses ops, so
its traffic model bills the boundary buffers of each top-level op (a
fusion's operands and result), and it multiplies a while body by its
trip count.  The port has no HLO.  Eager PyTorch runs each aten op as a
kernel of its own, so the port's boundary buffers are each op's operands
and results.  `OpCounter`, a `TorchDispatchMode`, sees every aten op
below autograd (forward, backward and remat recompute alike) and
accumulates:

  flops   — 2*M*N*K for every ``mm``/``bmm``/``addmm``/``baddbmm``,
            and what `count_flops` and `record_kernel` report (the Mamba
            causal conv, written as K multiply-adds, reports its
            convolution count; the two model kernels report their
            cost); elementwise ops count none;
  bytes   — operand plus result bytes (numel x element size, so a view
            bills what it covers, not its storage) of every op that
            launches work.  Views, reshapes, ``detach``, aliases and
            allocations bill 0 (the reference's `SKIP_BYTES_OPS`).  An
            in-place write through indices (``index_copy_``,
            ``index_add_``, ``scatter_``) bills the region it writes and
            its indices and values, not the buffer; a pure write
            (``copy_``, ``fill_``, ``zero_``) does not bill its
            destination's old contents;
  launches — ops that launch work, with a `by_op` breakdown (the kernel
            wrappers add one for each kernel launch, under the kernel's
            name); a CUDA op may launch more than one kernel or none,
            so this is the op count, set beside the profiler's kernel
            count where both are read;
  peak_live_bytes — the largest sum of live storages allocated inside
            the call, each counted once however many views share it,
            and freed when the storage dies (a finalizer on it), so a
            tensor autograd saves for the backward stays counted until
            the backward has run.  Workspaces an op allocates inside
            its kernel (cuBLAS, a reduction's scratch) are not seen.

The counts depend on shapes, dtypes and strides only, so a call on
``meta`` tensors (no memory, no work) counts what the same call on the
card does: `kernels.ops.flash_attention` and `ops.ssd` take ``meta``
tensors to their kernels' output shapes and report the same cost a card
launch reports.

`trips(n)` is the port's counterpart of a while loop with a known trip
count: ``range(n)``, except under ``OpCounter(fold_loops=True)``, which
runs the body once with every count multiplied by n (peak memory is
not multiplied).  The train step's microbatch loop runs through it.

Left out: the reference's HLO walker, `parse_computations` and its
records ``Instr`` and ``CompStats``, its collective model
(``COLLECTIVES``: ring traffic, DCN attribution) and the CPU-backend
artifact bucket: the port has no HLO, one card has no collectives, and
eager ops have no backend-specific fusions to discount.  Its
``HloReport`` is `OpReport` here, and its ``SKIP_BYTES_OPS`` are the
views and `ALLOC_OPS`.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

aten = torch.ops.aten

# allocations: no work, no bytes (a later op writes them)
ALLOC_OPS = {aten.empty, aten.empty_like, aten.empty_strided,
             aten.new_empty, aten.new_empty_strided}
# writes that do not read the old contents of their destination
WRITE_ONLY_OPS = {aten.copy_, aten.fill_, aten.zero_, aten.normal_,
                  aten.uniform_, aten.random_, aten.bernoulli_,
                  aten.exponential_}
# in-place writes through indices: the region written, not the buffer
INDEX_WRITE_OPS = {aten.index_copy_, aten.index_add_, aten.scatter_,
                   aten.scatter_add_}
ACCUMULATE_OPS = {aten.index_add_, aten.scatter_add_}


def _tensors(tree):
    """The tensors of an op's args, kwargs or results, lists flattened."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _flops(packet, args) -> int:
    """2 M N K of a (batched) matrix product; 0 for any other op."""
    if packet in (aten.mm, aten.addmm):
        a, b = args[-2], args[-1]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if packet in (aten.bmm, aten.baddbmm):
        a, b = args[-2], args[-1]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return 0


def _index_write_bytes(packet, args, kwargs) -> int:
    """Bytes of an in-place write through indices, ``op(dest, dim,
    index, source)``: every operand but the destination, plus the
    region written (the source's elements; a scatter's index's), twice
    where the write adds to the old values."""
    dest, index = args[0], args[2]
    others = sum(_nbytes(t) for t in _tensors((args[1:], kwargs)))
    region = index.numel() if packet in (aten.scatter_, aten.scatter_add_) \
        else args[3].numel()
    reads = 2 if packet in ACCUMULATE_OPS else 1
    return others + reads * region * dest.element_size()


@dataclasses.dataclass
class OpReport:
    flops: float
    bytes: float
    launches: int
    by_op: Dict[str, Dict[str, float]]
    peak_live_bytes: int


class OpCounter(TorchDispatchMode):
    """Counts every aten op run under it (see the module docstring).

        with OpCounter() as c:
            step(...)
        report = c.report()

    `fold_loops` makes `trips(n)` run its body once, counted n times.
    """

    def __init__(self, fold_loops: bool = False):
        super().__init__()
        self.fold_loops = fold_loops
        self.weight = 1
        self.flops = 0
        self.bytes = 0
        self.launches = 0
        self.by_op: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"launches": 0, "flops": 0, "bytes": 0})
        self._lock = threading.Lock()
        self._live = 0
        self._peak = 0
        self._storages: Dict[int, int] = {}   # storage key -> nbytes
        probe = torch.empty(0, device="meta")
        if probe.untyped_storage() is not probe.untyped_storage():
            raise RuntimeError("OpCounter needs a storage's Python object "
                               "to live as long as the storage (torch 2.1 "
                               "or later)")

    # -- counts --------------------------------------------------------
    def add(self, name: str, flops: int = 0, nbytes: int = 0,
            launches: int = 1) -> None:
        w = self.weight
        row = self.by_op[name]
        row["launches"] += w * launches
        row["flops"] += w * flops
        row["bytes"] += w * nbytes
        self.launches += w * launches
        self.flops += w * flops
        self.bytes += w * nbytes

    def report(self) -> OpReport:
        return OpReport(self.flops, self.bytes, self.launches,
                        {k: dict(v) for k, v in self.by_op.items()},
                        self._peak)

    # -- live storages -------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        """Count `t`'s storage as live until it dies (a finalizer on the
        storage: views, and tensors autograd saves, keep it alive)."""
        st = t.untyped_storage()
        key, n = st._cdata, st.nbytes()
        with self._lock:
            if key in self._storages or n == 0:
                return
            self._storages[key] = n
            self._live += n
            self._peak = max(self._peak, self._live)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        with self._lock:
            self._live -= self._storages.pop(key, 0)

    # -- dispatch ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        in_keys = {_storage_key(t) for t in ins}
        written = [a.alias_info is not None and a.alias_info.is_write
                   for a in func._schema.arguments]
        mutates = any(written)
        for t in outs:
            if _storage_key(t) not in in_keys:
                self._track(t)
        if packet in ALLOC_OPS:
            return out
        if not mutates and all(_storage_key(t) in in_keys for t in outs):
            return out     # a view, an alias, a reshape that copies nothing
        self.add(packet.__name__, _flops(packet, args),
                 self._op_bytes(func, packet, args, kwargs, outs, written))
        return out

    @staticmethod
    def _op_bytes(func, packet, args, kwargs, outs, written) -> int:
        if packet in INDEX_WRITE_OPS:
            return _index_write_bytes(packet, args, kwargs)
        schema = func._schema.arguments
        read = 0
        for i, a in enumerate(args):
            if i < len(schema) and written[i] and (
                    packet in WRITE_ONLY_OPS or schema[i].kwarg_only):
                continue
            read += sum(_nbytes(t) for t in _tensors(a))
        pos = {a.name: i for i, a in enumerate(schema)}
        for name, v in kwargs.items():
            i = pos.get(name)
            if i is not None and written[i]:
                continue   # an out= buffer: billed as the result
            read += sum(_nbytes(t) for t in _tensors(v))
        return read + sum(_nbytes(t) for t in outs)


def active_counter() -> Optional[OpCounter]:
    """The innermost `OpCounter` on the dispatch-mode stack, if any."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpCounter):
            return mode
    return None


def record_kernel(name: str, cost, *args) -> None:
    """One launch of a hand-written kernel, with the flops and bytes of
    ``cost(*args)`` (a `utils.roofline` cost: (bound_ms, bound_by,
    bytes, flops)); the wrappers of `flash_attention` and `ssd` call
    this on the card and on ``meta``.  Nothing, and no cost computed,
    when no counter is active."""
    counter = active_counter()
    if counter is not None:
        _, _, nbytes, flops = cost(*args)
        counter.add(name, flops, nbytes)


def count_flops(name: str, flops: int) -> None:
    """FLOPs of work the ops do not show (the causal conv's multiply-adds
    as the convolution they compute), under `name` in ``by_op``, with no
    launch of their own."""
    counter = active_counter()
    if counter is not None:
        counter.add(name, flops, 0, launches=0)


def trips(n: int):
    """``range(n)``; under ``OpCounter(fold_loops=True)`` only 0, with
    the body's counts multiplied by n."""
    counter = active_counter()
    if counter is None or not counter.fold_loops or n <= 1:
        yield from range(n)
        return
    counter.weight *= n
    try:
        yield 0
    finally:
        counter.weight //= n


def analyze(fn, *args, fold_loops: bool = False, **kwargs) -> OpReport:
    """Run ``fn(*args, **kwargs)`` once under an `OpCounter` and return
    its report."""
    with OpCounter(fold_loops=fold_loops) as counter:
        fn(*args, **kwargs)
    return counter.report()

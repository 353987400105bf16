"""Checkpointing of the port (counterpart of
`repro.checkpoint.checkpointer`): npz files + JSON manifest, atomic
commits, restore onto a device, background writes, retention policy.

Layout (the reference's):
    <dir>/step_000123/
        manifest.json     tree description, shapes, dtypes, step, metadata
        arrays.npz        flattened keypath -> array
    <dir>/LATEST          text file naming the last committed step dir

A tree is nested dicts and named tuples of tensors.  Keys are the
reference's ``/``-joined paths: a dict key, or ``.name`` for a field of
a named tuple (``.params/embed``, ``.opt/.mu/stages/stage0/...``,
``.step``), so each package reads a checkpoint the other wrote.  bf16 tensors have no numpy dtype: they are
stored as the reference's numpy writes its bf16 arrays, two raw bytes a
value (numpy ``|V2``) with ``bfloat16`` in the manifest, and `restore`
gives them back bit for bit.

Commits are atomic (write to step_xxx.tmp, sync, rename), so a crash
mid-write never corrupts the latest checkpoint.  `restore(template,
device=...)` places every tensor on `device` in the template's dtype;
the reference's ``shardings`` (an elastic re-mesh onto new shardings)
has no counterpart on one card.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device

def _is_named_tuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree):
    """(key part, child) pairs in the reference's order: a dict's keys
    sorted, a named tuple's fields as ``.name``; None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_named_tuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    return None


def _flatten_paths(tree, prefix=()):
    items = _items(tree)
    if items is None:
        return [("/".join(prefix), tree)]
    return [kv for k, child in items
            for kv in _flatten_paths(child, prefix + (k,))]


def _unflatten_like(tree, leaves):
    items = _items(tree)
    if items is None:
        return next(leaves)
    kids = [_unflatten_like(child, leaves) for _, child in items]
    if isinstance(tree, dict):
        return dict(zip((k for k, _ in items), kids))
    return type(tree)(*kids)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor (any device) as numpy; bf16 as ``|V2`` bytes."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _tree_text(tree) -> str:
    items = _items(tree)
    if items is None:
        return "*"
    inner = ", ".join(f"{k}: {_tree_text(c)}" for k, c in items)
    if _is_named_tuple(tree):
        return f"{type(tree).__name__}({inner})"
    return "{" + inner + "}"


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3,
                 background: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._q: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        if background:
            self._q = queue.Queue(maxsize=2)
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any,
             metadata: Optional[Dict] = None) -> None:
        """Host-blocking (or queued, if background=True) checkpoint save:
        every tensor is copied to the host before this returns."""
        pairs = _flatten_paths(tree)
        flat = {k: _to_numpy(v) for k, v in pairs}
        manifest = {
            "step": int(step),
            "treedef": _tree_text(tree),
            "keys": {k: {"shape": list(flat[k].shape),
                         "dtype": str(v.dtype).replace("torch.", "")}
                     for k, v in pairs},
            "metadata": metadata or {},
        }
        if self._q is not None:
            self._q.put((step, flat, manifest))
        else:
            self._write(step, flat, manifest)

    def wait(self) -> None:
        if self._q is not None:
            self._q.join()

    def _drain(self) -> None:
        while True:
            step, flat, manifest = self._q.get()
            try:
                self._write(step, flat, manifest)
            finally:
                self._q.task_done()

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               manifest: Dict) -> None:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **flat)
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        os.sync()
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        latest_tmp = self.dir / "LATEST.tmp"
        latest_tmp.write_text(final.name)
        latest_tmp.rename(self.dir / "LATEST")
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.dir.glob("step_????????"))
        for old in steps[:-self.keep_last]:
            shutil.rmtree(old, ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        latest = self.dir / "LATEST"
        if not latest.exists():
            return None
        return int(latest.read_text().strip().split("_")[-1])

    def restore(self, template: Any, step: Optional[int] = None,
                device=None) -> Any:
        """Restore into the structure of `template` (tensors, e.g. on the
        ``meta`` device: only shapes and dtypes are read), as tensors on
        `device` (None: the card) in the template's dtypes."""
        dev = resolve_device(device)
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        dtypes = {k: v["dtype"] for k, v in
                  json.loads((d / "manifest.json").read_text())["keys"].items()}
        with np.load(d / "arrays.npz") as z:
            flat = {k: z[k] for k in z.files}
        out = []
        for key, leaf in _flatten_paths(template):
            if key not in flat:
                raise KeyError(f"checkpoint missing {key}")
            arr = flat[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"{key}: checkpoint shape {arr.shape} != "
                    f"{tuple(leaf.shape)}")
            out.append(_to_tensor(arr, dtypes.get(key), leaf, dev))
        return _unflatten_like(template, iter(out))

    def manifest(self, step: Optional[int] = None) -> Dict:
        step = self.latest_step() if step is None else step
        d = self.dir / f"step_{step:08d}"
        return json.loads((d / "manifest.json").read_text())


def _to_tensor(arr: np.ndarray, stored: Optional[str], leaf: torch.Tensor,
               dev: torch.device) -> torch.Tensor:
    """A stored array as a tensor on `dev` in the template leaf's dtype."""
    arr = np.array(arr, order="C")  # keeps a 0-d array 0-d
    t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
        if stored == "bfloat16" else torch.from_numpy(arr)
    return t.to(device=dev, dtype=leaf.dtype)

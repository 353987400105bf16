"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``kernels/_build/<name>-<digest>.so`` (the digest covers
the source, the shared headers ``csrc/*.cuh`` and the flags, so an
edited source or header is rebuilt and a stale library is never
loaded).  No PyTorch header is included, which keeps a
build to seconds; pointers and the stream cross as ``ctypes.c_void_p``.
Nothing is built or loaded when this module is imported.

`LAUNCHES` counts launches per kernel: each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main
path went through the kernel.  `check_arg` is the wrappers' shared
argument check (contiguous, or with contiguous 16-byte aligned rows for
a kernel that takes strides).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # exactness: no contraction into FMA, IEEE division (no fast math)
    "--fmad=false",
    # print registers / shared memory / spills of every kernel
    "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}
LAUNCHES: Dict[str, int] = {"fleet_route": 0, "wwl_route": 0,
                            "maxweight_claim": 0, "flash_attention": 0,
                            "ssd": 0}


def check_arg(kernel: str, name: str, x: torch.Tensor, dtype: torch.dtype,
              shape, device=None, strided: bool = False) -> None:
    """Raise unless `x` is a CUDA tensor of `dtype` and `shape` (and on
    `device`, when given) that is contiguous or, with `strided`, whose
    rows are contiguous and 16-byte aligned (`rows_aligned`; the kernel
    takes the other strides)."""
    if not x.is_cuda:
        raise ValueError(f"{kernel}: {name} must be a CUDA tensor, "
                         f"got device {x.device}")
    if device is not None and x.device != device:
        raise ValueError(f"{kernel}: {name} is on {x.device}, want {device}")
    if x.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(x.shape)}")
    if strided:
        if not rows_aligned(x):
            raise ValueError(f"{kernel}: {name} must have a contiguous last "
                             f"axis and 16-byte aligned rows, got strides "
                             f"{x.stride()} at {x.data_ptr() % 16} bytes "
                             f"past 16")
    elif not x.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def rows_aligned(x: torch.Tensor) -> bool:
    """Whether a kernel that takes strides can read `x` 16 bytes at a
    time: a contiguous last axis, every other stride a multiple of 16
    bytes and the first element 16-byte aligned."""
    esize = x.element_size()
    return ((x.shape[-1] <= 1 or x.stride(-1) == 1)
            and all(s * esize % 16 == 0 for s in x.stride()[:-1])
            and x.data_ptr() % 16 == 0)


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "CUDA kernels are built from source on first use")
    return found


def sources() -> Iterable[str]:
    """Names of every kernel source under csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu's library is (or will be) built."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; None when its library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all(names: Iterable[str] = ()) -> None:
    """Build the given sources (default: all of csrc/), one nvcc per
    source, all started together."""
    names = list(names) or list(sources())
    started = {n: _start(n) for n in names}
    try:
        for n, s in started.items():
            if s is not None:
                _finish(n, s)
    finally:
        for s in started.values():
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib

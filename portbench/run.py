"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, and with ``--trace 1`` ``breakdown``); the numbers compared
for ``correct`` come last there, under ``checks``, and again as the last
lines of standard error.  Exits 2, printing no result, without enough
CUDA devices, without the program (``src/repro_torch``), or when the
process has loaded ``jax``, ``jaxlib``, ``flax``, the JAX package
``repro`` or ``benchmarks``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import spec  # noqa: E402

# every cache of the build and of the kernels at a fixed path inside the
# checkout, so that only a checkout's first run builds
CACHE = spec.ROOT / ".portbench_cache"
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions",
             "TRITON_CACHE_DIR": CACHE / "triton",
             "CUDA_CACHE_PATH": CACHE / "nv"}
# one host thread for PyTorch's and OpenMP's CPU work: the window's host
# side is one Python thread, and idle pool threads only add noise
THREAD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark must not
    load, each name compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, path in CACHE_ENV.items():
        os.environ[key] = str(path)
    os.environ.update(THREAD_ENV)

    cell = spec.cell(args.workload)
    import torch

    torch.set_num_threads(1)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    src = spec.ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"portbench: the program is missing ({src / 'repro_torch'})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))

    from portbench import harness

    result = harness.run(cell, spec.manifest(), args.seed, args.seconds,
                         bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 2
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

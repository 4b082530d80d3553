"""Run one cell of the benchmark of light_loam_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for.  Prints the result as one JSON object on the last line of
standard output, and the numbers compared with their limits as the last
lines of standard error.  Exits with 2, printing no result, when the cell
cannot run as its files say (no card, too few cards, files or the program
missing), and with 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "light_loam_tpu_torch" / "__init__.py").is_file():
        fail("the program (light_loam_tpu_torch/) is not in this checkout")
    sys.path[:0] = [str(BENCH), str(ROOT)]
    _cache_dirs()
    from harness import manifest

    try:
        m = manifest.manifest()
        cell = manifest.cell(m, args.workload)
    except manifest.BenchError as e:
        fail(str(e))
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        fail(f"{torch.cuda.device_count()} CUDA devices, the cell needs {chips}")

    from harness import runner

    try:
        result = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda:0")
    except manifest.BenchError as e:
        fail(str(e))
    loaded = runner.forbidden_modules()
    if loaded:
        fail(f"forbidden modules loaded: {', '.join(loaded)}", 3)
    print(json.dumps(result))
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)


if __name__ == "__main__":
    main()

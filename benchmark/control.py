"""Readings of the comparison that decides ``correct``, for setting its
limits: the program's on each seed, or with ``--control`` the control's,
the plain reference computed in TF32 (float32, matrix products on the
tensor cores: the nearest precision below the configuration's float32 with
TF32 off) put in the program's place.  The benchmark's own runs never run
the control.

    python3 benchmark/control.py --workload <cell> --seconds <s> [--control] --seeds <n> [<n> ...]

prints one JSON line a seed: {"seed", "control", "correct", "readings",
"metrics", ...}.  Needs a CUDA card, as run.py does.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true",
                    help="judge the reference in TF32 in the program's place")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(BENCH.parent)]
    import run as bench_run

    bench_run._cache_dirs()
    import torch

    from harness import manifest, runner

    if not torch.cuda.is_available():
        bench_run.fail("torch.cuda.is_available() is false")
    cell = manifest.cell(manifest.manifest(), args.workload)
    for seed in args.seeds:
        r = runner.run(cell, seed, args.seconds, False, "cuda:0",
                       control=args.control)
        print(json.dumps({
            "seed": seed, "control": args.control, "correct": r["correct"],
            "readings": r["info"]["readings"],
            "frames": r["info"].get("frames"),
            "reference_s": r["info"].get("reference_s"),
            "metrics": {k: v["value"] for k, v in r["metrics"].items()},
        }), flush=True)


if __name__ == "__main__":
    main()

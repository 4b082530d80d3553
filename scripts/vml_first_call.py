"""How often the first multi-threaded CPU sqrt of a fresh process errs.

    python scripts/vml_first_call.py [--runs N] [--threads T] [--jobs J]

Starts N fresh Python processes, each computing ``torch.sqrt`` of 36864
float32 values in [1, 3000] on T threads as its first call of the
function, and counts the processes whose result lies more than 1e-6
(relative) from the float64 square root.  It does so twice: with the bare
``torch`` import ("cold") and after importing ``light_loam_tpu_torch``,
which calls each VML-backed function once on a tiny tensor at import
("warmed").  PyTorch's CPU sqrt calls MKL's vector math (VML); a first
call made by several threads at once can leave one thread computing at
about 12 correct bits.  Prints one line per mode.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import subprocess
import sys

CHILD = r"""
import sys
import numpy as np
import torch
if sys.argv[1] == "warmed":
    import light_loam_tpu_torch  # noqa: F401
torch.set_num_threads(int(sys.argv[2]))
x = np.random.default_rng(1).uniform(1, 3000, 36864).astype(np.float32)
y = torch.sqrt(torch.from_numpy(x)).numpy().astype(np.float64)
exact = np.sqrt(x.astype(np.float64))
print(float((abs(y - exact) / exact).max()))
"""


def one(mode: str, threads: int) -> float:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", CHILD, mode, str(threads)],
                         capture_output=True, text=True, env=env, check=True)
    return float(out.stdout.strip())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=180)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--jobs", type=int, default=6)
    args = ap.parse_args()
    for mode in ("cold", "warmed"):
        with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
            errs = list(pool.map(lambda _: one(mode, args.threads),
                                 range(args.runs)))
        bad = [e for e in errs if e > 1e-6]
        print(f"{mode}: {len(bad)} of {args.runs} processes erred "
              f"(worst relative error {max(errs):.3g}; {args.threads} "
              "threads)")


if __name__ == "__main__":
    main()

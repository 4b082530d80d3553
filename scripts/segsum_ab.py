"""The segment sum at its call sites (``chip_smoke.py`` phase 3c) from two
checkouts on one card, in turns: base, this tree, this tree, base.

    python scripts/segsum_ab.py --base DIR [--out FILE]

DIR is another checkout of the repository, for instance a commit unpacked
with ``git archive`` into a directory that ``.gitignore`` lists.  Each
turn is a fresh process in one checkout that builds that checkout's
``csrc/segsum.cu`` and runs its ``chip_smoke.phase_segsum`` (phase 5's 12
frames and a refinement recorded, then every call site timed; it raises if
the kernel is not bit for bit its plain version).  Prints, per site, the
device ms per launch of each turn, and writes every turn's numbers as JSON
(``--out``, default ``build/segsum_ab.json``).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# run in the checkout: its own chip_smoke and package
TURN = """
import json, torch
import chip_smoke as c
smi = c.phase_device()
c.phase_build((c.SEGSUM,))
sites = c.phase_segsum(torch.device("cuda", 0))
print("SEGSUM_AB " + json.dumps({"smi": smi, "sites": list(sites.values())}))
"""


def turn(root: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", TURN], cwd=root, env=env,
                          capture_output=True, text=True, timeout=1200)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise RuntimeError(f"phase 3c in {root} failed with exit "
                           f"{proc.returncode}:\n{proc.stdout[-4000:]}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("SEGSUM_AB ")][-1]
    return {**json.loads(line[len("SEGSUM_AB "):]), "stdout": proc.stdout}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, type=Path)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "segsum_ab.json")
    args = ap.parse_args(argv)
    order = [("base", args.base.resolve()), ("tree", ROOT), ("tree", ROOT),
             ("base", args.base.resolve())]
    turns = []
    for name, root in order:
        result = turn(root)
        turns.append({"name": name, **result})
        print(f"[{len(turns)} {name}] {result['smi']}", flush=True)
    print("site | N C S dtype | " + " | ".join(t["name"] for t in turns)
          + " (device ms per launch) | bound ms")

    def key(site):
        return site["site"], site["N"], site["C"], site["S"], site["dtype"]

    by_turn = [{key(site): site for site in t["sites"]} for t in turns]
    for k, site in by_turn[1].items():
        print(f"{k[0]} | {' '.join(map(str, k[1:]))} | "
              + " | ".join(f"{sites[k]['device_ms']:.4f}" if k in sites
                           else "-" for sites in by_turn)
              + f" | {site['bound_ms']:.5f}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(turns, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Ranks started as separate processes through the launcher's environment
(parallel/multihost.py): twin of tests/test_multihost.py.

Each rank is its own ``python`` process running
tests/torch_multihost_worker.py with the variables ``torchrun`` sets, so
``init_from_env`` is what joins them (gloo, on the CPU).  The result is
held to tests/multihost_worker.py's JAX run on one process with as many
virtual devices as ranks (the same mesh size), its planes fit by
tests/oracle.py's float64 least squares (run through
tests/oracle_planes.py: the package's own float32 adjugate kept 563 surf
factors where the port keeps 719), with the sharded twin's tolerances
(tests/test_torch_sharded.py: t_w within 2e-2 m, where the jitted JAX
step's float32 gates flip against the port's, measured 6.89 mm
at 4 ranks; surf factors within max(5, 3 %), map surf points within
max(10, 2 %)), and to the JAX
test's sanity bounds: the solve engaged (surf factors > 100) and pulled the
0.3 m odometry guess back to the origin (|t_w| < 0.1).  ~40 s on the CPU
(2 ranks; 4 run under ``slow``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_multihost import WORKER, _free_port

TORCH_WORKER = os.path.join(os.path.dirname(__file__),
                            "torch_multihost_worker.py")
ORACLE_PLANES = os.path.join(os.path.dirname(__file__), "oracle_planes.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _result(out: str) -> dict:
    lines = [line for line in out.splitlines() if line.startswith("RESULT ")]
    assert len(lines) == 1, out
    return json.loads(lines[0][len("RESULT "):])


def _run_jax_worker(local_devs: int, timeout: float = 420.0) -> dict:
    """tests/multihost_worker.py as one process with ``local_devs`` virtual
    devices (the package found from the repository's root), inside
    tests/oracle_planes.py."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, ORACLE_PLANES, WORKER, "0", "1", str(_free_port()),
         str(local_devs)], capture_output=True, text=True, env=env,
        timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return _result(proc.stdout)


def _run_torch_ranks(world: int, timeout: float = 240.0) -> dict:
    port = str(_free_port())
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, TORCH_WORKER], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, _, err in outs:
        assert rc == 0, f"rank failed (rc={rc}):\n{err[-3000:]}"
    assert not any("RESULT " in out for _, out, _ in outs[1:])
    return _result(outs[0][1])


@pytest.mark.parametrize("world", [2, pytest.param(4, marks=pytest.mark.slow)])
def test_ranks_from_env_match_jax(world):
    got = _run_torch_ranks(world)
    ref = _run_jax_worker(world)
    assert got["world_size"] == ref["n_global_devices"] == world
    assert got["ranks_equal"]
    gap = float(np.linalg.norm(np.subtract(got["t_w"], ref["t_w"])))
    assert gap < 2e-2, f"port vs JAX: {gap:.5f} m"
    assert abs(got["surf_factors"] - ref["surf_factors"]) <= max(
        5, 0.03 * ref["surf_factors"])
    assert abs(got["map_surf_points"] - ref["map_surf_points"]) <= max(
        10, 0.02 * ref["map_surf_points"])
    assert got["surf_factors"] > 100
    assert np.linalg.norm(got["t_w"]) < 0.1

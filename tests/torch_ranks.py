"""Start ranks of the PyTorch port's multi-device tests on the CPU.

``run_ranks(fn, world, tmp_path, *args)`` spawns ``world`` processes that
join one gloo group through a file in ``tmp_path`` (so that test workers
running side by side never compete for a port), calls ``fn(group, *args)``
in each with its ``ShardGroup`` on the CPU and returns every rank's result
in rank order.  A rank that raises fails the call with its traceback; a
rank still running after ``timeout`` seconds is killed and the call fails.

``fn`` travels to the children by its import path, so it must live at the
top level of a module that imports no JAX: the children load neither JAX
nor the JAX package.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from light_loam_tpu_torch.parallel.sharded import make_group


def _rank_main(rank, fn, world, init_method, out_dir, args):
    torch.set_num_threads(1)
    group = make_group(world, rank, "gloo", init_method, device="cpu")
    try:
        result = fn(group, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 300.0):
    out_dir = tmp_path / f"ranks{world}-{time.monotonic_ns()}"
    out_dir.mkdir()
    init_method = f"file://{out_dir / 'rdzv'}"
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, init_method, str(out_dir), args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} still "
                                   f"running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]

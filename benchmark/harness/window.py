"""What every driver's window shares: the runs the comparison will take,
the program states held for them, the profiler and the split of set-up.

A driver keeps only its step loop.  Around each unit of work (a sweep, or
a batched step of all lanes) it calls ``Plan.starts`` before the
profiler's step and ``Plan.ends`` after it; the plan copies the program's
states it needs into buffers allocated before the window, so the window
calls no ``cudaMalloc`` for them and the comparison does not depend on how
the program allocates its states.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import compare, trace, traffic


def _alloc(tree):
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree)
    parts = [_alloc(x) for x in tree]
    return tuple(parts) if type(tree) is tuple else type(tree)(*parts)


def _copy(dst, src) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src, non_blocking=True)
        return
    for d, s in zip(dst, src):
        _copy(d, s)


class Held:
    """``slots`` copies of a state shaped like ``template``, owned by the
    harness."""

    def __init__(self, template, slots: int):
        self.bufs = [_alloc(template) for _ in range(slots)]
        self.used = 0

    def take(self, state) -> int:
        _copy(self.bufs[self.used], state)
        self.used += 1
        return self.used - 1


class Plan:
    """The runs of consecutive units the comparison takes, and when.

    Run 0 starts at unit 0 from the empty state (with lanes: each lane's
    first ``start_units``).  The mix's other ``runs - 1`` start at the
    first unit boundary after times drawn from the seed, uniform over the
    mix's ``spread`` of the window's seconds, each in a lane drawn from the
    seed, one after another.  A run holds the program's states at each of
    its boundaries, so that each unit's mapping step can be judged from
    the program's state as well (a driver with no mapping passes no map
    template and no ``mapping``).  With ``profiled`` (a traced live run) one
    more run covers exactly the profiled units and holds its states only
    at its two ends, so that no copy falls inside the profiled slice; the
    reference's pass over its units gives the sizes of their 5-NN
    searches."""

    def __init__(self, ctx: dict, mix: dict, odo_template, map_template,
                 lanes: int = 1, profiled: bool = False):
        cmp = mix["compare"]
        rng = np.random.default_rng(traffic.derived_seed(ctx["seed"], 7))
        lo, hi = cmp["spread"]
        times = sorted(rng.uniform(lo, hi, cmp["runs"] - 1) * ctx["seconds"])
        self.pending = [{"time": t, "lane": int(rng.integers(lanes)),
                         "units": cmp["units"]} for t in times]
        first = cmp.get("start_units", cmp["units"])
        self.runs = [self._run(0, first, b) for b in range(lanes)]
        self.slice = None
        if profiled:
            prof = mix["profile"]
            self.slice = (prof["skip"] + 1, prof["units"])
            self.runs.append(dict(self._run(*self.slice, 0), profiled=True))
        slots = (lanes * first + len(self.pending) * (cmp["units"] + 1)
                 + 2 * int(profiled))
        self.odo = Held(odo_template, slots)
        self.map = None if map_template is None else Held(map_template, slots)
        self.open = None

    @staticmethod
    def _run(start: int, units: int, lane: int) -> dict:
        return {"start": start, "units": units, "lane": lane,
                "odos": [None] * (units + 1), "maps": [None] * (units + 1)}

    def _take(self, run: dict, j: int, odo, mapping) -> None:
        b = run["lane"]
        run["odos"][j] = self.odo.take(odo(b))
        if self.map is not None:
            run["maps"][j] = self.map.take(mapping(b))

    def _free(self, s: int, units: int) -> bool:
        """Whether a run of ``units`` from boundary ``s`` keeps its copies
        out of the profiled slice and its warm-up unit."""
        if self.slice is None:
            return True
        first, n = self.slice
        return s + units <= first - 1 or s >= first + n + 1

    def starts(self, n: int, elapsed: float, odo, mapping) -> None:
        """At the boundary before unit ``n``, ``elapsed`` seconds into the
        window: copy the states the runs need here.  ``odo(b)`` and
        ``mapping(b)`` give lane b's states as they are now."""
        if (self.open is None and self.pending
                and elapsed >= self.pending[0]["time"]
                and self._free(n, self.pending[0]["units"])):
            run = self.pending.pop(0)
            self.open = self._run(n, run["units"], run["lane"])
            self.runs.append(self.open)
        for run in self.runs:
            j = n - run["start"]
            if run.get("profiled"):
                if j == 0:
                    self._take(run, j, odo, mapping)
            elif 0 <= j <= run["units"]:
                self._take(run, j, odo, mapping)
        if self.open is not None and n == self.open["start"] + self.open["units"]:
            self.open = None

    def ends(self, n: int, odo, mapping) -> None:
        """At the boundary after unit ``n - 1``, once the profiler has
        stepped: the profiled run's last copy."""
        for run in self.runs:
            if run.get("profiled") and n == run["start"] + run["units"]:
                self._take(run, run["units"], odo, mapping)

    def compare_runs(self, sweep, poses) -> list:
        """The completed runs in the form ``compare.compare_runs`` takes:
        ``sweep(k, b)`` is unit k's sweep of lane b (live points), ``poses(k,
        b)`` the program's (odom q, t, map q, t) of it.  States are copied to
        the host."""
        def host(held, i):
            return None if i is None else compare.to_host(held.bufs[i])
        out = []
        for run in self.runs:
            s, u, b = run["start"], run["units"], run["lane"]
            if run["odos"][u] is None:
                continue
            odos = [host(self.odo, i) for i in run["odos"]]
            maps = [host(self.map, i) for i in run["maps"]]
            steps = None
            if not run.get("profiled") and self.map is not None:
                steps = [(maps[j], odos[j + 1], maps[j + 1]) for j in range(u)]
            out.append({
                "odo": odos[0], "map": maps[0], "map_after": maps[u],
                "steps": steps,
                "sweeps": [sweep(s + j, b) for j in range(u)],
                "poses": [poses(s + j, b) for j in range(u)],
                "profiled": bool(run.get("profiled")),
                "start": s, "lane": b})
        return out


def profiler(ctx: dict, mix: dict):
    """(profiler or None, dict that receives its events): with ``--trace
    1`` a ``torch.profiler`` over the mix's ``profile.units`` units after
    the first ``profile.skip`` (one warm-up unit between)."""
    kept = {}
    if not ctx["trace"]:
        return None, kept
    from torch.profiler import ProfilerActivity, profile, schedule

    def ready(p):
        kept["events"] = p.profiler.kineto_results.events()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if ctx["device"].type == "cuda" else [])
    cfg = mix["profile"]
    prof = profile(activities=acts, on_trace_ready=ready,
                   schedule=schedule(wait=cfg["skip"], warmup=1,
                                     active=cfg["units"], repeat=1))
    prof.start()
    return prof, kept


def annotated():
    """The annotation each unit of a traced window runs inside."""
    return torch.profiler.record_function(trace.UNIT)


def setup_split(ctx: dict, sweeps_made: float, warm_end: float,
                setup_s: float) -> dict:
    """Where set-up went, in seconds: the sweeps made (process start to the
    lap held), the warm-up, the fresh start."""
    return {"sweeps_made_s": sweeps_made, "warm_up_s": warm_end - sweeps_made,
            "fresh_start_s": setup_s - warm_end}


def stretch(times: np.ndarray, mix: dict, n: int) -> dict:
    """Mean host ms of the profiled units beside the median of the others
    in the same window: how far the profiler stretches what it records."""
    first, units = mix["profile"]["skip"] + 1, mix["profile"]["units"]
    inside = times[first:min(first + units, n)]
    rest = np.concatenate([times[:first], times[first + units:n]])
    if len(inside) == 0 or len(rest) == 0:
        return {}
    return {"profiled_unit_ms": 1000.0 * float(inside.mean()),
            "other_unit_ms_median": 1000.0 * float(np.median(rest))}


def knn_calls(sizes: list, config: dict) -> list:
    """knn5's (Q, live queries, live references) of each profiled sweep's
    mapping step, from the reference's pass over the same sweeps from the
    program's states (``mapping.step``'s sizes): the step's outer passes
    each search the corner and the surf stacks in the local map, at the
    stack capacities, with live counts cut at the capacities."""
    p = config["mapping"]
    calls = []
    for n_sc, n_lc, n_ss, n_ls in sizes:
        one = [(p["stack_corner_capacity"],
                min(n_sc, p["stack_corner_capacity"]),
                min(n_lc, p["local_corner_capacity"])),
               (p["stack_surf_capacity"],
                min(n_ss, p["stack_surf_capacity"]),
                min(n_ls, p["local_surf_capacity"]))]
        calls += one * p["outer_iterations"]
    return calls

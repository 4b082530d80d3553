"""Peaks of the card and the least time of a kernel's work.

Copied from ``chip_smoke.py`` (``_bound``, ``knn_bound``,
``knn_lanes_bound``, ``vote_bound``, ``segsum_bound`` and the H100 peaks),
so the benchmark's yardstick stays put when the program's scripts change.
``knn_bound`` feeds ``knn5_roofline_pct``; the other two wait for their
metrics (PERF.md, Open questions).

NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: 67 TFLOP/s in
float32 outside the tensor cores, 3.35 TB/s of HBM3; a square root is one
MUFU operation, at a sixteenth of the FP32 rate.  Flops per pair: knn5's
Gram distance is a 3-term dot (5: a multiply and two FMAs), |q|^2 + |r|^2
(1) and -2 q.r (an FMA, 2), so 8; the vote's pair is two such distances
(16), the gap (1) and -(gap^2)/res^2 (2), so 19, and two square roots.
"""

from __future__ import annotations

H100_FP32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12
H100_MUFU_PER_S = H100_FP32_FLOPS / 16
KNN_FLOP_PER_PAIR = 8
VOTE_FLOP_PER_PAIR, VOTE_SQRT_PER_PAIR = 19, 2


def bound_s(flops: float, nbytes: float, mufu: float = 0.0) -> tuple:
    """(least seconds, what bounds it): operations or bytes."""
    t_op = flops / H100_FP32_FLOPS + mufu / H100_MUFU_PER_S
    t_mem = nbytes / H100_BYTES_PER_S
    return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")


def knn_bound(Q: int, counts) -> tuple:
    """knn5 over live (query, reference) counts per lane: it visits qc x rc
    pairs; it reads the live queries (12 B), the live references and their
    mask (13 B) and the counts, and writes every output row (5 x 8 B)."""
    return bound_s(KNN_FLOP_PER_PAIR * sum(qc * rc for qc, rc in counts),
                   sum(12 * qc + 13 * rc + 8 + 40 * Q for qc, rc in counts))


def vote_bound(R: int, K: int) -> tuple:
    """compat_votes over R x K x K pairs; reads src, tgt and valid (7
    floats a point) and writes one float a point."""
    pairs = R * K * K
    return bound_s(VOTE_FLOP_PER_PAIR * pairs, 32 * R * K,
                   VOTE_SQRT_PER_PAIR * pairs)


def segsum_bound(live_rows: int, width_bytes: int, columns: int, slots: int,
                 lanes: int = 1) -> tuple:
    """segment_sum reads each live row (its values and slot id) and writes
    every slot: one add per value read, against bytes over 3.35 TB/s."""
    return bound_s(live_rows * columns,
                   live_rows * (width_bytes + 8) + lanes * slots * width_bytes)

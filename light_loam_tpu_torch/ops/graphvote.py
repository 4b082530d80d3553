"""Graph-matching correspondence-consistency voting.

Counterpart of ``light_loam_tpu/ops/graphvote.py`` — THE Light-LOAM
contribution (RA-L 2024 §III): correspondences vote on each other's
reliability through pairwise rigid-motion compatibility

    score(i, j) = exp(−(‖pᵢ−pⱼ‖_src − ‖pᵢ−pⱼ‖_tgt)² / res²)

``simple_vote`` is the live-path variant (src/laserOdometry.cpp:165-342):
the correspondences split into ``n_regions`` contiguous chunks; each
incompatible pair (score < threshold) adds one vote against both ends;
correspondences with votes ≤ 0.9·chunk_size survive, weighted 5.0 when
votes ≤ 50 else 1.0.  The counts come from ``ops/cuda_vote.py``.

``full_graph_vote`` is the paper's full pipeline, latent in the reference
(graph_construction_partial + graph_based_correspondence_vote_partial,
src/laserMapping.cpp:261-834): per-vertex degree over a 0.95-thresholded
adjacency, first-order reliability as the mean geometric-mean triangle
weight, an adaptive threshold, neighbour pruning, then a 0.1·loose +
0.9·tight score.  The reference's tight pass computes ``pow(x, 1/3)`` with
INTEGER 1/3 == 0 (laserMapping.cpp:597); like the JAX package this takes
the intended cube root of the first-order pass (laserMapping.cpp:457),
the deviation PARITY.md documents.  Its triangle sums are batched
(R, K, K) products in full float32 (torch.bmm; TF32 is off
package-wide), as they are XLA einsums in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from light_loam_tpu_torch.ops.cuda_vote import (
    compat_scores,
    compat_votes,
    compat_votes_plain,
)


# the vote modes run_vote dispatches on
VOTE_MODES = ("off", "simple", "full")


def _chunk_layout(valid: torch.Tensor, n_regions: int):
    """The reference's contiguous chunking of the compacted correspondence
    list (laserOdometry.cpp:202-214): (rank, chunk_id, offset, n_valid,
    base), base = n_valid // n_regions (the last chunk absorbs the
    remainder)."""
    v = valid.to(torch.int64)
    rank = torch.cumsum(v, 0) - v
    n_valid = v.sum()
    base = n_valid // n_regions
    chunk_id = torch.where(
        base == 0,
        torch.full_like(rank, n_regions - 1),
        torch.clamp(rank // torch.clamp(base, min=1), max=n_regions - 1),
    )
    offset = rank - chunk_id * base
    return rank, chunk_id, offset, n_valid, base


def _chunk_sizes(n_valid, base, n_regions: int):
    return torch.cat([base.expand(n_regions - 1),
                      (n_valid - base * (n_regions - 1))[None]])


def _scatter_chunks(values, valid, chunk_id, offset, n_regions: int, K: int):
    """Scatter (Q, ...) values into (n_regions, K, ...) chunk buffers."""
    dest = torch.where(valid, chunk_id * K + torch.clamp(offset, max=K - 1),
                       torch.full_like(chunk_id, n_regions * K))
    out = values.new_zeros((n_regions * K + 1,) + values.shape[1:]
                           ).index_put((dest,), values)
    return out[: n_regions * K].reshape((n_regions, K) + values.shape[1:])


class VoteResult(NamedTuple):
    selected: torch.Tensor  # (Q,) bool — survived the vote
    weight: torch.Tensor    # (Q,) float — optimization weight (0 if not selected)
    votes: torch.Tensor     # (Q,) float — incompatibility votes received


def simple_vote(
    src: torch.Tensor,
    tgt: torch.Tensor,
    valid: torch.Tensor,
    n_regions: int,
    chunk_capacity: int,
    score_threshold: float = 0.96,
    resolution: float = 1.0,
    selected_ratio: float = 0.90,
    low_vote_count: float = 50.0,
    low_vote_weight: float = 5.0,
    high_vote_weight: float = 1.0,
    backend: str = "auto",
) -> VoteResult:
    """Live-path vote (laserOdometry.cpp:165-342).

    src: (Q, 3) current-frame correspondence points; tgt: (Q, 3) their
    matched previous-frame anchors; valid: (Q,) active slots.
    ``chunk_capacity`` must cover Q // n_regions + n_regions.

    ``backend``: "auto"/"pallas" count votes with the CUDA kernel on CUDA
    tensors and the plain version on CPU tensors; "xla" is the plain
    version, which a CUDA tensor refuses (ValueError)."""
    if backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown vote_backend: {backend!r}")
    if backend == "xla" and src.is_cuda:
        raise ValueError(
            "vote_backend='xla' selects the plain PyTorch votes, which the "
            "port runs only on CPU tensors; use 'auto' on CUDA")
    K = chunk_capacity
    rank, chunk_id, offset, n_valid, base = _chunk_layout(valid, n_regions)
    in_chunk = valid & (offset < K)

    csrc = _scatter_chunks(src, in_chunk, chunk_id, offset, n_regions, K)
    ctgt = _scatter_chunks(tgt, in_chunk, chunk_id, offset, n_regions, K)
    cval = _scatter_chunks(in_chunk.to(torch.float32), in_chunk, chunk_id,
                           offset, n_regions, K)
    votes_fn = compat_votes_plain if backend == "xla" else compat_votes
    votes_chunk = votes_fn(csrc, ctgt, cval, score_threshold, resolution)

    sizes = _chunk_sizes(n_valid, base, n_regions).to(torch.float32)
    num_selected = selected_ratio * sizes
    sel_chunk = (votes_chunk <= num_selected[:, None]) & (cval > 0)
    w_chunk = torch.where(votes_chunk <= low_vote_count,
                          float(low_vote_weight),
                          float(high_vote_weight)) * sel_chunk

    flat_idx = torch.where(in_chunk, chunk_id * K + offset,
                           torch.zeros_like(chunk_id))
    zero = torch.zeros((), device=src.device)
    selected = in_chunk & sel_chunk.reshape(-1)[flat_idx]
    weight = torch.where(in_chunk, w_chunk.reshape(-1)[flat_idx], zero)
    votes = torch.where(in_chunk, votes_chunk.reshape(-1)[flat_idx], zero)
    return VoteResult(selected=selected, weight=weight, votes=votes)


def run_vote(
    mode: str,
    src: torch.Tensor,
    tgt: torch.Tensor,
    valid: torch.Tensor,
    n_regions: int,
    chunk_capacity: int,
    score_threshold: float = 0.96,
    resolution: float = 1.0,
    selected_ratio: float = 0.90,
    low_vote_count: float = 50.0,
    low_vote_weight: float = 5.0,
    high_vote_weight: float = 1.0,
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch to the configured vote; returns (selected, weight)."""
    if mode == "off":
        return valid, torch.ones_like(src[:, 0])
    if mode == "simple":
        v = simple_vote(
            src, tgt, valid,
            n_regions=n_regions, chunk_capacity=chunk_capacity,
            score_threshold=score_threshold,
            resolution=resolution,
            selected_ratio=selected_ratio,
            low_vote_count=low_vote_count,
            low_vote_weight=low_vote_weight,
            high_vote_weight=high_vote_weight,
            backend=backend,
        )
        return v.selected, v.weight
    if mode == "full":
        v = full_graph_vote(
            src, tgt, valid,
            n_regions=n_regions, chunk_capacity=chunk_capacity,
            resolution=resolution,
        )
        return v.selected, v.score
    raise ValueError(f"unknown vote mode: {mode}")


class FullVoteResult(NamedTuple):
    selected: torch.Tensor  # (Q,) bool
    score: torch.Tensor     # (Q,) float reliability in [0, 1]
    degree: torch.Tensor    # (Q,) pruned degree


def cube_root(x: torch.Tensor) -> torch.Tensor:
    """Cube root of x ≥ 0 in x's dtype, rounded once.  torch has no cbrt,
    and float32 ``pow(x, 1/3)`` (an exponent of 0.33333334) is off by up
    to 15 ulp at tiny x, as XLA's CPU cbrt is (tests/test_torch_vote.py
    ``test_cube_root_rounds_once``).  Through float64 the exponent's error
    is below 2e-15 relative for any float32 x."""
    return x.double().pow(1.0 / 3.0).to(x.dtype)


def _triangle_sums(B: torch.Tensor, G3: torch.Tensor) -> torch.Tensor:
    """½ · rowsum(B ⊙ (B @ G^⅓)) = Σ_{j<k∈N(i)} (G_ij G_ik G_jk)^⅓ per row,
    B the adjacency-masked cube-root weights."""
    return 0.5 * torch.bmm(B, G3).mul_(B).sum(-1)


def full_graph_vote(
    src: torch.Tensor,
    tgt: torch.Tensor,
    valid: torch.Tensor,
    n_regions: int,
    chunk_capacity: int,
    edge_threshold: float = 0.95,
    resolution: float = 1.0,
    weight_balance: float = 0.9,
) -> FullVoteResult:
    """The paper's full reliability pipeline (laserMapping.cpp:321-834).

    Four (R, K, K) float32 buffers live at once: G, G^⅓, the masked
    weights B and one product.  The adjacency A = G > edge_threshold is
    never stored as floats: B = A ⊙ G^⅓ is pruned in place, and the pruned
    degree and loose sums are masked reductions."""
    K = chunk_capacity
    rank, chunk_id, offset, n_valid, base = _chunk_layout(valid, n_regions)
    in_chunk = valid & (offset < K)

    csrc = _scatter_chunks(src, in_chunk, chunk_id, offset, n_regions, K)
    ctgt = _scatter_chunks(tgt, in_chunk, chunk_id, offset, n_regions, K)
    cval = _scatter_chunks(in_chunk.to(torch.float32), in_chunk, chunk_id,
                           offset, n_regions, K)

    # zero diagonal and padding, like setZero + the skipped self pair
    G = compat_scores(csrc, ctgt, resolution)
    G.mul_(cval[:, :, None]).mul_(cval[:, None, :])
    G.diagonal(dim1=1, dim2=2).zero_()

    # chunk connectivity guard (laserMapping.cpp:392-396)
    connected = (G * G).sum(dim=(1, 2)) > 0                      # (R,)

    adj = G > edge_threshold
    degree = adj.sum(-1, dtype=torch.float32)                    # (R, K)
    G3 = cube_root(G)
    B = torch.where(adj, G3, torch.zeros((), device=G.device))
    tri = _triangle_sums(B, G3)

    denom = degree * (degree - 1.0) * 0.5
    has_tri = degree > 1.0
    zero = torch.zeros((), device=G.device)
    first_order = torch.where(has_tri, tri / torch.clamp(denom, min=1.0), zero)

    # adaptive threshold: min(global ratio, mean score) (laserMapping.cpp:490-492)
    num_a = torch.where(has_tri, tri, zero).sum(-1)
    den_a = torch.where(has_tri, denom, zero).sum(-1)
    param_a = num_a / torch.clamp(den_a, min=1e-12)
    n_in_chunk = torch.clamp(cval.sum(-1), min=1.0)
    param_b = first_order.sum(-1) / n_in_chunk
    threshold = torch.minimum(param_a, param_b)[:, None]         # (R, 1)

    # prune neighbours whose first-order score is below the threshold
    keep = (first_order >= threshold).to(G.dtype)[:, None, :]    # (R, 1, K)
    B.mul_(keep)                                                  # A2 ⊙ G^⅓
    pruned = adj & (keep > 0)
    deg2 = pruned.sum(-1, dtype=torch.float32)

    # loose = mean kept-neighbour edge weight; tight = mean kept-triangle
    # geometric mean, only where the pruned degree > 2
    # (laserMapping.cpp:581-611)
    tri2 = _triangle_sums(B, G3)
    del B, G3
    # integer division in the reference: deg*(deg-2)/2, truncated
    tight_den = torch.floor(deg2 * (deg2 - 2.0) / 2.0)
    loose = torch.where(pruned, G, zero).sum(-1) / torch.clamp(deg2, min=1.0)
    big_enough = deg2 > 2.0
    tight = torch.where(big_enough, tri2 / torch.clamp(tight_den, min=1.0),
                        zero)
    loose = torch.where(big_enough & (deg2 > 0), loose, zero)

    score_chunk = (1.0 - weight_balance) * loose + weight_balance * tight
    score_chunk = score_chunk * connected[:, None].to(G.dtype)
    sel_chunk = (score_chunk != 0.0) & (cval > 0)

    flat_idx = torch.where(in_chunk, chunk_id * K + offset,
                           torch.zeros_like(chunk_id))
    selected = in_chunk & sel_chunk.reshape(-1)[flat_idx]
    score = torch.where(in_chunk, score_chunk.reshape(-1)[flat_idx], zero)
    deg_out = torch.where(in_chunk, deg2.reshape(-1)[flat_idx], zero)
    return FullVoteResult(selected=selected, score=score, degree=deg_out)

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

The paper's full graph pipeline (``full_graph_vote``) is not ported yet:
``run_vote("full", ...)`` raises NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from light_loam_tpu_torch.ops.cuda_vote import compat_votes, compat_votes_plain


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
    sizes = base.expand(n_regions).clone()
    sizes[n_regions - 1] = n_valid - base * (n_regions - 1)
    return sizes


def _scatter_chunks(values, valid, chunk_id, offset, n_regions: int, K: int):
    """Scatter (Q, ...) values into (n_regions, K, ...) chunk buffers."""
    dest = torch.where(valid, chunk_id * K + torch.clamp(offset, max=K - 1),
                       torch.full_like(chunk_id, n_regions * K))
    out = values.new_zeros((n_regions * K + 1,) + values.shape[1:])
    out[dest] = values
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
        raise NotImplementedError(
            "vote mode 'full' (full_graph_vote) is not ported to PyTorch yet")
    raise ValueError(f"unknown vote mode: {mode}")

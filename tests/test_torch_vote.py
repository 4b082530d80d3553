"""Graph-vote counts, the simple vote and the full graph vote of the PyTorch
port against the JAX package.

``compat_votes_plain`` (the plain version of the CUDA vote kernel), the
Pallas kernel in interpret mode and the XLA votes are each held to float64
truth: a distance rounding can flip a score sitting at the threshold, so a
count may differ from the float64 count only by the row's pairs whose
float64 score lies within the float32 rounding bound of the threshold
(``votes_f64`` of test_torch_cuda.py).  The CUDA kernel's host-side
pieces, its launch geometry and the band of exp arguments it decides
without ``expf``, are checked here too; the kernel itself runs in
test_torch_cuda.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_loam_tpu.ops import graphvote as jg
from light_loam_tpu.ops import pallas_vote as jpv
from light_loam_tpu_torch.ops import graphvote as tg
from light_loam_tpu_torch.ops import cuda_vote as cv
from light_loam_tpu_torch.ops.cuda_vote import VOTE, compat_votes, compat_votes_plain
from test_torch_cuda import (
    DECISION_TOL,
    full_vote_case,
    full_vote_margins,
    votes_f64,
)

torch.set_num_threads(2)


def _xla_votes(src, tgt, valid, threshold=0.96, resolution=1.0):
    K = src.shape[1]
    scores = jg._compat_scores(src, tgt, resolution)
    pair_ok = (valid[:, :, None] * valid[:, None, :]) > 0
    incompat = (scores < threshold) & pair_ok & ~jnp.eye(K, dtype=bool)[None]
    return jnp.sum(incompat.astype(jnp.float32), axis=-1)


def _chunks(R, K, seed):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (R, K, 3)).astype(np.float32)
    tgt = src + 0.3
    bad = rng.random((R, K)) < 0.25
    tgt = tgt + np.where(bad[..., None], rng.uniform(2, 8, (R, K, 3)),
                         0.0).astype(np.float32)
    valid = (rng.random((R, K)) < 0.9).astype(np.float32)
    return (src * valid[..., None]).astype(np.float32), \
        (tgt * valid[..., None]).astype(np.float32), valid


@pytest.mark.parametrize("R,K", [(4, 96), (10, 163)])
def test_plain_votes_match_pallas_and_xla(R, K):
    """All three against float64 truth (module docstring): a fraction cap
    at a few hundred counts cannot tell one flipped borderline pair from a
    fault, the rounding bound can."""
    src, tgt, valid = _chunks(R, K, seed=K)
    thr = float(np.float32(0.96))
    got = {
        "plain": compat_votes_plain(torch.as_tensor(src), torch.as_tensor(tgt),
                                    torch.as_tensor(valid), thr).numpy(),
        "pallas": np.asarray(jpv.compat_votes_pallas(
            jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid),
            threshold=thr, interpret=True)),
        "xla": np.asarray(_xla_votes(jnp.asarray(src), jnp.asarray(tgt),
                                     jnp.asarray(valid), threshold=thr)),
    }
    assert got["plain"].max() > 0
    n_loose = 0
    for r in range(R):
        want, loose, _ = votes_f64(*(torch.as_tensor(a[r])
                                     for a in (src, tgt, valid)), thr)
        n_loose += int(loose.sum())
        for name, votes in got.items():
            off = np.abs(votes[r] - want.numpy())
            assert (off <= loose.numpy()).all(), (name, r, off.max())
    # the rounding band is narrow: it excuses a few pairs, not a fault
    assert n_loose < 1e-3 * R * K * K, n_loose


def test_empty_chunks_vote_zero():
    src = torch.zeros((3, 64, 3))
    out = compat_votes(src, src, torch.zeros((3, 64)))
    assert (out == 0).all()


def test_cpu_tensors_do_not_launch_the_kernel():
    VOTE.launches = 0
    src, tgt, valid = _chunks(2, 32, seed=1)
    compat_votes(torch.as_tensor(src), torch.as_tensor(tgt),
                 torch.as_tensor(valid))
    assert VOTE.launches == 0


def _vote_inputs(n=150, seed=1):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    tgt = src + np.float32(0.4)
    bad = np.zeros(n, bool)
    bad[::6] = True
    tgt[bad] += rng.uniform(3, 9, (bad.sum(), 3)).astype(np.float32)
    valid = rng.random(n) < 0.9
    return src, tgt, valid


@pytest.mark.parametrize("n_regions,chunk_capacity", [(5, 48), (10, 163)])
def test_simple_vote_matches_jax(n_regions, chunk_capacity):
    src, tgt, valid = _vote_inputs(n=1536 if n_regions == 10 else 150)
    jv = jg.simple_vote(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid),
                        n_regions=n_regions, chunk_capacity=chunk_capacity,
                        backend="xla")
    tv = tg.simple_vote(torch.as_tensor(src), torch.as_tensor(tgt),
                        torch.as_tensor(valid), n_regions=n_regions,
                        chunk_capacity=chunk_capacity)
    assert 0 < int(np.asarray(jv.selected).sum()) < valid.sum()
    np.testing.assert_array_equal(tv.selected.numpy(), np.asarray(jv.selected))
    np.testing.assert_array_equal(tv.weight.numpy(), np.asarray(jv.weight))
    np.testing.assert_array_equal(tv.votes.numpy(), np.asarray(jv.votes))


def test_simple_vote_matches_jax_pallas_backend():
    src, tgt, valid = _vote_inputs()
    orig = jpv.compat_votes_pallas
    try:
        jpv.compat_votes_pallas = functools.partial(orig, interpret=True)
        jv = jg.simple_vote(jnp.asarray(src), jnp.asarray(tgt),
                            jnp.asarray(valid), n_regions=5,
                            chunk_capacity=48, backend="pallas")
    finally:
        jpv.compat_votes_pallas = orig
    tv = tg.simple_vote(torch.as_tensor(src), torch.as_tensor(tgt),
                        torch.as_tensor(valid), n_regions=5,
                        chunk_capacity=48, backend="pallas")
    np.testing.assert_array_equal(tv.selected.numpy(), np.asarray(jv.selected))
    np.testing.assert_allclose(tv.votes.numpy(), np.asarray(jv.votes), atol=1.0)


def test_run_vote_modes():
    src, tgt, valid = (torch.as_tensor(a) for a in _vote_inputs())
    sel, w = tg.run_vote("off", src, tgt, valid, 5, 48)
    assert torch.equal(sel, valid) and (w == 1).all()
    sel, score = tg.run_vote("full", src, tgt, valid, 5, 48)
    full = tg.full_graph_vote(src, tgt, valid, n_regions=5, chunk_capacity=48)
    assert torch.equal(sel, full.selected) and torch.equal(score, full.score)
    assert 0 < int(sel.sum()) < int(valid.sum())
    assert not sel[~valid].any() and (score[~sel] == 0).all()
    with pytest.raises(ValueError):
        tg.run_vote("bogus", src, tgt, valid, 5, 48)


def test_cube_root_rounds_once():
    """The port's cube root is the float64 cube root rounded once to
    float32; float32 pow(x, 1/3), like XLA's CPU cbrt, is off by up to 15
    ulp at tiny x (the band ROADMAP.md Queue 3 records)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.random(200_000), np.exp(rng.uniform(-87, 0, 200_000)),
                        [0.0, 1.0]]).astype(np.float32)
    exact = np.cbrt(x.astype(np.float64)).astype(np.float32)
    got = tg.cube_root(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, exact)

    def ulps(a):
        return np.abs(a.view(np.int32).astype(np.int64)
                      - exact.view(np.int32).astype(np.int64))

    pow32 = ulps(torch.as_tensor(x).pow(1.0 / 3.0).numpy())
    xla = ulps(np.asarray(jnp.cbrt(jnp.asarray(x))))
    assert 0 < pow32.max() <= 15 and 0 < xla.max() <= 15
    # near the 0.95 adjacency threshold both stay within one ulp
    near = x > 0.9
    assert pow32[near].max() <= 1 and xla[near].max() <= 1


@pytest.mark.parametrize("case", ["literal", "padding", "odometry"])
def test_full_graph_vote_matches_jax_and_literal(case):
    """Selected sets equal to the JAX package's and to the float64 literal
    port of the reference (tests/oracle.py) but for entries a decision of
    which float64 puts within DECISION_TOL of its threshold (named in the
    failure); scores within 1e-5 of JAX's and 1e-3 of the oracle's."""
    from oracle import literal_full_vote

    src, tgt, valid, R, K = full_vote_case(case)
    if case == "odometry":
        assert K == 163
    slots = np.nonzero(valid)[0]
    oracle = literal_full_vote(src[slots], tgt[slots], n_regions=R)
    want_sel = np.zeros(len(valid), bool)
    want_score = np.zeros(len(valid))
    for rank, s in oracle.items():
        want_sel[slots[rank]] = True
        want_score[slots[rank]] = s
    margin = np.full(len(valid), np.inf)
    margin[slots] = full_vote_margins(src[slots], tgt[slots], R)
    excused = margin < DECISION_TOL

    j = jg.full_graph_vote(jnp.asarray(src), jnp.asarray(tgt),
                           jnp.asarray(valid), n_regions=R, chunk_capacity=K)
    t = tg.full_graph_vote(torch.as_tensor(src), torch.as_tensor(tgt),
                           torch.as_tensor(valid), n_regions=R,
                           chunk_capacity=K)
    t_sel, t_score = t.selected.numpy(), t.score.numpy()
    j_sel, j_score = np.asarray(j.selected), np.asarray(j.score)
    assert not t_sel[~valid].any()
    assert 0.3 * valid.sum() < t_sel.sum() < valid.sum()
    for name, other in (("jax", j_sel), ("oracle", want_sel)):
        flips = np.nonzero(t_sel != other)[0]
        bad = [(int(i), float(margin[i])) for i in flips if not excused[i]]
        assert not bad, f"{name}: selection differs at (entry, margin) {bad}"
    both = t_sel & j_sel & ~excused
    np.testing.assert_allclose(t_score[both], j_score[both], rtol=0, atol=1e-5)
    both = t_sel & want_sel & ~excused
    np.testing.assert_allclose(t_score[both], want_score[both], rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(t.degree.numpy()[both],
                                  np.asarray(j.degree)[both])


@pytest.mark.parametrize("R,K", [(10, 163), (10, 829), (3, 300), (1, 1),
                                 (2, 7000), (1, 20000)])
def test_vote_geometry_covers_every_row_once(R, K):
    """Block b of the flattened grid serves chunk b // row_blocks and, warp
    by warp, rows_per_warp rows each from (b % row_blocks) * 8 *
    rows_per_warp on (vote.cu's index arithmetic)."""
    g = cv.vote_geometry(R, K)
    per_block = cv.WARPS_PER_BLOCK * g.rows_per_warp
    seen = np.zeros((R, K), np.int64)
    for b in range(R * g.row_blocks):
        chunk, rb = divmod(b, g.row_blocks)
        for w in range(cv.WARPS_PER_BLOCK):
            for r in range(g.rows_per_warp):
                row = rb * per_block + w * g.rows_per_warp + r
                if row < K:
                    seen[chunk, row] += 1
    assert (seen == 1).all()


def test_vote_geometry_fills_the_card_at_the_odometry_shape():
    assert 10 * cv.vote_geometry(10, 163).row_blocks >= 132


@pytest.mark.parametrize("K", [1, 163, 829, 6000, 20000])
def test_vote_geometry_fits_shared_memory(K):
    g = cv.vote_geometry(10, K)
    assert g.tile == min(K, cv.MAX_TILE)
    # the H100's per-block limit, and the 48 KB vote.cu takes without
    # opting in to more
    assert 0 < g.smem_bytes <= 232_448 and g.smem_bytes <= 48 * 1024


def test_exp_band_decides_as_exp_outside_it():
    """Every float32 argument within 1e-3 of ln 0.96 that falls outside the
    band is decided by ``a < a_lo`` as float64 exp(a) < 0.96 decides it."""
    a_lo, a_hi = cv.exp_band(0.96)
    assert a_lo < a_hi
    c = np.log(0.96)
    lo, hi = np.float32(c - 1e-3), np.float32(c + 1e-3)
    # every float32 between lo and hi (negative: bit patterns run backwards)
    bits = np.arange(hi.view(np.int32), lo.view(np.int32) + 1, dtype=np.int32)
    a = torch.as_tensor(bits.view(np.float32))
    assert len(a) > 100_000
    outside = (a < a_lo) | (a > a_hi)
    exact = torch.exp(a.double()) < 0.96
    assert outside.float().mean() > 0.95
    assert torch.equal((a < a_lo)[outside], exact[outside])


def test_exp_band_is_the_whole_line_where_the_proof_fails():
    for t in (0.0, -1.0, float("inf"), float("nan"), 1e-36):
        assert cv.exp_band(t) == (-np.inf, np.inf)

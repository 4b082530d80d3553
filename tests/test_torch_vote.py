"""Graph-vote counts and the simple vote of the PyTorch port against the JAX
package.

``compat_votes_plain`` (the plain version of the CUDA vote kernel) is held
against the Pallas kernel in interpret mode and the XLA votes, with
tests/test_pallas_vote.py's own tolerance: a distance rounding can flip a
score sitting at the threshold, so each count may differ by at most 1 and
fewer than 1% of the counts may differ."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_loam_tpu.ops import graphvote as jg
from light_loam_tpu.ops import pallas_vote as jpv
from light_loam_tpu_torch.ops import graphvote as tg
from light_loam_tpu_torch.ops.cuda_vote import VOTE, compat_votes, compat_votes_plain

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


def _assert_votes_close(got, want):
    diff = np.abs(got - want)
    assert (diff <= 1.0).all() and (diff > 0).mean() < 0.01, (
        f"max diff {diff.max()}, frac {np.mean(diff > 0)}")


@pytest.mark.parametrize("R,K", [(4, 96), (10, 163)])
def test_plain_votes_match_pallas_and_xla(R, K):
    src, tgt, valid = _chunks(R, K, seed=K)
    got = compat_votes_plain(torch.as_tensor(src), torch.as_tensor(tgt),
                             torch.as_tensor(valid)).numpy()
    assert got.max() > 0
    pallas = np.asarray(jpv.compat_votes_pallas(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid),
        interpret=True))
    _assert_votes_close(got, pallas)
    _assert_votes_close(got, np.asarray(_xla_votes(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid))))


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
    with pytest.raises(NotImplementedError):
        tg.run_vote("full", src, tgt, valid, 5, 48)
    with pytest.raises(ValueError):
        tg.run_vote("bogus", src, tgt, valid, 5, 48)

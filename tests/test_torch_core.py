"""Quaternion algebra of the PyTorch port against the JAX package.

Inputs are made with numpy from a seed and fed to both; outputs agree to
1e-6 (float32 transcendental functions differ in the last ulp between the
two libraries).  The round trips are the port's twins of
tests/test_quaternion.py's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import light_loam_tpu.core as jcore
import light_loam_tpu_torch.core as tcore
from light_loam_tpu.core import quaternion as jq
from light_loam_tpu_torch.core import quaternion as tq

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)


def _quats(rng, n=64):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _both(fn_name, *arrays):
    j = getattr(jq, fn_name)(*[jnp.asarray(a) for a in arrays])
    t = getattr(tq, fn_name)(*[torch.as_tensor(a) for a in arrays])
    return np.asarray(j), t.numpy()


def test_identity():
    np.testing.assert_array_equal(tq.quat_identity().numpy(),
                                  np.asarray(jq.quat_identity()))


@pytest.mark.parametrize("fn_name", [
    "quat_multiply", "quat_inverse", "quat_normalize", "quat_to_matrix",
])
def test_unary_and_binary_ops(fn_name):
    rng = np.random.default_rng(0)
    q1, q2 = _quats(rng), _quats(rng)
    args = (q1, q2) if fn_name == "quat_multiply" else (q1 * 3.0,) \
        if fn_name == "quat_normalize" else (q1,)
    j, t = _both(fn_name, *args)
    np.testing.assert_allclose(t, j, **TOL)


def test_rotate_broadcasts_one_quaternion_over_points():
    rng = np.random.default_rng(1)
    q = _quats(rng, 1)
    p = rng.uniform(-80, 80, (500, 3)).astype(np.float32)
    j, t = _both("quat_rotate", q, p)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-4)  # |p| ~ 100 m


@pytest.mark.parametrize("s", [1.0, 0.5, 0.0])
def test_slerp_identity(s):
    rng = np.random.default_rng(2)
    q = _quats(rng)
    q[:4] = [[0, 0, 0, 1], [1e-8, 0, 0, 1], [0, 0, 0, -1], [0.3, 0, 0, -0.95]]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    sv = np.full(len(q), s, np.float32)
    j, t = _both("quat_slerp_identity", q, sv)
    np.testing.assert_allclose(t, j, **TOL)


def test_exp_including_zero():
    rng = np.random.default_rng(3)
    phi = rng.normal(scale=0.3, size=(64, 3)).astype(np.float32)
    phi[0] = 0.0
    phi[1] = 1e-9
    j, t = _both("quat_exp", phi)
    np.testing.assert_allclose(t, j, **TOL)


def _hard_quats(rng):
    """Unit quaternions with w >= 0 and w < 0, near-pi rotations about
    each axis and off-axis (|w| = 1e-3, so the canonical sign is not a
    rounding choice), the identity and its negation, a tiny rotation."""
    q = _quats(rng)
    hard = [[0, 0, 0, 1], [0, 0, 0, -1], [1e-5, 0, 0, 1],
            [1, 0, 0, 1e-3], [0, 1, 0, -1e-3], [0, 0, 1, 1e-3],
            [0.6, -0.8, 0, 1e-3], [0.5, 0.5, -0.7, -1e-3],
            [0.3, 0, 0, -0.95], [-0.2, 0.4, 0.1, -0.8]]
    q[:len(hard)] = hard
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_log_matches_jax():
    q = _hard_quats(np.random.default_rng(5))
    j, t = _both("quat_log", q)
    np.testing.assert_allclose(t, j, **TOL)


def test_matrix_to_quat_matches_jax():
    q = _hard_quats(np.random.default_rng(6))
    m = np.array(jq.quat_to_matrix(jnp.asarray(q)))
    j, t = _both("matrix_to_quat", m)
    np.testing.assert_allclose(t, j, **TOL)
    assert (t[:, 3] >= 0).all()


def test_matrix_roundtrip():
    """tests/test_quaternion.py::test_matrix_roundtrip on the port."""
    rng = np.random.default_rng(2)
    qq = _quats(rng, 32)
    qq = qq * np.where(qq[..., 3:4] < 0, -1.0, 1.0).astype(np.float32)
    back = tq.matrix_to_quat(tq.quat_to_matrix(torch.as_tensor(qq)))
    np.testing.assert_allclose(back.numpy(), qq, atol=1e-4)


def test_exp_log_roundtrip():
    """tests/test_quaternion.py::test_exp_log_roundtrip on the port."""
    rng = np.random.default_rng(3)
    phi = rng.normal(scale=0.5, size=(16, 3)).astype(np.float32)
    back = tq.quat_log(tq.quat_exp(torch.as_tensor(phi)))
    np.testing.assert_allclose(back.numpy(), phi, atol=1e-5)


def test_core_exports_what_the_jax_package_exports():
    assert tcore.__all__ == jcore.__all__
    for name in tcore.__all__:
        assert callable(getattr(tcore, name)), name

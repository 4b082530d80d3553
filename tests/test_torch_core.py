"""Quaternion algebra of the PyTorch port against the JAX package.

Inputs are made with numpy from a seed and fed to both; outputs agree to
1e-6 (float32 transcendental functions differ in the last ulp between the
two libraries)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

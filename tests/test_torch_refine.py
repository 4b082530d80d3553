"""The windowed Schur-complement refinement of the PyTorch port against the
JAX package: solver/schur.py, ops/knn.py ``knn_tiled`` and
models/refine.py, twins of tests/test_refine.py at make_ba_problem's sizes
(K 4, M 24, P 256).  ~10 s on two CPU threads.

Tolerances:
  * ``schur_solve``: 1e-5 relative to the JAX package's on a window's
    reduced system (both float32, summed in another order), and the 1e-3 of
    tests/test_refine.py against a float64 dense solve;
  * ``knn_tiled``: indices exact and, on lattice inputs (every product and
    sum of the Gram form exact in float32), distances exact; on random
    inputs distances within the Gram-form band of tests/test_torch_knn.py
    (the cross term's 3-term dot rounds differently in XLA and in torch);
  * ``extract_landmarks``: anchors and the k-NN exact.  The plane fit solves
    the normal equations of 5 map points in float32 (ROADMAP Queue 3: every
    fit here has cond(AᵀA) of 6e3-3e9), so which anchors pass the 0.2 m
    gate is decided by rounding: the port and the JAX package differ on a
    few of the 256 anchors of the map below.  Given one fit (the JAX
    package's solve, handed to both), the masks agree exactly except within
    1e-4 of a gate (``fit_gate`` or d2[:, -1] against 1.0); with each
    package's own float32 fit, on at least 95 % of the anchors (the few
    percent of flipped plane factors of tests/test_torch_mapping.py), and
    the port no further from the float64 decision than the JAX package;
  * ``refine_window``: poses within 1e-4 (tests/test_refine.py:111-112).
The sharded twin (``test_refine_sharded_matches_single``) is in
tests/test_torch_sharded.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import light_loam_tpu.models.mapping as jmapping
from light_loam_tpu.models import refine as jr
from light_loam_tpu.ops import knn as jk
from light_loam_tpu.ops import voxel as jvoxel
from light_loam_tpu.solver import schur as js
from light_loam_tpu.utils.synthetic import World, pad_cloud, simulate_scan
from light_loam_tpu_torch.models import refine as tr
from light_loam_tpu_torch.ops import knn as tk
from light_loam_tpu_torch.solver import schur as ts
from test_refine import make_ba_problem
from test_torch_cuda import lattice_knn_inputs
from test_torch_knn import _assert_knn_equal

torch.set_num_threads(2)

SCHUR_RTOL = 1e-5
POSE_TOL = 1e-4
GATE_BAND = 1e-4


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _system(rng, K=3, M=5, n_res=40):
    """tests/test_refine.py::test_schur_matches_dense_solve's system: block
    form (float64) and the full matrix it stands for."""
    Jp = rng.normal(size=(n_res, K, 6)) * (rng.random((n_res, K, 1)) < 0.6)
    Jl = rng.normal(size=(n_res, M, 3)) * (rng.random((n_res, M, 1)) < 0.6)
    r = rng.normal(size=n_res)
    Hpp = np.zeros((K, 6, 6)); g_p = np.zeros((K, 6))
    Hll = np.zeros((M, 3, 3)); g_l = np.zeros((M, 3))
    Hpl = np.zeros((K, M, 6, 3))
    H = np.zeros((K * 6 + M * 3, K * 6 + M * 3))
    g = np.zeros(K * 6 + M * 3)
    for i in range(n_res):
        k = rng.integers(0, K); m = rng.integers(0, M)
        jp = Jp[i, k]; jl = Jl[i, m]
        Hpp[k] += np.outer(jp, jp); g_p[k] += jp * r[i]
        Hll[m] += np.outer(jl, jl); g_l[m] += jl * r[i]
        Hpl[k, m] += np.outer(jp, jl)
        row = np.zeros(K * 6 + M * 3)
        row[k * 6:(k + 1) * 6] = jp
        row[K * 6 + m * 3:K * 6 + (m + 1) * 3] = jl
        H += np.outer(row, row)
        g += row * r[i]
    blocks = [b.astype(np.float32) for b in (Hpp, g_p, Hpl, Hll, g_l)]
    return blocks, H, g


def _dense(H, g, K, M, damping, prior0):
    Hd = H.copy()
    for k in range(K):
        blk = slice(k * 6, (k + 1) * 6)
        Hd[blk, blk] += damping * (1 + np.trace(H[blk, blk])) * np.eye(6)
    Hd[:6, :6] += prior0 * np.eye(6)
    for m in range(M):
        blk = slice(K * 6 + m * 3, K * 6 + (m + 1) * 3)
        Hd[blk, blk] += damping * (1 + np.trace(H[blk, blk])) * np.eye(3)
    return np.linalg.solve(Hd, -g)


def _assert_rel(a, b, rtol=SCHUR_RTOL):
    a, b = _np(a), _np(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


def _ba_blocks(seed=1):
    """The reduced system of make_ba_problem's window (K 4, M 24, P 256)
    at its initial poses: one iteration's blocks, in float32."""
    _, (q0, t0), stacks, lm = _ba(seed)
    K, P = stacks.shape[:2]
    tlm = _tlm(lm)
    blocks, _ = tr.normal_equations(
        _t(q0), _t(t0), _t(stacks), torch.ones((K, P), dtype=torch.bool),
        tlm, tlm.n, tlm.d, 0.1, 2.0, 1.0)
    return [b.numpy() for b in blocks]


def test_schur_matches_jax():
    """The reduced solve of a real window, gauge prior on keyframe 0: the
    1e8 prior makes S badly scaled in float32, so the products stay full
    FP32 (no TF32) and the port is within 1e-5 of the JAX package's."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    blocks = _ba_blocks()
    dp_t, dl_t = ts.schur_solve(*map(_t, blocks), damping=1e-4)
    dp_j, dl_j = js.schur_solve(*map(jnp.asarray, blocks), damping=1e-4)
    _assert_rel(dp_t, dp_j)
    _assert_rel(dl_t, dl_j)
    assert np.abs(_np(dp_t)).max() > 1e-3


@pytest.mark.parametrize("fix_first_pose", [False, True])
def test_schur_matches_dense_solve(fix_first_pose):
    """tests/test_refine.py::test_schur_matches_dense_solve for both
    packages (and with the gauge prior).  That system is near singular
    (cond(H) ~1e19, the damping alone regularises it), so the two float32
    solves are held to the float64 one at its 1e-3, not to each other at
    1e-5 (they differ by 9e-5)."""
    K, M, damping = 3, 5, 1e-3
    blocks, H, g = _system(np.random.default_rng(2), K, M)
    delta = _dense(H, g, K, M, damping, 1e8 if fix_first_pose else 0.0)
    for dp, dl in (
            ts.schur_solve(*map(_t, blocks), damping=damping,
                           fix_first_pose=fix_first_pose),
            js.schur_solve(*map(jnp.asarray, blocks), damping=damping,
                           fix_first_pose=fix_first_pose)):
        np.testing.assert_allclose(_np(dp).reshape(-1), delta[:K * 6],
                                   atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(_np(dl).reshape(-1), delta[K * 6:],
                                   atol=1e-3, rtol=1e-3)


def test_inv3x3_matches_jax_with_singular_blocks():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    # exactly singular (integer entries: det is exactly 0 in float32)
    A[5] = 0.0
    A[9] = np.outer([1.0, 2.0, 3.0], [1.0, -2.0, 4.0])    # rank 1
    A[11] = [[1.0, 2.0, 3.0], [-2.0, 0.0, 5.0], [-1.0, 2.0, 8.0]]  # rank 2
    inv_t = ts._inv3x3(_t(A))
    inv_j = js._inv3x3(jnp.asarray(A))
    np.testing.assert_allclose(_np(inv_t), _np(inv_j), rtol=1e-5, atol=1e-5)
    for i in (5, 9, 11):
        assert (_np(inv_t)[i] == 0).all()


def test_schur_singular_landmark_and_all_masked_window():
    """A landmark nobody observes, undamped, has a singular block: it drops
    out (zeros in its inverse, dl = 0) and the rest matches the JAX package;
    an all-masked window solves to finite zeros; and an exactly singular
    reduced system (no damping, no gauge prior) gives zeros, as the JAX
    package's LU does through its finiteness guard."""
    Hpp, g_p, Hpl, Hll, g_l = _ba_blocks()
    Hll[2] = 0.0
    Hpl[:, 2] = 0.0
    g_l[2] = 0.0
    blocks = (Hpp, g_p, Hpl, Hll, g_l)
    out_t = ts.schur_solve(*map(_t, blocks), damping=0.0)
    out_j = js.schur_solve(*map(jnp.asarray, blocks), damping=0.0)
    for a, b in zip(out_t, out_j):
        assert torch.isfinite(a).all()
        _assert_rel(a, b)
    assert (_np(out_t[1])[2] == 0).all()

    zeros = [np.zeros_like(b) for b in blocks]
    for damping, fix in ((1e-4, True), (0.0, False)):
        dp_t, dl_t = ts.schur_solve(*map(_t, zeros), damping=damping,
                                    fix_first_pose=fix)
        dp_j, dl_j = js.schur_solve(*map(jnp.asarray, zeros),
                                    damping=damping, fix_first_pose=fix)
        for a, b in ((dp_t, dp_j), (dl_t, dl_j)):
            assert (_np(a) == 0).all() and (_np(b) == 0).all()


def test_schur_nonfinite_solve_gives_zeros():
    K, M = 2, 3
    blocks, _, _ = _system(np.random.default_rng(5), K, M)
    blocks[0][1, 2, 2] = np.nan
    dp_t, dl_t = ts.schur_solve(*map(_t, blocks))
    dp_j, dl_j = js.schur_solve(*map(jnp.asarray, blocks))
    for a, b in ((dp_t, dp_j), (dl_t, dl_j)):
        assert (_np(a) == 0).all() and (_np(b) == 0).all()


def _random_cloud(rng, n, scale=60.0):
    return ((rng.random((n, 3)) - 0.5) * scale).astype(np.float32)


@pytest.mark.parametrize("inputs", ["random", "lattice", "few_live"])
@pytest.mark.parametrize("ref_count", [False, True])
def test_knn_tiled_matches_jax(inputs, ref_count):
    """Streamed k-NN: first-index ties inside a tile, the running best ahead
    of the tile in the merge, (1e30, 0) where fewer than k references are
    live, and ``ref_count`` skipping the dead tail."""
    rng = np.random.default_rng(6)
    Q, N, tile, rc = 150, 2000, 256, 1100
    if inputs == "lattice":
        q, r, m = lattice_knn_inputs(Q, N, rc, seed=7, segments=8)
    else:
        q, r = _random_cloud(rng, Q), _random_cloud(rng, N)
        m = (rng.random(N) < 0.8) & (np.arange(N) < rc)
        if inputs == "few_live":
            m = np.zeros(N, bool)
            m[[3, 700, rc - 1]] = True
    count = rc if ref_count else None
    d_t, i_t = tk.knn_tiled(_t(q), _t(r), _t(m), k=5, tile=tile,
                            ref_count=count)
    d_j, i_j = jk.knn_tiled(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m),
                            k=5, tile=tile,
                            ref_count=None if count is None
                            else jnp.int32(count))
    d_j, i_j = np.asarray(d_j), np.asarray(i_j)
    assert i_t.dtype == torch.int32
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    if inputs == "lattice":
        np.testing.assert_array_equal(d_t.numpy(), d_j)
    else:
        _assert_knn_equal(q, r, d_t, i_t, d_j, i_j)
    if inputs == "few_live":
        assert (d_t[:, 3:] == 1e30).all() and (i_t[:, 3:] == 0).all()
        assert (d_t[:, :3] < 1e20).all()


def _scan_map(seed=19, capacity=32768):
    """The surf-map stand-in: one synthetic hdl64 sweep of
    ``World.urban(seed)``, padded to ``capacity`` rows."""
    pts = simulate_scan(World.urban(seed=seed), np.zeros(3), n_azimuth=500,
                        noise=0.01, seed=50)
    return pad_cloud(pts, capacity)


def test_extract_landmarks_matches_jax_given_one_fit(monkeypatch):
    """Everything but the ill-conditioned solve, exactly: both packages'
    3×3 solve is replaced by the JAX package's float32 result on its own
    normal equations, so both gate the same planes; the masks then agree
    except within 1e-4 of a gate."""
    xyz, mask = _scan_map()
    anchors, _, _, _ = jvoxel.voxel_downsample(
        jnp.asarray(xyz), jnp.zeros(len(xyz)), jnp.asarray(mask), 4.0, 256)
    d2, idx = jk.knn_tiled(anchors, jnp.asarray(xyz), jnp.asarray(mask),
                           k=5, tile=4096)
    near = jnp.asarray(xyz)[idx]
    fit = jmapping._solve3x3(jnp.einsum("qni,qnj->qij", near, near),
                             -jnp.sum(near, axis=1))
    monkeypatch.setattr(jmapping, "_solve3x3", lambda A, b: fit)
    monkeypatch.setattr(tr, "_solve3x3",
                        lambda A, b: tuple(_t(x) for x in fit))

    lm_j = jr.extract_landmarks(jnp.asarray(xyz), jnp.asarray(mask), 256)
    lm_t = tr.extract_landmarks(_t(xyz), _t(mask), 256)
    np.testing.assert_array_equal(_np(lm_t.anchor), _np(lm_j.anchor))
    resid = np.abs(np.einsum("qni,qi->qn", _np(near), _np(lm_j.n))
                   + _np(lm_j.d)[:, None])
    near_gate = ((np.abs(resid - 0.2) < GATE_BAND).any(axis=1)
                 | (np.abs(_np(d2)[:, -1] - 1.0) < GATE_BAND))
    m_j, m_t = _np(lm_j.mask), _np(lm_t.mask)
    assert m_j.sum() >= 5
    np.testing.assert_array_equal(m_t[~near_gate], m_j[~near_gate])
    np.testing.assert_allclose(_np(lm_t.n)[m_j], _np(lm_j.n)[m_j],
                               atol=1e-6)
    np.testing.assert_allclose(_np(lm_t.d)[m_j], _np(lm_j.d)[m_j],
                               rtol=1e-6)


def _f64_masks(xyz, mask, anchors):
    """The gates decided on a float64 fit of the same neighbours."""
    d2, idx = jk.knn_tiled(jnp.asarray(anchors), jnp.asarray(xyz),
                           jnp.asarray(mask), k=5, tile=4096)
    near = xyz[np.asarray(idx)].astype(np.float64)
    x = np.linalg.solve(np.einsum("qni,qnj->qij", near, near),
                        -near.sum(axis=1)[..., None])[..., 0]
    norm = np.linalg.norm(x, axis=1)
    resid = np.abs(np.einsum("qni,qi->qn", near, x / norm[:, None])
                   + 1.0 / norm[:, None])
    return (np.asarray(d2)[:, -1] < 1.0) & (resid <= 0.2).all(axis=1)


def test_extract_landmarks_float32_fit_band():
    """The whole function, float32 fits included: anchors exact, the masks
    on at least 95 % of the anchors, and the port's masks as close to the
    float64 decision as the JAX package's, within 2 % of the anchors.  (The
    float32 fit is the reference's fault: here it rejects ~110 of the ~120
    neighbourhoods that a float64 fit of the same points accepts.)"""
    xyz, mask = _scan_map()
    lm_j = jr.extract_landmarks(jnp.asarray(xyz), jnp.asarray(mask), 256)
    lm_t = tr.extract_landmarks(_t(xyz), _t(mask), 256)
    np.testing.assert_array_equal(_np(lm_t.anchor), _np(lm_j.anchor))
    m_j, m_t = _np(lm_j.mask), _np(lm_t.mask)
    assert m_j.sum() >= 5
    assert (m_j != m_t).mean() <= 0.05, (m_j != m_t).sum()
    truth = _f64_masks(xyz, mask, _np(lm_j.anchor))
    assert truth.sum() > 4 * m_j.sum()
    assert (m_t != truth).sum() <= (m_j != truth).sum() + 0.02 * len(m_j)


def test_normal_basis_matches_jax():
    rng = np.random.default_rng(8)
    n = rng.normal(size=(200, 3)).astype(np.float32)
    n[:20] = [[1.0, 0.0, 0.0]] * 20  # the second reference axis
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    for a, b in zip(tr._normal_basis(_t(n)), jr._normal_basis(jnp.asarray(n))):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)


def _ba(seed, **kw):
    rng = np.random.default_rng(seed)
    (q_true, t_true), (q0, t0), stacks, lm = make_ba_problem(rng, **kw)
    return (q_true, t_true), (q0, t0), stacks, lm


def _tlm(lm):
    return tr.PlaneLandmarks(*[_t(x) for x in lm])


@pytest.mark.parametrize("case", ["full", "masked", "tied_anchors"])
def test_refine_window_matches_jax(case):
    """Poses and landmarks after 4 iterations; "masked" drops a quarter of
    the stack points and two landmarks, "tied_anchors" duplicates landmark
    3's anchor into landmark 7 so that every association to it is a tie
    (argmin keeps the first index in both packages)."""
    _, (q0, t0), stacks, lm = _ba(1)
    K, P = stacks.shape[:2]
    mask = np.ones((K, P), bool)
    if case == "masked":
        mask = np.random.default_rng(9).random((K, P)) > 0.25
        lm = lm._replace(mask=lm.mask.at[jnp.asarray([2, 11])].set(False))
    if case == "tied_anchors":
        lm = lm._replace(anchor=lm.anchor.at[7].set(lm.anchor[3]))
    q_j, t_j, lm_j = jr.refine_window(jnp.asarray(q0), jnp.asarray(t0),
                                      jnp.asarray(stacks), jnp.asarray(mask),
                                      lm, n_iterations=4)
    q_t, t_t, lm_t = tr.refine_window(_t(q0), _t(t0), _t(stacks), _t(mask),
                                      _tlm(lm), n_iterations=4)
    np.testing.assert_allclose(_np(t_t), _np(t_j), atol=POSE_TOL)
    np.testing.assert_allclose(_np(q_t), _np(q_j), atol=POSE_TOL)
    np.testing.assert_allclose(_np(lm_t.n), _np(lm_j.n), atol=POSE_TOL)
    np.testing.assert_allclose(_np(lm_t.d), _np(lm_j.d), atol=POSE_TOL)
    # a moved pose, not a no-op: the window does work
    assert np.abs(_np(t_t) - t0).max() > 1e-3


def test_argmin_keeps_the_first_of_equal_distances():
    d = torch.tensor([[3.0, 1.0, 1.0, 2.0], [0.5, 0.5, 0.5, 0.5]])
    np.testing.assert_array_equal(torch.argmin(d, dim=-1).numpy(), [1, 0])
    np.testing.assert_array_equal(np.asarray(jnp.argmin(jnp.asarray(
        d.numpy()), axis=-1)), [1, 0])


def test_refine_recovers_poses():
    """tests/test_refine.py::test_refine_recovers_poses on the port alone."""
    (q_true, t_true), (q0, t0), stacks, lm = _ba(0)
    K, P = stacks.shape[:2]
    err0 = np.linalg.norm(t0 - t_true, axis=1).mean()
    q, t, _ = tr.refine_window(_t(q0), _t(t0), _t(stacks),
                               torch.ones((K, P), dtype=torch.bool),
                               _tlm(lm), n_iterations=6)
    err1 = np.linalg.norm(_np(t) - t_true, axis=1).mean()
    assert err1 < 0.25 * err0, f"refine did not converge: {err0} -> {err1}"
    assert err1 < 0.02
    dots = np.abs(np.sum(_np(q) * q_true, axis=1))
    assert (dots > 0.9999).all()


def test_refine_hooks_default_to_one_device():
    """The collectives left for a multi-process window default to identity
    and offset 0: passing them explicitly changes nothing."""
    _, (q0, t0), stacks, lm = _ba(2)
    K, P = stacks.shape[:2]
    args = (_t(q0), _t(t0), _t(stacks), torch.ones((K, P), dtype=torch.bool),
            _tlm(lm))
    q_a, t_a, _ = tr.refine_window(*args, n_iterations=2)
    q_b, t_b, _ = tr.refine_window(*args, n_iterations=2,
                                   psum=lambda x: x,
                                   gather_poses=lambda x: x, offset=0)
    assert torch.equal(q_a, q_b) and torch.equal(t_a, t_b)

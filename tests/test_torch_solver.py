"""Residuals, analytic Jacobians and the LM solve of the PyTorch port.

All six factor types (the live path's edge, plane and plane-norm factors
and the reference's latent scalar-edge, componentwise-plane and distance
factors): residuals agree with the JAX package to 1e-5 and Jacobians to
1e-5 relative / 1e-4 absolute (entries reach ~20 m, a few float32 ulps); in
float64 the analytic Jacobians equal ``torch.autograd``'s through the
right-tangent update q ⊗ Exp(δθ), t + δt to 1e-8; the LM pose agrees with
the JAX package's to 1e-5, with one family or all six."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_loam_tpu import solver as js
from light_loam_tpu_torch import solver as ts
from light_loam_tpu_torch.core import quaternion as tq

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _pose(rng):
    q = rng.normal(size=4).astype(np.float32)
    q[3] = 3.0  # a moderate rotation, away from the identity
    return (q / np.linalg.norm(q)).astype(np.float32), \
        rng.normal(size=3).astype(np.float32)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _factors(kind, rng, n=64):
    cp = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    mask = rng.random(n) < 0.9
    s = np.ones(n, np.float32)
    if kind in ("edge", "edge_scalar"):
        a = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
        b = a + rng.normal(size=(n, 3)).astype(np.float32)
        return dict(cp=cp, a=a, b=b, s=s, weight=w, mask=mask)
    if kind == "plane":
        a, b, c = (rng.uniform(-20, 20, (n, 3)).astype(np.float32)
                   for _ in range(3))
        return dict(cp=cp, a=a, b=b, c=c, s=s, weight=w, mask=mask)
    if kind == "plane_component":
        return dict(cp=cp, j=rng.uniform(-20, 20, (n, 3)).astype(np.float32),
                    n=_unit(rng, n), s=s, weight=w, mask=mask)
    if kind == "distance":
        return dict(cp=cp, target=rng.uniform(-20, 20, (n, 3)).astype(
            np.float32), weight=w, mask=mask)
    return dict(cp=cp, n=_unit(rng, n), d=rng.normal(size=n).astype(np.float32),
                weight=w, mask=mask)


_CLASSES = {"edge": "EdgeFactors", "plane_norm": "PlaneNormFactors",
            "edge_scalar": "EdgeScalarFactors",
            "plane_component": "PlaneComponentFactors",
            "distance": "DistanceFactors"}


def _build(pkg, kind, f, to):
    f = {k: to(v) for k, v in f.items()}
    if kind == "plane":
        return pkg.make_plane_factors(**f), pkg.plane_residuals
    return (getattr(pkg, _CLASSES[kind])(**f),
            getattr(pkg.residuals, f"{kind}_residuals"))


KINDS = ["edge", "plane", "plane_norm", "edge_scalar", "plane_component",
         "distance"]


@pytest.mark.parametrize("kind", KINDS)
def test_residuals_and_jacobians_match_jax(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    q, t = _pose(rng)
    f = _factors(kind, rng)
    jf, jfn = _build(js, kind, f, jnp.asarray)
    tf, tfn = _build(ts, kind, f, torch.as_tensor)
    jr, jJ = jfn(jnp.asarray(q), jnp.asarray(t), jf)
    tr, tJ = tfn(torch.as_tensor(q), torch.as_tensor(t), tf)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)
    np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_analytic_jacobians_match_autograd(kind):
    rng = np.random.default_rng(10 + KINDS.index(kind))
    q, t = _pose(rng)
    f = _factors(kind, rng, n=16)
    fac, fn = _build(ts, kind, f, lambda a: torch.as_tensor(
        a.astype(np.float64) if a.dtype == np.float32 else a))
    q0, t0 = torch.as_tensor(q, dtype=torch.float64), torch.as_tensor(
        t, dtype=torch.float64)

    def residual(delta):
        qd = tq.quat_multiply(q0, tq.quat_exp(delta[:3]))
        return fn(qd, t0 + delta[3:], fac)[0]

    auto = torch.autograd.functional.jacobian(
        residual, torch.zeros(6, dtype=torch.float64))
    _, J = fn(q0, t0, fac)
    np.testing.assert_allclose(J.numpy(), auto.numpy(), rtol=1e-8, atol=1e-8)


def test_lm_solve_matches_jax():
    rng = np.random.default_rng(20)
    q_true, t_true = _pose(rng)
    n = 300
    # planes through points of the true pose: n·(R p + t) + d = 0
    cp = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    pw = np.asarray(tq.quat_rotate(torch.as_tensor(q_true)[None],
                                   torch.as_tensor(cp))) + t_true
    d = (-(nrm * pw).sum(1) + rng.normal(scale=0.02, size=n)).astype(np.float32)
    f = dict(cp=cp, n=nrm, d=d, weight=np.ones(n, np.float32),
             mask=rng.random(n) < 0.95)
    q0 = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    t0 = np.zeros(3, np.float32)
    jq, jt, jc = js.lm_solve(jnp.asarray(q0), jnp.asarray(t0), js.FactorSet(
        plane_norm=js.PlaneNormFactors(**{k: jnp.asarray(v) for k, v in f.items()})),
        n_iterations=8)
    tq_, tt, tc = ts.lm_solve(torch.as_tensor(q0), torch.as_tensor(t0), ts.FactorSet(
        plane_norm=ts.PlaneNormFactors(**{k: torch.as_tensor(v) for k, v in f.items()})),
        n_iterations=8)
    np.testing.assert_allclose(tq_.numpy(), np.asarray(jq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-6)
    # and it actually moved toward the true pose
    assert np.linalg.norm(tt.numpy() - t_true) < np.linalg.norm(t_true) * 0.5


def test_lm_solve_without_factors_keeps_the_pose():
    q0 = torch.tensor([0.1, 0.0, 0.0, 0.995])
    t0 = torch.tensor([1.0, 2.0, 3.0])
    f = _factors("plane_norm", np.random.default_rng(3), n=8)
    f["mask"] = np.zeros(8, bool)
    fs = ts.FactorSet(plane_norm=ts.PlaneNormFactors(
        **{k: torch.as_tensor(v) for k, v in f.items()}))
    q, t, _ = ts.lm_solve(q0, t0, fs)
    assert torch.equal(q, q0) and torch.equal(t, t0)


def _consistent_factors(kind, rng, q_true, t_true, n=120):
    """Factors of one kind that the true pose satisfies up to ~1 cm of
    noise, so the LM has a minimum to find."""
    f = _factors(kind, rng, n)
    pw = np.asarray(tq.quat_rotate(torch.as_tensor(q_true)[None],
                                   torch.as_tensor(f["cp"]))) + t_true
    noise = rng.normal(scale=0.01, size=(n, 3)).astype(np.float32)
    if kind in ("edge", "edge_scalar"):
        d = rng.normal(size=(n, 3)).astype(np.float32)
        f["a"] = (pw + noise + d).astype(np.float32)
        f["b"] = (pw + noise - d).astype(np.float32)
    elif kind == "plane":
        u, v = _unit(rng, n), _unit(rng, n)
        f["a"] = (pw + noise).astype(np.float32)
        f["b"] = (pw + noise + 3 * u).astype(np.float32)
        f["c"] = (pw + noise + 3 * v).astype(np.float32)
    elif kind == "plane_component":
        f["j"] = (pw + noise).astype(np.float32)
    elif kind == "distance":
        f["target"] = (pw + noise).astype(np.float32)
    else:
        f["d"] = (-(f["n"] * pw).sum(1) + noise[:, 0]).astype(np.float32)
    return f


def test_lm_solve_with_all_six_families_matches_jax():
    rng = np.random.default_rng(21)
    q_true = np.asarray(tq.quat_normalize(torch.as_tensor(
        [0.05, -0.03, 0.02, 1.0])))
    t_true = np.array([0.4, -0.2, 0.1], np.float32)
    fs = {kind: _consistent_factors(kind, rng, q_true, t_true)
          for kind in KINDS}
    jset = js.FactorSet(**{k: _build(js, k, f, jnp.asarray)[0]
                           for k, f in fs.items()})
    tset = ts.FactorSet(**{k: _build(ts, k, f, torch.as_tensor)[0]
                           for k, f in fs.items()})
    assert all(f is not None for f in tset)
    q0 = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    t0 = np.zeros(3, np.float32)
    jq, jt, jc = js.lm_solve(jnp.asarray(q0), jnp.asarray(t0), jset,
                             n_iterations=6)
    tq_, tt, tc = ts.lm_solve(torch.as_tensor(q0), torch.as_tensor(t0), tset,
                              n_iterations=6)
    np.testing.assert_allclose(tq_.numpy(), np.asarray(jq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-6)
    # every family pulls toward the true pose
    assert np.linalg.norm(tt.numpy() - t_true) < 0.05


# The odometry's solve as one CUDA kernel (csrc/lm.cu, behind the custom
# op light_loam_tpu_torch::lm_solve_edge_plane): which calls take it, and
# its CPU kernel, the plain loop, here.  The kernel itself is held to the
# plain loop on the card (tests/test_torch_cuda.py).

def _edge_plane_set(seed, n=120):
    """FactorSet of the edge and plane families that a pose off the
    identity satisfies up to ~1 cm (the JAX-parity inputs above)."""
    rng = np.random.default_rng(seed)
    q_true = np.asarray(tq.quat_normalize(torch.as_tensor(
        [0.04, -0.02, 0.03, 1.0])))
    t_true = np.array([0.5, -0.3, 0.1], np.float32)
    return ts.FactorSet(**{
        kind: _build(ts, kind, _consistent_factors(kind, rng, q_true, t_true,
                                                   n), torch.as_tensor)[0]
        for kind in ("edge", "plane")})


def _plane_norm_set(seed):
    f = _factors("plane_norm", np.random.default_rng(seed), n=16)
    return ts.PlaneNormFactors(**{k: torch.as_tensor(v) for k, v in f.items()})


def _edge_scalar_set(seed):
    f = _factors("edge_scalar", np.random.default_rng(seed), n=16)
    return ts.EdgeScalarFactors(**{k: torch.as_tensor(v)
                                   for k, v in f.items()})


_ROUTES = {
    # (device, dtype, families, allreduce) -> takes the kernel
    "odometry_on_cuda": ("cuda", torch.float32, ("edge", "plane"), None, True),
    "cpu_tensors": ("cpu", torch.float32, ("edge", "plane"), None, False),
    "float64": ("cuda", torch.float64, ("edge", "plane"), None, False),
    "mapping_plane_norm": ("cuda", torch.float32, ("edge", "plane_norm"),
                           None, False),
    "corner_vote_edge_scalar": ("cuda", torch.float32,
                                ("edge", "plane", "edge_scalar"), None,
                                False),
    "sharded_allreduce": ("cuda", torch.float32, ("edge", "plane"),
                          lambda x: x, False),
    "edge_only": ("cuda", torch.float32, ("edge",), None, False),
}


@pytest.mark.parametrize("route", sorted(_ROUTES))
def test_lm_kernel_routing(route):
    """``lm_solve`` takes the CUDA kernel only for CUDA float32 tensors on
    one process (``allreduce`` the identity) with exactly the edge and
    plane families: mapping's plane-norm solve, the corner vote's scalar
    edges, the sharded step's allreduce and CPU tensors keep the loop."""
    from light_loam_tpu_torch.solver import gauss_newton as gn

    device, dtype, families, allreduce, want = _ROUTES[route]
    base = _edge_plane_set(0)
    extra = {"plane_norm": _plane_norm_set(1),
             "edge_scalar": _edge_scalar_set(2)}
    fs = ts.FactorSet(**{name: getattr(base, name, None) if name in
                         ("edge", "plane") else extra[name]
                         for name in families})
    got = gn.uses_lm_kernel(torch.device(device), dtype, fs,
                            gn._identity if allreduce is None else allreduce)
    assert got is want


def test_lm_solve_on_cpu_never_reaches_the_op(monkeypatch):
    """On CPU tensors ``lm_solve`` runs the plain loop without the op."""
    from light_loam_tpu_torch.solver import gauss_newton as gn

    def refuse(*args):
        raise AssertionError("the op was called for CPU tensors")

    monkeypatch.setattr(gn, "lm_solve_edge_plane", refuse)
    q, t, _ = ts.lm_solve(torch.tensor([0.0, 0.0, 0.0, 1.0]), torch.zeros(3),
                          _edge_plane_set(3), n_iterations=4)
    assert torch.isfinite(q).all() and torch.isfinite(t).all()


@pytest.mark.parametrize("case", ["consistent", "weighted_masked",
                                  "all_masked"])
def test_lm_op_cpu_kernel_equals_lm_solve(case):
    """The op's CPU kernel is ``lm_solve``'s loop: the same floats, bit for
    bit, on the JAX-parity inputs, with vote-like weights and masks, and
    with every factor masked (the pose unchanged, the cost 0)."""
    fs = _edge_plane_set(4)
    rng = np.random.default_rng(5)
    if case != "consistent":
        n = fs.plane.mask.shape[0]
        plane = fs.plane._replace(
            weight=torch.as_tensor(rng.uniform(0, 5, n).astype(np.float32)),
            mask=fs.plane.mask & torch.as_tensor(rng.random(n) < 0.6))
        fs = fs._replace(plane=plane)
    if case == "all_masked":
        fs = ts.FactorSet(
            edge=fs.edge._replace(mask=torch.zeros_like(fs.edge.mask)),
            plane=fs.plane._replace(mask=torch.zeros_like(fs.plane.mask)))
    q0 = torch.tensor([0.0, 0.0, 0.0, 1.0])
    t0 = torch.zeros(3)
    want = ts.lm_solve(q0, t0, fs, n_iterations=8, huber_delta=0.1)
    got = torch.ops.light_loam_tpu_torch.lm_solve_edge_plane(
        q0, t0, *fs.edge, *fs.plane, 8, 0.1, 1e-4, 1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if case == "all_masked":
        assert torch.equal(got[0], q0) and torch.equal(got[1], t0)
        assert got[2].item() == 0.0
    else:
        assert np.linalg.norm(got[1].numpy() - [0.5, -0.3, 0.1]) < 0.05


def test_lm_op_vmap_equals_a_loop_over_lanes(recwarn):
    """Under ``torch.vmap`` the op's vmap rule (no per-lane fallback: the
    fallback's warning would be recorded) equals a loop of single calls,
    bit for bit; an operand without a lane axis is shared by every lane."""
    import warnings

    from light_loam_tpu_torch.solver import gauss_newton as gn

    sets = [_edge_plane_set(10 + b) for b in range(3)]
    q0 = torch.stack([tq.quat_normalize(torch.tensor([0.01 * b, 0.0, 0.0,
                                                      1.0]))
                      for b in range(3)])
    t0 = torch.zeros(3)
    edge = [torch.stack(x) for x in zip(*(s.edge for s in sets))]
    plane = list(sets[0].plane)
    warnings.simplefilter("always")
    got = torch.vmap(
        lambda q, *e: gn.lm_solve_edge_plane(q, t0, *e, *plane, 6, 0.1, 1e-4,
                                             1))(q0, *edge)
    assert not [w for w in recwarn if "batching rule" in str(w.message)]
    for b in range(3):
        want = gn.lm_solve_edge_plane(q0[b], t0, *(e[b] for e in edge),
                                      *plane, 6, 0.1, 1e-4, 1)
        for g, w in zip(got, want):
            assert torch.equal(g[b], w)


def test_lm_kernel_constants_match_the_source():
    """The wrapper's copies of lm.cu's staged floats a factor, and the
    shared memory it asks for at the odometry's capacities (staged) and
    past the card's 227 KB (a scratch buffer instead)."""
    import re

    from light_loam_tpu_torch.solver import gauss_newton as gn

    src = (gn.LM.source).read_text()
    for name in ("EDGE_FLOATS", "PLANE_FLOATS"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(gn, name)
    assert "extern \"C\" int lm_solve_launch(" in src
    assert gn.staged_bytes(768, 1536) == 4 * (13 * 768 + 12 * 1536) == 113664
    assert gn.staged_bytes(4 * 768, 4 * 1536) == 0

"""Separable time-dependent sources ``f(x, t) = g(t) f(x)``
(solvers/transient.py source_scales + f_time= on every evolver).

Oracles: dense scipy twins stepping the identical schemes with the
same per-step factors (trajectory-exact), a CN self-convergence order
check (midpoint evaluation keeps O(dt^2)), and the sharded evolvers
against their driven single-device counterparts."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from pmg_dolfinx_jax.fem.assembly import assemble_stiffness, lumped_mass_np
from pmg_dolfinx_jax.fem.mesh import BoxMesh
from pmg_dolfinx_jax.solvers.transient import (
    heat_fdm_evolve, source_scales, wave_leapfrog_evolve,
    wave_newmark_evolve)

KAPPA, DT, NSTEPS = 1.5, 2e-3, 6


def _g(t):
    return 1.2 + np.sin(3.0 * t)


def _setup(P=3):
    mesh = BoxMesh((3, 3, 3))
    bc = np.asarray(mesh.boundary_dof_marker(P))
    m0 = lumped_mass_np(mesh, P, bc_zero=True)
    rng = np.random.default_rng(7)
    f = np.where(bc, 0.0, rng.standard_normal(mesh.num_dofs(P)))
    c = mesh.dof_coords(P)
    u0 = (np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
          * np.sin(np.pi * c[:, 2]))
    return mesh, bc, m0, f, u0


@pytest.mark.parametrize("scheme,when", [("be", "end"), ("cn", "mid")])
def test_heat_driven_matches_dense_twin(scheme, when):
    mesh, bc, m0, f, u0 = _setup()
    P, sigma = 3, 1.0 / DT
    kap = 0.5 * KAPPA if scheme == "cn" else KAPPA
    A = (assemble_stiffness(mesh, P, kappa=kap, bc=True).tocsr()
         + sigma * sp.diags(m0)).tocsc()
    lu = spla.splu(A)
    gs = source_scales(_g, DT, NSTEPS, when)
    u = u0.copy()
    for g in gs:
        if scheme == "be":
            rhs = sigma * m0 * u + g * f
        else:
            rhs = 2.0 * sigma * m0 * u - A @ u + g * f
        rhs[bc] = u[bc]
        u = lu.solve(rhs)
    got = np.asarray(heat_fdm_evolve(mesh, P, kappa=KAPPA, dt=DT,
                                     scheme=scheme, f=f, f_time=_g)(
        u0, NSTEPS)).reshape(-1)
    assert np.linalg.norm(got - u) < 1e-12 * np.linalg.norm(u)


def test_newmark_driven_matches_dense_twin():
    mesh, bc, m0, f, u0 = _setup()
    P, beta, gamma = 3, 0.25, 0.5
    c0 = 1.0 / (beta * DT * DT)
    K = assemble_stiffness(mesh, P, kappa=KAPPA, bc=True).tocsr()
    A = (K + c0 * sp.diags(m0)).tocsc()
    lu = spla.splu(A)
    m0safe = np.where(bc, 1.0, m0)
    gs = source_scales(_g, DT, NSTEPS, "end")
    u = u0.copy()
    v = np.zeros_like(u)
    a = np.where(bc, 0.0, (_g(0.0) * f - K @ u) / m0safe)
    for g in gs:
        ustar = u + DT * v + (0.5 - beta) * DT * DT * a
        rhs = g * f + c0 * m0 * ustar
        rhs[bc] = u[bc]
        u1 = lu.solve(rhs)
        a1 = np.where(bc, 0.0, c0 * (u1 - ustar))
        v = v + DT * ((1.0 - gamma) * a + gamma * a1)
        u, a = u1, a1
    uT, vT = wave_newmark_evolve(mesh, P, kappa=KAPPA, dt=DT, f=f,
                                 f_time=_g)(u0, np.zeros_like(u0), NSTEPS)
    assert np.linalg.norm(np.asarray(uT).reshape(-1) - u) < \
        1e-12 * np.linalg.norm(u)
    assert np.linalg.norm(np.asarray(vT).reshape(-1) - v) < \
        1e-12 * np.linalg.norm(v)


def test_leapfrog_driven_matches_dense_twin():
    mesh, bc, m0, f, u0 = _setup()
    P = 3
    K = assemble_stiffness(mesh, P, kappa=KAPPA, bc=True).tocsr()
    m0safe = np.where(bc, 1.0, m0)
    dt = 5e-4  # inside the spectral bound

    def acc(u, g):
        return np.where(bc, 0.0, (g * f - K @ u) / m0safe)

    um1 = u0.copy()
    u = np.where(bc, u0, u0 + 0.5 * dt * dt * acc(u0, _g(0.0)))  # v0 = 0
    for n in range(1, NSTEPS):
        u1 = np.where(bc, u, 2.0 * u - um1 + dt * dt * acc(u, _g(n * dt)))
        um1, u = u, u1
    vT = (u - um1) / dt + 0.5 * dt * acc(u, _g(NSTEPS * dt))
    uT, vT_j = wave_leapfrog_evolve(mesh, P, kappa=KAPPA, dt=dt, f=f,
                                    f_time=_g)(u0, np.zeros_like(u0),
                                               NSTEPS)
    assert np.linalg.norm(np.asarray(uT).reshape(-1) - u) < \
        1e-12 * np.linalg.norm(u)
    assert np.linalg.norm(np.asarray(vT_j).reshape(-1) - vT) < \
        1e-12 * np.linalg.norm(vT)


def test_cn_driven_keeps_second_order():
    """Midpoint source evaluation: CN self-convergence rate vs a
    dt/16 reference stays ~2 (an endpoint evaluation would drop it)."""
    mesh, _, _, f, u0 = _setup(P=2)
    P, T = 2, 0.08
    ref = np.asarray(heat_fdm_evolve(mesh, P, kappa=KAPPA, dt=T / 128,
                                     scheme="cn", f=f, f_time=_g)(
        u0, 128)).reshape(-1)
    errs = []
    for nsteps in (8, 16):
        got = np.asarray(heat_fdm_evolve(mesh, P, kappa=KAPPA,
                                         dt=T / nsteps, scheme="cn", f=f,
                                         f_time=_g)(u0, nsteps)).reshape(-1)
        errs.append(np.linalg.norm(got - ref))
    rate = np.log2(errs[0] / errs[1])
    # Discriminates the O(dt) drop an endpoint evaluation causes (rate
    # ~1); coarse ladders run slightly super-convergent (measured 2.7).
    assert 1.6 < rate < 3.2, (rate, errs)


@pytest.mark.parametrize("kind", ["heat", "wave"])
def test_dist_driven_matches_single(kind):
    from pmg_dolfinx_jax.parallel.transient_dist import (
        heat_dist_evolve, wave_newmark_dist_evolve)

    mesh = BoxMesh((4, 4, 4))
    P = 2
    bc = np.asarray(mesh.boundary_dof_marker(P))
    rng = np.random.default_rng(11)
    f = np.where(bc, 0.0, rng.standard_normal(mesh.num_dofs(P)))
    c = mesh.dof_coords(P)
    u0 = (np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
          * np.sin(np.pi * c[:, 2]))
    if kind == "heat":
        ref = np.asarray(heat_fdm_evolve(mesh, P, kappa=KAPPA, dt=DT,
                                         scheme="cn", f=f, f_time=_g)(
            u0, NSTEPS)).reshape(-1)
        got = heat_dist_evolve(mesh, P, (2, 2, 1), kappa=KAPPA, dt=DT,
                               scheme="cn", f=f, f_time=_g)(u0, NSTEPS)
        assert np.linalg.norm(got - ref) < 1e-10 * np.linalg.norm(ref)
    else:
        v0 = np.zeros_like(u0)
        ur, vr = (np.asarray(a).reshape(-1) for a in wave_newmark_evolve(
            mesh, P, kappa=KAPPA, dt=DT, f=f, f_time=_g)(u0, v0, NSTEPS))
        uT, vT = wave_newmark_dist_evolve(mesh, P, 4, kappa=KAPPA, dt=DT,
                                          f=f, f_time=_g)(u0, v0, NSTEPS)
        assert np.linalg.norm(uT - ur) < 1e-10 * np.linalg.norm(ur)
        assert np.linalg.norm(vT - vr) < 1e-10 * np.linalg.norm(vr)


@pytest.mark.parametrize("B", [1, 2])
def test_packed_driven_matches_per_rhs(B):
    """Driven sources on the batched serving steppers (batch_evolve over
    the heat/wave/semilinear evolvers, B=1 included): every column
    matches the per-RHS driven evolvers at f32."""
    from pmg_dolfinx_jax.models.semilinear import cubic
    from pmg_dolfinx_jax.solvers.transient import (
        batch_evolve, semilinear_fdm_evolve)

    mesh = BoxMesh((6, 6, 6))
    P, dt, nsteps = 3, 1e-3, 5
    bc = np.asarray(mesh.boundary_dof_marker(P))
    rng = np.random.default_rng(17)
    f = np.where(bc, 0.0, rng.standard_normal(mesh.num_dofs(P)))
    U0 = rng.standard_normal((B, mesh.num_dofs(P))).astype(np.float32)
    U0[:, bc] = 0.0
    V0 = rng.standard_normal((B, mesh.num_dofs(P))).astype(np.float32)

    import jax.numpy as jnp

    # heat CN
    ev1 = heat_fdm_evolve(mesh, P, kappa=KAPPA, dt=dt, scheme="cn",
                          dtype=jnp.float32, f=f, f_time=_g)
    ref = np.stack([np.asarray(ev1(U0[k], nsteps)).reshape(-1)
                    for k in range(B)])
    got = np.asarray(batch_evolve(ev1)(U0, nsteps))
    assert np.linalg.norm(got - ref) < 2e-5 * np.linalg.norm(ref)

    # wave, both integrators
    for scheme, ev_plain in (("newmark", wave_newmark_evolve),
                             ("leapfrog", wave_leapfrog_evolve)):
        evp = ev_plain(mesh, P, kappa=KAPPA, dt=dt, dtype=jnp.float32,
                       f=f, f_time=_g)
        refs = [tuple(np.asarray(a).reshape(-1)
                      for a in evp(U0[k], V0[k], nsteps))
                for k in range(B)]
        uref = np.stack([r[0] for r in refs])
        UT, VT = batch_evolve(evp)(U0, V0, nsteps)
        assert np.linalg.norm(np.asarray(UT) - uref) < \
            2e-5 * np.linalg.norm(uref), scheme

    # semilinear CNAB
    nl = cubic(0.8)
    evs = semilinear_fdm_evolve(mesh, P, nl, kappa=KAPPA, dt=dt,
                                scheme="cnab", dtype=jnp.float32, f=f,
                                f_time=_g)
    ref = np.stack([np.asarray(evs(U0[k], nsteps)).reshape(-1)
                    for k in range(B)])
    got = np.asarray(batch_evolve(evs)(U0, nsteps))
    assert np.linalg.norm(got - ref) < 2e-5 * np.linalg.norm(ref)

"""Transient semilinear reaction-diffusion (semilinear_fdm_evolve IMEX,
semilinear_newton_evolve implicit BE, semilinear_dist_evolve sharded).

Oracles: dense scipy twins (including a per-step Newton twin for the
implicit path), the steady fixed-point identity against the framework's
own `newton_solve`, self-convergence orders, and sharded-vs-single
trajectory match."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from pmg_dolfinx_jax.fem.assembly import (
    assemble_rhs, assemble_stiffness, l2_error, lumped_mass_np)
from pmg_dolfinx_jax.fem.mesh import BoxMesh, geometric_spacing
from pmg_dolfinx_jax.models.semilinear import cubic, f_rhs_semilinear
from pmg_dolfinx_jax.models.poisson import u_exact
from pmg_dolfinx_jax.solvers.transient import (
    semilinear_fdm_evolve, semilinear_newton_evolve, source_scales)

KAPPA, SIGMA, DT, NSTEPS = 1.2, 0.7, 2e-3, 6
NL = cubic(2.0)


def _setup(P=3, spacing=None):
    mesh = BoxMesh((3, 4, 3), spacing=spacing)
    bc = np.asarray(mesh.boundary_dof_marker(P))
    m0 = lumped_mass_np(mesh, P, bc_zero=True)
    c = mesh.dof_coords(P)
    u0 = np.where(bc, 0.0,
                  np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
                  * np.sin(np.pi * c[:, 2]))
    return mesh, bc, m0, u0


@pytest.mark.parametrize("scheme", ["be", "cnab"])
def test_imex_matches_dense_twin(scheme):
    """The scanned IMEX program reproduces the scipy twin step for step
    (graded mesh, sigma shift, cubic reaction)."""
    mesh, bc, m0, u0 = _setup(
        spacing=(None, geometric_spacing(4, 2.0), None))
    P, sdt = 3, 1.0 / DT
    kap = 0.5 * KAPPA if scheme == "cnab" else KAPPA
    shift = 0.5 * SIGMA if scheme == "cnab" else SIGMA
    A = (assemble_stiffness(mesh, P, kappa=kap, bc=True).tocsr()
         + (shift + sdt) * sp.diags(m0)).tocsc()
    lu = spla.splu(A)
    u = u0.copy()
    N_m1 = NL.N_np(u)
    for _ in range(NSTEPS):
        N_n = NL.N_np(u)
        if scheme == "be":
            rhs = sdt * m0 * u - m0 * N_n
            rhs[bc] = u[bc]
            u = lu.solve(rhs)
        else:
            rhs = 2.0 * sdt * m0 * u - m0 * (1.5 * N_n - 0.5 * N_m1)
            rhs[bc] = 2.0 * u[bc]
            u = lu.solve(rhs) - u
        N_m1 = N_n
    got = np.asarray(semilinear_fdm_evolve(
        mesh, P, NL, kappa=KAPPA, dt=DT, scheme=scheme, sigma=SIGMA)(
        u0, NSTEPS)).reshape(-1)
    assert np.linalg.norm(got - u) < 1e-11 * np.linalg.norm(u)


def test_be_steady_state_matches_newton_solve():
    """The IMEX BE fixed point is EXACTLY the steady semilinear system:
    long evolution lands on the newton_solve answer."""
    from pmg_dolfinx_jax.solvers.newton import newton_solve
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    mesh, bc, m0, _ = _setup()
    P = 3
    b = assemble_rhs(mesh, P, f_rhs_semilinear(KAPPA, NL, sigma=SIGMA))
    uT = np.asarray(semilinear_fdm_evolve(
        mesh, P, NL, kappa=KAPPA, dt=0.02, scheme="be", sigma=SIGMA,
        f=b)(np.zeros(mesh.num_dofs(P)), 400)).reshape(-1)
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=KAPPA, coarse="fdm",
                        operator="kron", sigma=SIGMA)
    u_star, info = newton_solve(hier, b, NL, rtol=1e-12)
    u_star = np.asarray(u_star).reshape(-1)
    assert np.linalg.norm(uT - u_star) < 1e-7 * np.linalg.norm(u_star)
    assert l2_error(mesh, P, uT, u_exact) < 5e-4


def test_newton_evolve_matches_dense_implicit_twin():
    """Fully implicit BE via per-step newton_solve == a scipy per-step
    Newton twin (5 exact-Jacobian iterations, spsolve)."""
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    mesh, bc, m0, u0 = _setup()
    P, sdt = 3, 1.0 / DT
    K = (assemble_stiffness(mesh, P, kappa=KAPPA, bc=True).tocsr()
         + SIGMA * sp.diags(m0))
    A = K + sdt * sp.diags(m0)
    u = u0.copy()
    for _ in range(NSTEPS):
        b = sdt * m0 * u
        w = u.copy()
        for _ in range(6):
            F = A @ w + m0 * NL.N_np(w) - b
            F[bc] = 0.0
            J = (A + sp.diags(m0 * NL.dN_np(w))).tocsc()
            dw = spla.spsolve(J, F)
            w = w - np.where(bc, 0.0, dw)
        u = w
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=KAPPA, coarse="fdm",
                        operator="kron", sigma=SIGMA + sdt)
    got, iters = semilinear_newton_evolve(hier, mesh, P, NL, DT,
                                          rtol=1e-12)(u0, NSTEPS)
    assert np.linalg.norm(got - u) < 1e-9 * np.linalg.norm(u)
    assert max(iters) <= 5, iters  # warm-started: few Newtons per step


@pytest.mark.parametrize("scheme,lo,hi", [("be", 0.7, 1.4),
                                          ("cnab", 1.6, 3.2)])
def test_imex_orders(scheme, lo, hi):
    mesh, bc, m0, u0 = _setup(P=2)
    P, T = 2, 0.08
    ref = np.asarray(semilinear_fdm_evolve(
        mesh, P, NL, kappa=KAPPA, dt=T / 128, scheme="cnab",
        sigma=SIGMA)(u0, 128)).reshape(-1)
    errs = []
    for nsteps in (8, 16):
        got = np.asarray(semilinear_fdm_evolve(
            mesh, P, NL, kappa=KAPPA, dt=T / nsteps, scheme=scheme,
            sigma=SIGMA)(u0, nsteps)).reshape(-1)
        errs.append(np.linalg.norm(got - ref))
    rate = np.log2(errs[0] / errs[1])
    assert lo < rate < hi, (scheme, rate, errs)


@pytest.mark.parametrize("shards", [4, (2, 2, 1)])
def test_dist_matches_single(shards):
    from pmg_dolfinx_jax.parallel.transient_dist import (
        semilinear_dist_evolve)

    mesh = BoxMesh((4, 4, 4))
    P = 2
    bc = np.asarray(mesh.boundary_dof_marker(P))
    c = mesh.dof_coords(P)
    u0 = np.where(bc, 0.0,
                  np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
                  * np.sin(np.pi * c[:, 2]))
    rng = np.random.default_rng(2)
    f = np.where(bc, 0.0, rng.standard_normal(mesh.num_dofs(P)))
    g = lambda t: 1.0 + 0.3 * np.cos(15.0 * t)
    ref = np.asarray(semilinear_fdm_evolve(
        mesh, P, NL, kappa=KAPPA, dt=DT, scheme="cnab", sigma=SIGMA,
        f=f, f_time=g)(u0, NSTEPS)).reshape(-1)
    got = semilinear_dist_evolve(mesh, P, shards, NL, kappa=KAPPA,
                                 dt=DT, scheme="cnab", sigma=SIGMA,
                                 f=f, f_time=g)(u0, NSTEPS)
    assert np.linalg.norm(got - ref) < 1e-10 * np.linalg.norm(ref)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("scheme", ["be", "cnab"])
def test_packed_matches_per_rhs(scheme, B):
    """Batched semilinear stepping (vmap of the scanned IMEX stepper) ==
    the per-RHS scanned trajectories to f32 precision."""
    import jax.numpy as jnp

    from pmg_dolfinx_jax.solvers.transient import batch_evolve

    mesh = BoxMesh((6, 6, 6))
    P, dt, nsteps = 3, 2e-3, 5
    rng = np.random.default_rng(1)
    U0 = rng.standard_normal((B, mesh.num_dofs(P))).astype(np.float32)
    U0[:, np.asarray(mesh.boundary_dof_marker(P))] = 0.0
    ev1 = semilinear_fdm_evolve(mesh, P, NL, kappa=KAPPA, dt=dt,
                                scheme=scheme, sigma=SIGMA,
                                dtype=jnp.float32)
    ref = np.stack([np.asarray(ev1(U0[k], nsteps)).reshape(-1)
                    for k in range(B)])
    UT = np.asarray(batch_evolve(ev1)(U0, nsteps))
    rel = np.linalg.norm(UT - ref) / np.linalg.norm(ref)
    assert rel < 2e-5, rel

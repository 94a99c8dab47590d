"""Semilinear reaction-diffusion via inexact Newton (`solvers.newton`).

Beyond reference parity (the reference is linear-only). Oracle: a dense
float64 NumPy Newton twin on the independently assembled system
``A u + m3 N(u) = b`` solved with scipy spsolve Jacobian steps.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from pmg_dolfinx_jax.fem.assembly import (
    assemble_rhs, assemble_stiffness, l2_error, lumped_mass_np)
from pmg_dolfinx_jax.fem.mesh import BoxMesh, PerturbedBoxMesh
from pmg_dolfinx_jax.models import semilinear
from pmg_dolfinx_jax.models.poisson import u_exact
from pmg_dolfinx_jax.solvers.newton import newton_solve
from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

KAPPA = 2.0
SIGMA = 0.7


def _dense_newton(mesh, P, kappa, sigma, nonlin, b, tol=1e-13, maxiter=40):
    """Float64 host Newton with exact sparse-LU steps (the oracle)."""
    A = assemble_stiffness(mesh, P, kappa=kappa, bc=True).tocsr()
    m3 = lumped_mass_np(mesh, P, bc_zero=True)
    if sigma:
        A = A + sigma * sp.diags(m3)
    u = np.zeros_like(b)
    for _ in range(maxiter):
        F = A @ u + m3 * nonlin.N_np(u) - b
        if np.linalg.norm(F) < tol:
            break
        J = (A + sp.diags(m3 * nonlin.dN_np(u))).tocsc()
        u = u + spla.spsolve(J, -F)
    return u


def test_newton_cubic_matches_dense_twin():
    mesh = BoxMesh((5, 4, 6), extent=(1.0, 2.0, 0.7))
    nonlin = semilinear.cubic(5.0)
    b = assemble_rhs(mesh, 3, semilinear.f_rhs_semilinear(
        KAPPA, nonlin, sigma=SIGMA))
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=KAPPA, coarse="fdm",
                        operator="kron", sigma=SIGMA)
    u, info = newton_solve(hier, b, nonlin, rtol=1e-12)
    assert info["converged"], info
    # Quadratic-phase contraction: few Newton steps, monotone residuals.
    assert info["niter"] <= 8, info
    fn = info["fnorms"]
    assert all(b_ < a_ for a_, b_ in zip(fn, fn[1:])), fn
    u_ref = _dense_newton(mesh, 3, KAPPA, SIGMA, nonlin, b)
    assert np.linalg.norm(np.asarray(u) - u_ref) < 1e-9 * np.linalg.norm(u_ref)


def test_newton_manufactured_accuracy():
    """The nonlinear solve reproduces the manufactured solution to the
    same discretization error level as the linear family."""
    mesh = BoxMesh((6, 6, 6))
    nonlin = semilinear.cubic(3.0)
    b = assemble_rhs(mesh, 3, semilinear.f_rhs_semilinear(KAPPA, nonlin))
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=KAPPA, coarse="fdm",
                        operator="kron")
    u, info = newton_solve(hier, b, nonlin, rtol=1e-11)
    assert info["converged"]
    err = l2_error(mesh, 3, np.asarray(u), u_exact)
    assert err < 2e-4, err


def test_newton_bratu():
    """Bratu–Gelfand ``-lap u = lam e^u`` below the fold: converges from
    u0=0 and matches the dense twin."""
    mesh = BoxMesh((5, 5, 5))
    nonlin = semilinear.bratu(5.0)
    b = np.zeros(mesh.num_dofs(3))
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=1.0, coarse="fdm",
                        operator="kron")
    u, info = newton_solve(hier, b, nonlin, rtol=0.0, atol=1e-11)
    assert info["converged"], info
    u_ref = _dense_newton(mesh, 3, 1.0, 0.0, nonlin, b, tol=1e-13)
    assert np.linalg.norm(np.asarray(u) - u_ref) < 1e-9 * np.linalg.norm(u_ref)
    # Positive interior solution (classic Bratu qualitative check).
    interior = ~np.asarray(mesh.boundary_dof_marker(3))
    assert np.all(np.asarray(u)[interior] > 0)


def test_newton_general_backend_curved_varkappa():
    """Semilinear family on curved hexes + variable DG-0 kappa through
    the lattice backend, dense-twin verified."""
    from pmg_dolfinx_jax.fem.assembly import resolve_kappa
    from pmg_dolfinx_jax.models.poisson import kappa_linear

    mesh = PerturbedBoxMesh((4, 4, 3))
    kc, _ = resolve_kappa(mesh, kappa_linear)
    nonlin = semilinear.cubic(4.0)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(mesh.num_dofs(3))
    b[np.asarray(mesh.boundary_dof_marker(3))] = 0.0
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=kappa_linear,
                        coarse="direct", operator="lattice", sigma=SIGMA)
    u, info = newton_solve(hier, b, nonlin, rtol=1e-12)
    assert info["converged"], info
    u_ref = _dense_newton(mesh, 3, kc, SIGMA, nonlin, b)
    assert np.linalg.norm(np.asarray(u) - u_ref) < 1e-8 * np.linalg.norm(u_ref)


@pytest.mark.parametrize("layout", ["slab", "grid"])
def test_newton_sharded_matches_single(layout):
    """The sharded Newton programs (shard_map'd step/resid) reproduce the
    single-device trajectory: same residual norms, same solution."""
    mesh = BoxMesh((8, 8, 6))
    nonlin = semilinear.cubic(5.0)
    b = assemble_rhs(mesh, 3, semilinear.f_rhs_semilinear(
        KAPPA, nonlin, sigma=SIGMA))
    kw = dict(degrees=(1, 3), kappa=KAPPA, coarse="fdm", operator="kron",
              sigma=SIGMA)
    single = PMGHierarchy(mesh, **kw)
    u1, info1 = newton_solve(single, b, nonlin, rtol=1e-11,
                             lin_rtol=1e-10)
    if layout == "slab":
        from pmg_dolfinx_jax.parallel.dist import DistPMG

        sharded = DistPMG(mesh, n_devices=4, **kw)
    else:
        from pmg_dolfinx_jax.parallel.grid2d import GridPMG

        sharded = GridPMG(mesh, shards=(2, 2), **kw)
    u2, info2 = newton_solve(sharded, b, nonlin, rtol=1e-11,
                             lin_rtol=1e-10)
    assert info2["converged"]
    assert info1["niter"] == info2["niter"]
    f1, f2 = np.array(info1["fnorms"]), np.array(info2["fnorms"])
    assert np.allclose(f1, f2, rtol=1e-8), (f1, f2)
    assert np.linalg.norm(np.asarray(u1) - np.asarray(u2)) < \
        1e-10 * np.linalg.norm(np.asarray(u1))

"""End-to-end p-multigrid tests (SURVEY.md §7 step 4 gate).

Mirrors python_tests/pmg.py: unit cube, degrees [1, 3], kappa = 2.0,
manufactured solution sin(pi x) sin(pi y) sin(pi z), 10 stationary V-cycle
applications, checking (a) residual convergence and (b) the L2 error
landing at the discretization-error level.
"""

import numpy as np
import pytest

from pmg_dolfinx_jax.models.poisson import PoissonProblem, fit_box_cells


@pytest.mark.parametrize("coarse", ["smoother", "cg", "direct"])
def test_pmg_two_level_converges(coarse):
    prob = PoissonProblem(nc=(6, 6, 6), degrees=(1, 3), kappa=2.0, coarse=coarse)
    u, rnorms = prob.solve(num_cycles=10)
    b = np.asarray(prob.b)
    r0 = np.linalg.norm(b)
    rel = np.array(rnorms) / r0
    # Residual must drop monotonically.
    assert np.all(np.diff(np.log10(rel[: np.argmin(rel) + 1])) < 0)
    if coarse == "smoother":
        # Reference default path without AMG: the "coarse solve" is just
        # 2 Chebyshev iterations at p=1 (pmg.hpp:106-109), so the cycle
        # contracts slowly — bounded by the unsolved coarse error.
        assert rel[-1] < 0.08, (coarse, rel)
    else:
        # Exact-ish coarse solves give true multigrid convergence.
        assert rel[-1] < 1e-6, (coarse, rel)
        # Discretization error of the p=3 space on a 6^3 mesh.
        err = prob.error_l2(u)
        assert err < 5e-4, err


def test_pmg_three_levels():
    prob = PoissonProblem(nc=(4, 4, 4), degrees=(1, 2, 4), kappa=2.0, coarse="cg")
    u, rnorms = prob.solve(num_cycles=10)
    rel = rnorms[-1] / np.linalg.norm(np.asarray(prob.b))
    assert rel < 1e-6, rnorms
    assert prob.error_l2(u) < 5e-4


def test_pmg_error_reaches_discretization_level():
    """After convergence the L2 error must match the error of the directly
    solved discrete system (V-cycle introduces no extra error)."""
    import scipy.sparse.linalg as spla

    from pmg_dolfinx_jax.fem.assembly import assemble_stiffness, l2_error
    from pmg_dolfinx_jax.models.poisson import u_exact

    prob = PoissonProblem(nc=(5, 5, 5), degrees=(1, 3), kappa=2.0, coarse="cg")
    u, _ = prob.solve(num_cycles=12)
    A = assemble_stiffness(prob.mesh, 3, kappa=2.0)
    u_direct = spla.spsolve(A.tocsc(), np.asarray(prob.b))
    e_mg = prob.error_l2(u)
    e_direct = l2_error(prob.mesh, 3, u_direct, u_exact)
    assert abs(e_mg - e_direct) < 0.01 * e_direct


def test_vcycle_diagnostics():
    prob = PoissonProblem(nc=(4, 4, 4), degrees=(1, 3), kappa=2.0)
    import jax.numpy as jnp

    u, diag = prob.hierarchy.apply(prob.b, jnp.zeros_like(prob.b), diagnostics=True)
    assert len(diag["pre"]) == 1 and len(diag["post"]) == 1
    assert float(diag["post"][0]) < float(diag["pre"][0])


def test_fit_box_cells():
    nx, ny, nz = fit_box_cells(500000, 3)
    nd = (nx * 3 + 1) * (ny * 3 + 1) * (nz * 3 + 1)
    assert abs(nd - 500000) / 500000 < 0.05


def test_pmg_lattice_backend_matches_dofmap():
    """The lattice (structured fast path) hierarchy reproduces the dofmap
    hierarchy's V-cycle trajectory to float64 rounding."""
    nc = (4, 4, 4)
    a = PoissonProblem(nc=nc, degrees=(1, 3), kappa=2.0, coarse="cg",
                       operator="dofmap")
    b = PoissonProblem(nc=nc, degrees=(1, 3), kappa=2.0, coarse="cg",
                       operator="lattice")
    for ea, eb in zip(a.hierarchy.eigs, b.hierarchy.eigs):
        assert np.allclose(ea[-1], eb[-1], rtol=1e-9)
    ua, ra = a.solve(num_cycles=5)
    ub, rb = b.solve(num_cycles=5)
    assert np.allclose(ra, rb, rtol=1e-8), (ra, rb)
    assert np.allclose(np.asarray(ua), np.asarray(ub), atol=1e-10)


def test_pmg_kron_backend_matches_dofmap():
    nc = (4, 4, 4)
    a = PoissonProblem(nc=nc, degrees=(1, 3), kappa=2.0, coarse="cg",
                       operator="dofmap")
    b = PoissonProblem(nc=nc, degrees=(1, 3), kappa=2.0, coarse="cg",
                       operator="kron")
    for ea, eb in zip(a.hierarchy.eigs, b.hierarchy.eigs):
        assert np.allclose(ea[-1], eb[-1], rtol=1e-9)
    ua, ra = a.solve(num_cycles=5)
    ub, rb = b.solve(num_cycles=5)
    assert np.allclose(ra, rb, rtol=1e-8), (ra, rb)
    assert np.allclose(np.asarray(ua), np.asarray(ub), atol=1e-10)


def test_mixed_precision_refined_solve():
    """f32 V-cycle + f64 outer refinement must converge far below the
    plain-f32 stationary floor (~1e-4 rel residual)."""
    import jax.numpy as jnp

    prob = PoissonProblem(nc=(6, 6, 6), degrees=(1, 3), kappa=2.0,
                          coarse="cg", operator="kron", dtype=jnp.float32)
    u64, rnorms = prob.hierarchy.solve_refined(prob.b, num_cycles=20)
    r0 = np.linalg.norm(np.asarray(prob.b))
    assert rnorms[-1] / r0 < 1e-9, np.array(rnorms) / r0
    assert prob.error_l2(np.asarray(u64)) < 5e-4


def test_pmg_hmg_coarse_converges():
    """p-MG with nested geometric h-MG coarse solve (the AMG replacement)
    must converge like the exact coarse solves."""
    prob = PoissonProblem(nc=(8, 8, 8), degrees=(1, 3), kappa=2.0,
                          coarse="hmg", operator="kron")
    u, rnorms = prob.solve(num_cycles=10)
    rel = np.array(rnorms) / np.linalg.norm(np.asarray(prob.b))
    assert rel[-1] < 1e-5, rel
    assert prob.error_l2(u) < 5e-4


def test_hmg_axis_interpolation():
    from pmg_dolfinx_jax.solvers.hmg import axis_h_interpolation, coarsenable_levels

    I = axis_h_interpolation(2, P=1)
    assert I.shape == (5, 3)
    # Linear functions reproduced exactly.
    xc = np.linspace(0, 1, 3)
    xf = np.linspace(0, 1, 5)
    assert np.allclose(I @ (1 + 2 * xc), 1 + 2 * xf)
    assert coarsenable_levels((8, 8, 8), min_cells=2) == [
        (8, 8, 8), (4, 4, 4), (2, 2, 2)]
    assert coarsenable_levels((6, 4, 4), min_cells=2) == [(6, 4, 4), (3, 2, 2)]


def test_vcycle_trajectory_regression():
    """Pin the two-level V-cycle residual trajectory (n=6, p=[1,3],
    kappa=2, CG coarse) — guards algorithmic drift. Values recorded from
    the validated implementation (matching the oracle-checked operator,
    smoother mirrors, and transfer identities)."""
    prob = PoissonProblem(nc=(6, 6, 6), degrees=(1, 3), kappa=2.0,
                          coarse="cg", operator="kron")
    _, rnorms = prob.solve(num_cycles=4)
    rel = np.array(rnorms) / np.linalg.norm(np.asarray(prob.b))
    expected = [1.6321e-01, 2.9059e-02, 5.6003e-03, 1.0813e-03]
    assert np.allclose(rel, expected, rtol=2e-3), rel


def test_pcg_outer_beats_stationary():
    """V-cycle-preconditioned flexible CG reaches the tolerance in fewer
    cycles than the stationary Richardson iteration."""
    prob = PoissonProblem(nc=(6, 6, 6), degrees=(1, 3), kappa=2.0,
                          coarse="cg", operator="kron")
    u_pcg, niter = prob.hierarchy.solve_pcg(prob.b, rtol=1e-8, maxiter=30)
    u_st, rnorms = prob.solve(num_cycles=12)
    r0 = np.linalg.norm(np.asarray(prob.b))
    st_needed = next(i + 1 for i, r in enumerate(rnorms) if r / r0 < 1e-7)
    assert niter <= st_needed, (niter, st_needed)
    assert prob.error_l2(np.asarray(u_pcg)) < 5e-4


def test_pmg_fdm_coarse_matches_direct_coarse():
    """FDM coarse solve (exact, six matmuls) gives the same trajectory as
    the dense-Cholesky 'direct' coarse."""
    a = PoissonProblem(nc=(6, 6, 6), degrees=(1, 3), kappa=2.0,
                       coarse="direct", operator="kron")
    b = PoissonProblem(nc=(6, 6, 6), degrees=(1, 3), kappa=2.0,
                       coarse="fdm", operator="kron")
    ua, ra = a.solve(num_cycles=6)
    ub, rb = b.solve(num_cycles=6)
    assert np.allclose(ra, rb, rtol=1e-9), (ra, rb)
    assert np.allclose(np.asarray(ua), np.asarray(ub), atol=1e-11)

"""Solver tests: CG, Lanczos/tqli eigenvalues, Chebyshev smoothers.

Mirrors the reference numerics validation (SURVEY.md §2.3/§4):
python_tests/cg.py (CG + eigenvalue estimates vs dense spectra),
python_tests/tqli.py (tqli vs dense eigensolver, hard asserts),
python_tests/chebyshev.py (fourth-kind recurrence behavior).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pmg_dolfinx_jax.fem.assembly import assemble_stiffness
from pmg_dolfinx_jax.fem.mesh import BoxMesh
from pmg_dolfinx_jax.ops.laplacian import MatFreeLaplacian
from pmg_dolfinx_jax.solvers.cg import cg_solve
from pmg_dolfinx_jax.solvers.chebyshev import chebyshev1_solve, chebyshev4_solve
from pmg_dolfinx_jax.solvers.tridiag import (
    eigenvalues_tridiagonal,
    lanczos_eigenvalue_estimates,
    tqli,
)


def _problem(nc=(4, 4, 4), P=2, kappa=2.0):
    mesh = BoxMesh(nc)
    op = MatFreeLaplacian(mesh, P, kappa=kappa)
    return mesh, op


def test_tqli_vs_dense():
    rng = np.random.default_rng(3)
    for n in (2, 3, 5, 10, 20, 40):
        d = rng.standard_normal(n)
        e = rng.standard_normal(n - 1)
        ev_tqli = tqli(d, e)
        ev_dense = eigenvalues_tridiagonal(d, e)
        assert np.allclose(ev_tqli, np.sort(ev_dense), atol=1e-10), n


def test_cg_solves_poisson():
    mesh, op = _problem()
    rng = np.random.default_rng(0)
    marker = np.asarray(mesh.boundary_dof_marker(op.P))
    b = rng.standard_normal(mesh.num_dofs(op.P)) * (~marker)
    x, info = cg_solve(
        op, jnp.asarray(b), jnp.zeros(mesh.num_dofs(op.P)), op.diag_inv,
        rtol=1e-12, maxiter=500,
    )
    A = assemble_stiffness(mesh, op.P, kappa=2.0)
    res = np.linalg.norm(A @ np.asarray(x) - b) / np.linalg.norm(b)
    assert res < 1e-9
    assert int(info["niter"]) < 500


def test_cg_eigenvalue_estimates():
    """Lanczos estimates from 20 recorded CG iterations bracket the true
    extremal eigenvalues of M^-1 A (the smoother-calibration contract,
    python_tests/cg.py:133-138 / eigenvalue_computation.py)."""
    mesh, op = _problem(nc=(3, 3, 3), P=2)
    n = mesh.num_dofs(op.P)
    x, info = cg_solve(
        op, jnp.ones(n), jnp.zeros(n), op.diag_inv,
        rtol=1e-6, maxiter=20, record=True,
    )
    est = lanczos_eigenvalue_estimates(info["alphas"], info["betas"], info["stored"])
    A = assemble_stiffness(mesh, op.P, kappa=2.0).toarray()
    MA = np.asarray(op.diag_inv)[:, None] * A
    true = np.sort(np.real(np.linalg.eigvals(MA)))
    # The largest Ritz value approximates lambda_max from below; with the
    # 1.1 inflation used by the drivers it must cover the true lambda_max.
    assert est[-1] <= true[-1] * 1.0000001
    assert est[-1] * 1.1 > true[-1] * 0.99
    # Smallest Ritz value must lie within the spectrum.
    assert est[0] >= true[0] * 0.9


def test_eigenvalue_estimates_zero_stored():
    """CG that converges DURING its first iteration stores no
    coefficients, but the first alpha is still in the raw buffer and is
    a valid Rayleigh quotient (strongly shifted Newmark hierarchies on
    tiny meshes hit this — the old code raised)."""
    alphas = np.array([0.25, 0.0, 0.0])
    betas = np.zeros(3)
    stored = np.array([False, False, False])
    est = lanczos_eigenvalue_estimates(alphas, betas, stored)
    assert np.allclose(est, [4.0, 4.0])
    # All-zero raw buffer (no iterations ran at all) still raises.
    with pytest.raises(ValueError):
        lanczos_eigenvalue_estimates(np.zeros(3), betas, stored)


def test_cg_matches_reference_formulation():
    """CG trajectory equals an independent NumPy implementation of the
    same (Jacobi-preconditioned) recurrence to ~machine precision."""
    mesh, op = _problem(nc=(4, 4, 4), P=2)
    n = mesh.num_dofs(op.P)
    A = assemble_stiffness(mesh, op.P, kappa=2.0).toarray()
    Minv = np.asarray(op.diag_inv)
    b = np.ones(n)
    # NumPy mirror
    x_np = np.zeros(n)
    r = b - A @ x_np
    p = Minv * r
    rnorm = p @ r
    alphas, betas = [], []
    for _ in range(10):
        y = A @ p
        alpha = rnorm / (p @ y)
        x_np += alpha * p
        r -= alpha * y
        z = Minv * r
        rnorm_new = r @ z
        beta = rnorm_new / rnorm
        rnorm = rnorm_new
        p = beta * p + z
        alphas.append(alpha)
        betas.append(beta)
    x_jax, info = cg_solve(
        op, jnp.asarray(b), jnp.zeros(n), op.diag_inv,
        rtol=1e-30, maxiter=10, record=True,
    )
    # Identical recurrence well before convergence (large enough interior
    # that 10 iterations stay meaningful; the converged tail is chaotic in
    # FP summation order and not comparable).
    assert np.allclose(np.asarray(info["alphas"]), alphas, rtol=1e-8)
    assert np.allclose(np.asarray(info["betas"]), betas, rtol=1e-7)


def test_chebyshev4_matches_numpy_mirror():
    """Fourth-kind recurrence equals an independent dense NumPy twin."""
    mesh, op = _problem(nc=(2, 2, 2), P=2)
    n = mesh.num_dofs(op.P)
    A = assemble_stiffness(mesh, op.P, kappa=2.0).toarray()
    Minv = np.asarray(op.diag_inv)
    MA = Minv[:, None] * A
    lmax = 1.1 * np.max(np.real(np.linalg.eigvals(MA)))
    rng = np.random.default_rng(5)
    b = rng.standard_normal(n)
    x0 = rng.standard_normal(n)
    num_iters = 3
    # NumPy mirror of Phillips & Fischer 4th-kind smoothing
    x = x0.copy()
    r = b - A @ x
    z = (4.0 / (3.0 * lmax)) * Minv * r
    for k in range(1, num_iters + 1):
        x = x + z
        r = r - A @ z
        z = z * (2 * k - 1) / (2 * k + 3) + (8 * k + 4) / ((2 * k + 3) * lmax) * Minv * r
    x_jax = chebyshev4_solve(
        op, jnp.asarray(b), jnp.asarray(x0), op.diag_inv, lmax, num_iters
    )
    assert np.allclose(np.asarray(x_jax), x, atol=1e-12)


@pytest.mark.parametrize("kind", ["cheb4", "cheb1"])
def test_chebyshev_reduces_error(kind):
    """Smoothing from an exact-solution perturbation reduces the error —
    and the residual — substantially (smoother contract for PMG)."""
    mesh, op = _problem(nc=(3, 3, 3), P=3)
    n = mesh.num_dofs(op.P)
    A = assemble_stiffness(mesh, op.P, kappa=2.0).toarray()
    MA = np.asarray(op.diag_inv)[:, None] * A
    eigs = np.sort(np.real(np.linalg.eigvals(MA)))
    lmax = 1.1 * eigs[-1]
    rng = np.random.default_rng(11)
    x_true = rng.standard_normal(n)
    b = jnp.asarray(A @ x_true)
    x0 = jnp.zeros(n)
    if kind == "cheb4":
        x = chebyshev4_solve(op, b, x0, op.diag_inv, lmax, 5)
    else:
        x = chebyshev1_solve(op, b, x0, op.diag_inv, (0.1 * eigs[-1], lmax), 5)
    r0 = np.linalg.norm(np.asarray(b))
    r = np.linalg.norm(np.asarray(b) - A @ np.asarray(x))
    assert r < 0.35 * r0, (kind, r / r0)


def test_high_precision_stationary_guard():
    """The shared runtime guard (PMGHierarchy/DistPMG/GridPMG solve):
    warns for every stationary iteration whose matmuls may run in TF32
    (precision 'high' or 'default'; measured to diverge on an H100);
    'highest' is exact f32 and stays silent."""
    import warnings

    from pmg_dolfinx_jax.solvers.pmg import warn_high_precision_stationary

    for prec in ("high", "default"):
        with pytest.warns(UserWarning, match="diverged"):
            warn_high_precision_stationary(prec)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        warn_high_precision_stationary("highest")

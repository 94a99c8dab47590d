"""Independent NumPy/scipy V-cycle twin: a REAL oracle for the PMG
trajectory (the role python_tests/pmg.py plays against PETSc in the
reference, SURVEY.md §2.3).

Everything here is assembled scipy matrices + plain NumPy loops: recorded
Jacobi-CG calibration with scipy.linalg.eigh_tridiagonal Lanczos
estimates (the reference formula, src/cg.hpp:127-135), fourth-kind
Chebyshev smoothing, Kronecker-product transfer matrices, and the
pmg.hpp:56-155 cycle ordering. The jitted implementation must reproduce
this trajectory — unlike a recorded-residual regression, this detects
algorithmic drift, not just change.
"""

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp

from pmg_dolfinx_jax.fem.assembly import assemble_rhs, assemble_stiffness
from pmg_dolfinx_jax.fem.mesh import BoxMesh
from pmg_dolfinx_jax.models.poisson import PoissonProblem, f_rhs
from pmg_dolfinx_jax.ops.lattice import axis_interpolation_matrix

SMOOTHER_ITERS = 2
CAL_ITERS = 20
CAL_RTOL = 1e-6
LMAX_FACTOR = 1.1


def _np_recorded_cg(A, Minv, b, maxiter=CAL_ITERS, rtol=CAL_RTOL):
    """Jacobi-CG on A x = b recording (alpha, beta) with the reference's
    store-until-converged semantics (src/cg.hpp:148-222)."""
    x = np.zeros_like(b)
    r = b - A @ x
    p = Minv * r
    rnorm = p @ r
    rnorm0 = rnorm
    alphas, betas = [], []
    for _ in range(maxiter):
        y = A @ p
        alpha = rnorm / (p @ y)
        x = x + alpha * p
        r = r - alpha * y
        z = Minv * r
        rnorm_new = r @ z
        beta = rnorm_new / rnorm
        converged = rnorm_new / rnorm0 < rtol * rtol
        p = beta * p + z
        rnorm = rnorm_new
        if converged:
            break
        alphas.append(alpha)
        betas.append(beta)
    return np.array(alphas), np.array(betas)


def _np_lanczos_lmax(alphas, betas):
    """Largest Ritz value from the CG-Lanczos tridiagonal
    (reference formula, src/cg.hpp:127-135)."""
    m = len(alphas)
    d = np.empty(m)
    e = np.empty(max(m - 1, 0))
    d[0] = 1.0 / alphas[0]
    for i in range(1, m):
        d[i] = 1.0 / alphas[i] + betas[i - 1] / alphas[i - 1]
        e[i - 1] = np.sqrt(betas[i - 1]) / alphas[i - 1]
    return scipy.linalg.eigh_tridiagonal(d, e, eigvals_only=True)[-1]


def _np_cheb4(A, Minv, b, x, lmax, num_iters):
    r = b - A @ x
    z = (4.0 / (3.0 * lmax)) * Minv * r
    for k in range(1, num_iters + 1):
        x = x + z
        r = r - A @ z
        z = (z * (2 * k - 1) / (2 * k + 3)
             + (8 * k + 4) / ((2 * k + 3) * lmax) * Minv * r)
    return x


def _np_cg(A, Minv, b, x, rtol=1e-8, maxiter=60):
    """Coarse Jacobi-CG mirroring cg_solve's while_loop semantics."""
    r = b - A @ x
    p = Minv * r
    rnorm = p @ r
    rnorm0 = rnorm
    for _ in range(maxiter):
        y = A @ p
        alpha = rnorm / (p @ y)
        x = x + alpha * p
        r = r - alpha * y
        z = Minv * r
        rnorm_new = r @ z
        beta = rnorm_new / rnorm
        p = beta * p + z
        rnorm = rnorm_new
        if rnorm_new / rnorm0 < rtol * rtol:
            break
    return x


class NumpyPMG:
    """Assembled-matrix twin of PMGHierarchy + v_cycle."""

    def __init__(self, mesh, degrees, kappa):
        self.degrees = degrees
        self.A, self.Minv, self.lmax, self.bc = [], [], [], []
        for P in degrees:
            A = assemble_stiffness(mesh, P, kappa=kappa).tocsr()
            Minv = 1.0 / A.diagonal()
            a, b = _np_recorded_cg(A, Minv, np.ones(A.shape[0]))
            self.A.append(A)
            self.Minv.append(Minv)
            self.lmax.append(LMAX_FACTOR * _np_lanczos_lmax(a, b))
            self.bc.append(np.asarray(mesh.boundary_dof_marker(P)))
        self.I3 = []
        for i in range(len(degrees) - 1):
            Pc, Pf = degrees[i], degrees[i + 1]
            Ix, Iy, Iz = (
                sp.csr_matrix(axis_interpolation_matrix(nc_a, Pc, Pf))
                for nc_a in mesh.nc
            )
            self.I3.append(sp.kron(Ix, sp.kron(Iy, Iz)).tocsr())

    def v_cycle(self, b, u):
        L = len(self.degrees)
        us, bs = [None] * L, [None] * L
        us[L - 1], bs[L - 1] = u, b
        for i in range(L - 1, 0, -1):
            if i < L - 1:
                us[i] = np.zeros(self.A[i].shape[0])
            us[i] = _np_cheb4(self.A[i], self.Minv[i], bs[i], us[i],
                              self.lmax[i], SMOOTHER_ITERS)
            r = bs[i] - self.A[i] @ us[i]
            bs[i - 1] = self.I3[i - 1].T @ r
        b0 = np.where(self.bc[0], 0.0, bs[0])
        us[0] = _np_cg(self.A[0], self.Minv[0], b0,
                       np.zeros(self.A[0].shape[0]))
        for i in range(L - 1):
            us[i + 1] = us[i + 1] + self.I3[i] @ us[i]
            us[i + 1] = _np_cheb4(self.A[i + 1], self.Minv[i + 1], bs[i + 1],
                                  us[i + 1], self.lmax[i + 1], SMOOTHER_ITERS)
        return us[L - 1]

    def solve(self, b, num_cycles):
        u = np.zeros_like(b)
        rnorms = []
        for _ in range(num_cycles):
            u = self.v_cycle(b, u)
            rnorms.append(np.linalg.norm(b - self.A[-1] @ u))
        return u, rnorms


@pytest.mark.parametrize("operator", ["kron", "dofmap"])
def test_vcycle_trajectory_matches_numpy_twin(operator):
    nc, degrees, kappa = (6, 6, 6), (1, 3), 2.0
    mesh = BoxMesh(nc)
    twin = NumpyPMG(mesh, degrees, kappa)
    b = assemble_rhs(mesh, degrees[-1], f_rhs(kappa))
    u_np, rn_np = twin.solve(b, num_cycles=5)

    prob = PoissonProblem(nc=nc, degrees=degrees, kappa=kappa, coarse="cg",
                          operator=operator)
    # Calibrated eigenvalue bounds agree with the scipy twin's.
    for lm_twin, eigs in zip(twin.lmax, prob.hierarchy.eigs):
        assert np.isclose(lm_twin, LMAX_FACTOR * eigs[-1], rtol=1e-9)
    u, rn = prob.solve(num_cycles=5)
    assert np.allclose(rn, rn_np, rtol=1e-8), (rn, rn_np)
    assert np.allclose(np.asarray(u), u_np, atol=1e-10)


def test_vcycle_three_levels_matches_numpy_twin():
    """Deeper hierarchy (p = 1 -> 2 -> 4) against the same twin."""
    nc, degrees, kappa = (4, 4, 4), (1, 2, 4), 2.0
    mesh = BoxMesh(nc)
    twin = NumpyPMG(mesh, degrees, kappa)
    b = assemble_rhs(mesh, degrees[-1], f_rhs(kappa))
    u_np, rn_np = twin.solve(b, num_cycles=4)
    prob = PoissonProblem(nc=nc, degrees=degrees, kappa=kappa, coarse="cg",
                          operator="kron")
    u, rn = prob.solve(num_cycles=4)
    assert np.allclose(rn, rn_np, rtol=1e-8), (rn, rn_np)
    assert np.allclose(np.asarray(u), u_np, atol=1e-10)

"""Fast Diagonalization direct solver tests."""

import jax.numpy as jnp
import numpy as np
import scipy.sparse.linalg as spla

from pmg_dolfinx_jax.fem.assembly import assemble_rhs, assemble_stiffness, l2_error
from pmg_dolfinx_jax.fem.mesh import BoxMesh
from pmg_dolfinx_jax.models.poisson import f_rhs, u_exact
from pmg_dolfinx_jax.solvers.fdm import FastDiagonalizationSolver


def test_fdm_exact_direct_solve():
    """One FDM application == the sparse direct solve (f64)."""
    mesh = BoxMesh((4, 3, 5), extent=(1.0, 2.0, 0.7))
    P, kappa = 3, 2.0
    fdm = FastDiagonalizationSolver(mesh, P, kappa=kappa, dtype=jnp.float64)
    A = assemble_stiffness(mesh, P, kappa=kappa)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(mesh.num_dofs(P))
    b[np.asarray(mesh.boundary_dof_marker(P))] = 0.0
    u = np.asarray(fdm.solve(jnp.asarray(b)))
    u_ref = spla.spsolve(A.tocsc(), b)
    assert np.linalg.norm(u - u_ref) / np.linalg.norm(u_ref) < 1e-11


def test_fdm_poisson_manufactured():
    """FDM solves the flagship problem directly; L2 error at
    discretization level in a single application."""
    mesh = BoxMesh((8, 8, 8))
    P, kappa = 3, 2.0
    fdm = FastDiagonalizationSolver(mesh, P, kappa=kappa, dtype=jnp.float64)
    b = assemble_rhs(mesh, P, f_rhs(kappa))
    u = np.asarray(fdm.solve(jnp.asarray(b)))
    assert l2_error(mesh, P, u, u_exact) < 2e-5


def test_fdm_f32_with_refinement():
    """f32 FDM + f64 refinement reaches near-machine residuals."""
    mesh = BoxMesh((6, 6, 6))
    P, kappa = 3, 2.0
    fdm = FastDiagonalizationSolver(mesh, P, kappa=kappa, dtype=jnp.float32)
    b = assemble_rhs(mesh, P, f_rhs(kappa))
    u64, rnorms = fdm.refine(b, cycles=4)
    A = assemble_stiffness(mesh, P, kappa=kappa)
    r = np.linalg.norm(A @ np.asarray(u64) - b) / np.linalg.norm(b)
    assert r < 1e-10, (rnorms, r)


def test_fdm_preconditions_variable_coefficient():
    """FDM at the mean coefficient as FCG preconditioner for a
    variable-(DG-0)-kappa problem: converges in O(10) iterations where
    Jacobi-CG needs many more."""
    import jax

    from pmg_dolfinx_jax.fem.geometry import (
        geometry_factors,
        quadrature_weights_3d,
        tabulate_geometry_dphi,
    )
    from pmg_dolfinx_jax.fem.gll import derivative_matrix
    from pmg_dolfinx_jax.ops.laplacian import laplacian_apply
    from pmg_dolfinx_jax.solvers.cg import cg_solve, fcg_solve

    mesh = BoxMesh((4, 4, 4))
    P = 2
    rng = np.random.default_rng(3)
    kappa_c = 1.0 + 0.8 * rng.random(mesh.ncells)  # 1.8x contrast
    G, _ = geometry_factors(
        mesh.geometry_x, mesh.geometry_dofmap,
        tabulate_geometry_dphi(P), quadrature_weights_3d(P), xp=np,
    )
    lv = dict(
        dofmap=jnp.asarray(mesh.dofmap(P)), G=jnp.asarray(G),
        coeff=jnp.asarray(kappa_c), D=jnp.asarray(derivative_matrix(P)),
        bc=jnp.asarray(mesh.boundary_dof_marker(P)),
    )
    A = lambda x: laplacian_apply(x, lv["dofmap"], lv["G"], lv["coeff"],
                                  lv["D"], lv["bc"])
    fdm = FastDiagonalizationSolver(mesh, P, kappa=float(kappa_c.mean()),
                                    dtype=jnp.float64)
    b = np.zeros(mesh.num_dofs(P))
    b[~np.asarray(mesh.boundary_dof_marker(P))] = 1.0
    b = jnp.asarray(b)
    x, info = fcg_solve(A, b, jnp.zeros_like(b), fdm.solve,
                        rtol=1e-10, maxiter=60)
    niter = int(info["niter"])
    r = np.linalg.norm(np.asarray(b - A(x)))
    assert r / np.linalg.norm(np.asarray(b)) < 1e-8
    assert niter <= 15, niter
    # Jacobi-CG needs substantially more iterations on the same problem.
    from pmg_dolfinx_jax.fem.assembly import stiffness_diagonal_np

    dinv = jnp.asarray(1.0 / stiffness_diagonal_np(mesh, P, float(kappa_c.mean())))
    _, info_j = cg_solve(A, b, jnp.zeros_like(b), dinv, rtol=1e-10, maxiter=200)
    assert int(info_j["niter"]) > 2 * niter


def test_fdm_preconditions_deformed_mesh():
    """FDM on the underlying axis-aligned box as FCG preconditioner for
    the DEFORMED-hex operator (the mildly-deformed use advertised in
    solvers/fdm.py): converges in O(10) iterations to the scipy direct
    solution."""
    import scipy.sparse.linalg as spla

    from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh, default_warp
    from pmg_dolfinx_jax.ops.lattice import LatticeLaplacian
    from pmg_dolfinx_jax.solvers.cg import fcg_solve

    nc, P, kappa = (6, 6, 6), 3, 2.0
    mesh = PerturbedBoxMesh(nc, warp=default_warp(0.05))
    box = BoxMesh(nc)
    A = LatticeLaplacian(mesh, P, kappa=kappa, dtype=jnp.float64,
                         precision="highest")
    fdm = FastDiagonalizationSolver(box, P, kappa=kappa, dtype=jnp.float64)
    b = assemble_rhs(mesh, P, f_rhs(kappa))
    u, info = fcg_solve(
        A, jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)), fdm.solve,
        rtol=1e-12, maxiter=60,
    )
    niter = int(info["niter"])
    assert niter < 25, niter
    A_sp = assemble_stiffness(mesh, P, kappa=kappa)
    u_ref = spla.spsolve(A_sp.tocsc(), b)
    assert np.allclose(np.asarray(u), u_ref, atol=1e-8)

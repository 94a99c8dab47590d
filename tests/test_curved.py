"""General (non-affine) hexahedral mesh family: PerturbedBoxMesh.

The reference handles general Q1-coordinate hex meshes through DOLFINx;
here the lattice and dofmap backends do, with full 6-entry geometry
factors. These tests run the complete stack on smoothly deformed cells:
operator vs the independently assembled scipy matrix, FCG solve vs scipy
spsolve, and manufactured-solution convergence (the interior-bubble warp
keeps the domain EXACTLY the unit cube, so u_e is unchanged).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla

from pmg_dolfinx_jax.fem.assembly import (
    assemble_stiffness,
    l2_error_collocated,
)
from pmg_dolfinx_jax.fem.mesh import BoxMesh, PerturbedBoxMesh, default_warp
from pmg_dolfinx_jax.models.poisson import PoissonProblem, f_rhs, u_exact
from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy


def test_perturbed_mesh_geometry():
    mesh = PerturbedBoxMesh((4, 4, 4))
    box = BoxMesh((4, 4, 4))
    # Boundary vertices unmoved; interior vertices displaced.
    xb, xp = box.geometry_x, mesh.geometry_x
    on_bnd = np.any((xb == 0.0) | (xb == 1.0), axis=1)
    assert np.allclose(xp[on_bnd], xb[on_bnd])
    assert not np.allclose(xp[~on_bnd], xb[~on_bnd])
    # Q1-consistent dof coords: P=1 dof coords == vertex coords.
    assert np.allclose(mesh.dof_coords(1), xp)
    # Boundary dof coords lie exactly on the cube boundary at any P.
    c3 = mesh.dof_coords(3)
    bnd = np.asarray(mesh.boundary_dof_marker(3))
    onface = np.any(np.isclose(c3[bnd], 0.0) | np.isclose(c3[bnd], 1.0),
                    axis=1)
    assert onface.all()


@pytest.mark.parametrize("operator", ["lattice", "dofmap"])
def test_perturbed_operator_matches_assembled(operator):
    mesh = PerturbedBoxMesh((3, 4, 3))
    P = 3
    hier = PMGHierarchy(mesh, degrees=(1, P), kappa=2.0, coarse="cg",
                        operator=operator)
    A = assemble_stiffness(mesh, P, kappa=2.0)
    x = np.random.default_rng(0).standard_normal(mesh.num_dofs(P))
    y = np.asarray(hier.operator()(jnp.asarray(x)))
    assert np.allclose(y, A @ x, atol=1e-11)


def test_perturbed_full_solve_and_convergence():
    """FCG(V-cycle) on deformed hexes == scipy direct solve; L2 error
    vs the manufactured solution converges under h-refinement."""
    P = 3
    errs = []
    for n in (4, 8):
        mesh = PerturbedBoxMesh((n, n, n), warp=default_warp(0.06))
        from pmg_dolfinx_jax.fem.assembly import assemble_rhs

        hier = PMGHierarchy(mesh, degrees=(1, P), kappa=2.0, coarse="cg",
                            operator="lattice")
        b = assemble_rhs(mesh, P, f_rhs(2.0))
        u, niter = hier.solve_pcg(jnp.asarray(b), rtol=1e-11, maxiter=80)
        assert niter < 50
        A = assemble_stiffness(mesh, P, kappa=2.0)
        u_ref = spla.spsolve(A.tocsc(), b)
        assert np.allclose(np.asarray(u), u_ref, atol=1e-8)
        errs.append(l2_error_collocated(mesh, P, np.asarray(u), u_exact))
    # Q1 (isoparametric-trilinear) geometry limits convergence to ~O(h^2).
    assert errs[0] / errs[1] > 3.0, errs
    assert errs[1] < 2e-3, errs


def test_fast_paths_reject_nonaffine_mesh():
    mesh = PerturbedBoxMesh((4, 4, 4))
    from pmg_dolfinx_jax.ops.kron import KronLaplacian
    from pmg_dolfinx_jax.solvers.fdm import FastDiagonalizationSolver
    from pmg_dolfinx_jax.parallel.dist import DistPMG
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    with pytest.raises(ValueError, match="axis-aligned"):
        KronLaplacian(mesh, 2)
    with pytest.raises(ValueError, match="axis-aligned"):
        FastDiagonalizationSolver(mesh, 2)
    with pytest.raises(ValueError, match="axis-aligned"):
        PMGHierarchy(mesh, degrees=(1, 2), operator="kron")
    with pytest.raises(ValueError, match="axis-aligned"):
        PMGHierarchy(mesh, degrees=(1, 2), operator="lattice", coarse="fdm")
    with pytest.raises(ValueError, match="axis-aligned"):
        DistPMG(mesh, n_devices=4, degrees=(1, 2), operator="kron")
    with pytest.raises(ValueError, match="axis-aligned"):
        GridPMG(mesh, shards=(2, 2), degrees=(1, 2))


def test_perturbed_dist_lattice_matches_single():
    """Sharded lattice backend on deformed hexes == single device."""
    from pmg_dolfinx_jax.fem.assembly import assemble_rhs
    from pmg_dolfinx_jax.parallel.dist import DistPMG

    mesh = PerturbedBoxMesh((8, 4, 4), warp=default_warp(0.05))
    single = PMGHierarchy(mesh, degrees=(1, 3), kappa=2.0, coarse="cg",
                          operator="lattice")
    b = assemble_rhs(mesh, 3, f_rhs(2.0))
    u_s, rn_s = single.solve(jnp.asarray(b), num_cycles=5)
    dist = DistPMG(mesh, n_devices=4, degrees=(1, 3), kappa=2.0,
                   coarse="cg", operator="lattice")
    u_d, rn_d = dist.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


def test_refined_solve_on_curved_mesh():
    """Mixed-precision refinement with the f64 LATTICE residual (the
    Kronecker form doesn't exist on non-affine hexes) converges past the
    f32 floor on a perturbed mesh."""
    from pmg_dolfinx_jax.fem.assembly import assemble_rhs

    mesh = PerturbedBoxMesh((6, 6, 6))
    h = PMGHierarchy(mesh, degrees=(1, 3), kappa=2.0, coarse="cg",
                     operator="lattice", dtype=jnp.float32)
    b = assemble_rhs(mesh, 3, f_rhs(2.0))
    # Contraction is ~0.56/cycle on deformed cells (Jacobi-Chebyshev
    # degrades with cell distortion, as in the reference smoothers).
    u, rn = h.solve_refined(b, num_cycles=30)
    r0 = np.linalg.norm(b)
    assert rn[-1] / r0 < 1e-6, np.array(rn) / r0
    assert all(b_ < a_ for a_, b_ in zip(rn, rn[1:]))


def test_refined_solve_variable_kappa():
    """Refinement with a per-cell DG-0 coefficient (f64 lattice
    residual path, box mesh)."""
    from pmg_dolfinx_jax.fem.assembly import assemble_rhs
    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.models.poisson import f_rhs_variable, kappa_linear

    mesh = BoxMesh((6, 6, 6))
    h = PMGHierarchy(mesh, degrees=(1, 3), kappa=kappa_linear, coarse="cg",
                     operator="lattice", dtype=jnp.float32)
    b = assemble_rhs(mesh, 3, f_rhs_variable())
    u, rn = h.solve_refined(b, num_cycles=25)
    r0 = np.linalg.norm(b)
    assert rn[-1] / r0 < 1e-5, np.array(rn) / r0
    assert all(b_ < a_ for a_, b_ in zip(rn, rn[1:]))


def test_perturbed_dist_refined():
    """Sharded refinement on deformed hexes uses the f64 LATTICE
    residual (the kron form would silently solve the wrong operator;
    code-review r2 finding)."""
    from pmg_dolfinx_jax.fem.assembly import assemble_rhs
    from pmg_dolfinx_jax.parallel.dist import DistPMG

    mesh = PerturbedBoxMesh((8, 4, 4), warp=default_warp(0.05))
    dist = DistPMG(mesh, n_devices=4, degrees=(1, 3), kappa=2.0,
                   coarse="cg", operator="lattice", dtype=jnp.float32)
    b = assemble_rhs(mesh, 3, f_rhs(2.0))
    single = PMGHierarchy(mesh, degrees=(1, 3), kappa=2.0, coarse="cg",
                          operator="lattice", dtype=jnp.float32)
    u_s, rn_s = single.solve_refined(jnp.asarray(b), num_cycles=15)
    u_d, rn_d = dist.solve_refined(b, num_cycles=15)
    assert np.allclose(rn_d, rn_s, rtol=1e-3), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-6)

"""Spatially varying reaction coefficient sigma(x) (variable-sigma
family): ``-div(kappa grad u) + sigma(x) u = f``. Implementation is the
m3-baking design (fem.assembly.resolve_sigma/shifted_mass_np): the
field is folded into every level's lumped-mass vector with the ops
scalar at 1.0, so no apply path changes anywhere. Ground truth: the
scipy-assembled shifted system ``A + diag(m * sigma(x))``."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from pmg_dolfinx_jax.fem.assembly import (
    assemble_stiffness,
    lumped_mass_np,
)
from pmg_dolfinx_jax.fem.mesh import BoxMesh, PerturbedBoxMesh
from pmg_dolfinx_jax.models.poisson import kappa_linear
from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy


def sigma_field(x):
    """Smooth positive reaction field, O(1)..O(40)."""
    return 1.0 + 40.0 * x[0] * x[1] + 5.0 * x[2] ** 2


def _assembled_shifted(mesh, P, kappa):
    A = assemble_stiffness(mesh, P, kappa=kappa).tolil()
    m = lumped_mass_np(mesh, P, bc_zero=True)
    sd = sigma_field(mesh.dof_coords(P).T)
    A.setdiag(A.diagonal() + m * sd)
    return A.tocsr()


@pytest.mark.parametrize("operator,mesh,kappa", [
    ("lattice", BoxMesh((4, 4, 4)), 2.0),
    ("dofmap", BoxMesh((4, 4, 4)), 2.0),
    ("lattice", PerturbedBoxMesh((4, 3, 4)), kappa_linear),
])
def test_sigma_field_operator_oracle(operator, mesh, kappa):
    """The hierarchy's fine operator == the assembled shifted matrix."""
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=kappa, coarse="cg",
                        operator=operator, sigma=sigma_field)
    A = _assembled_shifted(mesh, 3, kappa)
    u = np.random.default_rng(0).standard_normal(mesh.num_dofs(3))
    y = np.asarray(hier.operator()(jnp.asarray(u)))
    assert np.allclose(y, A @ u, atol=1e-10), np.abs(y - A @ u).max()


@pytest.mark.parametrize("coarse", ["cg", "direct", "hmg"])
def test_sigma_field_solve_matches_scipy(coarse):
    """FCG(V) solves the SHIFTED system for every coarse mode (hmg
    rediscretizes the field per h-level; direct bakes it into the
    bottom factor)."""
    mesh = BoxMesh((6, 6, 6))
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=2.0, coarse=coarse,
                        operator="lattice", sigma=sigma_field)
    b = np.random.default_rng(1).standard_normal(mesh.num_dofs(3))
    bc = np.asarray(mesh.boundary_dof_marker(3))
    b[bc] = 0.0
    u, it = hier.solve_pcg(jnp.asarray(b), rtol=1e-11, maxiter=40)
    u_ref = spla.spsolve(_assembled_shifted(mesh, 3, 2.0),
                         np.where(bc, 0.0, b))
    assert it < 40
    assert np.allclose(np.asarray(u), u_ref, atol=1e-8), (
        np.abs(np.asarray(u) - u_ref).max())


def test_sigma_field_refined_matches_scipy():
    mesh = PerturbedBoxMesh((4, 4, 4))
    hier = PMGHierarchy(mesh, degrees=(1, 2), kappa=2.0, coarse="cg",
                        operator="lattice", sigma=sigma_field,
                        dtype=jnp.float64)
    b = np.random.default_rng(2).standard_normal(mesh.num_dofs(2))
    bc = np.asarray(mesh.boundary_dof_marker(2))
    b[bc] = 0.0
    u, rn = hier.solve_refined(jnp.asarray(b), num_cycles=20)
    u_ref = spla.spsolve(_assembled_shifted(mesh, 2, 2.0), b)
    assert np.allclose(np.asarray(u), u_ref, atol=1e-9), (
        np.abs(np.asarray(u) - u_ref).max())


def test_sigma_field_sharded_matches_single():
    """Slab and grid decompositions: exact trajectory match vs the
    single-device hierarchy (the baked m3 rides the usual layouts)."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    mesh = BoxMesh((8, 4, 4))
    b = np.random.default_rng(3).standard_normal(mesh.num_dofs(3))
    single = PMGHierarchy(mesh, degrees=(1, 3), kappa=2.0, coarse="cg",
                          operator="lattice", sigma=sigma_field)
    _, rn_s = single.solve(jnp.asarray(b), num_cycles=5)
    dist = DistPMG(mesh, n_devices=4, degrees=(1, 3), kappa=2.0,
                   coarse="cg", operator="lattice", sigma=sigma_field)
    _, rn_d = dist.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-10), (rn_s, rn_d)
    grid = GridPMG(mesh, shards=(2, 2, 1), degrees=(1, 3), kappa=2.0,
                   coarse="cg", operator="lattice", sigma=sigma_field)
    _, rn_g = grid.solve(b, num_cycles=5)
    assert np.allclose(rn_g, rn_s, rtol=1e-10), (rn_s, rn_g)
    # Gathered direct coarse with the baked field (the A0 diagonal).
    single_d = PMGHierarchy(mesh, degrees=(1, 3), kappa=2.0,
                            coarse="direct", operator="lattice",
                            sigma=sigma_field)
    _, rn_sd = single_d.solve(jnp.asarray(b), num_cycles=5)
    dist_d = DistPMG(mesh, n_devices=4, degrees=(1, 3), kappa=2.0,
                     coarse="direct", operator="lattice",
                     sigma=sigma_field)
    _, rn_dd = dist_d.solve(b, num_cycles=5)
    assert np.allclose(rn_dd, rn_sd, rtol=1e-10), (rn_sd, rn_dd)


def test_sigma_field_dist_hmg_general_grid():
    """The distributed (dist=True) general-family h-MG coarse threads
    the field per rediscretized h-level — trajectory-exact vs the
    single-device hmg (same level sizes)."""
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    mesh = PerturbedBoxMesh((4, 8, 4))
    b = np.random.default_rng(4).standard_normal(mesh.num_dofs(3))
    single = PMGHierarchy(mesh, degrees=(1, 3), kappa=kappa_linear,
                          coarse="hmg", operator="lattice",
                          sigma=sigma_field)
    _, rn_s = single.solve(jnp.asarray(b), num_cycles=5)
    grid = GridPMG(mesh, shards=(2, 2, 2), degrees=(1, 3),
                   kappa=kappa_linear, coarse="hmg",
                   coarse_cfg=dict(dist=True), operator="lattice",
                   sigma=sigma_field)
    _, rn_g = grid.solve(b, num_cycles=5)
    assert np.allclose(rn_g, rn_s, rtol=1e-10), (rn_s, rn_g)


def test_sigma_field_rejections():
    mesh = BoxMesh((4, 4, 4))
    with pytest.raises(ValueError, match="general backend"):
        PMGHierarchy(mesh, degrees=(1, 2), kappa=2.0, operator="kron",
                     sigma=sigma_field)
    with pytest.raises(ValueError, match="scalar sigma"):
        PMGHierarchy(mesh, degrees=(1, 2), kappa=2.0, operator="lattice",
                     coarse="fdm", sigma=sigma_field)
    with pytest.raises(ValueError, match="scalar sigma"):
        PMGHierarchy(mesh, degrees=(1, 2), kappa=2.0, operator="lattice",
                     smoother="schwarz", sigma=sigma_field)
    from pmg_dolfinx_jax.models.poisson import PoissonProblem

    with pytest.raises(ValueError, match="source term"):
        PoissonProblem(nc=(4, 4, 4), degrees=(1, 2), kappa=2.0,
                       operator="lattice", sigma=sigma_field)

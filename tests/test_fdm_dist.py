"""Distributed Fast Diagonalization (parallel/fdm_dist.py).

The pencil-transpose FDM must be VALUE-exact against the single-device
`fdm_solve` (the embedded boundary rows only add exact-zero terms to the
same dot products), both standalone and as the non-gathered
``coarse='fdm', coarse_cfg=dict(dist=True)`` V-cycle coarse solve on the
slab and multi-axis grid layouts. Reference analogue: the coarse KSP
solve running under any rank layout (src/amg.hpp:67-113) — here exact,
direct, and without gathering.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pmg_dolfinx_jax.fem.assembly import assemble_rhs
from pmg_dolfinx_jax.fem.mesh import BoxMesh, PerturbedBoxMesh
from pmg_dolfinx_jax.models.poisson import PoissonProblem, f_rhs
from pmg_dolfinx_jax.parallel.dist import DistPMG
from pmg_dolfinx_jax.parallel.fdm_dist import DistFDM
from pmg_dolfinx_jax.parallel.grid2d import GridPMG
from pmg_dolfinx_jax.solvers.fdm import FastDiagonalizationSolver


@pytest.mark.parametrize(
    "shards,kappa,sigma,Pdeg,nc",
    [
        (4, 2.0, 0.0, 3, (8, 5, 6)),
        (8, 2.0, 7.5, 4, (8, 5, 6)),  # slab + lumped-mass shift
        ((2, 2, 2), (1.0, 3.0, 64.0), 0.0, 3, (6, 4, 8)),  # per-axis kappa
        ((4, 2, 1), 2.0, 3.0, 2, (8, 6, 5)),  # mixed grid, one axis local
    ],
)
def test_dist_fdm_matches_single_device(shards, kappa, sigma, Pdeg, nc):
    """Standalone distributed direct solve == single-device FDM to f64
    roundoff on slab, 3D-grid and mixed layouts."""
    mesh = BoxMesh(nc)
    b = np.random.default_rng(0).standard_normal(mesh.num_dofs(Pdeg))
    ref = FastDiagonalizationSolver(
        mesh, Pdeg, kappa=kappa, dtype=jnp.float64, sigma=sigma
    )
    u_ref = np.asarray(ref.solve(b))
    dist = DistFDM(mesh, Pdeg, shards, kappa=kappa, dtype=jnp.float64,
                   sigma=sigma)
    u_d = dist.solve(b)
    err = np.max(np.abs(u_d - u_ref)) / np.max(np.abs(u_ref))
    assert err < 1e-13, err


def test_dist_fdm_solution_is_exact():
    """The distributed direct solve really solves: A u == b through the
    oracle operator, and nonzero Dirichlet rows pass through."""
    from pmg_dolfinx_jax.ops.laplacian import MatFreeLaplacian

    mesh = BoxMesh((8, 4, 4))
    Pdeg, kappa = 3, 2.0
    rng = np.random.default_rng(1)
    b = rng.standard_normal(mesh.num_dofs(Pdeg))
    bc = np.asarray(mesh.boundary_dof_marker(Pdeg))
    dist = DistFDM(mesh, Pdeg, 4, kappa=kappa, dtype=jnp.float64)
    u = dist.solve(b)
    assert np.allclose(u[bc], b[bc])  # identity rows
    op = MatFreeLaplacian(mesh, Pdeg, kappa=kappa, dtype=jnp.float64)
    r = np.asarray(op(jnp.asarray(u))) - np.where(bc, u, b)
    assert np.linalg.norm(r[~bc]) / np.linalg.norm(b[~bc]) < 1e-12


def test_dist_fdm_rejects_curved_mesh():
    mesh = PerturbedBoxMesh((4, 4, 4))
    with pytest.raises(ValueError):
        DistFDM(mesh, 2, 4)


def test_dist_fdm_coarse_slab_matches_single():
    """DistPMG coarse='fdm' with coarse_cfg dist=True (pencil transposes,
    no gather) reproduces the single-device FDM-coarse trajectory."""
    nc = (8, 8, 8)
    kappa = 2.0
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa,
                            coarse="fdm", operator="kron")
    u_s, rn_s = single.solve(num_cycles=5)
    dist = DistPMG(single.mesh, n_devices=8, degrees=(1, 3), kappa=kappa,
                   coarse="fdm", coarse_cfg=dict(dist=True),
                   operator="kron")
    b = assemble_rhs(single.mesh, 3, f_rhs(kappa))
    u_d, rn_d = dist.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-9), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-10)


def test_dist_hmg_fdm_bottom_slab_matches_single():
    """Fully gather-free hierarchy: distributed h-MG coarse with the
    distributed-FDM bottom (coarse_cfg dist=True, bottom='fdm'). The FDM
    bottom is exact like the single-device Cholesky bottom, so the
    trajectory must match the single-device hmg coarse. (nc chosen so
    the shard-aligned hierarchy has the same depth as the single-device
    one — the usual alignment caveat, see coarse_cfg['divisors'].)"""
    nc = (8, 4, 4)
    kappa = 2.0
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa,
                            coarse="hmg", operator="kron")
    u_s, rn_s = single.solve(num_cycles=5)
    dist = DistPMG(single.mesh, n_devices=4, degrees=(1, 3), kappa=kappa,
                   coarse="hmg", coarse_cfg=dict(dist=True, bottom="fdm"),
                   operator="kron")
    b = assemble_rhs(single.mesh, 3, f_rhs(kappa))
    u_d, rn_d = dist.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-9), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-10)


def test_dist_hmg_fdm_bottom_grid_matches_single():
    """The multi-axis twin: GridPMG (2,2,2) distributed h-MG with the
    distributed-FDM bottom — no gather anywhere in the solve."""
    nc = (8, 8, 8)
    kappa, sigma = 2.0, 11.0
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa,
                            coarse="hmg", operator="kron", sigma=sigma)
    u_s, rn_s = single.solve(num_cycles=5)
    grid = GridPMG(single.mesh, shards=(2, 2, 2), degrees=(1, 3),
                   kappa=kappa, sigma=sigma, coarse="hmg",
                   coarse_cfg=dict(dist=True, bottom="fdm"))
    b = assemble_rhs(single.mesh, 3, f_rhs(kappa, sigma=sigma))
    u_d, rn_d = grid.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-9), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-10)


def test_hmg_fdm_bottom_rejected_where_unsupported():
    """bottom='fdm' is dist-only (gathered build_hmg) and
    constant-coefficient only (general family)."""
    from pmg_dolfinx_jax.solvers.hmg import build_hmg, build_hmg_general

    mesh = BoxMesh((4, 4, 4))
    with pytest.raises(ValueError, match="bottom"):
        build_hmg(mesh, 1, 2.0, jnp.float64, bottom="fdm")
    with pytest.raises(ValueError, match="bottom"):
        build_hmg_general(PerturbedBoxMesh((4, 4, 4)), 1, 2.0,
                          jnp.float64, bottom="fdm")


@pytest.mark.parametrize("shards,sigma,kappa", [
    ((2, 2, 2), 0.0, 2.0),
    ((2, 4), 37.0, (1.0, 3.0, 64.0)),  # shift + per-axis kappa
])
def test_dist_fdm_coarse_grid_matches_single(shards, sigma, kappa):
    """GridPMG coarse='fdm' with coarse_cfg dist=True on multi-axis
    layouts: exact trajectory match vs the single-device FDM coarse."""
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    nc = (4, 8, 4)
    mesh = BoxMesh(nc)
    single = PMGHierarchy(mesh, degrees=(1, 3), kappa=kappa,
                          coarse="fdm", operator="kron", sigma=sigma)
    b = np.random.default_rng(2).standard_normal(mesh.num_dofs(3))
    u_s, rn_s = single.solve(jnp.asarray(b), num_cycles=5)
    grid = GridPMG(mesh, shards=shards, degrees=(1, 3), kappa=kappa,
                   coarse="fdm", coarse_cfg=dict(dist=True), sigma=sigma)
    u_d, rn_d = grid.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-9), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-10)

"""2D (x, y) device-mesh decomposition tests (kron backend).

Same rank-invariance contract as the 1D slab tests, on a 2x4 and 4x2
device grid: operator, calibration, and full V-cycle trajectories must
match the single-device results.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pmg_dolfinx_jax.fem.assembly import assemble_rhs
from pmg_dolfinx_jax.fem.mesh import BoxMesh
from pmg_dolfinx_jax.models.poisson import PoissonProblem, f_rhs
from pmg_dolfinx_jax.parallel.grid2d import GridPartition, GridPMG


def test_grid_partition_roundtrip_and_weights():
    mesh = BoxMesh((4, 6, 3))
    part = GridPartition(mesh, (2, 3))
    for P in (1, 3):
        u = np.random.default_rng(0).standard_normal(mesh.num_dofs(P))
        ud = part.to_dist(P, u)
        assert np.array_equal(part.from_dist(P, ud), u)
        w = part.ownership_weights(P)
        assert w.shape == ud.shape
        assert int(round(w.sum())) == mesh.num_dofs(P)
        assert np.allclose((ud**2 * w).sum(), u @ u)


@pytest.mark.parametrize("shards", [(2, 4), (4, 2)])
def test_grid2d_pmg_matches_single_device(shards):
    nc = (8, 8, 4)
    kappa = 2.0
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa, coarse="cg",
                            operator="kron")
    u_s, rn_s = single.solve(num_cycles=5)
    grid = GridPMG(single.mesh, shards=shards, degrees=(1, 3), kappa=kappa,
                   coarse="cg")
    for es, ed in zip(single.hierarchy.eigs, grid.eigs):
        assert np.allclose(es[-1], ed[-1], rtol=1e-8)
    b = assemble_rhs(single.mesh, 3, f_rhs(kappa))
    u_d, rn_d = grid.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


def test_grid3d_pmg_matches_single_device():
    """Full 3D (2,2,2) box decomposition on 8 devices == single device."""
    nc = (4, 4, 4)
    kappa = 2.0
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa, coarse="cg",
                            operator="kron")
    u_s, rn_s = single.solve(num_cycles=5)
    grid = GridPMG(single.mesh, shards=(2, 2, 2), degrees=(1, 3), kappa=kappa,
                   coarse="cg")
    b = assemble_rhs(single.mesh, 3, f_rhs(kappa))
    u_d, rn_d = grid.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


def test_grid3d_partition_roundtrip():
    mesh = BoxMesh((4, 4, 6))
    part = GridPartition(mesh, (2, 2, 2))
    for P in (1, 2):
        u = np.random.default_rng(1).standard_normal(mesh.num_dofs(P))
        ud = part.to_dist(P, u)
        assert np.array_equal(part.from_dist(P, ud), u)
        w = part.ownership_weights(P)
        assert int(round(w.sum())) == mesh.num_dofs(P)
        assert np.allclose((ud**2 * w).sum(), u @ u)


@pytest.mark.parametrize("coarse", ["fdm", "direct", "hmg"])
def test_grid_global_coarse_matches_single_device(coarse):
    """Gathered global coarse solvers (fdm/direct/hmg) on a (2,2,2) grid
    reproduce the single-device trajectories (VERDICT r1 item 2)."""
    nc = (4, 4, 4)
    kappa = 2.0
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa,
                            coarse=coarse, operator="kron")
    u_s, rn_s = single.solve(num_cycles=5)
    grid = GridPMG(single.mesh, shards=(2, 2, 2), degrees=(1, 3),
                   kappa=kappa, coarse=coarse)
    b = assemble_rhs(single.mesh, 3, f_rhs(kappa))
    u_d, rn_d = grid.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


@pytest.mark.parametrize("shards,sigma", [((2, 2, 2), 0.0),
                                          ((2, 4), 37.0)])
def test_grid_hmg_distributed_coarse_matches_single(shards, sigma):
    """Non-gathered h-MG coarse on the grid (coarse_cfg dist=True): every
    h-level stays in the multi-axis duplicated-plane layout, only the
    coarsest bottom solve gathers. Same h-hierarchy sizes as the
    single-device build, so trajectories must match the gathered/single
    hmg coarse (the multi-axis twin of
    test_parallel.test_dist_hmg_distributed_coarse_matches_single)."""
    nc = (4, 8, 4)
    kappa = 2.0
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa,
                            coarse="hmg", operator="kron", sigma=sigma)
    u_s, rn_s = single.solve(num_cycles=5)
    grid = GridPMG(single.mesh, shards=shards, degrees=(1, 3), kappa=kappa,
                   coarse="hmg", coarse_cfg=dict(dist=True), sigma=sigma)
    b = assemble_rhs(single.mesh, 3, f_rhs(kappa, sigma=sigma))
    u_d, rn_d = grid.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


def test_grid_hmg_distributed_coarse_general_family():
    """Distributed h-MG coarse for the GENERAL family on the grid
    (`build_hmg_grid_general`): curved hexes + variable DG-0 kappa +
    sigma, every rediscretized lattice h-level in the multi-axis
    layout. Same level sizes as the single-device general build, so
    trajectories must match the gathered/single hmg coarse."""
    from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_jax.models.poisson import f_rhs_variable, kappa_linear

    sigma = 5.0
    mesh = PerturbedBoxMesh((4, 8, 4))
    single = PoissonProblem(nc=mesh.nc, mesh=mesh, degrees=(1, 3),
                            kappa=kappa_linear, coarse="hmg",
                            operator="lattice", sigma=sigma,
                            f=f_rhs_variable(sigma=sigma))
    u_s, rn_s = single.solve(num_cycles=5)
    grid = GridPMG(mesh, shards=(2, 2, 2), degrees=(1, 3),
                   kappa=kappa_linear, coarse="hmg",
                   coarse_cfg=dict(dist=True), operator="lattice",
                   sigma=sigma)
    b = assemble_rhs(mesh, 3, f_rhs_variable(sigma=sigma))
    u_d, rn_d = grid.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


def test_grid_hmg_distributed_coarse_rejects_unalignable():
    """dist=True needs every h-level's cells divisible per axis by the
    shard grid; a (4,4,4) mesh on (4,1,1) shards cannot coarsen at all
    -> clear error."""
    from pmg_dolfinx_jax.parallel.grid2d import build_hmg_grid

    mesh = BoxMesh((4, 4, 4))
    with pytest.raises(ValueError, match="not h-coarsenable"):
        build_hmg_grid(mesh, (4, 1, 1), 1, 2.0, jnp.float64)


def test_grid_fdm_coarse_2d_shards():
    """FDM coarse with an unsharded axis (shards=(2,4,1))."""
    nc = (4, 8, 4)
    kappa = 2.0
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa,
                            coarse="fdm", operator="kron")
    u_s, rn_s = single.solve(num_cycles=5)
    grid = GridPMG(single.mesh, shards=(2, 4), degrees=(1, 3), kappa=kappa,
                   coarse="fdm")
    b = assemble_rhs(single.mesh, 3, f_rhs(kappa))
    u_d, rn_d = grid.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


def test_grid_solve_pcg_converges_and_matches_single():
    nc = (4, 4, 4)
    kappa = 2.0
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa,
                            coarse="fdm", operator="kron")
    u_s, n_s = single.hierarchy.solve_pcg(single.b, rtol=1e-8)
    grid = GridPMG(single.mesh, shards=(2, 2, 2), degrees=(1, 3),
                   kappa=kappa, coarse="fdm")
    b = assemble_rhs(single.mesh, 3, f_rhs(kappa))
    u_d, n_d = grid.solve_pcg(b, rtol=1e-8)
    assert n_d == n_s
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-8)


def test_grid_refined_solve_matches_single():
    nc = (4, 4, 4)
    kappa = 2.0
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa, coarse="cg",
                            operator="kron", dtype=jnp.float32)
    u_s, rn_s = single.hierarchy.solve_refined(single.b, num_cycles=12)
    grid = GridPMG(single.mesh, shards=(2, 2, 2), degrees=(1, 3),
                   kappa=kappa, coarse="cg", dtype=jnp.float32)
    b = assemble_rhs(single.mesh, 3, f_rhs(kappa))
    u_d, rn_d = grid.solve_refined(b, num_cycles=12)
    r0 = np.linalg.norm(b)
    assert rn_d[-1] / r0 < 1e-6, np.array(rn_d) / r0
    assert np.allclose(rn_d, rn_s, rtol=1e-3), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-6)


def test_grid_rejects_unknown_coarse():
    with pytest.raises(ValueError, match="unsupported coarse"):
        GridPMG(BoxMesh((4, 4, 4)), shards=(2, 2), coarse="nope")
    with pytest.raises(ValueError, match="operator"):
        GridPMG(BoxMesh((4, 4, 4)), shards=(2, 2), operator="nope")


def test_grid_lattice_backend_matches_single():
    """Lattice backend on a (2,2,2) grid == single-device lattice."""
    nc = (4, 4, 4)
    kappa = 2.0
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa, coarse="cg",
                            operator="lattice")
    u_s, rn_s = single.solve(num_cycles=5)
    grid = GridPMG(single.mesh, shards=(2, 2, 2), degrees=(1, 3),
                   kappa=kappa, coarse="cg", operator="lattice")
    for es, ed in zip(single.hierarchy.eigs, grid.eigs):
        assert np.allclose(es[-1], ed[-1], rtol=1e-8)
    b = assemble_rhs(single.mesh, 3, f_rhs(kappa))
    u_d, rn_d = grid.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


def test_grid_lattice_variable_kappa_matches_single():
    """Variable DG-0 kappa on a multi-axis (2,2,2) grid (previously
    slab-only; VERDICT r1 items 3+4)."""
    from pmg_dolfinx_jax.models.poisson import f_rhs_variable, kappa_linear

    nc = (4, 4, 4)
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa_linear,
                            coarse="cg", operator="lattice",
                            f=f_rhs_variable())
    u_s, rn_s = single.solve(num_cycles=5)
    grid = GridPMG(single.mesh, shards=(2, 2, 2), degrees=(1, 3),
                   kappa=kappa_linear, coarse="cg", operator="lattice")
    b = assemble_rhs(single.mesh, 3, f_rhs_variable())
    u_d, rn_d = grid.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


def test_grid_lattice_perturbed_hexes_matches_single():
    """General (non-affine) hexes distributed over a 2D device grid:
    trajectories and solutions match the single-device lattice path."""
    from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    mesh = PerturbedBoxMesh((4, 4, 2))
    kappa = 2.0
    single = PMGHierarchy(mesh, degrees=(1, 3), kappa=kappa, coarse="cg",
                          operator="lattice")
    b = assemble_rhs(mesh, 3, f_rhs(kappa))
    u_s, rn_s = single.solve(b, num_cycles=5)
    grid = GridPMG(mesh, shards=(2, 2), degrees=(1, 3), kappa=kappa,
                   coarse="cg", operator="lattice")
    u_d, rn_d = grid.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


def test_grid_lattice_f32_matches_f64():
    """The f32 working-precision lattice backend on the grid tracks the
    f64 grid trajectory (perturbed hexes, variable kappa)."""
    from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_jax.models.poisson import f_rhs_variable, kappa_linear

    mesh = PerturbedBoxMesh((4, 4, 2))
    b = assemble_rhs(mesh, 3, f_rhs_variable())
    kwargs = dict(shards=(2, 2), degrees=(1, 3), kappa=kappa_linear,
                  coarse="cg", operator="lattice")
    ref = GridPMG(mesh, dtype=jnp.float64, **kwargs)
    blk = GridPMG(mesh, dtype=jnp.float32, **kwargs)
    _, rn_ref = ref.solve(b, num_cycles=4)
    _, rn_blk = blk.solve(b, num_cycles=4)
    assert np.allclose(rn_ref, rn_blk, rtol=1e-4), (rn_ref, rn_blk)


@pytest.mark.parametrize("shards", [(2, 2, 2), (1, 2, 4), (2, 4, 1)])
def test_grid_kron_f32_matches_single(shards):
    """The f32 kron backend under multi-axis decompositions:
    trajectories track the single-device f32 hierarchy on every shard
    layout, including y/z-only grids."""
    nc = (4, 4, 4)
    kwargs = dict(degrees=(1, 3), kappa=2.0, coarse="cg",
                  dtype=jnp.float32)
    single = PoissonProblem(nc=nc, operator="kron", **kwargs)
    u_s, rn_s = single.solve(num_cycles=5)
    grid = GridPMG(single.mesh, shards=shards, operator="kron",
                   **kwargs)
    b = assemble_rhs(single.mesh, 3, f_rhs(2.0))
    u_d, rn_d = grid.solve(b, num_cycles=5)
    # f32 throughout: psum/exchange reduction order differs from the
    # single-device sums, so trajectories carry ~1e-4 relative noise.
    assert np.allclose(rn_d, rn_s, rtol=5e-4), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-5)


def test_grid_dofmap_oracle_matches_single():
    """The fully general dofmap oracle under a (2,2,2) grid (the last
    cell of the backend x decomposition matrix): trajectories match the
    single-device dofmap hierarchy exactly (f64), on a CURVED mesh with
    variable DG-0 kappa and the sigma shift — the most general problem
    the framework expresses."""
    from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_jax.models.poisson import f_rhs_variable, kappa_linear
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    mesh = PerturbedBoxMesh((4, 4, 2))
    kwargs = dict(degrees=(1, 3), kappa=kappa_linear, coarse="cg",
                  operator="dofmap", sigma=11.0)
    single = PMGHierarchy(mesh, **kwargs)
    b = assemble_rhs(mesh, 3, f_rhs_variable(sigma=11.0))
    u_s, rn_s = single.solve(jnp.asarray(b), num_cycles=5)
    grid = GridPMG(mesh, shards=(2, 2, 2), **kwargs)
    u_d, rn_d = grid.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-9), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-10)


def test_grid_kron_f32_apply_oracle():
    """Grid f32 kron apply == the f64 assembled operator (single apply,
    (2,2,2) shards, all three exchange paths active)."""
    from pmg_dolfinx_jax.fem.assembly import assemble_stiffness
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    mesh = BoxMesh((4, 4, 4))
    kappa = 2.0
    grid = GridPMG(mesh, shards=(2, 2, 2), degrees=(1, 3), kappa=kappa,
                   coarse="cg", dtype=jnp.float32, operator="kron")
    A = assemble_stiffness(mesh, 3, kappa=kappa).toarray()
    rng = np.random.default_rng(11)
    x = rng.standard_normal(mesh.num_dofs(3))
    xd = grid.to_dist(x)
    lvf = grid.data["levels"][-1]
    import jax
    from jax.sharding import PartitionSpec as P

    yd = jax.jit(
        jax.shard_map(
            lambda lv, v: grid._ops["apply"](lv, v, grid.levels[-1]),
            mesh=grid.jmesh,
            in_specs=(grid.data_specs["levels"][-1], P("x", "y", "z")),
            out_specs=P("x", "y", "z"),
        )
    )(lvf, xd)
    y = grid.from_dist(yd)
    ref = A @ x
    err = np.linalg.norm(y - ref) / np.linalg.norm(ref)
    assert err < 1e-5, err


def test_grid_kron_f32_sigma_and_fdm_coarse():
    """Shifted family + global fdm coarse through the grid f32 kron
    backend: matches the single-device shifted f32 solve."""
    nc = (4, 4, 4)
    sigma = 37.0
    kwargs = dict(degrees=(1, 3), kappa=2.0, coarse="fdm",
                  dtype=jnp.float32, sigma=sigma)
    single = PoissonProblem(nc=nc, operator="kron", **kwargs)
    u_s, rn_s = single.solve(num_cycles=5)
    grid = GridPMG(single.mesh, shards=(2, 2, 2), operator="kron",
                   **kwargs)
    b = assemble_rhs(single.mesh, 3, f_rhs(2.0, sigma=sigma))
    u_d, rn_d = grid.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=5e-4), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-5)


def test_grid_kron_refined_solve():
    """Mixed-precision refinement: f32 kron working cycle + f64 kron
    residual on the (2,2,2) grid."""
    nc = (4, 4, 4)
    grid = GridPMG(BoxMesh(nc), shards=(2, 2, 2), degrees=(1, 3),
                   kappa=2.0, coarse="cg", dtype=jnp.float32,
                   operator="kron")
    b = assemble_rhs(BoxMesh(nc), 3, f_rhs(2.0))
    _, rn = grid.solve_refined(b, num_cycles=12)
    r0 = np.linalg.norm(b)
    assert rn[-1] / r0 < 1e-6, np.array(rn) / r0


def test_grid_lattice_refined_solve():
    """Mixed-precision refinement through the grid lattice backend."""
    nc = (4, 4, 4)
    kappa = 2.0
    grid = GridPMG(BoxMesh(nc), shards=(2, 2, 2), degrees=(1, 3),
                   kappa=kappa, coarse="cg", dtype=jnp.float32,
                   operator="lattice")
    b = assemble_rhs(BoxMesh(nc), 3, f_rhs(kappa))
    u_d, rn_d = grid.solve_refined(b, num_cycles=12)
    r0 = np.linalg.norm(b)
    assert rn_d[-1] / r0 < 1e-6, np.array(rn_d) / r0


def test_grid_lattice_curved_refined_solve():
    """Refinement with the f32 lattice working cycle + f64 lattice
    residual on CURVED hexes over the (2,2,2) grid."""
    from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh

    nc = (4, 4, 4)
    mesh = PerturbedBoxMesh(nc)
    grid = GridPMG(mesh, shards=(2, 2, 2), degrees=(1, 3),
                   kappa=2.0, coarse="cg", dtype=jnp.float32,
                   operator="lattice")
    b = assemble_rhs(mesh, 3, f_rhs(2.0))
    # Curved cells: the point-Jacobi cycle contracts ~0.35/cycle.
    _, rn = grid.solve_refined(b, num_cycles=30)
    r0 = np.linalg.norm(b)
    assert rn[-1] / r0 < 1e-6, np.array(rn) / r0

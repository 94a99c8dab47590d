"""Graded (non-uniform per-axis spacing) tensor-product meshes:
``BoxMesh(spacing=...)`` — boundary-layer refinement beyond the
reference's uniform `create_box` geometry (examples/pmg/main.cpp:442-451).

The mesh stays a tensor product of 1D meshes, so the whole Kronecker
fast family carries grading natively: the per-axis 1D stiffness/mass
simply assemble on non-uniform spacing (`ops.kron.axis_stiffness_mass`
already takes per-cell widths), the FDM direct solver diagonalizes the
graded pencils exactly, and the per-cell Schwarz blocks read their own
cell size from the global 1D matrices. On a SHARDED graded axis the
local stiffness differs per shard — `ops.kron.local_axis_K` row-stacks
the per-shard blocks (the same spec-P(axis) mechanism Robin ends use).
h-MG coarsens graded meshes by MERGING cells (`coarsen_spacing`; coarse
corners stay a subset of the fine corners) with per-coarse-cell graded
transfer blocks — including the non-gathered (dist=True) hierarchies,
whose sharded graded axes get per-shard ROW-STACKED transfer blocks
(`solvers.hmg.local_axis_h_interpolation`)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pmg_dolfinx_jax.fem.assembly import assemble_stiffness
from pmg_dolfinx_jax.fem.mesh import BoxMesh, geometric_spacing
from pmg_dolfinx_jax.models.poisson import PoissonProblem
from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy


def _graded_mesh(nc=(4, 3, 5), **kw):
    rng = np.random.default_rng(7)
    spacing = (geometric_spacing(nc[0], 6.0), None,
               rng.uniform(0.5, 2.0, nc[2]))
    return BoxMesh(nc, spacing=spacing, **kw)


def test_spacing_normalization_and_nodes():
    mesh = _graded_mesh(extent=(2.0, 1.0, 3.0))
    assert mesh.is_graded
    for a in range(3):
        hc = mesh.h_cells[a]
        assert hc.shape == (mesh.nc[a],)
        assert np.isclose(hc.sum(), mesh.extent[a])
        nodes = mesh.axis_nodes(a)
        assert nodes[0] == 0.0 and nodes[-1] == mesh.extent[a]
        assert np.allclose(np.diff(nodes), hc)
    # graded mesh has no single h
    with pytest.raises(ValueError, match="graded"):
        mesh.h
    # ratio contract of the helper
    s = geometric_spacing(8, 10.0)
    assert np.isclose(s[-1] / s[0], 10.0)
    # a constant spacing array is detected as uniform
    u = BoxMesh((3, 3, 3), spacing=(np.ones(3), None, None))
    assert not u.is_graded and u.h == (1.0 / 3,) * 3
    with pytest.raises(ValueError, match="one width per cell"):
        BoxMesh((3, 3, 3), spacing=(np.ones(4), None, None))
    with pytest.raises(ValueError, match="positive"):
        BoxMesh((3, 3, 3), spacing=(np.array([1.0, -1.0, 1.0]), None, None))


def test_dof_coords_follow_grading():
    mesh = _graded_mesh()
    P = 3
    c = mesh.dof_coords(P).reshape(mesh.lattice_shape(P) + (3,))
    # corner lattice rows sit exactly at the cumulative node positions
    assert np.allclose(c[::P, 0, 0, 0], mesh.axis_nodes(0))
    assert np.allclose(c[0, 0, ::P, 2], mesh.axis_nodes(2))
    # geometry corners match the tensor product of the node arrays
    g = mesh.geometry_x.reshape(tuple(n + 1 for n in mesh.nc) + (3,))
    assert np.allclose(g[:, 0, 0, 0], mesh.axis_nodes(0))
    assert np.allclose(g[0, :, 0, 1], mesh.axis_nodes(1))


@pytest.mark.parametrize("operator", ["kron", "lattice", "dofmap"])
def test_operator_oracle_parity_graded(operator):
    """Every backend's apply == the scipy-assembled matrix on a graded
    mesh (the general backends inherit it from the geometry pipeline;
    the kron path from the non-uniform 1D assembly)."""
    from pmg_dolfinx_jax.ops.kron import KronLaplacian
    from pmg_dolfinx_jax.ops.laplacian import MatFreeLaplacian
    from pmg_dolfinx_jax.ops.lattice import LatticeLaplacian

    mesh = _graded_mesh()
    P, kappa = 3, 2.0
    op = {"kron": KronLaplacian, "lattice": LatticeLaplacian,
          "dofmap": MatFreeLaplacian}[operator](
        mesh, P, kappa=kappa, dtype=jnp.float64)
    A = assemble_stiffness(mesh, P, kappa=kappa)
    u = np.random.default_rng(0).standard_normal(mesh.num_dofs(P))
    y = np.asarray(op(jnp.asarray(u)))
    assert np.allclose(y, A @ u, atol=1e-11), np.abs(y - A @ u).max()


def test_kron_f32_oracle_parity_graded():
    """The f32 working-precision kron apply (the production dtype) on
    graded spacing agrees with the f64 apply to f32 rounding."""
    from pmg_dolfinx_jax.ops.kron import KronLaplacian

    mesh = _graded_mesh((8, 4, 4))
    P, kappa = 3, 2.0
    ref = KronLaplacian(mesh, P, kappa=kappa, dtype=jnp.float64)
    op = KronLaplacian(mesh, P, kappa=kappa, dtype=jnp.float32)
    u = np.random.default_rng(1).standard_normal(mesh.num_dofs(P))
    y = np.asarray(op(jnp.asarray(u, jnp.float32)))
    y_ref = np.asarray(ref(jnp.asarray(u)))
    rel = np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref)
    assert rel < 1e-5, rel


def test_fdm_exact_solve_graded():
    """The fast-diagonalization direct solver stays EXACT on graded
    spacing (per-axis generalized eigenproblems of the graded pencils),
    including mixed faces and Robin ends."""
    import scipy.sparse.linalg as spla

    from pmg_dolfinx_jax.solvers.fdm import FastDiagonalizationSolver

    faces = ((True, True), (True, False), (False, True))
    robin = ((0.0, 0.0), (0.0, 1.5), (0.0, 0.0))
    mesh = _graded_mesh(dirichlet_faces=faces, robin=robin)
    P, kappa = 3, 2.0
    fdm = FastDiagonalizationSolver(mesh, P, kappa=kappa, dtype=jnp.float64)
    A = assemble_stiffness(mesh, P, kappa=kappa)
    b = np.random.default_rng(2).standard_normal(mesh.num_dofs(P))
    b[np.asarray(mesh.boundary_dof_marker(P))] = 0.0
    u = np.asarray(fdm.solve(jnp.asarray(b)))
    u_ref = spla.spsolve(A.tocsc(), b)
    assert np.allclose(u, u_ref, atol=1e-10), np.abs(u - u_ref).max()


def test_manufactured_convergence_graded():
    """p=3 FCG(V) solves on geometrically graded unit cubes: L2 error
    drops at the O(h^4) discretization rate under refinement."""
    errs = []
    for nc in (6, 12):
        mesh = BoxMesh((nc,) * 3, spacing=(geometric_spacing(nc, 4.0),) * 3)
        prob = PoissonProblem(mesh=mesh, degrees=(1, 3), kappa=2.0,
                              dtype=jnp.float64, coarse="fdm")
        u, _ = prob.hierarchy.solve_pcg(prob.b, rtol=1e-10)
        errs.append(prob.error_l2(u))
    order = np.log2(errs[0] / errs[1])
    assert order > 3.5, (errs, order)


@pytest.mark.parametrize("smoother,max_iters", [
    ("cheb", 20), ("schwarz", 9), ("line-z", 18),
])
def test_smoothers_graded(smoother, max_iters):
    """Chebyshev/Schwarz/line smoothers on a graded hierarchy: the
    Schwarz per-cell FDM blocks and the line block inverses are
    assembled from the graded 1D matrices (per-cell sizes exact).
    Grading IS stretched-cell anisotropy — point-Jacobi Chebyshev
    degrades (18 iters measured) while the per-cell Schwarz blocks
    absorb it (8 iters), the same pattern as the curved-hex flagship."""
    mesh = _graded_mesh((6, 6, 6))
    prob = PoissonProblem(mesh=mesh, degrees=(1, 3), kappa=2.0,
                          dtype=jnp.float64, coarse="fdm",
                          smoother=smoother)
    u, niter = prob.hierarchy.solve_pcg(prob.b, rtol=1e-9)
    assert niter <= max_iters, niter
    assert prob.error_l2(u) < 2e-4


def test_h_interpolation_graded_exact():
    """The graded 1D h-transfer reproduces every polynomial up to
    degree P exactly on the merged-cell node sets (the nodal-nesting
    property uniform transfers have by construction)."""
    from pmg_dolfinx_jax.fem.gll import gauss_lobatto
    from pmg_dolfinx_jax.solvers.hmg import axis_h_interpolation

    P, ncc, f = 3, 3, 2
    h_fine = np.random.default_rng(0).uniform(0.3, 2.0, ncc * f)
    I = axis_h_interpolation(ncc, P, factor=f, h_fine=h_fine)

    def nodes(h):
        xg, _ = gauss_lobatto(P + 1)
        offs = np.concatenate(([0.0], np.cumsum(h)))
        out = [offs[0]]
        for c, w in enumerate(h):
            out.extend(offs[c] + xg[1:] * w)
        return np.array(out)

    xc, xf = nodes(h_fine.reshape(ncc, f).sum(1)), nodes(h_fine)
    for deg in range(P + 1):
        assert np.abs(I @ xc**deg - xf**deg).max() < 1e-12, deg


def test_coarsen_cell_field_volume_weighted():
    """DG-0 coarsening on a graded mesh weights children by their
    actual volumes (plain mean would bias toward small cells)."""
    from pmg_dolfinx_jax.solvers.hmg import coarsen_cell_field

    h = (np.array([1.0, 3.0]), np.array([1.0, 1.0]), np.array([1.0, 1.0]))
    # cell order x slowest: the first 4 cells are the x=0 layer
    vals = np.array([10.0] * 4 + [20.0] * 4)
    # x-pairs (10, 20) with volume weights (1, 3) -> 17.5 everywhere
    out = coarsen_cell_field(vals, (2, 2, 2), (1, 2, 2), h_cells=h)
    assert np.allclose(out, 17.5), out
    # uniform h -> plain mean
    out_u = coarsen_cell_field(vals, (2, 2, 2), (1, 2, 2))
    assert np.allclose(out_u, 15.0), out_u


def test_hmg_graded_matches_exact_coarse():
    """coarse='hmg' on a graded kron-family hierarchy: merged-cell
    coarse meshes + graded transfers converge like the EXACT fdm
    coarse (same FCG iteration count, same solution)."""
    mesh = BoxMesh((8, 8, 8), spacing=(geometric_spacing(8, 5.0),) * 3)
    us, iters = [], []
    for coarse in ("hmg", "fdm"):
        prob = PoissonProblem(mesh=mesh, degrees=(1, 3), kappa=2.0,
                              dtype=jnp.float64, coarse=coarse)
        u, niter = prob.hierarchy.solve_pcg(prob.b, rtol=1e-9)
        us.append(np.asarray(u))
        iters.append(int(niter))
    assert iters[0] <= iters[1] + 2, iters
    assert np.allclose(us[0], us[1], atol=1e-8)


def test_hmg_general_graded_curved():
    """The general-family h-MG on a GRADED PerturbedBoxMesh with
    variable kappa: rediscretized graded levels (the warp evaluates at
    the same merged corner positions) match the exact dense coarse."""
    from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_jax.models.poisson import f_rhs_variable, kappa_linear

    mesh = PerturbedBoxMesh((8, 8, 8),
                            spacing=(None, geometric_spacing(8, 4.0), None))
    us, iters = [], []
    for coarse in ("hmg", "direct"):
        prob = PoissonProblem(mesh=mesh, degrees=(1, 3), kappa=kappa_linear,
                              f=f_rhs_variable(), dtype=jnp.float64,
                              coarse=coarse, operator="lattice")
        u, niter = prob.hierarchy.solve_pcg(prob.b, rtol=1e-9)
        us.append(np.asarray(u))
        iters.append(int(niter))
    assert iters[0] <= iters[1] + 2, iters
    assert np.allclose(us[0], us[1], atol=1e-8)


def test_hmg_gathered_sharded_graded_matches_single():
    """The GATHERED hmg coarse on graded sharded layouts (slab + grid)
    rides the single-device graded hierarchy — trajectory-exact."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    mesh = BoxMesh((8, 4, 4), spacing=(geometric_spacing(8, 4.0),
                                       None, None))
    prob = PoissonProblem(mesh=mesh, degrees=(1, 3), kappa=2.0,
                          dtype=jnp.float64, coarse="hmg")
    u_s, rn_s = prob.solve(num_cycles=6)
    dist = DistPMG(mesh, n_devices=4, degrees=(1, 3), kappa=2.0,
                   dtype=jnp.float64, coarse="hmg")
    u_d, rn_d = dist.solve(np.asarray(prob.b), num_cycles=6)
    assert np.allclose(rn_d, rn_s, rtol=1e-9)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-10)
    grid = GridPMG(mesh, shards=(2, 2), degrees=(1, 3), kappa=2.0,
                   dtype=jnp.float64, coarse="hmg")
    u_g, rn_g = grid.solve(np.asarray(prob.b), num_cycles=6)
    assert np.allclose(rn_g, rn_s, rtol=1e-9)
    assert np.allclose(u_g, np.asarray(u_s), atol=1e-10)


def test_hmg_dist_slab_graded_matches_single():
    """The NON-GATHERED (dist=True) h-hierarchy on a graded slab: the
    sharded graded x axis gets per-shard row-stacked TRANSFER blocks
    (local_axis_h_interpolation) alongside the stacked stiffness —
    trajectory-exact vs the single-device graded hmg."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG

    mesh = BoxMesh((16, 4, 4), spacing=(geometric_spacing(16, 5.0), None,
                                        geometric_spacing(4, 2.0)))
    prob = PoissonProblem(mesh=mesh, degrees=(1, 3), kappa=2.0,
                          dtype=jnp.float64, coarse="hmg")
    u_s, rn_s = prob.solve(num_cycles=6)
    dist = DistPMG(mesh, n_devices=4, degrees=(1, 3), kappa=2.0,
                   dtype=jnp.float64, coarse="hmg",
                   coarse_cfg=dict(dist=True))
    u_d, rn_d = dist.solve(np.asarray(prob.b), num_cycles=6)
    assert np.allclose(rn_d, rn_s, rtol=1e-9)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-10)


def test_hmg_dist_grid_graded_gather_free():
    """The fully gather-free graded hierarchy: every axis graded AND
    sharded, dist h-MG levels + distributed-FDM bottom (graded pencils)
    — no gather anywhere, trajectory-exact vs single device."""
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    mesh = BoxMesh((8, 8, 8), spacing=(geometric_spacing(8, 4.0),) * 3)
    prob = PoissonProblem(mesh=mesh, degrees=(1, 3), kappa=2.0,
                          dtype=jnp.float64, coarse="hmg")
    u_s, rn_s = prob.solve(num_cycles=6)
    grid = GridPMG(mesh, shards=(2, 2, 2), degrees=(1, 3), kappa=2.0,
                   dtype=jnp.float64, coarse="hmg",
                   coarse_cfg=dict(dist=True, bottom="fdm"))
    u_g, rn_g = grid.solve(np.asarray(prob.b), num_cycles=6)
    assert np.allclose(rn_g, rn_s, rtol=1e-9)
    assert np.allclose(u_g, np.asarray(u_s), atol=1e-10)


def test_hmg_dist_general_graded_curved():
    """General-family dist h-MG on a GRADED curved mesh with variable
    kappa: rediscretized graded lattice h-levels in the multi-axis
    layout — trajectory-exact vs single device."""
    from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_jax.models.poisson import f_rhs_variable, kappa_linear
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    mesh = PerturbedBoxMesh((8, 8, 8),
                            spacing=(None, geometric_spacing(8, 4.0), None))
    prob = PoissonProblem(mesh=mesh, degrees=(1, 3), kappa=kappa_linear,
                          f=f_rhs_variable(), dtype=jnp.float64,
                          coarse="hmg", operator="lattice")
    u_s, rn_s = prob.solve(num_cycles=6)
    grid = GridPMG(mesh, shards=(2, 2), degrees=(1, 3), kappa=kappa_linear,
                   dtype=jnp.float64, coarse="hmg",
                   coarse_cfg=dict(dist=True), operator="lattice")
    u_g, rn_g = grid.solve(np.asarray(prob.b), num_cycles=6)
    assert np.allclose(rn_g, rn_s, rtol=1e-9)
    assert np.allclose(u_g, np.asarray(u_s), atol=1e-10)


def test_dist_slab_graded_matches_single():
    """x-slab decomposition of a graded-x mesh: each shard's local axis
    stiffness differs (row-stacked spec-P(axis) blocks) — trajectories
    must still match the single-device solve exactly."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG

    mesh = BoxMesh((8, 4, 5), spacing=(geometric_spacing(8, 5.0), None,
                                       geometric_spacing(5, 3.0)))
    prob = PoissonProblem(mesh=mesh, degrees=(1, 3), kappa=2.0,
                          dtype=jnp.float64, coarse="fdm")
    u_s, rn_s = prob.solve(num_cycles=6)
    dist = DistPMG(mesh, n_devices=4, degrees=(1, 3), kappa=2.0,
                   dtype=jnp.float64, coarse="fdm")
    u_d, rn_d = dist.solve(np.asarray(prob.b), num_cycles=6)
    assert np.allclose(rn_d, rn_s, rtol=1e-9), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-10)


def test_dist_fdm_graded_matches_single():
    """Distributed FDM (pencil all_to_all transposes) on a graded mesh:
    the boundary-embedded transform matrices diagonalize the graded
    per-axis pencils — value-exact vs the single-device direct solve."""
    from pmg_dolfinx_jax.parallel.fdm_dist import DistFDM
    from pmg_dolfinx_jax.solvers.fdm import FastDiagonalizationSolver

    mesh = BoxMesh((4, 4, 4),
                   spacing=tuple(geometric_spacing(4, 3.0) for _ in range(3)))
    P = 3
    single = FastDiagonalizationSolver(mesh, P, kappa=2.0, dtype=jnp.float64)
    dist = DistFDM(mesh, P, (2, 2), kappa=2.0, dtype=jnp.float64)
    b = np.random.default_rng(3).standard_normal(mesh.num_dofs(P))
    b[np.asarray(mesh.boundary_dof_marker(P))] = 0.0
    u_s = np.asarray(single.solve(jnp.asarray(b)))
    u_d = np.asarray(dist.solve(b))
    assert np.allclose(u_d, u_s, atol=1e-12), np.abs(u_d - u_s).max()


def test_packed_kron_graded_matches_base():
    """A batch of graded-mesh kron applies as ONE vmapped program (the
    serving layout of `solve_many` / `batch_evolve`) matches the
    per-column applies."""
    import jax

    from pmg_dolfinx_jax.ops.kron import KronLaplacian

    mesh = BoxMesh((4, 4, 4),
                   spacing=(geometric_spacing(4, 4.0), None, None))
    P, B = 3, 3
    base = KronLaplacian(mesh, P, kappa=2.0, dtype=jnp.float32)
    U = np.random.default_rng(4).standard_normal(
        (B, mesh.num_dofs(P))).astype(np.float32)
    Y = np.asarray(jax.jit(jax.vmap(base))(jnp.asarray(U)))
    for k in range(B):
        y_ref = np.asarray(base(jnp.asarray(U[k])))
        rel = np.linalg.norm(Y[k] - y_ref) / np.linalg.norm(y_ref)
        assert rel < 1e-5, (k, rel)


@pytest.mark.parametrize("shards,operator", [
    ((2, 2), "kron"),
    ((2, 2, 2), "kron"),
    ((2, 2), "lattice"),
])
def test_grid_graded_matches_single(shards, operator):
    """2D/3D grid decompositions on graded meshes (every sharded axis
    graded): trajectory-exact vs single device, kron AND the general
    lattice backend."""
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    nc = (4, 4, 4)
    mesh = BoxMesh(nc, spacing=tuple(geometric_spacing(n, 4.0) for n in nc))
    prob = PoissonProblem(mesh=mesh, degrees=(1, 3), kappa=2.0,
                          dtype=jnp.float64, coarse="fdm",
                          operator=operator)
    u_s, rn_s = prob.solve(num_cycles=5)
    grid = GridPMG(mesh, shards=shards, degrees=(1, 3), kappa=2.0,
                   dtype=jnp.float64, coarse="fdm", operator=operator)
    u_d, rn_d = grid.solve(np.asarray(prob.b), num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-9), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-10)

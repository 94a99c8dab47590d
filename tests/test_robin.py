"""Robin boundary conditions: kappa du/dn + alpha u = g on flagged faces.

Beyond-reference model-family coverage (the reference supports only the
all-Dirichlet box, examples/pmg/main.cpp:173-185). The weak form adds the
boundary mass ``integral_Gamma alpha u v ds`` — diagonal under GLL surface
collocation (fem.assembly.robin_mass_np) — and the surface data term
``integral_Gamma g v ds`` (robin_rhs_np). On the axis-aligned box the
boundary mass factors EXACTLY per axis (``alpha e_end e_end^T (x) M (x)
M``), so the whole Kronecker family — kron applies, the FDM
direct solver, the kron h-MG — carries Robin as scalar 1D stiffness
end-point updates; the general backends bake it into the pointwise m3
shift like a sigma field.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import jax
import jax.numpy as jnp

from pmg_dolfinx_jax.fem.assembly import (
    assemble_rhs,
    assemble_stiffness,
    l2_error,
    robin_mass_np,
    robin_rhs_np,
    shifted_mass_np,
)
from pmg_dolfinx_jax.fem.mesh import BoxMesh, PerturbedBoxMesh
from pmg_dolfinx_jax.models.poisson import (
    PoissonProblem,
    f_rhs_mixed,
    grad_u_exact_mixed,
    robin_data,
    u_exact_mixed,
)
from pmg_dolfinx_jax.ops.kron import KronLaplacian, axis_stiffness_mass
from pmg_dolfinx_jax.solvers.fdm import FastDiagonalizationSolver
from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

DF = ((True, False), (False, False), (True, True))
ROBIN = ((0.0, 2.5), (1.7, 0.3), (0.0, 0.0))


def _mesh(cls=BoxMesh, nc=(3, 4, 2), **kw):
    return cls(nc, extent=(1.0, 1.3, 0.8), dirichlet_faces=DF,
               robin=ROBIN, **kw)


def test_mesh_validation():
    with pytest.raises(ValueError, match="Dirichlet AND Robin"):
        BoxMesh((2, 2, 2), robin=((1.0, 0.0),) * 3)  # all-Dirichlet mesh
    with pytest.raises(ValueError, match=">= 0"):
        BoxMesh((2, 2, 2), dirichlet_faces=((False, True),) * 3,
                robin=((-1.0, 0.0),) * 3)
    with pytest.raises(ValueError, match="3x2"):
        BoxMesh((2, 2, 2), dirichlet_faces=DF, robin=(1.0, 2.0))
    assert _mesh().has_robin
    assert not BoxMesh((2, 2, 2)).has_robin


def test_robin_mass_box_equals_kron_end_form():
    """On the box, the GLL surface mass equals the per-axis Kronecker
    end-point form alpha e_end e_end^T (x) M (x) M exactly."""
    mesh = _mesh()
    P = 3
    b = robin_mass_np(mesh, P)
    ms = [axis_stiffness_mass(nc_a, P, h_a)[1]
          for nc_a, h_a in zip(mesh.nc, mesh.h)]
    ref = np.zeros(mesh.lattice_shape(P))
    for a in range(3):
        oth = [d for d in range(3) if d != a]
        w2 = np.multiply.outer(ms[oth[0]], ms[oth[1]])
        for s, idx in ((0, 0), (1, -1)):
            alpha = mesh.robin_alpha[a, s]
            if alpha:
                sl = [slice(None)] * 3
                sl[a] = idx
                ref[tuple(sl)] += alpha * w2
    ref = ref.ravel()
    ref[mesh.boundary_dof_marker(P)] = 0.0
    np.testing.assert_allclose(b, ref, rtol=0, atol=1e-14)


def test_robin_mass_curved_face_area():
    """On a mesh whose warp moves the Robin faces, the per-face weight
    total approximates alpha * (true curved face area): compare the
    x-high face against a fine numerical surface integral."""

    def warp(x):
        # Displaces the x=1 face outward in a smooth bump (non-flat face).
        b = 0.06 * np.sin(np.pi * x[1]) * np.sin(np.pi * x[2]) * x[0]
        return np.stack([b, np.zeros_like(b), np.zeros_like(b)])

    df = ((True, False), (True, True), (True, True))
    robin = ((0.0, 3.0), (0.0, 0.0), (0.0, 0.0))
    mesh = PerturbedBoxMesh((6, 6, 6), warp=warp, dirichlet_faces=df,
                            robin=robin)
    b = robin_mass_np(mesh, 2, bc_zero=False)
    # Surface x = 1 + 0.06 sin(pi y) sin(pi z): area = int sqrt(1+|gf|^2)
    yy, zz = np.meshgrid(*(np.linspace(0, 1, 801),) * 2, indexing="ij")
    gy = 0.06 * np.pi * np.cos(np.pi * yy) * np.sin(np.pi * zz)
    gz = 0.06 * np.pi * np.sin(np.pi * yy) * np.cos(np.pi * zz)
    area = np.trapezoid(
        np.trapezoid(np.sqrt(1 + gy**2 + gz**2), dx=1 / 800), dx=1 / 800)
    total = b.sum()
    # Q1-facet geometry at 6^2 face cells: ~1% discretization error.
    assert abs(total - 3.0 * area) < 0.02 * 3.0 * area


@pytest.mark.parametrize("kappa", [2.0, (2.0, 0.5, 3.0)])
def test_kron_apply_matches_oracle(kappa):
    mesh = _mesh()
    P = 3
    A = assemble_stiffness(mesh, P, kappa=kappa)
    op = KronLaplacian(mesh, P, kappa=kappa, dtype=jnp.float64)
    x = np.random.default_rng(0).standard_normal(mesh.num_dofs(P))
    np.testing.assert_allclose(np.asarray(op(jnp.asarray(x))), A @ x,
                               rtol=0, atol=1e-11)


def test_general_oracle_includes_robin_diag():
    """assemble_stiffness on a curved Robin mesh == curved no-Robin
    operator + diag(robin_mass) — the identity the baked general-backend
    path relies on."""
    mesh = _mesh(PerturbedBoxMesh)
    mesh0 = PerturbedBoxMesh((3, 4, 2), extent=(1.0, 1.3, 0.8),
                             dirichlet_faces=DF)
    P = 2
    A = assemble_stiffness(mesh, P, kappa=1.5)
    A0 = assemble_stiffness(mesh0, P, kappa=1.5)
    d = sp.diags(robin_mass_np(mesh, P))
    assert abs(A - (A0 + d)).max() < 1e-13


def test_fdm_direct_solve_exact():
    """The FDM direct solver stays EXACT with Robin end updates (and a
    sigma shift, and per-axis kappa)."""
    mesh = _mesh(nc=(4, 3, 5))
    P = 4
    kappa, sigma = (2.0, 0.5, 3.0), 0.7
    A = assemble_stiffness(mesh, P, kappa=kappa)
    A = A + sp.diags(sigma * shifted_mass_np(mesh, P, bc_zero=True))
    rng = np.random.default_rng(1)
    b = rng.standard_normal(mesh.num_dofs(P))
    b[mesh.boundary_dof_marker(P)] = 0.0
    fdm = FastDiagonalizationSolver(mesh, P, kappa=kappa,
                                    dtype=jnp.float64, sigma=sigma)
    u = np.asarray(fdm.solve(jnp.asarray(b)))
    assert np.abs(A @ u - b).max() < 1e-12 * np.abs(b).max()


@pytest.mark.parametrize("operator", ["kron", "lattice", "dofmap"])
def test_hierarchy_operator_matches_oracle(operator):
    mesh = _mesh()
    A = assemble_stiffness(mesh, 3, kappa=2.0)
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=2.0,
                        dtype=jnp.float64, coarse="smoother",
                        operator=operator)
    x = np.random.default_rng(2).standard_normal(mesh.num_dofs(3))
    y = np.asarray(hier.operator()(jnp.asarray(x)))
    np.testing.assert_allclose(y, A @ x, rtol=0, atol=1e-11)


def test_hierarchy_operator_matches_oracle_curved_sigma():
    """Curved mesh + Robin + scalar sigma through the baked m3 path."""
    mesh = _mesh(PerturbedBoxMesh)
    sigma = 0.9
    A = assemble_stiffness(mesh, 3, kappa=1.5)
    A = A + sp.diags(sigma * shifted_mass_np(mesh, 3, bc_zero=True))
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=1.5, sigma=sigma,
                        dtype=jnp.float64, coarse="smoother",
                        operator="lattice")
    x = np.random.default_rng(3).standard_normal(mesh.num_dofs(3))
    y = np.asarray(hier.operator()(jnp.asarray(x)))
    np.testing.assert_allclose(y, A @ x, rtol=0, atol=1e-11)


def _robin_problem(mesh_cls=BoxMesh, nc=(4, 4, 4), degrees=(1, 3),
                   kappa=2.0, coarse="direct", operator="kron", **kw):
    """Manufactured mixed-BC solution with Robin data computed from it:
    put Robin on the x-high and both y faces (the non-Dirichlet ones)."""
    mesh = mesh_cls(nc, dirichlet_faces=DF, robin=ROBIN)
    u = u_exact_mixed(DF)
    g = robin_data(kappa, u, grad_u_exact_mixed(DF), ROBIN)
    return PoissonProblem(
        degrees=degrees, kappa=kappa, mesh=mesh, coarse=coarse,
        operator=operator, f=f_rhs_mixed(
            kappa if np.ndim(kappa) == 0 else 1.0, DF),
        u_exact=u, robin_g=g, **kw)


def test_solve_matches_scipy():
    """PMG stationary solve on the Robin problem converges to the scipy
    sparse direct solution of the same discrete system."""
    prob = _robin_problem()
    mesh, P = prob.mesh, prob.degrees[-1]
    A = assemble_stiffness(mesh, P, kappa=2.0)
    b = np.asarray(prob.b)
    u_ref = spla.spsolve(A.tocsc(), b)
    u, res = prob.solve(num_cycles=30)
    assert res[-1] < 1e-8 * res[0]
    np.testing.assert_allclose(np.asarray(u), u_ref, rtol=0, atol=1e-8)


@pytest.mark.parametrize("coarse", ["fdm", "hmg"])
def test_solve_coarse_modes(coarse):
    """Robin rides the FDM coarse (exact 1D end updates) and the kron
    h-MG coarse (end updates rediscretized per h-level)."""
    prob = _robin_problem(nc=(4, 4, 4), coarse=coarse)
    u, res = prob.solve(num_cycles=30)
    assert res[-1] < 1e-8 * res[0]
    err = prob.error_l2(np.asarray(u))
    assert err < 2e-4


def test_solve_hmg_general_curved():
    """Curved-hex Robin problem with the rediscretized general h-MG
    coarse: converges, and matches the direct-coarse trajectory class
    (same discrete system — compare final solutions)."""
    mesh = PerturbedBoxMesh((4, 4, 4), dirichlet_faces=DF, robin=ROBIN)
    u = u_exact_mixed(DF)
    g = robin_data(1.5, u, grad_u_exact_mixed(DF), ROBIN)
    kw = dict(degrees=(1, 3), kappa=1.5, mesh=mesh, operator="lattice",
              f=f_rhs_mixed(1.5, DF), u_exact=u, robin_g=g)
    p1 = PoissonProblem(coarse="hmg", **kw)
    p2 = PoissonProblem(coarse="direct", **kw)
    u1, r1 = p1.hierarchy.solve_pcg(p1.b, rtol=1e-10, maxiter=40)
    u2, r2 = p2.hierarchy.solve_pcg(p2.b, rtol=1e-10, maxiter=40)
    np.testing.assert_allclose(np.asarray(u1), np.asarray(u2),
                               rtol=0, atol=1e-7)


def test_manufactured_convergence():
    """L2 error of the Robin problem decreases at the expected high-order
    rate under h-refinement (O(h^{P+1}) for P=3 -> factor ~16)."""
    errs = []
    for nc in (3, 6):
        prob = _robin_problem(nc=(nc, nc, nc), coarse="fdm")
        u, _ = prob.solve(num_cycles=25)
        errs.append(l2_error(prob.mesh, 3, np.asarray(u),
                             u_exact_mixed(DF)))
    rate = np.log2(errs[0] / errs[1])
    assert rate > 3.5, (errs, rate)


def test_refined_solve_robin():
    """Mixed-precision refined solve reaches f64 accuracy on the Robin
    system (the f64 residual operator carries the Robin term on both the
    kron and the baked-lattice paths)."""
    for operator in ("kron", "lattice"):
        prob = _robin_problem(nc=(3, 3, 3), coarse="direct",
                              operator=operator)
        u, rnorms = prob.hierarchy.solve_refined(prob.b, num_cycles=30,
                                                 rtol=1e-12)
        assert rnorms[-1] < 1e-9 * rnorms[0], (operator, rnorms)


# ---------------- distributed (x-slab) layout ----------------
#
# The sharded x axis carries a Robin face at its global high end
# (ROBIN[0] = (0.0, 2.5)), so these exercise the per-shard ROW-STACKED
# local stiffness (ops.kron.stacked_local_K — only the end shards
# differ); y carries Robin at both ends through the global-matrix fold.


@pytest.mark.parametrize("operator,kappa", [
    ("kron", 2.0),
    ("kron", (2.0, 0.5, 3.0)),
    ("lattice", 2.0),
])
def test_dist_operator_matches_oracle(operator, kappa):
    from pmg_dolfinx_jax.parallel.dist import DistPMG

    mesh = BoxMesh((8, 4, 4), dirichlet_faces=DF, robin=ROBIN)
    A = assemble_stiffness(mesh, 3, kappa=kappa)
    dist = DistPMG(mesh, n_devices=4, degrees=(1, 3), kappa=kappa,
                   dtype=jnp.float64, operator=operator)
    x = np.random.default_rng(6).standard_normal(mesh.num_dofs(3))
    yd = dist.from_dist(dist.operator()(dist.to_dist(x)))
    np.testing.assert_allclose(yd, A @ x, rtol=0, atol=1e-11)


@pytest.mark.parametrize("operator,coarse,sigma", [
    ("kron", "cg", 0.0),
    ("kron", "fdm", 0.0),
    ("kron", "hmg", 0.0),
    ("lattice", "direct", 0.7),
])
def test_dist_solve_matches_single(operator, coarse, sigma):
    """Sharded Robin trajectories == single-device (all coarse modes are
    rebuilt from the Robin-flagged mesh; lattice bakes sigma*mass +
    boundary mass into one m3)."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG

    prob = _robin_problem(nc=(8, 4, 4), coarse=coarse, operator=operator,
                          sigma=sigma)
    u_s, rn_s = prob.solve(num_cycles=8)
    dist = DistPMG(prob.mesh, n_devices=4, degrees=(1, 3), kappa=2.0,
                   coarse=coarse, operator=operator, sigma=sigma)
    u_d, rn_d = dist.solve(np.asarray(prob.b), num_cycles=8)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


def test_dist_kron_f32_robin_matches_single():
    """The f32 sharded kron backend carries the Robin end updates
    through the per-shard stacked Kx factor."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG

    prob = _robin_problem(nc=(8, 4, 4), coarse="cg",
                          operator="kron", dtype=jnp.float32)
    u_s, rn_s = prob.solve(num_cycles=5)
    dist = DistPMG(prob.mesh, n_devices=4, degrees=(1, 3), kappa=2.0,
                   coarse="cg", operator="kron",
                   dtype=jnp.float32)
    u_d, rn_d = dist.solve(np.asarray(prob.b), num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-4), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-5)


@pytest.mark.parametrize("operator", ["kron", "lattice"])
def test_dist_refined_robin_matches_single(operator):
    """Sharded mixed-precision refinement on the Robin system: the f64
    residual operator carries the Robin term (stacked Kx on the kron
    path, baked m3 on the lattice path)."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG

    # The all-Robin y axis contracts slower (~0.55/cycle) than the
    # all-Dirichlet problems — identical single vs sharded either way.
    prob = _robin_problem(nc=(8, 8, 8), coarse="cg", operator=operator,
                          dtype=jnp.float32)
    u_s, rn_s = prob.hierarchy.solve_refined(prob.b, num_cycles=25)
    dist = DistPMG(prob.mesh, n_devices=8, degrees=(1, 3), kappa=2.0,
                   coarse="cg", operator=operator, dtype=jnp.float32)
    b = np.asarray(prob.b)
    u_d, rn_d = dist.solve_refined(b, num_cycles=25)
    r0 = np.linalg.norm(b)
    assert rn_d[-1] / r0 < 1e-6, np.array(rn_d) / r0
    assert np.allclose(rn_d, rn_s, rtol=1e-3), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-6)


def test_distfdm_robin_matches_single_fdm():
    """The gather-free distributed FDM (pencil all_to_all transposes)
    carries the Robin end updates in its embedded per-axis transforms —
    value-exact vs the single-device exact solver."""
    from pmg_dolfinx_jax.parallel.fdm_dist import DistFDM

    mesh = BoxMesh((8, 4, 4), dirichlet_faces=DF, robin=ROBIN)
    P4, kappa = 4, (2.0, 0.5, 3.0)
    single = FastDiagonalizationSolver(mesh, P4, kappa=kappa,
                                       dtype=jnp.float64, sigma=0.3)
    dist = DistFDM(mesh, P4, 4, kappa=kappa, dtype=jnp.float64, sigma=0.3)
    rng = np.random.default_rng(7)
    b = rng.standard_normal(mesh.num_dofs(P4))
    b[mesh.boundary_dof_marker(P4)] = 0.0
    u_s = np.asarray(single.solve(jnp.asarray(b)))
    u_d = dist.solve(b)
    np.testing.assert_allclose(u_d, u_s, rtol=0, atol=1e-12)


@pytest.mark.parametrize("cfg", [dict(dist=True),
                                 dict(dist=True, bottom="fdm")])
def test_dist_hmg_distributed_robin_matches_single(cfg):
    """Non-gathered h-MG coarse with Robin: every h-level carries the
    rediscretized end updates (stacked per-shard x blocks), the 'fdm'
    bottom makes the whole hierarchy gather-free — trajectory-exact vs
    the single-device gathered hmg."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG

    prob = _robin_problem(nc=(8, 4, 4), coarse="hmg", operator="kron")
    u_s, rn_s = prob.solve(num_cycles=6)
    dist = DistPMG(prob.mesh, n_devices=4, degrees=(1, 3), kappa=2.0,
                   coarse="hmg", coarse_cfg=cfg, operator="kron")
    u_d, rn_d = dist.solve(np.asarray(prob.b), num_cycles=6)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


def test_dist_fdm_dist_coarse_robin_matches_single():
    """coarse='fdm' with coarse_cfg dist=True (pencil-transposed exact
    coarse solve, no gather) on the Robin mesh == single-device fdm
    coarse trajectories."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG

    prob = _robin_problem(nc=(8, 4, 4), coarse="fdm", operator="kron")
    u_s, rn_s = prob.solve(num_cycles=6)
    dist = DistPMG(prob.mesh, n_devices=4, degrees=(1, 3), kappa=2.0,
                   coarse="fdm", coarse_cfg=dict(dist=True),
                   operator="kron")
    u_d, rn_d = dist.solve(np.asarray(prob.b), num_cycles=6)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


# ---------------- 2D/3D grid decompositions ----------------
#
# Robin faces on SHARDED axes: x-high (last x-shard differs) and BOTH
# y ends (first and last y-shard differ) — the per-shard row-stacked
# local stiffness on every decomposed axis.


@pytest.mark.parametrize("operator,kappa", [
    ("kron", 2.0),
    ("kron", (2.0, 0.5, 3.0)),
    ("lattice", 2.0),
    ("dofmap", 2.0),
])
def test_grid_operator_matches_oracle(operator, kappa):
    from jax.sharding import PartitionSpec as P

    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    mesh = BoxMesh((4, 4, 4), dirichlet_faces=DF, robin=ROBIN)
    A = assemble_stiffness(mesh, 3, kappa=kappa)
    grid = GridPMG(mesh, shards=(2, 2, 2), degrees=(1, 3), kappa=kappa,
                   dtype=jnp.float64, operator=operator)
    x = np.random.default_rng(8).standard_normal(mesh.num_dofs(3))
    lvf = grid.data["levels"][-1]
    yd = jax.jit(
        jax.shard_map(
            lambda lv, v: grid._ops["apply"](lv, v, grid.levels[-1]),
            mesh=grid.jmesh,
            in_specs=(grid.data_specs["levels"][-1], P("x", "y", "z")),
            out_specs=P("x", "y", "z"),
        )
    )(lvf, grid.to_dist(x))
    np.testing.assert_allclose(grid.from_dist(yd), A @ x,
                               rtol=0, atol=1e-11)


@pytest.mark.parametrize("shards,operator,coarse,sigma", [
    ((2, 2, 2), "kron", "fdm", 0.0),
    ((2, 4), "kron", "hmg", 0.0),
    ((2, 2), "lattice", "direct", 0.7),
])
def test_grid_solve_matches_single(shards, operator, coarse, sigma):
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    prob = _robin_problem(nc=(4, 4, 4), coarse=coarse, operator=operator,
                          sigma=sigma)
    u_s, rn_s = prob.solve(num_cycles=8)
    grid = GridPMG(prob.mesh, shards=shards, degrees=(1, 3), kappa=2.0,
                   coarse=coarse, operator=operator, sigma=sigma)
    u_d, rn_d = grid.solve(np.asarray(prob.b), num_cycles=8)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


def test_grid_kron_f32_robin_matches_single():
    """The grid-decomposed f32 kron backend: per-shard stacked K factors
    carry the Robin ends on every sharded axis."""
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    prob = _robin_problem(nc=(4, 4, 4), coarse="cg",
                          operator="kron", dtype=jnp.float32)
    u_s, rn_s = prob.solve(num_cycles=5)
    grid = GridPMG(prob.mesh, shards=(2, 2, 2), degrees=(1, 3), kappa=2.0,
                   coarse="cg", operator="kron", dtype=jnp.float32)
    u_d, rn_d = grid.solve(np.asarray(prob.b), num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-4), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-5)


@pytest.mark.parametrize("cfg", [dict(dist=True),
                                 dict(dist=True, bottom="fdm")])
def test_grid_hmg_distributed_robin_matches_single(cfg):
    """Non-gathered grid h-MG with Robin: rediscretized end updates at
    every h-level in the multi-axis layout; bottom='fdm' keeps the whole
    hierarchy gather-free."""
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    prob = _robin_problem(nc=(4, 4, 4), coarse="hmg", operator="kron")
    u_s, rn_s = prob.solve(num_cycles=6)
    grid = GridPMG(prob.mesh, shards=(2, 2), degrees=(1, 3), kappa=2.0,
                   coarse="hmg", coarse_cfg=cfg, operator="kron")
    u_d, rn_d = grid.solve(np.asarray(prob.b), num_cycles=6)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


def test_grid_hmg_general_dist_robin_curved():
    """General-family (curved hexes) distributed grid h-MG with Robin:
    the rediscretized lattice h-levels bake the boundary mass into m3 on
    every level — trajectory-exact vs the single-device gathered
    build_hmg_general."""
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    mesh = PerturbedBoxMesh((4, 4, 4), dirichlet_faces=DF, robin=ROBIN)
    u = u_exact_mixed(DF)
    g = robin_data(1.5, u, grad_u_exact_mixed(DF), ROBIN)
    prob = PoissonProblem(degrees=(1, 3), kappa=1.5, mesh=mesh,
                          coarse="hmg", operator="lattice",
                          f=f_rhs_mixed(1.5, DF), u_exact=u, robin_g=g,
                          sigma=0.4)
    u_s, rn_s = prob.solve(num_cycles=6)
    grid = GridPMG(mesh, shards=(2, 2), degrees=(1, 3), kappa=1.5,
                   coarse="hmg", coarse_cfg=dict(dist=True),
                   operator="lattice", sigma=0.4)
    u_d, rn_d = grid.solve(np.asarray(prob.b), num_cycles=6)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


def test_grid_refined_robin_matches_single():
    """Grid-sharded mixed-precision refinement on the Robin system."""
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    prob = _robin_problem(nc=(4, 4, 4), coarse="fdm", operator="kron",
                          dtype=jnp.float32)
    u_s, rn_s = prob.hierarchy.solve_refined(prob.b, num_cycles=10)
    grid = GridPMG(prob.mesh, shards=(2, 2, 2), degrees=(1, 3), kappa=2.0,
                   coarse="fdm", operator="kron", dtype=jnp.float32)
    b = np.asarray(prob.b)
    u_d, rn_d = grid.solve_refined(b, num_cycles=10)
    assert np.allclose(rn_d, rn_s, rtol=1e-3), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-6)


# ---------------- line / Schwarz smoothers with Robin ----------------


def test_schwarz_blocks_exact_with_robin():
    """The per-cell Schwarz FDM blocks fold the Robin end updates:
    M(r) == multiplicity-weighted exact per-cell block solves of the
    Robin-assembled matrix (kron form, per-axis kappa)."""
    from pmg_dolfinx_jax.solvers.schwarz import (
        build_schwarz,
        schwarz_precond_apply,
    )

    mesh = _mesh(nc=(3, 4, 5))
    P, kappa = 2, (2.0, 0.5, 3.0)
    A = assemble_stiffness(mesh, P, kappa=kappa).tocsr()
    dofmap = np.asarray(mesh.dofmap(P))
    N = mesh.num_dofs(P)
    mult = np.zeros(N)
    np.add.at(mult, dofmap.ravel(), 1.0)
    w = 1.0 / np.sqrt(mult)
    r = np.random.default_rng(9).standard_normal(N)
    want = np.zeros(N)
    rw = r * w
    for c in range(dofmap.shape[0]):
        d = dofmap[c]
        want[d] += np.linalg.solve(A[np.ix_(d, d)].toarray(), rw[d])
    want *= w
    bc = np.asarray(mesh.boundary_dof_marker(P), bool)
    want[bc] = r[bc]
    sw = build_schwarz(mesh, P, kappa, jnp.float64)
    got = np.asarray(schwarz_precond_apply(sw, jnp.asarray(r),
                                           mesh.lattice_shape(P), P))
    assert np.allclose(got, want, atol=1e-13 * np.abs(want).max())


@pytest.mark.parametrize("smoother", ["line-z", "schwarz"])
def test_solve_smoothers_robin(smoother):
    """Line blocks (assembled-matrix restriction) and Schwarz blocks
    (folded end updates) carry Robin: stationary solve converges to the
    scipy solution of the same system."""
    prob = _robin_problem(nc=(4, 4, 4), coarse="direct",
                          smoother=smoother)
    mesh, P = prob.mesh, prob.degrees[-1]
    A = assemble_stiffness(mesh, P, kappa=2.0)
    u_ref = spla.spsolve(A.tocsc(), np.asarray(prob.b))
    u, res = prob.solve(num_cycles=25)
    assert res[-1] < 1e-8 * res[0], res
    np.testing.assert_allclose(np.asarray(u), u_ref, rtol=0, atol=1e-8)


@pytest.mark.parametrize("smoother", ["line-z", "schwarz"])
def test_dist_smoothers_robin_match_single(smoother):
    """Sharded Robin + line/Schwarz smoothers: the re-laid-out global
    blocks are trajectory-exact vs single-device."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG

    prob = _robin_problem(nc=(8, 4, 4), coarse="direct",
                          smoother=smoother)
    u_s, rn_s = prob.solve(num_cycles=6)
    dist = DistPMG(prob.mesh, n_devices=4, degrees=(1, 3), kappa=2.0,
                   coarse="direct", operator="kron", smoother=smoother)
    u_d, rn_d = dist.solve(np.asarray(prob.b), num_cycles=6)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


def test_validation_guards():
    mesh = _mesh()
    # Pure Robin (no Dirichlet anywhere) is non-singular: must build.
    m2 = BoxMesh((2, 2, 2), dirichlet_faces=((False, False),) * 3,
                 robin=((1.0, 1.0),) * 3)
    h = PMGHierarchy(m2, degrees=(1, 2), dtype=jnp.float64,
                     coarse="direct")
    A = assemble_stiffness(m2, 2, kappa=2.0)
    x = np.random.default_rng(4).standard_normal(m2.num_dofs(2))
    np.testing.assert_allclose(np.asarray(h.operator()(jnp.asarray(x))),
                               A @ x, rtol=0, atol=1e-11)

"""General-family h-multigrid coarse solver (r2 VERDICT missing #2).

The reference solves its p=1 coarse problem with hypre BoomerAMG on any
assembled matrix (src/amg.hpp:11-119). The replacement for
meshes where the constant-coefficient kron h-MG refuses — curved
(perturbed) hexes and variable DG-0 kappa — is a rediscretized lattice
h-hierarchy (`solvers.hmg.build_hmg_general`): coarse meshes re-evaluate
the smooth warp (exactly nested corners), geometry factors are recomputed
per level, DG-0 kappa is volume-averaged, transfers are reference-space
nodal h-interpolation.

Quality gate: the hmg coarse must match the EXACT (dense Cholesky)
coarse solve iteration-for-iteration in the FCG outer loop — measured
identical on curved and variable-kappa problems.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla

from pmg_dolfinx_jax.fem.assembly import assemble_rhs, assemble_stiffness
from pmg_dolfinx_jax.fem.mesh import BoxMesh, PerturbedBoxMesh
from pmg_dolfinx_jax.models.poisson import (
    f_rhs,
    f_rhs_tensor,
    f_rhs_variable,
    kappa_linear,
)
from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy


def test_coarsen_cell_field():
    from pmg_dolfinx_jax.solvers.hmg import coarsen_cell_field

    nc_f, nc_c = (4, 4, 2), (2, 2, 1)
    vals = np.arange(np.prod(nc_f), dtype=float)
    out = coarsen_cell_field(vals, nc_f, nc_c)
    assert out.shape == (np.prod(nc_c),)
    v = vals.reshape(nc_f)
    assert np.isclose(out[0], v[:2, :2, :2].mean())
    assert np.isclose(out[-1], v[2:, 2:, :].mean())


def test_curved_hmg_matches_direct_coarse():
    """Curved hexes: hmg coarse == exact dense coarse, same FCG count."""
    mesh = PerturbedBoxMesh((4, 4, 4))
    b = assemble_rhs(mesh, 3, f_rhs(2.0))
    iters = {}
    for coarse in ("direct", "hmg"):
        h = PMGHierarchy(mesh, degrees=(1, 3), kappa=2.0, coarse=coarse,
                         operator="lattice")
        u, niter = h.solve_pcg(jnp.asarray(b), rtol=1e-10, maxiter=60)
        iters[coarse] = niter
    A = assemble_stiffness(mesh, 3, kappa=2.0)
    u_ref = spla.spsolve(A.tocsc(), b)
    assert np.allclose(np.asarray(u), u_ref, atol=1e-7)
    assert iters["hmg"] <= iters["direct"] + 1, iters


def test_variable_kappa_hmg_matches_direct_coarse():
    """Variable DG-0 kappa on a box: hmg coarse == exact coarse.

    Isotropic cells (extent matches nc): factor-2 isotropic h-coarsening
    on ANISOTROPIC cells legitimately costs a few extra outer iterations
    (measured 14 vs 11 on (8,4,4)@unit-cube); semicoarsening is the
    standard fix and out of scope here."""
    mesh = BoxMesh((8, 4, 4), extent=(2.0, 1.0, 1.0))
    b = assemble_rhs(mesh, 3, f_rhs_variable())
    iters = {}
    for coarse in ("direct", "hmg"):
        h = PMGHierarchy(mesh, degrees=(1, 3), kappa=kappa_linear,
                         coarse=coarse, operator="lattice")
        _, niter = h.solve_pcg(jnp.asarray(b), rtol=1e-10, maxiter=60)
        iters[coarse] = niter
    assert iters["hmg"] <= iters["direct"] + 1, iters


def test_curved_hmg_sigma():
    """Shifted curved problem through the general h-hierarchy (the shift
    rediscretizes per h-level with each level's own lumped mass)."""
    import scipy.sparse as sp

    from pmg_dolfinx_jax.fem.assembly import lumped_mass_np

    sigma = 37.0
    mesh = PerturbedBoxMesh((4, 4, 2))
    b = assemble_rhs(mesh, 3, f_rhs(2.0, sigma=sigma))
    h = PMGHierarchy(mesh, degrees=(1, 3), kappa=2.0, coarse="hmg",
                     operator="lattice", sigma=sigma)
    u, niter = h.solve_pcg(jnp.asarray(b), rtol=1e-10, maxiter=60)
    assert niter < 40, niter
    A = (assemble_stiffness(mesh, 3, kappa=2.0).tocsr()
         + sigma * sp.diags(lumped_mass_np(mesh, 3, bc_zero=True)))
    u_ref = spla.spsolve(A.tocsc(), b)
    assert np.allclose(np.asarray(u), u_ref, atol=1e-7)


def test_grid_curved_hmg_matches_single():
    """Gathered redundant general-hmg coarse on a (2,2) device grid:
    trajectories match the single-device hmg solve exactly (f64)."""
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    mesh = PerturbedBoxMesh((4, 4, 2))
    b = assemble_rhs(mesh, 3, f_rhs_variable())
    kwargs = dict(degrees=(1, 3), kappa=kappa_linear, coarse="hmg",
                  operator="lattice")
    single = PMGHierarchy(mesh, **kwargs)
    u_s, rn_s = single.solve(jnp.asarray(b), num_cycles=5)
    grid = GridPMG(mesh, shards=(2, 2), **kwargs)
    u_d, rn_d = grid.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-9), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-10)


def test_dist_curved_hmg_matches_single():
    """Same through the 1D slab decomposition (4 shards)."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG

    mesh = PerturbedBoxMesh((4, 4, 2))
    b = assemble_rhs(mesh, 3, f_rhs(2.0))
    kwargs = dict(degrees=(1, 3), kappa=2.0, coarse="hmg",
                  operator="lattice")
    single = PMGHierarchy(mesh, **kwargs)
    u_s, rn_s = single.solve(jnp.asarray(b), num_cycles=5)
    dist = DistPMG(mesh, n_devices=4, **kwargs)
    u_d, rn_d = dist.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-9), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-10)


def test_vcycle_preconditioned_cg_beats_jacobi():
    """One h-MG V-cycle as the CG preconditioner (examples/amg.py
    --pc hmg, the reference's KSPCG+PCHYPRE composition,
    amg/main.cpp:173-211) must cut the iteration count by an
    AMG-class factor vs plain Jacobi-CG on a non-eigenvector rhs."""
    from pmg_dolfinx_jax.ops.lattice import LatticeLaplacian
    from pmg_dolfinx_jax.solvers.cg import cg_solve
    from pmg_dolfinx_jax.solvers.hmg import build_hmg
    from pmg_dolfinx_jax.solvers.pmg import kron_cycle_ops, v_cycle

    mesh = BoxMesh((16, 16, 16))  # large enough that Jacobi-CG's O(1/h)
    op = LatticeLaplacian(mesh, 1, kappa=2.0, dtype=jnp.float64)

    def f_gauss(x):
        return 1000.0 * np.exp(-sum((x[i] - 0.5) ** 2 for i in range(2))
                               / 0.02)

    b = jnp.asarray(assemble_rhs(mesh, 1, f_gauss))
    _, info_j = cg_solve(op, b, jnp.zeros_like(b), op.diag_inv,
                         rtol=1e-8, maxiter=200)

    levels, data, bottom = build_hmg(mesh, 1, 2.0, jnp.float64)
    hops = kron_cycle_ops("highest")
    shape = levels[-1].shape

    def precond(r):
        u = v_cycle(data, r.reshape(shape),
                    jnp.zeros(shape, dtype=r.dtype), levels=levels,
                    coarse=bottom, coarse_cfg={}, ops=hops)
        return u.reshape(jnp.shape(r))

    x, info_h = cg_solve(op, b, jnp.zeros_like(b), op.diag_inv,
                         rtol=1e-8, maxiter=200, precond=precond)
    assert int(info_h["niter"]) * 3 <= int(info_j["niter"]), (
        int(info_h["niter"]), int(info_j["niter"]))
    r = b - op(x)
    assert float(jnp.linalg.norm(r)) < 1e-6 * float(jnp.linalg.norm(b))


def test_semicoarsen_sizes():
    from pmg_dolfinx_jax.solvers.hmg import semicoarsen_sizes

    sizes = semicoarsen_sizes((8, 8, 16), axes=(2,))
    assert sizes == [(8, 8, 16), (8, 8, 8), (8, 8, 4), (8, 8, 2)]
    # after the strong axis bottoms out, only RATIO-PRESERVING full
    # coarsening continues (coarsening just the weak axes would re-grow
    # the effective anisotropy); here (4,4,1) violates min_cells -> stop
    sizes2 = semicoarsen_sizes((16, 4, 4), axes=(0,), min_cells=2)
    assert sizes2 == [(16, 4, 4), (8, 4, 4), (4, 4, 4), (2, 4, 4)]
    # partial semi-coarsening of multiple strong axes
    sizes3 = semicoarsen_sizes((4, 8, 16), axes=(1, 2))
    assert sizes3[1] == (4, 4, 8) and sizes3[2] == (4, 2, 4)


def test_semicoarsening_rescues_anisotropic_hmg():
    """Anisotropic tensor kappa diag(1,1,64): isotropic factor-2 h-MG
    coarsening stalls the FCG outer loop (point smoothers are blind to
    the strong z coupling on every level — the weakness CLAUDE.md/r2
    documented), while SEMI-coarsening the strong axis
    (`semicoarsen_sizes`, coarse_cfg['sizes']) converges. The AMG
    strength-of-connection analogue (reference src/amg.hpp BoomerAMG).
    Measured (maxiter=80, rtol 1e-10): iso 80+ (cap), semi 33,
    semi + smoother_iters=4: 15 vs 11 for the exact dense coarse."""
    from pmg_dolfinx_jax.solvers.hmg import semicoarsen_sizes

    K = np.diag([1.0, 1.0, 64.0])
    nc = (8, 8, 16)
    mesh = BoxMesh(nc)
    b = jnp.asarray(assemble_rhs(mesh, 3, f_rhs_tensor(K)))
    iters = {}
    for tag, cfg in (("iso", None),
                     ("semi", dict(sizes=semicoarsen_sizes(nc, (2,))))):
        h = PMGHierarchy(mesh, degrees=(1, 3), kappa=K, coarse="hmg",
                         operator="lattice", coarse_cfg=cfg)
        _, niter = h.solve_pcg(b, rtol=1e-10, maxiter=60)
        iters[tag] = int(niter)
    assert iters["semi"] <= 40, iters
    assert iters["semi"] < iters["iso"] - 15, iters


def test_semicoarsening_sharded_matches_single():
    """coarse_cfg['sizes'] rides the gathered hmg coarse on DistPMG and
    GridPMG: same custom (semi-coarsened) hierarchy, trajectory-exact vs
    the single-device solve."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG
    from pmg_dolfinx_jax.solvers.hmg import semicoarsen_sizes

    K = np.diag([1.0, 1.0, 16.0])
    nc = (8, 4, 8)
    mesh = BoxMesh(nc)
    b = jnp.asarray(assemble_rhs(mesh, 2, f_rhs_tensor(K)))
    cfg = dict(sizes=semicoarsen_sizes(nc, (2,)))
    hier = PMGHierarchy(mesh, degrees=(1, 2), kappa=K, coarse="hmg",
                        operator="lattice", coarse_cfg=dict(cfg))
    u_s, rn_s = hier.solve(b, num_cycles=4)
    dist = DistPMG(mesh, n_devices=4, degrees=(1, 2), kappa=K,
                   coarse="hmg", operator="lattice",
                   coarse_cfg=dict(cfg), dtype=jnp.float64)
    u_d, rn_d = dist.solve(np.asarray(b), num_cycles=4)
    assert np.allclose(rn_d, rn_s, rtol=1e-10), (rn_s, rn_d)
    grid = GridPMG(mesh, shards=(2, 2, 1), degrees=(1, 2), kappa=K,
                   coarse="hmg", operator="lattice",
                   coarse_cfg=dict(cfg), dtype=jnp.float64)
    u_g, rn_g = grid.solve(np.asarray(b), num_cycles=4)
    assert np.allclose(rn_g, rn_s, rtol=1e-10), (rn_s, rn_g)


def test_hmg_sizes_validation():
    """Malformed coarse_cfg['sizes'] must fail fast with a clear error
    (review finding: non-nested levels previously died in cryptic
    reshape errors deep in setup)."""
    from pmg_dolfinx_jax.solvers.hmg import build_hmg, validate_hmg_sizes

    mesh = BoxMesh((8, 8, 8))
    with pytest.raises(ValueError, match="nested"):
        build_hmg(mesh, 1, 2.0, jnp.float64, sizes=[(8, 8, 8), (6, 6, 6)])
    with pytest.raises(ValueError, match="must start at"):
        validate_hmg_sizes((8, 8, 8), [(4, 4, 4), (2, 2, 2)])
    with pytest.raises(ValueError, match="repeated"):
        validate_hmg_sizes((8, 8, 8), [(8, 8, 8), (8, 8, 8)])
    with pytest.raises(ValueError, match=">= 2 levels"):
        validate_hmg_sizes((8, 8, 8), [(8, 8, 8)])


def test_semicoarsening_dist_hmg():
    """coarse_cfg['sizes'] + dist=True: the DISTRIBUTED (non-gathered)
    h-hierarchy accepts a shard-aligned semi-coarsened hierarchy and
    stays trajectory-exact vs the gathered/single-device solve; a
    shard-misaligned hierarchy fails fast (review finding: sizes was
    silently dropped with dist=True)."""
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG
    from pmg_dolfinx_jax.solvers.hmg import semicoarsen_sizes

    nc = (8, 4, 8)
    mesh = BoxMesh(nc)
    b = assemble_rhs(mesh, 2, f_rhs(2.0))
    sizes = semicoarsen_sizes(nc, (2,))
    single = PMGHierarchy(mesh, degrees=(1, 2), kappa=2.0, coarse="hmg",
                          operator="kron", coarse_cfg=dict(sizes=sizes))
    u_s, rn_s = single.solve(jnp.asarray(b), num_cycles=4)
    grid = GridPMG(mesh, shards=(2, 2, 1), degrees=(1, 2), kappa=2.0,
                   coarse="hmg", coarse_cfg=dict(dist=True, sizes=sizes))
    u_d, rn_d = grid.solve(b, num_cycles=4)
    assert np.allclose(rn_d, rn_s, rtol=1e-10), (rn_s, rn_d)
    with pytest.raises(ValueError, match="not divisible"):
        GridPMG(mesh, shards=(2, 2, 1), degrees=(1, 2), kappa=2.0,
                coarse="hmg",
                coarse_cfg=dict(dist=True, sizes=[nc, (4, 1, 8)]))


def test_semicoarsen_axes_autodetect():
    """Strong-axis detection from the coefficient AND cell aspect."""
    from pmg_dolfinx_jax.solvers.hmg import semicoarsen_axes

    mesh = BoxMesh((8, 8, 8))
    # tensor anisotropy: strong z
    assert semicoarsen_axes(mesh, np.diag([1.0, 1.0, 64.0])) == (2,)
    # isotropic scalar: no strong axes
    assert semicoarsen_axes(mesh, 2.0) == ()
    # cell-aspect anisotropy: hx = 1/16 vs 1/4 -> coupling_x 16x larger
    assert semicoarsen_axes(BoxMesh((16, 4, 4)), 2.0) == (0,)
    # extent-compensated cells are isotropic again
    assert semicoarsen_axes(BoxMesh((16, 4, 4), extent=(4.0, 1.0, 1.0)),
                            2.0) == ()
    # two strong axes
    assert semicoarsen_axes(mesh, np.diag([1.0, 50.0, 64.0])) == (1, 2)


def test_hmg_sizes_rejects_short_tuples():
    from pmg_dolfinx_jax.solvers.hmg import validate_hmg_sizes

    with pytest.raises(ValueError, match="triples"):
        validate_hmg_sizes((8, 8, 8), [(8, 8, 8), (4, 4)])

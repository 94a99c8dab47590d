"""Line-relaxation smoother (solvers/line.py) — the anisotropy remedy.

The reference has no line smoothers; its answer to anisotropy is hypre
BoomerAMG's strength-of-connection coarsening at p=1 (src/amg.hpp:11-119).
This module pins the replacement: dense within-line block
inverses applied as ONE batched matvec (no sequential Thomas sweep),
used as the Chebyshev preconditioner at the p-levels
(``PMGHierarchy(smoother='line')``) and/or the h-MG levels
(``coarse_cfg['smoother']='line'``).

Measured facts pinned here:
- the rotated-100:1-tensor STATIONARY divergence at smoother_iters=2
  (tests/test_tensor_kappa.py) turns contracting with smoother='line';
- diag(1,1,64) on (8,8,16): FCG(V-hmg) hits the 80-iteration cap with
  point Jacobi + isotropic coarsening and solves in ~7 iterations with
  line relaxation everywhere — better than the exact dense coarse with
  point smoothers (11).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla

from pmg_dolfinx_jax.fem.assembly import assemble_rhs, assemble_stiffness
from pmg_dolfinx_jax.fem.mesh import BoxMesh, PerturbedBoxMesh
from pmg_dolfinx_jax.models.poisson import (
    f_rhs_tensor,
    f_rhs_variable,
    kappa_aniso,
    kappa_linear,
)
from pmg_dolfinx_jax.solvers.line import (
    LINE_BLOCK_DOF_LIMIT,
    line_block_inverses,
    line_precond_apply,
    parse_line_smoother,
)
from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

DIAG64 = np.diag([1.0, 1.0, 64.0])


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_line_block_inverse_oracle(axis):
    """line_precond_apply == independent per-line dense solve against the
    assembled matrix, and bc dofs pass through untouched (the blocks'
    bc rows/cols are zeroed with unit diagonal)."""
    mesh = BoxMesh((3, 4, 5))
    P = 2
    A = assemble_stiffness(mesh, P, kappa=DIAG64).toarray()
    shape = mesh.lattice_shape(P)
    N = int(np.prod(shape))
    rng = np.random.default_rng(axis)
    r = rng.standard_normal(N)

    # Independent oracle: loop lines in index space, solve each block.
    want = np.empty(N)
    idx = np.arange(N).reshape(shape)
    moved = np.moveaxis(idx, axis, -1).reshape(-1, shape[axis])
    for line in moved:
        want[line] = np.linalg.solve(A[np.ix_(line, line)], r[line])

    inv = line_block_inverses(mesh, P, DIAG64, axis)
    got = np.asarray(line_precond_apply(jnp.asarray(inv), jnp.asarray(r),
                                        shape, axis))
    assert np.allclose(got, want, atol=1e-12 * np.abs(want).max())

    bc = np.asarray(mesh.boundary_dof_marker(P), bool)
    assert np.allclose(got[bc], r[bc])  # identity on bc dofs


def test_parse_line_smoother():
    mesh = BoxMesh((8, 8, 8))
    assert parse_line_smoother("cheb", mesh, 1.0) is None
    assert parse_line_smoother(None, mesh, 1.0) is None
    # tensor diagonal picks the strong axis
    assert parse_line_smoother("line", mesh, DIAG64) == 2
    # stretched cells count too: small h_x -> strong x coupling
    stretched = BoxMesh((8, 8, 8), extent=(0.1, 1.0, 1.0))
    assert parse_line_smoother("line", stretched, 1.0) == 0
    assert parse_line_smoother("line-y", mesh, 1.0) == 1
    with pytest.raises(ValueError, match="unknown hmg smoother"):
        parse_line_smoother("thomas", mesh, 1.0)


def test_line_dof_limit():
    mesh = BoxMesh((40, 40, 40))
    with pytest.raises(ValueError, match="line smoother blocks"):
        line_block_inverses(mesh, 4, 1.0, 2)


def test_line_restores_stationary_rotated_tensor():
    """The pinned divergence of test_rotated_tensor_stationary_smoother_iters
    (rel 1.22 after 10 cycles at smoother_iters=2, point Jacobi) turns
    into contraction with smoother='line' at the SAME smoother_iters."""
    mesh = BoxMesh((6, 6, 6))
    K = kappa_aniso()  # pi/6 off-grid rotation, 100:1
    b = jnp.asarray(np.asarray(assemble_rhs(mesh, 6, f_rhs_tensor(K))))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hier = PMGHierarchy(mesh, degrees=(1, 3, 6), kappa=K,
                            dtype=jnp.float64, coarse="direct",
                            operator="lattice", smoother_iters=2,
                            smoother="line")
        _, rn = hier.solve(b, num_cycles=10)
    rn = np.asarray(rn)
    assert rn[-1] / rn[0] < 0.05, rn  # measured 6.0e-3


def test_line_rescues_anisotropic_hmg():
    """diag(1,1,64) with ISOTROPIC h-coarsening: point Jacobi stalls the
    FCG outer loop past 60 iterations (pinned in
    test_semicoarsening_rescues_anisotropic_hmg); line relaxation at the
    p-levels AND h-levels solves in ~7 — and the answer matches the
    assembled direct solve."""
    nc = (8, 8, 16)
    mesh = BoxMesh(nc)
    b = jnp.asarray(assemble_rhs(mesh, 3, f_rhs_tensor(DIAG64)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=DIAG64,
                            coarse="hmg", operator="lattice",
                            smoother="line",
                            coarse_cfg=dict(smoother="line"))
        u, niter = hier.solve_pcg(b, rtol=1e-10, maxiter=80)
    assert int(niter) <= 12, niter  # measured 7
    A = assemble_stiffness(mesh, 3, kappa=DIAG64)
    u_ref = spla.spsolve(A.tocsc(), np.asarray(b))
    assert np.allclose(np.asarray(u), u_ref,
                       atol=1e-7 * max(1.0, np.abs(u_ref).max()))


@pytest.mark.parametrize("operator", ["lattice", "dofmap", "kron"])
def test_line_smoother_backends_match_direct(operator):
    """smoother='line' produces the assembled solution on every backend
    family (incl. the flat-vector dofmap oracle and the lattice-shaped
    kron path)."""
    mesh = BoxMesh((6, 6, 8))
    b = jnp.asarray(assemble_rhs(mesh, 3, f_rhs_tensor(DIAG64)))
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=DIAG64,
                        dtype=jnp.float64, coarse="direct",
                        operator=operator, smoother="line")
    u, niter = hier.solve_pcg(b, rtol=1e-10, maxiter=40)
    A = assemble_stiffness(mesh, 3, kappa=DIAG64)
    u_ref = spla.spsolve(A.tocsc(), np.asarray(b))
    assert np.allclose(np.asarray(u), u_ref,
                       atol=1e-7 * max(1.0, np.abs(u_ref).max()))


def test_line_general_family_curved_variable_kappa():
    """Line relaxation on the GENERAL family: curved (perturbed) hexes +
    variable DG-0 kappa, explicit axis."""
    mesh = PerturbedBoxMesh((6, 6, 6))
    b = jnp.asarray(np.asarray(
        assemble_rhs(mesh, 4, f_rhs_variable(kappa_linear))))
    hier = PMGHierarchy(mesh, degrees=(1, 4), kappa=kappa_linear,
                        dtype=jnp.float64, coarse="direct",
                        operator="lattice", smoother="line-z")
    u, niter = hier.solve_pcg(b, rtol=1e-10, maxiter=40)
    A = assemble_stiffness(mesh, 4, kappa=kappa_linear)
    u_ref = spla.spsolve(A.tocsc(), np.asarray(b))
    assert np.allclose(np.asarray(u), u_ref,
                       atol=1e-7 * max(1.0, np.abs(u_ref).max()))


def test_line_sigma_shifted():
    """The line blocks carry the sigma lumped-mass shift (reaction-
    diffusion family): shifted solve matches the assembled shifted
    system."""
    from pmg_dolfinx_jax.fem.assembly import lumped_mass_np

    SIGMA = 11.0
    mesh = BoxMesh((6, 6, 8))
    b = jnp.asarray(assemble_rhs(mesh, 3, f_rhs_tensor(DIAG64)))
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=DIAG64,
                        dtype=jnp.float64, coarse="direct",
                        operator="lattice", smoother="line",
                        sigma=SIGMA)
    u, niter = hier.solve_pcg(b, rtol=1e-10, maxiter=40)
    A = assemble_stiffness(mesh, 3, kappa=DIAG64).tolil()
    m = lumped_mass_np(mesh, 3, bc_zero=True)
    A.setdiag(A.diagonal() + SIGMA * m)
    u_ref = spla.spsolve(A.tocsc(), np.asarray(b))
    assert np.allclose(np.asarray(u), u_ref,
                       atol=1e-7 * max(1.0, np.abs(u_ref).max()))


def test_hmg_line_smoother_sharded_matches_single():
    """coarse_cfg['smoother']='line' rides the gathered hmg coarse on
    DistPMG and GridPMG: trajectory-exact vs the single-device solve
    (the redundant-global coarse hierarchy is identical)."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    K = np.diag([1.0, 1.0, 16.0])
    nc = (8, 4, 8)
    mesh = BoxMesh(nc)
    b = jnp.asarray(assemble_rhs(mesh, 2, f_rhs_tensor(K)))
    cfg = dict(smoother="line")
    hier = PMGHierarchy(mesh, degrees=(1, 2), kappa=K, coarse="hmg",
                        operator="lattice", coarse_cfg=dict(cfg),
                        dtype=jnp.float64)
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


def test_dist_hmg_line_matches_single():
    """Line smoother on the DISTRIBUTED (dist=True) h-MG hierarchies:
    the global build's blocks ride the duplicated-plane layouts of every
    h-level (slab AND multi-axis grid), trajectory-exact vs the
    single-device gathered hierarchy."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    K = np.diag([1.0, 1.0, 16.0])
    mesh = BoxMesh((8, 4, 8))
    b = jnp.asarray(assemble_rhs(mesh, 2, f_rhs_tensor(K)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hier = PMGHierarchy(mesh, degrees=(1, 2), kappa=K, coarse="hmg",
                            operator="kron", dtype=jnp.float64,
                            smoother="line",
                            coarse_cfg=dict(smoother="line"))
        u_s, rn_s = hier.solve(b, num_cycles=4)
        dist = DistPMG(mesh, n_devices=4, degrees=(1, 2), kappa=K,
                       coarse="hmg", operator="kron", dtype=jnp.float64,
                       smoother="line",
                       coarse_cfg=dict(dist=True, smoother="line"))
        u_d, rn_d = dist.solve(np.asarray(b), num_cycles=4)
        grid = GridPMG(mesh, shards=(2, 2, 1), degrees=(1, 2), kappa=K,
                       coarse="hmg", operator="kron", dtype=jnp.float64,
                       smoother="line",
                       coarse_cfg=dict(dist=True, smoother="line"))
        u_g, rn_g = grid.solve(np.asarray(b), num_cycles=4)
    assert np.allclose(rn_d, rn_s, rtol=1e-10), (rn_s, rn_d)
    assert np.allclose(rn_g, rn_s, rtol=1e-10), (rn_s, rn_g)


def test_dist_hmg_line_general_family_matches_single():
    """Same for the GENERAL family (curved hexes + variable DG-0 kappa):
    build_hmg_grid_general threads the line blocks through the
    rediscretized multi-axis h-levels."""
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    mesh = PerturbedBoxMesh((8, 4, 8))
    b = jnp.asarray(np.asarray(
        assemble_rhs(mesh, 2, f_rhs_variable(kappa_linear))))
    hier = PMGHierarchy(mesh, degrees=(1, 2), kappa=kappa_linear,
                        coarse="hmg", operator="lattice",
                        dtype=jnp.float64, smoother="line-z",
                        coarse_cfg=dict(smoother="line-z"))
    u_s, rn_s = hier.solve(b, num_cycles=4)
    grid = GridPMG(mesh, shards=(2, 2, 1), degrees=(1, 2),
                   kappa=kappa_linear, coarse="hmg", operator="lattice",
                   dtype=jnp.float64, smoother="line-z",
                   coarse_cfg=dict(dist=True, smoother="line-z"))
    u_g, rn_g = grid.solve(np.asarray(b), num_cycles=4)
    assert np.allclose(rn_g, rn_s, rtol=1e-10), (rn_s, rn_g)


def test_dist_hmg_line_x_rejected():
    """dist=True line relaxation along the slab axis must fail fast."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG

    mesh = BoxMesh((8, 4, 4))
    K = np.diag([16.0, 1.0, 1.0])
    with pytest.raises(ValueError, match="along x"):
        DistPMG(mesh, n_devices=4, degrees=(1, 2), kappa=K,
                coarse="hmg", operator="kron", dtype=jnp.float64,
                coarse_cfg=dict(dist=True, smoother="line"))


def test_line_rejects_unknown_backend():
    mesh = BoxMesh((8, 8, 8))
    with pytest.raises(ValueError, match="unknown operator backend"):
        PMGHierarchy(mesh, degrees=(1, 3), kappa=2.0, dtype=jnp.float32,
                     operator="fused", smoother="line")


def test_plevel_line_sharded_matches_single():
    """PMGHierarchy / DistPMG / GridPMG with the p-level line smoother:
    residual trajectories match exactly (the line blocks live in the
    duplicated-plane layouts; lines are shard-local, zero extra
    communication)."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    K = np.diag([1.0, 1.0, 16.0])
    mesh = BoxMesh((8, 4, 8))
    b = jnp.asarray(assemble_rhs(mesh, 2, f_rhs_tensor(K)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hier = PMGHierarchy(mesh, degrees=(1, 2), kappa=K, coarse="cg",
                            operator="lattice", dtype=jnp.float64,
                            smoother="line")
        u_s, rn_s = hier.solve(b, num_cycles=4)
        dist = DistPMG(mesh, n_devices=4, degrees=(1, 2), kappa=K,
                       coarse="cg", operator="lattice",
                       dtype=jnp.float64, smoother="line")
        u_d, rn_d = dist.solve(np.asarray(b), num_cycles=4)
        grid = GridPMG(mesh, shards=(2, 2, 1), degrees=(1, 2), kappa=K,
                       coarse="cg", operator="lattice",
                       dtype=jnp.float64, smoother="line")
        u_g, rn_g = grid.solve(np.asarray(b), num_cycles=4)
    assert np.allclose(rn_d, rn_s, rtol=1e-10), (rn_s, rn_d)
    assert np.allclose(rn_g, rn_s, rtol=1e-10), (rn_s, rn_g)
    assert np.allclose(np.asarray(u_d), np.asarray(u_s), atol=1e-11)


def test_plevel_line_kron_sharded_matches_single():
    """Same invariance on the kron backend (lattice-shaped vectors) with
    the FDM coarse."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG

    K = np.diag([1.0, 1.0, 16.0])
    mesh = BoxMesh((8, 4, 8))
    b = jnp.asarray(assemble_rhs(mesh, 2, f_rhs_tensor(K)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hier = PMGHierarchy(mesh, degrees=(1, 2), kappa=K, coarse="fdm",
                            operator="kron", dtype=jnp.float64,
                            smoother="line")
        u_s, rn_s = hier.solve(b, num_cycles=4)
        dist = DistPMG(mesh, n_devices=4, degrees=(1, 2), kappa=K,
                       coarse="fdm", operator="kron", dtype=jnp.float64,
                       smoother="line")
        u_d, rn_d = dist.solve(np.asarray(b), num_cycles=4)
    assert np.allclose(rn_d, rn_s, rtol=1e-10), (rn_s, rn_d)


def test_line_sharded_axis_rejected():
    """Lines must not span shards: DistPMG rejects line-x (x is the slab
    axis); GridPMG rejects a line axis with shards>1."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    mesh = BoxMesh((8, 4, 4))
    K = np.diag([16.0, 1.0, 1.0])  # strongest axis = x -> auto picks x
    with pytest.raises(ValueError, match="cannot relax along x"):
        DistPMG(mesh, n_devices=4, degrees=(1, 2), kappa=K, coarse="cg",
                operator="lattice", dtype=jnp.float64, smoother="line")
    with pytest.raises(ValueError, match="shards"):
        GridPMG(mesh, shards=(2, 2, 2), degrees=(1, 2), kappa=2.0,
                coarse="cg", operator="lattice", dtype=jnp.float64,
                smoother="line-z")

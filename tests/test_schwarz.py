"""Cell-wise FDM Schwarz smoother (solvers/schwarz.py).

The production-size robust smoother: per-cell blocks inverted by
separable fast diagonalization (Lottes & Fischer's spectral-element
smoother), O(ndofs) memory — the scalable sibling of the line smoother
(solvers/line.py). The reference smooths with point Jacobi only
(src/chebyshev.hpp).

Pinned measured facts:
- block exactness: for the Kronecker-form operator the separable FDM
  block equals the exact cell block of the bc-applied assembled matrix
  (oracle to roundoff, incl. the sigma shift);
- isotropic p=(1,3,6): V-cycle contraction 0.12/cycle vs 0.41 Jacobi;
- rotated 100:1 tensor: the stationary divergence at smoother_iters=2
  turns contracting;
- curved hexes + variable kappa (hmg coarse): FCG 21 -> 8 iterations.
"""

import warnings

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
    kappa_aniso,
    kappa_linear,
)
from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy
from pmg_dolfinx_jax.solvers.schwarz import (
    build_schwarz,
    schwarz_precond_apply,
)

DIAG = np.diag([1.0, 2.0, 64.0])


def test_schwarz_dense_matches_batched():
    """The dense per-axis form (the default — six rectangular
    contractions, see schwarz._axis_dense) is mathematically identical
    to the batched per-cell-matmul reference form, incl. curved meshes,
    tensor kappa and the sigma shift."""
    rng = np.random.default_rng(7)
    for mesh, kappa, sigma in (
        (BoxMesh((3, 4, 5)), DIAG, 0.0),
        (PerturbedBoxMesh((4, 3, 4)), 2.0, 11.0),
    ):
        P = 3
        sw = build_schwarz(mesh, P, kappa, jnp.float64, sigma=sigma,
                           form="both")
        r = jnp.asarray(rng.standard_normal(mesh.num_dofs(P)))
        shape = mesh.lattice_shape(P)
        dense = schwarz_precond_apply(sw, r, shape, P, form="dense")
        batched = schwarz_precond_apply(sw, r, shape, P, form="batched")
        np.testing.assert_allclose(np.asarray(dense), np.asarray(batched),
                                   rtol=0, atol=1e-13)


@pytest.mark.parametrize("sigma", [0.0, 11.0])
def test_schwarz_matches_exact_block_solves(sigma):
    """M(r) == symmetric multiplicity-weighted sum of EXACT per-cell
    block solves of the bc-applied assembled (shifted) matrix — the
    separable FDM form is exact for the Kronecker-form operator."""
    from pmg_dolfinx_jax.fem.assembly import lumped_mass_np

    mesh = BoxMesh((3, 4, 5))
    P = 2
    A = assemble_stiffness(mesh, P, kappa=DIAG).tolil()
    if sigma:
        A.setdiag(A.diagonal() + sigma * lumped_mass_np(mesh, P,
                                                        bc_zero=True))
    A = A.tocsr()
    dofmap = np.asarray(mesh.dofmap(P))
    N = mesh.num_dofs(P)
    mult = np.zeros(N)
    np.add.at(mult, dofmap.ravel(), 1.0)
    w = 1.0 / np.sqrt(mult)
    rng = np.random.default_rng(3)
    r = rng.standard_normal(N)
    want = np.zeros(N)
    rw = r * w
    for c in range(dofmap.shape[0]):
        d = dofmap[c]
        want[d] += np.linalg.solve(A[np.ix_(d, d)].toarray(), rw[d])
    want *= w
    bc = np.asarray(mesh.boundary_dof_marker(P), bool)
    want[bc] = r[bc]

    sw = build_schwarz(mesh, P, DIAG, jnp.float64, sigma=sigma)
    got = np.asarray(schwarz_precond_apply(sw, jnp.asarray(r),
                                           mesh.lattice_shape(P), P))
    assert np.allclose(got, want, atol=1e-13 * np.abs(want).max())
    assert np.allclose(got[bc], r[bc])  # identity on bc dofs


def test_schwarz_beats_jacobi_isotropic():
    """Isotropic p=(1,3,6) V-cycle: Schwarz contraction ~0.12/cycle vs
    ~0.41 point Jacobi (measured rel@10 4.6e-10 vs 1.6e-4)."""
    mesh = BoxMesh((6, 6, 6))
    b = jnp.asarray(np.asarray(assemble_rhs(mesh, 6, f_rhs(2.0))))
    rels = {}
    for sm in ("cheb", "schwarz"):
        h = PMGHierarchy(mesh, degrees=(1, 3, 6), kappa=2.0,
                         dtype=jnp.float64, coarse="direct",
                         operator="lattice", smoother=sm)
        _, rn = h.solve(b, num_cycles=10)
        rn = np.asarray(rn)
        rels[sm] = rn[-1] / rn[0]
    assert rels["schwarz"] < 1e-8, rels
    assert rels["schwarz"] < rels["cheb"] * 1e-3, rels


def test_schwarz_restores_stationary_rotated_tensor():
    """The pinned rotated-100:1 stationary divergence at the default
    smoother_iters=2 turns contracting with smoother='schwarz' — like
    the line smoother, but at O(ndofs) memory (any problem size)."""
    mesh = BoxMesh((6, 6, 6))
    K = kappa_aniso()
    b = jnp.asarray(np.asarray(assemble_rhs(mesh, 6, f_rhs_tensor(K))))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        h = PMGHierarchy(mesh, degrees=(1, 3, 6), kappa=K,
                         dtype=jnp.float64, coarse="direct",
                         operator="lattice", smoother="schwarz")
        _, rn = h.solve(b, num_cycles=10)
    rn = np.asarray(rn)
    assert rn[-1] / rn[0] < 0.05, rn  # measured 3.4e-3


@pytest.mark.parametrize("operator", ["lattice", "dofmap", "kron"])
def test_schwarz_backends_match_direct(operator):
    mesh = BoxMesh((6, 6, 8))
    b = jnp.asarray(assemble_rhs(mesh, 3, f_rhs_tensor(DIAG)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=DIAG,
                            dtype=jnp.float64, coarse="direct",
                            operator=operator, smoother="schwarz")
        u, niter = hier.solve_pcg(b, rtol=1e-10, maxiter=60)
    A = assemble_stiffness(mesh, 3, kappa=DIAG)
    u_ref = spla.spsolve(A.tocsc(), np.asarray(b))
    assert np.allclose(np.asarray(u), u_ref,
                       atol=1e-7 * max(1.0, np.abs(u_ref).max()))


def test_schwarz_general_family_curved_variable_kappa():
    """Curved hexes + variable DG-0 kappa with schwarz at the p-levels
    AND the rediscretized h-MG levels: FCG count drops vs Jacobi
    (measured 8 vs 21) and the answer matches the assembled solve."""
    mesh = PerturbedBoxMesh((6, 6, 6))
    b = jnp.asarray(np.asarray(
        assemble_rhs(mesh, 4, f_rhs_variable(kappa_linear))))
    iters = {}
    for sm in ("cheb", "schwarz"):
        hier = PMGHierarchy(mesh, degrees=(1, 4), kappa=kappa_linear,
                            dtype=jnp.float64, coarse="hmg",
                            operator="lattice", smoother=sm,
                            coarse_cfg=dict(smoother=sm))
        u, niter = hier.solve_pcg(b, rtol=1e-10, maxiter=40)
        iters[sm] = int(niter)
    assert iters["schwarz"] <= 12, iters  # measured 8
    assert iters["schwarz"] < iters["cheb"] - 5, iters  # measured 21
    A = assemble_stiffness(mesh, 4, kappa=kappa_linear)
    u_ref = spla.spsolve(A.tocsc(), np.asarray(b))
    assert np.allclose(np.asarray(u), u_ref,
                       atol=1e-7 * max(1.0, np.abs(u_ref).max()))


def test_schwarz_sigma_shifted():
    from pmg_dolfinx_jax.fem.assembly import lumped_mass_np

    SIGMA = 7.0
    mesh = BoxMesh((6, 6, 8))
    b = jnp.asarray(assemble_rhs(mesh, 3, f_rhs_tensor(DIAG)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=DIAG,
                            dtype=jnp.float64, coarse="direct",
                            operator="lattice", smoother="schwarz",
                            sigma=SIGMA)
        u, niter = hier.solve_pcg(b, rtol=1e-10, maxiter=60)
    A = assemble_stiffness(mesh, 3, kappa=DIAG).tolil()
    A.setdiag(A.diagonal() + SIGMA * lumped_mass_np(mesh, 3, bc_zero=True))
    u_ref = spla.spsolve(A.tocsr().tocsc(), np.asarray(b))
    assert np.allclose(np.asarray(u), u_ref,
                       atol=1e-7 * max(1.0, np.abs(u_ref).max()))


def test_schwarz_sharded_matches_single():
    """DistPMG (x-slab) / GridPMG (3D grid) with the p-level Schwarz
    smoother: residual trajectories match the single device exactly.
    The cell blocks are shard-local (cells never span shards); the only
    communication is the interface partial-sum exchange after the cell
    overlap-add (ops['exchange'] inside the smoother), so ANY axis
    layout works — unlike the line smoother, which needs its line axis
    unsharded."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    K = np.diag([1.0, 2.0, 16.0])
    mesh = BoxMesh((8, 4, 8))
    b = jnp.asarray(assemble_rhs(mesh, 2, f_rhs_tensor(K)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hier = PMGHierarchy(mesh, degrees=(1, 2), kappa=K, coarse="cg",
                            operator="lattice", dtype=jnp.float64,
                            smoother="schwarz")
        u_s, rn_s = hier.solve(b, num_cycles=4)
        dist = DistPMG(mesh, n_devices=4, degrees=(1, 2), kappa=K,
                       coarse="cg", operator="lattice",
                       dtype=jnp.float64, smoother="schwarz")
        u_d, rn_d = dist.solve(np.asarray(b), num_cycles=4)
        # x sharded too — the layout the line smoother must reject.
        grid = GridPMG(mesh, shards=(2, 2, 2), degrees=(1, 2), kappa=K,
                       coarse="cg", operator="lattice",
                       dtype=jnp.float64, smoother="schwarz")
        u_g, rn_g = grid.solve(np.asarray(b), num_cycles=4)
    assert np.allclose(rn_d, rn_s, rtol=1e-10), (rn_s, rn_d)
    assert np.allclose(rn_g, rn_s, rtol=1e-10), (rn_s, rn_g)
    assert np.allclose(np.asarray(u_d), np.asarray(u_s), atol=1e-11)
    assert np.allclose(np.asarray(u_g), np.asarray(u_s), atol=1e-11)


def test_schwarz_kron_sharded_matches_single():
    """Same invariance on the kron backend (lattice-shaped vectors) with
    the FDM coarse, and on the curved-hex general family (GridPMG
    lattice backend + hmg coarse) — the meshes Schwarz is for."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    K = np.diag([1.0, 2.0, 16.0])
    mesh = BoxMesh((8, 4, 8))
    b = jnp.asarray(assemble_rhs(mesh, 2, f_rhs_tensor(K)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hier = PMGHierarchy(mesh, degrees=(1, 2), kappa=K, coarse="fdm",
                            operator="kron", dtype=jnp.float64,
                            smoother="schwarz")
        u_s, rn_s = hier.solve(b, num_cycles=4)
        dist = DistPMG(mesh, n_devices=4, degrees=(1, 2), kappa=K,
                       coarse="fdm", operator="kron", dtype=jnp.float64,
                       smoother="schwarz")
        u_d, rn_d = dist.solve(np.asarray(b), num_cycles=4)
    assert np.allclose(rn_d, rn_s, rtol=1e-10), (rn_s, rn_d)

    mesh_c = PerturbedBoxMesh((8, 4, 8))
    b_c = jnp.asarray(np.asarray(
        assemble_rhs(mesh_c, 2, f_rhs_variable(kappa_linear))))
    hier = PMGHierarchy(mesh_c, degrees=(1, 2), kappa=kappa_linear,
                        coarse="cg", operator="lattice",
                        dtype=jnp.float64, smoother="schwarz")
    u_s, rn_s = hier.solve(b_c, num_cycles=4)
    grid = GridPMG(mesh_c, shards=(2, 1, 2), degrees=(1, 2),
                   kappa=kappa_linear, coarse="cg", operator="lattice",
                   dtype=jnp.float64, smoother="schwarz")
    u_g, rn_g = grid.solve(np.asarray(b_c), num_cycles=4)
    assert np.allclose(rn_g, rn_s, rtol=1e-10), (rn_s, rn_g)


def test_hmg_schwarz_gathered_sharded_matches_single():
    """coarse_cfg['smoother']='schwarz' on the GATHERED (redundant-
    global) hmg coarse under sharding: the replicated h-levels smooth
    with the global Schwarz data and no exchange (the ops dict of the
    inner hierarchy has none) — trajectory-exact vs single device."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    K = np.diag([1.0, 1.0, 16.0])
    mesh = BoxMesh((8, 4, 8))
    b = jnp.asarray(assemble_rhs(mesh, 2, f_rhs_tensor(K)))
    cfg = dict(smoother="schwarz")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hier = PMGHierarchy(mesh, degrees=(1, 2), kappa=K, coarse="hmg",
                            operator="lattice", coarse_cfg=dict(cfg),
                            dtype=jnp.float64)
        u_s, rn_s = hier.solve(b, num_cycles=4)
        dist = DistPMG(mesh, n_devices=4, degrees=(1, 2), kappa=K,
                       coarse="hmg", operator="lattice",
                       coarse_cfg=dict(cfg), dtype=jnp.float64)
        u_d, rn_d = dist.solve(np.asarray(b), num_cycles=4)
        grid = GridPMG(mesh, shards=(2, 2, 1), degrees=(1, 2), kappa=K,
                       coarse="hmg", operator="lattice",
                       coarse_cfg=dict(cfg), dtype=jnp.float64)
        u_g, rn_g = grid.solve(np.asarray(b), num_cycles=4)
    assert np.allclose(rn_d, rn_s, rtol=1e-10), (rn_s, rn_d)
    assert np.allclose(rn_g, rn_s, rtol=1e-10), (rn_s, rn_g)


def test_dist_hmg_schwarz_matches_single():
    """Schwarz on the DISTRIBUTED (dist=True) h-MG hierarchies: the
    global build's per-level cell blocks ride the duplicated-plane
    layouts of every h-level (slab AND multi-axis grid),
    trajectory-exact vs the single-device gathered hierarchy."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    K = np.diag([1.0, 1.0, 16.0])
    mesh = BoxMesh((8, 4, 8))
    b = jnp.asarray(assemble_rhs(mesh, 2, f_rhs_tensor(K)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hier = PMGHierarchy(mesh, degrees=(1, 2), kappa=K, coarse="hmg",
                            operator="kron", dtype=jnp.float64,
                            smoother="schwarz",
                            coarse_cfg=dict(smoother="schwarz"))
        u_s, rn_s = hier.solve(b, num_cycles=4)
        dist = DistPMG(mesh, n_devices=4, degrees=(1, 2), kappa=K,
                       coarse="hmg", operator="kron", dtype=jnp.float64,
                       smoother="schwarz",
                       coarse_cfg=dict(dist=True, smoother="schwarz"))
        u_d, rn_d = dist.solve(np.asarray(b), num_cycles=4)
        grid = GridPMG(mesh, shards=(2, 2, 2), degrees=(1, 2), kappa=K,
                       coarse="hmg", operator="kron", dtype=jnp.float64,
                       smoother="schwarz",
                       coarse_cfg=dict(dist=True, smoother="schwarz"))
        u_g, rn_g = grid.solve(np.asarray(b), num_cycles=4)
    assert np.allclose(rn_d, rn_s, rtol=1e-10), (rn_s, rn_d)
    assert np.allclose(rn_g, rn_s, rtol=1e-10), (rn_s, rn_g)


def test_dist_hmg_schwarz_general_family_matches_single():
    """Same for the GENERAL family (curved hexes + variable DG-0 kappa):
    build_hmg_grid_general threads the Schwarz blocks through the
    rediscretized multi-axis h-levels."""
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    mesh = PerturbedBoxMesh((8, 4, 8))
    b = jnp.asarray(np.asarray(
        assemble_rhs(mesh, 2, f_rhs_variable(kappa_linear))))
    hier = PMGHierarchy(mesh, degrees=(1, 2), kappa=kappa_linear,
                        coarse="hmg", operator="lattice",
                        dtype=jnp.float64, smoother="schwarz",
                        coarse_cfg=dict(smoother="schwarz"))
    u_s, rn_s = hier.solve(b, num_cycles=4)
    grid = GridPMG(mesh, shards=(2, 2, 1), degrees=(1, 2),
                   kappa=kappa_linear, coarse="hmg", operator="lattice",
                   dtype=jnp.float64, smoother="schwarz",
                   coarse_cfg=dict(dist=True, smoother="schwarz"))
    u_g, rn_g = grid.solve(np.asarray(b), num_cycles=4)
    assert np.allclose(rn_g, rn_s, rtol=1e-10), (rn_s, rn_g)


def test_schwarz_rejects_unknown_backend():
    mesh = BoxMesh((8, 8, 8))
    with pytest.raises(ValueError, match="unknown operator backend"):
        PMGHierarchy(mesh, degrees=(1, 3), kappa=2.0, dtype=jnp.float32,
                     operator="fused", smoother="schwarz")

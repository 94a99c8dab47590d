"""Anisotropic (3x3-tensor) diffusion coefficient tests.

Beyond the reference's scalar DG-0 coefficient (src/laplacian.hpp:220-241):
``kappa`` may be a symmetric 3x3 tensor (constant, per-cell, or a callable
field), folded into the 6-entry geometry factors
``G = w/detJ K kappa K^T`` (fem/geometry.py) so every downstream consumer
— lattice / blocked / dofmap applies, diagonals, oracle assembly, h-MG
rediscretization — is unchanged. Gates: exact agreement with the
assembled-matrix oracle in f64, scalar reduction, and converged solves on
a strongly anisotropic problem.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla

from pmg_dolfinx_jax.fem.assembly import (
    assemble_rhs,
    assemble_stiffness,
    resolve_kappa,
    stiffness_diagonal_np,
)
from pmg_dolfinx_jax.fem.mesh import BoxMesh, PerturbedBoxMesh
from pmg_dolfinx_jax.models.poisson import f_rhs
from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

ANISO = np.diag([1.0, 1.0, 100.0])  # classic strong-anisotropy tensor


def _spd_tensor_field(mesh, seed=0):
    """Random symmetric positive-definite tensor per cell."""
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(mesh.ncells, 3, 3))
    return np.einsum("cam,cbm->cab", B, B) + 3.0 * np.eye(3)


def test_resolve_kappa_tensor_forms():
    mesh = BoxMesh((3, 3, 3))
    kc, const = resolve_kappa(mesh, ANISO)
    assert kc.shape == (mesh.ncells, 3, 3) and not const
    assert np.allclose(kc, ANISO)
    kt = _spd_tensor_field(mesh)
    kc2, _ = resolve_kappa(mesh, kt)
    assert np.array_equal(kc2, kt)
    # callable returning tensors, sampled at centroids
    fn = lambda x: np.broadcast_to(ANISO, (x.shape[1], 3, 3))
    kc3, _ = resolve_kappa(mesh, fn)
    assert np.allclose(kc3, ANISO)
    with pytest.raises(ValueError, match="symmetric"):
        resolve_kappa(mesh, np.triu(np.ones((3, 3))) + np.eye(3))


def test_tensor_reduces_to_scalar():
    """kappa = k*I must reproduce the scalar-kappa operator."""
    mesh = PerturbedBoxMesh((4, 4, 4))
    P, k = 3, 2.7
    A_s = assemble_stiffness(mesh, P, kappa=k).toarray()
    A_t = assemble_stiffness(mesh, P, kappa=k * np.eye(3)).toarray()
    assert np.allclose(A_t, A_s, atol=1e-12 * np.abs(A_s).max())


@pytest.mark.parametrize("operator", ["dofmap", "lattice"])
def test_operator_matches_assembled_oracle(operator):
    """Matrix-free applies on a curved mesh with a random SPD tensor
    field match the assembled CSR matrix to f64 roundoff (the
    --mat_comp oracle, reference examples/mat_free/main.cpp:270-289)."""
    mesh = PerturbedBoxMesh((4, 3, 3))
    P = 3
    kt = _spd_tensor_field(mesh)
    A = assemble_stiffness(mesh, P, kappa=kt)
    rng = np.random.default_rng(1)
    x = rng.normal(size=mesh.num_dofs(P))
    marker = np.asarray(mesh.boundary_dof_marker(P))
    want = A @ np.where(marker, 0.0, x)
    want[marker] = x[marker]

    if operator == "dofmap":
        from pmg_dolfinx_jax.ops.laplacian import MatFreeLaplacian

        op = MatFreeLaplacian(mesh, P, kappa=kt, dtype=jnp.float64)
    else:
        from pmg_dolfinx_jax.ops.lattice import LatticeLaplacian

        op = LatticeLaplacian(mesh, P, kappa=kt, dtype=jnp.float64)
        op = op.__call__ if not callable(op) else op
    got = np.asarray(op(jnp.asarray(x)))
    assert np.allclose(got, want, atol=1e-11 * np.abs(want).max())


def test_diagonal_matches_assembled():
    mesh = PerturbedBoxMesh((3, 3, 4))
    P = 2
    kt = _spd_tensor_field(mesh, seed=2)
    A = assemble_stiffness(mesh, P, kappa=kt)
    d = stiffness_diagonal_np(mesh, P, kt)
    assert np.allclose(d, A.diagonal(), atol=1e-12 * np.abs(d).max())


def test_lattice_tensor_kappa_f32():
    """The f32 lattice apply with a per-cell tensor kappa (folded into
    G): oracle parity to f32 rounding."""
    from pmg_dolfinx_jax.ops.lattice import LatticeLaplacian

    mesh = PerturbedBoxMesh((4, 3, 3))
    P = 3
    kt = _spd_tensor_field(mesh, seed=3)
    op = LatticeLaplacian(mesh, P, kappa=kt, dtype=jnp.float32)
    A = assemble_stiffness(mesh, P, kappa=kt)
    x = np.random.default_rng(4).normal(size=mesh.num_dofs(P))
    marker = np.asarray(mesh.boundary_dof_marker(P))
    want = A @ np.where(marker, 0.0, x)
    want[marker] = x[marker]
    got = np.asarray(op(jnp.asarray(x, jnp.float32)))
    assert np.allclose(got, want, atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("coarse", ["direct", "cg"])
def test_pmg_solves_anisotropic_problem(coarse):
    """Full PMG solve with the classic diag(1,1,100) anisotropy: the
    FCG(V) solution matches the scipy direct solve of the assembled
    system."""
    mesh = BoxMesh((6, 6, 6))
    degrees = (1, 3)
    hier = PMGHierarchy(mesh, degrees=degrees, kappa=ANISO,
                        dtype=jnp.float64, coarse=coarse,
                        operator="lattice")
    b = np.asarray(assemble_rhs(mesh, degrees[-1], f_rhs(1.0)))
    u, niter = hier.solve_pcg(jnp.asarray(b), rtol=1e-10, maxiter=60)
    A = assemble_stiffness(mesh, degrees[-1], kappa=ANISO)
    u_ref = spla.spsolve(A.tocsc(), b)
    assert np.allclose(np.asarray(u), u_ref,
                       atol=1e-7 * max(1.0, np.abs(u_ref).max()))


def test_tensor_kappa_sharded_matches_single_device():
    """DistPMG (1D slab) and GridPMG (3D grid) with a per-cell SPD tensor
    field: residual trajectories match the single-device solve exactly
    (the rank-count-invariance contract extends to anisotropic kappa)."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    mesh = BoxMesh((8, 4, 4))
    degrees = (1, 3)
    kt = _spd_tensor_field(mesh, seed=6)
    hier = PMGHierarchy(mesh, degrees=degrees, kappa=kt,
                        dtype=jnp.float64, coarse="cg",
                        operator="lattice")
    b = np.asarray(assemble_rhs(mesh, degrees[-1], f_rhs(1.0)))
    u_s, rn_s = hier.solve(jnp.asarray(b), num_cycles=5)
    dist = DistPMG(mesh, n_devices=4, degrees=degrees, kappa=kt,
                   coarse="cg", operator="lattice", dtype=jnp.float64)
    u_d, rn_d = dist.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-10), (rn_s, rn_d)
    assert np.allclose(np.asarray(u_d), np.asarray(u_s), atol=1e-11)
    grid = GridPMG(mesh, shards=(2, 2, 2), degrees=degrees, kappa=kt,
                   coarse="cg", operator="lattice", dtype=jnp.float64)
    u_g, rn_g = grid.solve(b, num_cycles=5)
    assert np.allclose(rn_g, rn_s, rtol=1e-10), (rn_s, rn_g)
    assert np.allclose(np.asarray(u_g), np.asarray(u_s), atol=1e-11)


def test_rotated_tensor_stationary_smoother_iters():
    """Pins the measured stationary-divergence facts behind
    `warn_tensor_stationary`: the three-level (1,3,6) cycle with the
    rotated 100:1 tensor DIVERGES at the default smoother_iters=2 and
    CONVERGES at smoother_iters=3. The divergence lives at the high-p
    smoothing levels, not in the coarse operator — a true-Galerkin
    (I^T A I whole-chain) and an exactly-integrated Q1 coarse were both
    measured to diverge identically at smoother_iters=2 (standalone f64
    scipy twin), so a 'better' coarse is NOT the remedy the warning
    should point to. The threshold is problem-dependent: on an
    elongated (3,7,10) box, whose cell aspect ratios compound the
    tensor anisotropy, si=3 still diverges and si=4 contracts
    (measured; not pinned here for runtime)."""
    import warnings

    from pmg_dolfinx_jax.models.poisson import kappa_aniso

    mesh = BoxMesh((6, 6, 6))
    K = kappa_aniso()  # pi/6 off-grid rotation, 100:1
    b = jnp.asarray(np.asarray(assemble_rhs(mesh, 6, f_rhs(1.0))))
    rels = {}
    for si in (2, 3):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            hier = PMGHierarchy(mesh, degrees=(1, 3, 6), kappa=K,
                                dtype=jnp.float64, coarse="direct",
                                operator="lattice", smoother_iters=si)
            _, rn = hier.solve(b, num_cycles=10)
        rn = np.asarray(rn)
        rels[si] = rn[-1] / rn[0]
    assert rels[2] > 1.0, rels  # diverged (measured 1.22)
    assert rels[3] < 0.1, rels  # contracting (measured 4.9e-2)


def test_pmg_hmg_coarse_tensor_field_curved():
    """The general-family h-MG coarse solver threads tensor kappa through
    the rediscretized h-levels (volume-averaged tensors): FCG converges
    on a curved mesh with a random SPD tensor field."""
    mesh = PerturbedBoxMesh((8, 8, 8))
    degrees = (1, 3)
    kt = _spd_tensor_field(mesh, seed=5)
    hier = PMGHierarchy(mesh, degrees=degrees, kappa=kt,
                        dtype=jnp.float64, coarse="hmg",
                        operator="lattice")
    b = np.asarray(assemble_rhs(mesh, degrees[-1], f_rhs(1.0)))
    u, niter = hier.solve_pcg(jnp.asarray(b), rtol=1e-9, maxiter=40)
    assert int(niter) < 40
    A = assemble_stiffness(mesh, degrees[-1], kappa=kt)
    r = b - A @ np.asarray(u)
    # bc rows are identity in A; u there equals b there by construction
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-8


def test_kron_family_diagonal_tensor():
    """A constant DIAGONAL tensor keeps the Kronecker-sum structure
    (per-axis scalars) — grid-aligned anisotropic diffusion on the full
    kron path, oracle-verified, and solved EXACTLY by the FDM direct
    solver."""
    from pmg_dolfinx_jax.ops.kron import KronLaplacian
    from pmg_dolfinx_jax.solvers.fdm import FastDiagonalizationSolver

    K = np.diag([1.0, 4.0, 64.0])
    mesh = BoxMesh((4, 5, 6))
    P = 3
    A = assemble_stiffness(mesh, P, kappa=K)
    op = KronLaplacian(mesh, P, kappa=K, dtype=jnp.float64)
    assert op.kappa_axes == (1.0, 4.0, 64.0)
    rng = np.random.default_rng(7)
    x = rng.normal(size=mesh.num_dofs(P))
    marker = np.asarray(mesh.boundary_dof_marker(P))
    want = A @ np.where(marker, 0.0, x)
    want[marker] = x[marker]
    got = np.asarray(op(jnp.asarray(x)))
    assert np.allclose(got, want, atol=1e-11 * np.abs(want).max())

    # per-axis tuple spec is equivalent
    op2 = KronLaplacian(mesh, P, kappa=(1.0, 4.0, 64.0), dtype=jnp.float64)
    got2 = np.asarray(op2(jnp.asarray(x)))
    assert np.array_equal(got, got2)

    # FDM: the whole anisotropic system solved exactly (one direct solve)
    b = np.asarray(assemble_rhs(mesh, P, f_rhs(1.0)))
    fdm = FastDiagonalizationSolver(mesh, P, kappa=K, dtype=jnp.float64,
                                    precision="highest")
    u = np.asarray(fdm.solve(b)).reshape(-1)
    u_ref = spla.spsolve(A.tocsc(), b)
    assert np.allclose(u, u_ref, atol=1e-9 * max(1.0, np.abs(u_ref).max()))


def test_kron_family_rejects_nonseparable():
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy as H

    from pmg_dolfinx_jax.models.poisson import kappa_aniso

    mesh = BoxMesh((4, 4, 4))
    with pytest.raises(ValueError, match="Kronecker"):
        H(mesh, degrees=(1, 2), kappa=kappa_aniso(), operator="kron")
    with pytest.raises(ValueError, match="Kronecker"):
        H(mesh, degrees=(1, 2), kappa=_spd_tensor_field(mesh),
          operator="kron")  # per-cell tensor field
    with pytest.raises(ValueError, match="constant-coefficient"):
        H(mesh, degrees=(1, 2), kappa=_spd_tensor_field(mesh),
          operator="lattice", coarse="fdm")


def test_pmg_kron_fdm_diagonal_tensor_solve():
    """Full PMG on the kron backend with a diagonal anisotropic tensor
    and the exact FDM coarse: FCG converges fast (the exact coarse
    sidesteps the rediscretized-coarse divergence) and matches scipy."""
    K = np.diag([1.0, 1.0, 64.0])
    mesh = BoxMesh((6, 6, 6))
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=K,
                        dtype=jnp.float64, coarse="fdm", operator="kron")
    b = np.asarray(assemble_rhs(mesh, 3, f_rhs(1.0)))
    u, niter = hier.solve_pcg(jnp.asarray(b), rtol=1e-10, maxiter=60)
    A = assemble_stiffness(mesh, 3, kappa=K)
    u_ref = spla.spsolve(A.tocsc(), b)
    assert np.allclose(np.asarray(u), u_ref,
                       atol=1e-7 * max(1.0, np.abs(u_ref).max()))
    assert int(niter) < 25, int(niter)


def test_diag_tensor_kron_sharded_matches_single():
    from pmg_dolfinx_jax.parallel.dist import DistPMG
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    K = np.diag([1.0, 2.0, 16.0])
    mesh = BoxMesh((8, 4, 4))
    kw = dict(degrees=(1, 3), kappa=K, coarse="fdm", operator="kron")
    hier = PMGHierarchy(mesh, dtype=jnp.float64, **kw)
    b = np.asarray(assemble_rhs(mesh, 3, f_rhs(1.0)))
    u_s, rn_s = hier.solve(jnp.asarray(b), num_cycles=5)
    dist = DistPMG(mesh, n_devices=4, dtype=jnp.float64, **kw)
    u_d, rn_d = dist.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-10), (rn_s, rn_d)
    grid = GridPMG(mesh, shards=(2, 2, 1), dtype=jnp.float64, **kw)
    u_g, rn_g = grid.solve(b, num_cycles=5)
    assert np.allclose(rn_g, rn_s, rtol=1e-10), (rn_s, rn_g)


def test_fdm_refine_shifted_system():
    """fdm.refine must refine the SHIFTED operator when sigma != 0
    (r3 review: the f64 residual operator silently dropped sigma and
    refinement converged to the unshifted solution)."""
    import scipy.sparse as sp

    from pmg_dolfinx_jax.fem.assembly import lumped_mass_np
    from pmg_dolfinx_jax.solvers.fdm import FastDiagonalizationSolver

    sigma = 50.0
    mesh = BoxMesh((4, 4, 4))
    P = 2
    b = np.asarray(assemble_rhs(mesh, P, f_rhs(1.0, sigma=sigma)))
    fdm = FastDiagonalizationSolver(mesh, P, kappa=1.0, sigma=sigma,
                                    dtype=jnp.float64)
    u, rnorms = fdm.refine(b, cycles=4)
    A = (assemble_stiffness(mesh, P, kappa=1.0).tocsr()
         + sigma * sp.diags(lumped_mass_np(mesh, P, bc_zero=True)))
    u_ref = spla.spsolve(A.tocsc(), b)
    assert np.allclose(np.asarray(u), u_ref, atol=1e-10)
    assert rnorms[-1] < 1e-10 * max(1.0, rnorms[0])


def test_per_axis_tuple_kappa_everywhere():
    """(kx, ky, kz) tuples are sugar for the diagonal tensor at EVERY
    public entry point (r3 review: hierarchy constructors previously
    crashed with a misleading per-cell error)."""
    import warnings

    mesh = BoxMesh((6, 6, 6))
    kax = (1.0, 2.0, 16.0)
    b = np.asarray(assemble_rhs(mesh, 3, f_rhs(1.0)))
    A = assemble_stiffness(mesh, 3, kappa=np.diag(kax))
    u_ref = spla.spsolve(A.tocsc(), b)
    for operator, coarse in (("kron", "fdm"), ("lattice", "direct")):
        hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=kax,
                            dtype=jnp.float64, coarse=coarse,
                            operator=operator)
        u, niter = hier.solve_pcg(jnp.asarray(b), rtol=1e-10, maxiter=60)
        assert np.allclose(np.asarray(u), u_ref,
                           atol=1e-7 * max(1.0, np.abs(u_ref).max())), operator
    # kron family with a diagonal/per-axis coefficient is exactly
    # represented at every level: its stationary entry points must NOT
    # warn (r3 review: spurious divergence warning on the headline
    # aniso-diag configuration), while the lattice hierarchy (folded
    # tensor, rediscretized coarse) still does.
    hier_k = PMGHierarchy(mesh, degrees=(1, 3), kappa=kax,
                          dtype=jnp.float64, coarse="fdm", operator="kron")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        hier_k.solve(jnp.asarray(b), num_cycles=1)
    with pytest.warns(UserWarning, match="tensor"):
        hier.solve(jnp.asarray(b), num_cycles=1)

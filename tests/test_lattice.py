"""Lattice-form (structured fast path) operator vs the assembled oracle.

Gate pattern as for the dofmap operator (`mat_free --mat_comp`,
examples/mat_free/main.cpp:270-289): the fast kernel must reproduce the
slow assembled reference. In f64 on CPU the lattice formulation is exact
to rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pmg_dolfinx_jax.fem.assembly import assemble_stiffness
from pmg_dolfinx_jax.fem.mesh import BoxMesh
from pmg_dolfinx_jax.ops.lattice import LatticeLaplacian, axis_matrices


@pytest.mark.parametrize(
    "nc,P", [((2, 2, 2), 1), ((3, 2, 4), 3), ((2, 3, 2), 4), ((2, 2, 2), 6)]
)
def test_lattice_vs_assembled(nc, P):
    mesh = BoxMesh(nc)
    kappa = 2.0
    op = LatticeLaplacian(mesh, P, kappa=kappa, dtype=jnp.float64)
    A = assemble_stiffness(mesh, P, kappa=kappa, bc=True)
    rng = np.random.default_rng(9)
    for _ in range(2):
        x = rng.standard_normal(mesh.num_dofs(P))
        y = np.asarray(op(jnp.asarray(x)))
        err = np.linalg.norm(y - A @ x) / np.linalg.norm(A @ x)
        assert err < 1e-12, (nc, P, err)


def test_lattice_diag_matches_dofmap():
    mesh = BoxMesh((3, 2, 2))
    P = 3
    op = LatticeLaplacian(mesh, P, kappa=2.0, dtype=jnp.float64)
    A = assemble_stiffness(mesh, P, kappa=2.0)
    assert np.allclose(np.asarray(op.diag), A.diagonal(), atol=1e-11)


def test_axis_matrices_structure():
    E, Dg = axis_matrices(3, 2)
    assert E.shape == (9, 7) and Dg.shape == (9, 7)
    # E rows are one-hot; columns of interface dofs are hit twice.
    assert np.array_equal(E.sum(axis=1), np.ones(9))
    col_counts = E.sum(axis=0)
    assert col_counts[2] == 2 and col_counts[4] == 2  # interface planes
    assert col_counts[0] == 1 and col_counts[-1] == 1
    # Dg rows sum to zero (derivative of constants).
    assert np.allclose(Dg.sum(axis=1), 0.0, atol=1e-11)


def test_kron_vs_assembled():
    from pmg_dolfinx_jax.ops.kron import KronLaplacian

    for nc, P in [((2, 2, 2), 1), ((3, 2, 4), 3), ((2, 2, 2), 6)]:
        mesh = BoxMesh(nc, extent=(1.0, 2.0, 0.5))  # anisotropic box
        kappa = 2.0
        op = KronLaplacian(mesh, P, kappa=kappa, dtype=jnp.float64)
        A = assemble_stiffness(mesh, P, kappa=kappa, bc=True)
        x = np.random.default_rng(4).standard_normal(mesh.num_dofs(P))
        y = np.asarray(op(jnp.asarray(x)))
        err = np.linalg.norm(y - A @ x) / np.linalg.norm(A @ x)
        assert err < 1e-12, (nc, P, err)
        assert np.allclose(np.asarray(op.diag), A.diagonal(), atol=1e-11)


def test_lattice_v2_and_affine_vs_assembled():
    """The copy-free-expansion variant (v2) and its affine-G mode equal
    the oracle exactly in f64."""
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.geometry import (
        geometry_factors,
        quadrature_weights_3d,
        tabulate_geometry_dphi,
    )
    from pmg_dolfinx_jax.fem.gll import gauss_lobatto
    from pmg_dolfinx_jax.ops.lattice import (
        geometry_to_qlattice,
        lattice_laplacian_apply_v2,
    )

    mesh = BoxMesh((3, 4, 2))
    P, kappa, n = 3, 2.0, 4
    A = assemble_stiffness(mesh, P, kappa=kappa)
    x = np.random.default_rng(2).standard_normal(mesh.num_dofs(P))
    y_ref = A @ x
    op = LatticeLaplacian(mesh, P, kappa=kappa, dtype=jnp.float64)
    G_cells, _ = geometry_factors(
        mesh.geometry_x, mesh.geometry_dofmap,
        tabulate_geometry_dphi(P), quadrature_weights_3d(P), xp=np,
    )
    Gq = jnp.asarray(geometry_to_qlattice(G_cells * kappa, mesh.nc, P))
    bc = jnp.asarray(mesh.boundary_dof_marker(P))
    xx = jnp.asarray(x)
    y2 = np.asarray(lattice_laplacian_apply_v2(xx, op.mats, Gq, bc, mesh.nc, P))
    assert np.linalg.norm(y2 - y_ref) / np.linalg.norm(y_ref) < 1e-13
    w3 = quadrature_weights_3d(P)
    Gaff = jnp.asarray((G_cells[:, 0, :] / w3[0]).reshape(mesh.nc + (6,)))
    _, w1 = gauss_lobatto(n)
    w1 = jnp.asarray(w1)
    y3 = np.asarray(
        lattice_laplacian_apply_v2(
            xx, op.mats, Gaff, bc, mesh.nc, P,
            weights1d=(w1, w1, w1), coeff=jnp.full(mesh.nc, kappa),
        )
    )
    assert np.linalg.norm(y3 - y_ref) / np.linalg.norm(y_ref) < 1e-13


@pytest.mark.parametrize("P", [7, 8])
def test_high_degree_beyond_reference(P):
    """Degrees beyond the reference's compile-time P<=5 cap
    (laplacian.hpp:336-346,468-479) — our dispatch is degree-generic."""
    mesh = BoxMesh((1, 2, 1))
    kappa = 2.0
    from pmg_dolfinx_jax.ops.kron import KronLaplacian

    op = KronLaplacian(mesh, P, kappa=kappa, dtype=jnp.float64)
    A = assemble_stiffness(mesh, P, kappa=kappa)
    x = np.random.default_rng(P).standard_normal(mesh.num_dofs(P))
    y = np.asarray(op(jnp.asarray(x)))
    assert np.linalg.norm(y - A @ x) / np.linalg.norm(A @ x) < 1e-12


def test_lattice_laplacian_variable_kappa_and_curved():
    """LatticeLaplacian accepts per-cell DG-0 / callable kappa and curved
    meshes (the p=1 operator behind examples/amg.py's general family):
    apply AND diagonal must match the assembled oracle."""
    from pmg_dolfinx_jax.fem.assembly import assemble_stiffness, resolve_kappa
    from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_jax.models.poisson import kappa_linear

    mesh = PerturbedBoxMesh((3, 4, 5))
    P = 2
    op = LatticeLaplacian(mesh, P, kappa=kappa_linear, dtype=jnp.float64)
    kc, _ = resolve_kappa(mesh, kappa_linear)
    A = assemble_stiffness(mesh, P, kappa=kc).toarray()
    nd = mesh.num_dofs(P)
    bc = np.asarray(mesh.boundary_dof_marker(P)) > 0.5
    x = np.random.default_rng(3).standard_normal(nd)
    y_ref = A @ np.where(bc, 0.0, x)
    y_ref[bc] = x[bc]
    y = np.asarray(op(jnp.asarray(x)))
    assert np.allclose(y, y_ref, atol=1e-11)
    d_ref = np.where(bc, 1.0, np.diag(A))
    assert np.allclose(np.asarray(op.diag), d_ref, atol=1e-11)

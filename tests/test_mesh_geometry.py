"""Tests for BoxMesh dofmaps and geometry factors (SURVEY.md §7 step 1)."""

import numpy as np
import pytest

from pmg_dolfinx_jax.fem.assembly import geometry_factors_np
from pmg_dolfinx_jax.fem.geometry import quadrature_weights_3d
from pmg_dolfinx_jax.fem.mesh import BoxMesh


def test_dofmap_basic():
    mesh = BoxMesh((2, 3, 4))
    P = 3
    dm = mesh.dofmap(P)
    assert dm.shape == (24, 64)
    assert dm.min() == 0
    assert dm.max() == mesh.num_dofs(P) - 1
    # Adjacent cells in z share a face: last z-plane of cell (0,0,0) equals
    # first z-plane of cell (0,0,1).
    n = P + 1
    c0 = dm[0].reshape(n, n, n)
    c1 = dm[1].reshape(n, n, n)  # cell (0,0,1): z is fastest index
    assert np.array_equal(c0[:, :, -1], c1[:, :, 0])
    # Adjacent in x: cell (1,0,0) has index ny*nz = 12
    cx = dm[12].reshape(n, n, n)
    assert np.array_equal(c0[-1, :, :], cx[0, :, :])


def test_every_dof_covered():
    mesh = BoxMesh((3, 2, 2))
    for P in (1, 2, 4):
        dm = mesh.dofmap(P)
        assert len(np.unique(dm)) == mesh.num_dofs(P)


def test_boundary_marker_count():
    mesh = BoxMesh((3, 3, 3))
    P = 2
    NX, NY, NZ = mesh.lattice_shape(P)
    marker = mesh.boundary_dof_marker(P)
    interior = (NX - 2) * (NY - 2) * (NZ - 2)
    assert marker.sum() == mesh.num_dofs(P) - interior


def test_dof_multiplicity_matches_dofmap_count():
    mesh = BoxMesh((2, 3, 2))
    for P in (1, 3):
        dm = mesh.dofmap(P)
        counts = np.bincount(dm.ravel(), minlength=mesh.num_dofs(P))
        assert np.array_equal(mesh.dof_multiplicity(P), counts.astype(float))


def test_dof_coords_corners_and_ordering():
    mesh = BoxMesh((2, 2, 2), extent=(2.0, 1.0, 1.0))
    P = 2
    coords = mesh.dof_coords(P)
    dm = mesh.dofmap(P)
    # Cell 0 first dof is the origin; its last dof the cell's far corner.
    assert np.allclose(coords[dm[0, 0]], [0.0, 0.0, 0.0])
    assert np.allclose(coords[dm[0, -1]], [1.0, 0.5, 0.5])


@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_geometry_factors_box(P):
    """On an axis-aligned box: J = diag(h), detJ = hx hy hz,
    G = w * detJ * diag(1/h^2)."""
    mesh = BoxMesh((2, 1, 3), extent=(2.0, 3.0, 1.0))
    G, detJ = geometry_factors_np(mesh, P)
    hx, hy, hz = mesh.h
    w = quadrature_weights_3d(P)
    assert np.allclose(detJ, hx * hy * hz)
    vol = hx * hy * hz
    assert np.allclose(G[..., 0], w[None, :] * vol / hx**2)
    assert np.allclose(G[..., 3], w[None, :] * vol / hy**2)
    assert np.allclose(G[..., 5], w[None, :] * vol / hz**2)
    for off_diag in (1, 2, 4):
        assert np.allclose(G[..., off_diag], 0.0, atol=1e-14)


def test_geometry_factors_distorted_vs_jnp():
    """jnp path == numpy path on a randomly perturbed (non-affine) mesh."""
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.geometry import (
        geometry_factors,
        tabulate_geometry_dphi,
    )

    mesh = BoxMesh((2, 2, 2))
    rng = np.random.default_rng(0)
    x = np.array(mesh.geometry_x)
    x = x + 0.05 * rng.standard_normal(x.shape)
    P = 3
    args = (
        x,
        mesh.geometry_dofmap,
        tabulate_geometry_dphi(P),
        quadrature_weights_3d(P),
    )
    G_np, det_np = geometry_factors(*args, xp=np)
    G_j, det_j = geometry_factors(*[jnp.asarray(a) for a in args])
    assert np.allclose(G_np, np.asarray(G_j), atol=1e-13)
    assert np.allclose(det_np, np.asarray(det_j), atol=1e-13)
    # Sanity: detJ stays positive for a mild perturbation.
    assert det_np.min() > 0

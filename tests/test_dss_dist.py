"""Distributed unstructured-topology PMG (parallel/dss_dist.py).

The shared-entity exchange (row-gather pack -> psum -> unpack) must
reproduce the single-device DSS hierarchy exactly: trajectories and
solutions to fp roundoff on the 8-virtual-device CPU mesh, across
coarse solvers, smoothers, degrees, coefficients and the dummy-cell
padding path (cell counts not divisible by the shard count).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pmg_dolfinx_jax.fem.assembly import assemble_rhs
from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh
from pmg_dolfinx_jax.fem.unstructured import (
    UnstructuredHexMesh,
    l_shaped_hex_mesh,
)
from pmg_dolfinx_jax.models.poisson import f_rhs
from pmg_dolfinx_jax.parallel.dss_dist import DSSDist, DSSPartition
from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-virtual-device CPU mesh")


def test_partition_roundtrip_and_weights():
    mesh = l_shaped_hex_mesh(2)  # 24 cells over 8 shards
    part = DSSPartition(mesh, 8)
    for P in (1, 3):
        t = part.tables(P)
        u = np.random.default_rng(P).standard_normal(mesh.num_dofs(P))
        ud = part.to_dist(P, u)
        np.testing.assert_array_equal(part.from_dist(P, ud), u)
        # every global dof owned exactly once
        S = 8
        w = t["weights"].reshape(S, -1)
        l2g = t["l2g"]
        owned = np.zeros(mesh.num_dofs(P))
        sel = l2g >= 0
        np.add.at(owned, l2g[sel], w.reshape(S, -1)[sel])
        np.testing.assert_array_equal(owned, 1.0)


def test_stationary_trajectory_exact_with_padding():
    """81 cells over 8 shards — exercises the dummy-cell padding."""
    mesh = l_shaped_hex_mesh(3)
    b = assemble_rhs(mesh, 3, f_rhs(2.0))
    hs = PMGHierarchy(mesh, degrees=(1, 3), kappa=2.0, coarse="cg",
                      operator="dss")
    us, rs = hs.solve(jnp.asarray(b), num_cycles=6)
    hd = DSSDist(mesh, n_devices=8, degrees=(1, 3), kappa=2.0, coarse="cg")
    ud, rd = hd.solve(b, num_cycles=6)
    np.testing.assert_allclose(rd, np.asarray(rs), rtol=1e-10)
    np.testing.assert_allclose(ud, np.asarray(us), rtol=0,
                               atol=1e-12 * abs(np.asarray(us)).max())


def test_fcg_direct_sigma_dg0_exact():
    mesh = l_shaped_hex_mesh(2)
    kap = np.linspace(1.0, 2.5, mesh.ncells)
    b = assemble_rhs(mesh, 4, f_rhs(1.0, sigma=0.8))
    hs = PMGHierarchy(mesh, degrees=(1, 2, 4), kappa=kap, coarse="direct",
                      operator="dss", sigma=0.8)
    us, its = hs.solve_pcg(jnp.asarray(b), rtol=1e-9)
    hd = DSSDist(mesh, n_devices=8, degrees=(1, 2, 4), kappa=kap,
                 coarse="direct", sigma=0.8)
    ud, itd = hd.solve_pcg(b, rtol=1e-9)
    assert its == itd
    np.testing.assert_allclose(ud, np.asarray(us), rtol=0,
                               atol=1e-12 * abs(np.asarray(us)).max())


def test_curved_schwarz_exact():
    pb = PerturbedBoxMesh((4, 4, 4))
    unc = UnstructuredHexMesh(pb.geometry_x, np.asarray(pb.geometry_dofmap))
    b = assemble_rhs(unc, 3, f_rhs(1.0))
    hs = PMGHierarchy(unc, degrees=(1, 3), kappa=2.0, coarse="cg",
                      operator="dss", smoother="schwarz")
    us, rs = hs.solve(jnp.asarray(b), num_cycles=5)
    hd = DSSDist(unc, n_devices=8, degrees=(1, 3), kappa=2.0, coarse="cg",
                 smoother="schwarz")
    ud, rd = hd.solve(b, num_cycles=5)
    np.testing.assert_allclose(rd, np.asarray(rs), rtol=1e-10)


def test_rejects_unsupported():
    mesh = l_shaped_hex_mesh(2)
    with pytest.raises(ValueError, match="amg"):
        DSSDist(mesh, n_devices=8, degrees=(1, 3), coarse="amg")
    from pmg_dolfinx_jax.fem.mesh import BoxMesh

    with pytest.raises(ValueError, match="Unstructured"):
        DSSDist(BoxMesh((2, 2, 2)), n_devices=8)

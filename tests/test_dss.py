"""The fast unstructured operator backend (operator='dss').

Layer 1 — layout: the DSS renumbering/tables reproduce the merged
dofmap exactly (gather/scatter roundtrips are BIT-exact vs the indexed
forms, including the 8 dihedral face orientations exercised by a
rotated-frame mesh).
Layer 2 — operator: the DSS apply equals the dofmap oracle apply to
roundoff in f64 on every degree class (P=1 all-vertex, P=2 m=1,
P>=3 full face/edge blocks), with DG-0 kappa and tensor kappa.
Layer 3 — solver: PMGHierarchy(operator='dss') residual trajectories
are identical to operator='dofmap' (same cycle, different kernels) and
FCG reaches the discretization error on the manufactured L-shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pmg_dolfinx_jax.fem.assembly import (
    assemble_rhs,
    l2_error_collocated,
)
from pmg_dolfinx_jax.fem.geometry import (
    geometry_factors,
    quadrature_weights_3d,
    tabulate_geometry_dphi,
)
from pmg_dolfinx_jax.fem.gll import derivative_matrix, interpolation_matrix_1d
from pmg_dolfinx_jax.fem.unstructured import (
    UnstructuredHexMesh,
    l_shaped_hex_mesh,
)
from pmg_dolfinx_jax.models.poisson import f_rhs
from pmg_dolfinx_jax.ops.interpolate import prolongate, restrict
from pmg_dolfinx_jax.ops.laplacian import laplacian_apply
from pmg_dolfinx_jax.ops.unstructured import (
    dss_device_tables,
    dss_gather,
    dss_laplacian_apply,
    dss_meta,
    dss_prolongate,
    dss_restrict,
    dss_scatter,
)
from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy


def _u_exact(x):
    return np.sin(np.pi * x[0]) * np.sin(np.pi * x[1]) * np.sin(np.pi * x[2])


def _rotated_lshape(n=2, seed=0):
    """L-shape with every cell's corner frame independently rotated —
    exercises all dihedral face/edge orientation variants."""
    base = l_shaped_hex_mesh(n)
    cells = np.array(base.geometry_dofmap)
    rng = np.random.default_rng(seed)
    rot = np.zeros_like(cells)
    # The 24 rotations of the cube act on the (i, j, k) corner lattice;
    # generate them as signed-axis permutations with det +1.
    from itertools import permutations

    frames = []
    for perm in permutations(range(3)):
        for sx in (1, -1):
            for sy in (1, -1):
                for sz in (1, -1):
                    M = np.zeros((3, 3))
                    for r, (p, s) in enumerate(zip(perm, (sx, sy, sz))):
                        M[r, p] = s
                    if np.linalg.det(M) > 0:
                        frames.append(M)
    corners = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                        for k in (0, 1)]) - 0.5
    for c in range(len(cells)):
        M = frames[rng.integers(len(frames))]
        newc = (corners @ M.T) + 0.5
        idx = [int(np.argmin(np.abs(corners + 0.5 - p).sum(1)))
               for p in newc]
        rot[c] = cells[c, idx]
    return UnstructuredHexMesh(base.geometry_x, rot)


@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_gather_scatter_bit_exact(P):
    mesh = _rotated_lshape(2)
    lt = mesh.dss_layout(P)
    meta = dss_meta(lt)
    t = dss_device_tables(lt)
    nd = mesh.num_dofs(P)
    dm = jnp.asarray(mesh.dofmap(P))
    n = P + 1
    x = jnp.asarray(np.random.default_rng(P).standard_normal(nd))
    u = dss_gather(x, t, meta)
    u_ref = x[dm.reshape(-1)].reshape(mesh.ncells, n, n, n)
    assert jnp.array_equal(u, u_ref)
    y = dss_scatter(u_ref, t, meta)
    y_ref = jnp.zeros(nd, x.dtype).at[dm.reshape(-1)].add(u_ref.reshape(-1))
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=0, atol=1e-13 * float(abs(y_ref).max()))
    # owner-write: value-consistent fields come back exactly
    xc = dss_gather(x, t, meta)
    assert jnp.array_equal(dss_scatter(xc, t, meta, first=True), x)


@pytest.mark.parametrize("P", [1, 2, 3])
def test_apply_matches_dofmap_oracle(P):
    mesh = _rotated_lshape(2, seed=3)
    lt = mesh.dss_layout(P)
    meta = dss_meta(lt)
    nd = mesh.num_dofs(P)
    rng = np.random.default_rng(P)
    coeff = jnp.asarray(rng.uniform(1.0, 3.0, mesh.ncells))
    G_np, _ = geometry_factors(
        mesh.geometry_x, mesh.geometry_dofmap, tabulate_geometry_dphi(P),
        quadrature_weights_3d(P), xp=np)
    lv = dict(
        dss_device_tables(lt),
        G=jnp.asarray(G_np), coeff=coeff,
        D=jnp.asarray(derivative_matrix(P)),
        bc_marker=jnp.asarray(mesh.boundary_dof_marker(P)),
    )
    x = jnp.asarray(rng.standard_normal(nd))
    y = dss_laplacian_apply(x, lv, meta)
    y_ref = laplacian_apply(x, jnp.asarray(mesh.dofmap(P)), lv["G"], coeff,
                            lv["D"], lv["bc_marker"])
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=1e-12, atol=1e-12)


def test_transfers_match_dofmap():
    mesh = _rotated_lshape(2, seed=5)
    Pc, Pf = 2, 4
    ltc, ltf = mesh.dss_layout(Pc), mesh.dss_layout(Pf)
    tc, tf = dss_device_tables(ltc), dss_device_tables(ltf)
    mc, mf = dss_meta(ltc), dss_meta(ltf)
    M1 = jnp.asarray(interpolation_matrix_1d(Pc, Pf))
    rng = np.random.default_rng(0)
    dmc = jnp.asarray(mesh.dofmap(Pc))
    dmf = jnp.asarray(mesh.dofmap(Pf))
    mult = jnp.asarray(mesh.dof_multiplicity(Pf))
    xc = jnp.asarray(rng.standard_normal(mesh.num_dofs(Pc)))
    np.testing.assert_allclose(
        np.asarray(dss_prolongate(xc, M1, tc, mc, tf, mf)),
        np.asarray(prolongate(xc, dmc, dmf, M1, mesh.num_dofs(Pf))),
        rtol=1e-13, atol=1e-13)
    xf = jnp.asarray(rng.standard_normal(mesh.num_dofs(Pf)))
    np.testing.assert_allclose(
        np.asarray(dss_restrict(xf, M1, tf, mf, tc, mc, 1.0 / mult)),
        np.asarray(restrict(xf, dmc, dmf, M1, mult, mesh.num_dofs(Pc))),
        rtol=1e-13, atol=1e-13)


def test_hierarchy_trajectory_identical_to_dofmap():
    mesh = l_shaped_hex_mesh(3)
    kappa = np.linspace(1.0, 3.0, mesh.ncells)  # DG-0 field
    b = jnp.asarray(assemble_rhs(mesh, 4, f_rhs(1.0)))
    res = {}
    for op in ("dofmap", "dss"):
        hier = PMGHierarchy(mesh, degrees=(1, 2, 4), kappa=kappa,
                            coarse="direct", operator=op, sigma=0.7)
        _, r = hier.solve(b, num_cycles=8)
        res[op] = np.asarray(r)
    np.testing.assert_allclose(res["dss"], res["dofmap"],
                               rtol=1e-11, atol=1e-14)


def test_tensor_kappa_matches_dofmap():
    mesh = _rotated_lshape(2, seed=7)
    K = np.array([[2.0, 0.3, 0.1], [0.3, 1.5, 0.2], [0.1, 0.2, 1.0]])
    b = jnp.asarray(assemble_rhs(mesh, 3, f_rhs(1.0)))
    res = {}
    for op in ("dofmap", "dss"):
        hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=K,
                            coarse="direct", operator=op)
        u, it = hier.solve_pcg(b, rtol=1e-10)
        res[op] = np.asarray(u)
        assert it < 25
    np.testing.assert_allclose(res["dss"], res["dofmap"], rtol=1e-8,
                               atol=1e-11)


def test_manufactured_convergence_fcg():
    mesh = l_shaped_hex_mesh(3)
    kappa = 2.0
    P = 4
    b = jnp.asarray(assemble_rhs(mesh, P, f_rhs(kappa)))
    hier = PMGHierarchy(mesh, degrees=(1, 2, P), kappa=kappa,
                        coarse="direct", operator="dss")
    u, it = hier.solve_pcg(b, rtol=1e-10)
    assert it <= 14
    err = l2_error_collocated(mesh, P, np.asarray(u), _u_exact)
    assert err < 5e-6


def test_dss_requires_layout_mesh():
    from pmg_dolfinx_jax.fem.mesh import BoxMesh

    with pytest.raises(ValueError, match="dss"):
        PMGHierarchy(BoxMesh((2, 2, 2)), degrees=(1, 2), operator="dss")


def test_schwarz_dss_matches_box_schwarz_on_wrapped_box():
    """On a uniform axis-aligned box wrapped as UnstructuredHexMesh the
    per-cell DSS Schwarz blocks coincide with the box Schwarz blocks
    (own-h neighbour augmentation == the global 1D matrix block at
    uniform spacing): residual trajectories (permutation-invariant)
    must match to roundoff."""
    from pmg_dolfinx_jax.fem.mesh import BoxMesh

    box = BoxMesh((4, 4, 4))
    un = UnstructuredHexMesh(box.geometry_x, np.asarray(box.geometry_dofmap))
    P = 3
    res = {}
    for mesh, op in ((box, "lattice"), (un, "dss")):
        b = jnp.asarray(assemble_rhs(mesh, P, f_rhs(2.0)))
        h = PMGHierarchy(mesh, degrees=(1, P), kappa=2.0, coarse="direct",
                         operator=op, smoother="schwarz")
        _, r = h.solve(b, num_cycles=6)
        res[op] = np.asarray(r)
    np.testing.assert_allclose(res["dss"], res["lattice"], rtol=1e-6)


def test_schwarz_dss_curved_varkappa_reduces_iterations():
    from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh

    pb = PerturbedBoxMesh((6, 6, 6))
    unc = UnstructuredHexMesh(pb.geometry_x, np.asarray(pb.geometry_dofmap))
    kap = lambda x: 1.0 + 0.8 * np.sin(3 * x[0]) * np.cos(2 * x[1])
    b = jnp.asarray(assemble_rhs(unc, 4, f_rhs(1.0)))
    its = {}
    for sm in ("cheb", "schwarz"):
        h = PMGHierarchy(unc, degrees=(1, 2, 4), kappa=kap, coarse="direct",
                         operator="dss", smoother=sm)
        _, its[sm] = h.solve_pcg(b, rtol=1e-8, maxiter=60)
    assert its["schwarz"] < its["cheb"], its


def test_schwarz_dss_sigma_and_p1_level():
    mesh = _rotated_lshape(2, seed=11)
    b = jnp.asarray(assemble_rhs(mesh, 2, f_rhs(2.0, sigma=1.2)))
    h = PMGHierarchy(mesh, degrees=(1, 2), kappa=2.0, sigma=1.2,
                     coarse="direct", operator="dss", smoother="schwarz")
    _, r = h.solve(b, num_cycles=8)
    r = np.asarray(r)
    assert r[-1] / r[0] < 1e-5

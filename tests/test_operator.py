"""Matrix-free Laplacian vs assembled oracle (SURVEY.md §7 step 2).

The reference's own correctness gate is `mat_free --mat_comp`: compare the
sum-factorized operator against the assembled CSR operator on identical
input (examples/mat_free/main.cpp:270-289). Same pattern here, with the
scipy-assembled golden matrix from fem.assembly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pmg_dolfinx_jax.fem.assembly import assemble_stiffness
from pmg_dolfinx_jax.fem.mesh import BoxMesh
from pmg_dolfinx_jax.ops.laplacian import MatFreeLaplacian


@pytest.mark.parametrize(
    "nc,P",
    [((2, 2, 2), 1), ((2, 2, 2), 2), ((2, 1, 3), 3), ((2, 2, 2), 4), ((1, 1, 1), 6)],
)
def test_matfree_vs_assembled(nc, P):
    mesh = BoxMesh(nc)
    kappa = 2.0
    op = MatFreeLaplacian(mesh, P, kappa=kappa)
    A = assemble_stiffness(mesh, P, kappa=kappa, bc=True)
    rng = np.random.default_rng(42)
    for _ in range(3):
        x = rng.standard_normal(mesh.num_dofs(P))
        y_mf = np.asarray(op(jnp.asarray(x)))
        y_ref = A @ x
        err = np.linalg.norm(y_mf - y_ref) / np.linalg.norm(y_ref)
        assert err < 1e-12, (nc, P, err)


def test_bc_rows_identity():
    mesh = BoxMesh((2, 2, 2))
    P = 3
    op = MatFreeLaplacian(mesh, P)
    marker = mesh.boundary_dof_marker(P)
    x = np.random.default_rng(1).standard_normal(mesh.num_dofs(P))
    y = np.asarray(op(jnp.asarray(x)))
    assert np.allclose(y[marker], x[marker])


@pytest.mark.parametrize("P", [1, 2, 3, 5])
def test_matfree_diagonal(P):
    mesh = BoxMesh((2, 2, 1))
    kappa = 2.0
    op = MatFreeLaplacian(mesh, P, kappa=kappa)
    A = assemble_stiffness(mesh, P, kappa=kappa, bc=True)
    assert np.allclose(np.asarray(op.diag), A.diagonal(), atol=1e-12)


def test_operator_symmetry():
    """x^T A y == y^T A x on interior dofs (A with bc is not symmetric
    across the bc/interior block, so test with bc-zeroed vectors)."""
    mesh = BoxMesh((2, 2, 2))
    P = 3
    op = MatFreeLaplacian(mesh, P)
    marker = np.asarray(mesh.boundary_dof_marker(P))
    rng = np.random.default_rng(7)
    x = rng.standard_normal(mesh.num_dofs(P)) * (~marker)
    y = rng.standard_normal(mesh.num_dofs(P)) * (~marker)
    Ax = np.asarray(op(jnp.asarray(x)))
    Ay = np.asarray(op(jnp.asarray(y)))
    assert abs(x @ Ay - y @ Ax) < 1e-10 * np.linalg.norm(Ax) * np.linalg.norm(y)


def test_batched_geometry_matches_unbatched():
    """batch_size geometry recomputation (the reference --batch_size
    memory knob, laplacian.hpp:383-395) must be bit-compatible with the
    precomputed-G apply."""
    mesh = BoxMesh((4, 3, 2))
    P = 3
    a = MatFreeLaplacian(mesh, P, kappa=2.0, batch_size=0)
    b = MatFreeLaplacian(mesh, P, kappa=2.0, batch_size=6)
    x = np.random.default_rng(8).standard_normal(mesh.num_dofs(P))
    ya = np.asarray(a(jnp.asarray(x)))
    yb = np.asarray(b(jnp.asarray(x)))
    assert np.allclose(ya, yb, atol=1e-13)


def test_vtk_and_npz_writers(tmp_path):
    from pmg_dolfinx_jax.utils.io import write_npz, write_vtk

    mesh = BoxMesh((2, 2, 2))
    P = 2
    u = np.arange(mesh.num_dofs(P), dtype=float)
    vtk = tmp_path / "u.vtk"
    write_vtk(vtk, mesh, P, u)
    text = vtk.read_text()
    assert "STRUCTURED_GRID" in text and "SCALARS u double" in text
    assert f"POINTS {mesh.num_dofs(P)}" in text
    npz = tmp_path / "u.npz"
    write_npz(npz, mesh, P, u)
    data = np.load(npz)
    assert data["u"].shape == mesh.lattice_shape(P)


def test_variable_dg0_coefficient():
    """Per-cell (DG-0) kappa — the reference kernel's entity_constants
    argument (laplacian.hpp:144,230) — through the dofmap and lattice
    backends, against the oracle with per-cell coefficients."""
    from pmg_dolfinx_jax.fem.geometry import (
        geometry_factors,
        quadrature_weights_3d,
        tabulate_geometry_dphi,
    )
    from pmg_dolfinx_jax.ops.laplacian import laplacian_apply
    from pmg_dolfinx_jax.ops.lattice import (
        LatticeLaplacian,
        geometry_to_qlattice,
        lattice_laplacian_apply,
        axis_matrices,
    )
    from pmg_dolfinx_jax.fem.gll import derivative_matrix

    mesh = BoxMesh((3, 2, 2))
    P = 2
    rng = np.random.default_rng(12)
    kappa_c = 1.0 + rng.random(mesh.ncells)
    A = assemble_stiffness(mesh, P, kappa=kappa_c)
    x = rng.standard_normal(mesh.num_dofs(P))
    y_ref = A @ x

    # dofmap backend: coeff is per-cell natively
    import pmg_dolfinx_jax.fem.geometry as geo

    G, _ = geo.geometry_factors(
        mesh.geometry_x, mesh.geometry_dofmap,
        tabulate_geometry_dphi(P), quadrature_weights_3d(P), xp=np,
    )
    y_dof = np.asarray(
        laplacian_apply(
            jnp.asarray(x), jnp.asarray(mesh.dofmap(P)), jnp.asarray(G),
            jnp.asarray(kappa_c), jnp.asarray(derivative_matrix(P)),
            jnp.asarray(mesh.boundary_dof_marker(P)),
        )
    )
    assert np.allclose(y_dof, y_ref, atol=1e-12)

    # lattice backend: kappa folded into the per-cell G factors
    mats = {}
    for name, nc_a in zip("xyz", mesh.nc):
        E, Dg = axis_matrices(nc_a, P)
        mats["E" + name] = jnp.asarray(E)
        mats["D" + name] = jnp.asarray(Dg)
    Gq = geometry_to_qlattice(G * kappa_c[:, None, None], mesh.nc, P)
    y_lat = np.asarray(
        lattice_laplacian_apply(
            jnp.asarray(x), mats, jnp.asarray(Gq),
            jnp.asarray(mesh.boundary_dof_marker(P)),
        )
    )
    assert np.allclose(y_lat, y_ref, atol=1e-12)


def test_checkpoint_roundtrip(tmp_path):
    from pmg_dolfinx_jax.utils.checkpoint import load_state, save_state

    mesh = BoxMesh((2, 2, 2))
    u = np.random.default_rng(0).standard_normal(mesh.num_dofs(2))
    path = tmp_path / "state.npz"
    save_state(path, mesh, (1, 2), 2.0, u, [1.0, 0.1], cycle=2)
    u2, rnorms, cycle = load_state(path, mesh, (1, 2), 2.0)
    assert np.array_equal(u2, u) and cycle == 2 and rnorms == [1.0, 0.1]
    import pytest

    with pytest.raises(ValueError):
        load_state(path, mesh, (1, 3), 2.0)


def test_refined_resume_from_checkpoint(tmp_path):
    """solve_refined(u0=...) resumes a refinement from a saved iterate
    and lands at the same accuracy as an uninterrupted run."""
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.assembly import assemble_rhs
    from pmg_dolfinx_jax.models.poisson import PoissonProblem, f_rhs
    from pmg_dolfinx_jax.utils.checkpoint import load_state, save_state

    prob = PoissonProblem(nc=(4, 4, 4), degrees=(1, 3), kappa=2.0,
                          dtype=jnp.float32, coarse="cg", operator="kron")
    u_full, rn_full = prob.hierarchy.solve_refined(prob.b, num_cycles=12)
    u_half, rn_half = prob.hierarchy.solve_refined(prob.b, num_cycles=6)
    path = tmp_path / "refine.npz"
    save_state(path, prob.mesh, (1, 3), 2.0, u_half, rn_half, cycle=6)
    u0, _, _ = load_state(path, prob.mesh, (1, 3), 2.0)
    u_res, rn_res = prob.hierarchy.solve_refined(prob.b, num_cycles=6,
                                                 u0=u0)
    r0 = float(np.linalg.norm(np.asarray(prob.b)))
    assert rn_res[-1] / r0 < 1e-6
    assert np.isclose(rn_res[-1], rn_full[-1], rtol=0.5), (
        rn_full[-1], rn_res[-1])

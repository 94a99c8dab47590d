"""Assembled BCOO operator tests (reference test/test_csr.cpp pattern).

The reference's only compiled test builds the global interpolation matrix
between Q_p and Q_{p+1} spaces, interpolates a linear function and checks
norms to 1e-9 (test/test_csr.cpp:78-117). Same gates here, plus spmv
parity with the matrix-free operator.
"""

import jax.numpy as jnp
import numpy as np

from pmg_dolfinx_jax.fem.mesh import BoxMesh
from pmg_dolfinx_jax.ops.csr import InterpolationMatrixOperator, MatrixOperator
from pmg_dolfinx_jax.ops.interpolate import PInterpolator
from pmg_dolfinx_jax.ops.laplacian import MatFreeLaplacian


def test_matrix_operator_matches_matfree():
    mesh = BoxMesh((3, 2, 3))
    P = 3
    mf = MatFreeLaplacian(mesh, P, kappa=2.0)
    mo = MatrixOperator(mesh, P, kappa=2.0)
    x = np.random.default_rng(0).standard_normal(mesh.num_dofs(P))
    y_mf = np.asarray(mf(jnp.asarray(x)))
    y_mo = np.asarray(mo(jnp.asarray(x)))
    assert np.allclose(y_mo, y_mf, atol=1e-11)
    assert np.allclose(np.asarray(mo.diag), np.asarray(mf.diag), atol=1e-11)


def test_interpolation_matrix_linear_exact():
    """Interpolating a linear function between degrees is exact — the
    reference's test_csr gate (|norm difference| < 1e-9)."""
    mesh = BoxMesh((3, 3, 3))
    Pc, Pf = 2, 3
    I = InterpolationMatrixOperator(mesh, Pc, Pf)
    cc = mesh.dof_coords(Pc)
    cf = mesh.dof_coords(Pf)
    lin = lambda c: 1.0 + 2 * c[:, 0] - 0.5 * c[:, 1] + 0.25 * c[:, 2]
    u_c = lin(cc)
    u_f = np.asarray(I.apply(jnp.asarray(u_c)))
    assert np.linalg.norm(u_f - lin(cf)) < 1e-9


def test_interpolation_matrix_matches_matfree_transfer():
    """Global assembled I / I^T == the matrix-free sum-factorized transfer
    (the contract validated against PETSc in
    python_tests/interpolation_matrix.py:65,78)."""
    mesh = BoxMesh((2, 3, 2))
    Pc, Pf = 1, 3
    I = InterpolationMatrixOperator(mesh, Pc, Pf)
    mf = PInterpolator(mesh, Pc, Pf)
    rng = np.random.default_rng(1)
    xc = rng.standard_normal(mesh.num_dofs(Pc))
    assert np.allclose(
        np.asarray(I.apply(jnp.asarray(xc))),
        np.asarray(mf.prolong(jnp.asarray(xc))),
        atol=1e-12,
    )
    xf = rng.standard_normal(mesh.num_dofs(Pf))
    assert np.allclose(
        np.asarray(I.transpose_apply(jnp.asarray(xf))),
        np.asarray(mf.restrict(jnp.asarray(xf))),
        atol=1e-12,
    )


def test_csr_pmg_backend_matches_dofmap_curved():
    """`PMGHierarchy(operator='csr')`: the whole hierarchy/solve stack on
    the ASSEMBLED BCOO operator (the reference's CSR fine-operator path,
    examples/pmg/main.cpp:40-43) — trajectory-identical to the dofmap
    matrix-free backend on a curved mesh with per-cell kappa and a sigma
    shift (same bc semantics, same Jacobi diagonal, same transfers)."""
    from pmg_dolfinx_jax.fem.assembly import assemble_rhs
    from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    mesh = PerturbedBoxMesh((4, 4, 4))
    rng = np.random.default_rng(0)
    kap = 1.0 + 0.5 * rng.random(64)
    b = assemble_rhs(mesh, 3,
                     lambda x: np.sin(np.pi * x[0]) * np.cos(x[1])
                     * (1.0 + x[2]))
    out = {}
    for op in ("dofmap", "csr"):
        h = PMGHierarchy(mesh, degrees=(1, 3), kappa=kap, coarse="direct",
                         operator=op, sigma=2.0)
        u, res = h.solve(b, num_cycles=8)
        out[op] = (np.asarray(u), np.asarray(res))
    ud, rd = out["dofmap"]
    uc, rc = out["csr"]
    assert np.linalg.norm(uc - ud) < 1e-12 * np.linalg.norm(ud)
    assert np.max(np.abs(rc - rd) / rd) < 1e-12
    # and the trajectory actually converged
    assert rc[-1] < 1e-2 * rc[0]


def test_csr_pmg_backend_fcg_and_sigma_field():
    """operator='csr' through solve_pcg with a sigma FIELD (baked into
    the assembled diagonal via the m3 mechanism) matches dofmap."""
    from pmg_dolfinx_jax.fem.assembly import assemble_rhs
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    mesh = BoxMesh((4, 4, 4))
    sig = lambda x: 1.0 + 3.0 * x[0] * x[1]
    b = assemble_rhs(mesh, 3, lambda x: np.cos(np.pi * x[0]) + x[2])
    res = {}
    for op in ("dofmap", "csr"):
        h = PMGHierarchy(mesh, degrees=(1, 3), kappa=1.5, coarse="direct",
                         operator=op, sigma=sig)
        u, niter = h.solve_pcg(b, rtol=1e-10)
        res[op] = (np.asarray(u), niter)
    assert res["csr"][1] == res["dofmap"][1]
    assert np.linalg.norm(res["csr"][0] - res["dofmap"][0]) < \
        1e-9 * np.linalg.norm(res["dofmap"][0])


def test_csr_fine_operator_matches_assembled_shift():
    """The csr level apply IS the assembled shifted matrix: A_bc +
    diag(sigma*m3) applied to a random vector, bc rows = identity."""
    from pmg_dolfinx_jax.fem.assembly import (assemble_stiffness,
                                              lumped_mass_np)
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    mesh = BoxMesh((3, 4, 3))
    P, sigma = 3, 4.0
    h = PMGHierarchy(mesh, degrees=(1, P), kappa=2.0, coarse="smoother",
                     operator="csr", sigma=sigma)
    A = assemble_stiffness(mesh, P, kappa=2.0, bc=True).tocsr()
    m3 = lumped_mass_np(mesh, P, bc_zero=True)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(mesh.num_dofs(P))
    y = np.asarray(h.operator()(jnp.asarray(x)))
    ref = A @ x + sigma * m3 * x
    assert np.linalg.norm(y - ref) < 1e-12 * np.linalg.norm(ref)

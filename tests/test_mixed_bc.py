"""Mixed Dirichlet/Neumann face boundary conditions
(`BoxMesh(dirichlet_faces=...)`): beyond the reference's all-Dirichlet
setup (examples/pmg/main.cpp:173-185). Unflagged faces carry the
homogeneous NEUMANN (natural) condition — their dofs are ordinary
unknowns and the cell-based assembly already produces the correct
variational rows, so every operator backend inherits correctness from
the marker. The hard-coded spots (FDM per-axis trims, Schwarz per-axis
end masks, h-MG coarsened-mesh flag propagation) are what these tests
pin down.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pmg_dolfinx_jax.fem.assembly import assemble_rhs, assemble_stiffness, l2_error
from pmg_dolfinx_jax.fem.mesh import BoxMesh, PerturbedBoxMesh
from pmg_dolfinx_jax.models.poisson import f_rhs_mixed, u_exact_mixed
from pmg_dolfinx_jax.solvers.fdm import FastDiagonalizationSolver
from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

MIXED = ((True, False), (False, False), (True, True))  # D-N, N-N, D-D


def test_marker_honors_faces():
    mesh = BoxMesh((3, 3, 3), dirichlet_faces=MIXED)
    P = 2
    m = np.asarray(mesh.boundary_dof_marker(P)).reshape(
        mesh.lattice_shape(P))
    assert m[0].all() and not m[-1, 1:-1, 1:-1].any()  # x: D low, N high
    assert not m[1:-1, 0, 1:-1].any() and not m[1:-1, -1, 1:-1].any()  # y: N
    assert m[:, :, 0].all() and m[:, :, -1].all()  # z: D both


@pytest.mark.parametrize("operator", ["kron", "lattice", "dofmap"])
def test_operator_oracle_parity_mixed(operator):
    """Every backend's apply == the scipy-assembled matrix with the
    flag-derived marker (identity rows at Dirichlet dofs only)."""
    from pmg_dolfinx_jax.ops.kron import KronLaplacian
    from pmg_dolfinx_jax.ops.laplacian import MatFreeLaplacian
    from pmg_dolfinx_jax.ops.lattice import LatticeLaplacian

    mesh = BoxMesh((3, 4, 3), dirichlet_faces=MIXED)
    P, kappa = 3, 2.0
    op = {"kron": KronLaplacian, "lattice": LatticeLaplacian,
          "dofmap": MatFreeLaplacian}[operator](
        mesh, P, kappa=kappa, dtype=jnp.float64)
    A = assemble_stiffness(mesh, P, kappa=kappa)
    u = np.random.default_rng(0).standard_normal(mesh.num_dofs(P))
    y = np.asarray(op(jnp.asarray(u)))
    assert np.allclose(y, A @ u, atol=1e-11), np.abs(y - A @ u).max()


@pytest.mark.parametrize("faces", [
    MIXED,
    ((False, False), (True, True), (True, True)),  # Neumann x-walls
])
def test_manufactured_solution_mixed(faces):
    """FCG(V) solve against the mixed-BC manufactured solution —
    discretization-level L2 error."""
    mesh = BoxMesh((6, 6, 6), dirichlet_faces=faces)
    kappa = 2.0
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=kappa, coarse="fdm",
                        operator="kron")
    b = assemble_rhs(mesh, 3, f_rhs_mixed(kappa, faces))
    u, it = hier.solve_pcg(jnp.asarray(b), rtol=1e-10, maxiter=30)
    err = l2_error(mesh, 3, np.asarray(u), u_exact_mixed(faces))
    # Discretization error at p=3, 6^3 cells; measured O(h^4)
    # convergence across 4/6/8/12 cells (6.4e-5 / 1.3e-5 / 4.0e-6 /
    # 7.8e-7 for the D-N/N-N/D-D case).
    assert err < 5e-5, (err, it)


def test_fdm_exact_mixed_and_pure_neumann_shifted():
    """FDM direct solve with mixed trims == assembled solve; the pure
    Neumann + sigma>0 (screened Poisson) case included."""
    import scipy.sparse.linalg as spla

    for faces, sigma in (
        (MIXED, 0.0),
        (((False, False),) * 3, 7.0),  # pure Neumann, shifted
    ):
        mesh = BoxMesh((4, 3, 4), dirichlet_faces=faces)
        P, kappa = 3, 2.0
        fd = FastDiagonalizationSolver(mesh, P, kappa=kappa,
                                       dtype=jnp.float64, sigma=sigma)
        b = np.random.default_rng(1).standard_normal(mesh.num_dofs(P))
        bc = np.asarray(mesh.boundary_dof_marker(P))
        b[bc] = 0.0
        from pmg_dolfinx_jax.fem.assembly import lumped_mass_np

        A = assemble_stiffness(mesh, P, kappa=kappa).tolil()
        if sigma:
            m = lumped_mass_np(mesh, P, bc_zero=True)
            A.setdiag(A.diagonal() + sigma * m)
        u = np.asarray(fd.solve(b))
        r = A.tocsr() @ u - b
        assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-12


def test_fdm_singular_pure_neumann_raises():
    mesh = BoxMesh((3, 3, 3), dirichlet_faces=((False, False),) * 3)
    with pytest.raises(ValueError, match="singular"):
        FastDiagonalizationSolver(mesh, 2, kappa=1.0, dtype=jnp.float64)
    with pytest.raises(ValueError, match="singular"):
        PMGHierarchy(mesh, degrees=(1, 2), kappa=1.0, coarse="cg")


def test_hmg_coarse_mixed_matches_direct():
    """The h-MG coarse on a mixed-BC mesh (flags propagate to every
    coarsened level) matches the exact direct coarse trajectory."""
    mesh = BoxMesh((8, 8, 8), dirichlet_faces=MIXED)
    kappa = 2.0
    b = np.random.default_rng(2).standard_normal(mesh.num_dofs(3))
    tr = {}
    for coarse in ("direct", "hmg"):
        hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=kappa,
                            coarse=coarse, operator="kron")
        _, tr[coarse] = hier.solve(jnp.asarray(b), num_cycles=6)
    # The nested h-cycles approximate the exact coarse solve closely
    # enough that trajectories agree to ~1e-3 relative (measured; same
    # behavior as the all-Dirichlet case).
    assert np.allclose(tr["hmg"], tr["direct"], rtol=5e-3), tr
    assert tr["hmg"][-1] < 0.05 * tr["hmg"][0], tr["hmg"]


def test_schwarz_mixed_dense_matches_batched_and_smooths():
    from pmg_dolfinx_jax.solvers.schwarz import (
        build_schwarz,
        schwarz_precond_apply,
    )

    mesh = BoxMesh((4, 3, 4), dirichlet_faces=MIXED)
    P = 3
    sw = build_schwarz(mesh, P, 2.0, jnp.float64, form="both")
    r = jnp.asarray(
        np.random.default_rng(3).standard_normal(mesh.num_dofs(P)))
    shape = mesh.lattice_shape(P)
    dense = schwarz_precond_apply(sw, r, shape, P, form="dense")
    batched = schwarz_precond_apply(sw, r, shape, P, form="batched")
    assert np.allclose(np.asarray(dense), np.asarray(batched), atol=1e-12)
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=2.0, coarse="fdm",
                        operator="kron", smoother="schwarz")
    b = assemble_rhs(mesh, 3, f_rhs_mixed(2.0, MIXED))
    _, rn = hier.solve(jnp.asarray(b), num_cycles=8)
    assert rn[-1] < 1e-6 * rn[0], rn  # ~0.13/cycle contraction measured


def test_sharded_mixed_matches_single():
    """Mixed-BC markers flow through the distributed layouts: DistPMG
    (fdm coarse, both gathered and pencil-distributed) and GridPMG are
    trajectory-exact vs single device."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    mesh = BoxMesh((8, 4, 4), dirichlet_faces=MIXED)
    kappa = 2.0
    b = np.random.default_rng(4).standard_normal(mesh.num_dofs(3))
    single = PMGHierarchy(mesh, degrees=(1, 3), kappa=kappa,
                          coarse="fdm", operator="kron")
    _, rn_s = single.solve(jnp.asarray(b), num_cycles=5)
    for make in (
        lambda: DistPMG(mesh, n_devices=4, degrees=(1, 3), kappa=kappa,
                        coarse="fdm", operator="kron"),
        lambda: DistPMG(mesh, n_devices=4, degrees=(1, 3), kappa=kappa,
                        coarse="fdm", coarse_cfg=dict(dist=True),
                        operator="kron"),
        lambda: GridPMG(mesh, shards=(2, 2, 1), degrees=(1, 3),
                        kappa=kappa, coarse="fdm",
                        coarse_cfg=dict(dist=True)),
    ):
        dist = make()
        _, rn_d = dist.solve(b, num_cycles=5)
        assert np.allclose(rn_d, rn_s, rtol=1e-9), (rn_s, rn_d)


def test_dist_fdm_mixed_matches_single():
    from pmg_dolfinx_jax.parallel.fdm_dist import DistFDM

    mesh = BoxMesh((6, 4, 8), dirichlet_faces=MIXED)
    P = 2
    b = np.random.default_rng(5).standard_normal(mesh.num_dofs(P))
    ref = FastDiagonalizationSolver(mesh, P, kappa=2.0, dtype=jnp.float64)
    dist = DistFDM(mesh, P, (2, 1, 2), kappa=2.0, dtype=jnp.float64)
    err = np.abs(dist.solve(b) - np.asarray(ref.solve(b))).max()
    assert err < 1e-13, err


def test_kron_f32_mixed_parity():
    """The f32 kron apply (the production dtype) inherits mixed BCs
    through the 3D marker (the 1D axis matrices are raw/no-bc): parity
    vs the assembled system to f32 rounding."""
    from pmg_dolfinx_jax.ops.kron import KronLaplacian

    mesh = BoxMesh((3, 4, 3), dirichlet_faces=MIXED)
    P, kappa = 3, 2.0
    op = KronLaplacian(mesh, P, kappa=kappa, dtype=jnp.float32)
    A = assemble_stiffness(mesh, P, kappa=kappa)
    u = np.random.default_rng(8).standard_normal(mesh.num_dofs(P))
    y = np.asarray(op(jnp.asarray(u, jnp.float32)))
    ref = A @ u
    rel = np.abs(y - ref).max() / np.abs(ref).max()
    assert rel < 1e-5, rel  # f32 matmul rounding


def test_curved_mixed_bc_lattice():
    """General family: curved hexes + mixed faces through the lattice
    backend (marker-generic) — oracle parity + FCG convergence."""
    from pmg_dolfinx_jax.ops.lattice import LatticeLaplacian

    mesh = PerturbedBoxMesh((4, 4, 4), dirichlet_faces=MIXED)
    P, kappa = 3, 2.0
    op = LatticeLaplacian(mesh, P, kappa=kappa, dtype=jnp.float64)
    A = assemble_stiffness(mesh, P, kappa=kappa)
    u = np.random.default_rng(6).standard_normal(mesh.num_dofs(P))
    assert np.allclose(np.asarray(op(jnp.asarray(u))), A @ u, atol=1e-11)
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=kappa, coarse="cg",
                        operator="lattice")
    b = np.random.default_rng(7).standard_normal(mesh.num_dofs(3))
    bc = np.asarray(mesh.boundary_dof_marker(3))
    b[bc] = 0.0
    u, it = hier.solve_pcg(jnp.asarray(b), rtol=1e-8, maxiter=30)
    assert it < 30  # converged before the cap

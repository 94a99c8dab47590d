"""Multi-device tests on the simulated 8-device CPU mesh (SURVEY.md §7 step 6).

Gates mirror the reference's implicit multi-rank contract: every printed
norm must be rank-count invariant (its examples print global norms under
different `srun -n`; SURVEY.md §4), i.e. the sharded operator and V-cycle
must match the single-device results bit-for-tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pmg_dolfinx_jax.fem.mesh import BoxMesh
from pmg_dolfinx_jax.models.poisson import PoissonProblem, f_rhs
from pmg_dolfinx_jax.fem.assembly import assemble_rhs
from pmg_dolfinx_jax.ops.laplacian import MatFreeLaplacian
from pmg_dolfinx_jax.parallel.dist import DistPMG
from pmg_dolfinx_jax.parallel.partition import SlabPartition


def test_partition_roundtrip_and_weights():
    mesh = BoxMesh((8, 3, 2))
    part = SlabPartition(mesh, 4)
    for P in (1, 3):
        u = np.random.default_rng(0).standard_normal(mesh.num_dofs(P))
        ud = part.to_dist(P, u)
        assert np.array_equal(part.from_dist(P, ud), u)
        # Ownership weights count every global dof exactly once.
        w = part.ownership_weights(P)
        assert w.size == ud.size
        assert int(w.sum()) == mesh.num_dofs(P)
        # Weighted dot over the duplicated layout == global dot.
        assert np.allclose((ud.reshape(-1) ** 2 * w.reshape(-1)).sum(), u @ u)


def test_partition_requires_divisibility():
    with pytest.raises(ValueError):
        SlabPartition(BoxMesh((7, 2, 2)), 4)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_dist_operator_matches_single_device(n_dev):
    mesh = BoxMesh((8, 4, 4))
    P = 3
    op = MatFreeLaplacian(mesh, P, kappa=2.0)
    dist = DistPMG(mesh, n_devices=n_dev, degrees=(1, P), kappa=2.0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(mesh.num_dofs(P))
    y_single = np.asarray(op(jnp.asarray(x)))
    xd = dist.to_dist(x)
    yd = dist.operator()(xd)
    y_dist = dist.from_dist(yd)
    assert np.allclose(y_dist, y_single, atol=1e-12)


def test_dist_calibration_matches_single_device():
    """Distributed Lanczos eigenvalue estimates == single-device ones."""
    mesh = BoxMesh((8, 4, 4))
    single = PoissonProblem(nc=(8, 4, 4), degrees=(1, 3), kappa=2.0)
    dist = DistPMG(mesh, n_devices=8, degrees=(1, 3), kappa=2.0)
    for es, ed in zip(single.hierarchy.eigs, dist.eigs):
        assert np.allclose(es[-1], ed[-1], rtol=1e-8)
        assert np.allclose(es[0], ed[0], rtol=1e-6)


def test_dist_pmg_matches_single_device_trajectory():
    """V-cycle residual history on 8 shards == single device (the
    rank-count-invariance gate)."""
    nc = (8, 4, 4)
    kappa = 2.0
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa, coarse="cg")
    u_s, rn_s = single.solve(num_cycles=5)
    dist = DistPMG(single.mesh, n_devices=8, degrees=(1, 3), kappa=kappa, coarse="cg")
    b = assemble_rhs(single.mesh, 3, f_rhs(kappa))
    u_d, rn_d = dist.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-9), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-10)


def test_dist_lattice_matches_single_device():
    """Sharded lattice (structured fast path) backend == single-device dofmap
    trajectory — operator, calibration and full V-cycle."""
    nc = (8, 4, 4)
    kappa = 2.0
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa, coarse="cg")
    u_s, rn_s = single.solve(num_cycles=5)
    dist = DistPMG(single.mesh, n_devices=8, degrees=(1, 3), kappa=kappa,
                   coarse="cg", operator="lattice")
    for es, ed in zip(single.hierarchy.eigs, dist.eigs):
        assert np.allclose(es[-1], ed[-1], rtol=1e-8)
    b = assemble_rhs(single.mesh, 3, f_rhs(kappa))
    u_d, rn_d = dist.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


def test_dist_lattice_operator_matches_single():
    mesh = BoxMesh((8, 4, 4))
    P = 3
    op = MatFreeLaplacian(mesh, P, kappa=2.0)
    dist = DistPMG(mesh, n_devices=4, degrees=(1, P), kappa=2.0,
                   operator="lattice")
    x = np.random.default_rng(3).standard_normal(mesh.num_dofs(P))
    yd = dist.from_dist(dist.operator()(dist.to_dist(x)))
    ys = np.asarray(op(jnp.asarray(x)))
    assert np.allclose(yd, ys, atol=1e-11)


def test_dist_kron_matches_single_device():
    nc = (8, 4, 4)
    kappa = 2.0
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa, coarse="cg")
    u_s, rn_s = single.solve(num_cycles=5)
    dist = DistPMG(single.mesh, n_devices=8, degrees=(1, 3), kappa=kappa,
                   coarse="cg", operator="kron")
    for es, ed in zip(single.hierarchy.eigs, dist.eigs):
        assert np.allclose(es[-1], ed[-1], rtol=1e-8)
    b = assemble_rhs(single.mesh, 3, f_rhs(kappa))
    u_d, rn_d = dist.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


def test_dist_kron_operator_matches_single():
    mesh = BoxMesh((8, 4, 4))
    P = 3
    op = MatFreeLaplacian(mesh, P, kappa=2.0)
    dist = DistPMG(mesh, n_devices=4, degrees=(1, P), kappa=2.0,
                   operator="kron")
    x = np.random.default_rng(5).standard_normal(mesh.num_dofs(P))
    yd = dist.from_dist(dist.operator()(dist.to_dist(x)))
    ys = np.asarray(op(jnp.asarray(x)))
    assert np.allclose(yd, ys, atol=1e-11)


def test_dist_kron_f32_matches_single():
    """Sharded f32 kron backend (the production dtype) == single-device
    f32 trajectories to f32 reduction-order noise."""
    import jax.numpy as jnp

    nc = (8, 4, 4)
    kappa = 2.0
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa, coarse="cg",
                            operator="kron", dtype=jnp.float32)
    u_s, rn_s = single.solve(num_cycles=5)
    dist = DistPMG(single.mesh, n_devices=4, degrees=(1, 3), kappa=kappa,
                   coarse="cg", operator="kron", dtype=jnp.float32)
    b = assemble_rhs(single.mesh, 3, f_rhs(kappa))
    u_d, rn_d = dist.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-4), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-5)


def test_dist_refined_solve_matches_single():
    """Sharded mixed-precision refinement == single-device refinement."""
    import jax.numpy as jnp

    nc = (8, 8, 8)  # isotropic cells (Jacobi-Chebyshev MG degrades on
    # anisotropic cells — same behaviour as the reference smoothers)
    kappa = 2.0
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa, coarse="cg",
                            operator="kron", dtype=jnp.float32)
    u_s, rn_s = single.hierarchy.solve_refined(single.b, num_cycles=12)
    dist = DistPMG(single.mesh, n_devices=8, degrees=(1, 3), kappa=kappa,
                   coarse="cg", operator="kron", dtype=jnp.float32)
    b = assemble_rhs(single.mesh, 3, f_rhs(kappa))
    u_d, rn_d = dist.solve_refined(b, num_cycles=12)
    r0 = np.linalg.norm(b)
    assert rn_d[-1] / r0 < 1e-6, np.array(rn_d) / r0
    assert np.allclose(rn_d, rn_s, rtol=1e-3), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-6)


def test_dist_fdm_coarse_matches_single():
    """Sharded FDM coarse (gather -> redundant exact solve -> slice)
    matches the single-device FDM-coarse trajectory."""
    nc = (8, 8, 8)
    kappa = 2.0
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa, coarse="fdm",
                            operator="kron")
    u_s, rn_s = single.solve(num_cycles=5)
    dist = DistPMG(single.mesh, n_devices=8, degrees=(1, 3), kappa=kappa,
                   coarse="fdm", operator="kron")
    b = assemble_rhs(single.mesh, 3, f_rhs(kappa))
    u_d, rn_d = dist.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-9), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-10)


@pytest.mark.parametrize("coarse", ["direct", "hmg"])
def test_dist_global_coarse_matches_single(coarse):
    """Gathered direct/hmg coarse on the 1D slab partition reproduces the
    single-device trajectories."""
    nc = (8, 4, 4)
    kappa = 2.0
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa,
                            coarse=coarse, operator="kron")
    u_s, rn_s = single.solve(num_cycles=5)
    dist = DistPMG(single.mesh, n_devices=4, degrees=(1, 3), kappa=kappa,
                   coarse=coarse, operator="kron")
    b = assemble_rhs(single.mesh, 3, f_rhs(kappa))
    u_d, rn_d = dist.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


@pytest.mark.parametrize("sigma", [0.0, 37.0])
def test_dist_hmg_distributed_coarse_matches_single(sigma):
    """Non-gathered h-MG coarse (coarse_cfg dist=True): every h-level stays
    in the duplicated-plane slab layout, only the coarsest bottom solve
    gathers. Same h-hierarchy sizes as the single-device build here, so the
    trajectories must match the gathered/single-device hmg coarse."""
    nc = (8, 4, 4)
    kappa = 2.0
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa,
                            coarse="hmg", operator="kron", sigma=sigma)
    u_s, rn_s = single.solve(num_cycles=5)
    dist = DistPMG(single.mesh, n_devices=4, degrees=(1, 3), kappa=kappa,
                   coarse="hmg", coarse_cfg=dict(dist=True),
                   operator="kron", sigma=sigma)
    b = assemble_rhs(single.mesh, 3, f_rhs(kappa, sigma=sigma))
    u_d, rn_d = dist.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-9)


def test_dist_hmg_distributed_coarse_rejects_unalignable():
    """dist=True needs every h-level's x-cells divisible by n_shards; an
    8-shard build of an 8-cell axis cannot coarsen at all -> clear error."""
    from pmg_dolfinx_jax.parallel.dist import build_hmg_dist

    mesh = BoxMesh((8, 4, 4))
    with pytest.raises(ValueError, match="not h-coarsenable"):
        build_hmg_dist(mesh, 8, 1, 2.0, jnp.float64)


def test_dist_solve_pcg_matches_single():
    nc = (8, 4, 4)
    kappa = 2.0
    single = PoissonProblem(nc=nc, degrees=(1, 3), kappa=kappa,
                            coarse="fdm", operator="kron")
    u_s, n_s = single.hierarchy.solve_pcg(single.b, rtol=1e-8)
    dist = DistPMG(single.mesh, n_devices=4, degrees=(1, 3), kappa=kappa,
                   coarse="fdm", operator="kron")
    b = assemble_rhs(single.mesh, 3, f_rhs(kappa))
    u_d, n_d = dist.solve_pcg(b, rtol=1e-8)
    assert n_d == n_s
    assert np.allclose(u_d, np.asarray(u_s), atol=1e-8)


def test_dist_rejects_unknown_coarse():
    with pytest.raises(ValueError, match="unsupported coarse"):
        DistPMG(BoxMesh((8, 4, 4)), n_devices=4, coarse="nope")


def test_dist_rejects_unknown_operator():
    import pytest

    mesh = BoxMesh((4, 4, 4))
    with pytest.raises(ValueError, match="unknown operator"):
        DistPMG(mesh, n_devices=4, degrees=(1, 2), operator="nope")
    with pytest.raises(ValueError, match="unknown operator"):
        DistPMG(mesh, n_devices=4, degrees=(1, 2),
                operator="fused")


def test_dist_solve_resume_matches_uninterrupted():
    """DistPMG.solve(u0=...): 3+2 cycles == 5 straight cycles."""
    nc = (8, 4, 4)
    kappa = 2.0
    dist = DistPMG(BoxMesh(nc), n_devices=4, degrees=(1, 3), kappa=kappa,
                   coarse="cg")
    b = assemble_rhs(BoxMesh(nc), 3, f_rhs(kappa))
    u5, rn5 = dist.solve(b, num_cycles=5)
    u3, _ = dist.solve(b, num_cycles=3)
    u_res, rn_res = dist.solve(b, num_cycles=2, u0=u3)
    assert np.allclose(u_res, u5, atol=1e-12)
    assert np.allclose(rn_res, rn5[3:], rtol=1e-10)

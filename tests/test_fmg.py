"""Full-multigrid (nested-iteration) initial guess tests.

FMG is a beyond-reference feature (the reference's driver iterates from
zero, examples/pmg/main.cpp:362-367): restrict the rhs down the
p-hierarchy, coarse-solve, prolong upward with one truncated V-cycle
per level. These tests pin (a) the guess is much closer than zero,
(b) the stationary iteration started from it stays strictly ahead and
reaches the same solution, (c) it works across operator backends,
coarse solvers, and the shifted/general families.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pmg_dolfinx_jax.fem.assembly import assemble_rhs
from pmg_dolfinx_jax.fem.mesh import BoxMesh, PerturbedBoxMesh
from pmg_dolfinx_jax.models.poisson import f_rhs, kappa_linear
from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

KAPPA = 2.0


def _problem(mesh, P):
    b = assemble_rhs(mesh, P, f_rhs(KAPPA))
    return jnp.asarray(b, dtype=jnp.float64)


@pytest.mark.parametrize("operator,coarse", [
    ("kron", "direct"),
    ("kron", "fdm"),
    ("lattice", "cg"),
    ("dofmap", "direct"),
])
def test_fmg_guess_beats_zero_and_stays_ahead(operator, coarse):
    mesh = BoxMesh((6, 6, 6))
    degrees = (1, 3)
    hier = PMGHierarchy(mesh, degrees=degrees, kappa=KAPPA,
                        dtype=jnp.float64, coarse=coarse,
                        operator=operator)
    b = _problem(mesh, degrees[-1])
    A = hier.operator()
    nb = float(jnp.linalg.norm(b))

    # (a) the FMG guess is far closer than the zero start
    u_fmg = hier._from_work(hier._fmg_guess(hier._to_work(b)))
    r_fmg = float(jnp.linalg.norm(b - A(u_fmg))) / nb
    assert r_fmg < 0.15, r_fmg

    # (b) started from it, every cycle stays strictly ahead of the
    # zero-start trajectory, and both converge to the same solution
    u_a, res_a = hier.solve(b, num_cycles=8, fmg=True)
    u_b, res_b = hier.solve(b, num_cycles=8)
    assert all(ra < rb for ra, rb in zip(res_a, res_b))
    assert res_a[-1] / nb < 1e-6
    assert np.allclose(np.asarray(u_a), np.asarray(u_b),
                       atol=1e-5 * max(1.0, np.abs(u_b).max()))


def test_fmg_three_level_shifted_curved():
    """3-level hierarchy, curved hexes, variable kappa AND sigma shift —
    the fully general family."""
    mesh = PerturbedBoxMesh((6, 6, 6))
    degrees = (1, 2, 4)
    hier = PMGHierarchy(mesh, degrees=degrees, kappa=kappa_linear,
                        dtype=jnp.float64, coarse="direct",
                        operator="lattice", sigma=3.0)
    b = _problem(mesh, degrees[-1])
    A = hier.operator()
    nb = float(jnp.linalg.norm(b))
    u_fmg = hier._from_work(hier._fmg_guess(hier._to_work(b)))
    assert float(jnp.linalg.norm(b - A(u_fmg))) / nb < 0.15
    u, res = hier.solve(b, num_cycles=6, fmg=True)
    _, res0 = hier.solve(b, num_cycles=6)
    assert res[-1] < res0[-1]


def test_fmg_dist_matches_single_device_trajectory():
    """The sharded FMG sweep (restrict rhs through the exchange-aware
    ops, coarse-solve, prolong up) must be trajectory-exact vs the
    single-device one — the rank-count-invariance contract extends to
    the nested iteration."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG

    nc = (8, 4, 4)
    mesh = BoxMesh(nc)
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=KAPPA,
                        dtype=jnp.float64, coarse="cg", operator="kron")
    b = _problem(mesh, 3)
    u_s, rn_s = hier.solve(b, num_cycles=5, fmg=True)
    dist = DistPMG(mesh, n_devices=8, degrees=(1, 3), kappa=KAPPA,
                   coarse="cg", operator="kron")
    u_d, rn_d = dist.solve(b, num_cycles=5, fmg=True)
    assert np.allclose(rn_d, rn_s, rtol=1e-9), (rn_s, rn_d)
    assert np.allclose(np.asarray(u_d), np.asarray(u_s), atol=1e-10)
    # and ahead of the zero-start sharded trajectory
    _, rn_0 = dist.solve(b, num_cycles=5)
    assert all(rf < r0 for rf, r0 in zip(rn_d, rn_0))


def test_fmg_grid_matches_single_device_trajectory():
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    nc = (8, 8, 4)
    mesh = BoxMesh(nc)
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=KAPPA,
                        dtype=jnp.float64, coarse="cg", operator="kron")
    b = _problem(mesh, 3)
    u_s, rn_s = hier.solve(b, num_cycles=5, fmg=True)
    grid = GridPMG(mesh, shards=(2, 2, 2), degrees=(1, 3), kappa=KAPPA,
                   coarse="cg")
    u_d, rn_d = grid.solve(b, num_cycles=5, fmg=True)
    assert np.allclose(rn_d, rn_s, rtol=1e-8), (rn_s, rn_d)
    assert np.allclose(np.asarray(u_d), np.asarray(u_s), atol=1e-9)
    u_p, n_p = grid.solve_pcg(b, rtol=1e-10, fmg=True)
    u_q, n_q = grid.solve_pcg(b, rtol=1e-10)
    assert n_p <= n_q
    assert np.allclose(np.asarray(u_p), np.asarray(u_q),
                       atol=1e-7 * max(1.0, np.abs(np.asarray(u_q)).max()))


def test_fmg_pcg_saves_iterations():
    mesh = BoxMesh((8, 8, 8))
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=KAPPA,
                        dtype=jnp.float64, coarse="direct",
                        operator="kron")
    b = _problem(mesh, 3)
    u0, n0 = hier.solve_pcg(b, rtol=1e-10)
    u1, n1 = hier.solve_pcg(b, rtol=1e-10, fmg=True)
    assert n1 <= n0
    assert np.allclose(np.asarray(u0), np.asarray(u1),
                       atol=1e-7 * max(1.0, np.abs(u0).max()))


def test_fmg_refined_start():
    """solve_refined(fmg=True): the f64 refinement loop started from the
    working-dtype FMG guess is ahead of the zero start at every cycle."""
    mesh = BoxMesh((6, 6, 6))
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=KAPPA,
                        dtype=jnp.float64, coarse="direct",
                        operator="kron")
    b = _problem(mesh, 3)
    u1, r1 = hier.solve_refined(b, num_cycles=5, fmg=True)
    u0, r0 = hier.solve_refined(b, num_cycles=5)
    assert all(a < z for a, z in zip(r1, r0)), (r1, r0)
    # both converge to the same f64 solution when run to tolerance
    nb = float(jnp.linalg.norm(b))
    uc1, rc1 = hier.solve_refined(b, num_cycles=30, rtol=1e-11, fmg=True)
    uc0, rc0 = hier.solve_refined(b, num_cycles=30, rtol=1e-11)
    assert rc1[-1] / nb < 1e-11 and len(rc1) < len(rc0)
    assert np.allclose(np.asarray(uc1), np.asarray(uc0),
                       atol=1e-9 * max(1.0, np.abs(np.asarray(uc0)).max()))


def test_fmg_refined_sharded_matches_single():
    """DistPMG/GridPMG solve_refined(fmg=True): the sharded refined loop
    seeded by the sharded FMG guess matches the single-device one."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    mesh = BoxMesh((8, 4, 4))
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=KAPPA,
                        dtype=jnp.float64, coarse="cg", operator="kron")
    b = _problem(mesh, 3)
    u_s, r_s = hier.solve_refined(b, num_cycles=4, fmg=True)
    dist = DistPMG(mesh, n_devices=4, degrees=(1, 3), kappa=KAPPA,
                   coarse="cg", operator="kron", dtype=jnp.float64)
    u_d, r_d = dist.solve_refined(b, num_cycles=4, fmg=True)
    assert np.allclose(r_d, r_s, rtol=1e-9), (r_s, r_d)
    assert np.allclose(np.asarray(u_d), np.asarray(u_s), atol=1e-11)
    grid = GridPMG(mesh, shards=(2, 2), degrees=(1, 3), kappa=KAPPA,
                   coarse="cg", dtype=jnp.float64)
    u_g, r_g = grid.solve_refined(b, num_cycles=4, fmg=True)
    assert np.allclose(r_g, r_s, rtol=1e-9), (r_s, r_g)
    assert np.allclose(np.asarray(u_g), np.asarray(u_s), atol=1e-11)

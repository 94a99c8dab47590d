"""W-cycle (mu-cycle, gamma=2) tests.

A beyond-reference cycle type (the reference's PMG is V-only,
src/pmg.hpp:56-155): each level visits its coarse sub-hierarchy twice.
Selected via ``coarse_cfg['gamma']`` so every solve path — stationary,
FCG-preconditioned, refined, sharded — runs it through the same generic
`v_cycle`. These tests pin (a) the recursion structure against a manual
composition from the public primitives, (b) the convergence win over V
when the coarse solve is weak, and (c) shard-layout invariance.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pmg_dolfinx_jax.fem.assembly import assemble_rhs
from pmg_dolfinx_jax.fem.mesh import BoxMesh
from pmg_dolfinx_jax.models.poisson import f_rhs
from pmg_dolfinx_jax.solvers.chebyshev import chebyshev4_solve
from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy, v_cycle

KAPPA = 2.0


def _problem(mesh, P):
    b = assemble_rhs(mesh, P, f_rhs(KAPPA))
    return jnp.asarray(b, dtype=jnp.float64)


def test_wcycle_matches_manual_composition():
    """One gamma=2 cycle on a 3-level hierarchy == pre-smooth + restrict
    + TWO 2-level V-cycles on the sub-hierarchy + prolong + post-smooth,
    composed from the same public primitives."""
    mesh = BoxMesh((4, 4, 4))
    degrees = (1, 2, 4)
    hier = PMGHierarchy(mesh, degrees=degrees, kappa=KAPPA,
                        dtype=jnp.float64, coarse="direct",
                        operator="kron")
    b = hier._to_work(_problem(mesh, degrees[-1]))
    u0 = jnp.zeros_like(b)

    got = v_cycle(hier.data, b, u0, levels=hier.levels, coarse="direct",
                  coarse_cfg={"gamma": 2}, ops=hier.ops)

    ops, data, levels = hier.ops, hier.data, hier.levels
    lvs = data["levels"]
    smooth = lambda lv, bb, x, level: chebyshev4_solve(
        lambda t: ops["apply"](lv, t, level), bb, x,
        lv["diag_inv"], lv["lmax"], level.smoother_iters)
    u = smooth(lvs[2], b, u0, levels[2])
    r = b - ops["apply"](lvs[2], u, levels[2])
    b_c = ops["restrict"](data["transfer"][1], r, levels[1], levels[2])
    sub = dict(data, levels=lvs[:2], transfer=data["transfer"][:1])
    u_c = jnp.zeros(levels[1].ndofs, dtype=b.dtype).reshape(jnp.shape(b_c))
    for _ in range(2):
        u_c = v_cycle(sub, b_c, u_c, levels=levels[:2], coarse="direct",
                      coarse_cfg={}, ops=ops)
    du = ops["prolong"](data["transfer"][1], u_c, levels[1], levels[2])
    want = smooth(lvs[2], b, u + du, levels[2])

    assert np.allclose(np.asarray(got), np.asarray(want),
                       atol=1e-14, rtol=1e-14)


def test_gamma1_is_the_v_cycle():
    mesh = BoxMesh((4, 4, 4))
    hier = PMGHierarchy(mesh, degrees=(1, 2, 4), kappa=KAPPA,
                        dtype=jnp.float64, coarse="direct",
                        operator="kron")
    b = hier._to_work(_problem(mesh, 4))
    u0 = jnp.zeros_like(b)
    u_v = v_cycle(hier.data, b, u0, levels=hier.levels, coarse="direct",
                  coarse_cfg={}, ops=hier.ops)
    u_g1 = v_cycle(hier.data, b, u0, levels=hier.levels, coarse="direct",
                   coarse_cfg={"gamma": 1}, ops=hier.ops)
    assert np.array_equal(np.asarray(u_v), np.asarray(u_g1))


@pytest.mark.parametrize("operator", ["kron", "lattice"])
def test_wcycle_beats_v_with_weak_coarse(operator):
    """With an under-resolved coarse solve (coarse='smoother') the extra
    coarse visits must pay: the gamma=2 trajectory leads the V-cycle one
    at every cycle, and both reach the same solution."""
    mesh = BoxMesh((6, 6, 6))
    degrees = (1, 2, 4)
    kw = dict(degrees=degrees, kappa=KAPPA, dtype=jnp.float64,
              coarse="smoother", operator=operator)
    hv = PMGHierarchy(mesh, **kw)
    hw = PMGHierarchy(mesh, coarse_cfg={"gamma": 2}, **kw)
    b = _problem(mesh, degrees[-1])
    u_v, res_v = hv.solve(b, num_cycles=8)
    u_w, res_w = hw.solve(b, num_cycles=8)
    assert all(rw < rv for rw, rv in zip(res_w, res_v)), (res_w, res_v)
    assert res_w[-1] < 0.5 * res_v[-1]


def test_wcycle_pcg_and_refined():
    mesh = BoxMesh((6, 6, 6))
    kw = dict(degrees=(1, 2, 4), kappa=KAPPA, dtype=jnp.float64,
              coarse="smoother", operator="kron")
    hv = PMGHierarchy(mesh, **kw)
    hw = PMGHierarchy(mesh, coarse_cfg={"gamma": 2}, **kw)
    b = _problem(mesh, 4)
    u_v, n_v = hv.solve_pcg(b, rtol=1e-10)
    u_w, n_w = hw.solve_pcg(b, rtol=1e-10)
    assert n_w <= n_v
    assert np.allclose(np.asarray(u_w), np.asarray(u_v),
                       atol=1e-7 * max(1.0, np.abs(np.asarray(u_v)).max()))
    r_v = hv.solve_refined(b, num_cycles=6)[1]
    r_w = hw.solve_refined(b, num_cycles=6)[1]
    assert r_w[-1] < r_v[-1]


def test_wcycle_sharded_matches_single_device():
    """DistPMG and GridPMG with coarse_cfg gamma=2: trajectory-exact vs
    the single-device W-cycle (shard-layout invariance extends to the
    recursive cycle shape)."""
    from pmg_dolfinx_jax.parallel.dist import DistPMG
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    mesh = BoxMesh((8, 8, 4))
    degrees = (1, 2, 4)
    kw = dict(degrees=degrees, kappa=KAPPA, coarse="cg",
              coarse_cfg={"gamma": 2})
    hier = PMGHierarchy(mesh, dtype=jnp.float64, operator="kron", **kw)
    b = _problem(mesh, degrees[-1])
    u_s, rn_s = hier.solve(b, num_cycles=5)
    dist = DistPMG(mesh, n_devices=8, operator="kron", **kw)
    u_d, rn_d = dist.solve(b, num_cycles=5)
    assert np.allclose(rn_d, rn_s, rtol=1e-9), (rn_s, rn_d)
    assert np.allclose(np.asarray(u_d), np.asarray(u_s), atol=1e-10)
    grid = GridPMG(mesh, shards=(2, 2, 2), **kw)
    u_g, rn_g = grid.solve(b, num_cycles=5)
    assert np.allclose(rn_g, rn_s, rtol=1e-8), (rn_s, rn_g)
    assert np.allclose(np.asarray(u_g), np.asarray(u_s), atol=1e-9)

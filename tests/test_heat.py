"""Transient heat equation (solvers/transient.py): implicit stepping on
the shifted family — beyond the reference's steady-only drivers.

The kron path runs the whole time loop as one scanned XLA program with
an exact FDM direct solve per step (sigma = 1/dt); the general path
steps through the shifted PMG hierarchy with FCG. Pins: the classic
convergence orders (backward Euler O(dt), Crank-Nicolson O(dt^2))
against the analytic separable decay mode, exact agreement between the
FDM and FCG step solvers, and grading invariance of the orders."""

import jax.numpy as jnp
import numpy as np
import pytest

from pmg_dolfinx_jax.fem.assembly import l2_error
from pmg_dolfinx_jax.fem.mesh import BoxMesh, geometric_spacing
from pmg_dolfinx_jax.solvers.transient import heat_fdm_evolve, heat_pcg_evolve

KAPPA, T = 1.0, 0.02
LAM = 3.0 * np.pi**2 * KAPPA


def _mode(mesh, P):
    c = mesh.dof_coords(P)
    return (np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
            * np.sin(np.pi * c[:, 2]))


def _u_exact(x):
    return (np.exp(-LAM * T) * np.sin(np.pi * x[0]) * np.sin(np.pi * x[1])
            * np.sin(np.pi * x[2]))


def _orders(mesh, P, scheme):
    u0 = _mode(mesh, P)
    errs = []
    for nsteps in (4, 8, 16):
        evolve = heat_fdm_evolve(mesh, P, kappa=KAPPA, dt=T / nsteps,
                                 scheme=scheme)
        uT = np.asarray(evolve(u0, nsteps)).reshape(-1)
        errs.append(l2_error(mesh, P, uT, _u_exact))
    return [np.log2(errs[i] / errs[i + 1]) for i in range(2)]


@pytest.mark.parametrize("scheme,order", [("be", 1.0), ("cn", 2.0)])
def test_fdm_time_orders(scheme, order):
    """BE is O(dt), CN is O(dt^2) against the analytic decay (p=4
    spatial error is negligible at these step sizes)."""
    mesh = BoxMesh((6, 6, 6))
    for o in _orders(mesh, 4, scheme):
        assert abs(o - order) < 0.25, (scheme, o)


def test_cn_order_graded():
    """The scanned FDM stepping keeps its O(dt^2) order on a graded
    mesh (the direct solve is exact on the graded pencils)."""
    mesh = BoxMesh((6, 6, 6), spacing=(geometric_spacing(6, 3.0),) * 3)
    for o in _orders(mesh, 4, "cn"):
        assert abs(o - 2.0) < 0.25, o


@pytest.mark.parametrize("scheme", ["be", "cn"])
def test_pcg_path_matches_fdm(scheme):
    """The general-family FCG step solver reproduces the FDM path's
    discrete trajectory (same scheme, tight per-step tolerance)."""
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    mesh = BoxMesh((6, 6, 6))
    P, dt, nsteps = 3, 0.005, 4
    u0 = _mode(mesh, P)
    u_fdm = np.asarray(
        heat_fdm_evolve(mesh, P, kappa=KAPPA, dt=dt, scheme=scheme)(
            u0, nsteps)).reshape(-1)
    kap_op = KAPPA / 2 if scheme == "cn" else KAPPA
    hier = PMGHierarchy(mesh, degrees=(1, P), kappa=kap_op, sigma=1.0 / dt,
                        dtype=jnp.float64, coarse="fdm")
    u_pcg, iters = heat_pcg_evolve(hier, mesh, P, dt, scheme=scheme,
                                   rtol=1e-11)(u0, nsteps)
    assert np.abs(np.asarray(u_pcg) - u_fdm).max() < 1e-10
    assert max(iters) <= 10, iters


def test_curved_transient_runs():
    """Curved-hex transient stepping (shifted lattice hierarchy): the
    step count drops the error toward the analytic decay within the
    Q1-geometry spatial accuracy of the coarse distorted mesh."""
    from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    mesh = PerturbedBoxMesh((4, 4, 4))
    P, dt, nsteps = 3, 0.005, 4
    u0 = _mode(mesh, P)
    hier = PMGHierarchy(mesh, degrees=(1, P), kappa=KAPPA / 2,
                        sigma=1.0 / dt, dtype=jnp.float64, coarse="cg",
                        operator="lattice")
    uT, iters = heat_pcg_evolve(hier, mesh, P, dt, scheme="cn",
                                rtol=1e-9)(u0, nsteps)
    assert l2_error(mesh, P, np.asarray(uT), _u_exact) < 0.05
    assert max(iters) <= 15, iters


def test_steady_state_with_source():
    """A time-independent source drives the BE iteration to the steady
    Poisson solution K u = b (long-time limit)."""
    import scipy.sparse.linalg as spla

    from pmg_dolfinx_jax.fem.assembly import assemble_rhs, assemble_stiffness
    from pmg_dolfinx_jax.models.poisson import f_rhs

    mesh = BoxMesh((5, 5, 5))
    P = 3
    b = assemble_rhs(mesh, P, f_rhs(KAPPA))
    evolve = heat_fdm_evolve(mesh, P, kappa=KAPPA, dt=0.05, scheme="be",
                             f=b)
    uT = np.asarray(evolve(np.zeros(mesh.num_dofs(P)), 200)).reshape(-1)
    A = assemble_stiffness(mesh, P, kappa=KAPPA)
    u_steady = spla.spsolve(A.tocsc(), b)
    rel = np.linalg.norm(uT - u_steady) / np.linalg.norm(u_steady)
    assert rel < 1e-6, rel


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("scheme", ["be", "cn"])
def test_packed_transient_matches_per_rhs(scheme, B):
    """The batched evolve (jax.vmap of the scanned FDM stepper, one
    program for the whole batch) reproduces the per-RHS scanned FDM
    trajectories to f32 precision for every column, B=1 included."""
    from pmg_dolfinx_jax.solvers.transient import batch_evolve

    mesh = BoxMesh((6, 6, 6))
    P, dt, nsteps = 3, 0.002, 5
    rng = np.random.default_rng(0)
    U0 = rng.standard_normal((B, mesh.num_dofs(P))).astype(np.float32)
    U0[:, np.asarray(mesh.boundary_dof_marker(P))] = 0.0
    ev1 = heat_fdm_evolve(mesh, P, kappa=KAPPA, dt=dt, scheme=scheme,
                          dtype=jnp.float32)
    ref = np.stack([np.asarray(ev1(U0[k], nsteps)).reshape(-1)
                    for k in range(B)])
    UT = np.asarray(batch_evolve(ev1)(U0, nsteps))
    assert UT.shape == U0.shape
    rel = np.linalg.norm(UT - ref) / np.linalg.norm(ref)
    assert rel < 2e-5, rel


def test_packed_transient_interpret_kernel():
    """One batched step at the f32 working precision agrees with the
    f64 batched step (the dtype reaches every array of the stepper)."""
    from pmg_dolfinx_jax.solvers.transient import batch_evolve

    mesh = BoxMesh((4, 4, 4))
    P, dt, B = 2, 0.01, 2
    rng = np.random.default_rng(1)
    U0 = rng.standard_normal((B, mesh.num_dofs(P)))
    U0[:, np.asarray(mesh.boundary_dof_marker(P))] = 0.0
    ev32 = batch_evolve(heat_fdm_evolve(mesh, P, dt=dt, dtype=jnp.float32))
    ev64 = batch_evolve(heat_fdm_evolve(mesh, P, dt=dt, dtype=jnp.float64))
    UT_32 = np.asarray(ev32(U0.astype(np.float32), 1))
    UT_64 = np.asarray(ev64(U0, 1))
    assert UT_32.dtype == np.float32 and UT_64.dtype == np.float64
    rel = (np.linalg.norm(UT_32 - UT_64)
           / np.linalg.norm(UT_64))
    assert rel < 1e-5, rel


def test_snapshot_evolve_matches_long_run():
    """Chunked trajectory sampling (`snapshot_evolve`): for Markov-in-u
    schemes (heat CN) every snapshot equals the one-shot run to the
    same step EXACTLY; tuple states (wave Newmark) thread through; the
    ragged tail chunk and argument validation work."""
    import pytest

    from pmg_dolfinx_jax.solvers.transient import (snapshot_evolve,
                                                   wave_newmark_evolve)

    mesh = BoxMesh((5, 5, 5))
    P, dt = 3, 0.01
    c = mesh.dof_coords(P)
    u0 = np.where(np.asarray(mesh.boundary_dof_marker(P)), 0.0,
                  np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
                  * np.sin(np.pi * c[:, 2]))
    ev = heat_fdm_evolve(mesh, P, kappa=KAPPA, dt=dt)
    snaps, uT = snapshot_evolve(ev, u0, 7, 3)   # chunks 3, 3, 1
    assert [s for s, _ in snaps] == [3, 6, 7]
    for step, u in snaps:
        ref = np.asarray(ev(u0, step))
        assert np.array_equal(np.asarray(u), ref), step
    assert np.array_equal(np.asarray(uT), np.asarray(ev(u0, 7)))

    # tuple state (wave): restart consistency ~ fp-level
    wv = wave_newmark_evolve(mesh, P, kappa=KAPPA, dt=dt)
    snaps_w, (uw, vw) = snapshot_evolve(wv, (u0, np.zeros_like(u0)), 6, 2)
    ur, vr = wv(u0, np.zeros_like(u0), 6)
    assert np.linalg.norm(np.asarray(uw) - np.asarray(ur)) < \
        1e-9 * max(np.linalg.norm(np.asarray(ur)), 1e-30)

    with pytest.raises(ValueError, match="every"):
        snapshot_evolve(ev, u0, 5, 0)


def test_scanned_general_stepper_matches_adaptive():
    """heat_pcg_evolve_scanned (one lax.scan, fixed inner FCG count)
    tracks the adaptive host-loop trajectory to solver tolerance on a
    curved mesh with variable kappa (VERDICT r4 item 9)."""
    from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy
    from pmg_dolfinx_jax.solvers.transient import (
        heat_pcg_evolve,
        heat_pcg_evolve_scanned,
    )

    mesh = PerturbedBoxMesh((4, 4, 4))
    P, dt = 3, 1e-3
    kap = lambda x: 1.0 + 0.5 * np.sin(2 * x[0])
    hier = PMGHierarchy(mesh, degrees=(1, P), kappa=kap, coarse="direct",
                        operator="lattice", sigma=1.0 / dt)
    c = mesh.dof_coords(P)
    u0 = (np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
          * np.sin(np.pi * c[:, 2]))
    u_h, _ = heat_pcg_evolve(hier, mesh, P, dt, scheme="be",
                             rtol=1e-10)(u0, 8)
    u_s = heat_pcg_evolve_scanned(hier, mesh, P, dt, scheme="be",
                                  inner_iters=6)(u0, 8)
    rel = (np.linalg.norm(np.asarray(u_s) - np.asarray(u_h))
           / np.linalg.norm(np.asarray(u_h)))
    assert rel < 1e-7

    with pytest.raises(ValueError, match="kron"):
        from pmg_dolfinx_jax.fem.mesh import BoxMesh

        hk = PMGHierarchy(BoxMesh((3, 3, 3)), degrees=(1, 2), kappa=2.0,
                          coarse="direct", operator="kron",
                          sigma=1.0 / dt)
        heat_pcg_evolve_scanned(hk, BoxMesh((3, 3, 3)), 2, dt)

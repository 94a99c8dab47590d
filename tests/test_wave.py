"""Wave equation ``u_tt - div(kappa grad u) = f`` (solvers/transient.py
wave_*): implicit Newmark-beta on the shifted family (sigma =
1/(beta dt^2), one exact FDM solve per step) and explicit leapfrog (one
kron apply per step, stability bound straight from the FDM eigenvalue
sums). Pins: O(dt^2) for average acceleration and leapfrog against the
analytic standing wave, O(dt) with algorithmic damping (gamma > 1/2),
EXACT discrete-energy conservation, FDM/FCG trajectory agreement, and
grading invariance of the order."""

import jax.numpy as jnp
import numpy as np
import pytest

from pmg_dolfinx_jax.fem.assembly import l2_error, lumped_mass_np
from pmg_dolfinx_jax.fem.mesh import BoxMesh, geometric_spacing
from pmg_dolfinx_jax.solvers.transient import (
    wave_leapfrog_evolve, wave_newmark_evolve, wave_pcg_evolve,
    wave_stable_dt)

KAPPA, T = 1.0, 0.2
OMEGA = np.pi * np.sqrt(3.0 * KAPPA)


def _mode(mesh, P):
    c = mesh.dof_coords(P)
    return (np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
            * np.sin(np.pi * c[:, 2]))


def _u_exact(x):
    return (np.cos(OMEGA * T) * np.sin(np.pi * x[0])
            * np.sin(np.pi * x[1]) * np.sin(np.pi * x[2]))


def _newmark_orders(mesh, P, gamma, steps=(4, 8, 16)):
    u0 = _mode(mesh, P)
    v0 = np.zeros_like(u0)
    errs = []
    for nsteps in steps:
        evolve = wave_newmark_evolve(mesh, P, kappa=KAPPA, dt=T / nsteps,
                                     gamma=gamma)
        uT, _ = evolve(u0, v0, nsteps)
        errs.append(l2_error(mesh, P, np.asarray(uT).reshape(-1), _u_exact))
    return [np.log2(errs[i] / errs[i + 1]) for i in range(len(errs) - 1)]


@pytest.mark.parametrize("gamma,order", [(0.5, 2.0), (0.75, 1.0)])
def test_newmark_time_orders(gamma, order):
    """Average acceleration (gamma=1/2) is O(dt^2); algorithmic damping
    (gamma=3/4) drops to O(dt) — against the analytic standing wave
    cos(omega t) sin(pi x) sin(pi y) sin(pi z), omega = pi sqrt(3 kappa)
    (p=4 spatial error is negligible at these step sizes)."""
    mesh = BoxMesh((6, 6, 6))
    for o in _newmark_orders(mesh, 4, gamma):
        assert abs(o - order) < 0.3, (gamma, o)


def test_newmark_order_graded():
    """O(dt^2) survives graded spacing (the shifted FDM step solve is
    exact on the graded pencils)."""
    mesh = BoxMesh((6, 6, 6), spacing=(geometric_spacing(6, 3.0),) * 3)
    for o in _newmark_orders(mesh, 4, 0.5):
        assert abs(o - 2.0) < 0.3, o


def test_newmark_energy_conservation():
    """(beta, gamma) = (1/4, 1/2) conserves E = (v^T M v + u^T K u)/2
    EXACTLY (trapezoidal rule on a linear system): relative drift at
    f64 over 100 steps is at rounding level. With gamma > 1/2 the
    scheme is dissipative: E decreases monotonically."""
    from pmg_dolfinx_jax.ops.kron import KronLaplacian

    mesh = BoxMesh((5, 5, 5))
    P, dt, nsteps = 3, 0.02, 100
    u0 = _mode(mesh, P)
    v0 = np.zeros_like(u0)
    m3 = lumped_mass_np(mesh, P, bc_zero=True)
    op = KronLaplacian(mesh, P, kappa=KAPPA, dtype=jnp.float64)

    def energy(u, v):
        u = np.asarray(u).reshape(-1)
        v = np.asarray(v).reshape(-1)
        Ku = np.asarray(op(jnp.asarray(u))).reshape(-1)
        return 0.5 * (v @ (m3 * v) + u @ Ku)

    E0 = energy(u0, v0)
    evolve = wave_newmark_evolve(mesh, P, kappa=KAPPA, dt=dt)
    Es = [energy(*evolve(u0, v0, n)) for n in (1, 10, 50, nsteps)]
    for E in Es:
        assert abs(E - E0) < 1e-11 * E0, (E, E0)

    evolve_d = wave_newmark_evolve(mesh, P, kappa=KAPPA, dt=dt, gamma=0.8)
    Ed = [energy(*evolve_d(u0, v0, n)) for n in (1, 10, 50)]
    assert Ed[0] < E0 and Ed[1] < Ed[0] and Ed[2] < Ed[1], (E0, Ed)


def test_leapfrog_order_and_stability_bound():
    """Leapfrog at dt = 0.72 dt_max is O(dt^2) against the analytic
    wave; just past the spectral bound (1.02 dt_max) it blows up —
    wave_stable_dt's lambda_max comes from the exact FDM
    diagonalization, so the edge is sharp."""
    mesh = BoxMesh((6, 6, 6))
    P = 4
    u0 = _mode(mesh, P)
    v0 = np.zeros_like(u0)
    dt_max = wave_stable_dt(mesh, P, kappa=KAPPA)
    n0 = int(np.ceil(T / (0.72 * dt_max)))
    errs = []
    for nsteps in (n0, 2 * n0, 4 * n0):
        evolve = wave_leapfrog_evolve(mesh, P, kappa=KAPPA, dt=T / nsteps)
        uT, _ = evolve(u0, v0, nsteps)
        errs.append(l2_error(mesh, P, np.asarray(uT).reshape(-1), _u_exact))
    for i in range(2):
        o = np.log2(errs[i] / errs[i + 1])
        assert abs(o - 2.0) < 0.35, (errs, o)

    dt_bad = 1.02 * dt_max
    nbad = 200
    evolve = wave_leapfrog_evolve(mesh, P, kappa=KAPPA, dt=dt_bad)
    uT, _ = evolve(u0, v0, nbad)
    assert not np.all(np.abs(np.asarray(uT)) < 1e3)


def test_leapfrog_rejects_zero_steps():
    """nsteps=0 raises a clear ValueError up front (ADVICE r3: it used
    to die inside source_scales with an opaque np.ones(-1) error), on
    the single-device and the sharded leapfrog alike."""
    import pytest

    from pmg_dolfinx_jax.parallel.transient_dist import (
        wave_leapfrog_dist_evolve)

    mesh, P = BoxMesh((4, 3, 3)), 2
    u0 = np.zeros(mesh.num_dofs(P))
    with pytest.raises(ValueError, match="nsteps >= 1"):
        wave_leapfrog_evolve(mesh, P, kappa=KAPPA, dt=1e-3)(u0, u0, 0)
    with pytest.raises(ValueError, match="nsteps >= 1"):
        wave_leapfrog_dist_evolve(mesh, P, 2, kappa=KAPPA,
                                  dt=1e-3)(u0, u0, 0)


def test_leapfrog_matches_newmark_trajectory():
    """Small-dt cross-check: the two O(dt^2) integrators agree with
    each other to O(dt^2) on a short horizon (distinct update formulas,
    same semi-discrete system)."""
    mesh = BoxMesh((5, 5, 5))
    P = 3
    u0 = _mode(mesh, P)
    v0 = np.zeros_like(u0)
    dt = 0.5 * wave_stable_dt(mesh, P, kappa=KAPPA)
    nsteps = 20
    u_n, _ = wave_newmark_evolve(mesh, P, kappa=KAPPA, dt=dt)(u0, v0, nsteps)
    u_l, _ = wave_leapfrog_evolve(mesh, P, kappa=KAPPA, dt=dt)(u0, v0, nsteps)
    ref = np.abs(np.asarray(u_n)).max()
    assert np.abs(np.asarray(u_n) - np.asarray(u_l)).max() < 0.05 * ref


@pytest.mark.parametrize("gamma", [0.5, 0.75])
def test_pcg_path_matches_fdm(gamma):
    """The general-family FCG Newmark stepper reproduces the FDM path's
    discrete trajectory (u AND v) at tight per-step tolerance."""
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    mesh = BoxMesh((6, 6, 6))
    P, dt, nsteps = 3, 0.02, 5
    beta = 0.25
    u0 = _mode(mesh, P)
    v0 = 0.3 * _mode(mesh, P)
    u_f, v_f = wave_newmark_evolve(mesh, P, kappa=KAPPA, dt=dt,
                                   gamma=gamma)(u0, v0, nsteps)
    hier = PMGHierarchy(mesh, degrees=(1, P), kappa=KAPPA,
                        sigma=1.0 / (beta * dt * dt), dtype=jnp.float64,
                        coarse="fdm")
    u_p, v_p, iters = wave_pcg_evolve(hier, mesh, P, dt, gamma=gamma,
                                      rtol=1e-12)(u0, v0, nsteps)
    assert np.abs(np.asarray(u_p).reshape(-1)
                  - np.asarray(u_f).reshape(-1)).max() < 1e-9
    assert np.abs(np.asarray(v_p).reshape(-1)
                  - np.asarray(v_f).reshape(-1)).max() < 1e-7
    assert max(iters) <= 12, iters


def test_curved_wave_runs():
    """Curved-hex Newmark stepping (shifted lattice hierarchy) tracks
    the analytic standing wave within the Q1-geometry spatial accuracy
    of the coarse distorted mesh."""
    from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    mesh = PerturbedBoxMesh((4, 4, 4))
    P, nsteps = 3, 8
    dt = T / nsteps
    u0 = _mode(mesh, P)
    v0 = np.zeros_like(u0)
    hier = PMGHierarchy(mesh, degrees=(1, P), kappa=KAPPA,
                        sigma=1.0 / (0.25 * dt * dt), dtype=jnp.float64,
                        coarse="cg", operator="lattice")
    uT, _, iters = wave_pcg_evolve(hier, mesh, P, dt, rtol=1e-9)(
        u0, v0, nsteps)
    assert l2_error(mesh, P, np.asarray(uT), _u_exact) < 0.05
    assert max(iters) <= 15, iters


def test_mixed_faces_energy():
    """Energy conservation holds with a natural (Neumann) face in the
    mix — the FDM shift and the kron apply share the same trimmed
    eigenstructure, and the conserved quantity doesn't care which faces
    are essential."""
    from pmg_dolfinx_jax.ops.kron import KronLaplacian

    faces = ((True, False), (True, True), (True, True))
    mesh = BoxMesh((5, 5, 5), dirichlet_faces=faces)
    P, dt = 3, 0.02
    rng = np.random.default_rng(7)
    bc = np.asarray(mesh.boundary_dof_marker(P)).reshape(-1)
    u0 = np.where(bc, 0.0, rng.standard_normal(bc.size))
    v0 = np.where(bc, 0.0, rng.standard_normal(bc.size))
    m3 = lumped_mass_np(mesh, P, bc_zero=True)
    op = KronLaplacian(mesh, P, kappa=KAPPA, dtype=jnp.float64)

    def energy(u, v):
        u = np.asarray(u).reshape(-1)
        v = np.asarray(v).reshape(-1)
        Ku = np.asarray(op(jnp.asarray(u))).reshape(-1)
        return 0.5 * (v @ (m3 * v) + u @ Ku)

    E0 = energy(u0, v0)
    evolve = wave_newmark_evolve(mesh, P, kappa=KAPPA, dt=dt)
    for n in (1, 25, 50):
        E = energy(*evolve(u0, v0, n))
        assert abs(E - E0) < 1e-11 * E0, (n, E, E0)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("scheme", ["newmark", "leapfrog"])
def test_packed_wave_matches_per_rhs(scheme, B):
    """Batched wave stepping (solvers/transient.py batch_evolve, vmap
    of the scanned stepper) == the per-RHS scanned trajectories to f32
    precision for every column (homogeneous Dirichlet)."""
    import jax.numpy as jnp

    from pmg_dolfinx_jax.solvers.transient import (
        batch_evolve, wave_leapfrog_evolve)

    mesh = BoxMesh((6, 6, 6))
    P, dt, nsteps = 3, 5e-4, 5
    rng = np.random.default_rng(4)
    U0 = rng.standard_normal((B, mesh.num_dofs(P))).astype(np.float32)
    V0 = rng.standard_normal((B, mesh.num_dofs(P))).astype(np.float32)
    bc = np.asarray(mesh.boundary_dof_marker(P))
    U0[:, bc] = 0.0
    ev1 = (wave_newmark_evolve if scheme == "newmark"
           else wave_leapfrog_evolve)(mesh, P, kappa=KAPPA, dt=dt,
                                      dtype=jnp.float32)
    refs = [tuple(np.asarray(a).reshape(-1)
                  for a in ev1(U0[k], V0[k], nsteps)) for k in range(B)]
    uref = np.stack([r[0] for r in refs])
    vref = np.stack([r[1] for r in refs])
    UT, VT = batch_evolve(ev1)(U0, V0, nsteps)
    assert np.linalg.norm(np.asarray(UT) - uref) < \
        2e-5 * np.linalg.norm(uref)
    # Newmark's a1 = c0 (u1 - u*) amplifies f32 cancellation noise by
    # c0 = 1/(beta dt^2) ~ 1e7, and the batched/per-RHS programs may
    # round differently — the velocity agreement floor is ~1e-3 rel
    # there (the displacement stays at f32 precision). Leapfrog has no
    # such amplification.
    vtol = 2e-3 if scheme == "newmark" else 2e-5
    assert np.linalg.norm(np.asarray(VT) - vref) < \
        vtol * np.linalg.norm(vref)

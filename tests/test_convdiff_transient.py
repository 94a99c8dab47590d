"""Transient convection-diffusion (solvers/transient.py
convdiff_fdm_evolve): IMEX stepping — implicit FDM diffusion, explicit
separable advection — as one scanned XLA program.

Oracles: (1) a dense scipy twin stepping the IDENTICAL scheme
(trajectory-exact, graded mesh + mixed faces + inhomogeneous Dirichlet
pass-through), (2) the exact semidiscrete solution ``expm(-t M^{-1}(K +
C))`` pinning the temporal orders (BE 1, CNAB 2), (3) the steady-state
fixed point — the IMEX iteration's fixed point is EXACTLY the steady
``convdiff_solve`` system, scheme error cancels."""

import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from pmg_dolfinx_jax.fem.assembly import (
    assemble_rhs, assemble_stiffness, lumped_mass_np)
from pmg_dolfinx_jax.fem.mesh import BoxMesh, geometric_spacing
from pmg_dolfinx_jax.ops.kron import axis_advection, axis_stiffness_mass
from pmg_dolfinx_jax.solvers.transient import (
    convdiff_advective_dt, convdiff_fdm_evolve)

KAPPA = 1.0
CVEL = (1.2, -0.6, 0.3)


def _adv_masked(mesh, P):
    """Interior-masked separable advection matrix (the operator's
    mask-in/identity-row convention), scipy."""
    Cs = [sp.csr_matrix(axis_advection(mesh.nc[a], P)) for a in range(3)]
    ms = [axis_stiffness_mass(mesh.nc[a], P, mesh.h_cells[a])[1]
          for a in range(3)]
    adv = (CVEL[0] * sp.kron(Cs[0], sp.kron(sp.diags(ms[1]),
                                            sp.diags(ms[2])))
           + CVEL[1] * sp.kron(sp.diags(ms[0]),
                               sp.kron(Cs[1], sp.diags(ms[2])))
           + CVEL[2] * sp.kron(sp.diags(ms[0]),
                               sp.kron(sp.diags(ms[1]), Cs[2])))
    z = sp.diags((~np.asarray(mesh.boundary_dof_marker(P))).astype(float))
    return (z @ adv @ z).tocsr()


def _dense_twin_evolve(mesh, P, kappa, dt, scheme, u0, nsteps, sigma=0.0):
    """scipy twin of convdiff_fdm_evolve: same IMEX formulas (linear
    reaction ``sigma u`` folded into the implicit shift), sparse direct
    solves."""
    sdt = 1.0 / dt
    bc = np.asarray(mesh.boundary_dof_marker(P))
    m0 = lumped_mass_np(mesh, P, bc_zero=True)
    C = _adv_masked(mesh, P)
    kap_op = 0.5 * kappa if scheme == "cnab" else kappa
    shift = 0.5 * sigma + sdt if scheme == "cnab" else sigma + sdt
    A = (assemble_stiffness(mesh, P, kappa=kap_op, bc=True).tocsr()
         + shift * sp.diags(m0)).tocsc()
    lu = spla.splu(A)
    u = np.asarray(u0, dtype=np.float64).copy()
    adv_m1 = C @ u
    for n in range(nsteps):
        adv_n = C @ u
        if scheme == "be":
            rhs = sdt * m0 * u - adv_n
        else:
            rhs = (2.0 * sdt * m0 * u - A @ u
                   - (1.5 * adv_n - 0.5 * adv_m1))
        rhs[bc] = u[bc]
        u = lu.solve(rhs)
        adv_m1 = adv_n
    return u


@pytest.mark.parametrize("scheme", ["be", "cnab"])
def test_trajectory_matches_dense_twin(scheme):
    """The scanned IMEX program reproduces the scipy twin step for step
    — graded spacing, mixed Dirichlet/Neumann faces, and inhomogeneous
    Dirichlet data passing through."""
    mesh = BoxMesh((3, 4, 3),
                   spacing=(None, geometric_spacing(4, 2.5), None),
                   dirichlet_faces=((True, True), (True, False),
                                    (True, True)))
    P, dt, nsteps = 3, 2e-3, 6
    c = mesh.dof_coords(P)
    u0 = np.cos(np.pi * c[:, 0]) * (1.0 + c[:, 1]) * (1.0 - 0.5 * c[:, 2])
    evolve = convdiff_fdm_evolve(mesh, P, CVEL, kappa=KAPPA, dt=dt,
                                 scheme=scheme)
    uT = np.asarray(evolve(u0, nsteps)).reshape(-1)
    ref = _dense_twin_evolve(mesh, P, KAPPA, dt, scheme, u0, nsteps)
    assert np.linalg.norm(uT - ref) < 1e-11 * np.linalg.norm(ref)
    # Dirichlet data held fixed; Neumann-face dofs evolved.
    bc = np.asarray(mesh.boundary_dof_marker(P))
    assert np.array_equal(uT[bc], u0[bc])


@pytest.mark.parametrize("scheme,order", [("be", 1.0), ("cnab", 2.0)])
def test_imex_time_orders(scheme, order):
    """Temporal orders against the EXACT semidiscrete solution
    ``expm(-T M^{-1}(K + C)) u0`` on the interior block."""
    mesh = BoxMesh((4, 4, 4))
    P, T = 2, 0.2
    bc = np.asarray(mesh.boundary_dof_marker(P))
    it = ~bc
    K = assemble_stiffness(mesh, P, kappa=KAPPA, bc=True).tocsr()
    C = _adv_masked(mesh, P)
    m0 = lumped_mass_np(mesh, P, bc_zero=True)
    L = (K[np.ix_(it, it)].toarray() + C[np.ix_(it, it)].toarray()) \
        / m0[it][:, None]
    c = mesh.dof_coords(P)
    u0 = np.where(bc, 0.0, np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
                  * np.sin(np.pi * c[:, 2]))
    ref = sla.expm(-T * L) @ u0[it]
    errs = []
    for nsteps in (8, 16, 32):
        dt = T / nsteps
        assert dt < convdiff_advective_dt(mesh, P, CVEL)
        evolve = convdiff_fdm_evolve(mesh, P, CVEL, kappa=KAPPA, dt=dt,
                                     scheme=scheme)
        uT = np.asarray(evolve(u0, nsteps)).reshape(-1)
        errs.append(np.linalg.norm(uT[it] - ref))
    rates = [np.log2(errs[i] / errs[i + 1]) for i in range(2)]
    for r in rates:
        assert abs(r - order) < 0.3, (scheme, rates, errs)


def test_be_steady_state_matches_convdiff_solve():
    """The IMEX fixed point is the exact steady system ``(K + C) u = f``
    — long BE evolution lands on the convdiff_solve/spsolve answer to
    solver accuracy (the scheme error cancels at the fixed point)."""
    from pmg_dolfinx_jax.solvers.convdiff import convdiff_solve
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    mesh = BoxMesh((4, 4, 4))
    P, dt, nsteps = 3, 0.02, 400
    pi = np.pi

    def fsrc(x):
        sx, sy, sz = (np.sin(pi * x[a]) for a in range(3))
        cx, cy, cz = (np.cos(pi * x[a]) for a in range(3))
        g = (pi * cx * sy * sz, pi * sx * cy * sz, pi * sx * sy * cz)
        return (3.0 * pi**2 * KAPPA * sx * sy * sz
                + sum(c_ * g_ for c_, g_ in zip(CVEL, g)))

    b = assemble_rhs(mesh, P, fsrc)
    evolve = convdiff_fdm_evolve(mesh, P, CVEL, kappa=KAPPA, dt=dt,
                                 scheme="be", f=b)
    uT = np.asarray(evolve(np.zeros(mesh.num_dofs(P)), nsteps)).reshape(-1)
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=KAPPA, coarse="fdm",
                        operator="kron")
    u_star, info = convdiff_solve(hier, b, CVEL, rtol=1e-12)
    assert np.linalg.norm(uT - np.asarray(u_star)) < \
        1e-8 * np.linalg.norm(u_star)


@pytest.mark.parametrize("scheme", ["be", "cnab"])
def test_sigma_reaction_matches_dense_twin(scheme):
    """Nonzero linear reaction sigma: the evolver folds it into the
    implicit shift (BE sigma+1/dt, CN sigma/2+1/dt) and reproduces the
    scipy twin stepping the identical formulas (the ADVICE r3 gap:
    --transient used to silently drop sigma)."""
    mesh = BoxMesh((3, 4, 3))
    P, dt, nsteps, sigma = 3, 2e-3, 6, 4.0
    c = mesh.dof_coords(P)
    u0 = np.where(np.asarray(mesh.boundary_dof_marker(P)), 0.0,
                  np.cos(np.pi * c[:, 0]) * (1.0 + c[:, 1]) * c[:, 2])
    evolve = convdiff_fdm_evolve(mesh, P, CVEL, kappa=KAPPA, dt=dt,
                                 scheme=scheme, sigma=sigma)
    uT = np.asarray(evolve(u0, nsteps)).reshape(-1)
    ref = _dense_twin_evolve(mesh, P, KAPPA, dt, scheme, u0, nsteps,
                             sigma=sigma)
    assert np.linalg.norm(uT - ref) < 1e-11 * np.linalg.norm(ref)
    # sigma genuinely changes the trajectory (guards a silent no-op).
    ref0 = _dense_twin_evolve(mesh, P, KAPPA, dt, scheme, u0, nsteps)
    assert np.linalg.norm(ref - ref0) > 1e-6 * np.linalg.norm(ref0)


def test_sigma_be_steady_state_is_shifted_system():
    """With reaction sigma, the BE fixed point is the steady
    ``(K + sigma M + C) u = f`` system — the sigma-shifted hierarchy's
    convdiff_solve answer."""
    from pmg_dolfinx_jax.solvers.convdiff import convdiff_solve
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    mesh = BoxMesh((4, 4, 4))
    P, dt, nsteps, sigma = 3, 0.02, 400, 3.0
    pi = np.pi

    def fsrc(x):
        sx, sy, sz = (np.sin(pi * x[a]) for a in range(3))
        cx, cy, cz = (np.cos(pi * x[a]) for a in range(3))
        g = (pi * cx * sy * sz, pi * sx * cy * sz, pi * sx * sy * cz)
        return ((3.0 * pi**2 * KAPPA + sigma) * sx * sy * sz
                + sum(c_ * g_ for c_, g_ in zip(CVEL, g)))

    b = assemble_rhs(mesh, P, fsrc)
    evolve = convdiff_fdm_evolve(mesh, P, CVEL, kappa=KAPPA, dt=dt,
                                 scheme="be", sigma=sigma, f=b)
    uT = np.asarray(evolve(np.zeros(mesh.num_dofs(P)), nsteps)).reshape(-1)
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=KAPPA, coarse="fdm",
                        operator="kron", sigma=sigma)
    u_star, info = convdiff_solve(hier, b, CVEL, rtol=1e-12)
    assert np.linalg.norm(uT - np.asarray(u_star)) < \
        1e-8 * np.linalg.norm(u_star)


def test_rejects_bad_scheme_and_velocity():
    mesh = BoxMesh((3, 3, 3))
    with pytest.raises(ValueError, match="scheme"):
        convdiff_fdm_evolve(mesh, 2, CVEL, scheme="rk4")
    with pytest.raises(ValueError, match="3-vector"):
        convdiff_fdm_evolve(mesh, 2, (1.0, 2.0))

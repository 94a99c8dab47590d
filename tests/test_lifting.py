"""Inhomogeneous Dirichlet data via lifting (`fem.assembly.lifted_rhs`):
u = g on the flagged faces, solve homogeneous for w, u = w + u_g. The
reference's apply_lifting step with NONZERO g (a no-op there,
examples/pmg/main.cpp:289-301). A linear exact solution lives in every
Q_p space, so the discrete solution must reproduce it to solver
tolerance — the sharpest possible check of the lifting algebra."""

import jax.numpy as jnp
import numpy as np

from pmg_dolfinx_jax.fem.assembly import lifted_rhs
from pmg_dolfinx_jax.fem.mesh import BoxMesh, PerturbedBoxMesh
from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy


def _g_linear(x):
    return 1.0 + 2.0 * x[0] - x[1] + 0.5 * x[2]


def test_lifted_linear_solution_is_exact_box():
    """kappa-constant harmonic linear data: f=0, u=g reproduced to
    solver tolerance through the FCG solve, box + FDM coarse."""
    mesh = BoxMesh((5, 4, 5))
    P, kappa = 3, 2.0
    b, u_g = lifted_rhs(mesh, P, kappa, lambda x: 0.0 * x[0], _g_linear)
    hier = PMGHierarchy(mesh, degrees=(1, P), kappa=kappa, coarse="fdm",
                        operator="kron")
    w, it = hier.solve_pcg(jnp.asarray(b), rtol=1e-12, maxiter=40)
    u = np.asarray(w) + u_g
    exact = _g_linear(mesh.dof_coords(P).T)
    assert np.abs(u - exact).max() < 1e-9, np.abs(u - exact).max()


def test_lifted_linear_solution_is_exact_curved_mixed():
    """Curved hexes + MIXED faces: the Neumann faces of a linear
    solution carry a nonzero flux, so restrict the test to data whose
    normal derivative vanishes there (g constant along the Neumann
    axis) — exact reproduction again."""
    faces = ((True, True), (False, False), (True, True))
    mesh = PerturbedBoxMesh((4, 4, 4), dirichlet_faces=faces)
    P, kappa = 3, 2.0

    def g(x):  # no y-dependence: zero normal flux on the Neumann faces
        return 1.0 + 2.0 * x[0] + 0.5 * x[2]

    b, u_g = lifted_rhs(mesh, P, kappa, lambda x: 0.0 * x[0], g)
    hier = PMGHierarchy(mesh, degrees=(1, P), kappa=kappa, coarse="cg",
                        operator="lattice")
    w, it = hier.solve_pcg(jnp.asarray(b), rtol=1e-12, maxiter=40)
    u = np.asarray(w) + u_g
    exact = g(mesh.dof_coords(P).T)
    assert np.abs(u - exact).max() < 1e-8, np.abs(u - exact).max()


def test_lifted_fdm_direct_one_shot():
    """FDM direct solve of the lifted system: exact in one application."""
    from pmg_dolfinx_jax.solvers.fdm import FastDiagonalizationSolver

    mesh = BoxMesh((4, 5, 4))
    P, kappa = 4, 3.0
    b, u_g = lifted_rhs(mesh, P, kappa, lambda x: 0.0 * x[0], _g_linear)
    fd = FastDiagonalizationSolver(mesh, P, kappa=kappa, dtype=jnp.float64)
    u = np.asarray(fd.solve(b)) + u_g
    exact = _g_linear(mesh.dof_coords(P).T)
    assert np.abs(u - exact).max() < 1e-11, np.abs(u - exact).max()

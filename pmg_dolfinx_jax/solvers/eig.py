"""Matrix-free modal analysis: lowest eigenpairs of the diffusion pencil.

Computes the smallest ``k`` generalized eigenpairs of ``K u = lam M u``
(stiffness against the GLL-lumped mass — the standard FEM modal
problem). Beyond the reference (solves only); standard production need
(vibration/diffusion modes, smallest-eigenvalue conditioning studies).

Design: shift-invert LOBPCG. With the diagonal lumped mass,
the standard form is ``C = M^-1/2 K M^-1/2``; the SMALLEST eigenvalues
of C are the LARGEST of ``C^-1 = M^1/2 K^-1 M^1/2``, which is exactly
what `jax.experimental.sparse.linalg.lobpcg_standard` computes (its
docstring: smallest-eigenvector mode is not supported — inversion
sidesteps that, and the framework owns fast inverses):

- axis-aligned constant / per-axis kappa: ``K^-1`` = the FDM direct
  solve (`solvers/fdm.py`) — each LOBPCG iteration costs k direct
  solves, all batched through `FastDiagonalizationSolver.solve_many`
  (one vmapped program per iteration);
- general family (curved hexes, variable/tensor kappa): ``K^-1`` = the
  V-cycle-preconditioned FCG solve to a fixed tolerance
  (`PMGHierarchy.solve_pcg_many`).

Dirichlet rows are masked to eigenvalue 0 in the inverse action so the
identity rows never pollute the top-k block.

The routine requires x64. It is validated on the CPU against scipy
shift-invert `eigsh` to 1e-8 on every model family (tests/test_eig.py);
a GPU run at 2M dofs is ROADMAP R4.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def lowest_eigenpairs(mesh, P, kappa=2.0, k=4, sigma=0.0,
                      hierarchy=None, degrees=None, inner_rtol=1e-11,
                      maxiter=200, tol=None, seed=0):
    """Smallest ``k`` eigenpairs of ``(K + sigma M) u = lam M u``.

    Returns ``(lams, U, iters)``: eigenvalues ascending ``(k,)``,
    M-orthonormal eigenvectors ``(ndofs, k)`` (zero at Dirichlet dofs),
    and the LOBPCG iteration count. f64 (modal analysis is a setup-time
    computation; run under ``jax_enable_x64``).

    ``hierarchy`` (optional) supplies a prebuilt `PMGHierarchy` for the
    general-family inverse; otherwise one is built from ``degrees``
    (default ``(1, P)``) when the mesh/kappa are outside the FDM's
    domain.
    """
    from ..fem.assembly import lumped_mass_np, resolve_kappa_axes

    if not jax.config.read("jax_enable_x64"):
        raise RuntimeError("lowest_eigenpairs requires jax_enable_x64")
    ndofs = mesh.num_dofs(P)
    if 5 * k >= ndofs:
        raise ValueError(f"need 5*k < ndofs (k={k}, ndofs={ndofs})")
    bc = jnp.asarray(np.asarray(mesh.boundary_dof_marker(P)))
    sm = jnp.asarray(np.sqrt(lumped_mass_np(mesh, P)))

    use_fdm = (getattr(mesh, "is_axis_aligned", True)
               and hierarchy is None
               and not callable(sigma))  # sigma FIELD: general inverse
    if use_fdm:
        try:
            resolve_kappa_axes(mesh, kappa)
        except ValueError:
            use_fdm = False
    if use_fdm:
        from .fdm import FastDiagonalizationSolver

        fd = FastDiagonalizationSolver(mesh, P, kappa=kappa,
                                       dtype=jnp.float64, sigma=sigma)
        solve_many = fd.solve_many
    else:
        from .pmg import PMGHierarchy

        hier = hierarchy
        if hier is None:
            # This branch is only reached for the GENERAL family (curved
            # mesh, or axis-aligned with tensor/field kappa — anything
            # the FDM's resolve_kappa_axes rejected), so the lattice
            # backend is the right default.
            hier = PMGHierarchy(
                mesh, degrees=tuple(degrees or (1, P)), kappa=kappa,
                dtype=jnp.float64, coarse="cg", operator="lattice",
                sigma=sigma,
            )

        fn = hier._pcg_many_fn()
        work_shape = tuple(hier._to_work(jnp.zeros(ndofs)).shape)

        def solve_many(B):
            # Trace-safe core (solve_pcg_many's host conversions would
            # break inside LOBPCG's traced loop).
            Bw = B.reshape((B.shape[0],) + work_shape)
            U, _ = fn(hier.data, Bw, jnp.zeros_like(Bw),
                      float(inner_rtol), 100)
            return U.reshape(B.shape)

    def inv_action(X):
        # (n, k) -> (n, k): C^-1 X = M^1/2 K^-1 M^1/2 X, bc rows masked.
        B = jnp.where(bc[None, :], 0.0, (sm[:, None] * X).T)
        U = solve_many(B)
        return (sm[:, None] * jnp.where(bc[None, :], 0.0, U).T)

    from jax.experimental.sparse.linalg import lobpcg_standard

    X0 = jnp.asarray(
        np.random.default_rng(seed).standard_normal((ndofs, k)))
    X0 = jnp.where(bc[:, None], 0.0, X0)
    theta, Y, iters = lobpcg_standard(inv_action, X0, m=maxiter, tol=tol)
    lams = 1.0 / theta
    order = jnp.argsort(lams)
    lams = lams[order]
    # Back to the generalized problem: u = M^-1/2 y (already
    # M-orthonormal: y^T y = u^T M u).
    U = jnp.where(bc[:, None], 0.0, Y[:, order] / sm[:, None])
    return np.asarray(lams), U, int(iters)

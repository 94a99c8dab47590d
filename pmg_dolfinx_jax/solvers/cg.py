"""Jacobi-preconditioned conjugate gradients with coefficient recording.

Redesign of `acc::CGSolver` (reference src/cg.hpp:93-251). The
reference's device loop interleaves GPU kernels with two MPI_Allreduce
reductions per iteration (cg.hpp:182, 195); here the whole solve is one
jitted `lax.while_loop` (or `lax.scan` when recording) whose two inner
products become `psum`s automatically when run inside `shard_map` — the
`dot` argument abstracts the reduction exactly where the reference
abstracts it behind `acc::inner_product` (vector.hpp:334-350).

Semantics match the reference iteration-for-iteration (validated against
the python mirror python_tests/cg.py):

    p = M^-1 r ;  rnorm = <p, r>
    loop: y = A p ; alpha = rnorm / <p, y>
          x += alpha p ; r -= alpha y ; z = M^-1 r
          rnorm' = <r, z> ; beta = rnorm' / rnorm
          converged if rnorm'/rnorm0 < rtol^2      [cg.hpp:206]
          p = beta p + z
          record (alpha, beta, rnorm') only when the iteration did NOT
          trigger convergence                      [cg.hpp:213-218]

The recorded alpha/beta feed the Lanczos tridiagonal eigenvalue estimate
(solvers/tridiag.py) used to calibrate Chebyshev smoothers.
"""

from functools import partial

import jax
import jax.numpy as jnp


def _safe_div(num, den):
    """Divide guarding against an exact-zero denominator (already-solved
    systems produce zero residual dots; the quotient is then irrelevant
    because the convergence flag stops the loop)."""
    return num / jnp.where(den == 0, jnp.ones_like(den), den)


def _default_dot(u, v):
    return jnp.vdot(u, v)


def cg_solve(A, b, x0, diag_inv, *, rtol=1e-8, maxiter=100, record=False,
             dot=_default_dot, precond=None):
    """Solve ``A x = b`` with Jacobi-preconditioned CG.

    Parameters
    ----------
    A : callable ``x -> A @ x`` (pure; closed over operator params by the
        caller — typically a `functools.partial` of `laplacian_apply`).
    b, x0 : right-hand side and initial guess.
    diag_inv : inverse operator diagonal (Jacobi preconditioner).
    rtol : relative tolerance on the *preconditioned* residual norm
        (same convergence test as the reference).
    maxiter : iteration cap. With ``record=True`` the loop is a fixed-length
        `lax.scan` (needed for fixed-shape coefficient buffers).
    record : also return per-iteration (alphas, betas, rnorms, stored-mask).
    dot : inner product; pass a psum-reducing version under shard_map.
    precond : optional callable ``r -> M^-1 r`` overriding the Jacobi
        preconditioner (must be a fixed SPD linear operator, e.g. a
        zero-initial-guess Chebyshev sweep).

    Returns
    -------
    ``(x, info)`` where info is a dict with ``niter``, ``rnorm`` (final
    preconditioned residual square), ``rnorm0``, and when recording the
    fixed-shape arrays ``alphas``, ``betas``, ``residuals``, ``stored``.
    """
    M = precond if precond is not None else (lambda r: diag_inv * r)
    r = b - A(x0)
    p = M(r)
    rnorm0 = dot(p, r)
    rtol2 = rtol * rtol

    def iteration(x, r, p, rnorm):
        y = A(p)
        alpha = _safe_div(rnorm, dot(p, y))
        x = x + alpha * p
        r = r - alpha * y
        z = M(r)
        rnorm_new = dot(r, z)
        beta = _safe_div(rnorm_new, rnorm)
        converged = _safe_div(rnorm_new, rnorm0) < rtol2
        p = beta * p + z
        return x, r, p, rnorm_new, alpha, beta, converged

    if not record:
        def cond(state):
            k, _, _, _, rnorm, done = state
            return jnp.logical_and(k < maxiter, jnp.logical_not(done))

        def body(state):
            k, x, r, p, rnorm, _ = state
            x, r, p, rnorm_new, _, _, converged = iteration(x, r, p, rnorm)
            return k + 1, x, r, p, rnorm_new, converged

        k, x, r, p, rnorm, done = jax.lax.while_loop(
            cond, body, (0, x0, r, p, rnorm0, rnorm0 <= jnp.zeros_like(rnorm0))
        )
        return x, dict(niter=k, rnorm=rnorm, rnorm0=rnorm0)

    def scan_body(carry, _):
        k, x, r, p, rnorm, done = carry
        xn, rn, pn, rnorm_n, alpha, beta, converged = iteration(x, r, p, rnorm)
        active = jnp.logical_not(done)
        # Freeze state once converged (scan is fixed length).
        x = jnp.where(active, xn, x)
        r = jnp.where(active, rn, r)
        p = jnp.where(active, pn, p)
        rnorm = jnp.where(active, rnorm_n, rnorm)
        stored = jnp.logical_and(active, jnp.logical_not(converged))
        new_done = jnp.logical_or(done, converged)
        out = (
            jnp.where(active, alpha, 0.0),
            jnp.where(active, beta, 0.0),
            jnp.where(active, rnorm_n, 0.0),
            stored,
        )
        return (k + active.astype(k.dtype), x, r, p, rnorm, new_done), out

    init = (jnp.asarray(0), x0, r, p, rnorm0, jnp.asarray(False))
    (k, x, r, p, rnorm, done), (alphas, betas, residuals, stored) = jax.lax.scan(
        scan_body, init, None, length=maxiter
    )
    return x, dict(
        niter=k,
        rnorm=rnorm,
        rnorm0=rnorm0,
        alphas=alphas,
        betas=betas,
        residuals=residuals,
        stored=stored,
    )


def fcg_solve(A, b, x0, M, *, rtol=1e-8, maxiter=50, dot=_default_dot):
    """Flexible (Polak-Ribiere) preconditioned conjugate gradients.

    For preconditioners that are not exactly fixed linear operators —
    e.g. a V-cycle whose coarse solve is itself a Krylov iteration. The
    flexible beta ``<z, r - r_old> / <z_old, r_old>`` restores robustness
    where classic CG would silently degrade. This is a capability the
    reference lacks (it drives the PMG as a stationary Richardson
    iteration, examples/pmg/main.cpp:362-367); MG-preconditioned FCG
    typically converges in ~half the cycles.

    Returns ``(x, info)`` with ``niter`` and the true-residual norms are
    the caller's to compute (the loop tracks the preconditioned norm).
    """
    r = b - A(x0)
    z = M(r)
    p = z
    rz = dot(r, z)
    rz0 = rz
    rtol2 = rtol * rtol

    def cond(state):
        k, x, r, z, p, rz, done = state
        return jnp.logical_and(k < maxiter, jnp.logical_not(done))

    def body(state):
        k, x, r, z, p, rz, _ = state
        q = A(p)
        alpha = _safe_div(rz, dot(p, q))
        x = x + alpha * p
        r_new = r - alpha * q
        z_new = M(r_new)
        # Polak-Ribiere (flexible) beta.
        beta = _safe_div(dot(z_new, r_new - r), rz)
        rz_new = dot(r_new, z_new)
        done = _safe_div(rz_new, rz0) < rtol2
        p = z_new + beta * p
        return k + 1, x, r_new, z_new, p, rz_new, done

    k, x, r, z, p, rz, done = jax.lax.while_loop(
        cond, body, (0, x0, r, z, p, rz, rz <= jnp.zeros_like(rz))
    )
    return x, dict(niter=k, rnorm=rz, rnorm0=rz0)

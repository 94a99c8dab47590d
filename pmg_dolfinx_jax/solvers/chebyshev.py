"""Chebyshev smoothers (fourth kind and first kind), Jacobi-preconditioned.

Redesign of `acc::Chebyshev` (reference src/chebyshev.hpp:19-107),
which implements the "optimised fourth-kind" Chebyshev iteration of
Phillips & Fischer, arXiv:2210.03179 (cited at chebyshev.hpp:50). Only the
upper eigenvalue estimate lambda_max is used by the fourth-kind smoother —
the eig_range lower bound is carried for API parity and for the first-kind
variant (the python mirror python_tests/chebyshev.py:47-65 implements both).

The fixed-iteration recurrence (k = 1..num_iters):

    r = b - A x
    z = (4 / (3 lmax)) M^-1 r
    repeat: x += z
            r -= A z
            z  = (2k-1)/(2k+3) z + (8k+4)/((2k+3) lmax) M^-1 r

One jitted `lax.fori_loop`; `num_iters + 1` operator applies per smooth
(same count as the reference: one residual + one per iteration).
"""

import jax
import jax.numpy as jnp


def chebyshev4_solve(A, b, x, diag_inv, lmax, num_iters):
    """Fourth-kind Chebyshev smoothing of ``A x = b`` from initial guess x.

    ``lmax`` is the (inflated) upper eigenvalue bound of ``M^-1 A`` —
    the drivers use 1.1 * lambda_max_estimate (examples/pmg/main.cpp:327).
    ``diag_inv`` is either the inverse-diagonal array (point Jacobi) or a
    callable ``r -> M^-1 r`` for block preconditioners (line relaxation,
    solvers/line.py).
    """
    M = diag_inv if callable(diag_inv) else (lambda r: diag_inv * r)
    r = b - A(x)
    z = (4.0 / (3.0 * lmax)) * M(r)

    def body(i, state):
        x, r, z = state
        x = x + z
        r = r - A(z)
        kf = jnp.asarray(i + 1, dtype=r.dtype)  # reference index runs 1..num_iters
        z = z * (2.0 * kf - 1.0) / (2.0 * kf + 3.0) + (
            (8.0 * kf + 4.0) / ((2.0 * kf + 3.0) * lmax)
        ) * M(r)
        return x, r, z

    x, r, z = jax.lax.fori_loop(0, num_iters, body, (x, r, z))
    return x


def chebyshev1_solve(A, b, x, diag_inv, eig_range, num_iters):
    """Classic (first-kind) Chebyshev iteration over ``[lmin, lmax]``.

    Counterpart of `cheb1` in the reference mirror
    python_tests/chebyshev.py:47-65; standard three-term recurrence with
    theta = (lmax+lmin)/2, delta = (lmax-lmin)/2.
    """
    lmin, lmax = eig_range
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma

    r = diag_inv * (b - A(x))
    d = r / theta

    def body(i, state):
        x, r, d, rho = state
        x = x + d
        r = r - diag_inv * A(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        return x, r, d, rho_new

    x, r, d, rho = jax.lax.fori_loop(0, num_iters, body, (x, r, d, rho))
    return x

"""Smoothed-aggregation algebraic multigrid coarse solver.

Fills the reference's BoomerAMG role (`coarse='amg'`): the reference
hands its assembled p=1 matrix to hypre and runs V-cycles under a
60-iteration KSP cap (src/amg.hpp:33-47) — topology-agnostic, which is
exactly what the geometric h-MG family here (`solvers/hmg.py`) cannot
be: it rediscretizes on coarsened BOX lattices and refuses unstructured
meshes. This module is the unstructured-capable multilevel coarse:
classical smoothed aggregation (Vanek/Mandel/Brezina) built at setup on
the host from the assembled coarsest-p matrix (scipy CSR, the golden
assembly), applied on device.

Split of the work:

- LEVEL 0 (the p-coarse problem, the only level whose size scales with
  the mesh) stays MATRIX-FREE: pre/post smoothing uses the hierarchy's
  own calibrated smoother, and the smoothed prolongator is applied as
  ``P = (I - omega D^-1 A) T0`` with A the hierarchy's fast operator
  apply — the only assembled objects touched per cycle at this size are
  the aggregate map (one element gather / segment-sum of N0 values; at
  p-coarse sizes ~1e4-1e5 this costs well under the smoother applies).
- DEEPER LEVELS are small (aggregation coarsens ~20-30x per level in
  3D): assembled Galerkin products ``A_{l+1} = P^T A_l P`` ship as BCOO
  until ``<= dense_cap`` dofs, where a dense Cholesky bottoms out.

Dirichlet rows of A are identity (assembly contract); they are EXCLUDED
from aggregation (zero rows of T0), so the coarse hierarchy never sees
them — their residual is identically zero inside the outer V-cycle
(masked coarse rhs) and the level-0 smoother owns them.

Aggregation: greedy root-neighborhood MIS over the strength graph
(|a_ij| >= theta sqrt(a_ii a_jj), theta=0 keeps the full 27-point hex
stencil), the standard three passes. Tentative prolongator = piecewise
constant over aggregates with unit-norm columns; Jacobi smoothing
weight ``omega = (4/3) / lambda_max(D^-1 A)`` via host power iteration.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from .chebyshev import chebyshev4_solve

DENSE_CAP = 3000        # switch to dense Cholesky at/below this size
MAX_LEVELS = 10
OMEGA_FACTOR = 4.0 / 3.0


def _strength_graph(A, theta):
    """Symmetric strength-of-connection filter on CSR ``A``."""
    if theta <= 0.0:
        return A
    d = np.sqrt(np.abs(A.diagonal()))
    C = A.tocoo()
    keep = np.abs(C.data) >= theta * d[C.row] * d[C.col]
    keep |= C.row == C.col
    return sp.coo_matrix(
        (C.data[keep], (C.row[keep], C.col[keep])), shape=A.shape
    ).tocsr()


def aggregate(A, exclude=None, theta=0.0):
    """Greedy aggregation over the strength graph (host).

    Returns ``(agg, n_agg)``: per-dof aggregate index, ``-1`` for
    excluded (Dirichlet) dofs. Standard three passes: (1) roots whose
    whole free neighborhood is unaggregated seed an aggregate from it,
    (2) leftovers join a neighboring aggregate, (3) isolated remainders
    seed from whatever free neighbors remain.
    """
    S = _strength_graph(A.tocsr(), theta)
    n = S.shape[0]
    indptr, indices = S.indptr, S.indices
    free = np.ones(n, dtype=bool) if exclude is None else ~np.asarray(
        exclude, dtype=bool)
    agg = np.full(n, -1, dtype=np.int64)
    na = 0
    for i in range(n):
        if not free[i] or agg[i] >= 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        nbrs = nbrs[free[nbrs]]
        if (agg[nbrs] < 0).all():
            agg[nbrs] = na
            agg[i] = na
            na += 1
    for i in range(n):
        if not free[i] or agg[i] >= 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        cand = agg[nbrs[free[nbrs]]]
        cand = cand[cand >= 0]
        if len(cand):
            agg[i] = cand[0]
    for i in range(n):
        if not free[i] or agg[i] >= 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        sel = free[nbrs] & (agg[nbrs] < 0)
        agg[i] = na
        agg[nbrs[sel]] = na
        na += 1
    return agg, na


def _tentative(agg, na):
    """Unit-column piecewise-constant prolongator T0 (scipy CSR)."""
    rows = np.where(agg >= 0)[0]
    cols = agg[rows]
    cnt = np.bincount(cols, minlength=na).astype(np.float64)
    vals = 1.0 / np.sqrt(cnt[cols])
    return sp.coo_matrix((vals, (rows, cols)),
                         shape=(len(agg), na)).tocsr()


def _lmax_jacobi(A, iters=30, seed=0):
    """Power-iteration estimate of ``lambda_max(D^-1 A)`` (host)."""
    dinv = 1.0 / A.diagonal()
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(A.shape[0])
    lam = 1.0
    for _ in range(iters):
        w = dinv * (A @ v)
        lam = np.linalg.norm(w)
        v = w / lam
    return float(lam)


def _to_bcoo(M, dtype):
    C = sp.coo_matrix(M)
    from jax.experimental import sparse as jsparse

    return jsparse.BCOO(
        (jnp.asarray(C.data, dtype=dtype),
         jnp.asarray(np.stack([C.row, C.col], axis=1))),
        shape=C.shape,
    )


def build_amg(A0, bc_mask, dtype, theta=0.0, dense_cap=DENSE_CAP,
              max_levels=MAX_LEVELS, smoother_iters=2, psmooth=2, nu=2):
    """Host setup from the assembled (bc-applied) coarsest-p matrix.

    Returns ``(data, meta)``: a device pytree and the static meta tuple
    ``(n_agg0,)`` the jitted cycle needs. ``data`` keys:

    - level 0 (matrix-free side): ``agg0`` int32 (bc dofs -> n_agg0,
      the dummy slot), ``scale0``, ``dinv0``, ``omega0``;
    - ``inner``: tuple of per-level dicts — ``A`` (BCOO), ``P``/``PT``
      (BCOO, smoothed), ``dinv``, ``lmax`` — for intermediate levels;
    - ``chol``: dense Cholesky factor of the bottom level.
    """
    A0 = A0.tocsr()
    bc_mask = np.asarray(bc_mask, dtype=bool)
    agg, na = aggregate(A0, exclude=bc_mask, theta=theta)
    if na == 0:
        raise ValueError("aggregation produced no aggregates "
                         "(all dofs Dirichlet?)")
    T0 = _tentative(agg, na)
    lmax0 = _lmax_jacobi(A0)
    omega0 = OMEGA_FACTOR / lmax0
    Dinv0 = sp.diags(1.0 / A0.diagonal())
    # ``psmooth`` Jacobi smoothing steps on the tentative prolongator:
    # P = (I - omega D^-1 A)^psmooth T0. Measured (scipy two-level
    # study, L-shape p=1): psmooth 1 -> 2 improves the V(2,2)
    # asymptotic contraction 0.33 -> 0.27 and the V(4,4) one
    # 0.16 -> 0.11, at one extra level-0 apply per transfer.
    P = T0
    for _ in range(psmooth):
        P = P - omega0 * (Dinv0 @ (A0 @ P))
    A = (P.T @ A0 @ P).tocsr()

    agg_dev = np.where(agg >= 0, agg, na).astype(np.int32)
    scale = np.zeros(len(agg))
    rows = agg >= 0
    cnt = np.bincount(agg[rows], minlength=na).astype(np.float64)
    scale[rows] = 1.0 / np.sqrt(cnt[agg[rows]])
    data = dict(
        agg0=jnp.asarray(agg_dev),
        scale0=jnp.asarray(scale, dtype=dtype),
        dinv0=jnp.asarray(1.0 / A0.diagonal(), dtype=dtype),
        omega0=jnp.asarray(omega0, dtype=dtype),
    )

    inner = []
    for _ in range(max_levels):
        if A.shape[0] <= dense_cap:
            break
        aggl, nal = aggregate(A, theta=theta)
        T = _tentative(aggl, nal)
        om = OMEGA_FACTOR / _lmax_jacobi(A)
        Pl = T
        for _ in range(psmooth):
            Pl = Pl - om * (sp.diags(1.0 / A.diagonal()) @ (A @ Pl))
        inner.append(dict(
            A=_to_bcoo(A, dtype),
            P=_to_bcoo(Pl, dtype),
            PT=_to_bcoo(Pl.T.tocsr(), dtype),
            dinv=jnp.asarray(1.0 / A.diagonal(), dtype=dtype),
            lmax=jnp.asarray(1.1 * _lmax_jacobi(A), dtype=dtype),
        ))
        A = (Pl.T @ A @ Pl).tocsr()
    Ad = A.toarray()
    data["inner"] = tuple(inner)
    data["chol"] = jnp.asarray(np.linalg.cholesky(Ad), dtype=dtype)
    meta = (int(na), 2 * smoother_iters, int(psmooth), int(nu))
    return data, meta


def _inner_cycle(inner, l, b, chol, iters):
    """V(iters, iters) over the assembled BCOO levels; dense Cholesky
    bottom. Static recursion (traced inline)."""
    if l == len(inner):
        y = jax.scipy.linalg.solve_triangular(chol, b, lower=True)
        return jax.scipy.linalg.solve_triangular(chol.T, y, lower=False)
    lv = inner[l]
    A = lv["A"]
    x = chebyshev4_solve(lambda t: A @ t, b, jnp.zeros_like(b),
                         lv["dinv"], lv["lmax"], iters)
    r = b - A @ x
    e = _inner_cycle(inner, l + 1, lv["PT"] @ r, chol, iters)
    x = x + lv["P"] @ e
    return chebyshev4_solve(lambda t: A @ t, b, x, lv["dinv"], lv["lmax"],
                            iters)


def amg_cycle(amg, b, u, meta, lv0, level0, smooth, apply0):
    """One SA-AMG V-cycle on the (p-coarse) level-0 problem (jittable).

    ``smooth``/``apply0`` are the outer hierarchy's level-0 smoother
    hook and matrix-free apply — level 0 never touches an assembled
    matrix. The smoothed prolongator is applied matrix-free:
    ``P v = (I - omega D^-1 A)^psmooth T0 v`` and
    ``P^T r = T0^T (I - omega A D^-1)^psmooth r`` (A symmetric).
    ``nu`` repeats the (smoother_iters-sweep) level-0 smoother hook per
    pre/post stage.
    """
    na, iters, psmooth, nu = meta
    for _ in range(nu):
        u = smooth(lv0, b, u, level0)
    r = b - apply0(u)
    w = r
    for _ in range(psmooth):
        w = w - amg["omega0"] * apply0(amg["dinv0"] * w)
    rc = jax.ops.segment_sum(amg["scale0"] * w, amg["agg0"],
                             num_segments=na + 1)[:-1]
    e = _inner_cycle(amg["inner"], 0, rc, amg["chol"], iters)
    v = amg["scale0"] * jnp.concatenate(
        [e, jnp.zeros(1, dtype=e.dtype)])[amg["agg0"]]
    for _ in range(psmooth):
        v = v - amg["omega0"] * amg["dinv0"] * apply0(v)
    u = u + v
    for _ in range(nu):
        u = smooth(lv0, b, u, level0)
    return u

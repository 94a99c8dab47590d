"""Steady convection-diffusion: ``-div(kappa grad u) + c . grad u
+ sigma u = f`` with a constant velocity ``c`` on axis-aligned boxes.

The advection operator factors per axis exactly like the Kronecker-sum
stiffness — ``c . grad -> sum_a c_a M_b (x) C_a (x) M_c`` with the
scale-free 1D weak-derivative matrices `ops.kron.axis_advection` — so
the full operator is three extra matmuls on top of the diffusion
apply (`ops.kron.kron_convdiff_apply`). The system is nonsymmetric:
solved by `solvers.bicgstab` preconditioned with the hierarchy's
V-cycle on the SYMMETRIC (diffusion + sigma) part, which stays an
effective preconditioner up to moderate cell-Peclet numbers (the
advection perturbation is what BiCGStab absorbs). Measured (30k dofs,
p=3, f64, V(fdm) preconditioner): 11 iterations at cell Pe 0.02, 15 at
0.2, 92 at 1.9; beyond Pe ~ 1 the unstabilized Galerkin form is
under-resolved anyway (refine, or raise kappa) — the intended regime is
diffusion-dominated transport.

Generic over `PMGHierarchy` / `DistPMG` / `GridPMG` via
`solvers.shardwrap`: the advection contraction along a sharded axis is
interface-partial exactly like the stiffness term and rides the same
per-axis ppermute exchange (`shardwrap.axis_exchanges`); the 1D
advection matrices are scale-free hence shard-invariant (one local
matrix per axis, replicated).

Beyond reference parity: the reference (Wells-Group/pmg-dolfinx) is
symmetric-Poisson-only (src/cg.hpp requires SPD).
"""

import numpy as np
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..fem.assembly import resolve_kappa_axes
from ..ops.kron import axis_advection, kron_advection_terms
from .bicgstab import bicgstab_solve
from .pmg import v_cycle
from .shardwrap import (axis_exchanges, is_sharded, layout_converters,
                        shards_of, vector_spec, wrap_program)


def sd_stabilized_kappa(mesh, P, velocity, kappa, tau=None, h_eff="p"):
    """Streamline-diagonal (SD) artificial diffusion for the
    advection-DOMINATED regime: per-axis effective diffusion

        kappa_a^eff = kappa_a + tau_a c_a^2

    — the diagonal part of the streamline tensor ``tau c c^T``. Because
    it is a constant DIAGONAL tensor it rides the ENTIRE kron family
    unchanged (per-axis stiffness scaling, exact FDM direct solve,
    every decomposition): build the hierarchy with the returned
    ``kappa_axes`` and call `convdiff_solve` as usual — the V-cycle now
    preconditions the STABILIZED symmetric part, which is what keeps
    BiCGStab effective at cell Pe >> 1.

    ``tau_a`` defaults to the classic 1D optimal value
    ``h/(2|c_a|) (coth(Pe_a) - 1/Pe_a)`` — it vanishes as
    ``Pe_a -> 0`` (consistent: diffusion-dominated problems are left
    untouched) and saturates at ``h/(2|c_a|)`` for ``Pe_a -> inf``
    (first-order upwind-scale smearing, the standard
    accuracy/stability trade). ``h_eff`` picks the grid-size scale in
    that formula:

    - ``'p'`` (default): ``h = mean(h_cells_a)/P`` — the GLL
      node-spacing scale. Accuracy-leaning. MEASURED (6^3 cells, p=3,
      f64): cell Pe 21 converges in 104 BiCGStab iterations (the
      unstabilized form fails outright past Pe ~ 1); at cell Pe 0.4
      the manufactured L2 error inflates ~12x over plain Galerkin
      (the p=3 baseline is spectrally accurate, SD is an O(h) method
      — stabilize only when Pe demands it).
    - ``'cell'``: ``h = mean(h_cells_a)`` — robustness-leaning: same
      Pe-21 problem in 32 iterations, but ~110x L2 inflation at
      Pe 0.4.
    - a float: absolute length used directly.

    Pass ``tau`` to override everything with one scalar. Returns
    ``(kappa_axes, taus)`` — both 3-tuples. Note the DIAGONAL
    approximation: for velocities far from axis-aligned this adds some
    crosswind diffusion beyond true streamline stabilization (more
    diffusive, never less stable); the residual-based SUPG cross terms
    are the non-separable remainder and are deliberately not assembled.
    """
    kax = resolve_kappa_axes(mesh, kappa)
    cvel = np.asarray(velocity, dtype=np.float64)
    if cvel.shape != (3,):
        raise ValueError(f"velocity must be a 3-vector, got {cvel.shape}")
    taus = []
    for a in range(3):
        ca = abs(float(cvel[a]))
        if tau is not None:
            taus.append(float(tau))
        elif ca < 1e-300:
            taus.append(0.0)
        else:
            if h_eff == "p":
                h_a = float(np.mean(mesh.h_cells[a])) / float(P)
            elif h_eff == "cell":
                h_a = float(np.mean(mesh.h_cells[a]))
            else:
                h_a = float(h_eff)
            pe = ca * h_a / (2.0 * kax[a])
            taus.append(h_a / (2.0 * ca)
                        * (1.0 / np.tanh(pe) - 1.0 / pe))
    keff = tuple(kax[a] + taus[a] * float(cvel[a]) ** 2 for a in range(3))
    return keff, tuple(taus)


def _make_program(hier, lin_maxiter):
    ops = hier._ops
    levels = hier.levels
    fine = levels[-1]
    coarse, coarse_cfg = hier.coarse, hier.coarse_cfg
    precision = getattr(hier, "precision", "highest")
    exchanges = axis_exchanges(hier)

    def run(data, bw, u0, Cs, cvel, rtol):
        lv = data["levels"][-1]
        ms = (lv["mx"], lv["my"], lv["mz"])

        def A(x):
            yd = ops["apply"](lv, x, fine)  # diffusion+sigma, bc epilogue
            w = jnp.where(lv["bc_marker"], jnp.zeros_like(x), x)
            adv = kron_advection_terms(w, Cs, ms, cvel,
                                       precision=precision,
                                       exchanges=exchanges)
            return jnp.where(lv["bc_marker"], x, yd + adv)

        M = lambda r: v_cycle(
            data, r, ops["pvary"](jnp.zeros_like(r)),
            levels=levels, coarse=coarse, coarse_cfg=coarse_cfg, ops=ops,
        )
        return bicgstab_solve(
            A, bw, u0, M, rtol=rtol, maxiter=lin_maxiter,
            dot=lambda a, c: ops["dot"](a, c, lv),
        )

    vspec = vector_spec(hier) if is_sharded(hier) else None
    return wrap_program(
        hier, run,
        in_specs=(hier.data_specs, vspec, vspec, (P(), P(), P()), P(), P())
        if vspec else None,
        out_specs=(vspec, dict(niter=P(), rnorm=P(), rnorm0=P())),
    )


def convdiff_solve(hier, b, velocity, *, rtol=1e-8, maxiter=200, u0=None):
    """Solve the convection-diffusion system whose symmetric part is
    ``hier``'s fine-level operator (kappa diffusion + optional sigma
    shift) and whose advection velocity is the constant 3-vector
    ``velocity``.

    ``hier`` must be built with ``operator='kron'`` (the advection terms
    reuse the level's per-axis stiffness/mass data; box meshes —
    the same family the kron diffusion backend covers, graded spacing
    included since the 1D advection matrix is scale-free).

    Returns ``(u, info)``; ``info = dict(niter, rel_resid)`` from the
    preconditioned BiCGStab loop (one jitted — shard_map'd when sharded
    — while_loop program).
    """
    if getattr(hier, "operator_kind", None) != "kron":
        raise ValueError(
            "convdiff_solve needs a hierarchy built with operator='kron' "
            f"(got {getattr(hier, 'operator_kind', None)!r}): the "
            "advection terms ride the kron level data (per-axis masses)")
    dtype = hier.dtype
    fine = hier.levels[-1]
    shards = shards_of(hier)
    Cs = tuple(
        jnp.asarray(axis_advection(hier.mesh.nc[a] // shards[a], fine.P),
                    dtype=dtype)
        for a in range(3)
    )
    cvel = jnp.asarray(np.asarray(velocity, dtype=np.float64), dtype=dtype)
    if cvel.shape != (3,):
        raise ValueError(f"velocity must be a 3-vector, got {cvel.shape}")

    key = int(maxiter)
    cache = getattr(hier, "_convdiff_cache", None)
    if cache is None:
        cache = hier._convdiff_cache = {}
    if key not in cache:
        cache[key] = _make_program(hier, key)
    run = cache[key]

    to_w, from_w = layout_converters(hier)
    bw = to_w(np.asarray(b, dtype=dtype))
    uw = jnp.zeros_like(bw) if u0 is None else to_w(np.asarray(u0, dtype=dtype))
    u, info = run(hier.data, bw, uw, Cs, cvel,
                  jnp.asarray(rtol, dtype=dtype))
    rel = float(np.sqrt(float(info["rnorm"]) / max(float(info["rnorm0"]),
                                                   np.finfo(np.float64).tiny)))
    return from_w(u), dict(niter=int(info["niter"]), rel_resid=rel)

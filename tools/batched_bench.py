"""Batched multi-RHS throughput on the accelerator: does the vmapped RHS
axis buy utilization where one RHS does not saturate the device?

Three measurements (f32 'highest', bench.py slope methodology):

- kron p=6 APPLY at ~227k dofs, batch 1 vs 8: per-RHS GDOF/s. Small
  problems are launch/latency-bound on one device; the batch axis
  amortizes that.
- FDM direct SOLVE at 2.05M dofs p=6, batch 1 vs 8: per-RHS ms.
- V-cycle p=(1,3,6) at ~227k dofs (fdm coarse), batch 1 vs 8: per-RHS
  ms/cycle — the preconditioner under `solve_pcg_many`.

Run from the repo root: `python tools/batched_bench.py [--cpu]`.
Prints one JSON line. Self-limiting (no external timeout kills).
"""

import argparse
import json
import os
import sys
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pmg_dolfinx_jax.utils.measure import measure as _measure  # noqa: E402


def _per_rhs(run_factory, batches, lo, hi):
    out = {}
    for k in batches:
        per, spread = _measure(run_factory(k), lo, hi, min_samples=5)
        out[k] = (per / k, spread)
    return out


def bench_apply_small(nc=(10, 10, 10), lo=50, hi=250):
    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.ops.kron import KronLaplacian, kron_laplacian_apply

    P = 6
    mesh = BoxMesh(nc)
    nd = mesh.num_dofs(P)
    op = KronLaplacian(mesh, P, kappa=2.0, dtype=jnp.float32,
                       precision="highest")
    shape = mesh.lattice_shape(P)
    bc3 = op.bc_marker.reshape(shape)

    def factory(k):
        B = jnp.ones((k,) + shape, dtype=jnp.float32)
        f = jax.vmap(
            partial(kron_laplacian_apply, precision="highest"),
            in_axes=(0, None, None, None),
        )

        @partial(jax.jit, static_argnums=(4,))
        def chain(B_, Ks, ms, bc, reps):
            def body(i, V):
                return f(B_ + 1e-30 * V, Ks, ms, bc)

            return jnp.sum(jax.lax.fori_loop(0, reps, body, B_))

        return lambda r: float(chain(B, op.Ks, op.ms, bc3, r))

    per = _per_rhs(factory, (1, 8), lo, hi)
    return nd, {k: (nd / t / 1e9, s) for k, (t, s) in per.items()}


def bench_fdm_2m(nc=(21, 21, 21), lo=20, hi=100):
    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.solvers.fdm import (
        FastDiagonalizationSolver,
        fdm_solve,
    )

    P = 6
    mesh = BoxMesh(nc)
    nd = mesh.num_dofs(P)
    fdm = FastDiagonalizationSolver(mesh, P, kappa=2.0, dtype=jnp.float32)
    shape = mesh.lattice_shape(P)

    def factory(k):
        B = jnp.ones((k,) + shape, dtype=jnp.float32)
        f = jax.vmap(partial(fdm_solve, shape=shape, precision="highest"),
                     in_axes=(0, None, None, None, None))

        # Solver arrays are jit ARGUMENTS (CLAUDE.md closure rule).
        @partial(jax.jit, static_argnums=(5,))
        def chain(B_, Vs, Vts, dinv, bc, reps):
            def body(i, V):
                return f(B_ + 1e-30 * V, Vs, Vts, dinv, bc)

            return jnp.sum(jax.lax.fori_loop(0, reps, body, B_))

        return lambda r: float(chain(B, fdm.Vs, fdm.Vts, fdm.dinv,
                                     fdm.bc_marker, r))

    per = _per_rhs(factory, (1, 8), lo, hi)
    return nd, {k: (t * 1e3, s) for k, (t, s) in per.items()}


def bench_vcycle_small(nc=(10, 10, 10), lo=10, hi=50):
    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy, v_cycle

    mesh = BoxMesh(nc)
    hier = PMGHierarchy(mesh, degrees=(1, 3, 6), kappa=2.0,
                        dtype=jnp.float32, coarse="fdm", operator="kron")
    nd = mesh.num_dofs(6)
    vc = partial(v_cycle, levels=hier.levels, coarse=hier.coarse,
                 coarse_cfg=hier.coarse_cfg, ops=hier.ops)
    vcb = jax.vmap(vc, in_axes=(None, 0, 0))
    shape = hier.levels[-1].shape

    def factory(k):
        B = jnp.ones((k,) + tuple(shape), dtype=jnp.float32)

        @partial(jax.jit, static_argnums=(2,))
        def chain(data, B_, reps):
            def body(i, V):
                return vcb(data, B_ + 1e-30 * V, V)

            return jnp.sum(jax.lax.fori_loop(0, reps, body,
                                             jnp.zeros_like(B_)))

        return lambda r: float(chain(hier.data, B, r))

    per = _per_rhs(factory, (1, 8), lo, hi)
    return nd, {k: (t * 1e3, s) for k, (t, s) in per.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="tiny logic check on CPU (timings meaningless)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    tiny = dict(nc=(4, 4, 4), lo=2, hi=6) if args.cpu else {}

    out = {}
    nd, r = bench_apply_small(**tiny)
    out["apply_small"] = dict(
        ndofs=nd,
        gdofs_b1=round(r[1][0], 3), spread_b1=round(r[1][1], 3),
        gdofs_per_rhs_b8=round(r[8][0], 3), spread_b8=round(r[8][1], 3),
    )
    print(f"[apply {nd}] {out['apply_small']}", flush=True)

    nd, r = bench_fdm_2m(**tiny)
    out["fdm_2m"] = dict(
        ndofs=nd,
        ms_b1=round(r[1][0], 4), spread_b1=round(r[1][1], 3),
        ms_per_rhs_b8=round(r[8][0], 4), spread_b8=round(r[8][1], 3),
    )
    print(f"[fdm {nd}] {out['fdm_2m']}", flush=True)

    nd, r = bench_vcycle_small(**tiny)
    out["vcycle_small"] = dict(
        ndofs=nd,
        ms_b1=round(r[1][0], 4), spread_b1=round(r[1][1], 3),
        ms_per_rhs_b8=round(r[8][0], 4), spread_b8=round(r[8][1], 3),
    )
    print(f"[vcycle {nd}] {out['vcycle_small']}", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

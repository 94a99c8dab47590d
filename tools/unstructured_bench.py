"""DSS unstructured-operator throughput on the accelerator, beside the
dofmap element-gather/scatter-add path (ROADMAP S4).

Measures on the L-shaped demo mesh (provably non-box topology):

- dss_apply        full DSS apply, f32 'highest' (headline)
- dss_apply_default  same with default-precision cell matmuls
- dss_gather / dss_scatter / cells  the three stages in isolation
- dofmap_apply     the element-gather/scatter-add oracle (few reps)
- vcycle           p=(1,3,6) V-cycle ms (smoother coarse)

Run from the repo root: `python tools/unstructured_bench.py [--cpu]
[--n 15]` (n=15 -> 10125 cells, 2.24M dofs at p=6; mesh+layout setup
~30 s host-side). Prints one JSON line. Self-limiting.
"""

import argparse
import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n", type=int, default=15)
    ap.add_argument("--p", type=int, default=6)
    ap.add_argument("--skip-vcycle", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.geometry import (
        geometry_factors, quadrature_weights_3d, tabulate_geometry_dphi)
    from pmg_dolfinx_jax.fem.gll import derivative_matrix
    from pmg_dolfinx_jax.fem.unstructured import l_shaped_hex_mesh
    from pmg_dolfinx_jax.ops.laplacian import laplacian_apply
    from pmg_dolfinx_jax.ops.unstructured import (
        apply_cells, dss_device_tables, dss_gather, dss_laplacian_apply,
        dss_meta, dss_scatter)
    from pmg_dolfinx_jax.utils.measure import measure as _measure

    P = args.p
    n = P + 1
    t0 = time.time()
    mesh = l_shaped_hex_mesh(args.n)
    nd = mesh.num_dofs(P)
    lt = mesh.dss_layout(P)
    meta = dss_meta(lt)
    print(f"setup {time.time()-t0:.1f}s: {mesh.ncells} cells, "
          f"{nd} dofs at p={P}", flush=True)

    G_np, _ = geometry_factors(
        mesh.geometry_x, mesh.geometry_dofmap, tabulate_geometry_dphi(P),
        quadrature_weights_3d(P), xp=np)
    lv = dict(
        dss_device_tables(lt, dtype=jnp.float32),
        G=jnp.asarray(G_np, jnp.float32),
        coeff=jnp.full(mesh.ncells, 2.0, jnp.float32),
        D=jnp.asarray(derivative_matrix(P), jnp.float32),
        bc_marker=jnp.asarray(mesh.boundary_dof_marker(P)),
    )
    dm = jnp.asarray(mesh.dofmap(P))
    x = jnp.ones(nd, jnp.float32)
    u0 = jnp.ones((mesh.ncells, n, n, n), jnp.float32)

    J = partial(jax.jit, static_argnums=(0,))

    @partial(jax.jit, static_argnums=(3,))
    def c_apply(reps, x, lv_, prec):
        # traced reps + pure scaled chain (a static trip count invites
        # XLA to unroll the 27-block concat graph)
        def body(i, v):
            return 1e-4 * dss_laplacian_apply(v, lv_, meta, precision=prec)
        return jax.lax.fori_loop(0, reps, body, x)[0]

    @jax.jit
    def c_roundtrip(reps, x, lv_):
        # gather+scatter round trip (pure linear chain; the two stages
        # cannot be isolated without a DCE-proof consumer, which is the
        # compile hazard above)
        def body(i, v):
            return 0.25 * dss_scatter(dss_gather(v, lv_, meta), lv_, meta)
        return jax.lax.fori_loop(0, reps, body, x)[0]

    @J
    def c_cells(reps, u, lv_):
        def body(i, u):
            y = apply_cells(u, lv_["G"], lv_["coeff"], lv_["D"])
            return u + 1e-30 * y
        return jax.lax.fori_loop(0, reps, body, u)[0, 0, 0, 0]

    @J
    def c_dofmap(reps, x, dm_, lv_):
        def body(i, v):
            return laplacian_apply(v + 1e-30 * v[0], dm_, lv_["G"],
                                   lv_["coeff"], lv_["D"], lv_["bc_marker"])
        return jax.lax.fori_loop(0, reps, body, x)[0]

    out = {"ndofs": nd, "ncells": mesh.ncells}
    runs = [
        ("dss_apply", lambda r: float(c_apply(r, x, lv, "highest")), 10, 40),
        ("dss_apply_default",
         lambda r: float(c_apply(r, x, lv, "default")), 10, 40),
        ("dss_roundtrip", lambda r: float(c_roundtrip(r, x, lv)), 20, 80),
        ("cells_highest", lambda r: float(c_cells(r, u0, lv)), 10, 40),
        ("dofmap_apply", lambda r: float(c_dofmap(r, x, dm, lv)), 1, 3),
    ]
    for name, run, lo, hi in runs:
        try:
            per, spread = _measure(run, lo, hi, min_samples=5)
            out[name] = dict(ms=per * 1e3, spread=round(spread, 3))
            if "apply" in name:
                out[name]["gdofs"] = nd / per / 1e9
            print(f"{name}: {per*1e3:.3f} ms (spread {spread:.3f})"
                  + (f" = {nd/per/1e9:.2f} GDOF/s" if "apply" in name
                     else ""), flush=True)
        except Exception as e:
            out[name] = dict(error=str(e)[:200])
            print(f"{name}: FAILED {e}", flush=True)

    if not args.skip_vcycle:
        from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy, v_cycle

        t0 = time.time()
        hier = PMGHierarchy(mesh, degrees=(1, 3, P), kappa=2.0,
                            dtype=jnp.float32, coarse="smoother",
                            operator="dss", precision="highest")
        print(f"hierarchy setup {time.time()-t0:.1f}s", flush=True)
        vc = partial(v_cycle, levels=hier.levels, coarse=hier.coarse,
                     coarse_cfg=hier.coarse_cfg, ops=hier.ops)

        @partial(jax.jit, static_argnums=(3,))
        def c_vc(data, b, u, reps):
            def body(i, u):
                return vc(data, b, u)
            return jax.lax.fori_loop(0, reps, body, u)[0]

        b = jnp.ones(nd, jnp.float32)
        run = lambda r: float(c_vc(hier.data, b, jnp.zeros(nd, jnp.float32),
                                   r))
        per, spread = _measure(run, 4, 16, min_samples=5)
        out["vcycle"] = dict(ms=per * 1e3, spread=round(spread, 3))
        print(f"vcycle p=(1,3,{P}): {per*1e3:.3f} ms (spread {spread:.3f})",
              flush=True)

    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

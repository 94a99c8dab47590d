"""Benchmark harness: matrix-free p=6 Laplacian apply throughput (GDOF/s).

Mirrors the reference's operator micro-benchmark `mat_free --ndofs N`
(examples/mat_free/main.cpp:260-265: 1000 repeated matvecs under a timer,
the "% Mat-free Matvec" number; SURVEY.md §6). Baseline target from
BASELINE.md: >= 1 GDOF/s per card for the sum-factorized p=6 apply.
Two problem sizes: 2.05M dofs (the round-1 config) and 16.2M dofs (the
reference profiles up to 30M dofs, examples/cg/submit_rocprof.sh — the
large-N regime where the dense axis contraction's O(N) flops/dof bound
bites; see the roofline note in README).

Uses the production operator for the reference's own benchmark problem
(axis-aligned unit-cube mesh): the Kronecker-sum backend (ops/kron.py),
float32 with precision='highest' (true-f32 matmuls, no TF32; agrees with
the f64 assembled oracle to ~1e-7, verified in tests), carrying
LATTICE-SHAPED vectors.

Runs on a GPU only: any other default backend stops the run with a
non-zero exit before anything is measured.

Timing methodology: reps are chained inside one jitted loop with a
scalar reduction read back to the host; per-apply time is the slope
between two rep counts (subtracting launch/readback overhead). The
slope is sampled
repeatedly; the reported value is the median, and sampling widens until
the inner-quartile spread is below SPREAD_TARGET (or the attempt cap is
hit, in which case the spread is reported honestly in the JSON line).

Output contract: the headline JSON line is emitted IMMEDIATELY after
the first measurement, and RE-EMITTED with the enriched extras after
every extra — the last valid JSON line carries everything measured. An
extra that raises is recorded as ``<label>_error`` in that line, and the
process then exits non-zero; a headline that raises prints a 0.0 line
with an ``error`` field and exits non-zero. Extras are time-boxed by
BENCH_TIME_BUDGET_S (wall clock since process start, default 2400 s):
an extra whose estimated cost does not fit the remaining budget is
skipped with an explicit "skipped_budget" marker.
"""

import os
import sys
import json
import time
from functools import partial

import jax
import jax.numpy as jnp

# Extras time budget (seconds of wall clock since process start). Extras
# whose estimated cost exceeds the remaining budget are skipped with a
# "skipped_budget" marker.
TIME_BUDGET_S = float(os.environ.get("BENCH_TIME_BUDGET_S", 2400))
_T_START = time.time()

def _emit(payload):
    print(json.dumps(payload), flush=True)


def _platform():
    return jax.default_backend()


# Shared with the tools/ scripts; lives in the package so importing it
# never re-executes this module's body (bench.py runs as __main__).
from pmg_dolfinx_jax.utils.measure import measure as _measure  # noqa: E402


def _bench_size(nc, lo, hi):
    """The production kron apply (XLA, f32 'highest') at this size;
    returns ``(ndofs, GDOF/s, spread)``."""
    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.ops.kron import KronLaplacian, kron_laplacian_apply

    P = 6
    mesh = BoxMesh((nc, nc, nc))
    nd = mesh.num_dofs(P)
    op = KronLaplacian(mesh, P, kappa=2.0, dtype=jnp.float32,
                       precision="highest")
    shape = mesh.lattice_shape(P)
    x3 = jnp.ones(shape, dtype=jnp.float32)
    bc3 = op.bc_marker.reshape(shape)

    @partial(jax.jit, static_argnums=(4,))
    def chain_xla(x, Ks, ms, bc, reps):
        def body(i, v):
            # Data-dependent perturbation prevents loop-invariant hoisting;
            # 1e-30 underflows against O(1) values so the input stays x.
            return kron_laplacian_apply(
                x + 1e-30 * v, Ks, ms, bc, precision="highest"
            )
        return jnp.sum(jax.lax.fori_loop(0, reps, body, x))

    per_apply, spread = _measure(
        lambda r: float(chain_xla(x3, op.Ks, op.ms, bc3, r)), lo, hi)
    return nd, nd / per_apply / 1e9, spread


def _bench_vcycle_16m(smoother="cheb"):
    """16.2M-dof p=(1,3,6) V-cycle wall time (fdm coarse, f32 'highest')
    for the kron backend, timed as the slope of the jitted cycle scan.
    ``smoother='schwarz'`` times the dense-form cell-wise FDM Schwarz
    cycle (the robustness smoother) instead of Chebyshev."""
    import jax.numpy as jnp

    from pmg_dolfinx_jax.models.poisson import PoissonProblem

    out = {}
    for op in ("kron",):
        prob = PoissonProblem(nc=(42, 42, 42), degrees=(1, 3, 6), kappa=2.0,
                              dtype=jnp.float32, coarse="fdm", operator=op,
                              smoother=smoother)
        # The residual readback synchronizes with the device.
        run = lambda n: float(prob.solve(num_cycles=n)[1][-1])
        per_cycle, spread = _measure(run, 4, 16, min_samples=5)
        out[op] = (per_cycle * 1e3, spread)
        del prob
    return out


def _bench_fdm_solve_2m():
    """Whole-system FDM direct solve at 2.05M dofs (constant kappa):
    the 6-matmul fast-diagonalization SOLVE wall time in ms."""
    import jax
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.solvers.fdm import FastDiagonalizationSolver

    P = 6
    mesh = BoxMesh((21, 21, 21))
    from pmg_dolfinx_jax.solvers.fdm import fdm_solve

    fdm = FastDiagonalizationSolver(mesh, P, kappa=2.0, dtype=jnp.float32)
    shape = mesh.lattice_shape(P)
    b3 = jnp.ones(shape, dtype=jnp.float32)

    # Solver arrays are jit ARGUMENTS, not closures: the 2M-entry
    # dinv/bc lattices feed XLA matmul/elementwise graphs and would
    # constant-fold into the HLO otherwise (CLAUDE.md closure rule).
    @partial(jax.jit, static_argnums=(5, 6))
    def chain(b, Vs, Vts, dinv, bc, shp, reps):
        def body(i, v):
            return fdm_solve(b + 1e-30 * v, Vs, Vts, dinv, bc, shp)
        return jnp.sum(jax.lax.fori_loop(0, reps, body, b))

    run = lambda r: float(chain(b3, fdm.Vs, fdm.Vts, fdm.dinv,
                                fdm.bc_marker, shape, r))
    per_solve, spread = _measure(run, 50, 250, min_samples=5)
    return per_solve * 1e3, spread


def _bench_curved_2m():
    """Curved-hex (PerturbedBoxMesh) 2.05M p=(1,3,6) GENERAL-family
    tracking: V-cycle ms (slope-timed) + warm FCG(V) iteration count to
    1e-6, for cheb AND Schwarz smoothers (lattice 'highest', cg
    coarse)."""
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_jax.models.poisson import PoissonProblem

    out = {}
    for sm in ("cheb", "schwarz"):
        prob = PoissonProblem(mesh=PerturbedBoxMesh((21, 21, 21)),
                              degrees=(1, 3, 6), kappa=2.0,
                              dtype=jnp.float32, coarse="cg",
                              operator="lattice", smoother=sm)
        run = lambda n: float(prob.solve(num_cycles=n)[1][-1])
        per_cycle, spread = _measure(run, 4, 16, min_samples=5)
        _, niter = prob.hierarchy.solve_pcg(prob.b, rtol=1e-6)  # warm
        _, niter = prob.hierarchy.solve_pcg(prob.b, rtol=1e-6)
        out[sm] = dict(vcycle_ms=round(per_cycle * 1e3, 3),
                       spread=round(spread, 3), fcg_iters=int(niter))
        del prob
    return out


def _bench_heat_steps_2m():
    """Scanned transient stepping throughput: heat CN at 2.05M dofs
    p=3, constant kappa — one scanned FDM-step program, slope between
    two step counts (nsteps is a trace-time constant, so both programs
    are warmed first; the slope removes the per-call dispatch)."""
    import time as _time

    import numpy as np
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.solvers.transient import heat_fdm_evolve

    mesh = BoxMesh((42, 42, 42))
    P = 3
    c = mesh.dof_coords(P)
    u0 = np.asarray(
        np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
        * np.sin(np.pi * c[:, 2]), dtype=np.float32)
    evolve = heat_fdm_evolve(mesh, P, kappa=2.0, dt=1e-4, scheme="cn",
                             dtype=jnp.float32)
    lo, hi = 200, 1000
    np.asarray(evolve(u0, lo))
    np.asarray(evolve(u0, hi))  # warm both step-count programs
    samples = []
    for _ in range(5):
        t0 = _time.time()
        np.asarray(evolve(u0, lo))
        t_lo = _time.time() - t0
        t0 = _time.time()
        np.asarray(evolve(u0, hi))
        samples.append(((_time.time() - t0) - t_lo) / (hi - lo))
    per_step = sorted(samples)[len(samples) // 2]
    return 1.0 / per_step


def _bench_unstructured_2m():
    """Fast unstructured (DSS row-gather) operator at 2.24M dofs p=6 on
    the L-shaped mesh (round-5 headline for the unstructured wedge;
    reference parity target: src/laplacian.hpp runs this topology at
    full speed). Slope-timed f32 'highest' apply; the rep count is a
    TRACED argument (a static trip count invites XLA to unroll the
    27-block concat graph — observed 45+ min compiles)."""
    import time as _time

    import numpy as np
    import jax
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.geometry import (
        geometry_factors as _gf,
        quadrature_weights_3d as _qw,
        tabulate_geometry_dphi as _tg,
    )
    from pmg_dolfinx_jax.fem.gll import derivative_matrix as _dm
    from pmg_dolfinx_jax.fem.unstructured import l_shaped_hex_mesh
    from pmg_dolfinx_jax.ops.unstructured import (
        dss_device_tables,
        dss_laplacian_apply,
        dss_meta,
    )

    Pdeg = 6
    mesh = l_shaped_hex_mesh(15)
    nd = mesh.num_dofs(Pdeg)
    lt = mesh.dss_layout(Pdeg)
    meta = dss_meta(lt)
    G_np, _ = _gf(mesh.geometry_x, mesh.geometry_dofmap, _tg(Pdeg),
                  _qw(Pdeg), xp=np)
    lv = dict(
        dss_device_tables(lt, dtype=jnp.float32),
        G=jnp.asarray(G_np, jnp.float32),
        coeff=jnp.full(mesh.ncells, 2.0, jnp.float32),
        D=jnp.asarray(_dm(Pdeg), jnp.float32),
        bc_marker=jnp.asarray(mesh.boundary_dof_marker(Pdeg)),
    )
    x = jnp.ones(nd, jnp.float32)

    @jax.jit
    def chain(reps, x_, lv_):
        def body(i, v):
            # Pure scaled linear chain; the 1e-4 scale keeps 40 chained
            # applies in f32 range.
            return 1e-4 * dss_laplacian_apply(v, lv_, meta,
                                              precision="highest")
        return jax.lax.fori_loop(0, reps, body, x_)[0]

    run = lambda r: float(chain(r, x, lv))
    per, spread = _measure(run, 10, 40, min_samples=5)
    return nd, nd / per / 1e9, spread


def _fallback(extra, error):
    return {
        "metric": "matfree_laplacian_apply_p6_f32_kron",
        "value": 0.0,
        "unit": "GDOF/s",
        "vs_baseline": 0.0,
        "error": error,
        "extra": extra,
    }


def main():
    """Run the bench; returns the process exit code (0 only when the
    headline and every attempted extra succeeded)."""
    extra = {}
    if _platform() != "gpu":
        print(f"bench: default JAX backend is {_platform()!r}, not 'gpu'; "
              "refusing to measure", file=sys.stderr, flush=True)
        return 2
    from pmg_dolfinx_jax.utils.cache import enable_compile_cache

    enable_compile_cache()

    try:
        nd_s, gdofs_s, spread_s = _bench_size(21, 200, 1000)
    except Exception as e:  # noqa: BLE001 — print the line, then fail
        _emit(_fallback(extra, f"headline: {type(e).__name__}: {e}"[:300]))
        return 1
    dev = jax.devices()[0]
    extra.update(ndofs=nd_s, platform=dev.platform,
                 device_kind=dev.device_kind,
                 device_count=len(jax.devices()))

    # The headline line goes out the moment it exists; later re-emissions
    # carry the extras.
    result = {
        "metric": "matfree_laplacian_apply_p6_f32_kron",
        "value": round(gdofs_s, 3),
        "unit": "GDOF/s",
        "vs_baseline": round(gdofs_s / 1.0, 3),
        "spread": round(spread_s, 3),
        "extra": extra,
    }
    _emit(result)
    failed = []

    def guarded(label, est_s, fn):
        """Run one extra: skip (with a marker) if its estimated cost
        does not fit the remaining time budget, record an exception in
        the line (the run then exits non-zero), and re-emit the
        enriched line."""
        import traceback

        elapsed = time.time() - _T_START
        if elapsed + est_s > TIME_BUDGET_S:
            extra[label] = "skipped_budget"
            print(f"bench: skipping {label} (elapsed {int(elapsed)}s + "
                  f"est {int(est_s)}s > budget {int(TIME_BUDGET_S)}s)",
                  file=sys.stderr, flush=True)
            return
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — record, fail at the end
            extra[label + "_error"] = f"{type(e).__name__}: {e}"[:200]
            failed.append(label)
            traceback.print_exc(file=sys.stderr)
        _emit(result)

    def bench_16m():
        # 16.2M dofs: 8x the work per apply, fewer reps needed.
        nd_l, gdofs_l, spread_l = _bench_size(42, 20, 100)
        extra.update(
            gdofs_16M=round(gdofs_l, 3), ndofs_16M=nd_l,
            spread_16M=round(spread_l, 3),
        )

    def bench_30m():
        # 30.4M dofs (N=313): the reference's rocprof profile size
        # (examples/cg/submit_rocprof.sh --ndofs 30000000).
        nd_x, gdofs_x, spread_x = _bench_size(52, 10, 50)
        extra.update(
            gdofs_30M=round(gdofs_x, 3), ndofs_30M=nd_x,
            spread_30M=round(spread_x, 3),
        )

    def bench_vcycle():
        vcycle = _bench_vcycle_16m()
        extra["vcycle_16M_p136_fdm_ms"] = {
            k: round(v[0], 2) for k, v in vcycle.items()
        }

    def bench_fdm():
        fdm_ms, _ = _bench_fdm_solve_2m()
        extra["fdm_solve_2M_ms"] = round(fdm_ms, 3)

    def bench_vcycle_schwarz():
        vcycle = _bench_vcycle_16m(smoother="schwarz")
        extra["vcycle_16M_p136_schwarz_ms"] = {
            k: round(v[0], 2) for k, v in vcycle.items()
        }

    def bench_curved():
        extra["curved_2M_p136"] = _bench_curved_2m()

    def bench_heat():
        extra["heat_cn_2M_steps_per_s"] = round(_bench_heat_steps_2m(), 1)

    def bench_unstructured():
        nd_u, gdofs_u, spread_u = _bench_unstructured_2m()
        extra["unstructured_dss_2M"] = dict(
            ndofs=nd_u, gdofs=round(gdofs_u, 3),
            spread=round(spread_u, 3))

    # Priority order = value of the number, after one cheap extra.
    # Estimated costs are conservative compile+measure figures; the
    # budget gate turns a would-be external timeout into explicit skip
    # markers.
    guarded("fdm_solve_2M", 120, bench_fdm)
    guarded("unstructured_dss_2M", 300, bench_unstructured)
    guarded("16M", 420, bench_16m)
    guarded("30M", 420, bench_30m)
    guarded("vcycle_16M", 540, bench_vcycle)
    guarded("curved_2M", 300, bench_curved)
    guarded("heat_cn_2M", 240, bench_heat)
    guarded("vcycle_16M_schwarz", 540, bench_vcycle_schwarz)
    _emit(result)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

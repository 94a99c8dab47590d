"""Bring-up smoke test: the p-multigrid solver's main path on one GPU.

Runs the public entry points (`PoissonProblem`, `PMGHierarchy`, the
`ops/*` operators, `solvers.transient`) at the sizes users of a
high-order FEM solver run, in phases. Each phase prints one line — its
result, the tolerance it is held to, the seconds spent in setup, in the
first call (compile + one run) and in a warm call — and raises on a
miss; no exception is caught, so any failed phase makes the exit code
non-zero. The last line of standard output is one JSON object naming
the device.

    python chip_smoke.py              # one GPU (the default run)
    python chip_smoke.py --cards 4    # only the four-GPU sharded phase
                                      # and the one-GPU runs it is
                                      # compared with

Without a GPU (or outside a checkout of the repo) it exits non-zero
before printing a result. The phase functions take their sizes as
arguments; tests/test_chip_smoke.py runs each at a tiny size on the CPU.
"""

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
# FCG(V) iterations of the curved phase (PerturbedBoxMesh, p=(1,3,6),
# lattice, Schwarz smoother, cg coarse) to rtol 1e-6, as a float64 CPU
# run of `phase_curved` gives them at nc=4 (pinned by
# tests/test_chip_smoke.py). p-multigrid counts are nearly size
# independent, so the full-size GPU run must land within +-1.
CURVED_FCG_ITERS = 5


def _line(phase, **kv):
    """One phase line: ``phase=<name> k=v ...`` (floats in %.6g)."""
    parts = [f"phase={phase}"]
    for k, v in kv.items():
        if isinstance(v, float):
            v = f"{v:.6g}"
        parts.append(f"{k}={v}")
    print(" ".join(parts), flush=True)


class Clock:
    """Seconds spent in a phase's setup, first call and warm call."""

    def __init__(self):
        self.setup = 0.0
        self.first = 0.0
        self.wall = 0.0

    def run(self, kind, fn, *args, **kwargs):
        import jax

        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kwargs))
        setattr(self, kind, getattr(self, kind) + time.perf_counter() - t0)
        return out

    def fields(self):
        return dict(setup_s=self.setup, first_call_s=self.first,
                    wall_s=self.wall)


def _rel(y, ref):
    y = np.asarray(y, np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    return float(np.linalg.norm(y - ref) / np.linalg.norm(ref))


def _check(ok, msg):
    if not ok:
        raise AssertionError(msg)


# -- phases -----------------------------------------------------------------

def phase_device(n_cards=1):
    """Fail unless JAX's default devices are GPUs (no CPU fallback)."""
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform "
                         f"{d.platform!r}); nothing was run")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: need {n_cards} GPUs, found "
                         f"{len(devs)}")
    _line("device", platform=d.platform, kind=repr(d.device_kind),
          count=len(devs))
    return dict(platform=d.platform, kind=d.device_kind, count=len(devs))


def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    for ln in out.splitlines():
        print(f"card {ln}", flush=True)
    return out


def _dss_apply(mesh, P, dtype, precision):
    """The unstructured DSS operator (`ops.unstructured`) as a jitted
    ``x -> A x`` over device tables built once."""
    import jax
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.geometry import (
        geometry_factors,
        quadrature_weights_3d,
        tabulate_geometry_dphi,
    )
    from pmg_dolfinx_jax.fem.gll import derivative_matrix
    from pmg_dolfinx_jax.ops.unstructured import (
        dss_device_tables,
        dss_laplacian_apply,
        dss_meta,
    )

    layout = mesh.dss_layout(P)
    meta = dss_meta(layout)
    G, _ = geometry_factors(mesh.geometry_x, mesh.geometry_dofmap,
                            tabulate_geometry_dphi(P),
                            quadrature_weights_3d(P), xp=np)
    lv = dict(
        dss_device_tables(layout, dtype=dtype),
        G=jnp.asarray(G, dtype),
        coeff=jnp.full(mesh.ncells, 2.0, dtype),
        D=jnp.asarray(derivative_matrix(P), dtype),
        bc_marker=jnp.asarray(mesh.boundary_dof_marker(P)),
    )
    fn = jax.jit(lambda x, lv_: dss_laplacian_apply(x, lv_, meta,
                                                    precision=precision))
    return lambda x: fn(x, lv)


def phase_parity(nc=21, n_l=15, P=6, precisions=("highest", "high",
                                                  "default")):
    """kron and lattice on the box, dss on the L-shape, f32, against the
    dofmap gather/scatter apply in f64 (the plain reference). 'highest'
    must agree to 1e-5; 'high' and 'default' are measured (TF32 on a
    GPU with tensor cores)."""
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.fem.unstructured import l_shaped_hex_mesh
    from pmg_dolfinx_jax.ops.kron import KronLaplacian
    from pmg_dolfinx_jax.ops.laplacian import MatFreeLaplacian
    from pmg_dolfinx_jax.ops.lattice import LatticeLaplacian

    tol = 1e-5
    clk = Clock()
    rng = np.random.default_rng(SEED)
    errs = {}
    t0 = time.perf_counter()
    mesh = BoxMesh((nc, nc, nc))
    mesh_l = l_shaped_hex_mesh(n_l)
    cases = [("kron", mesh, KronLaplacian), ("lattice", mesh,
                                             LatticeLaplacian),
             ("dss", mesh_l, None)]
    clk.setup += time.perf_counter() - t0
    ndofs = {}
    for name, m, cls in cases:
        t0 = time.perf_counter()
        ref = MatFreeLaplacian(m, P, kappa=2.0, dtype=jnp.float64)
        x = rng.standard_normal(m.num_dofs(P))
        clk.setup += time.perf_counter() - t0
        y_ref = np.asarray(clk.run("first", ref, jnp.asarray(x)))
        ndofs[name] = m.num_dofs(P)
        del ref
        for prec in precisions:
            t0 = time.perf_counter()
            op = (_dss_apply(m, P, jnp.float32, prec) if cls is None
                  else cls(m, P, kappa=2.0, dtype=jnp.float32,
                           precision=prec))
            clk.setup += time.perf_counter() - t0
            x32 = jnp.asarray(x, jnp.float32)
            clk.run("first", op, x32)
            y = clk.run("wall", op, x32)
            errs[f"{name}_{prec}"] = _rel(y, y_ref)
            del op
        gc.collect()
    _line("parity", kron_ndofs=ndofs["kron"], dss_ndofs=ndofs["dss"],
          **{f"err_{k}": v for k, v in errs.items()},
          tol_highest=tol, **clk.fields())
    for name, _, _ in cases:
        if "highest" in precisions:
            e = errs[f"{name}_highest"]
            _check(e <= tol, f"{name} f32 'highest' vs f64 dofmap: {e:.3e}"
                             f" > {tol:g}")
    return errs


def _vcycle_ms(hier, reps=10):
    """Warm time of one fine-level V-cycle (block_until_ready)."""
    import jax
    import jax.numpy as jnp

    fine = hier.levels[-1]
    shape = fine.shape if hier.operator_kind == "kron" else (fine.ndofs,)
    b = jnp.ones(shape, hier.dtype)
    u = jnp.zeros_like(b)
    jax.block_until_ready(hier._vcycle(hier.data, b, u))
    t0 = time.perf_counter()
    for _ in range(reps):
        u = hier._vcycle(hier.data, b, u)
    jax.block_until_ready(u)
    return (time.perf_counter() - t0) / reps * 1e3


def phase_flagship(nc=42, nc_ref=21, degrees=(1, 3, 6), max_iters=8):
    """PoissonProblem at 16.2M dofs (kron, fdm coarse, f32): FCG(V) to
    1e-6 in <= ``max_iters``; then mixed-precision refinement to 1e-10
    at 2.05M, and — measured, not gated — 16 stationary cycles at
    'highest' and at 'high' (TF32) and FCG(V) at 'high'."""
    import warnings

    import jax.numpy as jnp

    from pmg_dolfinx_jax.models.poisson import PoissonProblem

    clk = Clock()
    t0 = time.perf_counter()
    prob = PoissonProblem(nc=(nc,) * 3, degrees=degrees, kappa=2.0,
                          dtype=jnp.float32, coarse="fdm", operator="kron")
    clk.setup += time.perf_counter() - t0
    hier = prob.hierarchy
    clk.run("first", hier.solve_pcg, prob.b, rtol=1e-6, maxiter=30)
    u, iters = clk.run("wall", hier.solve_pcg, prob.b, rtol=1e-6,
                       maxiter=30)
    err = float(prob.error_l2(u))
    vcycle_ms = _vcycle_ms(hier)
    ndofs = hier.levels[-1].ndofs
    del prob, hier, u
    gc.collect()

    t0 = time.perf_counter()
    ref = PoissonProblem(nc=(nc_ref,) * 3, degrees=degrees, kappa=2.0,
                         dtype=jnp.float32, coarse="fdm", operator="kron")
    clk.setup += time.perf_counter() - t0
    r0 = float(np.linalg.norm(np.asarray(ref.b, np.float64)))
    _, rn = clk.run("first", ref.hierarchy.solve_refined, ref.b,
                    num_cycles=60, rtol=1e-10)
    refined = rn[-1] / r0
    _, rn_st = ref.solve(num_cycles=16)
    stall_highest = rn_st[-1] / r0
    del ref
    gc.collect()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the stall is what is measured
        hi = PoissonProblem(nc=(nc_ref,) * 3, degrees=degrees, kappa=2.0,
                            dtype=jnp.float32, coarse="fdm",
                            operator="kron", precision="high")
        _, rn_hi = hi.solve(num_cycles=16)
        _, fcg_high = hi.hierarchy.solve_pcg(hi.b, rtol=1e-6, maxiter=30)
    stall_high = rn_hi[-1] / r0
    del hi
    gc.collect()
    _line("flagship", ndofs=ndofs, fcg_iters=iters,
          max_iters=max_iters, error_l2=err, refined_rel_res=refined,
          refined_cycles=len(rn), refined_tol=1e-10,
          stationary16_rel_res_highest=stall_highest,
          stationary16_rel_res_high=stall_high, fcg_iters_high_2M=fcg_high,
          **clk.fields())
    _check(iters <= max_iters, f"FCG took {iters} > {max_iters}")
    _check(np.isfinite(err) and err < 1e-3, f"L2 error {err}")
    _check(refined < 1e-10, f"refinement stalled at {refined:.3e}")
    return dict(fcg_iters=iters, error_l2=err, vcycle_ms=vcycle_ms,
                ndofs=ndofs)


def phase_curved(nc=21, degrees=(1, 3, 6), dtype=None):
    """Curved hexes (PerturbedBoxMesh), lattice operator, Schwarz
    smoother: FCG(V) to 1e-6 within +-1 of `CURVED_FCG_ITERS`."""
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh
    from pmg_dolfinx_jax.models.poisson import PoissonProblem

    clk = Clock()
    t0 = time.perf_counter()
    prob = PoissonProblem(mesh=PerturbedBoxMesh((nc,) * 3),
                          degrees=degrees, kappa=2.0,
                          dtype=dtype or jnp.float32, coarse="cg",
                          operator="lattice", smoother="schwarz")
    clk.setup += time.perf_counter() - t0
    hier = prob.hierarchy
    clk.run("first", hier.solve_pcg, prob.b, rtol=1e-6, maxiter=30)
    u, iters = clk.run("wall", hier.solve_pcg, prob.b, rtol=1e-6,
                       maxiter=30)
    err = float(prob.error_l2(u))
    ndofs = hier.levels[-1].ndofs
    del prob, hier, u
    gc.collect()
    _line("curved", ndofs=ndofs, fcg_iters=iters,
          expected=f"{CURVED_FCG_ITERS}+-1", error_l2=err, **clk.fields())
    _check(abs(iters - CURVED_FCG_ITERS) <= 1,
           f"curved FCG took {iters}, expected {CURVED_FCG_ITERS}+-1")
    _check(np.isfinite(err), "non-finite L2 error")
    return dict(fcg_iters=iters, error_l2=err)


def phase_unstructured(n=15, degrees=(1, 3, 6), max_iters=8):
    """The L-shaped unstructured hex mesh: dss operator with the SA-AMG
    coarse solve, FCG(V) to 1e-6 in <= ``max_iters``."""
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.assembly import assemble_rhs, l2_error_collocated
    from pmg_dolfinx_jax.fem.unstructured import l_shaped_hex_mesh
    from pmg_dolfinx_jax.models.poisson import f_rhs, u_exact
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    clk = Clock()
    P = degrees[-1]
    t0 = time.perf_counter()
    mesh = l_shaped_hex_mesh(n)
    b = jnp.asarray(assemble_rhs(mesh, P, f_rhs(2.0)), jnp.float32)
    hier = PMGHierarchy(mesh, degrees=degrees, kappa=2.0,
                        dtype=jnp.float32, operator="dss", coarse="amg")
    clk.setup += time.perf_counter() - t0
    clk.run("first", hier.solve_pcg, b, rtol=1e-6, maxiter=30)
    u, iters = clk.run("wall", hier.solve_pcg, b, rtol=1e-6, maxiter=30)
    err = l2_error_collocated(mesh, P, np.asarray(u, np.float64), u_exact)
    ndofs = mesh.num_dofs(P)
    del hier, u
    gc.collect()
    _line("unstructured", ndofs=ndofs, fcg_iters=iters,
          max_iters=max_iters, error_l2=err, **clk.fields())
    _check(iters <= max_iters, f"FCG took {iters} > {max_iters}")
    _check(np.isfinite(err) and err < 1e-3, f"L2 error {err}")
    return dict(fcg_iters=iters, error_l2=err)


def phase_transient(nc=42, P=3, steps=200, B=8, dt=1e-4):
    """Heat CN through the scanned FDM stepper (float64, the stepper's
    default) and the batched (vmap) stepper at batch B: every column
    agrees with its single-state run to 1e-6."""
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.solvers.transient import (batch_evolve,
                                                   heat_fdm_evolve)

    tol = 1e-6
    clk = Clock()
    t0 = time.perf_counter()
    mesh = BoxMesh((nc,) * 3)
    c = mesh.dof_coords(P)
    u0 = (np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
          * np.sin(np.pi * c[:, 2]))
    bc = np.asarray(mesh.boundary_dof_marker(P))
    rng = np.random.default_rng(SEED)
    U0 = np.stack([u0 * (1.0 + 0.25 * k) for k in range(B)])
    U0[1:] += np.where(bc, 0.0, rng.standard_normal((B - 1, u0.size)))
    evolve = heat_fdm_evolve(mesh, P, kappa=2.0, dt=dt, scheme="cn")
    many = batch_evolve(evolve)
    clk.setup += time.perf_counter() - t0
    clk.run("first", evolve, u0, steps)
    t0 = time.perf_counter()
    clk.run("wall", evolve, u0, steps)
    steps_per_s = steps / (time.perf_counter() - t0)
    clk.run("first", many, U0, steps)
    t0 = time.perf_counter()
    UT = np.asarray(clk.run("wall", many, U0, steps))
    batch_steps_per_s = steps / (time.perf_counter() - t0)
    worst = max(_rel(UT[k], evolve(U0[k], steps)) for k in range(B))
    _line("transient", ndofs=mesh.num_dofs(P), steps=steps, batch=B,
          batch_vs_single=worst, tol=tol, steps_per_s=steps_per_s,
          batch_steps_per_s=batch_steps_per_s, **clk.fields())
    _check(np.all(np.isfinite(UT)), "non-finite batched state")
    _check(worst <= tol, f"batched vs single: {worst:.3e} > {tol:g}")
    return dict(batch_vs_single=worst, steps_per_s=steps_per_s)


def _kron_gdofs(nc, reps, P=6):
    """Warm kron apply rate (f32 'highest'): ``reps`` applies chained in
    one jitted loop, timed to block_until_ready."""
    import jax
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.ops.kron import KronLaplacian, kron_laplacian_apply

    mesh = BoxMesh((nc, nc, nc))
    op = KronLaplacian(mesh, P, kappa=2.0, dtype=jnp.float32)
    shape = mesh.lattice_shape(P)
    x = jnp.ones(shape, jnp.float32)
    bc = op.bc_marker.reshape(shape)

    @jax.jit
    def chain(x, Ks, ms, bc):
        def body(i, v):
            # The 1e-30 data dependence keeps each apply in the loop.
            return kron_laplacian_apply(x + 1e-30 * v, Ks, ms, bc)
        return jax.lax.fori_loop(0, reps, body, x)

    jax.block_until_ready(chain(x, op.Ks, op.ms, bc))
    t0 = time.perf_counter()
    jax.block_until_ready(chain(x, op.Ks, op.ms, bc))
    per = (time.perf_counter() - t0) / reps
    return mesh.num_dofs(P), mesh.num_dofs(P) / per / 1e9


def _lattice_gdofs(nc, reps, P=6):
    """Warm lattice (general-hex) apply rate, f32 'highest'."""
    import jax
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.ops.lattice import (LatticeLaplacian,
                                             lattice_laplacian_apply)

    mesh = BoxMesh((nc, nc, nc))
    op = LatticeLaplacian(mesh, P, kappa=2.0, dtype=jnp.float32)
    x = jnp.ones(mesh.num_dofs(P), jnp.float32)

    @jax.jit
    def chain(x, mats, G, bc):
        def body(i, v):
            return lattice_laplacian_apply(x + 1e-30 * v, mats, G, bc)
        return jax.lax.fori_loop(0, reps, body, x)

    args = (x, op.mats, op.G, op.bc_marker)
    jax.block_until_ready(chain(*args))
    t0 = time.perf_counter()
    jax.block_until_ready(chain(*args))
    per = (time.perf_counter() - t0) / reps
    return mesh.num_dofs(P), mesh.num_dofs(P) / per / 1e9


def _kron_batch_gdofs(nc, B, reps, P=6):
    """Per-RHS kron apply rate of a batch of B vectors (jax.vmap — the
    layout `solve_many` and `batch_evolve` use)."""
    import jax
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.ops.kron import KronLaplacian, kron_laplacian_apply

    mesh = BoxMesh((nc, nc, nc))
    op = KronLaplacian(mesh, P, kappa=2.0, dtype=jnp.float32)
    shape = mesh.lattice_shape(P)
    X = jnp.ones((B,) + shape, jnp.float32)
    bc = op.bc_marker.reshape(shape)

    @jax.jit
    def chain(X, Ks, ms, bc):
        many = jax.vmap(lambda v: kron_laplacian_apply(v, Ks, ms, bc))

        def body(i, V):
            return many(X + 1e-30 * V)
        return jax.lax.fori_loop(0, reps, body, X)

    jax.block_until_ready(chain(X, op.Ks, op.ms, bc))
    t0 = time.perf_counter()
    jax.block_until_ready(chain(X, op.Ks, op.ms, bc))
    per = (time.perf_counter() - t0) / reps
    return mesh.num_dofs(P), B * mesh.num_dofs(P) / per / 1e9


def phase_timings(sizes=((21, 200), (42, 50), (52, 30)), lattice=(21, 50),
                  batch=(10, 8, 500), vcycle_ms=None, card=""):
    """Information only: kron apply GDOF/s at each size, the lattice
    apply at 2.05M, the 227k kron apply one at a time and as a vmapped
    batch (per-RHS rate), and the 16.2M V-cycle time from the flagship
    phase, beside the card."""
    clk = Clock()
    out = {}
    t0 = time.perf_counter()
    for nc, reps in sizes:
        nd, rate = _kron_gdofs(nc, reps)
        out[f"kron_gdofs_{nd}"] = rate
        gc.collect()
    nd, out[f"lattice_gdofs_{nd}"] = _lattice_gdofs(*lattice)
    nc_b, B, reps_b = batch
    nd, out[f"kron_gdofs_{nd}_b1"] = _kron_gdofs(nc_b, reps_b)
    nd, out[f"kron_gdofs_per_rhs_{nd}_b{B}"] = _kron_batch_gdofs(
        nc_b, B, max(reps_b // B, 1))
    gc.collect()
    clk.wall += time.perf_counter() - t0
    _line("timings", **out, vcycle16M_ms=vcycle_ms if vcycle_ms is not None
          else "not_measured", card=repr(card), **clk.fields())
    return out


# -- four cards -------------------------------------------------------------

def _assert_spread(tree, n):
    """Every array leaf lives on ``n`` distinct devices."""
    import jax

    for leaf in jax.tree_util.tree_leaves(tree):
        if isinstance(leaf, jax.Array):
            devs = {s.device for s in leaf.addressable_shards}
            _check(len(devs) == n,
                   f"array {leaf.shape} on {len(devs)} devices, not {n}")


def _traj_delta(rn_d, rn_s):
    rn_d, rn_s = np.asarray(rn_d), np.asarray(rn_s)
    _check(np.all(np.isfinite(rn_d)), "non-finite sharded residuals")
    return float(np.max(np.abs(rn_d - rn_s)
                        / np.maximum(np.abs(rn_s), 1e-300)))


def phase_grid4(nc=(84, 84, 42), shards=(2, 2, 1), degrees=(1, 3, 6),
                cycles=5):
    """GridPMG over a (2,2,1) card grid, kron f32, distributed-FDM
    coarse, against the same hierarchy on one card (f32: 1e-4)."""
    import jax
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    tol = 1e-4
    n = int(np.prod(shards))
    clk = Clock()
    t0 = time.perf_counter()
    mesh = BoxMesh(nc)
    P = degrees[-1]
    b = np.random.default_rng(SEED).standard_normal(mesh.num_dofs(P))
    b[np.asarray(mesh.boundary_dof_marker(P))] = 0.0
    kw = dict(degrees=degrees, kappa=2.0, dtype=jnp.float32)
    grid = GridPMG(mesh, shards=shards, coarse="fdm",
                   coarse_cfg=dict(dist=True), **kw)
    clk.setup += time.perf_counter() - t0
    _assert_spread(grid.data, n)
    xd = grid.to_dist(b)
    _assert_spread(xd, n)
    clk.run("first", grid.solve, b, num_cycles=cycles)
    _, rn_d = clk.run("wall", grid.solve, b, num_cycles=cycles)
    del grid, xd
    gc.collect()
    with jax.default_device(jax.devices()[0]):
        single = PMGHierarchy(mesh, coarse="fdm", operator="kron", **kw)
        _, rn_s = single.solve(jnp.asarray(b, jnp.float32),
                               num_cycles=cycles)
    del single
    gc.collect()
    delta = _traj_delta(rn_d, rn_s)
    _line("grid4", ndofs=mesh.num_dofs(P), shards=str(shards).replace(
        " ", ""), traj_delta=delta, tol=tol, devices=n, **clk.fields())
    _check(delta <= tol, f"grid vs single: {delta:.3e} > {tol:g}")
    return delta


def phase_dss4(n=15, degrees=(1, 3, 6), n_cards=4, cycles=4):
    """DSSDist on the L-shape (f64, Schwarz smoother, cg coarse) against
    the single-card dss hierarchy (f64: 1e-10)."""
    import jax
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.assembly import assemble_rhs
    from pmg_dolfinx_jax.fem.unstructured import l_shaped_hex_mesh
    from pmg_dolfinx_jax.models.poisson import f_rhs
    from pmg_dolfinx_jax.parallel.dss_dist import DSSDist
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    tol = 1e-10
    clk = Clock()
    t0 = time.perf_counter()
    mesh = l_shaped_hex_mesh(n)
    b = assemble_rhs(mesh, degrees[-1], f_rhs(2.0))
    kw = dict(degrees=degrees, kappa=2.0, dtype=jnp.float64, coarse="cg",
              smoother="schwarz")
    dist = DSSDist(mesh, n_devices=n_cards, **kw)
    clk.setup += time.perf_counter() - t0
    _assert_spread(dist.data, n_cards)
    clk.run("first", dist.solve, b, num_cycles=cycles)
    _, rn_d = clk.run("wall", dist.solve, b, num_cycles=cycles)
    del dist
    gc.collect()
    with jax.default_device(jax.devices()[0]):
        single = PMGHierarchy(mesh, operator="dss", **kw)
        _, rn_s = single.solve(jnp.asarray(b), num_cycles=cycles)
    del single
    gc.collect()
    delta = _traj_delta(rn_d, rn_s)
    _line("dss4", ndofs=mesh.num_dofs(degrees[-1]), traj_delta=delta,
          tol=tol, devices=n_cards, **clk.fields())
    _check(delta <= tol, f"DSSDist vs single: {delta:.3e} > {tol:g}")
    return delta


def phase_heat4(nc=(84, 84, 42), shards=(2, 2, 1), P=3, steps=200,
                dt=1e-4):
    """The sharded CN heat scan (`heat_dist_evolve`, f64) against the
    single-card scan (1e-10)."""
    import jax

    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.parallel.transient_dist import heat_dist_evolve
    from pmg_dolfinx_jax.solvers.transient import heat_fdm_evolve

    tol = 1e-10
    clk = Clock()
    t0 = time.perf_counter()
    mesh = BoxMesh(nc)
    c = mesh.dof_coords(P)
    u0 = (np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
          * np.sin(np.pi * c[:, 2]))
    dist = heat_dist_evolve(mesh, P, shards, kappa=2.0, dt=dt, scheme="cn")
    clk.setup += time.perf_counter() - t0
    clk.run("first", dist, u0, steps)
    uT_d = np.asarray(clk.run("wall", dist, u0, steps))
    with jax.default_device(jax.devices()[0]):
        uT_s = np.asarray(heat_fdm_evolve(mesh, P, kappa=2.0, dt=dt,
                                          scheme="cn")(u0, steps))
    delta = _rel(uT_d, uT_s)
    _line("heat4", ndofs=mesh.num_dofs(P), steps=steps, delta=delta,
          tol=tol, **clk.fields())
    _check(delta <= tol, f"sharded heat vs single: {delta:.3e} > {tol:g}")
    return delta


def phase_overlap4(n_sh=4, nc=(16, 21, 21), P=6, dump_dir=None):
    """Information only: does the compiled schedule of the sharded kron
    apply run each halo permute beside an independent contraction?"""
    from pmg_dolfinx_jax.utils.overlap import (
        analyze_overlap,
        scheduled_hlo_grid_kron_apply,
        scheduled_hlo_kron_apply,
    )

    res = {}
    for name, hlo in (
            ("slab", scheduled_hlo_kron_apply(n_sh=n_sh, nc=nc, P=P)),
            ("grid", scheduled_hlo_grid_kron_apply(shards=(2, 2, 1),
                                                   nc=(8, 8, 8), P=P))):
        events, n_ov = analyze_overlap(hlo)
        res[name] = dict(
            windows=sum(t.startswith("cp-start") for _, t in events),
            overlapped=n_ov,
            contractions=sum(t.startswith("contraction")
                             for _, t in events))
        if dump_dir:
            with open(os.path.join(dump_dir, f"overlap_{name}.hlo"),
                      "w") as fh:
                fh.write(hlo)
    _line("overlap4", **{f"{k}_{f}": v for k, r in res.items()
                         for f, v in r.items()})
    return res


# -- driver -----------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-GPU sharded phase")
    args = ap.parse_args(argv)

    import jax

    dev = phase_device(args.cards)
    card = card_line()
    jax.config.update("jax_enable_x64", True)
    from pmg_dolfinx_jax.utils.cache import enable_compile_cache

    enable_compile_cache()
    if args.cards == 4:
        out_dir = "chiprun_out" if os.path.isdir("chiprun_out") else None
        phase_grid4()
        phase_dss4()
        phase_heat4()
        phase_overlap4(dump_dir=out_dir)
    else:
        phase_parity()
        flag = phase_flagship()
        phase_curved()
        phase_unstructured()
        phase_transient()
        phase_timings(vcycle_ms=flag["vcycle_ms"], card=card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Wave-equation driver: ``u_tt - div(kappa grad u) = 0``.

Beyond-reference model-family coverage (the reference solves steady
Poisson only, examples/pmg/main.cpp): second-order dynamics built from
the framework's shifted family (solvers/transient.py wave_*).

Integrators:
- ``--scheme newmark`` (default): implicit Newmark-beta, average
  acceleration (beta, gamma) = (1/4, 1/2) — unconditionally stable,
  O(dt^2), EXACT discrete-energy conservation. Every step is one exact
  FDM direct solve with ``sigma = 1/(beta dt^2)``; the whole loop is
  one scanned XLA program. ``--gamma > 0.5`` adds algorithmic damping.
- ``--scheme leapfrog``: explicit central difference — one kron apply
  + pointwise updates per step (no solve). Conditionally stable; pass
  ``--dt 0`` to auto-pick 0.72x the EXACT spectral bound
  ``wave_stable_dt`` (from the FDM eigenvalue sums).

``--mesh perturbed`` steps curved hexes through the shifted PMG
hierarchy (one warm FCG(V) per step).

Accuracy check: the analytic standing wave
``u = cos(omega t) sin(pi x) sin(pi y) sin(pi z)``,
``omega = pi sqrt(3 kappa)``; prints the final-time L2 error, the
relative energy drift, and the step throughput. Orders and the exact
conservation are pinned in tests/test_wave.py.
"""

import json
import time

import numpy as np

from _common import base_parser, parse_shards, setup_jax


def main():
    p = base_parser(__doc__)
    p.add_argument("--degree", type=int, default=3)
    p.add_argument("--dt", type=float, default=1e-3,
                   help="time step; 0 = auto (0.72x the spectral "
                        "stability bound — leapfrog-safe)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--scheme", choices=["newmark", "leapfrog"],
                   default="newmark")
    p.add_argument("--gamma", type=float, default=0.5,
                   help="Newmark gamma (>1/2: algorithmic damping)")
    p.add_argument("--grade", type=str, default="",
                   help="graded spacing 'AXES:RATIO' (e.g. 'z:8')")
    p.add_argument("--mesh", choices=["box", "perturbed"], default="box")
    p.add_argument("--rtol", type=float, default=1e-9,
                   help="per-step FCG tolerance (perturbed mesh only)")
    p.add_argument("--pulse", type=float, default=0.0,
                   help="drive the medium from rest with a Ricker "
                        "wavelet of peak frequency F0 at the domain "
                        "center (separable source f(x,t) = g(t) f(x); "
                        "box mesh) instead of the standing-wave test")
    p.add_argument("--shards", type=str, default="",
                   help="shard the Newmark time loop: 'N' (x-slab) or "
                        "'sx,sy,sz' (device grid) — one distributed FDM "
                        "solve per step, gather-free (box mesh)")
    p.add_argument("--batch", type=int, default=0,
                   help="evolve B independent trajectories through one "
                        "program (jax.vmap of the scanned stepper, "
                        "solvers.transient.batch_evolve)")
    args = p.parse_args()
    shards = parse_shards(args.shards) if args.shards else None
    n_dev = int(np.prod(shards)) if shards is not None else None
    dtype = setup_jax(args, n_cpu_devices=n_dev if args.cpu else None)
    if shards is not None and args.mesh == "perturbed":
        raise SystemExit("--shards rides the distributed FDM/transform "
                         "step programs (box mesh)")

    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.assembly import l2_error, lumped_mass_np
    from pmg_dolfinx_jax.models.poisson import fit_box_cells
    from pmg_dolfinx_jax.ops.kron import KronLaplacian
    from pmg_dolfinx_jax.solvers.transient import (
        wave_leapfrog_evolve, wave_newmark_evolve, wave_pcg_evolve,
        wave_stable_dt)
    from pmg_dolfinx_jax.utils.timers import Timer, list_timings

    P, kappa = args.degree, args.kappa
    nc = fit_box_cells(args.ndofs, P)
    if shards is not None:
        sh3 = (shards, 1, 1) if np.ndim(shards) == 0 else shards
        nc = tuple((c + s - 1) // s * s for c, s in zip(nc, sh3))
    spacing = None
    if args.grade:
        from pmg_dolfinx_jax.fem.mesh import geometric_spacing

        axes_s, ratio_s = args.grade.split(":")
        spacing = tuple(
            geometric_spacing(nc[a], float(ratio_s))
            if "xyz"[a] in axes_s else None
            for a in range(3)
        )
    if args.mesh == "perturbed":
        from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh

        mesh = PerturbedBoxMesh(nc, spacing=spacing)
    else:
        from pmg_dolfinx_jax.fem.mesh import BoxMesh

        mesh = BoxMesh(nc, spacing=spacing)

    dt = args.dt
    if dt == 0.0:
        if args.mesh == "perturbed":
            raise SystemExit("--dt 0 (spectral auto-dt) needs the "
                             "axis-aligned FDM eigenvalues")
        dt = 0.72 * wave_stable_dt(mesh, P, kappa=kappa)
        print(f"auto dt = {dt:.3e} (0.72 x spectral bound)")
    print(f"mesh {nc[0]}x{nc[1]}x{nc[2]} p={P} ({mesh.num_dofs(P)} dofs), "
          f"{args.scheme} dt={dt:g} x {args.steps} steps")

    c = mesh.dof_coords(P)
    u0 = (np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
          * np.sin(np.pi * c[:, 2]))
    v0 = np.zeros_like(u0)
    T = dt * args.steps
    omega = np.pi * np.sqrt(3.0 * kappa)

    f_src, f_time = None, None
    if args.pulse > 0.0:
        if args.mesh == "perturbed":
            raise SystemExit("--pulse rides the box-mesh evolvers")
        from pmg_dolfinx_jax.fem.assembly import assemble_rhs

        # NOTE: bind the pulse parameters as defaults — the closure
        # must not read main()'s f0/t0 names at call time (t0 is
        # rebound to time.time() by the timing blocks below).
        def f_time(t, _f0=args.pulse, _t0=1.0 / args.pulse):
            a = (np.pi * _f0 * (t - _t0)) ** 2
            return (1.0 - 2.0 * a) * np.exp(-a)

        def blob(x):
            r2 = sum((x[a] - 0.5) ** 2 for a in range(3))
            return np.exp(-r2 / (2.0 * 0.05 ** 2))

        f_src = assemble_rhs(mesh, P, blob)
        u0, v0 = np.zeros_like(u0), np.zeros_like(v0)
        print(f"Ricker pulse f0={args.pulse:g} "
              f"(delay t0={1.0 / args.pulse:g}) at the center")

    def u_exact(x):
        return (np.cos(omega * T) * np.sin(np.pi * x[0])
                * np.sin(np.pi * x[1]) * np.sin(np.pi * x[2]))

    if args.batch:
        if args.mesh == "perturbed" or shards is not None:
            raise SystemExit("--batch rides the scanned kron/FDM "
                             "steppers (axis-aligned box, unsharded)")
        from pmg_dolfinx_jax.solvers.transient import batch_evolve

        B = args.batch
        with Timer("setup"):
            if args.scheme == "newmark":
                one = wave_newmark_evolve(mesh, P, kappa=kappa, dt=dt,
                                          gamma=args.gamma, dtype=dtype,
                                          f=f_src, f_time=f_time)
            else:
                one = wave_leapfrog_evolve(mesh, P, kappa=kappa, dt=dt,
                                           dtype=dtype, f=f_src,
                                           f_time=f_time)
            evolve = batch_evolve(one)
        U0 = np.broadcast_to(u0, (B, u0.size)).astype(dtype)
        V0 = np.zeros_like(U0)
        with Timer(f"warmup (compile + {args.steps} steps)"):
            np.asarray(evolve(U0, V0, args.steps)[0])
        with Timer(f"evolve ({args.steps} steps x batch {B})"):
            t0 = time.time()
            UT, VT = (np.asarray(a) for a in evolve(U0, V0, args.steps))
            wall = time.time() - t0
        err = l2_error(mesh, P, UT[0].astype(np.float64), u_exact)
        rate = args.steps * B / wall
        print(f"L2 error at T={T:g} (col 0): {err:.4e}")
        print(f"throughput: {rate:.1f} column-steps/s "
              f"({args.steps / wall:.1f} batch-steps/s)")
        list_timings()
        print(json.dumps({"l2_error": float(err),
                          "column_steps_per_s": rate}))
        return

    m3 = lumped_mass_np(mesh, P, bc_zero=True)
    op64 = KronLaplacian(mesh, P, kappa=kappa, dtype=jnp.float64) \
        if args.mesh == "box" else None

    def energy(u, v):
        if op64 is None:
            return float("nan")
        u = np.asarray(u, np.float64).reshape(-1)
        v = np.asarray(v, np.float64).reshape(-1)
        Ku = np.asarray(op64(jnp.asarray(u))).reshape(-1)
        return 0.5 * (v @ (m3 * v) + u @ Ku)

    with Timer("setup"):
        if args.mesh == "perturbed":
            from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

            if args.scheme == "leapfrog":
                raise SystemExit("leapfrog is kron-family only "
                                 "(needs the lumped-mass box apply)")
            beta = 0.25
            hier = PMGHierarchy(mesh, degrees=(1, P), kappa=kappa,
                                sigma=1.0 / (beta * dt * dt), dtype=dtype,
                                coarse="cg", operator="lattice")
            evolve = wave_pcg_evolve(hier, mesh, P, dt, gamma=args.gamma,
                                     rtol=args.rtol)
        elif args.scheme == "newmark":
            if shards is not None:
                from pmg_dolfinx_jax.parallel.transient_dist import (
                    wave_newmark_dist_evolve)

                print(f"sharded time loop: shards {shards} "
                      "(distributed FDM step solves, gather-free)")
                evolve = wave_newmark_dist_evolve(
                    mesh, P, shards, kappa=kappa, dt=dt,
                    gamma=args.gamma, dtype=dtype, f=f_src, f_time=f_time)
            else:
                evolve = wave_newmark_evolve(mesh, P, kappa=kappa, dt=dt,
                                             gamma=args.gamma, dtype=dtype,
                                             f=f_src, f_time=f_time)
        elif shards is not None:
            from pmg_dolfinx_jax.parallel.transient_dist import (
                wave_leapfrog_dist_evolve)

            print(f"sharded time loop: shards {shards} "
                  "(distributed forward transform apply per step)")
            evolve = wave_leapfrog_dist_evolve(
                mesh, P, shards, kappa=kappa, dt=dt, dtype=dtype,
                f=f_src, f_time=f_time)
        else:
            evolve = wave_leapfrog_evolve(mesh, P, kappa=kappa, dt=dt,
                                          dtype=dtype, f=f_src,
                                          f_time=f_time)

    E0 = energy(u0, v0)
    # Warm the SCANNED paths with the full step count: nsteps is a
    # trace-time constant of the scanned program, so a 1-step warmup
    # would leave the n-step program's compile inside the timed region
    # (observed ~15 s of XLA compile attributed to "evolve" before
    # this). The perturbed path loops on the host and compiles its
    # per-step solve on the first step — 1 warmup step suffices there.
    nwarm = 1 if args.mesh == "perturbed" else args.steps
    with Timer(f"warmup (compile + {nwarm} steps)"):
        out = evolve(u0, v0, nwarm)
        np.asarray(out[0])

    with Timer(f"evolve ({args.steps} steps)"):
        t0 = time.time()
        out = evolve(u0, v0, args.steps)
        uT, vT = np.asarray(out[0]), np.asarray(out[1])
        wall = time.time() - t0
    if args.mesh == "perturbed":
        iters = out[2]
        print(f"FCG iterations/step: min {min(iters)} max {max(iters)}")

    ET = energy(uT, vT)
    if args.pulse > 0.0:
        # Driven from rest: report the injected energy and amplitude
        # (no analytic standing-wave error applies).
        print(f"T={T:g}: radiated field max|u| = "
              f"{float(np.max(np.abs(uT))):.4e}, energy E_T = {ET:.4e}")
        print(f"throughput: {args.steps / wall:.1f} steps/s")
        list_timings()
        print(json.dumps({"energy_T": float(ET),
                          "max_abs_u": float(np.max(np.abs(uT))),
                          "steps_per_s": args.steps / wall}))
        return
    err = l2_error(mesh, P, uT.reshape(-1), u_exact)
    drift = abs(ET - E0) / E0 if np.isfinite(E0) and E0 > 0 else float("nan")
    print(f"L2 error at T={T:g}: {err:.4e} "
          f"(analytic cos({omega:.3f} T) = {np.cos(omega*T):+.4f})")
    if np.isfinite(drift):
        print(f"energy drift |E_T - E_0|/E_0 = {drift:.3e}")
    print(f"throughput: {args.steps / wall:.1f} steps/s")
    list_timings()
    print(json.dumps({"l2_error": float(err),
                      "energy_drift": float(drift),
                      "steps_per_s": args.steps / wall}))


if __name__ == "__main__":
    main()

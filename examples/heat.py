"""Transient heat-equation driver: ``u_t - div(kappa grad u) = 0``.

Beyond-reference model-family coverage (the reference solves steady
Poisson only, examples/pmg/main.cpp): implicit time stepping built from
the framework's shifted (reaction-diffusion) family with
``sigma = 1/dt`` (solvers/transient.py).

On the kron family (axis-aligned boxes, incl. --grade) every step is
ONE exact FDM direct solve — six small matmuls — and the whole time loop
compiles to a single XLA `lax.scan` program: zero host round-trips
between steps. General meshes (--mesh perturbed) step through the
shifted PMG hierarchy with one warm FCG(V) solve per step.

Accuracy check: the manufactured separable mode
``u = exp(-3 kappa pi^2 t) sin(pi x) sin(pi y) sin(pi z)`` (f = 0);
prints the final-time L2 error and the step throughput. Backward Euler
is O(dt), Crank-Nicolson O(dt^2) (pinned in tests/test_heat.py).
"""

import json
import time

import numpy as np

from _common import base_parser, parse_shards, setup_jax


def main():
    p = base_parser(__doc__)
    p.add_argument("--degree", type=int, default=3)
    p.add_argument("--dt", type=float, default=1e-3)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--scheme", choices=["be", "cn"], default="cn")
    p.add_argument("--grade", type=str, default="",
                   help="graded spacing 'AXES:RATIO' (e.g. 'z:8'); the "
                        "FDM step solve stays exact on graded meshes")
    p.add_argument("--fixed-iters", type=int, default=0,
                   help="perturbed mesh: >0 runs the SCANNED general "
                   "stepper with this fixed per-step FCG count (one "
                   "compiled lax.scan, no per-step dispatch) instead "
                   "of the adaptive host loop")
    p.add_argument("--mesh", choices=["box", "perturbed"], default="box",
                   help="'perturbed': curved hexes — steps through the "
                        "shifted PMG hierarchy (FCG per step) instead "
                        "of the direct FDM solve")
    p.add_argument("--rtol", type=float, default=1e-9,
                   help="per-step FCG tolerance (perturbed mesh only)")
    p.add_argument("--batch", type=int, default=0,
                   help="serving mode: step BATCH initial conditions "
                        "through one program (jax.vmap of the scanned "
                        "FDM stepper, solvers.transient.batch_evolve)")
    p.add_argument("--shards", type=str, default="",
                   help="shard the scanned time loop: 'N' (x-slab) or "
                        "'sx,sy,sz' (device grid) — one distributed FDM "
                        "solve per step, gather-free (box mesh, "
                        "parallel/transient_dist.py)")
    p.add_argument("--save-series", type=str, default="",
                   help="write trajectory snapshots PREFIX_NNNN.vtk "
                        "(or .npz) every --snap-every steps "
                        "(solvers.transient.snapshot_evolve)")
    p.add_argument("--snap-every", type=int, default=10)
    args = p.parse_args()
    shards = parse_shards(args.shards) if args.shards else None
    n_dev = int(np.prod(shards)) if shards is not None else None
    dtype = setup_jax(args, n_cpu_devices=n_dev if args.cpu else None)

    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.assembly import l2_error
    from pmg_dolfinx_jax.models.poisson import fit_box_cells
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
    print(f"mesh {nc[0]}x{nc[1]}x{nc[2]} p={P} ({mesh.num_dofs(P)} dofs), "
          f"{args.scheme} dt={args.dt:g} x {args.steps} steps")

    c = mesh.dof_coords(P)
    u0 = (np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
          * np.sin(np.pi * c[:, 2]))
    T = args.dt * args.steps
    lam = 3.0 * np.pi**2 * kappa

    def u_exact(x):
        return (np.exp(-lam * T) * np.sin(np.pi * x[0])
                * np.sin(np.pi * x[1]) * np.sin(np.pi * x[2]))

    if shards is not None and (args.mesh == "perturbed" or args.batch):
        raise SystemExit("--shards rides the distributed FDM step solve "
                         "(axis-aligned box, unbatched)")
    if args.batch:
        if args.mesh == "perturbed":
            raise SystemExit("--batch rides the scanned FDM stepper "
                             "(axis-aligned box only)")
        from pmg_dolfinx_jax.solvers.transient import (batch_evolve,
                                                       heat_fdm_evolve)

        B = args.batch
        with Timer("setup"):
            evolve = batch_evolve(heat_fdm_evolve(
                mesh, P, kappa=kappa, dt=args.dt, scheme=args.scheme,
                dtype=dtype))
        U0 = np.broadcast_to(u0, (B, u0.size)).astype(dtype)
        # Warm with the FULL step count: nsteps is a trace-time
        # constant of the scanned program — a 1-step warmup leaves the
        # n-step compile inside the timed region.
        with Timer(f"warmup (compile + {args.steps} steps)"):
            np.asarray(evolve(U0, args.steps))
        with Timer(f"evolve ({args.steps} steps x batch {B})"):
            t0 = time.time()
            UT = np.asarray(evolve(U0, args.steps))
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

    with Timer("setup"):
        if args.mesh == "perturbed":
            from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy
            from pmg_dolfinx_jax.solvers.transient import heat_pcg_evolve

            kap_op = kappa / 2 if args.scheme == "cn" else kappa
            # --fixed-iters (the scanned stepper) uses the smoother
            # coarse: the cg coarse's 60-iteration while_loop nested
            # inside the scanned FCG body blows the compile up at
            # large N (heat_pcg_evolve_scanned docstring).
            coarse = "smoother" if args.fixed_iters else "cg"
            hier = PMGHierarchy(mesh, degrees=(1, P), kappa=kap_op,
                                sigma=1.0 / args.dt, dtype=dtype,
                                coarse=coarse, operator="lattice")
            if args.fixed_iters:
                from pmg_dolfinx_jax.solvers.transient import (
                    heat_pcg_evolve_scanned)

                evolve = heat_pcg_evolve_scanned(
                    hier, mesh, P, args.dt, scheme=args.scheme,
                    inner_iters=args.fixed_iters)
            else:
                evolve = heat_pcg_evolve(hier, mesh, P, args.dt,
                                         scheme=args.scheme,
                                         rtol=args.rtol)
        elif shards is not None:
            from pmg_dolfinx_jax.parallel.transient_dist import (
                heat_dist_evolve)

            print(f"sharded time loop: shards {shards} "
                  "(distributed FDM step solves, gather-free)")
            evolve = heat_dist_evolve(mesh, P, shards, kappa=kappa,
                                      dt=args.dt, scheme=args.scheme,
                                      dtype=dtype)
        else:
            from pmg_dolfinx_jax.solvers.transient import heat_fdm_evolve

            evolve = heat_fdm_evolve(mesh, P, kappa=kappa, dt=args.dt,
                                     scheme=args.scheme, dtype=dtype)

    # Warm the scanned (box) path with the step counts the TIMED region
    # will actually run — nsteps is a trace-time constant, so warming a
    # different count leaves that program's compile inside the timed
    # region (observed ~15 s of XLA compile attributed to "evolve").
    # Plain runs call the full-nsteps program; --save-series calls only
    # the `every`-chunk and (if nsteps % every != 0) the ragged-tail
    # chunk — warm those two instead. The perturbed path loops on the
    # host; its per-step solve compiles on the first step.
    scanned_general = args.mesh == "perturbed" and args.fixed_iters
    if args.mesh == "perturbed" and not scanned_general:
        nwarm, tail = 1, 0
    elif args.save_series and not scanned_general:
        nwarm = min(args.snap_every, args.steps)
        tail = args.steps % args.snap_every
    else:
        nwarm, tail = args.steps, 0
    with Timer(f"warmup (compile + {nwarm} steps)"):
        if args.mesh == "perturbed" and not scanned_general:
            evolve(u0, nwarm)
        else:
            np.asarray(evolve(u0, nwarm))
            if tail and tail != nwarm:
                np.asarray(evolve(u0, tail))

    if args.save_series and args.mesh != "perturbed":
        from pmg_dolfinx_jax.solvers.transient import snapshot_evolve
        from pmg_dolfinx_jax.utils.io import write_npz, write_vtk

        with Timer(f"evolve+snapshots ({args.steps} steps)"):
            t0 = time.time()
            snaps, uT = snapshot_evolve(evolve, u0, args.steps,
                                        args.snap_every)
            uT = np.asarray(uT)
            wall = time.time() - t0
        ext = ".npz" if args.save_series.endswith(".npz") else ".vtk"
        prefix = args.save_series.removesuffix(ext)
        writer = write_npz if ext == ".npz" else write_vtk
        for k, (step, u) in enumerate(snaps):
            writer(f"{prefix}_{k:04d}{ext}", mesh, P,
                   np.asarray(u).reshape(-1))
        print(f"wrote {len(snaps)} snapshots to {prefix}_*{ext}")
    else:
        if args.save_series:
            print("--save-series rides the scanned box evolvers; "
                  "ignoring it on --mesh perturbed")
        with Timer(f"evolve ({args.steps} steps)"):
            t0 = time.time()
            if args.mesh == "perturbed" and not scanned_general:
                uT, iters = evolve(u0, args.steps)
                print(f"FCG iterations/step: min {min(iters)} "
                      f"max {max(iters)}")
            else:
                uT = np.asarray(evolve(u0, args.steps))
            wall = time.time() - t0

    err = l2_error(mesh, P, np.asarray(uT).reshape(-1), u_exact)
    print(f"L2 error at T={T:g}: {err:.4e} "
          f"(analytic decay exp(-{lam:.3f} T) = {np.exp(-lam*T):.4e})")
    print(f"throughput: {args.steps / wall:.1f} steps/s")
    list_timings()
    print(json.dumps({"l2_error": float(err),
                      "steps_per_s": args.steps / wall}))


if __name__ == "__main__":
    main()

"""Convection-diffusion driver: nonsymmetric steady transport.

Solves ``-div(kappa grad u) + c . grad u + sigma u = f`` on the unit
cube with a constant velocity ``c`` (`solvers/convdiff.py`): the
advection operator rides the Kronecker separability (three extra
matmuls per apply, `ops.kron.axis_advection`), and the nonsymmetric
system is solved by BiCGStab preconditioned with the framework's
V-cycle on the symmetric (diffusion + sigma) part.

Beyond reference parity — the reference is symmetric-Poisson-only.
Example:

    python examples/convdiff.py --ndofs 2000000 --velocity 10,0,0
    python examples/convdiff.py --peclet-sweep --cpu --dtype f64
    python examples/convdiff.py --transient --steps 500   # IMEX stepping
"""

import json
import time

import numpy as np

from _common import base_parser, parse_shards, setup_jax


def main():
    p = base_parser(__doc__)
    p.add_argument("--degrees", type=int, nargs="+", default=[1, 3])
    p.add_argument("--velocity", type=str, default="3,-1.5,0.8",
                   help="constant advection velocity 'cx,cy,cz'")
    p.add_argument("--sigma", type=float, default=0.0)
    p.add_argument("--coarse", choices=["smoother", "cg", "direct",
                                        "hmg", "fdm"], default="fdm")
    p.add_argument("--rtol", type=float, default=1e-9)
    p.add_argument("--maxiter", type=int, default=200)
    p.add_argument("--peclet-sweep", action="store_true",
                   help="sweep |c| over a decade ladder and report the "
                        "BiCGStab iteration counts (the symmetric-"
                        "preconditioner degradation curve)")
    p.add_argument("--warm", action="store_true")
    p.add_argument("--transient", action="store_true",
                   help="IMEX time stepping (implicit FDM diffusion + "
                        "explicit advection, one scanned XLA program) "
                        "driven to the steady state by the manufactured "
                        "source — no nonsymmetric solve at all")
    p.add_argument("--dt", type=float, default=0.0,
                   help="IMEX step size (default: advective CFL / 4)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--scheme", choices=["be", "cnab"], default="cnab")
    p.add_argument("--stabilize", choices=["p", "cell"], default="",
                   help="streamline-diagonal artificial diffusion for "
                        "cell Pe > 1 (sd_stabilized_kappa): 'p' = h/P "
                        "scale (accuracy-leaning), 'cell' = h scale "
                        "(robustness-leaning)")
    p.add_argument("--shards", type=str, default="",
                   help="shard the solve/time loop: 'N' (x-slab) or "
                        "'sx,sy,sz' (device grid)")
    args = p.parse_args()
    shards = parse_shards(args.shards) if args.shards else None
    n_dev = int(np.prod(shards)) if shards is not None else None
    dtype = setup_jax(args, n_cpu_devices=n_dev if args.cpu else None)

    from pmg_dolfinx_jax.fem.assembly import assemble_rhs, l2_error
    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.models.poisson import fit_box_cells, u_exact
    from pmg_dolfinx_jax.solvers.convdiff import (convdiff_solve,
                                                  sd_stabilized_kappa)
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy
    from pmg_dolfinx_jax.utils.timers import Timer, list_timings

    if args.operator != "kron":
        print("convection-diffusion rides the kron level data: "
              "forcing --operator kron")
        args.operator = "kron"
    nc = fit_box_cells(args.ndofs, max(args.degrees))
    if shards is not None:
        sh3 = (shards, 1, 1) if np.ndim(shards) == 0 else shards
        nc = tuple((c + s - 1) // s * s for c, s in zip(nc, sh3))
    mesh = BoxMesh(nc)
    P = max(args.degrees)
    cvel = np.array([float(s) for s in args.velocity.split(",")])
    assert cvel.shape == (3,), "--velocity expects 'cx,cy,cz'"
    print(f"mesh {nc}, {mesh.num_dofs(P)} dofs, degrees {args.degrees}, "
          f"kappa {args.kappa}, velocity {tuple(float(c) for c in cvel)}")

    pi = np.pi

    def f(x):
        sx, sy, sz = (np.sin(pi * x[a]) for a in range(3))
        cx, cy, cz = (np.cos(pi * x[a]) for a in range(3))
        g = (pi * cx * sy * sz, pi * sx * cy * sz, pi * sx * sy * cz)
        return ((3.0 * pi**2 * args.kappa + args.sigma) * sx * sy * sz
                + sum(c_ * g_ for c_, g_ in zip(cvel, g)))

    if args.transient:
        from pmg_dolfinx_jax.solvers.transient import (
            convdiff_advective_dt, convdiff_fdm_evolve)

        kap = args.kappa
        if args.stabilize:
            # Same constant-diagonal-tensor mechanism as the steady
            # branch: the stabilized kappa rides the FDM step solver.
            kap, _ = sd_stabilized_kappa(mesh, P, cvel, args.kappa,
                                         h_eff=args.stabilize)
            print(f"SD stabilization ({args.stabilize}): kappa_eff "
                  f"{tuple(round(float(k), 6) for k in kap)}")
        dt_adv = convdiff_advective_dt(mesh, P, cvel)
        dt = args.dt if args.dt > 0 else 0.25 * dt_adv
        if dt >= dt_adv:
            print(f"WARNING: dt {dt:g} >= advective CFL {dt_adv:g} — "
                  "the explicit advection term will blow up")
        with Timer("setup (assembly + FDM factorization)"):
            b = assemble_rhs(mesh, P, f)
            if shards is not None:
                from pmg_dolfinx_jax.parallel.transient_dist import (
                    convdiff_dist_evolve)

                print(f"sharded IMEX loop: shards {shards}")
                evolve = convdiff_dist_evolve(
                    mesh, P, shards, cvel, kappa=kap, dt=dt,
                    scheme=args.scheme, sigma=args.sigma, dtype=dtype,
                    f=b)
            else:
                evolve = convdiff_fdm_evolve(
                    mesh, P, cvel, kappa=kap, dt=dt,
                    scheme=args.scheme, sigma=args.sigma, dtype=dtype,
                    f=b)
        u0 = np.zeros(mesh.num_dofs(P))
        # Warm with the FULL step count: nsteps is a trace-time constant
        # of the scanned program (same rule as examples/heat.py).
        with Timer(f"warmup (compile + {args.steps} steps)"):
            np.asarray(evolve(u0, args.steps))
        with Timer(f"evolve ({args.steps} steps)"):
            t0 = time.time()
            uT = np.asarray(evolve(u0, args.steps))
            wall = time.time() - t0
        err = l2_error(mesh, P, np.asarray(uT, dtype=np.float64).reshape(-1),
                       u_exact)
        print(f"{args.scheme} dt={dt:g} (advective CFL {dt_adv:g}), "
              f"T={dt * args.steps:g}: steady-state L2 err {err:.3e}")
        print(f"throughput: {args.steps / wall:.1f} steps/s")
        list_timings()
        print(json.dumps({"l2_error": float(err),
                          "steps_per_s": args.steps / wall}))
        return

    def make_hier(cv):
        kap = args.kappa
        if args.stabilize:
            kap, taus = sd_stabilized_kappa(mesh, P, cv, args.kappa,
                                            h_eff=args.stabilize)
            print(f"SD stabilization ({args.stabilize}): kappa_eff "
                  f"{tuple(round(float(k), 6) for k in kap)}")
        kw = dict(degrees=tuple(args.degrees), kappa=kap, dtype=dtype,
                  coarse=args.coarse, operator="kron", sigma=args.sigma)
        if shards is None:
            return PMGHierarchy(mesh, **kw)
        if np.ndim(shards) == 0:
            from pmg_dolfinx_jax.parallel.dist import DistPMG

            return DistPMG(mesh, n_devices=int(shards), **kw)
        from pmg_dolfinx_jax.parallel.grid2d import GridPMG

        return GridPMG(mesh, shards=tuple(shards), **kw)

    with Timer("setup (hierarchy build + calibration + rhs)"):
        hier = make_hier(cvel)
        b = assemble_rhs(mesh, P, f)

    h_min = min(float(np.min(mesh.h_cells[a])) for a in range(3))
    if args.peclet_sweep:
        base = cvel / max(np.linalg.norm(cvel), 1e-300)
        print(f"{'|c|':>10} {'cell Pe':>10} {'iters':>6} {'rel resid':>11} "
              f"{'L2 err':>10}")
        for mag in (1.0, 10.0, 100.0, 1000.0):
            cv = base * mag
            bs = assemble_rhs(mesh, P, _sweep_f(args.kappa, args.sigma, cv))
            hs = make_hier(cv) if args.stabilize else hier
            u, info = convdiff_solve(hs, bs, cv, rtol=args.rtol,
                                     maxiter=args.maxiter)
            err = l2_error(mesh, P, np.asarray(u, dtype=np.float64),
                           u_exact)
            pe = mag * h_min / (2.0 * args.kappa)
            print(f"{mag:10.1f} {pe:10.3f} {info['niter']:6d} "
                  f"{info['rel_resid']:11.2e} {err:10.2e}")
        list_timings()
        return

    pe0 = float(np.linalg.norm(cvel)) * h_min / (2.0 * args.kappa)
    if pe0 > 1.0 and not args.stabilize:
        print(f"WARNING: cell Peclet {pe0:.2f} > 1 — the unstabilized "
              "Galerkin discretization is under-resolved (expect "
              "oscillations) and the symmetric V-cycle preconditioner "
              "degrades; refine the mesh, raise kappa, or pass "
              "--stabilize p|cell")
    kw = dict(rtol=args.rtol, maxiter=args.maxiter)
    if args.warm:
        convdiff_solve(hier, b, cvel, **kw)
    with Timer("bicgstab solve"):
        u, info = convdiff_solve(hier, b, cvel, **kw)
    err = l2_error(mesh, P, np.asarray(u, dtype=np.float64), u_exact)
    pe = float(np.linalg.norm(cvel)) * h_min / (2.0 * args.kappa)
    print(f"cell Peclet {pe:.3f}: {info['niter']} BiCGStab iterations, "
          f"rel resid {info['rel_resid']:.2e}, L2 err {err:.3e}")
    list_timings()


def _sweep_f(kappa, sigma, cvel):
    pi = np.pi

    def f(x):
        sx, sy, sz = (np.sin(pi * x[a]) for a in range(3))
        cx, cy, cz = (np.cos(pi * x[a]) for a in range(3))
        g = (pi * cx * sy * sz, pi * sx * cy * sz, pi * sx * sy * cz)
        return ((3.0 * pi**2 * kappa + sigma) * sx * sy * sz
                + sum(c_ * g_ for c_, g_ in zip(cvel, g)))

    return f


if __name__ == "__main__":
    main()

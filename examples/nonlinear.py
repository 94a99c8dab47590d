"""Semilinear reaction-diffusion driver: inexact Newton–Krylov.

Solves ``-div(kappa grad u) + sigma u + N(u) = f`` on the unit cube with
``N(u) = c u^3`` (monotone, manufactured solution) or the Bratu–Gelfand
problem ``-lap u = lam e^u`` (``--model bratu``), via
`solvers.newton.newton_solve`: every Newton step is a V-cycle-
preconditioned flexible-CG solve of the matrix-free Jacobian, with
Eisenstat–Walker forcing on the inner tolerances.

Beyond reference parity — the reference (examples/pmg/main.cpp) is
linear-only. Example:

    python examples/nonlinear.py --ndofs 2000000 --model cubic --c 5
    python examples/nonlinear.py --model bratu --lam 5 --cpu --dtype f64
    python examples/nonlinear.py --mesh perturbed --kappa-field linear
"""

import numpy as np

from _common import base_parser, setup_jax


def main():
    p = base_parser(__doc__)
    p.add_argument("--degrees", type=int, nargs="+", default=[1, 3])
    p.add_argument("--model", choices=["cubic", "bratu"], default="cubic")
    p.add_argument("--c", type=float, default=5.0,
                   help="cubic coefficient N(u) = c u^3")
    p.add_argument("--lam", type=float, default=5.0,
                   help="Bratu parameter (keep below the 3D fold ~6.8)")
    p.add_argument("--sigma", type=float, default=0.0,
                   help="additional linear reaction shift")
    p.add_argument("--coarse", choices=["smoother", "cg", "direct",
                                        "hmg", "fdm"], default="fdm")
    p.add_argument("--mesh", choices=["box", "perturbed"], default="box")
    p.add_argument("--kappa-field", choices=["const", "linear"],
                   default="const")
    p.add_argument("--rtol", type=float, default=1e-9)
    p.add_argument("--maxiter", type=int, default=20)
    p.add_argument("--lin-maxiter", type=int, default=60)
    p.add_argument("--warm", action="store_true",
                   help="run one throwaway solve first so the timed solve "
                        "excludes jit compilation")
    p.add_argument("--transient", action="store_true",
                   help="time-step u_t - div(k grad u) + sigma u + N(u) "
                        "= f instead of solving steady state: IMEX "
                        "scanned stepping (explicit reaction, one FDM "
                        "solve/step; box+cubic) or --implicit Newton-BE")
    p.add_argument("--implicit", action="store_true",
                   help="fully implicit BE (per-step warm Newton; "
                        "unconditionally stable for stiff reactions)")
    p.add_argument("--dt", type=float, default=5e-3)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--scheme", choices=["be", "cnab"], default="cnab")
    p.add_argument("--batch", type=int, default=0,
                   help="with --transient: step B trajectories through "
                        "one program (jax.vmap of the scanned IMEX "
                        "stepper, solvers.transient.batch_evolve)")
    args = p.parse_args()
    dtype = setup_jax(args)

    from pmg_dolfinx_jax.fem.assembly import assemble_rhs, l2_error
    from pmg_dolfinx_jax.models import semilinear
    from pmg_dolfinx_jax.models.poisson import fit_box_cells, u_exact
    from pmg_dolfinx_jax.solvers.newton import newton_solve
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy
    from pmg_dolfinx_jax.utils.timers import Timer, list_timings

    nc = fit_box_cells(args.ndofs, max(args.degrees))
    kappa = args.kappa
    if args.kappa_field == "linear":
        from pmg_dolfinx_jax.models.poisson import kappa_linear

        kappa = kappa_linear
        if args.operator == "kron":
            args.operator = "lattice"
            print("variable kappa: switching operator backend to 'lattice'")
    if args.mesh == "perturbed":
        from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh

        mesh = PerturbedBoxMesh(nc)
        if args.operator == "kron":
            args.operator = "lattice"
            print("perturbed mesh: switching operator backend to 'lattice'")
        if args.coarse == "fdm":
            args.coarse = "hmg"
            print("perturbed mesh: switching coarse solver to 'hmg'")
    else:
        from pmg_dolfinx_jax.fem.mesh import BoxMesh

        mesh = BoxMesh(nc)
    P = max(args.degrees)
    print(f"mesh {nc}, {mesh.num_dofs(P)} dofs, degrees {args.degrees}, "
          f"operator {args.operator}, coarse {args.coarse}")

    if args.model == "cubic":
        nonlin = semilinear.cubic(args.c)
        if args.kappa_field == "const" and args.mesh == "box":
            f = semilinear.f_rhs_semilinear(args.kappa, nonlin,
                                            sigma=args.sigma)
        else:
            # No manufactured source for the variable/curved cases: use
            # the linear family's source (solution unknown, report |F|).
            from pmg_dolfinx_jax.models.poisson import f_rhs

            f = f_rhs(2.0, sigma=args.sigma)
        b = assemble_rhs(mesh, P, f)
    else:
        nonlin = semilinear.bratu(args.lam)
        b = np.zeros(mesh.num_dofs(P))

    if args.transient:
        import json
        import time

        if args.model != "cubic" or args.mesh != "box" \
                or args.kappa_field != "const":
            raise SystemExit("--transient: box + cubic + constant kappa "
                             "(the manufactured steady state)")
        if args.implicit and args.batch:
            raise SystemExit("--batch rides the IMEX scan; "
                             "--implicit is the per-step Newton host "
                             "loop — pick one")
        if args.implicit:
            from pmg_dolfinx_jax.solvers.transient import (
                semilinear_newton_evolve)

            with Timer("setup (shifted hierarchy)"):
                hier = PMGHierarchy(
                    mesh, degrees=tuple(args.degrees), kappa=kappa,
                    dtype=dtype, coarse=args.coarse,
                    operator=args.operator,
                    sigma=args.sigma + 1.0 / args.dt)
                evolve = semilinear_newton_evolve(
                    hier, mesh, P, nonlin, args.dt, rtol=args.rtol, f=b)
            t0 = time.time()
            uT, iters = evolve(np.zeros(mesh.num_dofs(P)), args.steps)
            wall = time.time() - t0
            print(f"implicit BE: Newton/step min {min(iters)} "
                  f"max {max(iters)}")
        elif args.batch:
            from pmg_dolfinx_jax.solvers.transient import (
                batch_evolve, semilinear_fdm_evolve)

            B = args.batch
            with Timer("setup (batched IMEX stepper)"):
                evolve = batch_evolve(semilinear_fdm_evolve(
                    mesh, P, nonlin, kappa=args.kappa, dt=args.dt,
                    scheme=args.scheme, sigma=args.sigma, dtype=dtype,
                    f=b))
            U0 = np.zeros((B, mesh.num_dofs(P)), dtype)
            with Timer(f"warmup (compile + {args.steps} steps)"):
                np.asarray(evolve(U0, args.steps))
            t0 = time.time()
            uT = np.asarray(evolve(U0, args.steps))[0].reshape(-1)
            wall = time.time() - t0
            print(f"batched serving, batch {B} "
                  f"({args.steps * B / wall:.1f} column-steps/s)")
        else:
            from pmg_dolfinx_jax.solvers.transient import (
                semilinear_fdm_evolve)

            with Timer("setup (FDM factorization)"):
                evolve = semilinear_fdm_evolve(
                    mesh, P, nonlin, kappa=args.kappa, dt=args.dt,
                    scheme=args.scheme, sigma=args.sigma, dtype=dtype,
                    f=b)
            u0 = np.zeros(mesh.num_dofs(P))
            with Timer(f"warmup (compile + {args.steps} steps)"):
                np.asarray(evolve(u0, args.steps))
            t0 = time.time()
            uT = np.asarray(evolve(u0, args.steps)).reshape(-1)
            wall = time.time() - t0
        err = l2_error(mesh, P, np.asarray(uT, dtype=np.float64),
                       u_exact)
        mode = "implicit-be" if args.implicit else args.scheme
        print(f"{mode} dt={args.dt:g} T={args.dt * args.steps:g}: "
              f"steady-state L2 err {err:.3e}")
        print(f"throughput: {args.steps / wall:.1f} steps/s")
        list_timings()
        print(json.dumps({"l2_error": float(err),
                          "steps_per_s": args.steps / wall}))
        return

    with Timer("setup (hierarchy build + calibration)"):
        hier = PMGHierarchy(mesh, degrees=tuple(args.degrees), kappa=kappa,
                            dtype=dtype, coarse=args.coarse,
                            operator=args.operator, sigma=args.sigma)

    atol = 0.0
    if args.model == "bratu":
        # |F(0)| = lam |M e^0| is O(1); converge on the absolute norm.
        args.rtol, atol = 0.0, 1e-10 if args.dtype == "f64" else 1e-5

    kw = dict(rtol=args.rtol, atol=atol, maxiter=args.maxiter,
              lin_maxiter=args.lin_maxiter)
    if args.warm:
        newton_solve(hier, b, nonlin, **kw)
    with Timer("newton solve"):
        u, info = newton_solve(hier, b, nonlin, **kw)

    status = "converged" if info["converged"] else "NOT CONVERGED"
    print(f"{nonlin.name}: {status} in {info['niter']} Newton steps")
    for k, fn in enumerate(info["fnorms"]):
        lin = (f"  (lin iters {info['lin_iters'][k]})"
               if k < len(info["lin_iters"]) else "")
        print(f"  |F_{k}| = {fn:.3e}{lin}")
    if args.model == "cubic" and args.kappa_field == "const" \
            and args.mesh == "box":
        err = l2_error(mesh, P, np.asarray(u, dtype=np.float64), u_exact)
        print(f"L2 error vs manufactured solution: {err:.3e}")
    else:
        umax = float(np.max(np.asarray(u)))
        print(f"max(u) = {umax:.6f}")
    list_timings()


if __name__ == "__main__":
    main()

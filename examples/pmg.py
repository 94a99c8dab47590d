"""PMG driver: the flagship p-multigrid Poisson solve.

JAX counterpart of reference examples/pmg/main.cpp (`./pmg --ndofs N
[--amg] [--output]`): builds the fitted unit-cube mesh, the p-hierarchy with
CG/Lanczos-calibrated fourth-kind Chebyshev smoothers, and runs 10
stationary V-cycles, printing per-cycle residuals, the L2 error against the
manufactured solution, and a timing table.

The reference's `--amg` (hypre BoomerAMG coarse solve) maps to
`--coarse cg` (a converged Krylov coarse solve); `--coarse smoother`
reproduces the reference's AMG-off default (2 Chebyshev iterations at p=1).
"""

import json

import numpy as np

from _common import base_parser, setup_jax


def main():
    p = base_parser(__doc__)
    p.add_argument("--degrees", type=int, nargs="+", default=[1, 3])
    p.add_argument("--cycles", type=int, default=10)
    p.add_argument("--coarse",
                   choices=["smoother", "cg", "direct", "hmg", "fdm"],
                   default="cg")
    p.add_argument("--semicoarsen", type=str, default="",
                   help="h-MG semi-coarsening axes for anisotropic "
                        "problems, e.g. 'z' or 'xy' (with --coarse hmg: "
                        "coarsen the strongly-coupled axes first — the "
                        "BoomerAMG strength-of-connection analogue; "
                        "solvers.hmg.semicoarsen_sizes)")
    p.add_argument("--smoother", type=str, default="cheb",
                   choices=["cheb", "line", "line-x", "line-y", "line-z",
                            "schwarz"],
                   help="p-level smoother preconditioner: point Jacobi "
                        "(default), line relaxation along the strongly-"
                        "coupled axis ('line' = auto by kappa_aa/h_a^2; "
                        "moderate sizes, solvers/line.py), or 'schwarz' — "
                        "cell-wise FDM Schwarz (any size, O(ndofs) "
                        "memory, solvers/schwarz.py); both restore "
                        "stationary contraction under strong anisotropy "
                        "at the default smoother-iters")
    p.add_argument("--hmg-smoother", type=str, default="cheb",
                   choices=["cheb", "line", "line-x", "line-y", "line-z",
                            "schwarz"],
                   help="h-level smoother preconditioner (with --coarse "
                        "hmg): point Jacobi (default) or line relaxation "
                        "along the strongly-coupled axis ('line' = auto "
                        "by kappa_aa/h_a^2) — the anisotropy remedy that "
                        "keeps plain isotropic coarsening effective "
                        "(solvers/line.py)")
    p.add_argument("--smoother-iters", type=int, default=2,
                   help="Chebyshev iterations per smoothing pass "
                        "(default 2, the reference's setting; raising "
                        "to 3-4 restores STATIONARY contraction under "
                        "strong off-axis tensor anisotropy — measured, "
                        "see warn_tensor_stationary)")
    p.add_argument("--gamma", type=int, default=1,
                   help="cycle index: 1 = V-cycle (default), 2 = W-cycle "
                        "(each level visits its coarse sub-hierarchy "
                        "twice; pays when the coarse solve is weak — "
                        "beyond reference parity)")
    p.add_argument("--refined", action="store_true",
                   help="mixed-precision refinement: f64 outer residual + "
                        "working-dtype V-cycle (needs x64; converges past "
                        "the f32 residual floor)")
    p.add_argument("--pcg", action="store_true",
                   help="V-cycle-preconditioned flexible CG outer solver "
                        "(fewer cycles than the stationary iteration)")
    p.add_argument("--fdm", action="store_true",
                   help="fast-diagonalization DIRECT solve (constant "
                        "kappa, box mesh): the whole system in ~one "
                        "matvec cost; combine with --refined for f64")
    p.add_argument("--fmg", action="store_true",
                   help="full-multigrid initial guess (nested iteration: "
                        "restrict rhs down, coarse-solve, prolong up with "
                        "one truncated V-cycle per level) — typically "
                        "saves 2-4 cycles; beyond reference parity")
    p.add_argument("--warm", action="store_true",
                   help="run one throwaway solve first so the timed solve "
                        "excludes jit compilation")
    p.add_argument("--output", type=str, default=None,
                   help="write solution to this file (.npz or .vtk)")
    p.add_argument("--precision", choices=["highest", "high"],
                   default="highest",
                   help="'high' = TF32 matmuls inside the V-cycle on "
                        "tensor-core GPUs (operator error ~1e-3; use with "
                        "--pcg or --refined, whose outer loops recompute "
                        "the residual)")
    p.add_argument("--kappa-field",
                   choices=["const", "linear", "aniso", "aniso-diag"],
                   default="const",
                   help="'linear': variable coefficient kappa(x)=1+x "
                        "(DG-0 per cell; requires --operator lattice or "
                        "dofmap, reference laplacian.hpp:220-241); "
                        "'aniso': constant 3x3 diffusion TENSOR (100:1 "
                        "anisotropy rotated 30deg off-grid, folded into "
                        "the geometry factors — beyond reference parity); "
                        "'aniso-diag': grid-aligned diag(1,1,100) tensor "
                        "— per-axis Kronecker structure, so the kron "
                        "family and the exact --fdm direct solve apply")
    p.add_argument("--sigma", type=float, default=0.0,
                   help="lumped-mass shift: solve the reaction-diffusion "
                        "problem -div(kappa grad u) + sigma u = f (all "
                        "operator backends incl. curved hexes / variable "
                        "kappa; beyond reference parity)")
    p.add_argument("--sigma-field", action="store_true",
                   help="spatially varying reaction coefficient "
                        "sigma(x) = 10(1+x+y) (models.poisson."
                        "sigma_linear; general backends, baked into the "
                        "per-level lumped mass — beyond reference parity)")
    p.add_argument("--grade", type=str, default="",
                   help="graded (non-uniform) cell spacing 'AXES:RATIO', "
                        "e.g. 'z:8' or 'xyz:4': geometric grading with "
                        "the largest cell RATIO times the smallest on "
                        "the named axes (boundary-layer refinement, "
                        "beyond the reference's uniform create_box). The "
                        "whole kron family rides it natively — combine "
                        "with --fdm for an EXACT one-shot direct solve "
                        "on the graded mesh; --coarse hmg is the one "
                        "mode that rejects grading")
    p.add_argument("--mesh", choices=["box", "perturbed"], default="box",
                   help="'perturbed': smoothly deformed GENERAL hexahedra "
                        "(non-affine cells; the full geometry pipeline + "
                        "lattice backends)")
    p.add_argument("--neumann", type=str, default="",
                   help="axes whose BOTH faces carry the homogeneous "
                        "Neumann (natural) condition instead of "
                        "Dirichlet, e.g. 'x' or 'xy' (mixed-BC model "
                        "family, beyond reference parity; constant kappa "
                        "drivers only — the manufactured solution "
                        "switches to the matching sin/cos product)")
    p.add_argument("--robin", type=str, default="",
                   help="axes whose BOTH faces carry the Robin condition "
                        "kappa du/dn + alpha u = g (alpha=2) instead of "
                        "Dirichlet, e.g. 'y' or 'xy' (beyond reference "
                        "parity; surface data g manufactured from the "
                        "mixed-BC exact solution; axis-aligned box + "
                        "constant kappa). Composable with --neumann on "
                        "disjoint axes")
    args = p.parse_args()
    dtype = setup_jax(args)

    import jax

    if args.refined:
        jax.config.update("jax_enable_x64", True)

    from pmg_dolfinx_jax.models.poisson import (
        PoissonProblem,
        f_rhs_variable,
        fit_box_cells,
        kappa_linear,
    )
    from pmg_dolfinx_jax.utils.timers import Timer, list_timings

    nc = fit_box_cells(args.ndofs, max(args.degrees))
    print(f"mesh {nc[0]}x{nc[1]}x{nc[2]}, degrees {args.degrees}, "
          f"backend {jax.default_backend()}, dtype {args.dtype}")

    kappa, f = args.kappa, None
    sigma = args.sigma
    # sigma needs no backend override: every operator backend carries
    # the lumped-mass shift (README model-family matrix).
    if args.sigma_field:
        from pmg_dolfinx_jax.models.poisson import (
            f_rhs_sigma_field,
            sigma_linear,
        )

        if (args.sigma or args.kappa_field != "const" or args.neumann
                or args.robin or args.fdm):
            raise SystemExit("--sigma-field: use alone (constant kappa, "
                             "no --sigma/--neumann/--robin/--fdm — the "
                             "manufactured source is built for that "
                             "combination, and the FDM shift must be "
                             "separable)")
        sigma = sigma_linear
        f = f_rhs_sigma_field(args.kappa)
        if args.operator == "kron":
            args.operator = "lattice"
            print("sigma field: switching operator backend to 'lattice'")
    if args.kappa_field == "linear":
        kappa, f = kappa_linear, f_rhs_variable(sigma=args.sigma)
        if args.operator == "kron":
            args.operator = "lattice"
            print("variable kappa: switching operator backend to 'lattice'")
    elif args.kappa_field == "aniso":
        from pmg_dolfinx_jax.models.poisson import f_rhs_tensor, kappa_aniso

        kappa = kappa_aniso()
        f = f_rhs_tensor(kappa, sigma=args.sigma)
        if args.operator == "kron":
            args.operator = "lattice"
            print("tensor kappa: switching operator backend to 'lattice'")
    elif args.kappa_field == "aniso-diag":
        # Grid-aligned diagonal tensor: the Kronecker sum expresses it
        # per axis, so the kron family AND the exact FDM direct solve
        # apply unchanged (combine with --fdm for a one-shot solve of
        # the anisotropic system).
        from pmg_dolfinx_jax.models.poisson import f_rhs_tensor

        kappa = np.diag([1.0, 1.0, 100.0])
        f = f_rhs_tensor(kappa, sigma=args.sigma)
    u_exact_override = None
    robin_g = None
    robin = None
    faces = True
    if args.neumann or args.robin:
        if args.kappa_field != "const":
            raise SystemExit("--neumann/--robin support --kappa-field "
                             "const only (the manufactured mixed-BC "
                             "solution is constant-kappa)")
        if set(args.neumann) & set(args.robin):
            raise SystemExit("--neumann and --robin must name disjoint "
                             "axes")
        from pmg_dolfinx_jax.models.poisson import (
            f_rhs_mixed,
            u_exact_mixed,
        )

        faces = tuple(
            ((False, False)
             if "xyz"[a] in args.neumann or "xyz"[a] in args.robin
             else (True, True))
            for a in range(3)
        )
        f = f_rhs_mixed(args.kappa, faces, sigma=args.sigma)
        u_exact_override = u_exact_mixed(faces)
        if args.robin:
            if args.mesh == "perturbed":
                raise SystemExit("--robin manufactures the surface data "
                                 "g on flat faces (axis-aligned box "
                                 "only)")
            from pmg_dolfinx_jax.models.poisson import (
                grad_u_exact_mixed,
                robin_data,
            )

            robin = tuple(
                (2.0, 2.0) if "xyz"[a] in args.robin else (0.0, 0.0)
                for a in range(3)
            )
            robin_g = robin_data(args.kappa, u_exact_override,
                                 grad_u_exact_mixed(faces), robin)
            print(f"Robin faces (alpha=2) on axes '{args.robin}'"
                  + (f", Neumann on '{args.neumann}'" if args.neumann
                     else "") + f": dirichlet_faces={faces}")
        else:
            print(f"Neumann faces on axes '{args.neumann}': "
                  f"dirichlet_faces={faces}")
    spacing = None
    if args.grade:
        from pmg_dolfinx_jax.fem.mesh import geometric_spacing

        try:
            axes_s, ratio_s = args.grade.split(":")
            ratio = float(ratio_s)
            grade_axes = tuple(sorted("xyz".index(a) for a in axes_s))
        except (ValueError, IndexError):
            raise SystemExit("--grade expects 'AXES:RATIO', e.g. 'z:8' "
                             "or 'xyz:4'")
        spacing = tuple(
            geometric_spacing(nc[a], ratio) if a in grade_axes else None
            for a in range(3)
        )
        print(f"graded spacing on axes '{axes_s}' (geometric, ratio "
              f"{ratio:g})")
    mesh = None
    if args.mesh == "perturbed":
        from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh

        mesh = PerturbedBoxMesh(nc, dirichlet_faces=faces,
                                spacing=spacing)
        if args.operator == "kron":
            args.operator = "lattice"
            print("perturbed (general-hex) mesh: switching operator "
                  "backend to 'lattice'")
        if args.coarse == "fdm":
            args.coarse = "hmg"
            print("perturbed mesh: switching coarse solver to 'hmg' "
                  "(fdm is axis-aligned only; hmg rediscretizes the "
                  "curved operator per h-level)")
    elif faces is not True or spacing is not None:
        from pmg_dolfinx_jax.fem.mesh import BoxMesh

        mesh = BoxMesh(nc, dirichlet_faces=faces, robin=robin,
                       spacing=spacing)

    with Timer("setup (operators+calibration+rhs)"):
        coarse_cfg = {}
        if args.gamma > 1:
            coarse_cfg["gamma"] = args.gamma
        if args.hmg_smoother != "cheb":
            if args.coarse != "hmg":
                raise SystemExit("--hmg-smoother requires --coarse hmg")
            coarse_cfg["smoother"] = args.hmg_smoother
        if args.semicoarsen:
            from pmg_dolfinx_jax.solvers.hmg import (
                semicoarsen_axes,
                semicoarsen_sizes,
            )

            if args.coarse != "hmg":
                raise SystemExit("--semicoarsen requires --coarse hmg")
            if args.semicoarsen == "auto":
                from pmg_dolfinx_jax.fem.mesh import BoxMesh

                axes = semicoarsen_axes(mesh or BoxMesh(nc), kappa)
                print(f"semi-coarsening axes (auto): "
                      f"{''.join('xyz'[a] for a in axes) or '(none)'}")
            else:
                axes = tuple(sorted("xyz".index(a)
                                    for a in args.semicoarsen))
            coarse_cfg["sizes"] = semicoarsen_sizes(nc, axes)
            print(f"semi-coarsened h-levels: {coarse_cfg['sizes']}")
        prob = PoissonProblem(
            nc=nc, degrees=tuple(args.degrees), kappa=kappa, dtype=dtype,
            coarse=args.coarse, operator=args.operator, f=f,
            precision=args.precision, mesh=mesh, sigma=sigma,
            coarse_cfg=coarse_cfg or None,
            smoother_iters=args.smoother_iters,
            smoother=args.smoother,
            u_exact=u_exact_override,
            robin_g=robin_g,
        )
    ndofs = [prob.mesh.num_dofs(P) for P in args.degrees]
    print("hierarchy:", " -> ".join(f"p={P}: {n}" for P, n in zip(args.degrees, ndofs)))
    for P, eig in zip(args.degrees, prob.hierarchy.eigs):
        print(f"  level p={P}: eig range estimate [{eig[0]:.4f}, {eig[-1]:.4f}]")

    if args.fdm:
        if args.fmg:
            raise SystemExit("--fmg is an initial guess for the iterative "
                             "solvers; --fdm is a direct solve (exact in "
                             "one application) — drop one of the flags")
        if args.kappa_field not in ("const", "aniso-diag"):
            raise SystemExit("--fdm is a constant-coefficient (or diagonal-"
                             "tensor) direct solve; use --pcg for variable "
                             "kappa")
        from pmg_dolfinx_jax.solvers.fdm import FastDiagonalizationSolver

        fdm = FastDiagonalizationSolver(prob.mesh, args.degrees[-1],
                                        kappa=(kappa if args.kappa_field
                                               == "aniso-diag"
                                               else args.kappa),
                                        dtype=dtype, sigma=args.sigma)
        with Timer("fdm solve", sync=True):
            if args.refined:
                u, rnorms = fdm.refine(prob.b, cycles=min(args.cycles, 4))
            else:
                u = fdm.solve(prob.b)
                rnorms = []
        r0 = float(np.linalg.norm(np.asarray(prob.b)))
        for i, r in enumerate(rnorms):
            print(f"refine {i}: rel = {r / r0:.4e}")
        err = prob.error_l2(np.asarray(u))
        print(f"L2 error vs manufactured solution: {err:.4e}")
        list_timings()
        rel = rnorms[-1] / r0 if rnorms else None
        print(json.dumps({"rel_residual": rel, "l2_error": err}))
        return

    def _solve():
        if args.refined:
            return prob.hierarchy.solve_refined(prob.b,
                                                num_cycles=args.cycles,
                                                fmg=args.fmg)
        if args.pcg:
            u, niter = prob.hierarchy.solve_pcg(prob.b, rtol=1e-8,
                                                maxiter=args.cycles,
                                                fmg=args.fmg)
            return u, [], niter
        return (*prob.solve(num_cycles=args.cycles, fmg=args.fmg),)

    if args.warm:
        # Throwaway first solve so the timed one excludes jit compiles
        # (the whole-solve program's compile dwarfs the solve itself).
        with Timer("pmg solve warmup (jit compile)", sync=True):
            _solve()
    with Timer("pmg solve (%d cycles)" % args.cycles, sync=True):
        u, rnorms, *extra = _solve()
    if args.pcg:
        print(f"FCG(V-cycle) converged in {extra[0]} iterations")
    r0 = float(np.linalg.norm(np.asarray(prob.b)))
    for i, r in enumerate(rnorms):
        print(f"cycle {i + 1:2d}: |r| = {r:.4e}   rel = {r / r0:.4e}")
    err = prob.error_l2(u)
    print(f"L2 error vs manufactured solution: {err:.4e}")

    if args.output:
        from pmg_dolfinx_jax.utils.io import write_npz, write_vtk

        if args.output.endswith(".vtk"):
            write_vtk(args.output, prob.mesh, args.degrees[-1], np.asarray(u))
        else:
            write_npz(args.output, prob.mesh, args.degrees[-1], np.asarray(u))
        print(f"solution written to {args.output}")

    list_timings()
    rel = rnorms[-1] / r0 if rnorms else None
    print(json.dumps({"rel_residual": rel, "l2_error": err}))


if __name__ == "__main__":
    main()

"""Coarse-level (p=1) solver driver — the AMG-path replacement.

JAX counterpart of reference examples/amg/main.cpp: a pure p=1
solve of the Poisson problem, there via PETSc KSPCG preconditioned by
hypre BoomerAMG on device CSR ("ZZZ Solve", main.cpp:209-211). The
framework replaces algebraic multigrid with matrix-free options
(BASELINE.md explicitly swaps the AMG path out):

- `--pc jacobi`  : Jacobi-CG (default; the coarse solve used inside PMG),
- `--pc cheb`    : CG preconditioned by a fixed fourth-kind Chebyshev sweep,
- `--pc hmg`     : CG preconditioned by ONE geometric h-MG V-cycle — the
  closest analogue of the reference's KSPCG + PCHYPRE(BoomerAMG)
  composition (amg/main.cpp:173-211), with the closed-form geometric
  hierarchy standing in for AMG's inferred one.
"""

import numpy as np

from _common import base_parser, setup_jax


def main():
    p = base_parser(__doc__)
    p.add_argument("--pc", choices=["jacobi", "cheb", "hmg"],
                   default="jacobi")
    p.add_argument("--rtol", type=float, default=1e-8)
    p.add_argument("--max-iters", type=int, default=500)
    p.add_argument("--mesh", choices=["box", "perturbed"], default="box",
                   help="'perturbed': general (non-affine) hexahedra — "
                        "with --pc hmg this is the full BoomerAMG-"
                        "replacement scenario (rediscretized curved "
                        "h-levels)")
    p.add_argument("--kappa-field", choices=["const", "linear"],
                   default="const",
                   help="'linear': variable per-cell DG-0 coefficient")
    args = p.parse_args()
    dtype = setup_jax(args)

    import jax
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.assembly import assemble_rhs
    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.models.poisson import f_gauss, fit_box_cells
    from pmg_dolfinx_jax.ops.lattice import LatticeLaplacian
    from pmg_dolfinx_jax.solvers.cg import cg_solve
    from pmg_dolfinx_jax.utils.timers import Timer, list_timings

    nc = fit_box_cells(args.ndofs, 1)
    if args.pc == "hmg":
        # Round to multiples of 4 so the geometric hierarchy can coarsen
        # (fit_box_cells may pick prime cell counts).
        nc = tuple((c + 3) // 4 * 4 for c in nc)
    if args.mesh == "perturbed":
        from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh

        mesh = PerturbedBoxMesh(nc)
    else:
        mesh = BoxMesh(nc)
    kappa = args.kappa
    if args.kappa_field == "linear":
        from pmg_dolfinx_jax.models.poisson import kappa_linear

        kappa = kappa_linear
    general = args.mesh == "perturbed" or args.kappa_field != "const"
    nd = mesh.num_dofs(1)
    print(f"mesh {nc} ({args.mesh}), p=1, ndofs={nd}, "
          f"kappa {args.kappa_field}, backend {jax.default_backend()}")

    op = LatticeLaplacian(mesh, 1, kappa=kappa, dtype=dtype)
    b = jnp.asarray(assemble_rhs(mesh, 1, f_gauss), dtype=dtype)

    precond = None
    if args.pc == "cheb":
        from pmg_dolfinx_jax.solvers.chebyshev import chebyshev4_solve
        from pmg_dolfinx_jax.solvers.tridiag import lanczos_eigenvalue_estimates

        _, info = cg_solve(op, jnp.ones_like(b), jnp.zeros_like(b),
                           op.diag_inv, rtol=1e-6, maxiter=20, record=True)
        eigs = lanczos_eigenvalue_estimates(info["alphas"], info["betas"],
                                            info["stored"])
        lmax = 1.1 * eigs[-1]
        print(f"Chebyshev preconditioner with lmax = {lmax:.4f}")

        def precond(r):
            return chebyshev4_solve(op, r, jnp.zeros_like(r), op.diag_inv,
                                    lmax, 3)
    flexible = False
    if args.pc == "hmg":
        from pmg_dolfinx_jax.solvers.pmg import v_cycle

        if general:
            # Rediscretized lattice hierarchy: curved meshes re-evaluate
            # the warp per level, DG-0 kappa volume-averages — the full
            # BoomerAMG-replacement scenario (src/amg.hpp on any mesh).
            from pmg_dolfinx_jax.solvers.hmg import build_hmg_general

            levels, data, bottom, hops = build_hmg_general(
                mesh, 1, kappa, dtype)
        else:
            from pmg_dolfinx_jax.solvers.hmg import build_hmg
            from pmg_dolfinx_jax.solvers.pmg import kron_cycle_ops

            levels, data, bottom = build_hmg(mesh, 1, kappa, dtype)
            hops = kron_cycle_ops("highest")
        zeros = hops.get(
            "zeros", lambda level, dt: jnp.zeros(level.ndofs, dtype=dt)
        )
        # With a 'direct' bottom the V-cycle is a fixed SPD operator and
        # plain PCG applies; a 'cg' bottom (coarsest level > 4096 dofs)
        # is an inner Krylov solve — not a fixed linear operator — so
        # the outer loop must be FLEXIBLE CG.
        flexible = bottom != "direct"
        print(f"h-MG preconditioner: {len(levels)} levels "
              f"{[lv.shape for lv in levels]}, bottom '{bottom}'"
              f"{' -> flexible CG outer' if flexible else ''}")

        def precond(r):
            u0 = zeros(levels[-1], r.dtype)
            u = v_cycle(data, r.reshape(jnp.shape(u0)), u0, levels=levels,
                        coarse=bottom, coarse_cfg={}, ops=hops)
            return u.reshape(jnp.shape(r))

    with Timer("ZZZ Solve", sync=True):
        if flexible:
            from pmg_dolfinx_jax.solvers.cg import fcg_solve

            x, info = fcg_solve(op, b, jnp.zeros_like(b), precond,
                                rtol=args.rtol, maxiter=args.max_iters)
        else:
            x, info = cg_solve(op, b, jnp.zeros_like(b), op.diag_inv,
                               rtol=args.rtol, maxiter=args.max_iters,
                               precond=precond)
    print(f"CG iterations: {int(info['niter'])}, "
          f"|r|_M = {float(info['rnorm'])**0.5:.4e}")
    r = b - op(x)
    print(f"final true |r| = {float(jnp.linalg.norm(r)):.4e}")
    list_timings()


if __name__ == "__main__":
    main()

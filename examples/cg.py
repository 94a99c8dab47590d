"""CG driver: Jacobi-CG solve + eigenvalue estimation + Chebyshev solve.

JAX counterpart of reference examples/cg/main.cpp: matrix-free
operator at p=3, Jacobi-preconditioned CG solve ("ZZZ CG" timer), Lanczos
eigenvalue estimation from recorded coefficients, then a 30-iteration
fourth-kind Chebyshev solve with nonzero initial guess, and a peak-memory
report (examples/cg/main.cpp:221-295).
"""

import numpy as np

from _common import base_parser, setup_jax


def main():
    p = base_parser(__doc__)
    p.add_argument("--degree", type=int, default=3)
    p.add_argument("--max-iters", type=int, default=200)
    p.add_argument("--rtol", type=float, default=1e-6)
    args = p.parse_args()
    dtype = setup_jax(args)

    import jax
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.assembly import assemble_rhs
    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.models.poisson import f_gauss, fit_box_cells
    from pmg_dolfinx_jax.ops.lattice import LatticeLaplacian
    from pmg_dolfinx_jax.ops.laplacian import MatFreeLaplacian
    from pmg_dolfinx_jax.solvers.cg import cg_solve
    from pmg_dolfinx_jax.solvers.chebyshev import chebyshev4_solve
    from pmg_dolfinx_jax.solvers.tridiag import lanczos_eigenvalue_estimates
    from pmg_dolfinx_jax.utils.profiling import peak_memory_fraction
    from pmg_dolfinx_jax.utils.timers import Timer, list_timings

    nc = fit_box_cells(args.ndofs, args.degree)
    mesh = BoxMesh(nc)
    nd = mesh.num_dofs(args.degree)
    print(f"mesh {nc}, p={args.degree}, ndofs={nd}, backend {jax.default_backend()}")

    with Timer("create matfree operator"):
        if args.operator == "kron":
            from pmg_dolfinx_jax.ops.kron import KronLaplacian

            op = KronLaplacian(mesh, args.degree, kappa=args.kappa,
                               dtype=dtype)
        elif args.operator == "lattice":
            op = LatticeLaplacian(mesh, args.degree, kappa=args.kappa,
                                  dtype=dtype)
        else:
            op = MatFreeLaplacian(mesh, args.degree, kappa=args.kappa,
                                  dtype=dtype)
    # The reference's Gaussian point-source rhs (cg/main.cpp:136-148).
    # The manufactured sine is spectrally too clean here: CG converges in
    # ~16 iterations and the recorded Lanczos coefficients then
    # UNDERestimate lmax badly (1.57 vs true 2.21 at p=3), which makes
    # the 30-iteration Chebyshev demo diverge.
    b = jnp.asarray(assemble_rhs(mesh, args.degree, f_gauss), dtype=dtype)

    with Timer("ZZZ CG", sync=True):
        x, info = cg_solve(
            op, b, jnp.zeros_like(b), op.diag_inv,
            rtol=args.rtol, maxiter=args.max_iters, record=True,
        )
    niter = int(info["niter"])
    print(f"CG iterations: {niter}, final |r|_M = {float(info['rnorm'])**0.5:.4e}")

    eigs = lanczos_eigenvalue_estimates(info["alphas"], info["betas"], info["stored"])
    print(f"eigenvalue estimates of M^-1 A: [{eigs[0]:.4f}, {eigs[-1]:.4f}]")

    # Chebyshev solve with the estimated range and a nonzero initial guess
    # (ones with bc rows zeroed — reference examples/cg/main.cpp:268-284,
    # 30 iterations).
    lmax = 1.1 * eigs[-1]
    marker = jnp.asarray(mesh.boundary_dof_marker(args.degree))
    x0 = jnp.where(marker, 0.0, jnp.ones_like(b))
    with Timer("ZZZ Chebyshev(30)", sync=True):
        xc = chebyshev4_solve(op, b, x0, op.diag_inv, lmax, 30)
    r = b - op(xc)
    print(f"Chebyshev(30) final |r| = {float(jnp.linalg.norm(r)):.4e}")

    frac = peak_memory_fraction()
    if frac is not None:
        print(f"peak device memory: {100 * frac:.1f}%")
    list_timings()


if __name__ == "__main__":
    main()

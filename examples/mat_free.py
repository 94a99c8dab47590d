"""Operator micro-benchmark: repeated matvecs + correctness oracle.

JAX counterpart of reference examples/mat_free/main.cpp
(`./mat_free --ndofs N [--mat_comp] [--batch_size B]`): times `--reps`
repeated matrix-free applies (the "% Mat-free Matvec" / GDOF/s number,
main.cpp:260-265) and with `--mat_comp` checks the fast operator against
the assembled-matrix oracle (main.cpp:270-289).
"""

import time
from functools import partial

import numpy as np

from _common import base_parser, setup_jax


def main():
    p = base_parser(__doc__)
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--reps", type=int, default=1000)
    p.add_argument("--mat_comp", action="store_true",
                   help="verify against the assembled CSR oracle (hosts a "
                        "dense-per-cell assembly; use moderate --ndofs)")
    p.add_argument("--precision",
                   choices=["highest", "high", "default"],
                   default="highest")
    args = p.parse_args()
    dtype = setup_jax(args)

    import jax
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.models.poisson import fit_box_cells
    from pmg_dolfinx_jax.ops.lattice import LatticeLaplacian, lattice_laplacian_apply
    from pmg_dolfinx_jax.ops.laplacian import MatFreeLaplacian, laplacian_apply

    nc = fit_box_cells(args.ndofs, args.degree)
    mesh = BoxMesh(nc)
    nd = mesh.num_dofs(args.degree)
    print(f"mesh {nc}, p={args.degree}, ndofs={nd / 1e6:.3f}M, "
          f"backend {jax.default_backend()}, operator {args.operator}")

    x = jnp.ones(nd, dtype=dtype)
    if args.operator == "kron":
        from pmg_dolfinx_jax.ops.kron import KronLaplacian, kron_laplacian_apply

        op = KronLaplacian(mesh, args.degree, kappa=args.kappa, dtype=dtype,
                           precision=args.precision)
        # Lattice-shaped carrier (see ops/kron.py).
        x3 = x.reshape(mesh.lattice_shape(args.degree))
        bc3 = op.bc_marker.reshape(x3.shape)

        @partial(jax.jit, static_argnums=(4,))
        def chain(x, Ks, ms, bc, reps):
            def body(i, v):
                return kron_laplacian_apply(
                    x + 1e-30 * v, Ks, ms, bc, precision=args.precision
                )
            return jnp.sum(jax.lax.fori_loop(0, reps, body, x))

        def run(reps):
            return float(chain(x3, op.Ks, op.ms, bc3, reps))
    elif args.operator == "lattice":
        op = LatticeLaplacian(mesh, args.degree, kappa=args.kappa, dtype=dtype,
                              precision=args.precision)

        @partial(jax.jit, static_argnums=(4,))
        def chain(x, mats, G, bc, reps):
            def body(i, v):
                return lattice_laplacian_apply(
                    x + 1e-30 * v, mats, G, bc, precision=args.precision
                )
            return jnp.sum(jax.lax.fori_loop(0, reps, body, x))

        def run(reps):
            return float(chain(x, op.mats, op.G, op.bc_marker, reps))
    else:
        op = MatFreeLaplacian(mesh, args.degree, kappa=args.kappa, dtype=dtype)

        @partial(jax.jit, static_argnums=(6,))
        def chain(x, dofmap, G, coeff, D, bc, reps):
            def body(i, v):
                return laplacian_apply(x + 1e-30 * v, dofmap, G, coeff, D, bc)
            return jnp.sum(jax.lax.fori_loop(0, reps, body, x))

        def run(reps):
            return float(chain(x, op.dofmap, op.G, op.coeff, op.D,
                               op.bc_marker, reps))

    # One jitted chain of --reps applies ending in a scalar readback
    # (the readback synchronizes); the first call compiles.
    run(args.reps)
    t = time.perf_counter()
    run(args.reps)
    per = (time.perf_counter() - t) / args.reps
    print(f"mat-free matvec: {per * 1e3:.3f} ms/apply -> "
          f"{nd / per / 1e9:.3f} GDOF/s ({args.reps} reps)")

    if args.mat_comp:
        from pmg_dolfinx_jax.fem.assembly import assemble_stiffness

        A = assemble_stiffness(mesh, args.degree, kappa=args.kappa)
        xr = np.random.default_rng(0).standard_normal(nd)
        y = np.asarray(op(jnp.asarray(xr, dtype=dtype)))
        err = np.linalg.norm(y - A @ xr) / np.linalg.norm(A @ xr)
        print(f"|y_matfree - y_assembled| / |y| = {err:.3e}")


if __name__ == "__main__":
    main()

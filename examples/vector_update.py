"""Halo-exchange / compute overlap micro-benchmark on a device mesh.

JAX counterpart of reference examples/vector-update/main.cpp: 100
interleaved rounds of halo exchange + norm + axpy (main.cpp:107-116),
checking determinism of the printed dot value and timing the overlap.
Here the halo exchange is the interface-plane ppermute pair inside
`shard_map`; XLA's async collectives provide the overlap the reference
hand-schedules with scatter_fwd_begin/end.

Runs on however many devices are available (use JAX_PLATFORMS=cpu plus
jax_num_cpu_devices for a virtual mesh on one host).
"""

import time

import numpy as np

from _common import base_parser, setup_jax


def main():
    p = base_parser(__doc__)
    p.add_argument("--degree", type=int, default=2)
    p.add_argument("--rounds", type=int, default=100)
    p.add_argument("--devices", type=int, default=0,
                   help="0 = all available devices")
    args = p.parse_args()
    dtype = setup_jax(args, n_cpu_devices=args.devices or 8)

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.models.poisson import fit_box_cells
    from pmg_dolfinx_jax.parallel.dist import AXIS, DistPMG

    n_dev = args.devices or len(jax.devices())
    nc = fit_box_cells(args.ndofs, args.degree)
    nx = max(n_dev, (nc[0] // n_dev) * n_dev)
    mesh = BoxMesh((nx, nc[1], nc[2]))
    dist = DistPMG(mesh, n_devices=n_dev, degrees=(1, args.degree),
                   kappa=args.kappa, dtype=dtype, operator=args.operator)
    print(f"{n_dev} devices, mesh {mesh.nc}, p={args.degree}, "
          f"ndofs={mesh.num_dofs(args.degree)}")

    ops = dist._ops
    fine = dist.levels[-1]
    spec = dist.data_specs["levels"][-1]

    def round_fn(lv, u):
        # operator apply (contains the halo partial-sum exchange), a
        # global dot, and an axpy — the reference's per-round pattern.
        y = ops["apply"](lv, u, fine)
        d = ops["dot"](u, y, lv)
        return u + 0.25 * y / (1.0 + d), d

    stepped = jax.jit(
        jax.shard_map(
            round_fn, mesh=dist.jmesh,
            in_specs=(spec, P(AXIS)), out_specs=(P(AXIS), P()),
        )
    )

    lv = dist.data["levels"][-1]
    u = dist.to_dist(np.ones(mesh.num_dofs(args.degree)))
    dots = []
    stepped(lv, u)  # compile
    t0 = time.time()
    for _ in range(args.rounds):
        u, d = stepped(lv, u)
        dots.append(float(d))
    dt = time.time() - t0
    print(f"{args.rounds} rounds in {dt:.3f}s ({dt / args.rounds * 1e3:.3f} ms/round)")
    print(f"dot trajectory: first={dots[0]:.6e} last={dots[-1]:.6e}")
    assert all(np.isfinite(dots)), "non-finite dot encountered"


if __name__ == "__main__":
    main()

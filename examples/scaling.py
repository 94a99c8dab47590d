"""Weak/strong scaling sweep over a device mesh.

Counterpart of the reference's SLURM scaling scripts (examples/pmg/
submit.sh: `--ndofs 500000` per rank over 8 GCDs/node; SURVEY.md §6) as a
single driver: runs the sharded PMG solve on 1, 2, 4, ... devices and
reports per-cycle time, residual trajectory invariance, and (weak mode)
dofs/device held constant.

On CPU (`--cpu`) the timings are meaningless but the rank-count-invariance
of the residual norms — the correctness contract — is checked exactly.
"""

import time

import numpy as np

from _common import base_parser, setup_jax


def main():
    p = base_parser(__doc__)
    p.add_argument("--mode", choices=["weak", "strong"], default="strong")
    p.add_argument("--degrees", type=int, nargs="+", default=[1, 3])
    p.add_argument("--cycles", type=int, default=5)
    p.add_argument("--max-devices", type=int, default=0)
    p.add_argument("--grid", action="store_true",
                   help="sweep multi-axis (x,y,z) GridPMG box "
                        "decompositions instead of the 1D slab")
    p.add_argument("--coarse", choices=["cg", "smoother", "fdm", "direct",
                                        "hmg"], default="cg")
    p.add_argument("--dist-coarse", action="store_true",
                   help="with --coarse hmg/fdm: the distributed (non-"
                        "gathered) coarse solve (coarse_cfg dist=True; "
                        "fdm = pencil-transpose distributed direct "
                        "solve, parallel/fdm_dist.py)")
    p.add_argument("--bottom", choices=["direct", "cg", "smoother", "fdm"],
                   default="direct",
                   help="h-MG bottom solve (coarse_cfg['bottom']); "
                        "'fdm' needs --dist-coarse and makes the whole "
                        "hierarchy gather-free")
    p.add_argument("--smoother", type=str, default="cheb",
                   help="p-level smoother preconditioner: 'cheb' (point "
                        "Jacobi), 'line'/'line-x|y|z' (unsharded axis "
                        "only), or 'schwarz' (any layout)")
    args = p.parse_args()
    dtype = setup_jax(args, n_cpu_devices=args.max_devices or 8)

    import jax

    from pmg_dolfinx_jax.fem.assembly import assemble_rhs
    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.models.poisson import f_rhs, fit_box_cells
    from pmg_dolfinx_jax.parallel.dist import DistPMG

    if args.grid:
        return _grid_sweep(args, dtype)

    n_avail = args.max_devices or len(jax.devices())
    counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_avail]
    pmax = max(args.degrees)
    ref_trajectory = None
    rtol = 1e-9 if args.dtype == "f64" else 1e-3
    # Strong mode: ONE mesh divisible by every device count, so residual
    # trajectories are comparable across the sweep.
    lcm = max(counts)
    print(f"{'devices':>8} {'ndofs':>12} {'setup[s]':>9} {'s/cycle':>10} "
          f"{'rel resid':>11}")
    for nd in counts:
        target = args.ndofs * (nd if args.mode == "weak" else 1)
        nc = fit_box_cells(target, pmax)
        div = lcm if args.mode == "strong" else nd
        if args.dist_coarse and args.coarse == "hmg":
            # The pinned h-hierarchy needs one factor-2 coarsening with
            # x-cells still divisible by max(counts), and even y/z cells
            # (fit_box_cells often picks primes).
            div = 2 * lcm
            nc = (nc[0], (nc[1] + 1) // 2 * 2, (nc[2] + 1) // 2 * 2)
        nx = max(div, (nc[0] + div - 1) // div * div)
        mesh = BoxMesh((nx, nc[1], nc[2]))
        t0 = time.time()
        # Pin the h-hierarchy across device counts (its depth depends on
        # the shard-alignment constraint) so trajectories stay invariant.
        ccfg = (dict(dist=True, bottom=args.bottom,
                     divisors=(max(counts), 1, 1))
                if args.dist_coarse and args.coarse == "hmg"
                else dict(dist=True) if args.dist_coarse
                else dict(bottom=args.bottom) if args.coarse == "hmg"
                else None)
        dist = DistPMG(mesh, n_devices=nd, degrees=tuple(args.degrees),
                       kappa=args.kappa, dtype=dtype, coarse=args.coarse,
                       coarse_cfg=ccfg, operator=args.operator,
                       smoother=args.smoother)
        setup = time.time() - t0
        b = assemble_rhs(mesh, pmax, f_rhs(args.kappa))
        bd = dist.to_dist(b)
        ud = bd * 0
        dist.apply(bd, ud)  # compile
        t0 = time.time()
        rnorms = []
        for _ in range(args.cycles):
            ud = dist.apply(bd, ud)
            rnorms.append(dist.residual_norm(bd, ud))
        per = (time.time() - t0) / args.cycles
        rel = rnorms[-1] / float(np.linalg.norm(b))
        print(f"{nd:>8} {mesh.num_dofs(pmax):>12} {setup:>9.1f} "
              f"{per:>10.4f} {rel:>11.3e}")
        if args.mode == "strong":
            if ref_trajectory is None:
                ref_trajectory = rnorms
            else:
                invariant = np.allclose(rnorms, ref_trajectory, rtol=rtol)
                print(f"{'':>8} residual trajectory invariant vs 1 device: "
                      f"{invariant}")


def _grid_sweep(args, dtype):
    """Strong-scaling sweep over multi-axis GridPMG shard layouts on one
    fixed mesh: 1x1x1, 2x1x1, 2x2x1, 2x2x2, ... up to the device count —
    residual trajectories must be layout-invariant."""
    import time

    import jax

    from pmg_dolfinx_jax.fem.assembly import assemble_rhs
    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.models.poisson import f_rhs, fit_box_cells
    from pmg_dolfinx_jax.parallel.grid2d import GridPMG

    if args.operator not in ("kron", "lattice"):
        raise SystemExit(
            f"--grid supports operators kron/lattice, got {args.operator!r}"
        )
    n_avail = args.max_devices or len(jax.devices())
    layouts = [(1, 1, 1), (2, 1, 1), (2, 2, 1), (2, 2, 2),
               (4, 2, 2), (4, 4, 2)]
    layouts = [s for s in layouts if s[0] * s[1] * s[2] <= n_avail]
    pmax = max(args.degrees)
    nc = fit_box_cells(args.ndofs, pmax)
    div_all = tuple(max(s[a] for s in layouts) for a in range(3))
    if args.dist_coarse and args.coarse == "hmg":
        # One factor-2 coarsening must stay divisible by every layout.
        per_axis = tuple(2 * d for d in div_all)
    else:
        per_axis = (max(div_all),) * 3
    nc = tuple((c + d - 1) // d * d for c, d in zip(nc, per_axis))
    mesh = BoxMesh(nc)
    b = assemble_rhs(mesh, pmax, f_rhs(args.kappa))
    rtol = 1e-9 if args.dtype == "f64" else 1e-3
    ref = None
    print(f"mesh {nc}, {mesh.num_dofs(pmax)} dofs, operator "
          f"{args.operator}")
    print(f"{'layout':>10} {'setup[s]':>9} {'s/cycle':>10} {'rel resid':>11}")
    for shards in layouts:
        op = args.operator
        t0 = time.time()
        # Pin the h-hierarchy across layouts (see the slab sweep note).
        ccfg = (dict(dist=True, bottom=args.bottom, divisors=div_all)
                if args.dist_coarse and args.coarse == "hmg"
                else dict(dist=True) if args.dist_coarse
                else dict(bottom=args.bottom) if args.coarse == "hmg"
                else None)
        grid = GridPMG(mesh, shards=shards, degrees=tuple(args.degrees),
                       kappa=args.kappa, dtype=dtype, coarse=args.coarse,
                       coarse_cfg=ccfg, operator=op,
                       smoother=args.smoother)
        setup = time.time() - t0
        grid.solve(b, num_cycles=1)  # compile
        t0 = time.time()
        _, rnorms = grid.solve(b, num_cycles=args.cycles)
        per = (time.time() - t0) / args.cycles
        rel = rnorms[-1] / float(np.linalg.norm(b))
        tag = "x".join(map(str, shards))
        print(f"{tag:>10} {setup:>9.1f} {per:>10.4f} {rel:>11.3e}")
        if ref is None:
            ref = rnorms
        else:
            invariant = np.allclose(rnorms, ref, rtol=rtol)
            print(f"{'':>10} trajectory invariant vs 1x1x1: {invariant}")


if __name__ == "__main__":
    main()

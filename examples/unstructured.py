"""Poisson on an EXTERNAL unstructured hex mesh (p-MG, dofmap/csr).

The reference's drivers build `create_box` meshes but its mesh layer
ingests arbitrary DOLFINx hex meshes (src/mesh.hpp:17-98,
examples/cg/main.cpp:39's --file option); this driver is that surface:

    python examples/unstructured.py --mesh-file mesh.npz   # or .msh
    python examples/unstructured.py --demo-n 4             # L-shape demo

npz files carry ``nodes`` (n, 3) float and ``cells`` (ncells, 8) int
(package corner order; add ``corner_order='gmsh'`` for Gmsh ordering);
``.msh`` files are Gmsh ASCII v2.2. The demo mode solves the
manufactured problem on the L-shaped extrusion and reports the L2
error; file mode solves with f = 1 and reports the residual history.
"""

import json
import sys

import numpy as np

from _common import base_parser, setup_jax


def main():
    p = base_parser("Poisson on an external unstructured hex mesh")
    p.add_argument("--mesh-file", default=None,
                   help=".npz (nodes+cells) or Gmsh ASCII v2.2 .msh")
    p.add_argument("--demo-n", type=int, default=0,
                   help="L-shaped demo mesh with 3*n^3 cells")
    p.add_argument("--degrees", type=int, nargs="+", default=[1, 3])
    p.add_argument("--coarse", choices=["direct", "cg", "smoother", "amg"],
                   default="direct",
                   help="'amg' = smoothed-aggregation multilevel coarse "
                   "(solvers/amg.py) — the scalable choice when the p=1 "
                   "level outgrows the dense 'direct' factor")
    p.add_argument("--smoother", choices=["cheb", "schwarz"],
                   default="cheb",
                   help="'schwarz' = per-cell FDM blocks from each "
                   "cell's own edge geometry (solvers/schwarz_dss.py)")
    p.add_argument("--dirichlet-groups", nargs="+", default=None,
                   help="Gmsh physical surface group names to mark "
                   "Dirichlet (mesh-file mode; untagged faces stay "
                   "natural) — tag-driven mixed BCs, no callables")
    p.add_argument("--rtol", type=float, default=1e-8)
    p.add_argument("--maxiter", type=int, default=50)
    args = p.parse_args()
    dtype = setup_jax(args)

    from pmg_dolfinx_jax.fem.assembly import (assemble_rhs,
                                              l2_error_collocated)
    from pmg_dolfinx_jax.fem.unstructured import (l_shaped_hex_mesh,
                                                  load_hex_mesh_npz,
                                                  read_gmsh_hex)
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy
    from pmg_dolfinx_jax.utils.timers import Timer, list_timings

    if args.operator not in ("dofmap", "csr", "dss"):
        print(f"unstructured topology: --operator {args.operator} needs "
              "per-axis structure; forcing 'dss' (the fast row-gather "
              "unstructured backend)")
        args.operator = "dss"

    demo = args.mesh_file is None
    if demo:
        n = args.demo_n or 4
        mesh = l_shaped_hex_mesh(n)
    elif args.mesh_file.endswith(".msh"):
        mesh = read_gmsh_hex(args.mesh_file,
                             dirichlet=args.dirichlet_groups or True)
        if mesh.tagged_faces:
            print(f"physical surface groups: {sorted(mesh.tagged_faces)}")
    else:
        mesh = load_hex_mesh_npz(args.mesh_file)
    P = max(args.degrees)
    print(f"{mesh}, degree {P}: {mesh.num_dofs(P)} dofs "
          f"(backend {args.operator})")

    pi = np.pi
    if demo:
        u_exact = lambda x: (np.sin(pi * x[0]) * np.sin(pi * x[1])
                             * np.sin(pi * x[2]))
        f = lambda x: 3.0 * pi**2 * args.kappa * u_exact(x)
    else:
        f = lambda x: np.ones(x.shape[1])

    with Timer("setup (dofmap merge + hierarchy + rhs)"):
        b = assemble_rhs(mesh, P, f)
        hier = PMGHierarchy(mesh, degrees=tuple(args.degrees),
                            kappa=args.kappa, dtype=dtype,
                            coarse=args.coarse, operator=args.operator,
                            smoother=args.smoother)
    with Timer("fcg solve"):
        u, niter = hier.solve_pcg(b, rtol=args.rtol, maxiter=args.maxiter)
    out = {"niter": int(niter)}
    print(f"FCG(V): {niter} iterations to rtol {args.rtol:g}")
    if demo:
        err = l2_error_collocated(mesh, P, np.asarray(u, dtype=np.float64),
                                  u_exact)
        out["l2_error"] = float(err)
        print(f"L2 error vs manufactured solution: {err:.4e}")
    list_timings()
    print(json.dumps(out))


if __name__ == "__main__":
    main()

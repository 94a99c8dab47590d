"""Modal-analysis driver: smallest eigenmodes of the diffusion pencil.

``K u = lam M u`` (GLL-lumped mass) solved matrix-free by shift-invert
LOBPCG on the framework's own inverses (`solvers/eig.py`): the batched
FDM direct solve for axis-aligned constant/per-axis kappa, the batched
FCG(V) solve for curved hexes / variable kappa. Beyond the reference
(solves only); on the constant-kappa unit cube the computed spectrum is
compared against the analytic ``kappa pi^2 (i^2+j^2+k^2)`` values.

    python examples/modes.py --ndofs 100000 --kmodes 6 [--neumann x]
        [--mesh perturbed] [--sigma 10] [--cpu --dtype f64]

Requires f64 (modal analysis is a setup-time computation).
"""

import json

import numpy as np

from _common import base_parser, setup_jax


def _analytic(kappa, faces, kmodes, sigma=0.0):
    """Lowest continuum eigenvalues on the unit cube for separable BC
    sets: per axis the 1D spectrum is (pi n)^2 with n >= 1 (D,D),
    n >= 0 (N,N), or (pi (n + 1/2))^2 with n >= 0 (mixed)."""
    per_axis = []
    for lo, hi in faces:
        if lo and hi:
            w = [(np.pi * n) ** 2 for n in range(1, kmodes + 2)]
        elif not lo and not hi:
            w = [(np.pi * n) ** 2 for n in range(0, kmodes + 2)]
        else:
            w = [(np.pi * (n + 0.5)) ** 2 for n in range(0, kmodes + 2)]
        per_axis.append(w)
    sums = sorted(
        a + b + c
        for a in per_axis[0] for b in per_axis[1] for c in per_axis[2]
    )
    return [kappa * s + sigma for s in sums[:kmodes]]


def main():
    p = base_parser(__doc__)
    p.add_argument("--kmodes", type=int, default=4,
                   help="number of lowest eigenpairs")
    p.add_argument("--sigma", type=float, default=0.0,
                   help="lumped-mass shift (screened pencil)")
    p.add_argument("--degree", type=int, default=3)
    p.add_argument("--neumann", type=str, default="",
                   help="axes whose BOTH faces are natural-Neumann")
    p.add_argument("--mesh", choices=["box", "perturbed"], default="box")
    p.add_argument("--kappa-field", choices=["const", "linear"],
                   default="const")
    args = p.parse_args()
    args.dtype = "f64"  # modal analysis runs in f64
    setup_jax(args)

    import jax

    from pmg_dolfinx_jax.fem.mesh import BoxMesh, PerturbedBoxMesh
    from pmg_dolfinx_jax.models.poisson import fit_box_cells, kappa_linear
    from pmg_dolfinx_jax.solvers.eig import lowest_eigenpairs
    from pmg_dolfinx_jax.utils.timers import Timer, list_timings

    nc = fit_box_cells(args.ndofs, args.degree)
    faces = tuple(
        (False, False) if "xyz"[a] in args.neumann else (True, True)
        for a in range(3)
    )
    if args.neumann and not any(any(f) for f in faces) and not args.sigma:
        raise SystemExit("all-Neumann with sigma=0 is singular; add "
                         "--sigma or keep one Dirichlet axis")
    mk = PerturbedBoxMesh if args.mesh == "perturbed" else BoxMesh
    mesh = mk(nc, dirichlet_faces=faces)
    kappa = kappa_linear if args.kappa_field == "linear" else args.kappa
    print(f"mesh {nc[0]}x{nc[1]}x{nc[2]} ({args.mesh}), p={args.degree}, "
          f"{mesh.num_dofs(args.degree)} dofs, backend "
          f"{jax.default_backend()}")
    with Timer(f"lowest {args.kmodes} eigenpairs (LOBPCG)"):
        lams, U, iters = lowest_eigenpairs(
            mesh, args.degree, kappa=kappa, k=args.kmodes,
            sigma=args.sigma,
        )
    print(f"LOBPCG iterations: {iters}")
    print("eigenvalues:", " ".join(f"{l:.6f}" for l in lams))
    if args.mesh == "box" and args.kappa_field == "const":
        ana = _analytic(args.kappa, faces, args.kmodes, sigma=args.sigma)
        print("analytic:   ", " ".join(f"{l:.6f}" for l in ana))
        rel = np.abs(np.asarray(lams) - ana) / np.asarray(ana)
        print("rel deviation (discretization):",
              " ".join(f"{r:.2e}" for r in rel))
    list_timings()
    print(json.dumps({"eigenvalues": [float(l) for l in lams],
                      "iters": iters}))


if __name__ == "__main__":
    main()

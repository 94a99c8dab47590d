"""Anisotropy-remedy study: one table, every remedy, measured.

Compares the framework's three anisotropy remedies — more smoothing
(smoother_iters), h-MG SEMI-COARSENING (hmg.semicoarsen_sizes), and LINE
RELAXATION (solvers/line.py) — against point-Jacobi baselines on three
measured problem classes:

  A. grid-aligned tensor anisotropy: kappa = diag(1,1,64), (8,8,16)
     cells, p=(1,3), h-MG coarse — FCG iterations to rtol 1e-10 (cap
     80) and true error vs the assembled scipy direct solve;
  B. rotated (off-axis) 100:1 tensor, (6,6,6), p=(1,3,6), exact dense
     coarse — STATIONARY contraction after 10 V-cycles (the pinned
     divergence case of warn_tensor_stationary) plus FCG iterations;
  C. stretched cells (unit extent, (16,8,4) cells => 4:1:0.25 aspect),
     SCALAR kappa — the mesh-induced anisotropy the auto line/semi
     axis detection must catch without a tensor coefficient.

The reference has one answer to all of these: hypre BoomerAMG
strength-of-connection coarsening at p=1 (src/amg.hpp:11-119), which
helps the coarse problem but cannot fix the high-p smoother (the
divergence lives at the high-p levels — the r3 Galerkin bisect,
tests/test_tensor_kappa.py). CPU f64 run: ~10 min warm cache.
"""

import os
import sys
import warnings

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from pmg_dolfinx_jax.utils.cache import enable_compile_cache

    enable_compile_cache(min_compile_secs=0.3)
    import jax.numpy as jnp
    import scipy.sparse.linalg as spla

    from pmg_dolfinx_jax.fem.assembly import assemble_rhs, assemble_stiffness
    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.models.poisson import (
        f_rhs,
        f_rhs_tensor,
        kappa_aniso,
    )
    from pmg_dolfinx_jax.solvers.hmg import semicoarsen_axes, semicoarsen_sizes
    from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

    def fcg(mesh, degrees, kappa, b, coarse, si=2, smoother="cheb",
            cfg=None, operator="lattice"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            h = PMGHierarchy(mesh, degrees=degrees, kappa=kappa,
                             dtype=jnp.float64, coarse=coarse,
                             operator=operator, smoother_iters=si,
                             smoother=smoother, coarse_cfg=cfg)
            u, niter = h.solve_pcg(jnp.asarray(b), rtol=1e-10, maxiter=80)
        return np.asarray(u), int(niter)

    def stationary_rel(mesh, degrees, kappa, b, si, smoother):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            h = PMGHierarchy(mesh, degrees=degrees, kappa=kappa,
                             dtype=jnp.float64, coarse="direct",
                             operator="lattice", smoother_iters=si,
                             smoother=smoother)
            _, rn = h.solve(jnp.asarray(b), num_cycles=10)
        rn = np.asarray(rn)
        return float(rn[-1] / rn[0])

    # ---- A: grid-aligned diag(1,1,64), hmg coarse ----------------------
    print("\n## A. diag(1,1,64), (8,8,16) cells, p=(1,3), coarse='hmg'")
    print("FCG(V) iterations to rtol 1e-10 (cap 80) + max|u - u_direct|\n")
    K = np.diag([1.0, 1.0, 64.0])
    nc = (8, 8, 16)
    mesh = BoxMesh(nc)
    b = assemble_rhs(mesh, 3, f_rhs_tensor(K))
    u_ref = spla.spsolve(assemble_stiffness(mesh, 3, kappa=K).tocsc(), b)
    semi = dict(sizes=semicoarsen_sizes(nc, semicoarsen_axes(mesh, K)))
    rows = [
        ("point Jacobi, isotropic h-MG", dict()),
        ("point Jacobi, SEMI-coarsened h-MG", dict(cfg=dict(semi))),
        ("point Jacobi, semi + smoother_iters=4", dict(cfg=dict(semi), si=4)),
        ("LINE (p-levels only), isotropic h-MG", dict(smoother="line")),
        ("LINE everywhere, isotropic h-MG",
         dict(smoother="line", cfg=dict(smoother="line"))),
        ("LINE everywhere + semi-coarsening",
         dict(smoother="line", cfg=dict(smoother="line", **semi))),
        ("SCHWARZ everywhere, isotropic h-MG",
         dict(smoother="schwarz", cfg=dict(smoother="schwarz"))),
        ("SCHWARZ everywhere + semi-coarsening",
         dict(smoother="schwarz", cfg=dict(smoother="schwarz", **semi))),
        ("point Jacobi, EXACT dense coarse (bar)",
         dict()),  # coarse override below
    ]
    print("| smoother / hierarchy | FCG iters | max err |")
    print("|---|---|---|")
    for name, kw in rows:
        coarse = "direct" if "EXACT" in name else "hmg"
        u, niter = fcg(mesh, (1, 3), K, b, coarse, **kw)
        err = np.abs(u - u_ref).max()
        cap = " (cap)" if niter >= 80 else ""
        print(f"| {name} | {niter}{cap} | {err:.1e} |")

    # ---- B: rotated 100:1, stationary + FCG ----------------------------
    print("\n## B. rotated 100:1 tensor (pi/6), (6,6,6), p=(1,3,6), "
          "coarse='direct'")
    print("stationary |r10|/|r0| after 10 V-cycles; FCG iters to 1e-10\n")
    Kr = kappa_aniso()
    mesh_b = BoxMesh((6, 6, 6))
    b_b = assemble_rhs(mesh_b, 6, f_rhs_tensor(Kr))
    print("| smoother | stationary rel@10 | FCG iters |")
    print("|---|---|---|")
    for name, si, sm in (
        ("point Jacobi, si=2 (default)", 2, "cheb"),
        ("point Jacobi, si=3", 3, "cheb"),
        ("LINE, si=2", 2, "line"),
        ("SCHWARZ (cell-FDM), si=2", 2, "schwarz"),
    ):
        rel = stationary_rel(mesh_b, (1, 3, 6), Kr, b_b, si, sm)
        _, niter = fcg(mesh_b, (1, 3, 6), Kr, b_b, "direct", si=si,
                       smoother=sm)
        tag = "DIVERGED" if rel > 1 else f"{rel:.1e}"
        print(f"| {name} | {tag} | {niter} |")

    # ---- C: stretched cells, scalar kappa ------------------------------
    print("\n## C. stretched cells (16,8,4) on the unit cube (h ratios "
          "1:2:4), SCALAR kappa, p=(1,3), coarse='hmg'")
    print("mesh-induced anisotropy: auto axis detection, no tensor\n")
    mesh_c = BoxMesh((16, 8, 4))
    b_c = assemble_rhs(mesh_c, 3, f_rhs(2.0))
    u_ref_c = spla.spsolve(
        assemble_stiffness(mesh_c, 3, kappa=2.0).tocsc(), b_c)
    axes_c = semicoarsen_axes(mesh_c, 2.0)
    semi_c = dict(sizes=semicoarsen_sizes((16, 8, 4), axes_c))
    print(f"auto semi axes: {axes_c} (strongest = smallest h = x)")
    print("\n| smoother / hierarchy | FCG iters | max err |")
    print("|---|---|---|")
    for name, kw in (
        ("point Jacobi, isotropic h-MG", dict()),
        ("point Jacobi, SEMI-coarsened", dict(cfg=dict(semi_c))),
        ("LINE auto (x), isotropic h-MG",
         dict(smoother="line", cfg=dict(smoother="line"))),
        ("SCHWARZ (cell-FDM), isotropic h-MG",
         dict(smoother="schwarz", cfg=dict(smoother="schwarz"))),
    ):
        u, niter = fcg(mesh_c, (1, 3), 2.0, b_c, "hmg", **kw)
        err = np.abs(u - u_ref_c).max()
        cap = " (cap)" if niter >= 80 else ""
        print(f"| {name} | {niter}{cap} | {err:.1e} |")


if __name__ == "__main__":
    main()

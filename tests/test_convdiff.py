"""Convection-diffusion family: ``-div(k grad u) + c . grad u + sigma u
= f`` (solvers/convdiff.py, ops.kron.axis_advection/kron_convdiff_apply,
solvers/bicgstab.py).

Oracles: (1) an independently assembled 1D advection matrix
(Gauss-Legendre quadrature, per-cell loop — vs the framework's one-shot
GLL/tabulation form), (2) the analytic skew decomposition
``C + C^T = e_N e_N^T - e_0 e_0^T``, (3) scipy spsolve of the assembled
nonsymmetric system, (4) the manufactured solution.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from pmg_dolfinx_jax.fem.assembly import (
    assemble_rhs, assemble_stiffness, l2_error, lumped_mass_np)
from pmg_dolfinx_jax.fem.gll import (
    gauss_legendre, gauss_lobatto, lagrange_tabulate)
from pmg_dolfinx_jax.fem.mesh import BoxMesh
from pmg_dolfinx_jax.models.poisson import u_exact
from pmg_dolfinx_jax.ops.kron import axis_advection, axis_stiffness_mass
from pmg_dolfinx_jax.solvers.convdiff import convdiff_solve
from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

KAPPA = 2.0
CVEL = (3.0, -1.5, 0.8)


def _dense_advection_1d(nc, P):
    """Independent 1D advection assembly: per-cell Gauss-LEGENDRE
    quadrature (exact for the degree-(2P-1) integrand, different points
    than the framework's collocated GLL path) with an explicit
    overlap-add loop."""
    xg, _ = gauss_lobatto(P + 1)
    q, wq = gauss_legendre(P + 1)
    tab = lagrange_tabulate(xg, q, nderiv=1)
    phi, dphi = tab[0], tab[1]
    C_loc = np.einsum("q,qi,qj->ij", wq, phi, dphi)
    N = nc * P + 1
    C = np.zeros((N, N))
    for c in range(nc):
        s = c * P
        C[s:s + P + 1, s:s + P + 1] += C_loc
    return C


def _assembled_convdiff(mesh, P, kappa, sigma, cvel):
    """scipy oracle: symmetric part (assembled stiffness + lumped shift,
    bc identity rows) plus the separable advection with bc rows/cols
    masked (matching the operator's mask-in/identity-row convention)."""
    A = assemble_stiffness(mesh, P, kappa=kappa, bc=True).tocsr()
    if sigma:
        A = A + sigma * sp.diags(lumped_mass_np(mesh, P, bc_zero=True))
    Cs = [sp.csr_matrix(axis_advection(mesh.nc[a], P)) for a in range(3)]
    ms = [axis_stiffness_mass(mesh.nc[a], P, mesh.h_cells[a])[1]
          for a in range(3)]
    adv = (cvel[0] * sp.kron(Cs[0], sp.kron(sp.diags(ms[1]),
                                            sp.diags(ms[2])))
           + cvel[1] * sp.kron(sp.diags(ms[0]),
                               sp.kron(Cs[1], sp.diags(ms[2])))
           + cvel[2] * sp.kron(sp.diags(ms[0]),
                               sp.kron(sp.diags(ms[1]), Cs[2])))
    z = sp.diags((~np.asarray(mesh.boundary_dof_marker(P))).astype(float))
    return (A + z @ adv @ z).tocsc()


def test_axis_advection_oracles():
    """Framework C vs the independent Gauss-Legendre assembly, and the
    exact integration-by-parts skew identity (uniform AND graded — C is
    scale-free)."""
    from pmg_dolfinx_jax.fem.mesh import geometric_spacing

    for nc, P in ((4, 3), (3, 6)):
        C = axis_advection(nc, P)
        assert np.allclose(C, _dense_advection_1d(nc, P), atol=1e-13)
        S = C + C.T
        E = np.zeros_like(S)
        E[0, 0], E[-1, -1] = -1.0, 1.0
        assert np.allclose(S, E, atol=1e-13)
        # Scale-free: grading cannot change it (same assembly code path
        # takes no h at all — this pins the claim at the API level).
        assert C.shape == (nc * P + 1, nc * P + 1)


def test_convdiff_apply_vs_assembled():
    """kron_convdiff_apply == the scipy kron-assembled nonsymmetric
    operator (graded mesh included)."""
    import jax.numpy as jnp

    from pmg_dolfinx_jax.fem.mesh import geometric_spacing
    from pmg_dolfinx_jax.ops.kron import kron_convdiff_apply

    P, sigma = 3, 0.6
    for spacing in (None, (None, geometric_spacing(4, 3.0), None)):
        mesh = BoxMesh((3, 4, 5), extent=(1.0, 2.0, 0.7), spacing=spacing)
        Ks, ms = zip(*(axis_stiffness_mass(mesh.nc[a], P, mesh.h_cells[a])
                       for a in range(3)))
        Ks = tuple(KAPPA * K for K in Ks)
        Cs = tuple(axis_advection(mesh.nc[a], P) for a in range(3))
        bc = np.asarray(mesh.boundary_dof_marker(P))
        x = np.random.default_rng(0).standard_normal(mesh.num_dofs(P))
        y = np.asarray(kron_convdiff_apply(
            jnp.asarray(x), tuple(map(jnp.asarray, Ks)),
            tuple(map(jnp.asarray, Cs)), tuple(map(jnp.asarray, ms)),
            jnp.asarray(np.asarray(CVEL)), jnp.asarray(bc), sigma=sigma))
        A = _assembled_convdiff(mesh, P, KAPPA, sigma, CVEL)
        ref = A @ x
        assert np.linalg.norm(y - ref) < 1e-12 * np.linalg.norm(ref)


def _grad_u_exact(x):
    pi = np.pi
    sx, sy, sz = (np.sin(pi * x[a]) for a in range(3))
    cx, cy, cz = (np.cos(pi * x[a]) for a in range(3))
    return np.stack([pi * cx * sy * sz, pi * sx * cy * sz,
                     pi * sx * sy * cz])


def _f_convdiff(kappa, cvel, sigma=0.0):
    def f(x):
        g = _grad_u_exact(x)
        return ((3.0 * np.pi**2 * kappa + sigma) * u_exact(x)
                + sum(cvel[a] * g[a] for a in range(3)))

    return f


def test_convdiff_solve_end_to_end():
    """BiCGStab + symmetric-V-cycle preconditioner solves the
    nonsymmetric system: manufactured accuracy + spsolve match."""
    mesh = BoxMesh((6, 6, 6))
    P, sigma = 3, 0.6
    b = assemble_rhs(mesh, P, _f_convdiff(KAPPA, CVEL, sigma))
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=KAPPA, coarse="fdm",
                        operator="kron", sigma=sigma)
    u, info = convdiff_solve(hier, b, CVEL, rtol=1e-11)
    assert info["rel_resid"] < 1e-11, info
    A = _assembled_convdiff(mesh, P, KAPPA, sigma, CVEL)
    u_ref = spla.spsolve(A, b)
    assert np.linalg.norm(np.asarray(u) - u_ref) < \
        1e-8 * np.linalg.norm(u_ref)
    err = l2_error(mesh, P, np.asarray(u), u_exact)
    assert err < 2e-4, err


def test_convdiff_rejects_non_kron():
    mesh = BoxMesh((4, 4, 4))
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=KAPPA,
                        coarse="direct", operator="lattice")
    with pytest.raises(ValueError, match="operator='kron'"):
        convdiff_solve(hier, np.zeros(mesh.num_dofs(3)), CVEL)


@pytest.mark.parametrize("layout", ["slab", "grid"])
def test_convdiff_sharded_matches_oracle(layout):
    """The shard_map'd BiCGStab program (per-axis advection exchanges)
    solves the same system: spsolve-verified on slab and grid layouts."""
    mesh = BoxMesh((8, 8, 6))
    P, sigma = 3, 0.6
    b = assemble_rhs(mesh, P, _f_convdiff(KAPPA, CVEL, sigma))
    kw = dict(degrees=(1, 3), kappa=KAPPA, coarse="fdm", operator="kron",
              sigma=sigma)
    if layout == "slab":
        from pmg_dolfinx_jax.parallel.dist import DistPMG

        hier = DistPMG(mesh, n_devices=4, **kw)
    else:
        from pmg_dolfinx_jax.parallel.grid2d import GridPMG

        hier = GridPMG(mesh, shards=(2, 2), **kw)
    u, info = convdiff_solve(hier, b, CVEL, rtol=1e-11)
    assert info["rel_resid"] < 1e-11, info
    A = _assembled_convdiff(mesh, P, KAPPA, sigma, CVEL)
    u_ref = spla.spsolve(A, b)
    assert np.linalg.norm(np.asarray(u) - u_ref) < \
        1e-8 * np.linalg.norm(u_ref)


def test_sd_tau_limits():
    """sd_stabilized_kappa consistency: zero velocity leaves kappa
    untouched, small Pe adds O(Pe) nothing, tau= overrides."""
    from pmg_dolfinx_jax.solvers.convdiff import sd_stabilized_kappa

    mesh = BoxMesh((6, 6, 6))
    keff, taus = sd_stabilized_kappa(mesh, 3, (0.0, 0.0, 0.0), 2.0)
    assert keff == (2.0, 2.0, 2.0) and taus == (0.0, 0.0, 0.0)
    keff2, _ = sd_stabilized_kappa(mesh, 3, (1e-3, 0.0, 0.0), 2.0)
    assert keff2[0] - 2.0 < 1e-8  # tau c^2 ~ h^2 c^2 / (12 k)
    keff3, t3 = sd_stabilized_kappa(mesh, 3, (2.0, 0.0, 0.0), 1.0,
                                    tau=0.5)
    assert t3 == (0.5, 0.5, 0.5)
    assert abs(keff3[0] - (1.0 + 0.5 * 4.0)) < 1e-15


def test_sd_stabilized_high_peclet():
    """Cell Pe ~ 20 — far beyond the unstabilized regime (~1): the SD
    effective diffusion keeps BiCGStab+V(fdm) converging fast, and the
    computed solution is exactly the stabilized system's (spsolve of
    the assembled diagonal-tensor operator)."""
    from pmg_dolfinx_jax.solvers.convdiff import sd_stabilized_kappa

    mesh = BoxMesh((6, 6, 6))
    P, kappa, cvel = 3, 0.004, (1.0, 0.4, 0.2)
    pe = 1.0 * (1.0 / 6.0) / (2.0 * kappa)
    assert pe > 15
    b = assemble_rhs(mesh, P, _f_convdiff(kappa, cvel))
    # 'cell' scale (robustness-leaning): measured 32 iterations.
    keff_c, _ = sd_stabilized_kappa(mesh, P, cvel, kappa, h_eff="cell")
    hier_c = PMGHierarchy(mesh, degrees=(1, 3), kappa=keff_c,
                          coarse="fdm", operator="kron")
    _, info_c = convdiff_solve(hier_c, b, cvel, rtol=1e-9, maxiter=200)
    assert info_c["rel_resid"] < 1e-9 and info_c["niter"] < 60, info_c
    # default 'p' scale (accuracy-leaning): measured 104 iterations,
    # and the answer is EXACTLY the stabilized assembled system's.
    keff, taus = sd_stabilized_kappa(mesh, P, cvel, kappa)
    assert all(k > kappa for k in keff) and taus[0] > 0
    assert keff[0] < keff_c[0]
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=keff, coarse="fdm",
                        operator="kron")
    u, info = convdiff_solve(hier, b, cvel, rtol=1e-9, maxiter=200)
    assert info["rel_resid"] < 1e-9 and info["niter"] < 150, info
    A = _assembled_convdiff(mesh, P, np.diag(keff), 0.0, cvel)
    u_ref = spla.spsolve(A, b)
    assert np.linalg.norm(np.asarray(u) - u_ref) < \
        1e-7 * np.linalg.norm(u_ref)


def test_sd_moderate_pe_keeps_accuracy():
    """At cell Pe < 1 the default ('p'-scale) SD perturbation keeps the
    manufactured-solution error within ~15x of the (spectrally
    accurate) unstabilized Galerkin solve — the measured O(h)
    consistency cost documented in sd_stabilized_kappa."""
    from pmg_dolfinx_jax.solvers.convdiff import sd_stabilized_kappa

    mesh = BoxMesh((4, 4, 4))
    P, kappa, cvel = 3, 0.3, (1.0, 0.5, -0.3)
    b = assemble_rhs(mesh, P, _f_convdiff(kappa, cvel))
    base = PMGHierarchy(mesh, degrees=(1, 3), kappa=kappa, coarse="fdm",
                        operator="kron")
    u_g, _ = convdiff_solve(base, b, cvel, rtol=1e-11)
    err_g = l2_error(mesh, P, np.asarray(u_g), u_exact)
    keff, _ = sd_stabilized_kappa(mesh, P, cvel, kappa)
    hier = PMGHierarchy(mesh, degrees=(1, 3), kappa=keff, coarse="fdm",
                        operator="kron")
    u_s, _ = convdiff_solve(hier, b, cvel, rtol=1e-11)
    err_s = l2_error(mesh, P, np.asarray(u_s), u_exact)
    assert err_s < 20.0 * err_g, (err_s, err_g)
    assert err_s < 2e-3, err_s

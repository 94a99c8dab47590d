"""Kronecker-sum Laplacian: the production fast path for box meshes.

On any axis-aligned tensor-product mesh — which is every mesh the
reference drivers can build (`mesh::create_box`, examples/pmg/main.cpp:442)
— the per-cell Jacobian is diagonal, the geometry factor G is diagonal and
per-axis separable, and GLL collocation makes the 1D mass matrix exactly
diagonal (lumped). The weighted stiffness operator then collapses to the
Kronecker sum

    A = kappa * ( K_x (x) M_y (x) M_z
                + M_x (x) K_y (x) M_z
                + M_x (x) M_y (x) K_z )

with per-axis banded 1D stiffness matrices ``K[(N, N)]`` and diagonal
lumped mass vectors ``m[(N,)]``. One operator apply = THREE dense banded
matmuls + broadcast scalings, no indexed memory access. In true f32
('highest') it agrees with the general path to ~3e-8 (tests). PERF.md
holds the measured apply rates.

This is the same discrete operator the reference's sum-factorized kernel
(src/laplacian.hpp:143-278) evaluates on these meshes — verified against
the assembled oracle to 1e-12 in f64 — reached by exploiting structure
instead of emulating CUDA scatter patterns. General (non-axis-aligned)
hexes use `ops/lattice.py`; unstructured meshes use `ops/laplacian.py`.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.gll import gauss_lobatto
from .lattice import axis_matrices


def axis_stiffness_mass(nc: int, P: int, h,
                        robin=(0.0, 0.0)) -> tuple[np.ndarray, np.ndarray]:
    """1D GLL stiffness ``K[(N, N)]`` and lumped mass ``m[(N,)]`` on an
    ``nc``-cell 1D mesh with per-cell spacings ``h`` (scalar or (nc,)).

    K = Dg^T diag(w_q / h_c) Dg ;  m = E^T (w_q * h_c)  — the 1D
    reductions of the 3D geometry pipeline for diagonal Jacobians.

    ``robin=(alpha_lo, alpha_hi)`` adds the Robin boundary-condition
    end-point terms ``alpha * e_end e_end^T`` to K: on the axis-aligned
    box the 3D Robin boundary mass ``alpha integral_face u v ds``
    factors EXACTLY as ``alpha e0 e0^T (x) M (x) M`` (GLL surface
    lumping), so a scalar end update carries the whole Robin family
    through every Kronecker-structured consumer — kron
    applies, the FDM direct solver, h-MG rebuilds, line/Schwarz blocks.
    """
    h = np.broadcast_to(np.asarray(h, dtype=np.float64), (nc,))
    E, Dg = axis_matrices(nc, P)
    _, w1 = gauss_lobatto(P + 1)
    w = np.tile(w1, nc)
    hq = np.repeat(h, P + 1)
    K = Dg.T @ ((w / hq)[:, None] * Dg)
    m = E.T @ (w * hq)
    if robin[0]:
        K[0, 0] += float(robin[0])
    if robin[1]:
        K[-1, -1] += float(robin[1])
    return K, m


def axis_advection(nc: int, P: int) -> np.ndarray:
    """1D GLL advection (weak first-derivative) matrix ``C[(N, N)]``,
    ``C_ij = integral phi_i phi_j' dx``, on an ``nc``-cell 1D mesh.

    Scale-free: the 1/h of the derivative cancels the h of the volume
    element, so C is independent of the (possibly graded) cell widths —
    one matrix serves every shard of a sharded axis unchanged. GLL
    quadrature with P+1 points integrates the degree-(2P-1) product
    exactly, so the skew decomposition ``C + C^T = e_N e_N^T - e_0 e_0^T``
    (integration by parts) holds to rounding (pinned in tests).

    The 3D advection operator on an axis-aligned box factors as
        c . grad  ->  sum_a c_a * M_b (x) C_a (x) M_c
    (same separability as the Kronecker-sum stiffness), evaluated by
    `kron_convdiff_apply`.
    """
    E, Dg = axis_matrices(nc, P)
    _, w1 = gauss_lobatto(P + 1)
    w = np.tile(w1, nc)
    return E.T @ (w[:, None] * Dg)


def kron_advection_terms(x_masked, Cs, ms, cvel, precision="highest",
                         exchanges=(None, None, None)):
    """``sum_a c_a (M_b (x) C_a (x) M_c) x`` on the lattice-shaped,
    bc-masked input — the advection half of `kron_convdiff_apply`.

    ``exchanges[a]``: optional per-axis interface partial-sum exchange
    (the distributed layouts pass their ppermute pair for each sharded
    axis — only the axis-a contraction produces shard-partial interface
    planes; the mass scalings are pointwise and already consistent on
    duplicated planes, exactly as for the stiffness terms).
    """
    Cx, Cy, Cz = Cs
    mx, my, mz = ms
    w = x_masked
    tx = jnp.einsum("ax,xyz->ayz", Cx, w, precision=precision)
    if exchanges[0] is not None:
        tx = exchanges[0](tx)
    ty = jnp.einsum("by,xyz->xbz", Cy, w, precision=precision)
    if exchanges[1] is not None:
        ty = exchanges[1](ty)
    tz = jnp.einsum("cz,xyz->xyc", Cz, w, precision=precision)
    if exchanges[2] is not None:
        tz = exchanges[2](tz)
    return (cvel[0] * tx * (my[None, :, None] * mz[None, None, :])
            + cvel[1] * ty * (mx[:, None, None] * mz[None, None, :])
            + cvel[2] * tz * (mx[:, None, None] * my[None, :, None]))


def kron_convdiff_apply(x, Ks, Cs, ms, cvel, bc_marker,
                        precision="highest", sigma=0.0,
                        exchange=None, adv_exchanges=(None, None, None)):
    """Convection-diffusion operator ``y = (A + sigma M + B(c)) x`` on the
    Kronecker family: the symmetric-scaled stiffness sum
    (`kron_laplacian_apply`) plus the separable advection terms
    (`kron_advection_terms`), one shared bc mask/epilogue.

    Nonsymmetric — solve with `solvers.bicgstab` preconditioned by the
    V-cycle of the symmetric (diffusion + shift) part. Beyond reference
    parity (the reference has only the symmetric Poisson form).
    """
    lat = x.reshape(Ks[0].shape[1], Ks[1].shape[1], Ks[2].shape[1])
    bc3 = bc_marker.reshape(lat.shape)
    w = jnp.where(bc3, jnp.zeros_like(lat), lat)
    y = kron_laplacian_apply(
        w, Ks, ms, bc3, precision=precision,
        apply_bc=False, exchange=exchange, sigma=sigma,
    )
    y = y + kron_advection_terms(w, Cs, ms, cvel, precision=precision,
                                 exchanges=adv_exchanges)
    return jnp.where(bc3, lat, y).reshape(jnp.shape(x))


def robin_axis_ends(mesh, axis: int, scale: float = 1.0):
    """Per-axis Robin end coefficients ``(alpha_lo, alpha_hi) * scale``
    for `axis_stiffness_mass(robin=...)`. NOTE the kappa interplay: the
    Robin boundary mass is NOT scaled by kappa, so a caller that later
    multiplies K by ``k_a`` must pass ``scale=1/k_a`` here (the FDM
    eigenvalue path), or fold robin AFTER the kappa multiply."""
    ra = getattr(mesh, "robin_alpha", None)
    if ra is None:
        return (0.0, 0.0)
    return (float(ra[axis, 0]) * scale, float(ra[axis, 1]) * scale)


def stacked_local_K(Kl, k_a, robin_ends, n_shards):
    """Per-shard stacked kappa-folded LOCAL axis stiffness for a SHARDED
    mesh axis whose global ends carry Robin terms: ``(S * npl, npl)``
    float64, sharded along rows (each shard sees its own ``(npl, npl)``
    block inside shard_map — the per-shard apply code is unchanged).

    On a uniform mesh the local stiffness is shard-invariant, so the
    distributed layouts normally replicate one ``(npl, npl)`` matrix;
    Robin breaks that symmetry ONLY at the global ends — the kappa-free
    ``alpha`` updates land on the first shard's ``[0, 0]`` and the last
    shard's ``[-1, -1]`` entries, which in the row-stacked layout are
    simply the global ``[0, 0]`` and ``[-1, -1]`` corners.
    """
    out = np.tile(k_a * np.asarray(Kl, np.float64), (int(n_shards), 1))
    out[0, 0] += float(robin_ends[0])
    out[-1, -1] += float(robin_ends[1])
    return out


def local_axis_K(mesh, a, nc_local, Pdeg, k_a, n_shards_a):
    """Kappa-folded LOCAL axis stiffness with the mesh's Robin ends for
    the distributed layouts: ``(K, stacked)``.

    ``stacked=False``: the shard-invariant ``(npl, npl)`` float64 matrix
    (replicate, spec ``P()``) — a uniform no-Robin axis, or an unsharded
    axis with its grading / Robin ends folded in directly.
    ``stacked=True``: the per-shard row-stacked form ``(S*npl, npl)``
    (shard along rows, spec ``P(axis)``, each shard reads its own
    ``(npl, npl)`` block inside shard_map) — a SHARDED axis whose local
    stiffness differs per shard: global-end Robin terms
    (`stacked_local_K`) and/or GRADED spacing (each shard's block is
    assembled from its own slice of ``mesh.h_cells[a]``).
    """
    ends = robin_axis_ends(mesh, a)
    h_cells = mesh.h_cells[a]
    graded = not bool(np.allclose(h_cells, h_cells[0], rtol=1e-12))
    if n_shards_a == 1 or not graded:
        K, _ = axis_stiffness_mass(nc_local, Pdeg,
                                   h_cells if n_shards_a == 1
                                   else h_cells[0])
        if ends == (0.0, 0.0):
            return k_a * K, False
        if n_shards_a == 1:
            K = k_a * K
            K[0, 0] += ends[0]
            K[-1, -1] += ends[1]
            return K, False
        return stacked_local_K(K, k_a, ends, n_shards_a), True
    blocks = []
    for s in range(n_shards_a):
        Ks, _ = axis_stiffness_mass(
            nc_local, Pdeg, h_cells[s * nc_local:(s + 1) * nc_local])
        blocks.append(k_a * Ks)
    out = np.vstack(blocks)
    out[0, 0] += float(ends[0])
    out[-1, -1] += float(ends[1])
    return out, True


def kron_laplacian_apply(x, Ks, ms, bc_marker, precision="highest",
                         apply_bc=True, exchange=None, sigma=0.0):
    """``y = A x`` via the Kronecker-sum form (jittable, shape-preserving).

    Parameters
    ----------
    x : flat ``(NX*NY*NZ,)`` or lattice-shaped ``(NX, NY, NZ)`` input; the
        output matches. Solvers keep vectors lattice-shaped end-to-end
        (one convention through every cycle primitive).
    Ks : (Kx, Ky, Kz) — per-axis stiffness matrices with kappa folded in.
    ms : (mx, my, mz) — per-axis lumped mass vectors.
    bc_marker : bool marker, same shape convention as ``x``.
    exchange : optional callable applied to the K_x term's lattice BEFORE
        the terms are summed — the distributed layer passes the interface
        partial-sum exchange here (only the x-contraction produces
        shard-partial sums; the other terms are pointwise in x and already
        consistent on duplicated planes).

    Internally uses the symmetrized scaling
    ``A = S (Kt_x ⊕ Kt_y ⊕ Kt_z) S`` with ``S = diag(s_x ⊗ s_y ⊗ s_z)``,
    ``s_a = sqrt(m_a)``, ``Kt_a = S_a^-1 K_a S_a^-1`` — algebraically
    identical to the mass-weighted Kronecker sum but with two fused
    elementwise scalings instead of three lattice-sized mass broadcasts.
    The tiny (N,N) rescalings of
    K are recomputed per call and fuse into the matmul operands.
    """
    prec = precision
    Kx, Ky, Kz = Ks
    mx, my, mz = ms
    NX, NY, NZ = Kx.shape[1], Ky.shape[1], Kz.shape[1]
    sx, sy, sz = jnp.sqrt(mx), jnp.sqrt(my), jnp.sqrt(mz)
    Ktx = Kx / sx[:, None] / sx[None, :]
    Kty = Ky / sy[:, None] / sy[None, :]
    Ktz = Kz / sz[:, None] / sz[None, :]
    s3 = sx[:, None, None] * sy[None, :, None] * sz[None, None, :]
    w = (jnp.where(bc_marker, jnp.zeros_like(x), x).reshape(NX, NY, NZ)) * s3

    t1 = jnp.einsum("ax,xyz->ayz", Ktx, w, precision=prec)
    if exchange is not None:
        t1 = exchange(t1)
    t2 = jnp.einsum("by,xyz->xbz", Kty, w, precision=prec)
    t3 = jnp.einsum("cz,xyz->xyc", Ktz, w, precision=prec)
    t = t1 + t2 + t3
    if sigma:
        # Shifted (reaction-diffusion) operator A + sigma*M with the
        # GLL-lumped mass M = diag(mx (x) my (x) mz): since w already
        # carries one sqrt-mass factor, sigma*w*s3 == sigma*M*mask(x) —
        # one fused multiply-add, no extra lattice pass.
        t = t + sigma * w
    y = (t * s3).reshape(jnp.shape(x))
    if not apply_bc:
        return y
    return jnp.where(bc_marker, x, y)


def kron_diagonal(Ks, ms, bc_marker, sigma=0.0):
    """Closed-form operator diagonal (for Jacobi): bc rows get 1.
    ``sigma`` adds the lumped-mass shift (see `kron_laplacian_apply`)."""
    Kx, Ky, Kz = Ks
    mx, my, mz = ms
    dx, dy, dz = (jnp.diagonal(K) for K in (Kx, Ky, Kz))
    m3 = mx[:, None, None] * my[None, :, None] * mz[None, None, :]
    diag = (
        dx[:, None, None] * my[None, :, None] * mz[None, None, :]
        + mx[:, None, None] * dy[None, :, None] * mz[None, None, :]
        + mx[:, None, None] * my[None, :, None] * dz[None, None, :]
        + sigma * m3
    ).reshape(-1)
    return jnp.where(bc_marker, jnp.ones_like(diag), diag)


class KronLaplacian:
    """Drop-in operator bundle for axis-aligned `BoxMesh` (single device).

    Same contract as `MatFreeLaplacian` / `LatticeLaplacian`.
    """

    def __init__(self, mesh, P, kappa=2.0, dtype=jnp.float32,
                 precision="highest", sigma=0.0):
        """``sigma`` adds the GLL-lumped mass shift: the operator becomes
        ``A + sigma M`` (the reaction-diffusion / shifted-Poisson family
        ``-div(kappa grad u) + sigma u = f``; beyond reference parity)."""
        from ..fem.mesh import require_axis_aligned

        require_axis_aligned(mesh, "KronLaplacian")
        self.P = int(P)
        self.mesh = mesh
        self.dtype = dtype
        self.precision = precision
        self.sigma = float(sigma)
        self.ndofs = mesh.num_dofs(P)
        from ..fem.assembly import resolve_kappa_axes

        kax = resolve_kappa_axes(mesh, kappa)
        self.kappa_axes = kax
        Ks, ms = [], []
        for a, (nc_a, h_a, k_a) in enumerate(zip(mesh.nc, mesh.h_cells,
                                                 kax)):
            # kappa folded into the stiffness factors (one K per term;
            # a per-axis / diagonal-tensor kappa scales each term by its
            # own k_a — grid-aligned anisotropic diffusion). The Robin
            # end terms are kappa-free: scale=1/k_a pre-divides them so
            # the k_a multiply restores alpha exactly.
            K, m = axis_stiffness_mass(
                nc_a, self.P, h_a, robin=robin_axis_ends(mesh, a, 1.0 / k_a))
            Ks.append(jnp.asarray(k_a * K, dtype=dtype))
            ms.append(jnp.asarray(m, dtype=dtype))
        self.Ks = tuple(Ks)
        self.ms = tuple(ms)
        self.bc_marker = jnp.asarray(mesh.boundary_dof_marker(self.P))
        self._apply = jax.jit(partial(kron_laplacian_apply,
                                      precision=precision,
                                      sigma=self.sigma))
        self.diag = kron_diagonal(self.Ks, self.ms, self.bc_marker,
                                  sigma=self.sigma)
        self.diag_inv = 1.0 / self.diag

    def __call__(self, x):
        return self._apply(x, self.Ks, self.ms, self.bc_marker)

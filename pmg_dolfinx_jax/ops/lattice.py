"""Lattice-form matrix-free Laplacian: the structured-mesh fast path.

The dofmap-based operator (`ops/laplacian.py`) mirrors the reference's
unstructured gather -> per-cell kernel -> atomic scatter structure
(src/laplacian.hpp:143-278). This module is the structured-mesh
redesign that removes the indexed gathers and scatter-adds entirely:

The dof lattice ``u[(NX, NY, NZ)]`` maps to the *quadrature lattice*
``(Qx, Qy, Qz)`` with ``Q = nc*(P+1)`` (cell-discontinuous points) through
per-axis block-banded matrices:

- expansion ``E[(Q, N)]``: ``E[c*n + j, c*P + j] = 1`` — duplicates the
  cell-interface planes (the "gather" along one axis),
- derivative ``Dg[(Q, N)]``: ``Dg[c*n + q, c*P + i] = D1[q, i]`` — the 1D
  GLL derivative applied per cell (the sum-factorized contraction).

Then, writing ``o_a`` for applying a matrix along axis ``a``:

    ux = Dx o (Ey o (Ez o u)),  uy = Ex o (Dy o (Ez o u)),  uz = ...
    (tx, ty, tz) = coeff * G @ (ux, uy, uz)      per quadrature point
    y  = Ez^T o Ey^T o Dx^T o tx + ...           (E^T performs the
                                                  overlap-ADD: the former
                                                  atomicAdd scatter is now
                                                  a dense transposed matmul)

Every step is a dense (Q x N) matmul batched over the other two axes,
with no indexed memory ops. FLOP count is ~2x the classic
sum-factorization (the E-matmuls are mathematically copies).

Results are bit-identical in exact arithmetic to `laplacian_apply`
(tested to float tolerance in tests/test_lattice.py).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.geometry import quadrature_weights_3d, tabulate_geometry_dphi, geometry_factors
from ..fem.gll import derivative_matrix


def axis_matrices(nc: int, P: int, dtype=np.float64):
    """Global per-axis (E, Dg) matrices of shape ``(nc*(P+1), nc*P+1)``."""
    n = P + 1
    N = nc * P + 1
    Q = nc * n
    D1 = derivative_matrix(P)
    E = np.zeros((Q, N), dtype=dtype)
    Dg = np.zeros((Q, N), dtype=dtype)
    for c in range(nc):
        for q in range(n):
            E[c * n + q, c * P + q] = 1.0
            Dg[c * n + q, c * P: c * P + n] = D1[q]
    return E, Dg


def axis_interpolation_matrix(nc: int, P_coarse: int, P_fine: int, dtype=np.float64):
    """Global per-axis inter-degree interpolation ``(nc*Pf+1, nc*Pc+1)``.

    ``I1[f, c] = l_c^{coarse}(x_f^{fine})`` along one axis; the 3D
    transfer is its triple Kronecker action. Its plain transpose IS the
    reference's multiplicity-weighted per-cell restriction
    (src/interpolate.hpp:61-87) — the global-matrix form needs no
    multiplicity bookkeeping at all.
    """
    from ..fem.gll import interpolation_matrix_1d

    M1 = interpolation_matrix_1d(P_coarse, P_fine)
    Nf, Nc = nc * P_fine + 1, nc * P_coarse + 1
    I1 = np.zeros((Nf, Nc), dtype=dtype)
    for c in range(nc):
        # Overlapping interface rows receive identical values (C0 nodal).
        I1[c * P_fine: c * P_fine + P_fine + 1,
           c * P_coarse: c * P_coarse + P_coarse + 1] = M1
    return I1


def lattice_prolongate(x_c, I1s, shape_c, precision="highest"):
    """Coarse->fine transfer via three per-axis dense matmuls.

    Shape-preserving: lattice-shaped input -> lattice-shaped output,
    flat input -> flat output."""
    Ix, Iy, Iz = I1s
    t = x_c.reshape(shape_c)
    t = _along_x(Ix, t, precision)
    t = _along_y(Iy, t, precision)
    t = _along_z(Iz, t, precision)
    return t if x_c.ndim == 3 else t.reshape(-1)


def lattice_restrict(x_f, I1s, shape_f, precision="highest"):
    """Fine->coarse transfer: transposed per-axis matmuls (global I^T).

    Shape-preserving (see `lattice_prolongate`)."""
    Ix, Iy, Iz = I1s
    t = x_f.reshape(shape_f)
    t = _along_x(Ix.T, t, precision)
    t = _along_y(Iy.T, t, precision)
    t = _along_z(Iz.T, t, precision)
    return t if x_f.ndim == 3 else t.reshape(-1)


def expand_axis0(t, nc, P):
    """Dof axis -> quadrature axis along dim 0: ``out[c*n+i] = t[c*P+i]``.

    Pure reshape/concat data movement — replaces the E-matmul of the v1
    formulation (mathematically a copy) with zero FLOPs.
    """
    n = P + 1
    head = t[:-1].reshape((nc, P) + t.shape[1:])
    tail = t[P::P][:, None]
    return jnp.concatenate([head, tail], axis=1).reshape((nc * n,) + t.shape[1:])


def fold_axis0(s, nc, P):
    """Transpose of `expand_axis0`: overlap-ADD cell-block rows back to the
    dof axis (``out[c*P+i] += s[c*n+i]``) — the former atomicAdd scatter,
    as two static-slice adds."""
    n = P + 1
    s = s.reshape((nc, n) + s.shape[1:])
    core = s[:, :P].reshape((nc * P,) + s.shape[2:])
    zero = jnp.zeros((1,) + core.shape[1:], dtype=core.dtype)
    out = jnp.concatenate([core, zero], axis=0)  # rows 0 .. nc*P
    extra = s[:, P]  # contributions to rows (c+1)*P
    tail = out[1:].reshape((nc, P) + core.shape[1:])
    tail = tail.at[:, P - 1].add(extra)
    return jnp.concatenate([out[:1], tail.reshape((nc * P,) + core.shape[1:])], axis=0)


def _expand(t, axis, nc, P):
    if axis == 0:
        return expand_axis0(t, nc, P)
    t = jnp.moveaxis(t, axis, 0)
    return jnp.moveaxis(expand_axis0(t, nc, P), 0, axis)


def _fold(s, axis, nc, P):
    if axis == 0:
        return fold_axis0(s, nc, P)
    s = jnp.moveaxis(s, axis, 0)
    return jnp.moveaxis(fold_axis0(s, nc, P), 0, axis)


def lattice_laplacian_apply_v2(x, mats, G, bc_marker, nc, P,
                               precision="highest", apply_bc=True,
                               weights1d=None, coeff=None):
    """Copy-free-expansion variant of `lattice_laplacian_apply`.

    Only the six derivative contractions are matmuls (``Dg``/``Dg^T``);
    expansions and overlap-adds are reshape/concat memory ops. With
    ``weights1d + coeff`` given, G is interpreted in *affine* form
    ``G[(ncx, ncy, ncz, 6)]`` (constant per cell, exact for
    parallelepiped cells — every mesh the reference drivers build) and the
    quadrature weights are applied as a separable broadcast, cutting the
    geometry memory traffic by (P+1)^3.

    ``nc`` = (ncx, ncy, ncz), static.
    """
    prec = precision
    Dx, Dy, Dz = mats["Dx"], mats["Dy"], mats["Dz"]
    ncx, ncy, ncz = nc
    n = P + 1
    NX, NY, NZ = Dx.shape[1], Dy.shape[1], Dz.shape[1]

    xb = jnp.where(bc_marker, jnp.zeros_like(x), x).reshape(NX, NY, NZ)

    t_z = _expand(xb, 2, ncz, P)                       # (NX, NY, Qz)
    t_zy = _expand(t_z, 1, ncy, P)                     # (NX, Qy, Qz)
    ux = jnp.einsum("ax,xyz->ayz", Dx, t_zy, precision=prec)
    uy = _expand(jnp.einsum("by,xyz->xbz", Dy, t_z, precision=prec), 0, ncx, P)
    uz = _expand(
        _expand(jnp.einsum("cz,xyz->xyc", Dz, xb, precision=prec), 1, ncy, P),
        0, ncx, P,
    )

    if weights1d is not None:
        wx, wy, wz = weights1d  # (P+1,) GLL weights per axis
        blk = (ncx, n, ncy, n, ncz, n)
        g = G.reshape(ncx, 1, ncy, 1, ncz, 1, 6)
        w = (
            wx.reshape(1, n, 1, 1, 1, 1)
            * wy.reshape(1, 1, 1, n, 1, 1)
            * wz.reshape(1, 1, 1, 1, 1, n)
        )
        c = coeff.reshape(ncx, 1, ncy, 1, ncz, 1) if coeff is not None else 1.0
        s = w * c
        uxb, uyb, uzb = (v.reshape(blk) for v in (ux, uy, uz))
        tx = (s * (g[..., 0] * uxb + g[..., 1] * uyb + g[..., 2] * uzb)).reshape(ux.shape)
        ty = (s * (g[..., 1] * uxb + g[..., 3] * uyb + g[..., 4] * uzb)).reshape(ux.shape)
        tz = (s * (g[..., 2] * uxb + g[..., 4] * uyb + g[..., 5] * uzb)).reshape(ux.shape)
    else:
        tx = G[..., 0] * ux + G[..., 1] * uy + G[..., 2] * uz
        ty = G[..., 1] * ux + G[..., 3] * uy + G[..., 4] * uz
        tz = G[..., 2] * ux + G[..., 4] * uy + G[..., 5] * uz

    bx = jnp.einsum("ax,ayz->xyz", Dx, tx, precision=prec)   # (NX, Qy, Qz)
    by = _fold(ty, 0, ncx, P)
    bz = _fold(tz, 0, ncx, P)
    cxy = _fold(bx, 1, ncy, P) + jnp.einsum("by,xbz->xyz", Dy, by, precision=prec)
    cz = _fold(bz, 1, ncy, P)
    y = _fold(cxy, 2, ncz, P) + jnp.einsum("cz,xyc->xyz", Dz, cz, precision=prec)

    y = y.reshape(-1)
    if not apply_bc:
        return y
    return jnp.where(bc_marker, x, y)


def _along_x(M, t, prec):
    return jnp.einsum("ax,xyz->ayz", M, t, precision=prec)


def _along_y(M, t, prec):
    return jnp.einsum("by,xyz->xbz", M, t, precision=prec)


def _along_z(M, t, prec):
    return jnp.einsum("cz,xyz->xyc", M, t, precision=prec)


def lattice_laplacian_apply(x, mats, G, bc_marker, precision="highest",
                            apply_bc=True):
    """``y = A x`` on the flat dof vector via the lattice formulation.

    Parameters
    ----------
    x : ``(NX*NY*NZ,)`` flat or ``(NX, NY, NZ)`` lattice-shaped dof
        vector; the output matches (shape-preserving, like the kron
        apply — the multi-axis grid decomposition carries 3D vectors).
    mats : dict with per-axis matrices ``Ex, Dx, Ey, Dy, Ez, Dz``
        (shapes ``(Q_a, N_a)``) — from `LatticeLaplacian` setup.
    G : (Qx, Qy, Qz, 6) weighted geometry factors on the quadrature
        lattice, with the DG-0 coefficient folded in.
    bc_marker : (NX*NY*NZ,) bool.
    precision : XLA dot precision. 'highest' (default) gives true-f32
        matmuls; 'high'/'default' run in TF32 on tensor-core GPUs
        (~1e-3 relative error) — usable for preconditioner applies, not
        for residual evaluation.

    Same semantics as `laplacian_apply` (bc zero on input, identity rows).
    """
    prec = precision
    Ex, Dx = mats["Ex"], mats["Dx"]
    Ey, Dy = mats["Ey"], mats["Dy"]
    Ez, Dz = mats["Ez"], mats["Dz"]
    NX, NY, NZ = Ex.shape[1], Ey.shape[1], Ez.shape[1]

    xb = jnp.where(bc_marker, jnp.zeros_like(x), x).reshape(NX, NY, NZ)

    # Forward: values of grad(u) on the quadrature lattice.
    t_z = _along_z(Ez, xb, prec)                 # (NX, NY, Qz)
    s_zy = _along_y(Ey, t_z, prec)               # (NX, Qy, Qz)
    ux = _along_x(Dx, s_zy, prec)
    uy = _along_x(Ex, _along_y(Dy, t_z, prec), prec)
    uz = _along_x(Ex, _along_y(Ey, _along_z(Dz, xb, prec), prec), prec)

    tx = G[..., 0] * ux + G[..., 1] * uy + G[..., 2] * uz
    ty = G[..., 1] * ux + G[..., 3] * uy + G[..., 4] * uz
    tz = G[..., 2] * ux + G[..., 4] * uy + G[..., 5] * uz

    # Backward: transposed contractions; E^T sums interface contributions.
    bx = _along_x(Dx.T, tx, prec)               # (NX, Qy, Qz)
    by = _along_x(Ex.T, ty, prec)
    bz = _along_x(Ex.T, tz, prec)
    cxy = _along_y(Ey.T, bx, prec) + _along_y(Dy.T, by, prec)  # (NX, NY, Qz)
    cz = _along_y(Ey.T, bz, prec)
    y = _along_z(Ez.T, cxy, prec) + _along_z(Dz.T, cz, prec)   # (NX, NY, NZ)

    y = y.reshape(jnp.shape(x))
    if not apply_bc:
        # Raw accumulation (bc zeroed on input only) — the distributed
        # layer exchanges interface-plane partials before the epilogue.
        return y
    return jnp.where(bc_marker, x, y)


def geometry_to_qlattice(G_cells, nc, P):
    """Reorder per-cell G ``(ncells, (P+1)^3, 6)`` to the quadrature
    lattice layout ``(Qx, Qy, Qz, 6)``."""
    n = P + 1
    nx, ny, nz = nc
    G = np.asarray(G_cells).reshape(nx, ny, nz, n, n, n, 6)
    G = np.transpose(G, (0, 3, 1, 4, 2, 5, 6))
    return np.ascontiguousarray(G.reshape(nx * n, ny * n, nz * n, 6))


class LatticeLaplacian:
    """Drop-in fast-path operator for `BoxMesh` (single device).

    Same public contract as `MatFreeLaplacian` (apply + diag), different
    internals (no indexed gathers); the dofmap operator remains the
    general / oracle path.
    """

    def __init__(self, mesh, P, kappa=2.0, dtype=jnp.float32, precision="highest"):
        """``kappa`` may be a scalar, a per-cell DG-0 array, or a callable
        over points (sampled at cell centroids) — same contract as
        `PMGHierarchy` (`fem.assembly.resolve_kappa`)."""
        from ..fem.assembly import resolve_kappa_split, scale_G

        self.P = int(P)
        self.mesh = mesh
        self.dtype = dtype
        self.precision = precision
        nx, ny, nz = mesh.nc
        self.ndofs = mesh.num_dofs(P)
        mats = {}
        for name, nc_a in (("x", nx), ("y", ny), ("z", nz)):
            E, Dg = axis_matrices(nc_a, self.P)
            mats["E" + name] = jnp.asarray(E, dtype=dtype)
            mats["D" + name] = jnp.asarray(Dg, dtype=dtype)
        self.mats = mats

        # Geometry factors (float64 on host for accuracy, cast after).
        # Tensor (anisotropic) kappa folds into G here; scalar DG-0
        # kappa scales after — either way downstream is kappa-free.
        kc, kt, _ = resolve_kappa_split(mesh, kappa)
        G_cells, _ = geometry_factors(
            mesh.geometry_x,
            mesh.geometry_dofmap,
            tabulate_geometry_dphi(self.P),
            quadrature_weights_3d(self.P),
            xp=np,
            kappa=kt,
        )
        Gq = geometry_to_qlattice(scale_G(G_cells, kc, kt), mesh.nc, self.P)
        self.G = jnp.asarray(Gq, dtype=dtype)
        self.bc_marker = jnp.asarray(mesh.boundary_dof_marker(self.P))
        self._apply = jax.jit(
            partial(lattice_laplacian_apply, precision=precision)
        )

        # Diagonal via the (setup-time) dofmap path for exactness.
        from .laplacian import laplacian_diagonal

        diag = jax.jit(laplacian_diagonal, static_argnums=(5,))(
            jnp.asarray(mesh.dofmap(self.P)),
            jnp.asarray(G_cells, dtype=dtype),
            jnp.asarray(kc, dtype=dtype),
            jnp.asarray(derivative_matrix(self.P), dtype=dtype),
            self.bc_marker,
            self.ndofs,
        )
        self.diag = jnp.asarray(diag, dtype=dtype)
        self.diag_inv = 1.0 / self.diag

    def __call__(self, x):
        return self._apply(x, self.mats, self.G, self.bc_marker)

"""Per-quadrature-point geometry factors for the weighted Laplacian.

Equivalent of the reference geometry pipeline:
- device kernel `geometry_computation` (src/laplacian.hpp:22-113),
- host golden model `compute_scaled_geometrical_factor`
  (src/precompute.hpp:109-251).

For each cell and quadrature point q, with trilinear coordinate map x(X):

    J   = dx/dX                      (3x3 Jacobian)
    K   = adj(J) = detJ * J^{-1}
    G_q = (w_q / detJ) * K @ K.T     (symmetric; 6 unique entries stored)

so that the stiffness action is  y_c = D^T [ coeff * G ( D u_c ) ]  with D
the 1D GLL derivative matrix applied along each axis (sum factorization).

Entry order matches the reference layout (src/laplacian.hpp:99-111):
``[G00, G10, G20, G11, G21, G22]``.

Note: the reference device kernel's scalar `detJ` expansion
(laplacian.hpp:97) mixes row/column cofactor expansions and is only correct
for meshes where the off-diagonal terms cancel (e.g. the axis-aligned boxes
it is ever run on); this implementation uses the standard cofactor
expansion, correct for general hexes.

This is plain batched jnp — XLA fuses it well; no hand kernel needed
(SURVEY.md §7). Runs once at setup (or per batch in the geometry-batched
operator variant mirroring `batch_size` at laplacian.hpp:383-395).
"""

from functools import partial

import jax.numpy as jnp
import numpy as np

from .gll import gauss_lobatto, lagrange_tabulate


def tabulate_geometry_dphi(P: int) -> np.ndarray:
    """Trilinear (Q1) basis derivative table at the degree-P GLL points.

    Returns ``dphi[(3, nq, 8)]`` with ``nq = (P+1)**3``; axis 0 is the
    reference-coordinate derivative direction. Equivalent of the coordinate
    element tabulation uploaded at reference examples/pmg/main.cpp:222-232.
    Corner ordering matches BoxMesh.geometry_dofmap: ``(a*2 + b)*2 + c``.
    """
    q1, _ = gauss_lobatto(P + 1)
    tab = lagrange_tabulate(np.array([0.0, 1.0]), q1, nderiv=1)
    phi, dphi = tab[0], tab[1]  # (nq1, 2)
    nq1 = q1.shape[0]
    out = np.empty((3, nq1, nq1, nq1, 8))
    for a in range(2):
        for b in range(2):
            for c in range(2):
                loc = (a * 2 + b) * 2 + c
                out[0, ..., loc] = np.einsum("i,j,k->ijk", dphi[:, a], phi[:, b], phi[:, c])
                out[1, ..., loc] = np.einsum("i,j,k->ijk", phi[:, a], dphi[:, b], phi[:, c])
                out[2, ..., loc] = np.einsum("i,j,k->ijk", phi[:, a], phi[:, b], dphi[:, c])
    return out.reshape(3, nq1**3, 8)


def quadrature_weights_3d(P: int) -> np.ndarray:
    """Tensor-product GLL weights ``w[(P+1)**3]``, q index ``(i*n + j)*n + k``."""
    _, w = gauss_lobatto(P + 1)
    return np.einsum("i,j,k->ijk", w, w, w).reshape(-1)


def geometry_factors(xgeom, geometry_dofmap, dphi_geom, weights, xp=jnp,
                     kappa=None):
    """Compute ``G[(ncells, nq, 6)]`` and ``detJ[(ncells, nq)]``.

    Parameters mirror the reference kernel arguments
    (src/laplacian.hpp:22-26): corner coordinates, cell->corner map, Q1
    derivative table ``(3, nq, 8)``, and 3D quadrature weights ``(nq,)``.

    ``kappa`` (optional) folds the diffusion coefficient into G:
    an ``(ncells,)`` DG-0 scalar field scales the 6 entries
    (``G = w kappa/detJ K K^T``, identical to post-multiplying the
    kappa-free factors), while an ``(ncells, 3, 3)`` per-cell SYMMETRIC
    tensor produces ``G = w/detJ K kappa K^T`` — full anisotropic
    diffusion ``-div(kappa grad u)``, which cannot be recovered from the
    kappa-free 6-entry G and is beyond the reference's scalar-DG-0
    coefficient (src/laplacian.hpp:220-241). Every downstream consumer
    (lattice / blocked / dofmap applies, diagonals, oracle assembly) is
    unchanged: the 6-entry symmetric layout is the same.

    ``xp`` selects the backend: ``jnp`` (default, jittable) or ``np`` for
    the float64 golden model used by the assembly oracle regardless of the
    JAX x64 setting.
    """
    # Exact f32 contractions on the device path (no TF32).
    ein = np.einsum if xp is np else partial(xp.einsum, precision="highest")
    coords = xgeom[geometry_dofmap]  # (ncells, 8, 3)
    # J[c, q, a, b] = sum_k coords[c, k, a] * dphi_geom[b, q, k]
    J = ein("cka,bqk->cqab", coords, dphi_geom)
    K = _adjugate_3x3(J, xp)
    detJ = (
        J[..., 0, 0] * K[..., 0, 0]
        + J[..., 1, 0] * K[..., 0, 1]
        + J[..., 2, 0] * K[..., 0, 2]
    )
    if kappa is not None and xp.ndim(kappa) == 3:
        KKt = ein("xqam,xmn,xqbn->xqab", K, kappa, K)
        kappa = None  # folded; skip the scalar path below
    else:
        KKt = ein("xqam,xqbm->xqab", K, K)
    scale = weights[None, :] / detJ
    G = xp.stack(
        [
            KKt[..., 0, 0],
            KKt[..., 1, 0],
            KKt[..., 2, 0],
            KKt[..., 1, 1],
            KKt[..., 2, 1],
            KKt[..., 2, 2],
        ],
        axis=-1,
    ) * scale[..., None]
    if kappa is not None:
        # Post-multiply exactly like the historical consumer-side
        # ``G * kc[:, None, None]`` (bit-identical trajectories).
        G = G * xp.asarray(kappa)[:, None, None]
    return G, detJ


def _adjugate_3x3(J, xp=jnp):
    """Adjugate of a batched 3x3 matrix: ``adj(J) = detJ * J^{-1}``."""
    a, b, c = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
    d, e, f = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
    g, h, i = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
    row0 = xp.stack([e * i - f * h, -(b * i - c * h), b * f - c * e], axis=-1)
    row1 = xp.stack([-(d * i - f * g), a * i - c * g, -(a * f - c * d)], axis=-1)
    row2 = xp.stack([d * h - e * g, -(a * h - b * g), a * e - b * d], axis=-1)
    return xp.stack([row0, row1, row2], axis=-2)

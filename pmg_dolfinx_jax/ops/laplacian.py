"""Matrix-free sum-factorized Laplacian: ``y = A x`` without a matrix.

Redesign of the reference hot kernel `stiffness_operator`
(src/laplacian.hpp:143-278) and its host wrapper `MatFreeLaplacian`
(src/laplacian.hpp:283-526). The GPU kernel's structure (one thread block
per cell, shared-memory 1D contractions, atomicAdd scatter) is replaced by
batched XLA ops over all cells at once:

    gather  : u_cells = x[dofmap]  (bc dofs zeroed)       [laplacian.hpp:182-189]
    forward : du_d = D contracted along axis d            [laplacian.hpp:195-218]
              (GLL collocation: the 1D value table is the identity, so only
              the derivative contraction is needed — same trick as the
              reference, comment at laplacian.hpp:200-202)
    scale   : fw = coeff * G @ du  (6-entry symmetric G)  [laplacian.hpp:220-241]
    back    : y_cells = D^T contracted along each axis    [laplacian.hpp:245-267]
    scatter : y.at[dofmap].add(y_cells); y[bc] = x[bc]    [laplacian.hpp:272-277]

The scatter-add replaces atomicAdd race-free (pure functional scatter).
Each contraction is a small-K matmul batched over cells, in true f32 at
the working precision (no TF32). The Kronecker-form, lattice-form and
unstructured-DSS variants live in `kron.py`, `lattice.py` and
`unstructured.py`.

Degree P is a trace-time constant (shapes depend on it): one jitted program
per level, mirroring the reference's compile-time template dispatch
(laplacian.hpp:468-479) but without its P<=5 limit.
"""


import jax
import jax.numpy as jnp
import numpy as np

from ..fem.geometry import (
    geometry_factors,
    quadrature_weights_3d,
    tabulate_geometry_dphi,
)
from ..fem.gll import derivative_matrix


def laplacian_apply_cells(u_cells, G, coeff, D):
    """Cell-local stiffness action (no gather/scatter).

    Parameters
    ----------
    u_cells : (ncells, n, n, n) — cell-local dof values (n = P+1)
    G       : (ncells, n^3, 6) — weighted geometry factors
    coeff   : (ncells,) — DG-0 coefficient kappa per cell
    D       : (n, n) — 1D GLL derivative matrix D[q, i] = l_i'(x_q)

    Returns ``y_cells[(ncells, n, n, n)]``.
    """
    n = D.shape[0]
    g = G.reshape(G.shape[0], n, n, n, 6)
    # Forward contractions: values of grad(u) at the collocated points.
    ux = jnp.einsum("qi,cijk->cqjk", D, u_cells, precision="highest")
    uy = jnp.einsum("qj,cijk->ciqk", D, u_cells, precision="highest")
    uz = jnp.einsum("qk,cijk->cijq", D, u_cells, precision="highest")
    c = coeff[:, None, None, None]
    fw0 = c * (g[..., 0] * ux + g[..., 1] * uy + g[..., 2] * uz)
    fw1 = c * (g[..., 1] * ux + g[..., 3] * uy + g[..., 4] * uz)
    fw2 = c * (g[..., 2] * ux + g[..., 4] * uy + g[..., 5] * uz)
    # Transposed contractions back to dof space.
    return (
        jnp.einsum("qi,cqjk->cijk", D, fw0, precision="highest")
        + jnp.einsum("qj,ciqk->cijk", D, fw1, precision="highest")
        + jnp.einsum("qk,cijq->cijk", D, fw2, precision="highest")
    )


def laplacian_scatter_raw(x, dofmap, G, coeff, D, bc_marker):
    """Gather -> cell apply -> scatter-add, WITHOUT the bc row epilogue.

    Returns the raw accumulated ``y`` (bc dofs zeroed on gather only).
    Shared-dof entries hold *partial* sums when the dofmap covers only a
    subdomain — the distributed layer exchanges those partials across
    shard boundaries before applying the epilogue (the analogue of the
    reference's reverse scatter, src/vector.hpp:249-294).
    """
    n = D.shape[0]
    ncells = dofmap.shape[0]
    xb = jnp.where(bc_marker, jnp.zeros_like(x), x)
    u_cells = xb[dofmap.reshape(-1)].reshape(ncells, n, n, n)
    y_cells = laplacian_apply_cells(u_cells, G, coeff, D)
    return jnp.zeros_like(x).at[dofmap.reshape(-1)].add(
        y_cells.reshape(-1), mode="drop"
    )


def laplacian_apply(x, dofmap, G, coeff, D, bc_marker):
    """Full matrix-free apply ``y = A x`` on a flat dof vector (jittable).

    Semantics match the reference kernel exactly: bc dofs are zeroed on
    gather, interior rows accumulate cell contributions, and bc rows return
    ``y[bc] = x[bc]`` (identity), reference src/laplacian.hpp:182-189 and
    272-277 — expressed race-free as a where-epilogue.
    """
    y = laplacian_scatter_raw(x, dofmap, G, coeff, D, bc_marker)
    return jnp.where(bc_marker, x, y)


def laplacian_diagonal_raw(dofmap, G, coeff, D, ndofs):
    """Scatter-added diagonal WITHOUT the bc override (see
    `laplacian_diagonal`); shard-partial in the distributed setting."""
    n = D.shape[0]
    ncells = dofmap.shape[0]
    g = G.reshape(ncells, n, n, n, 6)
    D2 = D * D
    d = jnp.diagonal(D)
    diag = (
        jnp.einsum("mi,cmjk->cijk", D2, g[..., 0], precision="highest")
        + jnp.einsum("mj,cimk->cijk", D2, g[..., 3], precision="highest")
        + jnp.einsum("mk,cijm->cijk", D2, g[..., 5], precision="highest")
        + 2.0
        * (
            d[:, None, None] * d[None, :, None] * g[..., 1]
            + d[:, None, None] * d[None, None, :] * g[..., 2]
            + d[None, :, None] * d[None, None, :] * g[..., 4]
        )
    )
    diag = diag * coeff[:, None, None, None]
    return jnp.zeros(ndofs, dtype=diag.dtype).at[dofmap.reshape(-1)].add(
        diag.reshape(-1), mode="drop"
    )


def laplacian_diagonal(dofmap, G, coeff, D, bc_marker, ndofs):
    """Matrix-free diagonal of A (for the Jacobi preconditioner).

    The reference obtains the diagonal by assembling a throwaway CSR matrix
    (examples/pmg/main.cpp:274-279, flagged "FIXME: do this better"); here
    it is computed directly from the sum-factorized form. For local dof
    a=(i,j,k) the element diagonal is

        sum_m D[m,i]^2 G00[m,j,k] + D[m,j]^2 G11[i,m,k] + D[m,k]^2 G22[i,j,m]
        + 2 ( D[i,i] D[j,j] G01[i,j,k] + D[i,i] D[k,k] G02[i,j,k]
            + D[j,j] D[k,k] G12[i,j,k] )

    scatter-added over cells; bc rows get 1 (identity rows).
    """
    out = laplacian_diagonal_raw(dofmap, G, coeff, D, ndofs)
    return jnp.where(bc_marker, jnp.ones_like(out), out)


def laplacian_apply_batched(x, dofmap, xgeom, geometry_dofmap, dphi_geom,
                            weights, coeff, D, bc_marker, batch_size):
    """Apply with per-batch geometry recomputation (memory saver).

    The reference's ``batch_size`` mode (src/laplacian.hpp:324-348,
    383-395): instead of storing ``G[(ncells, nq, 6)]`` for all cells,
    recompute it for one batch of cells at a time inside the apply —
    trading FLOPs (cheap, fully fused by XLA) for device-memory footprint
    (the dominant memory consumer at high degree). Implemented as a
    `lax.scan` over cell batches accumulating into y. ``batch_size``
    must divide ncells.
    """
    n = D.shape[0]
    ncells = dofmap.shape[0]
    assert ncells % batch_size == 0
    nbatch = ncells // batch_size
    xb = jnp.where(bc_marker, jnp.zeros_like(x), x)
    dm = dofmap.reshape(nbatch, batch_size, n**3)
    gdm = geometry_dofmap.reshape(nbatch, batch_size, 8)
    cf = coeff.reshape(nbatch, batch_size)

    def one_batch(y, args):
        dm_b, gdm_b, cf_b = args
        G_b, _ = geometry_factors(xgeom, gdm_b, dphi_geom, weights)
        u_cells = xb[dm_b.reshape(-1)].reshape(batch_size, n, n, n)
        y_cells = laplacian_apply_cells(u_cells, G_b, cf_b, D)
        y = y.at[dm_b.reshape(-1)].add(y_cells.reshape(-1), mode="drop")
        return y, None

    y, _ = jax.lax.scan(one_batch, jnp.zeros_like(x), (dm, gdm, cf))
    return jnp.where(bc_marker, x, y)


class MatFreeLaplacian:
    """Host-side operator bundle (setup + jitted apply), single device.

    Counterpart of `acc::MatFreeLaplacian` (src/laplacian.hpp:283-526):
    owns the per-level constants (dofmap, G, 1D derivative table, bc
    marker, inverse diagonal) and exposes ``op(x) -> y``. ``batch_size``
    mirrors the reference's geometry-batching knob: 0 precomputes G for
    all cells (laplacian.hpp:324-348); > 0 recomputes G per batch of
    cells inside every apply, shrinking device memory by
    ``~6 (P+1)^3 ncells`` floats at the cost of recompute FLOPs.
    """

    def __init__(self, mesh, P, kappa=1.0, dtype=jnp.float64, batch_size=0):
        self.P = int(P)
        self.mesh = mesh
        self.dtype = dtype
        self.batch_size = int(batch_size)
        n = self.P + 1
        self.xgeom = jnp.asarray(mesh.geometry_x, dtype=dtype)
        self.geometry_dofmap = jnp.asarray(mesh.geometry_dofmap)
        self.dphi_geom = jnp.asarray(tabulate_geometry_dphi(self.P), dtype=dtype)
        self.weights = jnp.asarray(quadrature_weights_3d(self.P), dtype=dtype)
        self.dofmap = jnp.asarray(mesh.dofmap(self.P))
        from ..fem.assembly import resolve_kappa_split

        kc, kt, _ = resolve_kappa_split(mesh, kappa)
        if kt is not None:  # anisotropic tensor: fold into G, coeff = 1
            if self.batch_size:
                raise ValueError(
                    "tensor kappa + geometry batching not supported "
                    "(fold happens in the precomputed G); use batch_size=0"
                )
            kt = jnp.asarray(kt, dtype=dtype)
        self.coeff = jnp.asarray(kc, dtype=dtype)
        self.D = jnp.asarray(derivative_matrix(self.P), dtype=dtype)
        self.bc_marker = jnp.asarray(mesh.boundary_dof_marker(self.P))
        self.ndofs = mesh.num_dofs(self.P)
        if self.batch_size and mesh.ncells % self.batch_size != 0:
            raise ValueError("batch_size must divide ncells")

        # G precomputed for diagonal extraction (and for the unbatched
        # apply). In batched mode it is dropped after the diagonal.
        G, _ = jax.jit(geometry_factors)(
            self.xgeom, self.geometry_dofmap, self.dphi_geom, self.weights,
            kappa=kt,
        )
        # NOTE: operator data is passed as jit *arguments*, never closed
        # over — closed-over arrays become HLO constants and trigger
        # pathological compile-time constant folding.
        self.diag = jax.jit(laplacian_diagonal, static_argnums=(5,))(
            self.dofmap, G, self.coeff, self.D, self.bc_marker, self.ndofs
        )
        self.diag_inv = 1.0 / self.diag
        if self.batch_size:
            self.G = None
            self._apply = jax.jit(laplacian_apply_batched, static_argnames=("batch_size",))
        else:
            self.G = G
            self._apply = jax.jit(laplacian_apply)

    def __call__(self, x):
        if self.batch_size:
            return self._apply(
                x, self.dofmap, self.xgeom, self.geometry_dofmap,
                self.dphi_geom, self.weights, self.coeff, self.D,
                self.bc_marker, batch_size=self.batch_size,
            )
        return self._apply(x, self.dofmap, self.G, self.coeff, self.D, self.bc_marker)

    def as_pure(self):
        """Return ``(apply_fn, params)`` with apply_fn(params, x) pure —
        the form solvers and shard_map consume."""
        params = dict(
            dofmap=self.dofmap,
            G=self.G,
            coeff=self.coeff,
            D=self.D,
            bc_marker=self.bc_marker,
        )

        def apply_fn(p, x):
            return laplacian_apply(
                x, p["dofmap"], p["G"], p["coeff"], p["D"], p["bc_marker"]
            )

        return apply_fn, params

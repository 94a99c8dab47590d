"""Matrix-free inter-degree (p-level) transfer: prolongation/restriction.

Redesign of the reference `Interpolator` (src/interpolate.hpp).
The reference compresses the dense basix element interpolation matrix to a
per-cell CSR and walks it with one GPU thread per cell
(interpolate.hpp:118-170, kernels at :22-87). On nodal tensor-product
elements that matrix is exactly a triple Kronecker product of the 1D
interpolation matrix ``M1[f, c] = l_c^{coarse}(x_f^{fine})``, so here the
transfer is applied sum-factorized — three small dense contractions per
axis, dense matmuls, no sparse indexing at all.

Semantics match the reference exactly:

- prolongation (coarse->fine, interpolate_Q1Q2 at :22-45): per cell
  ``v_f[dofmap_f] = (M (x) M (x) M) v_c[dofmap_c]`` — a direct write; cells
  sharing a dof write identical values, so the overlapping scatter is safe.
- restriction (fine->coarse, interpolate_Q2Q1 at :61-87): per cell
  ``v_c[dofmap_c] += (M^T)^(x)3 (v_f[dofmap_f] / mult_f)`` with ``mult_f``
  the number of cells sharing each fine dof (:172-178) — the
  multiplicity-weighted transpose validated against PETSc's interpolation
  matrix in python_tests/interpolation_matrix.py:49-78.
"""

import jax
import jax.numpy as jnp

from ..fem.gll import interpolation_matrix_1d


def prolongate(x_coarse, dofmap_c, dofmap_f, M1, ndofs_f):
    """Coarse->fine interpolation on flat dof vectors (jittable)."""
    nc = M1.shape[1]
    ncells = dofmap_c.shape[0]
    u = x_coarse[dofmap_c.reshape(-1)].reshape(ncells, nc, nc, nc)
    v = jnp.einsum("ai,bj,ck,xijk->xabc", M1, M1, M1, u,
                   precision="highest")
    out = jnp.zeros(ndofs_f, dtype=x_coarse.dtype)
    # Duplicate indices carry identical values; last-write-wins is exact.
    return out.at[dofmap_f.reshape(-1)].set(v.reshape(-1), mode="drop")


def restrict(x_fine, dofmap_c, dofmap_f, M1, mult_f, ndofs_c):
    """Fine->coarse multiplicity-weighted transpose transfer (jittable)."""
    nf = M1.shape[0]
    ncells = dofmap_c.shape[0]
    xw = x_fine / mult_f
    u = xw[dofmap_f.reshape(-1)].reshape(ncells, nf, nf, nf)
    v = jnp.einsum("ai,bj,ck,xabc->xijk", M1, M1, M1, u,
                   precision="highest")
    out = jnp.zeros(ndofs_c, dtype=x_fine.dtype)
    return out.at[dofmap_c.reshape(-1)].add(v.reshape(-1), mode="drop")


class PInterpolator:
    """Transfer bundle between a degree-``P_coarse`` and ``P_fine`` space.

    Counterpart of `Interpolator` (src/interpolate.hpp:94-329) on one
    device; holds the 1D matrix, both dofmaps and the fine-dof
    multiplicity, and exposes jitted ``prolong``/``restrict``.
    """

    def __init__(self, mesh, P_coarse, P_fine, dtype=jnp.float64):
        self.P_coarse, self.P_fine = int(P_coarse), int(P_fine)
        self.M1 = jnp.asarray(
            interpolation_matrix_1d(self.P_coarse, self.P_fine), dtype=dtype
        )
        self.dofmap_c = jnp.asarray(mesh.dofmap(self.P_coarse))
        self.dofmap_f = jnp.asarray(mesh.dofmap(self.P_fine))
        self.mult_f = jnp.asarray(mesh.dof_multiplicity(self.P_fine), dtype=dtype)
        self.ndofs_c = mesh.num_dofs(self.P_coarse)
        self.ndofs_f = mesh.num_dofs(self.P_fine)
        # Arrays passed as jit arguments (not closures) to avoid
        # compile-time constant folding of the large dofmaps.
        self._prolong = jax.jit(prolongate, static_argnums=(4,))
        self._restrict = jax.jit(restrict, static_argnums=(5,))

    def prolong(self, xc):
        return self._prolong(xc, self.dofmap_c, self.dofmap_f, self.M1, self.ndofs_f)

    def restrict(self, xf):
        return self._restrict(
            xf, self.dofmap_c, self.dofmap_f, self.M1, self.mult_f, self.ndofs_c
        )

"""Assembled sparse device operator (the reference's CSR path).

Counterpart of `acc::MatrixOperator` (src/csr.hpp:59-296) and
the PETSc-wrapped `PETScOperator` (src/operators.hpp): an explicitly
assembled sparse matrix living on device, applied with sparse matvecs.
The reference uses it (a) as the correctness oracle for the matrix-free
kernels (`mat_free --mat_comp`), (b) as an alternative `FineOperator` for
the whole PMG solve (examples/pmg/main.cpp:40-43, templated), (c) to
extract the Jacobi diagonal, and (d) as the assembled global interpolation
matrix between two spaces (csr.hpp:133-203).

Here assembly happens on host (scipy, float64 — fem/assembly.py is the
golden model) and the matrix ships to device as a JAX BCOO; `spmv` and
`spmv_t` are jittable `bcoo_dot_general` calls. The two-space constructor
builds the global interpolation matrix as the sparse Kronecker product of
the banded per-axis 1D interpolation matrices — closed form, no cell
loop.

The matrix-free backends (kron/lattice/dss) are the production paths.
This operator exists for parity, oracles, and small coarse problems.
"""

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax.experimental import sparse as jsparse

from ..fem.assembly import assemble_stiffness
from .lattice import axis_interpolation_matrix


class MatrixOperator:
    """Assembled stiffness operator on device (BCOO).

    Same call contract as the matrix-free operators: ``op(x) -> A x`` with
    Dirichlet rows/columns eliminated and unit diagonal (bc semantics
    identical to the matrix-free kernels, so results agree to rounding).
    """

    def __init__(self, mesh, P, kappa=1.0, dtype=jnp.float64,
                 shift_diag=None):
        """``shift_diag`` (optional, host array of length ndofs) is added
        to the assembled matrix diagonal — the pointwise GLL-lumped shift
        ``sigma * m3`` (+ baked Robin boundary mass) the matrix-free
        backends apply at runtime; baking it here keeps the CSR operator
        exactly equal to the shifted matrix-free apply."""
        self.P = int(P)
        self.mesh = mesh
        A = assemble_stiffness(mesh, self.P, kappa=kappa, bc=True).tocsr()
        if shift_diag is not None:
            A = (A + sp.diags(np.asarray(shift_diag,
                                         dtype=np.float64))).tocsr()
        A = A.tocoo()
        self.shape = A.shape
        self._A = jsparse.BCOO(
            (
                jnp.asarray(A.data, dtype=dtype),
                jnp.asarray(np.stack([A.row, A.col], axis=1)),
            ),
            shape=A.shape,
        )
        diag = jnp.asarray(A.tocsr().diagonal(), dtype=dtype)
        self.diag = diag
        self.diag_inv = 1.0 / diag
        self._spmv = jax.jit(lambda M, x: M @ x)

    def __call__(self, x):
        return self._spmv(self._A, x)

    def transpose_apply(self, x):
        return self._spmv(self._A.T, x)


class InterpolationMatrixOperator:
    """Assembled global inter-degree interpolation matrix (BCOO).

    Counterpart of the two-space `MatrixOperator` constructor
    (src/csr.hpp:133-203, built from `fem::interpolation_matrix`) used by
    the reference's CSR-path PMG for transfers. ``apply`` prolongates
    (coarse->fine), ``transpose_apply`` restricts (fine->coarse, the
    `multTranspose` of python_tests/pmg.py:243).
    """

    def __init__(self, mesh, P_coarse, P_fine, dtype=jnp.float64):
        Is = [
            sp.csr_matrix(axis_interpolation_matrix(nc_a, P_coarse, P_fine))
            for nc_a in mesh.nc
        ]
        I = sp.kron(sp.kron(Is[0], Is[1]), Is[2]).tocoo()
        self.shape = I.shape
        self._I = jsparse.BCOO(
            (
                jnp.asarray(I.data, dtype=dtype),
                jnp.asarray(np.stack([I.row, I.col], axis=1)),
            ),
            shape=I.shape,
        )
        self._spmv = jax.jit(lambda M, x: M @ x)

    def apply(self, x_coarse):
        return self._spmv(self._I, x_coarse)

    def transpose_apply(self, x_fine):
        return self._spmv(self._I.T, x_fine)

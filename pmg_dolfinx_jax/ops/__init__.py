"""Matrix-free operators: sum-factorized Laplacian, p-transfer, CSR.

JAX equivalents of the reference device kernels (SURVEY.md §2.1):
src/laplacian.hpp (stiffness_operator + geometry), src/interpolate.hpp
(inter-degree transfer), src/csr.hpp (assembled operator, used as oracle).
"""

from .laplacian import (
    laplacian_apply,
    laplacian_apply_cells,
    laplacian_diagonal,
    MatFreeLaplacian,
)
from .interpolate import PInterpolator

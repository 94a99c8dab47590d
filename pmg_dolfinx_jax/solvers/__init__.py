"""Iterative solvers and the p-multigrid preconditioner.

JAX equivalents of reference L5/L6 (SURVEY.md §1): Jacobi-CG with
Lanczos eigenvalue estimation (src/cg.hpp), fourth-kind Chebyshev smoothing
(src/chebyshev.hpp), the PMG V-cycle (src/pmg.hpp) and coarse solvers
replacing PETSc/hypre AMG (src/amg.hpp). All solver loops are pure JAX
(`lax.while_loop` / `lax.scan`), jittable end-to-end, and generic over the
inner product so the same code runs single-chip and under `shard_map`.
"""

from .cg import cg_solve
from .chebyshev import chebyshev4_solve, chebyshev1_solve
from .tridiag import lanczos_eigenvalue_estimates, tqli
from .pmg import Level, PMGHierarchy, v_cycle
from .hmg import build_hmg
from .fdm import FastDiagonalizationSolver

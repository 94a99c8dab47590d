"""pmg_dolfinx_jax — a JAX p-multigrid finite-element framework.

A from-scratch JAX/XLA rebuild of the capabilities of
``Wells-Group/pmg-dolfinx`` (C++/HIP/CUDA): a matrix-free, sum-factorized
high-order solver for the Poisson problem ``-div(kappa grad u) = f`` on
hexahedral meshes, preconditioned by p-multigrid (coarsening in polynomial
degree) with fourth-kind Chebyshev smoothers, Jacobi-CG eigenvalue
estimation, matrix-free inter-degree transfer, and SPMD domain
decomposition over a ``jax.sharding.Mesh`` (halo exchange via collectives
instead of MPI).

Layering (mirrors reference SURVEY.md §1):

- ``fem``      — 1D GLL elements, structured hex meshes, dofmaps, geometry
                 factors, golden-model assembly (reference: basix/dolfinx).
- ``ops``      — matrix-free operators: sum-factorized Laplacian
                 (dofmap, Kronecker, lattice and unstructured DSS
                 forms), CSR/BCOO operator, p-transfer interpolation
                 (reference: src/laplacian.hpp, src/csr.hpp,
                 src/interpolate.hpp).
- ``solvers``  — Jacobi-CG with Lanczos eigenvalue estimation, fourth-kind
                 Chebyshev, the PMG V-cycle, coarse solvers (reference:
                 src/cg.hpp, src/chebyshev.hpp, src/pmg.hpp, src/amg.hpp).
- ``parallel`` — slab partition of the structured mesh, halo exchange via
                 ``shard_map`` + collectives (reference: src/vector.hpp,
                 src/mesh.hpp ghost layer / MPI scatterers).
- ``models``   — problem definitions (Poisson with manufactured solution).
- ``utils``    — timers, logging, profiling hooks.
"""

__version__ = "0.1.0"

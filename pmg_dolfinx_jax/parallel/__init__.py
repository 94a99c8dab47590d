"""SPMD domain decomposition over a JAX device mesh.

JAX replacement of the reference's MPI layer (SURVEY.md §2.4):
one-rank-one-GPU domain decomposition with ghost-cell layers, GPU-aware
point-to-point halo exchange (`acc::Vector` scatterers, src/vector.hpp)
and `MPI_Allreduce` dot products become:

- a slab partition of the structured lattice along a 1D device mesh axis,
  with shared interface planes stored on both neighbouring shards,
- halo *partial-sum* exchange via non-wrapping `jax.lax.ppermute` over ICI
  after every cell-scatter (the analogue of the reverse scatter), and
- `jax.lax.psum` inner products.

Everything runs inside a single `shard_map` region per solve — XLA
schedules the collectives and can overlap them with cell compute (the
lcells/bcells comm/compute overlap of the reference, src/mesh.hpp:106-143,
becomes a compiler scheduling concern instead of hand-written streams).
"""

from .partition import SlabPartition
from .dist import DistPMG, make_mesh
from .grid2d import GridPMG, GridPartition

"""Worker for the multi-process multi-host smoke test (not a test module).

Launched ``nprocs`` times by tests/test_multihost.py:

    python multihost_worker.py <coordinator> <nprocs> <pid> <out_json>

Each process brings up ``8 // nprocs`` virtual CPU devices (8 global, so
every process topology shards the SAME global mesh), builds the SAME
DistPMG / GridPMG solves as the single-process tests, and writes one
JSON file of residual norms for the parent to compare — rank-count AND
process-count invariance (the reference's multi-node `srun` contract,
SURVEY.md §4, validated without a cluster). Results go to a file (not
stdout) so interleaved runtime log output cannot corrupt them.
"""

import json
import sys

sys.path.insert(0, sys.path[0] + "/..")

from pmg_dolfinx_jax.parallel.multihost import initialize  # noqa: E402

coordinator, nprocs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
out_path = sys.argv[4]
initialize(coordinator_address=coordinator, num_processes=nprocs,
           process_id=pid, local_device_count=8 // nprocs)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
from pmg_dolfinx_jax.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=0.3)

from pmg_dolfinx_jax.fem.assembly import assemble_rhs  # noqa: E402
from pmg_dolfinx_jax.fem.mesh import BoxMesh  # noqa: E402
from pmg_dolfinx_jax.models.poisson import f_rhs  # noqa: E402
from pmg_dolfinx_jax.parallel.dist import DistPMG  # noqa: E402
from pmg_dolfinx_jax.parallel.grid2d import GridPMG  # noqa: E402

assert jax.device_count() == 8, jax.devices()
assert jax.process_count() == nprocs

kappa = 2.0
mesh = BoxMesh((8, 4, 4))
b = assemble_rhs(mesh, 3, f_rhs(kappa))

dist = DistPMG(mesh, n_devices=8, degrees=(1, 3), kappa=kappa,
               coarse="fdm", operator="kron")
u_d, rn_dist = dist.solve(b, num_cycles=5)

mesh_g = BoxMesh((4, 4, 4))
b_g = assemble_rhs(mesh_g, 3, f_rhs(kappa))
grid = GridPMG(mesh_g, shards=(2, 2, 2), degrees=(1, 3), kappa=kappa,
               coarse="cg")
u_g, rn_grid = grid.solve(b_g, num_cycles=5)

# General-hex lattice backend on the same 3D process-spanning grid.
from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh  # noqa: E402

mesh_l = PerturbedBoxMesh((4, 4, 4))
b_l = assemble_rhs(mesh_l, 3, f_rhs(kappa))
grid_l = GridPMG(mesh_l, shards=(2, 2, 2), degrees=(1, 3), kappa=kappa,
                 coarse="cg", operator="lattice")
u_l, rn_lat = grid_l.solve(b_l, num_cycles=5)

# f32 working precision on the process-spanning grid (the production
# dtype; interface exchanges cross the process boundary).
import jax.numpy as jnp  # noqa: E402

grid_f32 = GridPMG(mesh_g, shards=(2, 2, 2), degrees=(1, 3), kappa=kappa,
                   coarse="cg", operator="kron", dtype=jnp.float32)
_, rn_f32 = grid_f32.solve(b_g, num_cycles=5)

# Distributed (non-gathered) h-MG coarse spanning both processes: every
# h-level stays in the multi-axis layout; the only cross-process
# collective beyond the usual exchanges is the coarsest-level
# all_gather of the bottom solve (grid2d.build_hmg_grid).
mesh_h = BoxMesh((4, 8, 4))
b_h = assemble_rhs(mesh_h, 3, f_rhs(kappa))
grid_h = GridPMG(mesh_h, shards=(2, 2, 2), degrees=(1, 3), kappa=kappa,
                 coarse="hmg", coarse_cfg=dict(dist=True))
_, rn_hmg = grid_h.solve(b_h, num_cycles=5)

# Per-axis (diagonal-tensor) anisotropic kappa on the exact FDM coarse
# + semi-coarsened dist-hmg: the round-3 anisotropy features under
# multi-process SPMD.
import numpy as np  # noqa: E402

from pmg_dolfinx_jax.models.poisson import f_rhs_tensor  # noqa: E402

kdiag = (1.0, 2.0, 8.0)
b_t = assemble_rhs(mesh, 3, f_rhs_tensor(np.diag(kdiag)))
dist_t = DistPMG(mesh, n_devices=8, degrees=(1, 3), kappa=kdiag,
                 coarse="fdm", operator="kron")
_, rn_aniso = dist_t.solve(b_t, num_cycles=5)

# LINE-relaxation smoother across processes (solvers/line.py): the
# shard-local block matvecs ride the duplicated-plane layout; the only
# cross-process traffic stays the usual exchanges.
import warnings  # noqa: E402

kline = np.diag([1.0, 1.0, 16.0])
b_ln = assemble_rhs(mesh, 3, f_rhs_tensor(kline))
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    dist_ln = DistPMG(mesh, n_devices=8, degrees=(1, 3), kappa=kline,
                      coarse="cg", operator="lattice", smoother="line")
    _, rn_line = dist_ln.solve(b_ln, num_cycles=5)

# Distributed FDM coarse across processes (parallel/fdm_dist.py): the
# pencil all_to_all transposes cross the process boundary on every
# sharded axis of the (2,2,2) grid — no gather anywhere.
grid_fd = GridPMG(mesh_g, shards=(2, 2, 2), degrees=(1, 3), kappa=kappa,
                  coarse="fdm", coarse_cfg=dict(dist=True))
_, rn_fdmdist = grid_fd.solve(b_g, num_cycles=5)

# Cell-wise FDM SCHWARZ smoother across processes (solvers/schwarz.py):
# the cell overlap-add's interface partial-sum exchange crosses the
# process boundary on EVERY sharded axis of the (2,2,2) grid.
b_sw = assemble_rhs(mesh_g, 3, f_rhs_tensor(kline))
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    grid_sw = GridPMG(mesh_g, shards=(2, 2, 2), degrees=(1, 3),
                      kappa=kline, coarse="cg", operator="kron",
                      smoother="schwarz")
    _, rn_schwarz = grid_sw.solve(b_sw, num_cycles=5)

with open(out_path, "w") as f:
    json.dump({
        "pid": pid,
        "rn_dist": rn_dist,
        "rn_grid": rn_grid,
        "rn_lat": rn_lat,
        "rn_f32": rn_f32,
        "rn_hmg": rn_hmg,
        "rn_aniso": rn_aniso,
        "rn_line": rn_line,
        "rn_fdmdist": rn_fdmdist,
        "rn_schwarz": rn_schwarz,
        "u_d_norm": float((u_d ** 2).sum() ** 0.5),
        "u_g_norm": float((u_g ** 2).sum() ** 0.5),
    }, f)

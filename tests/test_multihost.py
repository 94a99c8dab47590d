"""Multi-host (multi-process) smoke test: the reference's multi-node MPI
runs (LUMI.md: 2 nodes x 8 GCDs under srun) mapped to JAX
multi-controller SPMD, validated on one machine with 2 processes x 4
virtual CPU devices AND 4 processes x 2 devices (Gloo collectives) over
the same 8-device global mesh. The residual trajectories must match the
single-process 8-device runs exactly — process-count invariance on top
of the rank-count invariance the other parallel tests pin down.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from pmg_dolfinx_jax.fem.assembly import assemble_rhs
from pmg_dolfinx_jax.fem.mesh import BoxMesh
from pmg_dolfinx_jax.models.poisson import f_rhs
from pmg_dolfinx_jax.parallel.dist import DistPMG
from pmg_dolfinx_jax.parallel.grid2d import GridPMG

_WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", params=[2, 4],
                ids=["2procs_x4dev", "4procs_x2dev"])
def two_process_results(request, tmp_path_factory):
    nprocs = request.param
    coord = f"localhost:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    outdir = tmp_path_factory.mktemp("multihost")
    out_paths = [str(outdir / f"result_{pid}.json")
                 for pid in range(nprocs)]
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, coord, str(nprocs), str(pid),
             out_paths[pid]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=os.path.dirname(_WORKER),
        )
        for pid in range(nprocs)
    ]
    for p in procs:
        try:
            out, err = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out")
        if p.returncode != 0:
            pytest.fail(f"worker rc={p.returncode}:\n{out[-2000:]}"
                        f"\n{err[-4000:]}")
    results = []
    for path in out_paths:
        with open(path) as f:
            results.append(json.load(f))
    return results


def test_two_processes_match_each_other(two_process_results):
    rs = sorted(two_process_results, key=lambda r: r["pid"])
    r0 = rs[0]
    for r1 in rs[1:]:
        assert np.allclose(r0["rn_dist"], r1["rn_dist"], rtol=1e-12)
        assert np.allclose(r0["rn_grid"], r1["rn_grid"], rtol=1e-12)
        assert np.allclose(r0["rn_lat"], r1["rn_lat"], rtol=1e-12)
        assert np.allclose(r0["rn_f32"], r1["rn_f32"], rtol=1e-12)
        assert np.allclose(r0["rn_hmg"], r1["rn_hmg"], rtol=1e-12)
        assert np.allclose(r0["rn_aniso"], r1["rn_aniso"], rtol=1e-12)
        assert np.allclose(r0["rn_line"], r1["rn_line"], rtol=1e-12)
        assert np.allclose(r0["rn_fdmdist"], r1["rn_fdmdist"], rtol=1e-12)
        assert np.allclose(r0["rn_schwarz"], r1["rn_schwarz"], rtol=1e-12)
        assert np.isclose(r0["u_d_norm"], r1["u_d_norm"], rtol=1e-12)


def test_two_processes_match_single_process(two_process_results):
    """Process-count invariance: 2 procs x 4 devices == 1 proc x 8."""
    r0 = two_process_results[0]
    kappa = 2.0
    mesh = BoxMesh((8, 4, 4))
    b = assemble_rhs(mesh, 3, f_rhs(kappa))
    dist = DistPMG(mesh, n_devices=8, degrees=(1, 3), kappa=kappa,
                   coarse="fdm", operator="kron")
    u_d, rn_dist = dist.solve(b, num_cycles=5)
    assert np.allclose(r0["rn_dist"], rn_dist, rtol=1e-10), (
        r0["rn_dist"], rn_dist)
    assert np.isclose(r0["u_d_norm"],
                      float(np.linalg.norm(np.asarray(u_d))), rtol=1e-10)

    mesh_g = BoxMesh((4, 4, 4))
    b_g = assemble_rhs(mesh_g, 3, f_rhs(kappa))
    grid = GridPMG(mesh_g, shards=(2, 2, 2), degrees=(1, 3), kappa=kappa,
                   coarse="cg")
    u_g, rn_grid = grid.solve(b_g, num_cycles=5)
    assert np.allclose(r0["rn_grid"], rn_grid, rtol=1e-10), (
        r0["rn_grid"], rn_grid)

    from pmg_dolfinx_jax.fem.mesh import PerturbedBoxMesh

    mesh_l = PerturbedBoxMesh((4, 4, 4))
    b_l = assemble_rhs(mesh_l, 3, f_rhs(kappa))
    grid_l = GridPMG(mesh_l, shards=(2, 2, 2), degrees=(1, 3), kappa=kappa,
                     coarse="cg", operator="lattice")
    _, rn_lat = grid_l.solve(b_l, num_cycles=5)
    assert np.allclose(r0["rn_lat"], rn_lat, rtol=1e-10), (
        r0["rn_lat"], rn_lat)

    import jax.numpy as jnp

    grid_f32 = GridPMG(mesh_g, shards=(2, 2, 2), degrees=(1, 3),
                       kappa=kappa, coarse="cg", operator="kron",
                       dtype=jnp.float32)
    _, rn_f32 = grid_f32.solve(b_g, num_cycles=5)
    # f32 path: Gloo vs single-process reduction orders differ slightly.
    assert np.allclose(r0["rn_f32"], rn_f32, rtol=5e-4), (
        r0["rn_f32"], rn_f32)

    mesh_h = BoxMesh((4, 8, 4))
    b_h = assemble_rhs(mesh_h, 3, f_rhs(kappa))
    grid_h = GridPMG(mesh_h, shards=(2, 2, 2), degrees=(1, 3), kappa=kappa,
                     coarse="hmg", coarse_cfg=dict(dist=True))
    _, rn_hmg = grid_h.solve(b_h, num_cycles=5)
    assert np.allclose(r0["rn_hmg"], rn_hmg, rtol=1e-10), (
        r0["rn_hmg"], rn_hmg)

    from pmg_dolfinx_jax.models.poisson import f_rhs_tensor

    kdiag = (1.0, 2.0, 8.0)
    b_t = assemble_rhs(mesh, 3, f_rhs_tensor(np.diag(kdiag)))
    dist_t = DistPMG(mesh, n_devices=8, degrees=(1, 3), kappa=kdiag,
                     coarse="fdm", operator="kron")
    _, rn_aniso = dist_t.solve(b_t, num_cycles=5)
    assert np.allclose(r0["rn_aniso"], rn_aniso, rtol=1e-10), (
        r0["rn_aniso"], rn_aniso)

    import warnings

    kline = np.diag([1.0, 1.0, 16.0])
    b_ln = assemble_rhs(mesh, 3, f_rhs_tensor(kline))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dist_ln = DistPMG(mesh, n_devices=8, degrees=(1, 3), kappa=kline,
                          coarse="cg", operator="lattice",
                          smoother="line")
        _, rn_line = dist_ln.solve(b_ln, num_cycles=5)
    assert np.allclose(r0["rn_line"], rn_line, rtol=1e-10), (
        r0["rn_line"], rn_line)

    grid_fd = GridPMG(mesh_g, shards=(2, 2, 2), degrees=(1, 3),
                      kappa=kappa, coarse="fdm",
                      coarse_cfg=dict(dist=True))
    _, rn_fdmdist = grid_fd.solve(b_g, num_cycles=5)
    assert np.allclose(r0["rn_fdmdist"], rn_fdmdist, rtol=1e-10), (
        r0["rn_fdmdist"], rn_fdmdist)

    b_sw = assemble_rhs(mesh_g, 3, f_rhs_tensor(kline))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        grid_sw = GridPMG(mesh_g, shards=(2, 2, 2), degrees=(1, 3),
                          kappa=kline, coarse="cg", operator="kron",
                          smoother="schwarz")
        _, rn_schwarz = grid_sw.solve(b_sw, num_cycles=5)
    assert np.allclose(r0["rn_schwarz"], rn_schwarz, rtol=1e-10), (
        r0["rn_schwarz"], rn_schwarz)

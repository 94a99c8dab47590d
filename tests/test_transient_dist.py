"""Sharded transient stepping (parallel/transient_dist.py): the scanned
heat / wave loops on slab and 2D/3D grid layouts must reproduce the
single-device trajectories (solvers/transient.py).

CN uses the exact-inverse identity ``u1 = A^{-1}(2 sigma M u + f) - u``
instead of the single-device path's explicit apply, so agreement is to
accumulated roundoff (pinned at 1e-10 rel over the trajectory), not
bit-exact; BE and Newmark run the identical formulas."""

import numpy as np
import pytest

from pmg_dolfinx_jax.fem.mesh import BoxMesh, geometric_spacing
from pmg_dolfinx_jax.parallel.transient_dist import (
    heat_dist_evolve, wave_newmark_dist_evolve)
from pmg_dolfinx_jax.solvers.transient import (
    heat_fdm_evolve, wave_newmark_evolve)

KAPPA, DT, NSTEPS = 1.3, 2e-3, 5


def _mesh():
    # Graded y, one Neumann face, non-unit extent: the fdm_dist
    # embeddings and the layout converters all get exercised.
    return BoxMesh((4, 4, 4), extent=(1.0, 1.2, 0.9),
                   spacing=(None, geometric_spacing(4, 2.0), None),
                   dirichlet_faces=((True, True), (True, False),
                                    (True, True)))


def _u0(mesh, P):
    c = mesh.dof_coords(P)
    return (np.sin(np.pi * c[:, 0]) * np.cos(0.5 * np.pi * c[:, 1])
            * np.sin(np.pi * c[:, 2] / 0.9))


@pytest.mark.parametrize("shards", [4, (2, 2, 1), (1, 2, 2)])
@pytest.mark.parametrize("scheme", ["be", "cn"])
def test_heat_dist_matches_single(shards, scheme):
    mesh, P = _mesh(), 3
    u0 = _u0(mesh, P)
    rng = np.random.default_rng(3)
    f = np.where(np.asarray(mesh.boundary_dof_marker(P)), 0.0,
                 rng.standard_normal(mesh.num_dofs(P)))
    ref = np.asarray(
        heat_fdm_evolve(mesh, P, kappa=KAPPA, dt=DT, scheme=scheme,
                        f=f)(u0, NSTEPS)).reshape(-1)
    got = heat_dist_evolve(mesh, P, shards, kappa=KAPPA, dt=DT,
                           scheme=scheme, f=f)(u0, NSTEPS)
    assert np.linalg.norm(got - ref) < 1e-10 * np.linalg.norm(ref), \
        (shards, scheme)


@pytest.mark.parametrize("shards", [4, (2, 1, 2)])
def test_wave_newmark_dist_matches_single(shards):
    mesh, P = _mesh(), 3
    u0, v0 = _u0(mesh, P), 0.3 * _u0(mesh, P)
    uref, vref = (np.asarray(a).reshape(-1) for a in wave_newmark_evolve(
        mesh, P, kappa=KAPPA, dt=DT)(u0, v0, NSTEPS))
    uT, vT = wave_newmark_dist_evolve(mesh, P, shards, kappa=KAPPA,
                                      dt=DT)(u0, v0, NSTEPS)
    assert np.linalg.norm(uT - uref) < 1e-10 * np.linalg.norm(uref)
    assert np.linalg.norm(vT - vref) < 1e-10 * np.linalg.norm(vref)


def test_heat_dist_rejects_bad_scheme():
    with pytest.raises(ValueError, match="scheme"):
        heat_dist_evolve(BoxMesh((3, 3, 3)), 2, 2, scheme="rk4")


@pytest.mark.parametrize("shards", [4, (2, 2, 1)])
@pytest.mark.parametrize("scheme", ["be", "cnab"])
def test_convdiff_dist_matches_single(shards, scheme):
    """Sharded IMEX transport: replicated scale-free advection
    matrices + duplicated-plane axis masses + per-axis exchanges must
    reproduce the single-device scan (graded sharded axis, mixed
    faces, driven source, and linear reaction sigma included)."""
    from pmg_dolfinx_jax.parallel.transient_dist import convdiff_dist_evolve
    from pmg_dolfinx_jax.solvers.transient import convdiff_fdm_evolve

    mesh, P = _mesh(), 3
    cvel = (1.1, -0.5, 0.3)
    u0 = _u0(mesh, P)
    rng = np.random.default_rng(5)
    f = np.where(np.asarray(mesh.boundary_dof_marker(P)), 0.0,
                 rng.standard_normal(mesh.num_dofs(P)))
    g = lambda t: 1.0 + 0.5 * np.sin(20.0 * t)
    ref = np.asarray(convdiff_fdm_evolve(
        mesh, P, cvel, kappa=KAPPA, dt=5e-4, scheme=scheme, sigma=1.5,
        f=f, f_time=g)(u0, NSTEPS)).reshape(-1)
    got = convdiff_dist_evolve(mesh, P, shards, cvel, kappa=KAPPA,
                               dt=5e-4, scheme=scheme, sigma=1.5, f=f,
                               f_time=g)(u0, NSTEPS)
    assert np.linalg.norm(got - ref) < 1e-10 * np.linalg.norm(ref), \
        (shards, scheme)


def test_fdm_apply_dist_matches_assembled():
    """The forward transform apply (M V) d (V^T M) == the assembled
    shifted operator, on a sharded layout (mixed faces + per-axis
    kappa)."""
    import jax
    import scipy.sparse as sp
    from jax.sharding import NamedSharding

    from pmg_dolfinx_jax.fem.assembly import (assemble_stiffness,
                                              lumped_mass_np)
    from pmg_dolfinx_jax.parallel.fdm_dist import (dist_layout,
                                                   make_fdm_apply_dist)
    from pmg_dolfinx_jax.parallel.multihost import fetch_global, put_global

    mesh = BoxMesh((4, 4, 2), dirichlet_faces=((True, True),
                                               (True, False),
                                               (True, True)))
    P, kd, sigma = 2, (1.0, 2.0, 0.5), 3.0
    part, jmesh, axes_spec, lat_spec = dist_layout(mesh, (2, 2, 1))
    data, spec, apply_local = make_fdm_apply_dist(
        mesh, P, part, axes_spec, lat_spec, kd, np.float64, sigma=sigma)
    with jmesh:
        data = jax.tree.map(
            lambda a, s: put_global(a, NamedSharding(jmesh, s)),
            data, spec)
    run = jax.jit(jax.shard_map(apply_local, mesh=jmesh,
                                in_specs=(spec, lat_spec),
                                out_specs=lat_spec))
    rng = np.random.default_rng(0)
    x = rng.standard_normal(mesh.num_dofs(P))
    xd = put_global(part.to_dist(P, x), NamedSharding(jmesh, lat_spec))
    y = part.from_dist(P, fetch_global(run(data, xd))).reshape(-1)
    A = (assemble_stiffness(mesh, P, kappa=np.diag(kd), bc=True).tocsr()
         + sigma * sp.diags(lumped_mass_np(mesh, P, bc_zero=True)))
    bc = np.asarray(mesh.boundary_dof_marker(P))
    ref = np.asarray(A @ np.where(bc, 0.0, x))
    ref = np.where(bc, x, ref)
    assert np.linalg.norm(y - ref) < 1e-11 * np.linalg.norm(ref)


@pytest.mark.parametrize("shards", [4, (2, 2, 1)])
def test_wave_leapfrog_dist_matches_single(shards):
    """Explicit sharded leapfrog (forward transform apply) vs the
    single-device kron-apply path — equal to eigendecomposition
    roundoff over the horizon."""
    from pmg_dolfinx_jax.parallel.transient_dist import (
        wave_leapfrog_dist_evolve)
    from pmg_dolfinx_jax.solvers.transient import wave_leapfrog_evolve

    mesh, P = _mesh(), 3
    u0, v0 = _u0(mesh, P), 0.2 * _u0(mesh, P)
    dt = 2e-4  # inside the spectral bound for this mesh
    g = lambda t: 1.0 + 0.4 * np.sin(30.0 * t)
    rng = np.random.default_rng(9)
    f = np.where(np.asarray(mesh.boundary_dof_marker(P)), 0.0,
                 rng.standard_normal(mesh.num_dofs(P)))
    ur, vr = (np.asarray(a).reshape(-1) for a in wave_leapfrog_evolve(
        mesh, P, kappa=KAPPA, dt=dt, f=f, f_time=g)(u0, v0, 8))
    uT, vT = wave_leapfrog_dist_evolve(mesh, P, shards, kappa=KAPPA,
                                       dt=dt, f=f, f_time=g)(u0, v0, 8)
    assert np.linalg.norm(uT - ur) < 1e-9 * np.linalg.norm(ur)
    assert np.linalg.norm(vT - vr) < 1e-9 * np.linalg.norm(vr)

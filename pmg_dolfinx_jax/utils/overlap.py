"""Comm/compute overlap verification: scheduled-HLO analysis.

The reference hand-schedules halo-exchange/compute overlap with its
lcells/bcells split (src/laplacian.hpp:378-455); here XLA's
latency-hiding scheduler provides it. These helpers compile the sharded
kron apply for the devices at hand (the GPUs of one host, or virtual CPU
devices for a dry run) and check the instruction schedule: each async
collective-permute window should contain at least one independent
contraction. See examples/overlap_check.py for the CLI and README for
the measured schedule.
"""

import re

import numpy as np


def _devices(n):
    import jax

    devs = jax.devices()
    if len(devs) < n:
        raise RuntimeError(f"need {n} devices, found {len(devs)}")
    return np.array(devs[:n])


def scheduled_hlo_kron_apply(n_sh=4, nc=(16, 21, 21), P=6):
    """Compile the x-slab sharded kron apply over ``n_sh`` devices;
    return the scheduled HLO text of the compiled program."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as Pspec

    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.ops.kron import axis_stiffness_mass
    from pmg_dolfinx_jax.parallel.dist import AXIS, dist_kron_cycle_ops
    from pmg_dolfinx_jax.parallel.partition import SlabPartition
    from pmg_dolfinx_jax.solvers.pmg import Level

    mesh = Mesh(_devices(n_sh), (AXIS,))
    bm = BoxMesh(nc)
    part = SlabPartition(bm, n_sh)
    ops = dist_kron_cycle_ops(n_sh)
    lvl = Level(P=P, ndofs=part.local_ndofs(P), shape=part.local_shape(P))

    Kx, _ = axis_stiffness_mass(part.cells_per_shard_x, P, bm.h[0])
    Ky, my = axis_stiffness_mass(bm.nc[1], P, bm.h[1])
    Kz, mz = axis_stiffness_mass(bm.nc[2], P, bm.h[2])
    _, mx_g = axis_stiffness_mass(bm.nc[0], P, bm.h[0])
    npl = part.local_planes(P)
    mx_dup = np.concatenate(
        [mx_g[s * (npl - 1): s * (npl - 1) + npl] for s in range(n_sh)]
    )
    f32 = jnp.float32
    lv = dict(
        Kx=jnp.asarray(2.0 * Kx, f32), Ky=jnp.asarray(2.0 * Ky, f32),
        Kz=jnp.asarray(2.0 * Kz, f32), mx=jnp.asarray(mx_dup, f32),
        my=jnp.asarray(my, f32), mz=jnp.asarray(mz, f32),
        bc_marker=jnp.asarray(part.to_dist(P, bm.boundary_dof_marker(P))
                              > 0.5),
    )
    spec = dict(Kx=Pspec(), Ky=Pspec(), Kz=Pspec(), mx=Pspec(AXIS),
                my=Pspec(), mz=Pspec(), bc_marker=Pspec(AXIS))
    fn = jax.jit(
        jax.shard_map(
            lambda l, x: ops["apply"](l, x, lvl), mesh=mesh,
            in_specs=(spec, Pspec(AXIS)), out_specs=Pspec(AXIS),
        )
    )
    lv_s = {
        k: jax.ShapeDtypeStruct(v.shape, v.dtype,
                                sharding=NamedSharding(mesh, spec[k]))
        for k, v in lv.items()
    }
    gshape = (n_sh * npl,) + part.local_shape(P)[1:]
    x_s = jax.ShapeDtypeStruct(gshape, f32,
                               sharding=NamedSharding(mesh, Pspec(AXIS)))
    return fn.lower(lv_s, x_s).compile().as_text()


def scheduled_hlo_grid_kron_apply(shards=(2, 2, 1), nc=(8, 8, 8), P=6):
    """Compile the multi-axis (grid) sharded kron apply; return the
    scheduled HLO. One ppermute pair per sharded axis, each depending
    only on its own stiffness term — the scheduler can overlap each
    with the other terms' contractions."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as Pspec

    from pmg_dolfinx_jax.fem.mesh import BoxMesh
    from pmg_dolfinx_jax.ops.kron import axis_stiffness_mass
    from pmg_dolfinx_jax.parallel.grid2d import (
        AXES,
        GridPartition,
        grid_kron_cycle_ops,
    )
    from pmg_dolfinx_jax.solvers.pmg import Level

    mesh = Mesh(_devices(int(np.prod(shards))).reshape(shards), AXES)
    bm = BoxMesh(nc)
    part = GridPartition(bm, shards)
    ops = grid_kron_cycle_ops(shards)
    lvl = Level(P=P, ndofs=part.local_ndofs(P), shape=part.local_shape(P))

    f32 = jnp.float32
    npls = part.local_shape(P)
    lv, spec = {}, {}
    for a, name in enumerate("xyz"):
        Kl, _ = axis_stiffness_mass(part.cells_per_shard[a], P, bm.h[a])
        _, mg = axis_stiffness_mass(bm.nc[a], P, bm.h[a])
        npl = npls[a]
        m_dup = np.concatenate(
            [mg[s * (npl - 1): s * (npl - 1) + npl]
             for s in range(part.shards[a])]
        )
        lv["K" + name] = jnp.asarray(2.0 * Kl, f32)
        lv["m" + name] = jnp.asarray(m_dup, f32)
        spec["K" + name] = Pspec()
        spec["m" + name] = Pspec(AXES[a])
    lv["bc_marker"] = jnp.asarray(
        part.to_dist(P, bm.boundary_dof_marker(P)) > 0.5
    )
    spec["bc_marker"] = Pspec(*AXES)
    fn = jax.jit(
        jax.shard_map(
            lambda l, x: ops["apply"](l, x, lvl), mesh=mesh,
            in_specs=(spec, Pspec(*AXES)), out_specs=Pspec(*AXES),
        )
    )
    lv_s = {
        k: jax.ShapeDtypeStruct(v.shape, v.dtype,
                                sharding=NamedSharding(mesh, spec[k]))
        for k, v in lv.items()
    }
    gshape = tuple(s * n for s, n in zip(part.shards, npls))
    x_s = jax.ShapeDtypeStruct(gshape, f32,
                               sharding=NamedSharding(mesh, Pspec(*AXES)))
    return fn.lower(lv_s, x_s).compile().as_text()


def analyze_overlap(hlo_text):
    """Return (events, n_overlapped): the schedule-order list of
    collective-permute start/done markers and contraction fusions, and
    how many permute windows (start..matching done, matched by the HLO
    instruction suffix) contain at least one contraction."""
    events = []
    starts, dones = {}, {}
    pos = 0
    for i, line in enumerate(hlo_text.splitlines()):
        lhs = line.split("=")[0]
        m = re.search(r"%(collective-permute-start(?:\.\d+)?) ", lhs)
        md = re.search(r"%collective-permute-done((?:\.\d+)?) ", lhs)
        if m:
            events.append((i, f"cp-start {m.group(1)}"))
            starts[m.group(1)] = pos
            pos += 1
        elif md:
            # Pair by the done's START OPERAND (HLO name suffixes are
            # uniquified independently and need not match across a pair).
            mo = re.search(r"done[^(]*\(.*?%(collective-permute-start"
                           r"(?:\.\d+)?)", line)
            key = mo.group(1) if mo else f"?done{md.group(1)}"
            events.append((i, f"cp-done({key})"))
            dones[key] = pos
            pos += 1
        elif re.search(r"dot_general", line) and "fusion" in line:
            m2 = re.search(r'op_name="[^"]*?/([a-z]+,[a-z]+->[a-z]+)/', line)
            events.append((i, f"contraction {m2.group(1) if m2 else '?'}"))
            pos += 1
    n_overlapped = 0
    for key, s_pos in starts.items():
        d_pos = dones.get(key)
        if d_pos is None:
            continue
        inside = [
            tag for p, (_, tag) in enumerate(events)
            if s_pos < p < d_pos and tag.startswith("contraction")
        ]
        if inside:
            n_overlapped += 1
    return events, n_overlapped



"""Multi-host (multi-process) execution: the reference's multi-node MPI.

The reference runs 2 nodes x 8 GCDs under Cray MPICH (LUMI.md,
examples/*/submit.sh: one MPI rank per GPU). The JAX analogue is
multi-controller SPMD: one process per host, `jax.distributed
.initialize` for the coordination service, and the SAME `shard_map`
programs running over a global device mesh — collectives go to NCCL
on GPU hosts (NVLink within a host, the network between hosts; Gloo on
CPU for testing). Nothing in the solver stack changes:
`DistPMG`/`GridPMG` build their arrays through `put_global`, which works
identically for single-process, multi-device and multi-host meshes.

Launch (one command per host, same program):

    # host 0                                  # host 1
    python my_driver.py --coordinator h0:1234 --nprocs 2 --pid 0
    python my_driver.py --coordinator h0:1234 --nprocs 2 --pid 1

with ``initialize(coordinator, nprocs, pid)`` called before first JAX
use. On GPU hosts pass all three explicitly (``coordinator`` =
``host0:<free port>``); each process then drives its host's local
GPUs, so one process per host, not per GPU.
A 2-process CPU smoke test lives in tests/test_multihost.py — the
"multi-node test without a cluster" the reference lacks (SURVEY.md §4).
"""

import jax
import numpy as np


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, local_device_count=None):
    """Bring up multi-controller JAX (call before any other JAX use).

    On GPU hosts pass the coordinator address, process count and
    process id explicitly (nothing autodetects them); for CPU testing
    pass ``local_device_count`` too, to fan each process out to several
    virtual devices.
    """
    if local_device_count is not None:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", int(local_device_count))
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=int(num_processes),
                      process_id=int(process_id))
    jax.distributed.initialize(**kwargs)


def put_global(arr, sharding):
    """Place a host array as a global jax.Array under ``sharding``.

    Works in single- and multi-process settings: every process passes the
    same full (global) host value — the setup arrays are deterministic
    functions of the mesh, so each host computes them identically, and
    each device receives its own shard (the multi-controller analogue of
    the reference uploading per-rank dofmaps/geometry to each GPU,
    examples/pmg/main.cpp:155-257).
    """
    a = np.asarray(arr)
    return jax.make_array_from_callback(a.shape, sharding,
                                        lambda idx: a[idx])


def fetch_global(garr):
    """Materialize a global jax.Array on the host of EVERY process.

    np.asarray works directly for fully-addressable or fully-replicated
    arrays; sharded multi-host arrays go through an all-gather
    (`multihost_utils.process_allgather`).
    """
    if garr.is_fully_addressable or garr.is_fully_replicated:
        return np.asarray(garr)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(garr, tiled=True))

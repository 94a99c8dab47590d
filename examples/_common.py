"""Shared CLI plumbing for the example drivers."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def base_parser(description):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--ndofs", type=int, default=50000,
                   help="target number of dofs (global)")
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument("--operator",
                   choices=["kron", "lattice", "dofmap", "csr", "dss"],
                   default="kron", help="kernel backend ('kron' = "
                   "Kronecker-sum, axis-aligned boxes; 'lattice' = "
                   "general hexes; 'dss' = row-gather unstructured-"
                   "topology backend; 'csr' = assembled sparse matvec, "
                   "parity/oracle path)")
    p.add_argument("--kappa", type=float, default=2.0)
    return p


def setup_jax(args, n_cpu_devices=None):
    """Configure JAX for a driver run and return the working dtype.

    Drivers run on a GPU; ``--cpu`` selects the CPU backend instead
    (with ``n_cpu_devices`` virtual devices for the sharded drivers).
    Without ``--cpu`` a run whose default backend is not a GPU stops
    here rather than falling back to the CPU."""
    import jax

    from pmg_dolfinx_jax.utils.cache import enable_compile_cache

    enable_compile_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        if n_cpu_devices:
            jax.config.update("jax_num_cpu_devices", int(n_cpu_devices))
    else:
        try:
            backend = jax.default_backend()
        except RuntimeError as e:
            raise SystemExit(f"no GPU backend ({e}); pass --cpu to run "
                             "on the CPU") from e
        if backend != "gpu":
            raise SystemExit(f"default JAX backend is {backend!r}, not "
                             "'gpu'; pass --cpu to run on the CPU")
    if args.dtype == "f64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    return jnp.float64 if args.dtype == "f64" else jnp.float32


def parse_shards(s):
    """'4' -> 4 (x-slab), '2,2,1' -> (2, 2, 1) (device grid)."""
    parts = [int(v) for v in s.split(",")]
    if len(parts) == 1:
        return parts[0]
    if len(parts) != 3:
        raise SystemExit("--shards expects 'N' or 'sx,sy,sz'")
    return tuple(parts)

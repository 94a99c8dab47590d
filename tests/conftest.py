"""Test configuration: CPU backend, 8 virtual devices, float64.

Multi-chip tests run on a simulated 8-device CPU mesh
(``jax_num_cpu_devices``) — the analogue of
"test multi-node without a cluster", which the reference lacks entirely
(SURVEY.md §4). Numerics tests run in float64 to match the reference's
``T = double`` (examples/pmg/main.cpp:30).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"

import jax

# NOTE: in JAX 0.9 the old ``--xla_force_host_platform_device_count`` XLA
# flag no longer creates virtual CPU devices; ``jax_num_cpu_devices`` (set
# together with ``jax_platforms``, before first backend use) is the
# working mechanism.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)
# Persistent compilation cache: XLA-CPU compiles dominate test wall time.
from pmg_dolfinx_jax.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=0.3)

"""Profiling annotations and device memory telemetry.

Counterpart of the reference's roctx / omnitrace scoped annotations
(`add/remove_profiling_annotation`, src/amd_gpu.hpp:236-252 — inserted
around CG iterations at src/cg.hpp:174,219) and the ROCm-SMI memory
queries (src/amd_gpu.hpp:71-234, peak-memory MPI_MAX reduce at
examples/cg/main.cpp:289-295).

Here: `jax.profiler` trace contexts (viewable in TensorBoard /
Perfetto) and PJRT `memory_stats()`.
"""

from contextlib import contextmanager

import jax


@contextmanager
def annotate(name: str):
    """Named trace scope (shows up in profiler timelines)."""
    with jax.profiler.TraceAnnotation(name):
        yield


@contextmanager
def trace(log_dir: str):
    """Capture a full profiler trace into ``log_dir``.

    The analogue of wrapping a run in rocprof/omnitrace
    (examples/cg/submit_rocprof.sh); inspect with TensorBoard or
    Perfetto.
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_memory_stats(device=None) -> dict:
    """Per-device memory statistics (bytes), incl. peak usage.

    Replacement for `print_amd_gpu_memory_*`; returns an empty dict on
    backends that do not implement PJRT memory stats (e.g. CPU).
    """
    device = device or jax.local_devices()[0]
    try:
        return dict(device.memory_stats() or {})
    except Exception:
        return {}


def peak_memory_fraction(device=None) -> float | None:
    """Peak-in-use fraction of device memory, if the backend reports it
    (the reference prints max % VRAM across ranks)."""
    stats = device_memory_stats(device)
    peak = stats.get("peak_bytes_in_use")
    limit = stats.get("bytes_limit")
    if peak and limit:
        return peak / limit
    return None

"""Named wall-clock timers with a `list_timings`-style report.

Counterpart of `dolfinx::common::Timer` scopes ("% Mat-free Matvec",
"ZZZ CG", ...) aggregated by `dolfinx::list_timings` at exit
(reference examples/mat_free/main.cpp:262-265, examples/pmg/main.cpp:461).

NOTE on async dispatch: JAX dispatch returns before device execution
finishes, so a Timer around a jitted call measures dispatch unless the
caller synchronizes. Pass ``sync=True`` to block on all devices at scope
exit (a trivial scalar computation read back from every device, which
waits for the work already queued there).
"""

import time
from collections import defaultdict
from contextlib import ContextDecorator

_records = defaultdict(lambda: [0, 0.0])  # name -> [count, total_seconds]


def _sync():
    import jax
    import jax.numpy as jnp

    # Force execution + readback of a scalar on every device.
    for d in jax.local_devices():
        float(jnp.zeros((), device=d) + 1.0)


class Timer(ContextDecorator):
    """``with Timer("name"):`` or ``@Timer("name")`` scope timer."""

    def __init__(self, name: str, sync: bool = False):
        self.name = name
        self.sync = sync

    def __enter__(self):
        if self.sync:
            _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            _sync()
        dt = time.perf_counter() - self._t0
        rec = _records[self.name]
        rec[0] += 1
        rec[1] += dt
        return False

    @property
    def elapsed(self):
        return time.perf_counter() - self._t0


def list_timings(print_fn=print):
    """Print the aggregated timing table (reference `list_timings`)."""
    if not _records:
        print_fn("no timings recorded")
        return
    width = max(len(n) for n in _records) + 2
    print_fn(f"{'timer'.ljust(width)} {'count':>7} {'total[s]':>10} {'avg[s]':>10}")
    for name in sorted(_records):
        count, total = _records[name]
        print_fn(
            f"{name.ljust(width)} {count:>7d} {total:>10.4f} {total / max(count, 1):>10.4f}"
        )


def reset_timings():
    _records.clear()

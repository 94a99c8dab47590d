"""Slope-based kernel timing shared by bench.py and the tools/ scripts.

Callers chain reps inside one jitted loop ending in a scalar readback
(which synchronizes with the device) and time the SLOPE between two rep
counts — launch/readback overhead subtracts out. This module owns the
sampling
loop; it lives in the package (not bench.py) so the tools/ scripts can
import it without loading the benchmark harness module twice
(bench.py runs as ``__main__``; a ``from bench import ...`` inside a
module bench.py itself imports would execute bench's module body a
second time).
"""

import time

SPREAD_TARGET = 0.10
MAX_SAMPLES = 25


def measure(run, lo, hi, min_samples=7):
    """Median per-apply slope between rep counts lo < hi, plus spread.

    Spread = (q3 - q1) / median over the collected slope samples; keeps
    sampling until it drops below SPREAD_TARGET or MAX_SAMPLES is hit.
    """
    run(lo)
    run(hi)  # warm both rep counts (compile + cache)
    slopes = []
    while True:
        for _ in range(min_samples if not slopes else 4):
            t0 = time.time()
            run(lo)
            t_lo = time.time() - t0
            t0 = time.time()
            run(hi)
            t_hi = time.time() - t0
            slopes.append((t_hi - t_lo) / (hi - lo))
        # Host-clock jitter can exceed the compute delta and produce
        # non-positive slopes; they carry no timing signal.
        s = sorted(x for x in slopes if x > 0)
        n = len(s)
        if n >= 3:
            med = s[n // 2]
            spread = (s[(3 * n) // 4] - s[n // 4]) / med
            if spread <= SPREAD_TARGET or len(slopes) >= MAX_SAMPLES:
                return med, spread
        elif len(slopes) >= MAX_SAMPLES:
            raise RuntimeError(
                "bench: host-clock jitter swamped the timing signal "
                f"({len(slopes)} samples, {n} positive slopes)"
            )

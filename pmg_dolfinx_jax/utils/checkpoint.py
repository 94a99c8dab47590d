"""Solver-state checkpoint/restart.

The reference has NO checkpoint/resume (SURVEY.md §5: errors terminate,
solver state is lost). Long production runs deserve better: these helpers
persist the stationary/refined iteration state (current iterate, residual
history, problem fingerprint) so a solve can resume after preemption —
cheap insurance on preemptible accelerator fleets.

Format: a single .npz (portable, no framework state). The fingerprint
guards against resuming onto a different discretization.
"""

import numpy as np


def _fingerprint(mesh, degrees, kappa):
    return np.array(
        [*mesh.nc, *[int(p) for p in degrees], float(kappa)], dtype=np.float64
    )


def save_state(path, mesh, degrees, kappa, u, rnorms, cycle):
    np.savez(
        path,
        fingerprint=_fingerprint(mesh, degrees, kappa),
        u=np.asarray(u),
        rnorms=np.asarray(rnorms, dtype=np.float64),
        cycle=np.int64(cycle),
    )


def load_state(path, mesh, degrees, kappa):
    """Return ``(u, rnorms, cycle)``; raises if the checkpoint belongs to
    a different problem."""
    data = np.load(path)
    expect = _fingerprint(mesh, degrees, kappa)
    if not np.array_equal(data["fingerprint"], expect):
        raise ValueError(
            "checkpoint fingerprint mismatch: saved for a different "
            f"problem (saved {data['fingerprint']}, expected {expect})"
        )
    return data["u"], list(data["rnorms"]), int(data["cycle"])

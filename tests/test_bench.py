"""Bench-harness regression tests (CPU; the GPU check is patched).

These tests pin the output contract: the headline line is emitted
IMMEDIATELY after the first measurement, re-emitted (enriched) after
every completed extra, failed extras degrade to `_error` strings and make
the process exit non-zero, extras that do not fit BENCH_TIME_BUDGET_S
are skipped with explicit "skipped_budget" markers, and nothing is
measured off the GPU.
"""

import contextlib
import io
import json

import numpy as np
import pytest


@pytest.fixture
def on_gpu(monkeypatch):
    import bench

    monkeypatch.setattr(bench, "_platform", lambda: "gpu")
    return bench


def _run(bench):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main()
    return rc, [ln for ln in buf.getvalue().splitlines() if ln.strip()]


def test_guarded_main_survives_subbench_failures(monkeypatch, on_gpu):
    bench = on_gpu

    def fake_size(nc, lo, hi):
        if nc == 21:  # the unguarded headline
            return 2048383, 26.8, 0.03
        raise RuntimeError("kernel crashed")  # 16M and 30M extras

    monkeypatch.setattr(bench, "_bench_size", fake_size)
    monkeypatch.setattr(bench, "_bench_vcycle_16m",
                        lambda smoother="cheb": {"kron": (13.0, 0.02)})
    monkeypatch.setattr(bench, "_bench_fdm_solve_2m", lambda: (0.135, 0.01))
    monkeypatch.setattr(bench, "_bench_unstructured_2m",
                        lambda: (2244151, 0.44, 0.02))
    monkeypatch.setattr(bench, "_bench_curved_2m", lambda: {
        "cheb": {"vcycle_ms": 5.5, "spread": 0.02, "fcg_iters": 10},
        "schwarz": {"vcycle_ms": 7.0, "spread": 0.02, "fcg_iters": 5},
    })
    monkeypatch.setattr(bench, "_bench_heat_steps_2m", lambda: 1635.0)

    rc, lines = _run(bench)
    # Incremental emission: every line is valid JSON with the headline
    # value, and the first goes out BEFORE any extra lands.
    assert len(lines) >= 2
    for ln in lines:
        assert json.loads(ln)["value"] == 26.8
    assert "fdm_solve_2M_ms" not in json.loads(lines[0])["extra"]
    d = json.loads(lines[-1])
    assert d["metric"] == "matfree_laplacian_apply_p6_f32_kron"
    assert d["value"] == 26.8 and d["unit"] == "GDOF/s"
    assert d["extra"]["platform"] == "cpu"  # jax.devices() is unpatched
    # Failed extras degrade to error strings, successful ones land, and
    # the run as a whole fails.
    assert "kernel crashed" in d["extra"]["16M_error"]
    assert "kernel crashed" in d["extra"]["30M_error"]
    assert d["extra"]["fdm_solve_2M_ms"] == 0.135
    assert d["extra"]["vcycle_16M_p136_fdm_ms"] == {"kron": 13.0}
    assert d["extra"]["vcycle_16M_p136_schwarz_ms"] == {"kron": 13.0}
    assert rc == 1


def test_main_skips_extras_when_budget_exhausted(monkeypatch, on_gpu):
    """With a zero time budget every extra is skipped with an explicit
    'skipped_budget' marker (no measurement attempted), the headline
    still prints, and the run succeeds."""
    bench = on_gpu

    def fake_size(nc, lo, hi):
        assert nc == 21, "no budget: only the headline may measure"
        return 2048383, 26.8, 0.03

    monkeypatch.setattr(bench, "_bench_size", fake_size)
    monkeypatch.setattr(bench, "TIME_BUDGET_S", 0.0)

    rc, lines = _run(bench)
    d = json.loads(lines[-1])
    assert d["value"] == 26.8
    for label in ("fdm_solve_2M", "16M", "30M", "vcycle_16M",
                  "vcycle_16M_schwarz"):
        assert d["extra"][label] == "skipped_budget"
    assert rc == 0


def test_main_refuses_to_run_off_gpu(monkeypatch):
    """Off the GPU nothing is measured and the exit code is non-zero."""
    import bench

    monkeypatch.setattr(bench, "_platform", lambda: "cpu")

    def boom(*a, **k):
        raise AssertionError("bench measured off the GPU")

    monkeypatch.setattr(bench, "_bench_size", boom)
    rc, lines = _run(bench)
    assert rc != 0 and lines == []


def test_main_emits_error_line_when_headline_raises(monkeypatch, on_gpu):
    """A crash in the headline bench itself prints the single JSON line
    and exits non-zero."""
    bench = on_gpu

    def boom(*a, **k):
        raise RuntimeError("crashed mid-headline")

    monkeypatch.setattr(bench, "_bench_size", boom)

    rc, lines = _run(bench)
    assert len(lines) == 1
    d = json.loads(lines[0])
    assert d["value"] == 0.0
    assert "crashed mid-headline" in d["error"]
    assert rc == 1


def test_measure_rejects_pure_jitter(monkeypatch):
    """_measure raises (not returns garbage) when every slope sample is
    non-positive — the clock-jitter guard."""
    from pmg_dolfinx_jax.utils import measure as measure_mod

    # A frozen clock makes every slope exactly 0.0 — all filtered as
    # signal-free, so sampling must hit MAX_SAMPLES and raise.
    monkeypatch.setattr(measure_mod.time, "time", lambda: 5.0)
    with pytest.raises(RuntimeError, match="jitter"):
        measure_mod.measure(lambda r: None, 10, 100, min_samples=3)


def test_duplicate_planes_layout():
    """Each shard's npl planes start at s*(npl-1); the interface plane is
    duplicated on both neighbours."""
    from pmg_dolfinx_jax.parallel.partition import duplicate_planes

    mg = np.arange(9.0)  # 2 shards x npl=5 planes, one shared
    out = duplicate_planes(mg, 5, 2)
    np.testing.assert_array_equal(
        out, [0, 1, 2, 3, 4, 4, 5, 6, 7, 8]
    )
    # single shard: identity
    np.testing.assert_array_equal(duplicate_planes(mg, 9, 1), mg)

"""chip_smoke.py on the CPU: every phase at a tiny size, the pinned
curved-phase iteration count, and the refusals (no GPU, no repo)."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def test_phase_parity_tiny():
    errs = cs.phase_parity(nc=2, n_l=2, P=3)
    assert set(errs) == {f"{n}_{p}" for n in ("kron", "lattice", "dss")
                         for p in ("highest", "high", "default")}
    assert max(errs.values()) < 1e-5


def test_phase_flagship_tiny():
    out = cs.phase_flagship(nc=4, nc_ref=3, degrees=(1, 3))
    assert out["fcg_iters"] <= 8 and out["error_l2"] < 1e-3
    assert out["vcycle_ms"] > 0.0


def test_phase_curved_pins_iteration_count():
    """The float64 CPU run of the curved phase at nc=4 gives the count
    the full-size GPU run is held to (+-1)."""
    out = cs.phase_curved(nc=4, degrees=(1, 3, 6), dtype=jnp.float64)
    assert out["fcg_iters"] == cs.CURVED_FCG_ITERS


def test_phase_unstructured_tiny():
    out = cs.phase_unstructured(n=2, degrees=(1, 3))
    assert out["fcg_iters"] <= 8


def test_phase_transient_tiny():
    out = cs.phase_transient(nc=3, P=2, steps=5, B=3)
    assert out["batch_vs_single"] < 1e-12


def test_phase_timings_tiny():
    out = cs.phase_timings(sizes=((2, 3),), lattice=(2, 3), batch=(1, 2, 4))
    assert list(out) == ["kron_gdofs_2197", "lattice_gdofs_2197",
                         "kron_gdofs_343_b1", "kron_gdofs_per_rhs_343_b2"]
    assert min(out.values()) > 0


def test_phase_grid4_tiny():
    assert cs.phase_grid4(nc=(4, 4, 2), degrees=(1, 3)) < 1e-4


def test_phase_dss4_tiny():
    assert cs.phase_dss4(n=2, degrees=(1, 3)) < 1e-10


def test_phase_heat4_tiny():
    assert cs.phase_heat4(nc=(4, 4, 2), P=2, steps=5) < 1e-10


def test_phase_overlap4_tiny(tmp_path):
    res = cs.phase_overlap4(nc=(8, 3, 3), P=2, dump_dir=str(tmp_path))
    assert res["slab"]["contractions"] >= 3
    assert (tmp_path / "overlap_slab.hlo").read_text().count(
        "collective-permute") >= 2


def test_assert_spread_catches_one_device():
    import jax

    one = jax.device_put(jnp.ones(8), jax.devices()[0])
    with pytest.raises(AssertionError, match="1 devices, not 4"):
        cs._assert_spread({"x": one}, 4)


def test_phase_device_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        cs.phase_device()


def _run_script(path, cwd):
    return subprocess.run(
        [sys.executable, str(path)], cwd=cwd, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )


def _printed_result(stdout):
    for ln in stdout.splitlines():
        try:
            if "ok" in json.loads(ln):
                return True
        except (ValueError, TypeError):
            continue
    return False


def test_script_exits_nonzero_without_gpu():
    r = _run_script(ROOT / "chip_smoke.py", ROOT)
    assert r.returncode != 0
    assert not _printed_result(r.stdout), r.stdout


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_script(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert not _printed_result(r.stdout), r.stdout

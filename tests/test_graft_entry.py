"""Guard the driver entry points (__graft_entry__) against API drift."""

import pathlib
import sys

import jax
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def test_entry_compiles_and_runs():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == args[1].shape
    assert bool(jax.numpy.isfinite(out).all())


def test_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


# Scheduled-HLO excerpts in the GPU compiler's format: a halo permute
# window that brackets an independent contraction, and one that does not.
_HLO_OVERLAP = """
  %fusion.15 = f32[4,43,43]{2,1,0} fusion(%p0, %p1), kind=kCustom, calls=%fused_dot, metadata={op_name="jit(f)/dot_general" source_file="kron.py"}
  %collective-permute-start = (f32[1,43,43]{2,1,0}, f32[1,43,43]{2,1,0}) collective-permute-start(%slice.1), source_target_pairs={{0,1},{1,2},{2,3}}
  %fusion.3 = f32[22,43,43]{2,1,0} fusion(%p0, %p2), kind=kCustom, calls=%fused_dot.1, metadata={op_name="jit(f)/cz,xyz->xyc/dot_general"}
  %collective-permute-done = f32[1,43,43]{2,1,0} collective-permute-done(%collective-permute-start)
"""
_HLO_SERIAL = """
  %fusion.15 = f32[4,43,43]{2,1,0} fusion(%p0, %p1), kind=kCustom, calls=%fused_dot, metadata={op_name="jit(f)/dot_general"}
  %collective-permute-start = (f32[1,43,43]{2,1,0}, f32[1,43,43]{2,1,0}) collective-permute-start(%slice.1), source_target_pairs={{0,1},{1,2},{2,3}}
  %collective-permute-done = f32[1,43,43]{2,1,0} collective-permute-done(%collective-permute-start)
  %fusion.3 = f32[22,43,43]{2,1,0} fusion(%p0, %p2), kind=kCustom, calls=%fused_dot.1, metadata={op_name="jit(f)/dot_general"}
"""


def test_analyze_overlap_finds_overlapped_window():
    from pmg_dolfinx_jax.utils.overlap import analyze_overlap

    events, n_overlapped = analyze_overlap(_HLO_OVERLAP)
    assert n_overlapped == 1, events
    assert [t.split()[0] for _, t in events] == [
        "contraction", "cp-start", "contraction",
        "cp-done(collective-permute-start)"]


def test_analyze_overlap_reports_serial_window():
    from pmg_dolfinx_jax.utils.overlap import analyze_overlap

    events, n_overlapped = analyze_overlap(_HLO_SERIAL)
    assert n_overlapped == 0, events
    assert len(events) == 4


@pytest.mark.parametrize("grid", [False, True])
def test_sharded_kron_apply_schedule_compiles(grid):
    """The overlap check compiles the sharded kron apply over the
    devices at hand (here 4 of the 8 virtual CPU devices): the scheduled
    HLO carries the halo permutes and the three axis contractions.
    (CPU collectives are synchronous, so no window exists here; the GPU
    schedule is read by examples/overlap_check.py.)"""
    from pmg_dolfinx_jax.utils.overlap import (
        analyze_overlap,
        scheduled_hlo_grid_kron_apply,
        scheduled_hlo_kron_apply,
    )

    if grid:
        hlo = scheduled_hlo_grid_kron_apply(shards=(2, 2, 1), nc=(4, 4, 2),
                                            P=2)
    else:
        hlo = scheduled_hlo_kron_apply(n_sh=4, nc=(8, 3, 3), P=2)
    assert "collective-permute" in hlo
    events, n_overlapped = analyze_overlap(hlo)
    assert sum(t.startswith("contraction") for _, t in events) >= 3, events
    assert n_overlapped == 0


def test_overlap_check_needs_enough_devices():
    from pmg_dolfinx_jax.utils.overlap import scheduled_hlo_kron_apply

    with pytest.raises(RuntimeError, match="need 64 devices"):
        scheduled_hlo_kron_apply(n_sh=64)

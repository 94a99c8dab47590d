"""Comm/compute overlap evidence for the sharded Kronecker apply.

Compiles the shard_map'd kron apply over the devices of this host (four
GPUs by default), reads the scheduled HLO, and checks whether each
async `collective-permute-start`/`-done` window contains at least one
of the independent contraction fusions — the compiler-scheduled
analogue of the reference's lcells/bcells overlap
(src/laplacian.hpp:378-455). README.md records what the H100 schedule
shows.

Run: python examples/overlap_check.py [--grid] [--dump FILE]
     (--cpu: dry run on virtual CPU devices, where collectives are
     synchronous and no window exists)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from _common import setup_jax  # noqa: E402


def main():
    setup_jax(argparse.Namespace(cpu="--cpu" in sys.argv, dtype="f32"),
              n_cpu_devices=4)
    from pmg_dolfinx_jax.utils.overlap import (
        analyze_overlap,
        scheduled_hlo_grid_kron_apply,
        scheduled_hlo_kron_apply,
    )

    if "--grid" in sys.argv:
        # (2,2,1) box decomposition: one ppermute pair per sharded axis,
        # each overlappable with the other terms.
        hlo = scheduled_hlo_grid_kron_apply()
    else:
        hlo = scheduled_hlo_kron_apply()
    if "--dump" in sys.argv:
        with open(sys.argv[sys.argv.index("--dump") + 1], "w") as fh:
            fh.write(hlo)
    events, n_overlapped = analyze_overlap(hlo)
    print("schedule order (line, event):")
    for i, tag in events:
        print(f"  {i:5d}  {tag}")
    print(f"\npermute windows with >=1 overlapped contraction: "
          f"{n_overlapped}")
    if n_overlapped >= 1:
        print("OVERLAP CONFIRMED: the halo ppermute is scheduled "
              "concurrently with independent contraction fusions "
              "(compiler-scheduled lcells/bcells analogue).")
    else:
        print("NO OVERLAP in this schedule — the explicit "
              "interior/boundary split would be needed.")


if __name__ == "__main__":
    main()

"""Phase 4-grid-procs of chip_smoke.py alone, once or several times.

Runs chip_smoke's phases 0 and 1, the records phase 4-grid-procs is held
to (phase 4-grid's sweep and exact paths, phase 4-fleet-grid), then phase
4-grid-procs once per entry of ``--omp``: the worker processes' intra-op
threads (``OMP_NUM_THREADS``; "default" leaves it unset).  Each run prints
the phase's JSON line after a ``VARIANT`` line; the script exits non-zero
if any check fails.  Needs one CUDA card:

    python3 chip_grid_procs.py                          # one run
    python3 chip_grid_procs.py --omp default,1,1,default
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--omp", default="default",
                    help="comma-separated OMP_NUM_THREADS of the workers, one run each")
    args = ap.parse_args()
    import chip_smoke as cs

    t0 = time.perf_counter()
    cs.phase0()
    cs.phase1()
    lut = cs.make_lut(cs.VoFODConfig().sensor)
    grid_launches, _ = cs.phase4_grid(lut)
    cs.phase4_grid(lut, "exact")
    cs.phase4_fleet_grid(lut, grid_launches)
    for omp in args.omp.split(","):
        if omp == "default":
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = str(int(omp))
        print("VARIANT", omp, flush=True)
        cs.phase4_grid_procs(lut)
    print(f"GRID_PROCS_OK {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

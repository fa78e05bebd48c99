"""Mask creation CLI — the create_mask.launch / MaskCreator nodelet analogue.

PyTorch-port counterpart of vofod_tpu/tools/create_mask.py.  Accumulates
pixels that never return across an NPZ scan recording on the device and
writes the FOV mask (ref src/mask_creator.cpp).

  python -m vofod_tpu_torch.tools.create_mask --scans recording.npz --out mask.npy \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scans", required=True)
    ap.add_argument("--out", required=True, help=".npy or .png")
    ap.add_argument("--rays", default="", help="HxW (default: infer square-ish)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the accumulator (default cuda; no fallback)")
    args = ap.parse_args(argv)

    import numpy as np

    from vofod_tpu_torch.io.scan_source import load_scans_npz
    from vofod_tpu_torch.runtime.mask_creator import MaskCreator

    ranges, _, _, _ = load_scans_npz(args.scans)
    n = ranges.shape[1]
    if args.rays:
        h, w = (int(v) for v in args.rays.lower().split("x"))
    else:
        h = 128 if n % 128 == 0 else 32
        w = n // h
    if h * w != n:
        ap.error(f"--rays {h}x{w} does not match scan size {n}")
    mc = MaskCreator(h, w, device=args.device)
    for r in ranges:
        mc.add_scan(np.asarray(r))
    mc.save(args.out)
    m = mc.mask()
    print(
        f"# {mc.n_scans} scans -> mask {h}x{w}, {int((m == 0).sum())} occluded px",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

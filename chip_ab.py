#!/usr/bin/env python3
"""Two trees of the port on one card, in turns.

    python3 chip_ab.py PARENT_DIR CHANGE_DIR [--order pccp] [--exact-pairs N]
                       [--out build/ab]

PARENT_DIR and CHANGE_DIR are checkouts of the repo (e.g. ``git archive``
unpacked into a git-ignored directory).  For each letter of ``--order``
(p: parent, c: change) the script times that tree's quirk-count kernels
(K13b ``quirk_counts``; K15b-6b ``quirk_columns``, ``quirk_ranks``,
``quirk_query`` on the slab with the most background of 3 shards) on a
flagship exact scan, then runs that tree's ``chip_smoke.py`` in full
(its log under ``--out``).  Each kernel gets its CUDA-event mean over 20
back-to-back calls (host work included where the host is slower) and,
from torch.profiler, its device-kernel ms, kernel launches and memsets a
call.  One JSON line per run, then a summary line of every run: those
kernel figures, each run's own chip_smoke kernel ms, and the exact and
grid-exact step p50 / p95 (phases 4-exact, 4-grid-exact) with their
device busy ms and idle share (phases 5-profile-exact,
5-profile-grid-exact).  With ``--exact-pairs N`` it then runs N pairs of
phase 4-exact alone (36 flagship scans of the reference-exact path, a
fresh process each), alternating which tree goes first, and reports each
run's step p50 / p95, the medians of both trees and the pairs each won.
Exits non-zero if any run fails.  Needs one GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# runs in the tree's root; prints one JSON line
_KERNEL_TIMES = r"""
import json
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")
import chip_smoke as cs
from vofod_tpu_torch import kernels
from vofod_tpu_torch.config import DynParams
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.pipeline.sepclusters import quirk_sure_counts
from vofod_tpu_torch.runtime.node import NodeOptions, VoFOD


def device_side(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms, n = {"kernel": 0.0, "memset": 0.0}, {"kernel": 0, "memset": 0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or "memcpy" in e.name.lower():
            continue
        kind = "memset" if "memset" in e.name.lower() else "kernel"
        ms[kind] += float(getattr(e, "device_time", None) or getattr(e, "cuda_time", 0.0)) / 1e3
        n[kind] += 1
    return dict(device_ms=ms["kernel"] / reps, cuda_launches=n["kernel"] / reps,
                memset_ms=ms["memset"] / reps, memsets=n["memset"] / reps)


lut = cs.make_lut(cs.VoFODConfig().sensor)
cfg, dyn = cs.exact_config(), DynParams()
grid = GridSpec.from_config(cfg)
node = VoFOD(cfg, dyn, NodeOptions(raycast_mode="exact"), lut, device="cuda")
node.load_apriori_map(cs.apriori_ground())
for r, p in cs.scan_cycle(lut, 7)[:6]:
    node.process_scan(r, None, p)
vals = node.state.grid
bg, sure = vals > dyn.thr_new_obstacles, vals > dyn.thr_sure_obstacles
n, nv = cs.GRID_SHARDS, grid.n_voxels
nzl = grid.nz // n
sl = [slice(i * nzl, (i + 1) * nzl) for i in range(n)]
t = int(torch.stack([bg[x].sum() for x in sl]).argmax())
b1, s1 = bg[sl[t]].contiguous(), sure[sl[t]].contiguous()
blocks = torch.stack([kernels.quirk_columns(bg[x].contiguous(), sure[x].contiguous())
                      for x in sl])
u1, below1 = kernels.quirk_ranks(b1, s1, blocks, t, nv)
u = u1.clone()
calls = {
    "quirk_counts": lambda: quirk_sure_counts(bg, sure, 1),
    "quirk_columns": lambda: kernels.quirk_columns(b1, s1),
    "quirk_ranks": lambda: kernels.quirk_ranks(b1, s1, blocks, t, nv),
    "quirk_query": lambda: kernels.quirk_query(b1, 1, u, below1),
}
out = {name: dict(ms=cs.cuda_ms(fn), **device_side(fn)) for name, fn in calls.items()}
print(json.dumps(dict(bg_voxels=int(bg.sum()), slab=t, kernels=out)))
"""

# runs in the tree's root; prints phase 4-exact's JSON line
_EXACT_STEP = r"""
import sys

sys.path.insert(0, ".")
import chip_smoke as cs

cs.phase4_exact(cs.make_lut(cs.VoFODConfig().sensor))
"""

QUIRK = ("quirk_counts", "quirk_columns", "quirk_ranks", "quirk_query")


def phases(log: str) -> dict:
    """The JSON phase lines of a chip_smoke log, by phase (the last of each
    name, kernel lines by kernel name)."""
    got = {}
    for line in log.splitlines():
        if not line.startswith("{"):
            continue
        try:
            d = json.loads(line)
        except json.JSONDecodeError:
            continue
        ph = d.get("phase")
        if ph in ("2-kernel", "2-grid-kernel"):
            got[d["name"]] = d
        elif ph:
            got[ph] = d
    return got


def summarize(ph: dict) -> dict:
    ex, gx = ph.get("4-exact", {}), ph.get("4-grid-exact", {})
    pe, pg = ph.get("5-profile-exact", {}), ph.get("5-profile-grid-exact", {})
    return dict(
        smoke_kernel_ms={k: ph[k]["ms"] for k in QUIRK if k in ph},
        smoke_kernel_device_ms={k: ph[k].get("device_ms") for k in QUIRK if k in ph},
        exact_step_ms_p50=ex.get("step_ms_p50"), exact_step_ms_p95=ex.get("step_ms_p95"),
        exact_busy_ms=pe.get("device_busy_ms_per_scan"),
        exact_idle_share=pe.get("idle_share_of_unprofiled_step"),
        grid_exact_step_ms_p50=gx.get("step_ms_p50"), grid_exact_step_ms_p95=gx.get("step_ms_p95"),
        grid_exact_busy_ms=pg.get("device_busy_ms_per_scan"),
        grid_exact_idle_share=pg.get("idle_share_of_unprofiled_step"),
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--order", default="pccp")
    ap.add_argument("--exact-pairs", type=int, default=0)
    ap.add_argument("--out", type=Path, default=Path("build/ab"))
    args = ap.parse_args()
    trees = {"p": args.parent.resolve(), "c": args.change.resolve()}
    args.out.mkdir(parents=True, exist_ok=True)
    runs, ok = [], True
    for i, tag in enumerate(args.order):
        tree, name = trees[tag], {"p": "parent", "c": "change"}[tag]
        k = subprocess.run([sys.executable, "-c", _KERNEL_TIMES], cwd=tree, capture_output=True,
                           text=True, timeout=600)
        lines = k.stdout.strip().splitlines()
        kern = json.loads(lines[-1]) if k.returncode == 0 and lines else {"error": k.stderr[-2000:]}
        s = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, capture_output=True,
                           text=True, timeout=1200)
        (args.out / f"{i}-{name}.log").write_text(s.stdout + "\n--- stderr ---\n" + s.stderr)
        last = s.stdout.strip().splitlines()[-1:] or [""]
        run = dict(run=i, tree=name, kernel_times=kern, smoke_rc=s.returncode,
                   smoke_last_line=last[0], **summarize(phases(s.stdout)))
        ok = ok and k.returncode == 0 and s.returncode == 0
        print(json.dumps(run), flush=True)
        runs.append(run)
    pairs = []
    for i in range(args.exact_pairs):
        p50 = {}
        for tag in ("pc" if i % 2 == 0 else "cp"):
            e = subprocess.run([sys.executable, "-c", _EXACT_STEP], cwd=trees[tag],
                               capture_output=True, text=True, timeout=600)
            got = phases(e.stdout).get("4-exact", {})
            ok = ok and e.returncode == 0 and bool(got)
            p50[tag] = got.get("step_ms_p50")
            print(json.dumps(dict(pair=i, tree={"p": "parent", "c": "change"}[tag], rc=e.returncode,
                                  exact_step_ms_p50=p50[tag],
                                  exact_step_ms_p95=got.get("step_ms_p95"))), flush=True)
        pairs.append(p50)
    out = {"summary": runs, "ok": ok}
    if pairs and ok:
        med = {t: sorted(p[t] for p in pairs)[len(pairs) // 2] for t in "pc"}
        out["exact_pairs"] = dict(pairs=len(pairs), parent_median=med["p"], change_median=med["c"],
                                  change_faster=sum(p["c"] < p["p"] for p in pairs),
                                  parent_faster=sum(p["p"] < p["c"] for p in pairs))
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

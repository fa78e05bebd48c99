#!/usr/bin/env python3
"""Two trees of the port on one card, in turns.

    python3 chip_ab.py PARENT_DIR CHANGE_DIR [--order pccp] [--exact-pairs N]
                       [--grid-exact-pairs N] [--out build/ab]

PARENT_DIR and CHANGE_DIR are checkouts of the repo (e.g. ``git archive``
unpacked into a git-ignored directory).  For each letter of ``--order``
(p: parent, c: change) the script times that tree's K15b-1 halo exchange
at the grid paths' shapes (shard 1 of 3 of the flagship grid): what one
sharded K2 sweep spends on its halo (the change: the in-place fill of a
halo'd buffer; a tree without it: the out-of-place exchange and, gated,
the clone of the extended slab), int32 labels at r = 3 and uint8 reach at
r = 2, the out-of-place exchange at r = 3 and the explore pad's f32 r =
16, and ``torch.cat`` of the same extended slab; each with its CUDA-event
mean over 20 back-to-back calls (host work included where the host is
slower) and, from torch.profiler, its device-kernel ms, kernel launches
and memcpys a call.  Then it profiles 5 scans of the grid and grid-exact
paths (as chip_smoke phase 5: a fresh node, the apriori plane, 6 warm-up
scans): K15b-1's launches and device ms a scan, the direct_copy kernels
and device-to-device memcpys a scan, and the device busy ms.  Then it
runs that tree's ``chip_smoke.py`` in full (its log under ``--out``).
One JSON line per run, then a summary line of every run: those figures
and the exact and grid-exact step p50 / p95 (phases 4-exact,
4-grid-exact) with their device busy ms and idle share (phases
5-profile-exact, 5-profile-grid-exact).  With ``--exact-pairs N`` /
``--grid-exact-pairs N`` it then runs N pairs of phase 4-exact /
4-grid-exact alone (36 flagship scans of the reference-exact path, dense
or over 3 shards, a fresh process each), alternating which tree goes
first, and reports each run's step p50 / p95, the medians of both trees
and the pairs each won.  Exits non-zero if any run fails.  Needs one GPU.
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
from functools import partial

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")
import chip_smoke as cs
from vofod_tpu_torch import kernels
from vofod_tpu_torch.config import DynParams
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.runtime.node import NodeOptions, VoFOD


def device_side(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms, n = {"kernel": 0.0, "memcpy": 0.0}, {"kernel": 0, "memcpy": 0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or "memset" in e.name.lower():
            continue
        kind = "memcpy" if "memcpy" in e.name.lower() else "kernel"
        ms[kind] += float(getattr(e, "device_time", None) or getattr(e, "cuda_time", 0.0)) / 1e3
        n[kind] += 1
    return dict(device_ms=ms["kernel"] / reps, cuda_launches=n["kernel"] / reps,
                memcpy_ms=ms["memcpy"] / reps, memcpys=n["memcpy"] / reps)


def grid_profile(lut, exact, n=5):
    cfg = cs.exact_config() if exact else cs.VoFODConfig()
    opts = NodeOptions(raycast_mode="exact") if exact else NodeOptions()
    node = VoFOD(cfg, DynParams(), opts, lut, device="cuda")
    node.load_apriori_map(cs.apriori_ground())
    drv = (cs.GridDriver(lut, node.state, cfg, raycast_mode="exact") if exact
           else cs.GridDriver(lut, node.state))
    scans = cs.scan_cycle(lut, 6 + n)
    for r, p in scans[:6]:
        drv.process_scan(r, None, p)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for r, p in scans[6:]:
            drv.process_scan(r, None, p)
        torch.cuda.synchronize()
    out = {"busy_ms": 0.0}
    for key in ("k15b1", "direct_copy", "memcpy_dtod"):
        out[key + "_launches"] = 0
        out[key + "_ms"] = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = float(getattr(e, "device_time", None) or getattr(e, "cuda_time", 0.0))
        out["busy_ms"] += us / 1e3 / n
        low = e.name.lower()
        for key, match in (("k15b1", "halo_exchange_kernel"), ("direct_copy", "direct_copy"),
                           ("memcpy_dtod", "memcpy dtod")):
            if match in low:
                out[key + "_launches"] += 1 / n
                out[key + "_ms"] += us / 1e3 / n
    return out


lut = cs.make_lut(cs.VoFODConfig().sensor)
cfg, dyn = cs.VoFODConfig(), DynParams()
grid = GridSpec.from_config(cfg)
node = VoFOD(cfg, dyn, NodeOptions(), lut, device="cuda")
node.load_apriori_map(cs.apriori_ground())
for r, p in cs.scan_cycle(lut, 7)[:6]:
    node.process_scan(r, None, p)
vals = node.state.grid
keys = torch.where(vals > dyn.thr_new_obstacles,
                   torch.arange(grid.n_voxels, dtype=torch.int32, device="cuda")
                   .reshape(grid.shape), cs.SENTINEL)
reach = (vals > dyn.thr_new_obstacles).to(torch.uint8)
nzl = grid.nz // cs.GRID_SHARDS
z0 = nzl  # shard 1 of 3
in_place = hasattr(kernels, "halo_fill_")
calls = {}
for name, g, h, fill in (("int32_r3", keys, 3, cs.SENTINEL), ("uint8_r2", reach, 2, 0),
                         ("f32_r16", vals, 16, -1e30)):
    slab = g[z0:z0 + nzl].contiguous()
    lo, hi = [g[z0 - h:z0].contiguous()], [g[z0 + nzl:z0 + nzl + h].contiguous()]
    ext = cs._global_ext(g, z0, nzl, h, fill).contiguous()
    calls[name + "_out_of_place"] = partial(kernels.halo_exchange, slab, lo, hi, [h], fill)
    calls[name + "_cat"] = partial(torch.cat, lo + [slab] + hi)
    if name == "f32_r16":
        continue
    if in_place:  # one sweep's halo: only the halo rows of a halo'd buffer
        calls[name + "_sweep"] = partial(kernels.halo_fill_, ext, h, lo, hi, [h], fill)
    else:  # a tree without that form: the whole extended slab, then (gated) its clone
        calls[name + "_sweep"] = (
            lambda slab=slab, lo=lo, hi=hi, h=h, fill=fill: kernels.halo_exchange(
                slab, lo, hi, [h], fill).clone())
out = {name: dict(ms=cs.cuda_ms(fn), **device_side(fn)) for name, fn in calls.items()}
prof = {"grid": grid_profile(lut, False), "grid_exact": grid_profile(lut, True)}
print(json.dumps(dict(in_place=in_place, halo=out, profiles=prof)))
"""

# runs in the tree's root; prints phase 4-exact's JSON line
_EXACT_STEP = r"""
import sys

sys.path.insert(0, ".")
import chip_smoke as cs

cs.phase4_exact(cs.make_lut(cs.VoFODConfig().sensor))
"""

# runs in the tree's root; prints phase 4-grid-exact's JSON line
_GRID_EXACT_STEP = r"""
import sys

sys.path.insert(0, ".")
import chip_smoke as cs

cs.phase4_grid(cs.make_lut(cs.VoFODConfig().sensor), "exact")
"""

HALO_CASES = ("inplace_int32_r3", "inplace_uint8_r2", "f32_r16")
PAIR_MODES = {"exact": (_EXACT_STEP, "4-exact", "dense"),
              "grid_exact": (_GRID_EXACT_STEP, "4-grid-exact", "grid")}


def phases(log: str) -> dict:
    """The JSON phase lines of a chip_smoke log, by phase (the last of each
    name, kernel lines by kernel name, 2-grid-halo lines by case)."""
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
        elif ph == "2-grid-halo":
            got[d["case"]] = d
        elif ph:
            got[ph] = d
    return got


def summarize(ph: dict) -> dict:
    ex, gx = ph.get("4-exact", {}), ph.get("4-grid-exact", {})
    pe, pg = ph.get("5-profile-exact", {}), ph.get("5-profile-grid-exact", {})
    return dict(
        smoke_halo={k: {m: ph[k].get(m) for m in ("ms", "device_ms", "library_ms", "bound_ms")}
                    for k in HALO_CASES if k in ph},
        smoke_halo_exchange_ms=ph.get("halo_exchange", {}).get("ms"),
        exact_step_ms_p50=ex.get("step_ms_p50"), exact_step_ms_p95=ex.get("step_ms_p95"),
        exact_busy_ms=pe.get("device_busy_ms_per_scan"),
        exact_idle_share=pe.get("idle_share_of_unprofiled_step"),
        grid_exact_step_ms_p50=gx.get("step_ms_p50"), grid_exact_step_ms_p95=gx.get("step_ms_p95"),
        grid_exact_busy_ms=pg.get("device_busy_ms_per_scan"),
        grid_exact_idle_share=pg.get("idle_share_of_unprofiled_step"),
        grid_exact_label_sweeps=sum(gx.get("label_sweeps_per_scan") or []),
        grid_exact_capped_scans=gx.get("capped_scans"),
    )


def run_pairs(trees: dict, mode: str, n: int) -> tuple[dict | None, bool]:
    """``n`` pairs of one step phase alone, alternating which tree goes
    first: each run's p50 / p95 and both trees' medians."""
    script, phase, key = PAIR_MODES[mode]
    pairs, ok = [], True
    for i in range(n):
        p50 = {}
        for tag in ("pc" if i % 2 == 0 else "cp"):
            e = subprocess.run([sys.executable, "-c", script], cwd=trees[tag],
                               capture_output=True, text=True, timeout=900)
            got = phases(e.stdout).get(phase, {})
            ok = ok and e.returncode == 0 and bool(got)
            p50[tag] = got.get("step_ms_p50", {}).get(key)
            print(json.dumps(dict(mode=mode, pair=i, tree={"p": "parent", "c": "change"}[tag],
                                  rc=e.returncode, step_ms_p50=p50[tag],
                                  step_ms_p95=got.get("step_ms_p95", {}).get(key))), flush=True)
        pairs.append(p50)
    if not (pairs and ok):
        return None, ok
    med = {t: sorted(p[t] for p in pairs)[len(pairs) // 2] for t in "pc"}
    return dict(pairs=len(pairs), parent_median=med["p"], change_median=med["c"],
                change_faster=sum(p["c"] < p["p"] for p in pairs),
                parent_faster=sum(p["p"] < p["c"] for p in pairs)), ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--order", default="pccp")
    ap.add_argument("--exact-pairs", type=int, default=0)
    ap.add_argument("--grid-exact-pairs", type=int, default=0)
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
    out = {"summary": runs}
    for mode, n in (("exact", args.exact_pairs), ("grid_exact", args.grid_exact_pairs)):
        if n:
            out[mode + "_pairs"], mode_ok = run_pairs(trees, mode, n)
            ok = ok and mode_ok
    out["ok"] = ok
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

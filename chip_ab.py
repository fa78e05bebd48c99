#!/usr/bin/env python3
"""Two trees of the port on one card, in turns.

    python3 chip_ab.py PARENT_DIR CHANGE_DIR [--order pccp] [--exact-pairs N]
                       [--grid-exact-pairs N] [--demote-only] [--compact-gate-only]
                       [--explore-only] [--ray-detect-only] [--variants all|NAME,...]
                       [--ray-detect-variants all|NAME,...] [--out build/ab]

PARENT_DIR and CHANGE_DIR are checkouts of the repo (e.g. ``git archive``
unpacked into a git-ignored directory).  For each letter of ``--order``
(p: parent, c: change) the script times that tree's kernels on a flagship
node's state (6 warm-up scans), each with its CUDA-event mean over 20
back-to-back calls (host work included where the host is slower) and,
from torch.profiler, its device-kernel ms, kernel launches and memcpys a
call:

- K1's two sweep-path calls (bg_near, int8 max r3; the local sure count,
  int32 sum r3), K14's two calls at the dynamic path's 2.0 / 1.9 m radii
  (int8 max at bound 4, r² 16; int32 sum at bound 5, r² 25), and K15a on a
  flagship scan's packed grid beside ``torch.bitwise_and`` + ``torch.ge``
  into preallocated outputs;
- the K15a wrapper's host profile: ``time.perf_counter_ns`` around 1,000
  calls of each step of ``kernels.unpack`` (and of the whole wrapper, the
  frontend's ``unpack`` and the two torch ops) with no sync;
- K15b-1's halo exchange at the grid paths' shapes (shard 1 of 3 of the
  flagship grid): what one sharded K2 sweep spends on its halo (a tree
  with the in-place fill: that fill of a halo'd buffer; one without it:
  the out-of-place exchange and its clone), int32 labels at r = 3 and
  uint8 reach at r = 2, the out-of-place exchange at r = 3 and the explore
  pad's f32 r = 16, and ``torch.cat`` of the same extended slab;
- K9 on the sweep scan's far list and on synthetic far lists at F = 2048,
  8192 and 20000 (> K clusters, long label ties; the parent refuses F >
  16384), with each of its kernels' device ms and its memsets a call, and
  its wrapper's host us a call over 1,000 calls;
- the DDA walk (K12) on a flagship exact scan's rays and K15b-6c on each
  of the 3 shards' rows;
- K11's demotion EMA and K13c on the inputs the step passes them (its
  calls recorded on the 7th scan of a fresh node): K11 in cases (a) the
  sweep step's, r 1.6 (19 taps, halo 1), (b) the dynamic step's shells at
  2.0 / 1.9 m (bound 4, r² 14.44) and (c) (a)'s inputs at halo 7 (r 7.99,
  2,103 taps), K13c in (d) the exact step's (leaf size 1), (e) the exact
  step's at 1.2 m (leaf size 2) and (f) the grid-exact step's on shard 1
  of 3; and where every tile pools, (a) on random masks and (d) on random
  cells; each checked bit-equal to its plain version, with the schedule
  the card chose, beside K1 on the same 0/1 mask and taps (the stencil
  alone) and one elementwise kernel moving the call's bytes (the floor).
  ``--demote-only`` runs these cases alone;
- K6 and K5a on the inputs the sweep step passes them (the wrappers'
  calls recorded on the 7th scan of a fresh node: the frontend's 131,072
  -> 4,096 hits, the far voxels 2.47 M -> 2,048, the query form 2.47 M ->
  256, the gate), each checked against its plain version (K6 bit-equal, K5a
  within chip_smoke.K5A_TOL), with its device ms, launches and memsets a
  call, the wrapper's host us a call over 1,000 calls with no sync, the sum
  of the three K6 calls, ``torch.nonzero`` of each K6 mask beside it, and
  the host us of the K6 wrapper's pieces (its allocations in three forms:
  four, three, one with its views; the look-back state's pick).
  ``--compact-gate-only`` runs these cases alone.  ``--variants`` then
  builds variants of the change tree's K6 and K5a (their schedule's
  constants edited in the source text: K6's threads and chunks a thread,
  K5a's block size and cluster size, clusters of one pooling the whole
  image) and times them on the same calls (``_COMPACT_GATE_VARIANTS``).

- K7 and K8 on the inputs the steps pass them (the wrappers' calls on the
  7th to 11th scans of a fresh node, the scans the smoke's phase 5
  profiles: K7 and K8 of the sweep step, K7 of the exact step), each
  checked against its plain version (bit-equal: K7's outputs; K8's grid,
  count and, where K8 gives it, cluster_connected), with its device ms,
  launches and other device ops (a fill, a memset) a call, the wrapper's
  host us a call over 1,000 calls with no sync, and the means over the
  five scans.  ``--explore-only`` runs these cases alone.
- K10 and K5b on the inputs the sweep step passes them (the wrappers'
  calls on the 7th to 11th scans of a fresh node), each checked against
  its plain version (K10: valid, ids and the counter bit-equal, the floats
  within chip_smoke's bounds; K5b on a fresh copy of its grid every call,
  the changed voxels bit-equal), with its device ms, launches and other
  device ops a call, the wrapper's host us a call over 1,000 calls with no
  sync, and the means over the five scans.  ``--ray-detect-only`` runs
  these cases alone.  ``--ray-detect-variants`` then builds variants of
  both trees' K10 and K5b (the windows skipped, the loads alone, tiles,
  warps, staged faces, packing, where the time goes; edited in the source
  text, ``_RAY_DETECT_VARIANTS``) and times them on the same calls.

Then it profiles 5 scans of the sweep, prebinned, dynamic (2.0 / 1.9 m)
and exact paths (K1, K14, K15a, K9, the DDA walk, K11's demotion and K13c's
device ms and launches a scan) and of the grid and grid-exact paths
(K15b-1's, K11's and K13c's launches and device ms a scan, the direct_copy
kernels and device-to-device memcpys, the busy ms), each from a fresh node after the
apriori plane and 6 warm-up scans, as chip_smoke phase 5 does.  Then it
runs that tree's ``chip_smoke.py`` in full (its log under ``--out``).  One
JSON line per run, then a summary line of every run (also written to
``--out``/summary.json): those figures and,
from the smoke, the step p50 / p95 of the sweep, prebinned, dynamic, exact
and grid-exact paths (phases 4-*) with every profiled path's device busy
ms, idle share and each port kernel's device ms and launches a scan
(phases 5-profile-*).  With
``--exact-pairs N`` / ``--grid-exact-pairs N`` it then runs N pairs of
phase 4-exact / 4-grid-exact alone (36 flagship scans of the
reference-exact path, dense or over 3 shards, a fresh process each),
alternating which tree goes first, and reports each run's step p50 / p95,
the medians of both trees and the pairs each won.  Exits non-zero if any
run fails.  Needs one GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# runs in the tree's root; prints one JSON line
_KERNEL_TIMES = r"""
import ctypes
import json
import re
import sys
import time
from functools import partial

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")
import chip_smoke as cs
from vofod_tpu_torch import kernels
from vofod_tpu_torch.config import DynParams
from vofod_tpu_torch.io.binner import HostBinner
from vofod_tpu_torch.ops import morphology as tm
from vofod_tpu_torch.pipeline.frontend import unpack
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


# kernel families a dense scan profile counts, by their kernels' names (K9:
# the parent's rank and stats passes, the sort's one launch or four chunked)
DENSE_KERNELS = {"ball_pool": ("ball_pool_kernel",), "unpack": ("unpack_kernel",),
                 "k9": ("rank_kernel", "stats_kernel", "slots_kernel", "chunk_"),
                 "dda_walk": ("dda_kernel",), "dda_round": ("round_kernel",),
                 "k11_demote": ("demote_ema_kernel",), "k13c": ("exact_demote_kernel",)}


def kernel_side(fn, reps=20):
    # device ms a call of each kernel name fn launches, and its memsets
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"(\w+)(?:<[^(]*>)?\(", e.name)
        name = m.group(1) if m else e.name[:40]
        ms, k = by.get(name, (0.0, 0))
        by[name] = (ms + float(getattr(e, "device_time", None) or getattr(e, "cuda_time", 0.0))
                    / 1e3 / reps, k + 1 / reps)
    return {name: dict(device_ms=round(ms, 5), per_call=k) for name, (ms, k) in by.items()}


def k9_far_list(grid, F, n_far, seed):
    # a far list of capacity F with ~n_far far voxels in > K clusters: a copy
    # of chip_smoke.synthetic_far_list, kept here because a tree from before
    # K9's chunked path has no such function.  48 compact clusters and
    # scattered voxels in ties of 100 labels
    rng = np.random.default_rng(seed)
    far, labels = cs.synthetic_far(grid, 48, seed)
    bg = rng.choice(grid.n_voxels, max(n_far - int(far.sum()), 0), replace=False)
    bg = bg[~far.reshape(-1)[bg]]
    far.reshape(-1)[bg] = True
    labels.reshape(-1)[bg] = cs.SENTINEL - 1 - rng.integers(0, 100, len(bg))
    fids, fvalid, ftotal = cs.masked_compact_plain(torch.as_tensor(far, device="cuda"), F)
    return fids, fvalid, torch.as_tensor(labels, device="cuda").reshape(-1)[fids.long()], ftotal


def dense_profile(lut, path, n=5):
    # K1, K14 and K15a device ms and launches a scan over n profiled scans of
    # a dense path from a fresh node (its busy ms: the smoke's phase 5)
    cfg, opts = cs.VoFODConfig(), NodeOptions()
    if path == "prebinned":
        opts = NodeOptions(frontend_mode="prebinned")
    elif path == "dynamic":
        cfg = cs.dynamic_config()
    elif path == "exact":
        cfg, opts = cs.exact_config(), NodeOptions(raycast_mode="exact")
    node = VoFOD(cfg, DynParams(), opts, lut, device="cuda")
    if path == "dynamic":
        node.update_params(ground_points_max_distance=2.0, sepclusters_max_bg_distance=1.9)
    node.load_apriori_map(cs.apriori_ground())
    scans = cs.scan_cycle(lut, 6 + n)
    for r, p in scans[:6]:
        node.process_scan(r, None, p)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for r, p in scans[6:]:
            node.process_scan(r, None, p)
        torch.cuda.synchronize()
    out = {}
    for key in DENSE_KERNELS:
        out[key + "_launches"] = 0
        out[key + "_ms"] = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = float(getattr(e, "device_time", None) or getattr(e, "cuda_time", 0.0))
        for key, names in DENSE_KERNELS.items():
            if any(m in e.name for m in names):
                out[key + "_launches"] += 1 / n
                out[key + "_ms"] += us / 1e3 / n
    return out


def host_us(fn, n=1000):
    # host microseconds a call over n calls with no sync, after 50
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    dt = (time.perf_counter_ns() - t0) / n / 1e3
    torch.cuda.synchronize()
    return round(dt, 3)


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
    for key in ("k15b1", "direct_copy", "memcpy_dtod", "k11_demote", "k13c"):
        out[key + "_launches"] = 0
        out[key + "_ms"] = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = float(getattr(e, "device_time", None) or getattr(e, "cuda_time", 0.0))
        out["busy_ms"] += us / 1e3 / n
        low = e.name.lower()
        for key, match in (("k15b1", "halo_exchange_kernel"), ("direct_copy", "direct_copy"),
                           ("memcpy_dtod", "memcpy dtod"), ("k11_demote", "demote_ema_kernel"),
                           ("k13c", "exact_demote_kernel")):
            if match in low:
                out[key + "_launches"] += 1 / n
                out[key + "_ms"] += us / 1e3 / n
    return out


import numpy as np
from vofod_tpu_torch.ops.raycast import raycast_dda, raycast_dda_slab
from vofod_tpu_torch.pipeline import classify as tcls
from vofod_tpu_torch.pipeline.step import exact_rays

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
# K1 (bg_near, the local sure count), K14 at 2.0 / 1.9 m, K15a
bg8 = (vals > dyn.thr_new_obstacles).to(torch.int8)
sure = (vals > dyn.thr_sure_obstacles).to(torch.int32)
r_np, p_np = cs.scan_cycle(lut, 7)[6]
packed = torch.as_tensor(HostBinner(cfg, lut).bin(r_np, p_np).packed, device="cuda")
lc, lb = torch.empty_like(packed, dtype=torch.int32), torch.empty_like(packed, dtype=torch.bool)
two_ops = lambda: (torch.bitwise_and(packed, 0x3F, out=lc), torch.ge(packed, 0x80, out=lb))
pools = {"k1_int8_max_r3": partial(tm.ball_pool, bg8, 3.0, "max", 0),
         "k1_int32_sum_r3": partial(tm.ball_pool, sure, 3.0, "sum", 0),
         "k14_int8_max_b4_r2_16": partial(tm.shell_pool, bg8, 16.0, 4.0, "max", 0),
         "k14_int32_sum_b5_r2_25": partial(tm.shell_pool, sure, 25.0, 5.0, "sum", 0),
         "k15a_unpack": partial(unpack, packed), "k15a_two_torch_ops": two_ops}
kern = {name: dict(ms=cs.cuda_ms(fn), **device_side(fn)) for name, fn in pools.items()}
lib, n = kernels.load(), packed.numel()
stream = kernels._stream()
host = {
    "frontend.unpack": partial(unpack, packed), "kernels.unpack": partial(kernels.unpack, packed),
    "two torch ops": two_ops,
    "_require": partial(kernels._require, packed, "unpack packed", torch.uint8),
    "numel": packed.numel, "load()": kernels.load, "_stream()": kernels._stream,
    "torch.empty x2 (device=packed.device)": lambda: (
        torch.empty(packed.shape, dtype=torch.int32, device=packed.device),
        torch.empty(packed.shape, dtype=torch.bool, device=packed.device)),
    "torch.empty_like x2": lambda: (torch.empty_like(packed, dtype=torch.int32),
                                    torch.empty_like(packed, dtype=torch.bool)),
    "data_ptr x3": lambda: (packed.data_ptr(), lc.data_ptr(), lb.data_ptr()),
    "launch (ctypes, outputs given)": lambda: lib.vofod_unpack(
        packed.data_ptr(), lc.data_ptr(), lb.data_ptr(), n, stream),
    "_count": partial(kernels._count, "unpack"),
}
host = {k: host_us(f) for k, f in host.items()}
# K9 on the sweep scan's far list (the node's state after 6 scans) and on
# synthetic far lists at F = 2048, 8192 and 20000 (the parent refuses
# F > 16384); its wrapper's host us a call
from vofod_tpu_torch.pipeline.background import split_and_update
true = torch.ones((), dtype=torch.bool, device="cuda")
K = cfg.max_clusters
r6, p6 = cs.scan_cycle(lut, 7)[6]
pose6 = torch.as_tensor(p6, device="cuda")
k3 = cs.frontend_bin(cfg, grid, torch.as_tensor(lut.directions, device="cuda"),
                     torch.as_tensor(lut.offsets, device="cuda"),
                     torch.as_tensor(r6.astype(np.float32), device="cuda"), pose6)
bg = split_and_update(cfg, dyn, vals, k3[0], node.state.bg_sufficient)
fids, fvalid, ftotal = cs.masked_compact_plain(bg.far, cfg.max_far_voxels)
k9_args = {"sweep_scan": (fids, fvalid, bg.labels.reshape(-1)[fids.long()], ftotal,
                          pose6[:3, 3].contiguous(), bg.bg_sufficient, true)}
for F in (2048, 8192, 20000):
    k9_args[f"F{F}"] = (*k9_far_list(grid, F, F - 600, F), pose6[:3, 3].contiguous(), true, true)
k9 = {}
capped = not hasattr(kernels, "K9_SMEM_KEYS")  # a tree whose K9 refuses F > 16384
for name, args in k9_args.items():
    fn = partial(tcls.cluster_stats, dyn, grid, K, *args)
    if capped and args[0].shape[0] > 16384:
        try:
            fn()
        except (RuntimeError, ValueError) as e:
            k9[name] = dict(refused=str(e)[:200])
            continue
    k9[name] = dict(ms=cs.cuda_ms(fn), **cs.device_profile(fn), kernels=kernel_side(fn),
                    n_far=int(args[3]))
# host us on the list's first 64 voxels, so that the device keeps up
small = tuple(t[:64] for t in k9_args["sweep_scan"][:3]) + k9_args["sweep_scan"][3:]
wrap = partial(kernels.cluster_stats, small[0], small[1], small[2], K, grid.origin,
               grid.voxel_size, (dyn.cls_min_points, dyn.cls_max_distance, dyn.cls_max_size,
                                 dyn.cls_max_explore_distance), small[4], small[5], small[6],
               small[3], grid_yx=(grid.ny, grid.nx))
gates = (dyn.cls_min_points, dyn.cls_max_distance, dyn.cls_max_size,
         dyn.cls_max_explore_distance)
k9_host = {"kernels.cluster_stats": host_us(wrap),
           "classify.cluster_stats": host_us(partial(tcls.cluster_stats, dyn, grid, K, *small)),
           "torch.empty": host_us(lambda: torch.empty(K, device="cuda")),
           "15 x torch.empty": host_us(lambda: [torch.empty(K, device="cuda")
                                                for _ in range(15)]),
           "host constants built": host_us(lambda: [
               a.ctypes.data_as(ctypes.c_void_p)
               for a in (np.array([*grid.origin, grid.voxel_size], dtype=np.float32),
                         np.array(gates, dtype=np.float32))])}
if hasattr(kernels, "_stats_host"):  # the change's cache of them
    k9_host["host constants cached"] = host_us(
        partial(kernels._stats_host, grid.origin, grid.voxel_size, gates))
# the DDA walk on a flagship exact scan's rays (6 warm-up scans of the exact
# path), dense and each shard's rows (K15b-6c; shard 0 holds the sensor)
ecfg = cs.exact_config()
enode = VoFOD(ecfg, dyn, NodeOptions(raycast_mode="exact"), lut, device="cuda")
enode.load_apriori_map(cs.apriori_ground())
for r, p in cs.scan_cycle(lut, 7)[:6]:
    enode.process_scan(r, None, p)
H, W = lut.height, lut.width
rays = exact_rays(ecfg, dyn, grid, torch.as_tensor(lut.directions, device="cuda"),
                  torch.as_tensor(lut.offsets, device="cuda"),
                  torch.ones(H * W, dtype=torch.bool, device="cuda"),
                  torch.as_tensor(r6.astype(np.float32), device="cuda") * 0.001,
                  torch.ones(H * W, dtype=torch.float32, device="cuda"), pose6)
bound = ecfg.raycast_max_distance_bound
walks = {"dda_exact_scan": partial(raycast_dda, grid, *rays, bound),
         **{f"dda_slab_shard{i}": partial(raycast_dda_slab, grid, *rays, bound, (i * nzl, nzl))
            for i in range(cs.GRID_SHARDS)}}
dda = {name: dict(ms=cs.cuda_ms(fn), **cs.device_profile(fn), kernels=kernel_side(fn))
       for name, fn in walks.items()}
prof = {"grid": grid_profile(lut, False), "grid_exact": grid_profile(lut, True),
        **{p: dense_profile(lut, p) for p in ("sweep", "prebinned", "dynamic", "exact")}}
print(json.dumps(dict(in_place=in_place, halo=out, kernels=kern, k15a_host_us=host,
                      k9=k9, k9_host_us=k9_host, dda=dda, profiles=prof)))
"""

# The inputs of K11's demotion and K13c as the step passes them (its
# sepclusters stage's calls of the two wrappers, recorded on the 7th scan of
# a path from a fresh node after the apriori plane); exec'd by the demotion
# cases below and by demote_probe.py: demote_inputs(cs) -> {case: (kind,
# args)}, kind "k11" (sepclusters.demote_ema's args) or "k13c"
# (sepclusters.exact_demote_ema's)
DEMOTE_INPUTS = r"""
import dataclasses

import torch

from vofod_tpu_torch.config import DynParams
from vofod_tpu_torch.ops import morphology as tm
from vofod_tpu_torch.pipeline import sepclusters as ts
from vofod_tpu_torch.runtime.node import NodeOptions, VoFOD


def step_calls(cs, lut, name, cfg, opts=None, dyn_radii=None, grid=False):
    node = VoFOD(cfg, DynParams(), opts or NodeOptions(), lut, device="cuda")
    if dyn_radii:
        node.update_params(ground_points_max_distance=dyn_radii[0],
                           sepclusters_max_bg_distance=dyn_radii[1])
    node.load_apriori_map(cs.apriori_ground())
    if grid:
        node = cs.GridDriver(lut, node.state, cfg, raycast_mode="exact")
    scans = cs.scan_cycle(lut, 7)
    for r, p in scans[:6]:
        node.process_scan(r, None, p)
    orig, got = getattr(ts, name), []

    def record(*a):
        got.append(tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in a))
        return orig(*a)

    setattr(ts, name, record)
    try:
        node.process_scan(scans[6][0], None, scans[6][1])
        torch.cuda.synchronize()
    finally:
        setattr(ts, name, orig)
    return got


def demote_inputs(cs):
    lut = cs.make_lut(cs.VoFODConfig().sensor)
    a = step_calls(cs, lut, "demote_ema", cs.VoFODConfig())[0]
    ex = cs.exact_config()
    opts = NodeOptions(raycast_mode="exact")
    shard = [c for c in step_calls(cs, lut, "exact_demote_ema", ex, opts, grid=True)
             if c[11][0] == ex.grid_shape[0] // cs.GRID_SHARDS]
    return {
        "a": ("k11", a),
        "b": ("k11", step_calls(cs, lut, "demote_ema", cs.dynamic_config(),
                                dyn_radii=(2.0, 1.9))[0]),
        "c": ("k11", a[:4] + (7.99,) + a[5:]),
        "d": ("k13c", step_calls(cs, lut, "exact_demote_ema", ex, opts)[0]),
        "e": ("k13c", step_calls(cs, lut, "exact_demote_ema",
                                 dataclasses.replace(ex, sepclusters_max_bg_distance=1.2),
                                 opts)[0]),
        "f": ("k13c", shard[0]),
    }
"""

# runs in the tree's root; prints one JSON line: K11's demotion in cases
# (a) the sweep step's call, (b) the dynamic step's at 2.0 / 1.9 m, (c) (a)'s
# inputs at halo 7, and K13c in (d) the exact step's call (leaf 1), (e) at
# 1.2 m (leaf 2), (f) the grid-exact step's call on shard 1 of 3; and, where
# every tile pools, (a) on random masks and (d) on random cells; each checked
# bit-equal to its plain version, beside K1 on the same 0/1 mask and taps
# (the stencil alone) and one elementwise kernel moving the call's bytes
# (the floor)
_DEMOTE_CASES = DEMOTE_INPUTS + r"""
import json
import math
import subprocess
import sys

import numpy as np

sys.path.insert(0, ".")
import chip_smoke as cs
from vofod_tpu_torch import kernels

dev = torch.device("cuda")


def timed(fn):
    return dict(ms=cs.cuda_ms(fn), **cs.device_profile(fn))


def copy_floor(n_bytes):
    # one elementwise kernel reading and writing half the call's bytes each
    src = torch.ones(n_bytes // 8, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    return timed(lambda: torch.mul(src, 1.0, out=dst))


def schedule(name, *args):
    fn = getattr(kernels, name + "_schedule", None)  # the run-table kernels only
    return None if fn is None else fn(*args)[-1]


inputs = demote_inputs(cs)
g = torch.Generator(device=dev).manual_seed(15)
vals = inputs["a"][1][0]
inputs["a dense"] = ("k11", (vals, torch.rand(vals.shape, generator=g, device=dev) < 0.02,
                             torch.rand(vals.shape, generator=g, device=dev) < 0.5)
                     + inputs["a"][1][3:])
d = inputs["d"][1]
occ = torch.rand(d[1].shape, generator=g, device=dev) < 0.05
inputs["d dense"] = ("k13c", (d[0], occ, torch.randint(0, 36, occ.shape, generator=g, device=dev,
                                                       dtype=torch.int32),
                              torch.ones(2, dtype=torch.bool, device=dev)) + d[4:])
cases = {}
for name, (kind, a) in inputs.items():
    if kind == "k11":
        v, bg, safe, sure, ball, w1, c = a
        taps, halo = tm.tap_set(ball)
        fn = lambda: kernels.demote_ema(v, bg, safe, sure, taps, halo, w1, c)
        got, want = (fn(),), (ts.demote_ema_plain(*a),)
        unsafe = (bg & ~safe).to(torch.int8)
        stencil = dict(k1_int8_max=timed(lambda: kernels.ball_pool(unsafe, taps, halo, "max", 0)))
        n_bytes = v.numel() * (4 + 4 + 1 + 1)
        args = (v, bg, safe, sure, taps, halo, w1, c)
    else:
        v, o, ce, flags, prev, lsz, radius, min_sure, w1, score, thr, win = a
        taps, halo = tm.ball_taps(radius), int(math.floor(radius))
        args = (v, o, ce, flags, prev, lsz, taps, halo, min_sure, w1, score, thr, win)
        fn = lambda: kernels.exact_demote_ema(*args)
        got, want = fn(), ts.exact_demote_ema_plain(*a)
        centres = ts.center_mask(o & ~(ce.to(torch.float32) >= min_sure), lsz).to(torch.int32)
        stencil = dict(k1_int32_sum=timed(lambda: kernels.ball_pool(centres, taps, halo, "sum",
                                                                      0)))
        n_bytes = v.numel() * (4 + 4 + 1) + o.numel() * (1 + 4)
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError(f"case {name}: the kernel differs from its plain version")
    cases[name] = dict(kind=kind, taps=len(taps), halo=halo, shape=list(v.shape),
                       demoted=int((got[0] != v).sum()), bytes=n_bytes,
                       bound_ms=n_bytes / cs.HBM_BYTES_PER_S * 1e3, kernel=timed(fn),
                       schedule=schedule("demote_ema" if kind == "k11" else "exact_demote_ema",
                                         *args),
                       **stencil, copy=copy_floor(n_bytes))
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip()
print(json.dumps(dict(nvidia_smi=smi, demote_cases=cases)))
"""

# The inputs of K6 and K5a as the sweep step passes them (the wrappers'
# calls on the 7th scan of a fresh node after the apriori plane), the head
# of the two scripts below: compact_gate_inputs(cs) -> (lut, {case:
# (wrapper name, positional args)})
COMPACT_GATE_INPUTS = r"""
import torch

from vofod_tpu_torch import kernels
from vofod_tpu_torch.config import DynParams
from vofod_tpu_torch.runtime.node import NodeOptions, VoFOD


def compact_gate_inputs(cs):
    lut = cs.make_lut(cs.VoFODConfig().sensor)
    node = VoFOD(cs.VoFODConfig(), DynParams(), NodeOptions(), lut, device="cuda")
    node.load_apriori_map(cs.apriori_ground())
    scans = cs.scan_cycle(lut, 7)
    for r, p in scans[:6]:
        node.process_scan(r, None, p)
    names = ("masked_compact", "gate_faces")
    orig, got = {k: getattr(kernels, k) for k in names}, []

    def recorder(name):
        def record(*a):
            got.append((name, tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in a)))
            return orig[name](*a)
        return record

    for k in names:
        setattr(kernels, k, recorder(k))
    try:
        node.process_scan(scans[6][0], None, scans[6][1])
        torch.cuda.synchronize()
    finally:
        for k in names:
            setattr(kernels, k, orig[k])
    cases = {}
    for name, a in got:
        if name == "gate_faces":
            cases["k5a gate"] = (name, a)
        else:
            form = "query" if len(a) > 2 else "mask"
            cases[f"k6 {form} {a[0].numel()}->{a[1]}"] = (name, a)
    return lut, cases
"""

# runs in the tree's root; prints one JSON line: K6's and K5a's calls of the
# sweep step's 7th scan, each checked against its plain version and timed
_COMPACT_GATE_CASES = COMPACT_GATE_INPUTS + r"""
import json
import subprocess
import sys
import time

sys.path.insert(0, ".")
import chip_smoke as cs
from vofod_tpu_torch.ops.compaction import masked_compact_isin_plain, masked_compact_plain
from vofod_tpu_torch.ops.raycast import gate_faces_plain, make_angular_gate


def timed(fn):
    return dict(ms=cs.cuda_ms(fn), **cs.device_profile(fn))


def host_us(fn, n=1000):
    # host microseconds a call over n calls with no sync, after 50
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    dt = (time.perf_counter_ns() - t0) / n / 1e3
    torch.cuda.synchronize()
    return round(dt, 3)


def one_buffer(cap):  # K6's outputs as views of one allocation: ids, total, valid's bytes
    buf = torch.empty(cap + 1 + -(-cap // 4), dtype=torch.int32, device="cuda")
    return buf[:cap], buf[cap + 1:].view(torch.bool)[:cap], buf[cap]


def empties(cap, scratch=0):  # K6's outputs: ids, valid, total (and a scratch)
    out = (torch.empty(cap, dtype=torch.int32, device="cuda"),
           torch.empty(cap, dtype=torch.bool, device="cuda"),
           torch.empty((), dtype=torch.int32, device="cuda"))
    return out + ((torch.empty(scratch, dtype=torch.int32, device="cuda"),) if scratch else ())


# the host cost of the K6 wrapper's allocations at the far call's capacity
# (2,048), in the three forms it has had: the outputs and the three-launch
# scan's scratch (two words a 4,096-byte block of 2.47 M), the outputs
# alone, the outputs as views of one allocation
pieces = {"4 torch.empty (outputs, three-launch scratch)": lambda: empties(2048, 1208),
          "3 torch.empty (outputs)": lambda: empties(2048),
          "1 torch.empty and its 3 views (outputs)": lambda: one_buffer(2048)}
if hasattr(kernels, "_compact_state_for"):
    def state_pick(dev=torch.device("cuda"), stream=kernels._stream()):
        with kernels._compact_lock:
            st = kernels._compact_state_for(dev, stream, 152)
            use, other = st[st[2]], st[1 - st[2]]
            st[2] ^= 1
        return use, other

    pieces["the look-back state: lock, lookup and flip"] = state_pick
pieces = {k: host_us(f) for k, f in pieces.items()}

lut, inputs = compact_gate_inputs(cs)
gate = make_angular_gate(lut)
cases = {}
for name, (wrapper, a) in inputs.items():
    fn = lambda wrapper=wrapper, a=a: getattr(kernels, wrapper)(*a)
    if wrapper == "masked_compact":
        plain = (masked_compact_plain(a[0], a[1]) if len(a) == 2
                 else masked_compact_isin_plain(a[0], a[2], a[3], a[1]))
        err = 0.0 if all(torch.equal(x, y) for x, y in zip(fn(), plain)) else float("inf")
        extra = dict(total=int(plain[2]), nonzero=timed(lambda m=a[0]: torch.nonzero(m)))
    else:
        active, fd, rot, table = a[:4]
        want = gate_faces_plain(gate, fd, active, rot, table).reshape(-1)
        err = float((fn().reshape(-1) - want).abs().max())
        extra = dict(texels=fd.shape[0])
    if not err <= (cs.K5A_TOL if wrapper == "gate_faces" else 0.0):
        raise AssertionError(f"case {name}: the kernel differs from its plain version ({err})")
    cases[name] = dict(kernel=timed(fn), host_us=host_us(fn), max_abs_err=err, **extra)
k6 = [c["kernel"]["device_ms"] for n, c in cases.items() if n.startswith("k6")]
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip()
print(json.dumps(dict(nvidia_smi=smi, compact_gate_cases=cases, k6_calls=len(k6),
                      k6_sweep_scan_device_ms=sum(k6),
                      k6_sweep_scan_host_us=sum(c["host_us"] for n, c in cases.items()
                                                if n.startswith("k6")),
                      k5a_device_ms=cases["k5a gate"]["kernel"]["device_ms"],
                      k6_wrapper_pieces_host_us=pieces)))
"""

# runs in the change tree's root with variant names as arguments (all when
# none); prints one JSON line: variants of K6 (csrc/compact.cu) and K5a
# (csrc/ray_gate.cu), each source edited by text substitution of its
# schedule's constants, built alone (one nvcc each, started together) and
# called through its C entry point on the sweep step's calls (and K6 on the
# far mask from a view at byte offset 7), each call checked against the
# plain version; per variant and case the device ms, launches and memsets a
# call and the CUDA-event ms, and each variant's registers
_COMPACT_GATE_VARIANTS = COMPACT_GATE_INPUTS + r"""
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, ".")
import chip_smoke as cs
from vofod_tpu_torch import kernels
from vofod_tpu_torch.ops.compaction import masked_compact_isin_plain, masked_compact_plain
from vofod_tpu_torch.ops.raycast import gate_faces_plain, make_angular_gate

CSRC = Path("vofod_tpu_torch/csrc")
OUT = Path("build/probe")
CT, VEC = "constexpr int CT = 256;", "constexpr int VEC = 4;"
GT, GC = "constexpr int GATE_T = 128;", "constexpr int GATE_CLUSTER = 8;"
VARIANTS = {  # name: (source, [(text, replacement), ...])
    "k6_base": ("compact.cu", []),
    "k6_vec1": ("compact.cu", [(VEC, "constexpr int VEC = 1;")]),
    "k6_vec2": ("compact.cu", [(VEC, "constexpr int VEC = 2;")]),
    "k6_t512": ("compact.cu", [(CT, "constexpr int CT = 512;")]),
    "k6_vec2_t512": ("compact.cu", [(CT, "constexpr int CT = 512;"),
                                    (VEC, "constexpr int VEC = 2;")]),
    "k5a_base": ("ray_gate.cu", []),
    "k5a_c8_t64": ("ray_gate.cu", [(GT, "constexpr int GATE_T = 64;")]),
    "k5a_c2": ("ray_gate.cu", [(GC, "constexpr int GATE_CLUSTER = 2;")]),
    "k5a_c4": ("ray_gate.cu", [(GC, "constexpr int GATE_CLUSTER = 4;")]),
    # clusters of one: every block pools the whole image
    "k5a_whole_t128": ("ray_gate.cu", [(GC, "constexpr int GATE_CLUSTER = 1;")]),
    "k5a_whole_t256": ("ray_gate.cu", [(GC, "constexpr int GATE_CLUSTER = 1;"),
                                       (GT, "constexpr int GATE_T = 256;")]),
}
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build(name):
    src, edits = VARIANTS[name]
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    text = (CSRC / src).read_text()
    for a, b in edits:
        if a not in text:
            raise RuntimeError(f"probe {name}: {a!r} not found")
        text = text.replace(a, b, 1)
    for h in CSRC.glob("*.cuh"):
        (d / h.name).write_text(h.read_text())
    (d / src).write_text(text)
    so = d / f"libprobe_{name}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so), str(d / src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"probe {name}: nvcc failed\n{res.stdout}{res.stderr}")
    regs = [ln.split("Used ")[1].split(",")[0] for ln in (res.stdout + res.stderr).splitlines()
            if "Used" in ln and "registers" in ln]
    lib = ctypes.CDLL(str(so))
    if src == "compact.cu":
        lib.vofod_compact.argtypes = [P, P, P, I, LL, I, P, P, LL, P, P, P, P]
    else:
        lib.vofod_gate_faces.argtypes = [P] * 8
    return lib, regs


def k6_call(lib, stream, mask, cap, labels=None, sel=None):
    n = mask.numel()
    pair = [torch.zeros(n // 4096 + 8, dtype=torch.int64, device=mask.device) for _ in "ab"]
    ids = torch.empty(cap, dtype=torch.int32, device=mask.device)
    valid = torch.empty(cap, dtype=torch.bool, device=mask.device)
    total = torch.empty((), dtype=torch.int32, device=mask.device)

    def launch():
        err = lib.vofod_compact(
            mask.data_ptr(), None if labels is None else labels.data_ptr(),
            None if sel is None else sel.data_ptr(), 0 if sel is None else sel.numel(), n, cap,
            pair[0].data_ptr(), pair[1].data_ptr(), pair[0].numel(), ids.data_ptr(),
            valid.data_ptr(), total.data_ptr(), stream)
        if err:
            raise RuntimeError(f"vofod_compact: {err}")
        pair.reverse()
        return ids, valid, total

    return launch


def k5a_call(lib, stream, active, fd, rot, table, pools, scalars):
    ints = kernels._host_i32(*active.shape, *pools, fd.shape[0],
                             0 if table is None else table.shape[0])
    floats = kernels._host_f32(*scalars)
    out = torch.empty(fd.shape[0], dtype=torch.float32, device=active.device)

    def launch():
        err = lib.vofod_gate_faces(active.data_ptr(), fd.data_ptr(), rot.data_ptr(),
                                   None if table is None else table.data_ptr(), ints[1],
                                   floats[1], out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"vofod_gate_faces: {err}")
        return out

    return launch


def main():
    names = sys.argv[1:] or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    with ThreadPoolExecutor(len(names)) as pool:
        futs = {n: pool.submit(build, n) for n in names}
        libs = {n: f.result() for n, f in futs.items()}
    stream = kernels._stream()
    lut, inputs = compact_gate_inputs(cs)
    gate = make_angular_gate(lut)
    far = next(a for w, a in inputs.values() if w == "masked_compact" and a[1] == 2048)[0]
    buf = torch.zeros(far.numel() + 32, dtype=torch.bool, device=far.device)
    view = buf[7:7 + far.numel()]
    view.copy_(far.reshape(-1))
    inputs["k6 mask at byte 7"] = ("masked_compact", (view, 2048))
    result = {}
    for vn, (lib, regs) in libs.items():
        row = {"registers": regs}
        for case, (wrapper, a) in inputs.items():
            if (wrapper == "masked_compact") != vn.startswith("k6"):
                continue
            if wrapper == "masked_compact":
                launch = k6_call(lib, stream, a[0], a[1], *a[2:])
                want = (masked_compact_plain(a[0], a[1]) if len(a) == 2
                        else masked_compact_isin_plain(a[0], a[2], a[3], a[1]))
                ok = all(torch.equal(x, y) for x, y in zip(launch(), want))
            else:
                launch = k5a_call(lib, stream, *a)
                want = gate_faces_plain(gate, a[1], a[0], a[2], a[3]).reshape(-1)
                ok = float((launch() - want).abs().max()) <= cs.K5A_TOL
            if not ok:
                raise AssertionError(f"probe {vn} case {case}: differs from the plain version")
            prof = cs.device_profile(launch)
            row[case] = dict(ms=round(cs.cuda_ms(launch), 5),
                             device_ms=round(prof["device_ms"], 5),
                             launches=prof["cuda_launches"], memsets=prof["memsets"])
        result[vn] = row
    print(json.dumps(dict(nvidia_smi=smi, variants=result)), flush=True)


main()
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
# The inputs of K7 and K8 as the step passes them (the wrappers' calls on
# the 7th to 11th scans of a fresh node after the apriori plane: the scans
# chip_smoke's phase 5 profiles; the sweep path's 7th has no valid query),
# the head of the script below: explore_inputs(cs, lut, cfg, opts) ->
# [(kernels.explore args, kernels.demote_ args)], a pair a scan
EXPLORE_INPUTS = r"""
import torch

from vofod_tpu_torch import kernels
from vofod_tpu_torch.config import DynParams
from vofod_tpu_torch.runtime.node import VoFOD


def explore_inputs(cs, lut, cfg, opts, first=7, n=5):
    node = VoFOD(cfg, DynParams(), opts, lut, device="cuda")
    node.load_apriori_map(cs.apriori_ground())
    scans = cs.scan_cycle(lut, first - 1 + n)
    for r, p in scans[:first - 1]:
        node.process_scan(r, None, p)
    names = ("explore", "demote_")
    orig, got, out = {k: getattr(kernels, k) for k in names}, {}, []

    def recorder(name):
        def record(*a):
            # K8's corners stay K7's own tensor: on a tree whose K8 adds to a
            # count beside them, their allocation holds it
            got[name] = tuple(x if name == "demote_" and i == 2 else
                              x.clone() if isinstance(x, torch.Tensor) else x
                              for i, x in enumerate(a))
            return orig[name](*a)
        return record

    for k in names:
        setattr(kernels, k, recorder(k))
    try:
        for r, p in scans[first - 1:]:
            node.process_scan(r, None, p)
            torch.cuda.synchronize()
            out.append((got.get("explore"), got.get("demote_")))
    finally:
        for k in names:
            setattr(kernels, k, orig[k])
    return out
"""

# runs in the tree's root; prints one JSON line: K7's and K8's calls of the
# sweep step's scans 7-11 and K7's of the exact step's, each checked against
# its plain version (bit-equal; K8 on a fresh copy of its grid every call,
# its count and, on a tree whose K8 gives it, cluster_connected), with the
# device ms, launches, other device ops (fills, memsets) a call of each
# kernel (torch.profiler; K8's grid copy not counted) and the wrapper's
# host us a call over 1,000 calls with no sync; the means over the five
# scans
_EXPLORE_CASES = EXPLORE_INPUTS + r"""
import json
import subprocess
import sys
import time

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")
import chip_smoke as cs
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.ops.explore import demote_floating_plain, explore_plain
from vofod_tpu_torch.runtime.node import NodeOptions


def host_us(fn, n=1000):
    # host microseconds a call over n calls with no sync, after 50
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    dt = (time.perf_counter_ns() - t0) / n / 1e3
    torch.cuda.synchronize()
    return round(dt, 3)


def profiled(fn, match, reps=20):
    # device ms and launches a call of the kernels named ``match``, and the
    # other device ops a call but memcpys (a fill kernel, a memset)
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then records no device event
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        mine = [e for e in ev if match in e.name]
        if mine:
            break
    us = sum(float(getattr(e, "device_time", None) or getattr(e, "cuda_time", 0.0)) for e in mine)
    other = [e for e in ev if match not in e.name and "memcpy" not in e.name.lower()]
    return dict(device_ms=round(us / reps / 1e3, 5), launches=len(mine) / reps,
                other_ops=len(other) / reps,
                memsets=sum("memset" in e.name.lower() for e in ev) / reps)


lut = cs.make_lut(cs.VoFODConfig().sensor)
grid = GridSpec.from_config(cs.VoFODConfig())
count = getattr(kernels, "demote_count", None)  # K8's count beside K7's corners
cases = {}
for path, cfg, opts in (("sweep", cs.VoFODConfig(), NodeOptions()),
                        ("exact", cs.exact_config(), NodeOptions(raycast_mode="exact"))):
    for i, (k7, k8) in enumerate(explore_inputs(cs, lut, cfg, opts)):
        fn7 = lambda a=k7: kernels.explore(*a)
        want = explore_plain(grid, *k7)
        if not all(torch.equal(x, y) for x, y in zip(fn7(), want)):
            raise AssertionError(f"K7 {path} scan {7 + i}: differs from explore_plain")
        row = dict(valid_queries=int(k7[4].sum()), connected=int(want[0].sum()),
                   k7=dict(**profiled(fn7, "explore"), host_us=host_us(fn7)))
        if path == "sweep":
            vmap, work = k8[0], k8[0].clone()
            a8 = (work,) + k8[1:]

            def fn8(a8=a8, vmap=vmap, work=work):
                work.copy_(vmap)  # a fresh grid every call: every demotion stores
                return kernels.demote_(*a8)

            if count is not None:
                count(k8[2]).zero_()
            got = fn8()
            got = got if isinstance(got, tuple) else (got,)
            want = demote_floating_plain(*k8)
            if not (torch.equal(work, want[0]) and all(
                    torch.equal(x, y) for x, y in zip(got, want[1:]))):
                raise AssertionError(f"K8 sweep scan {7 + i}: differs from its plain version")
            row.update(demotion_writes=int(want[1]),
                       k8=dict(**profiled(fn8, "demote_kernel"),
                               host_us=host_us(lambda a8=a8: kernels.demote_(*a8))))
        cases[f"{path} scan {7 + i}"] = row
means = {}
for path, k in (("sweep", "k7"), ("exact", "k7"), ("sweep", "k8")):
    rows = [r[k] for c, r in cases.items() if c.startswith(path)]
    means[f"{path} {k}"] = {m: round(sum(r[m] for r in rows) / len(rows), 5)
                            for m in ("device_ms", "launches", "other_ops", "memsets", "host_us")}
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip()
print(json.dumps(dict(nvidia_smi=smi, explore_cases=cases, explore_means=means)))
"""

# the sweep step's calls of K10 and K5b on scans 7-11 (the wrappers' calls
# recorded on a fresh node after the apriori plane, the scans chip_smoke's
# phase 5 profiles) and the profile of a call; the ray-detect cases and
# variants share them
RAY_DETECT_INPUTS = r"""
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vofod_tpu_torch import kernels
from vofod_tpu_torch.config import DynParams
from vofod_tpu_torch.runtime.node import NodeOptions, VoFOD


def step_calls(cs, lut, first=7, n=5):
    # [(kernels.detect args, kernels.ray_update args)] of sweep scans first
    # .. first + n - 1
    node = VoFOD(cs.VoFODConfig(), DynParams(), NodeOptions(), lut, device="cuda")
    node.load_apriori_map(cs.apriori_ground())
    scans = cs.scan_cycle(lut, first - 1 + n)
    for r, p in scans[:first - 1]:
        node.process_scan(r, None, p)
    names = ("detect", "ray_update")
    orig, got, out = {k: getattr(kernels, k) for k in names}, {}, []

    def recorder(name):
        def record(*a):
            got[name] = tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in a)
            return orig[name](*a)
        return record

    for k in names:
        setattr(kernels, k, recorder(k))
    try:
        for r, p in scans[first - 1:]:
            node.process_scan(r, None, p)
            torch.cuda.synchronize()
            out.append((got["detect"], got["ray_update"]))
    finally:
        for k in names:
            setattr(kernels, k, orig[k])
    return out


def profiled(fn, match, reps=20):
    # device ms and launches a call of the kernels named ``match``, and the
    # other device ops a call but memcpys (a fill kernel, a memset); a
    # session now and then loses events: up to three sessions until one
    # holds every call's launch
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        mine = [e for e in ev if match in e.name]
        if best is None or len(mine) > len(best[0]):
            best = (mine, ev)
        if len(mine) >= reps:
            break
    mine, ev = best
    us = sum(float(getattr(e, "device_time", None) or getattr(e, "cuda_time", 0.0)) for e in mine)
    other = [e for e in ev if match not in e.name and "memcpy" not in e.name.lower()]
    return dict(device_ms=round(us / max(len(mine), 1) / 1e3, 5), launches=len(mine) / reps,
                other_ops=len(other) / reps,
                memsets=sum("memset" in e.name.lower() for e in ev) / reps)
"""

# runs in the tree's root; prints one JSON line: K10's and K5b's calls of
# the sweep step's scans 7-11, each checked against its plain version (K10:
# valid, ids and the counter bit-equal, the floats within chip_smoke's
# bounds; K5b on a fresh copy of its grid every call: the changed voxels
# bit-equal), with the device ms, launches and other device ops (a fill, a
# memset) a call of each kernel (torch.profiler; K5b's grid copy not
# counted) and the wrapper's host us a call over 1,000 calls with no sync;
# the means over the five scans
_RAY_DETECT_CASES = RAY_DETECT_INPUTS + r"""
import json
import subprocess
import sys
import time

sys.path.insert(0, ".")
import chip_smoke as cs
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.ops.raycast import ray_window_update_plain_
from vofod_tpu_torch.pipeline.detect import detect_slots_plain


def host_us(fn, n=1000):
    # host microseconds a call over n calls with no sync, after 50
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    dt = (time.perf_counter_ns() - t0) / n / 1e3
    torch.cuda.synchronize()
    return round(dt, 3)


lut = cs.make_lut(cs.VoFODConfig().sensor)
grid = GridSpec.from_config(cs.VoFODConfig())
cases = {}
for i, (kd, kr) in enumerate(step_calls(cs, lut)):
    case = f"sweep scan {7 + i}"
    fn10 = lambda a=kd: kernels.detect(*a)
    (vals, far, labels, amin, amax, reps, npts, cls, obb, sensor, counter, cs_, _o, _iv, c,
     window) = kd
    want = detect_slots_plain(grid, cs_, c, vals, far, labels, amin, amax, reps, npts, cls, obb,
                              sensor, counter, window)
    cs._detect_compare(fn10(), want, case)
    base, work = kr[0], kr[0].clone()
    a5 = (work,) + kr[1:]

    def fn5(a5=a5, base=base, work=work):
        work.copy_(base)  # a fresh grid every call
        kernels.ray_update(*a5)

    fn5()
    want5 = ray_window_update_plain_(base.clone(), *kr[1:])
    cmp = cs._grid_cmp(work, want5, base, f"K5b {case}")
    cases[case] = dict(
        mav_slots=int(want[0].sum()), k5b_changed=cmp["n_changed"],
        k10=dict(**profiled(fn10, "detect_kernel"), host_us=host_us(fn10)),
        k5b=dict(**profiled(fn5, "ray_update_kernel"),
                 host_us=host_us(lambda a5=a5: kernels.ray_update(*a5))))
means = {k: {m: round(sum(r[k][m] for r in cases.values()) / len(cases), 5)
             for m in ("device_ms", "launches", "other_ops", "memsets", "host_us")}
         for k in ("k10", "k5b")}
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip()
print(json.dumps(dict(nvidia_smi=smi, ray_detect_cases=cases, ray_detect_means=means)))
"""


# runs in the change tree's root with the parent tree's root as its first
# argument (its K10 walked every slot's whole CS^3 window, its K5b ran the
# whole raylen chain on every window voxel: commit 3aa92df); prints one JSON
# line.  Variants of csrc/detect.cu and csrc/ray_update.cu, built by text
# substitution (the edits raise on a source that does not hold their text),
# each alone under build/probe (one nvcc each, started together) and called
# through its C entry point on the ray-detect cases' calls.  The names
# after the parent's root select some (all by default):
# - parent, change: the two trees' sources;
# - parent_detect_no_window: the parent's K10 with every slot's window loop
#   skipped (unchecked: the launch and the slots' scalars alone);
# - parent_detect_mav_window: the parent's K10 walking only the mav slots'
#   windows (unchecked);
# - parent_ray_loads_only: the parent's K5b loading each voxel's offsets,
#   point flag, its cone's T and grid value, and storing the grid value
#   where T > 0 and no point landed, with no raylen arithmetic (unchecked);
# - change_detect_warps2, change_detect_warps8: the change's K10 on 2 or 8
#   warps a slot (the tree's: 4; their sums in another order, so confidence
#   within chip_smoke.K10_CONF_RTOL);
# - change_ray_tile32x8, _tile32x4, _tile64x4, _tile32x16: the change's K5b
#   on tiles of that many voxels (the tree's: 16 x 16);
# - change_ray_minblocks: the change's K5b with its launch bounded to 2,048
#   threads an SM, so at most 32 registers a thread;
# - change_ray_warps8x4: the change's K5b with a warp on 8 x 4 voxels of the
#   tile (the tree's: two rows of 16);
# - change_ray_smem_faces: the change's K5b with the six gate faces staged in
#   shared memory by each block that survives its tile test;
# - change_ray_compact: the change's K5b (new rule) with the voxels past the
#   range, point flag and T tests packed into the block's first threads,
#   which alone run the FOV test, the raylen and the EMA;
# - change_ray_compact_fov: the same packing after the FOV test;
# - change_ray_fov_first: the change's K5b testing the FOV before the loads;
# - change_ray_tile_only, _range_only, _tests_only: the change's K5b
#   returning after the tile test, after the range test, or after the point
#   flag, T and FOV tests (unchecked: where the time goes).
# The checked variants are held to the plain version (K10:
# detect_slots_plain, valid, ids and the counter bit-equal, confidence too
# for the change's own order, the floats within chip_smoke's bounds; K5b:
# ray_window_update_plain_ on the same grid, the changed voxels bit-equal).
# Per case: the mav slots and the slots that keep a confidence, their box ∩
# window voxels; K5b's window voxels and how many pass each test of
# ops.raycast.ray_cull_plain (the tile, the range, no point, T nonzero, the
# FOV) and the voxels changed.  Per variant and case the device ms a call
# (torch.profiler, 20 calls), its launches and memsets a call and the
# CUDA-event ms; each variant's registers; the means over the five scans.
# On the first scan the two trees' own K5b also run the old rule with T6
# or the faces holding NaN, against the plain version (the parent's window
# max took fmaxf, which drops a NaN raylen)
_RAY_DETECT_VARIANTS = RAY_DETECT_INPUTS + r"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, ".")
import chip_smoke as cs
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.ops.raycast import ray_cull_plain, ray_window_update_plain_
from vofod_tpu_torch.pipeline.detect import detect_boxes, detect_slots_plain

_P, _I = ctypes.c_void_p, ctypes.c_int


def edit(src, pairs):
    for a, b in pairs:
        if src.count(a) != 1:
            raise RuntimeError(f"probe: {a!r} found {src.count(a)} times")
        src = src.replace(a, b)
    return src


PAR_CS3 = "  const int cs3 = n.CS * n.CS * n.CS;\n"
PAR_RAYLEN0 = (
    "    const float rl = raylen_at(T6, faces, rel_x, rel_y, rel_z, rot, n, f, z, j, i);\n"
    "    if (!(rl > 0.0f)) return;\n"
    "    w1 = exp2f(__fmul_rn(-f.its, __fmul_rn(f.coef, rl)));\n")
# the voxel's cone's T, with no raylen arithmetic
T_ONLY = '''__device__ float t_only(const float* __restrict__ T6, const float* __restrict__ rel_x,
                       const float* __restrict__ rel_y, const float* __restrict__ rel_z,
                       const RayI& n, int z, int j, int i) {
  const float X = rel_x[i], Y = rel_y[j], Z = rel_z[z];
  const float ax = fabsf(X), ay = fabsf(Y), az = fabsf(Z);
  const bool in_x = ax >= ay && ax >= az;
  const bool in_y = !in_x && ay >= az;
  const float rel_s = in_x ? X : (in_y ? Y : Z);
  const int cone = 2 * (in_x ? 0 : (in_y ? 1 : 2)) + (rel_s > 0.0f ? 0 : 1);
  return T6[(((size_t)cone * n.nz + z) * n.wy + j) * n.wx + i];
}

// torch.pow(base, its) as PyTorch computes it on the card
'''
PAR_POW = "// torch.pow(base, its) as PyTorch computes it on the card\n"


def parent_variants(par_det: str, par_ray: str) -> dict:
    return {
        "parent": (par_det, par_ray),
        "parent_detect_no_window": (edit(par_det, [(PAR_CS3, "  const int cs3 = 0;\n")]), None),
        "parent_detect_mav_window": (edit(par_det, [(PAR_CS3, (
            "  const int cs3 = cls[k] == CLS_MAV ? n.CS * n.CS * n.CS : 0;\n"))]), None),
        "parent_ray_loads_only": (None, edit(par_ray, [(PAR_POW, T_ONLY), (PAR_RAYLEN0, (
            "    const float rl = t_only(T6, rel_x, rel_y, rel_z, n, z, j, i);\n"
            "    if (!(rl > 0.0f)) return;\n    w1 = rl;\n"))])),
    }


def change_variants(det: str, ray: str) -> dict:
    out = {"change": (det, ray)}
    warps = "constexpr int DET_WARPS = 4;"
    for w in (2, 8):
        out[f"change_detect_warps{w}"] = (
            edit(det, [(warps, f"constexpr int DET_WARPS = {w};")]), None)
    tile = "constexpr int RAY_TX = 16, RAY_TY = 16;"
    for tx, ty in ((32, 8), (32, 4), (64, 4), (32, 16)):
        out[f"change_ray_tile{tx}x{ty}"] = (
            None, edit(ray, [(tile, f"constexpr int RAY_TX = {tx}, RAY_TY = {ty};")]))
    # the launch bounded to 2,048 threads an SM: at most 32 registers a thread
    bounds = ("__global__ void __launch_bounds__(RAY_TX * RAY_TY)\n    ray_update_kernel(",
              "__global__ void __launch_bounds__(RAY_TX * RAY_TY, 2048 / (RAY_TX * RAY_TY))\n"
              "    ray_update_kernel(")
    out["change_ray_minblocks"] = (None, edit(ray, [bounds]))
    out["change_ray_warps8x4"] = (None, edit(ray, [WARPS8X4]))
    out["change_ray_smem_faces"] = (None, edit(ray, SMEM_FACES))
    out["change_ray_compact"] = (None, edit(ray, COMPACT))
    out["change_ray_compact_fov"] = (None, edit(ray, COMPACT_FOV))
    out["change_ray_fov_first"] = (None, edit(ray, FOV_FIRST))
    for name, anchor, stop in STAGES:
        out[f"change_ray_{name}_only"] = (None, edit(ray, [(anchor, anchor + stop)]))
    return out


# a warp on 8 x 4 voxels of the tile
WARPS8X4 = ('''  const int i = xa + (int)threadIdx.x % RAY_TX, j = ya + (int)threadIdx.x / RAY_TX;
''', '''  const int w8 = (int)threadIdx.x >> 5, l8 = (int)threadIdx.x & 31;
  const int i = xa + (w8 % (RAY_TX / 8)) * 8 + l8 % 8, j = ya + (w8 / (RAY_TX / 8)) * 4 + l8 / 8;
''')
# the six gate faces staged in shared memory by each block past its tile
# test (F <= 32: 24 KB)
SMEM_FACES = [
    ("    if (dn2 > __fmul_rn(lim, lim)) return;  // the whole block\n  }\n", (
        "    if (dn2 > __fmul_rn(lim, lim)) return;  // the whole block\n  }\n"
        "  __shared__ float faces_sm[6 * 32 * 32];\n"
        "  const float* faces_s = faces;\n"
        "  if (n.F > 0 && n.F <= 32) {\n"
        "    for (int e = threadIdx.x; e < 6 * n.F * n.F; e += blockDim.x)\n"
        "      faces_sm[e] = faces[e];\n"
        "    __syncthreads();\n"
        "    faces_s = faces_sm;\n"
        "  }\n")),
    ("rl = raylen(T, v, c, el, faces, n, f);", "rl = raylen(T, v, c, el, faces_s, n, f);"),
]


# where the time goes (unchecked): every voxel returns after the tile test,
# after its range test, or after its point flag, T and FOV tests (a store
# that never happens keeps the tests)
STAGES = [
    ("tile", "    if (dn2 > __fmul_rn(lim, lim)) return;  // the whole block\n  }\n",
     "  if (MODE == 0 && n.F < 0) vals[0] = 0.0f;\n  if (MODE == 0) return;\n"),
    ("range", "  const bool in_range = live && v.d <= f.max_d;  // in registers\n",
     "  if (MODE == 0 && in_range && n.F < 0) vals[0] = 0.0f;\n  if (MODE == 0) return;\n"),
    ("tests", "  const bool reach = in_range && !hit;  // a point landed: no EMA\n",
     "  if (MODE == 0) {\n    float el;\n"
     "    if (reach && (T > 0.0f || T < 0.0f) && in_fov(v, rot, f, &el) && n.F < 0)\n"
     "      vals[0] = g_val;\n    return;\n  }\n"),
]
# the new rule's voxels past the range, point flag and T tests packed into
# the block's first threads (a ballot a warp, a prefix over the warps in
# shared memory), which then run the FOV test, the raylen and the EMA
COMPACT = [("  const bool reach = in_range && !hit;  // a point landed: no EMA\n",
            '''  const bool reach = in_range && !hit;  // a point landed: no EMA
  if (MODE == 0) {
    constexpr int NW = RAY_TX * RAY_TY / 32;
    __shared__ int p_src[RAY_TX * RAY_TY], w_n[NW];
    __shared__ float p_T[RAY_TX * RAY_TY], p_g[RAY_TX * RAY_TY];
    const bool want = reach && (T > 0.0f || T < 0.0f);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const uint32_t bal = __ballot_sync(0xffffffffu, want);
    if (lane == 0) w_n[warp] = __popc(bal);
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < NW; ++w) {
      off += w < warp ? w_n[w] : 0;
      total += w_n[w];
    }
    if (want) {
      const int p = off + __popc(bal & ((1u << lane) - 1u));
      p_src[p] = threadIdx.x;
      p_T[p] = T;
      p_g[p] = g_val;
    }
    __syncthreads();
    if ((int)threadIdx.x >= total) return;
    const int src = p_src[threadIdx.x];
    const int i2 = xa + src % RAY_TX, j2 = ya + src / RAY_TX;
    const Geo v2 = geometry(rel_x[i2], rel_y[j2], Z, f);
    float el;
    if (!in_fov(v2, rot, f, &el)) return;
    const float rl2 = raylen(p_T[threadIdx.x], v2, cone_of(v2), el, faces, n, f);
    if (!(rl2 > 0.0f)) return;
    const size_t g2 = ((size_t)z * n.ny + (n.y0 + j2)) * n.nx + (n.x0 + i2);
    vals[g2] = ema(p_g[threadIdx.x], exp2f(__fmul_rn(-f.its, __fmul_rn(f.coef, rl2))), f.score);
    return;
  }
''')]


# the same packing after the FOV test: the packed threads run only the
# gate, the density and the EMA
COMPACT_FOV = [("  const bool reach = in_range && !hit;  // a point landed: no EMA\n",
                '''  const bool reach = in_range && !hit;  // a point landed: no EMA
  if (MODE == 0) {
    constexpr int NW = RAY_TX * RAY_TY / 32;
    __shared__ int p_src[RAY_TX * RAY_TY], w_n[NW];
    __shared__ float p_T[RAY_TX * RAY_TY], p_g[RAY_TX * RAY_TY], p_el[RAY_TX * RAY_TY];
    float el = 0.0f;
    const bool want = reach && (T > 0.0f || T < 0.0f) && in_fov(v, rot, f, &el);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const uint32_t bal = __ballot_sync(0xffffffffu, want);
    if (lane == 0) w_n[warp] = __popc(bal);
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < NW; ++w) {
      off += w < warp ? w_n[w] : 0;
      total += w_n[w];
    }
    if (want) {
      const int p = off + __popc(bal & ((1u << lane) - 1u));
      p_src[p] = threadIdx.x;
      p_T[p] = T;
      p_g[p] = g_val;
      p_el[p] = el;
    }
    __syncthreads();
    if ((int)threadIdx.x >= total) return;
    const int src = p_src[threadIdx.x];
    const int i2 = xa + src % RAY_TX, j2 = ya + src / RAY_TX;
    const Geo v2 = geometry(rel_x[i2], rel_y[j2], Z, f);
    const float rl2 = raylen(p_T[threadIdx.x], v2, cone_of(v2), p_el[threadIdx.x], faces, n, f);
    if (!(rl2 > 0.0f)) return;
    const size_t g2 = ((size_t)z * n.ny + (n.y0 + j2)) * n.nx + (n.x0 + i2);
    vals[g2] = ema(p_g[threadIdx.x], exp2f(__fmul_rn(-f.its, __fmul_rn(f.coef, rl2))), f.score);
    return;
  }
''')]
# the FOV test before the loads: a voxel in range and in the FOV loads its
# point flag, T and grid value
FOV_FIRST = [
    ("  if (in_range) {\n    if (MODE != 1) hit = had[g] != 0;\n",
     "  float el0 = 0.0f;\n"
     "  const bool seen = in_range && (MODE == 2 || in_fov(v, rot, f, &el0));\n"
     "  if (seen) {\n    if (MODE != 1) hit = had[g] != 0;\n"),
    ("  const bool reach = in_range && !hit;  // a point landed: no EMA\n",
     "  const bool reach = seen && !hit;\n"),
    ("    float el;\n    if (in_fov(v, rot, f, &el)) rl = raylen(T, v, c, el, faces, n, f);\n",
     "    rl = raylen(T, v, c, el0, faces, n, f);\n"),
]


def build(srcs: dict) -> tuple[dict, dict]:
    out_dir = Path("build/probe")
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._nvcc()
    jobs = {}
    for name, pair in srcs.items():
        for kind, src in zip(("det", "ray"), pair):
            if src is None:
                continue
            stem = f"{name}_{kind}"
            (out_dir / f"{stem}.cu").write_text(src)
            cmd = [nvcc, *kernels.NVCC_FLAGS, "-shared", "-I", str(kernels._CSRC), "-o",
                   str(out_dir / f"{stem}.so"), str(out_dir / f"{stem}.cu")]
            jobs[(name, kind)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    for (name, kind), job in jobs.items():
        log = job.communicate()[0]
        if job.returncode != 0:
            raise RuntimeError(f"nvcc {name} {kind}: {log[-3000:]}")
        regs[f"{name}_{kind}"] = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                                  if "registers" in ln]
        lib = ctypes.CDLL(str(out_dir / f"{name}_{kind}.so"))
        if kind == "det":
            lib.vofod_detect.argtypes = [_P] * 20
        else:
            lib.vofod_ray_update.argtypes = [_P] * 8 + [_P, _P, _I, _P, _P, _I, _P]
        libs.setdefault(name, {})[kind] = lib
    return libs, regs


def det_call(lib, a):
    (vals, far, labels, aabb_min, aabb_max, reps, n_points, cls, obb, sensor, counter, cs_,
     origin, inv_voxel, c, window) = a
    K, dev = reps.shape[0], vals.device
    out = (torch.empty(K, dtype=torch.bool, device=dev),
           torch.empty(K, dtype=torch.int32, device=dev),
           torch.empty(K, dtype=torch.float32, device=dev),
           torch.empty(K, dtype=torch.float32, device=dev),
           torch.empty((K, 3, 3), dtype=torch.float32, device=dev),
           torch.empty((), dtype=torch.int32, device=dev))
    nzb, ny, nx = vals.shape
    nz, z_lo, own0, own1 = (nzb, 0, 0, nzb) if window is None else window
    ints = kernels._host_i32(nz, ny, nx, K, cs_, z_lo, nzb, own0, own1)
    floats = kernels._host_f32(*origin, inv_voxel, *c)

    def launch():
        err = lib.vofod_detect(
            vals.data_ptr(), far.data_ptr(), labels.data_ptr(), aabb_min.data_ptr(),
            aabb_max.data_ptr(), reps.data_ptr(), n_points.data_ptr(), cls.data_ptr(),
            obb.data_ptr(), sensor.data_ptr(), counter.data_ptr(), ints[1], floats[1],
            *(t.data_ptr() for t in out), kernels._stream())
        if err:
            raise RuntimeError(f"vofod_detect: CUDA error {err}")
        return out
    return launch


def ray_call(lib, a, work):
    _, had, T6, faces, rel_x, rel_y, rel_z, rot, x0, y0, c, ema, _gmax = a
    nz, ny, nx = work.shape
    wy, wx = rel_y.shape[0], rel_x.shape[0]
    F = 0 if faces is None else faces.shape[-1]
    ints = kernels._host_i32(nz, ny, nx, wy, wx, y0, x0, F)
    floats = kernels._host_f32(*c, ema.coef, ema.its, ema.weight, ema.score)
    # the old rule's scratch: the window's raylen and its max's bits
    raylen_w = torch.empty(nz * wy * wx, dtype=torch.float32, device=work.device)
    max_bits = torch.zeros((), dtype=torch.int32, device=work.device)

    def launch():
        if not ema.new_rule:
            max_bits.zero_()
        err = lib.vofod_ray_update(
            work.data_ptr(), had.data_ptr(), T6.data_ptr(),
            None if faces is None else faces.data_ptr(), rel_x.data_ptr(), rel_y.data_ptr(),
            rel_z.data_ptr(), rot.data_ptr(), ints[1], floats[1], int(bool(ema.new_rule)),
            raylen_w.data_ptr(), max_bits.data_ptr(), 3, kernels._stream())
        if err:
            raise RuntimeError(f"vofod_ray_update: CUDA error {err}")
        return work
    return launch


def old_rule_nan(lib, a, base):
    # the old rule on a call's inputs with T6 holding NaN (every 101st value)
    # or the faces (every 13th), as chip_smoke's phase 2 cases: whether the
    # grid is the plain version's, NaN where it is NaN
    out = {}
    for name, i in (("T6 holding NaN", 2), ("faces holding NaN", 3)):
        b = list(a)
        b[i] = a[i].clone()
        b[i].view(-1)[::101 if i == 2 else 13] = float("nan")
        b[11] = a[11]._replace(new_rule=False)
        work = base.clone()
        ray_call(lib, b, work)()
        want = ray_window_update_plain_(base.clone(), *b[1:12])
        out[name] = dict(plain_nan=int(want.isnan().sum()), kernel_nan=int(work.isnan().sum()),
                         equal=bool(((work == want) | (work.isnan() & want.isnan())).all()))
    return out


def main() -> int:
    par_dir = Path(sys.argv[1]) / "vofod_tpu_torch/csrc"
    par = ((par_dir / "detect.cu").read_text(), (par_dir / "ray_update.cu").read_text())
    chg = (Path("vofod_tpu_torch/csrc/detect.cu").read_text(),
           Path("vofod_tpu_torch/csrc/ray_update.cu").read_text())
    srcs = parent_variants(*par)
    if chg != par:  # this tree holds the redesigned kernels
        srcs.update(change_variants(*chg))
    if sys.argv[2:]:
        srcs = {k: v for k, v in srcs.items() if k in sys.argv[2:]}
    libs, regs = build(srcs)

    cfg, dyn = cs.VoFODConfig(), DynParams()
    lut = cs.make_lut(cfg.sensor)
    grid = GridSpec.from_config(cfg)
    res = {"k10": {}, "k5b": {}, "registers": regs}
    for s, (kd, kr) in enumerate(step_calls(cs, lut)):
        case = f"sweep scan {7 + s}"
        (vals, far, labels, amin, amax, reps, npts, cls, obb, sensor, counter, cs_, _o, _iv, c,
         window) = kd
        want = detect_slots_plain(grid, cs_, c, vals, far, labels, amin, amax, reps, npts, cls,
                                  obb, sensor, counter, window)
        lo, hi, ctr = detect_boxes(grid, amin, amax)
        keep = (want[0] & (ctr[:, 2] >= window[2]) & (ctr[:, 2] < window[3]) if window else
                want[0])
        half = cs_ // 2
        box = torch.clamp(torch.minimum(hi, ctr - half + cs_ - 1)
                          - torch.maximum(lo, ctr - half) + 1, min=0).prod(1)
        row = dict(mav_slots=int(want[0].sum()), keeping_slots=int(keep.sum()),
                   box_window_voxels=[int(b) for b in box[keep]])
        for name, lib in libs.items():
            if "det" not in lib:
                continue
            fn = det_call(lib["det"], kd)
            got = fn()
            if not any(k in name for k in ("no_window", "mav_window")):
                # the parent's and the warps variants' sums run in another order
                cs._detect_compare(got, want, f"{name} {case}",
                                   conf_equal=name.startswith("change") and "warps" not in name)
            row[name] = dict(**profiled(fn, "detect"), ms=cs.cuda_ms(fn))
        res["k10"][case] = row

        base, had, T6, faces, rel_x, rel_y, rel_z, rot, x0, y0, rc, ema, _ = kr
        wy, wx = rel_y.shape[0], rel_x.shape[0]
        win = (slice(None), slice(y0, y0 + wy), slice(x0, x0 + wx))
        m = ray_cull_plain(T6, had[win], rel_x, rel_y, rel_z, rot, rc, ema.new_rule)
        want = ray_window_update_plain_(base.clone(), had, T6, faces, rel_x, rel_y, rel_z, rot,
                                        x0, y0, rc, ema)
        row = dict(window_voxels=int(m["tile"].numel()),
                   **{f"after_{k}": int(v.sum()) for k, v in m.items()},
                   changed=int((want != base).sum()))
        for name, lib in libs.items():
            if "ray" not in lib:
                continue
            work = base.clone()
            fn = ray_call(lib["ray"], kr, work)
            fn()
            if not name.endswith("_only"):
                cs._grid_cmp(work, want, base, f"K5b {name} {case}")
            row[name] = dict(**profiled(fn, "ray_update"), ms=cs.cuda_ms(fn))
            if s == 0 and name in ("parent", "change"):
                row[name]["old_rule_nan"] = old_rule_nan(lib["ray"], kr, base)
        res["k5b"][case] = row
    for k in ("k10", "k5b"):
        rows = [r for c, r in res[k].items() if c.startswith("sweep scan")]
        res[k]["sweep scans 7-11 mean"] = {
            n: round(sum(r[n]["device_ms"] for r in rows) / len(rows), 5)
            for n in rows[0] if isinstance(rows[0][n], dict)}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(json.dumps(res))
    return 0


sys.exit(main())
"""

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
    dense = {}
    for path, step, prof in (("sweep", "4-flagship", "5-profile"),
                             ("prebinned", "4-prebinned", "5-profile-prebinned"),
                             ("dynamic", "4-dynamic", "5-profile-dynamic")):
        p50 = ph.get(step, {}).get("step_ms_p50")
        if isinstance(p50, dict):
            p50 = p50.get("prebinned")
        elif path == "dynamic":
            segs = ph.get(step, {}).get("segments") or [{}]
            p50 = segs[-1].get("step_ms_p50")
        dense[path] = dict(step_ms_p50=p50,
                           busy_ms=ph.get(prof, {}).get("device_busy_ms_per_scan"),
                           idle_share=ph.get(prof, {}).get("idle_share_of_unprofiled_step"))
    busy = {path: {k: ph.get(f"5-profile{sfx}", {}).get(m) for k, m in (
        ("busy_ms", "device_busy_ms_per_scan"), ("idle_share", "idle_share_of_unprofiled_step"),
        ("port_kernels_ms_per_scan", "port_kernels_ms_per_scan"))}
        for path, sfx in (("sweep", ""), ("exact", "-exact"), ("sequential", "-sequential"),
                          ("prebinned", "-prebinned"), ("dynamic", "-dynamic"),
                          ("grid", "-grid"), ("grid_exact", "-grid-exact"),
                          ("grid_sequential", "-grid-sequential"))}
    return dict(
        dense=dense, busy=busy,
        smoke_k9_k12={k: {m: ph[k].get(m) for m in ("ms", "plain_ms", "max_abs_err",
                                                     "large_far_lists", "random_directions")
                          if m in ph[k]}
                      for k in ("cluster_stats", "dda", "dda_slab") if k in ph},
        smoke_k1_k14_k15a={k: {m: ph[k].get(m) for m in ("ms", "device_ms", "library_ms",
                                                          "library_device_ms", "calls")}
                           for k in ("ball_pool", "shell_pool", "unpack") if k in ph},
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


def _json_run(script: str, tree: Path) -> tuple[bool, dict]:
    """``script`` in ``tree``'s root: (ok, its last line's JSON object or
    the error)."""
    k = subprocess.run([sys.executable, "-c", script], cwd=tree, capture_output=True, text=True,
                       timeout=600)
    lines = k.stdout.strip().splitlines()
    if k.returncode == 0 and lines:
        return True, json.loads(lines[-1])
    return False, {"error": k.stderr[-2000:]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--order", default="pccp")
    ap.add_argument("--exact-pairs", type=int, default=0)
    ap.add_argument("--grid-exact-pairs", type=int, default=0)
    ap.add_argument("--out", type=Path, default=Path("build/ab"))
    ap.add_argument("--demote-only", action="store_true",
                    help="time only the demotion cases (a)-(f) of each run")
    ap.add_argument("--compact-gate-only", action="store_true",
                    help="time only K6's and K5a's calls of the sweep step in each run")
    ap.add_argument("--explore-only", action="store_true",
                    help="time only K7's and K8's calls of the sweep and exact steps in each run")
    ap.add_argument("--ray-detect-only", action="store_true",
                    help="time only K10's and K5b's calls of the sweep step in each run")
    ap.add_argument("--variants", default="",
                    help="then time these variants of the change's K6 and K5a ('all': every one)")
    ap.add_argument("--ray-detect-variants", default="",
                    help="then time these variants of both trees' K10 and K5b ('all': every one)")
    args = ap.parse_args()
    trees = {"p": args.parent.resolve(), "c": args.change.resolve()}
    args.out.mkdir(parents=True, exist_ok=True)
    runs, ok = [], True
    for i, tag in enumerate(args.order):
        tree, name = trees[tag], {"p": "parent", "c": "change"}[tag]
        for flag, script in ((args.compact_gate_only, _COMPACT_GATE_CASES),
                             (args.explore_only, _EXPLORE_CASES),
                             (args.ray_detect_only, _RAY_DETECT_CASES)):
            if flag:
                g, gate = _json_run(script, tree)
                ok = ok and g
                print(json.dumps(dict(run=i, tree=name, **gate)), flush=True)
                runs.append(dict(run=i, tree=name, **gate))
        if args.compact_gate_only or args.explore_only or args.ray_detect_only:
            continue
        d, demote = _json_run(_DEMOTE_CASES, tree)
        if args.demote_only:
            ok = ok and d
            print(json.dumps(dict(run=i, tree=name, **demote)), flush=True)
            runs.append(dict(run=i, tree=name, **demote))
            continue
        g, gate = _json_run(_COMPACT_GATE_CASES, tree)
        e, expl = _json_run(_EXPLORE_CASES, tree)
        rd_ok, rd = _json_run(_RAY_DETECT_CASES, tree)
        k_ok, kern = _json_run(_KERNEL_TIMES, tree)
        s = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, capture_output=True,
                           text=True, timeout=1200)
        (args.out / f"{i}-{name}.log").write_text(s.stdout + "\n--- stderr ---\n" + s.stderr)
        last = s.stdout.strip().splitlines()[-1:] or [""]
        run = {"run": i, "tree": name, "kernel_times": kern,  # one nvidia_smi
               **demote, **gate, **expl, **rd,
               "smoke_rc": s.returncode, "smoke_last_line": last[0],
               **summarize(phases(s.stdout))}
        ok = ok and d and g and e and rd_ok and k_ok and s.returncode == 0
        print(json.dumps(run), flush=True)
        runs.append(run)
    out = {"summary": runs}
    if args.variants:
        names = [] if args.variants == "all" else args.variants.split(",")
        v = subprocess.run([sys.executable, "-c", _COMPACT_GATE_VARIANTS, *names],
                           cwd=trees["c"], capture_output=True, text=True, timeout=900)
        lines = v.stdout.strip().splitlines()
        out["variants"] = (json.loads(lines[-1]) if v.returncode == 0 and lines
                           else {"error": v.stderr[-4000:]})
        ok = ok and v.returncode == 0
    if args.ray_detect_variants:
        names = [] if args.ray_detect_variants == "all" else args.ray_detect_variants.split(",")
        v = subprocess.run([sys.executable, "-c", _RAY_DETECT_VARIANTS, str(trees["p"]), *names],
                           cwd=trees["c"], capture_output=True, text=True, timeout=1200)
        lines = v.stdout.strip().splitlines()
        out["ray_detect_variants"] = (json.loads(lines[-1]) if v.returncode == 0 and lines
                                      else {"error": v.stderr[-4000:]})
        ok = ok and v.returncode == 0
    for mode, n in (("exact", args.exact_pairs), ("grid_exact", args.grid_exact_pairs)):
        if n:
            out[mode + "_pairs"], mode_ok = run_pairs(trees, mode, n)
            ok = ok and mode_ok
    out["ok"] = ok
    print(json.dumps(out), flush=True)
    # the whole line under --out too: a log's end may not hold it
    (args.out / "summary.json").write_text(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

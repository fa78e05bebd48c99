#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vofod_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits non-zero:

0. require CUDA; print the card's name and power limit (nvidia-smi) and
   pin float32 matmuls and convolutions to full precision (no TF32);
1. build the CUDA kernels from csrc/ and, beside them, the native host
   binner (native/*.cpp, g++); print the build time;
2. hold each kernel against its plain PyTorch version on the card, on
   inputs taken from a real flagship scan (OS0-128, 241x201x51 grid): K1-K3
   bit-equal, K4 within one bf16 ulp at 1.0; CUDA-event times of both.
   The classify stage's kernels on the same scan's classify inputs and on
   synthetic cases: K6 (the three compactions, the label-predicate form,
   an overflow) bit-equal; K7 (the scan's queries, 256 valid queries over
   a random air/unknown/ground field, a serpentine corridor capped at 8
   sweeps, 32 of the queries at S = 16 and 62) and K8 (demotion of the
   random batch) bit-equal; K9 (the scan's far list, a synthetic far set of
   48 clusters, degenerate ones included)
   integers, bools and AABB bit-equal, floats within K9_TOL (OBB axes up to
   their sign, with sign flips counted).  The other stages' kernels on the
   same scan: K5a (the scan's image, the returns only, a random image
   under a pitched pose, a calibrated LUT) within K5A_TOL; K5b (the scan's
   window, both update rules, its_diff 1 and 2, kernel and plain version
   on separate clones of the grid) with the changed voxels bit-equal and
   the grid within K5B_TOL_REL x |score_ray|; K10 (the scan's slots, and
   synthetic slots in two grid corners and on an edge) with ids, valid
   and the counter bit-equal, confidence within K10_CONF_RTOL, pdet and
   covariance within K10_RTOL; K11 (the point EMA of the scan and of
   random counts; the demotion EMA with sure_sufficient True and False)
   bit-equal.  The reference-exact path's kernels on a flagship exact scan
   (exact census, hasCloseTo box, counted indexing) and synthetic cases:
   K1's hasCloseTo tap set bit-equal; K12's walk with the same nonzero
   voxels as the plain version's sequential sum on the host, raylen within
   K12_RAYLEN_RTOL of it and, in five walks, within one float32 ulp of the
   float64 sum of the same chords, its EMA pass (both rules, its_diff 1 and 2)
   bit-equal on the kernel's raylen and within K5B_TOL_REL x |score_ray|
   after walk and EMA; K2 run to convergence (the scan's coarse cells, a
   random field that converges, isolated voxels whose first sweep is the
   fixpoint, a serpentine corridor where the 128-sweep cap binds), K13b (the
   scan's grids, random fields at leaf sizes 1 and 2), K13a and K13c
   (sure_sufficient True and False) bit-equal.  The prebinned ingest on a
   flagship scan: K15a bit-equal to its plain version on the native
   binner's packed grid, whose counts (clamped to 63) and blockers are
   bit-equal to K3's and the raw frontend's; the host bin's p50/p95 over
   the cycle and the packed upload's time.  The stencils past 256 taps:
   K1 at radius 4, 5, 6 and 7.99 (257 to 2,103 taps, int32 tiles past 48 KB
   of shared memory from halo 6), K2 at 4, 5 and 7.99, K11's demotion at 4,
   5 and 7.99, and K14's shell pools at the dynamic path's tap sets, all
   bit-equal; K5b without faces (the ungated sweep) within K5b's bounds.
   K7s, the sequential explore, bit-equal on the grid, the clusters'
   connected flags and the write count to its plain version (a host loop
   over K7's and K8's plain versions): the classify inputs of a flagship
   sequential-explore scan with valid queries, the adversarial scene of
   tests/test_sequential_demotion.py in the flagship grid (floating, every
   carved cell demoted), 256 valid queries in 32 clusters over a random
   field, the same under query overflow, and no valid query.  Phase
   2-grid: the grid-sharded step's kernels with 3 shards of the flagship
   grid on the card, each bit-equal to its plain version: K15b-1 (halo
   exchange) on f32 / int32 / bool slabs at r 1-40 (multi-hop past every
   shard), also equal to the rows cut from the whole grid; K2's sharded
   sweeps (fixed count and gated) equal to the dense sweeps and flags;
   K15b-2 (fold-min) at r 16 and 20, equal to the min over every shard's
   stamp; K15b-3 / K15b-4a through the sharded sweep of a flagship scan,
   T equal to K4's, and the sharded K4 + K5b equal to the dense update
   under both rules;
3. replay tests/fixtures/golden_small.npz with the kernels on and check the
   tests/test_golden.py assertions and that the sweep path's thirteen
   kernels launched;
4. drive the flagship main path — ``VoFOD(device="cuda")``, the apriori
   ground plane and 36 scans of a content-varying cycle — and check
   ``bg_sufficient``, a NaN-free grid, that every kernel was launched and
   K5a, K5b, K10 and both K11 passes once per scan; print step p50/p95
   (CUDA events), host syncs per scan, and the explore queries and
   demotion writes of the 36 scans.  Then 6 scans with
   ``NodeOptions(raycast_every=2)``: the ray stage on every second scan.
   Then the reference-exact path, ``NodeOptions(raycast_mode="exact")``
   with the exact census and both compat flags, over the same 36 scans:
   1 host sync per scan, a finite grid, ``bg_sufficient``, every kernel of
   the path launched (K12's walk and EMA, K13a-c, K10 and the point EMA
   once per scan) and none of the sweep path's own; step p50/p95, label
   sweeps per scan, ``sep_converged`` and detections.  Then the prebinned
   ingest, ``NodeOptions(frontend_mode="prebinned")``, and a raw node over
   the same 36 scans in one process: bit-equal scan for scan, K15a once per
   prebinned scan and K3 never, 1 host sync per scan, step p50/p95 of both;
   the ``frontend_mode="auto"`` probe's choice and numbers; and
   ``cfg.dynamic_radii`` (bounds 2.0 / 2.0 m) over 36 scans with the radii
   changed every 12, each segment bit-equal to a static node at its radii
   started from the same state, K14 launched, 1 host sync per scan and no
   kernel rebuild; step p50/p95 per segment.  The raw node's steps over 7 ms
   are counted beside the prebinned node's.  Then the sequential explore,
   ``sequential_explore`` on the exact path, over the 36 scans: K7s once
   per scan, K7 and K8 never, 1 host sync per scan, the explore queries
   and demotion writes.  Then the node's runtime surface: the rangefinder
   under both validity rules, an NPZ snapshot round trip, the LUT
   consistency check, a ``trace_dir`` window and ``profile_stages``
   (bit-equal to a fused node).  Then phase 4-grid: 36 scans through
   ``make_grid_sharded_step`` over 3 shards of 17 planes on the card, each
   beside a dense node on the same scan: state, diagnostics and detection
   integers bit-equal, detection floats within 1e-5 relative, every K15b
   kernel launched on every scan, at most 1 host sync per scan; step
   p50/p95 of both, K15b launches and collective copies per scan;
5. a torch.profiler trace of 5 flagship scans of each path (sweep, exact,
   prebinned, dynamic radii at 2.0 / 1.9 m, sequential, grid-sharded),
   each from a fresh
   node after the same 6 warm-up scans: device time per stage (the step's
   ``vofod.*`` ranges), the top device ops, the device ops (kernels and
   copies) launched per scan, counted from key_averages and event by event,
   matmul kernels and pads per scan, and the device's busy and idle share
   of the step; then the sweep path once more, to show whether the op
   count depends on the profiler session.

The line before the last is the per-kernel JSON record (launches from the
path that runs each kernel: the sweep path, the prebinned path for K15a,
the dynamic-radii path for K14, the sequential path for K7s, the
grid-sharded path for K15b, else the exact path; bound_ms from the bytes
and operations of the timed call and the H100's published peaks); the last
line is ``{"ok": true, "device": {...}}``.  Needs no network and one GPU.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from vofod_tpu_torch import kernels  # noqa: E402
from vofod_tpu_torch.io import native  # noqa: E402
from vofod_tpu_torch.io.binner import HostBinner  # noqa: E402
from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig  # noqa: E402
from vofod_tpu_torch.geometry import GridSpec  # noqa: E402
from vofod_tpu_torch.io.scan_source import Scene, hover_pose, render_scan  # noqa: E402
from vofod_tpu_torch.ops.compaction import (  # noqa: E402
    masked_compact, masked_compact_isin, masked_compact_isin_plain, masked_compact_plain)
from vofod_tpu_torch.ops.components import (  # noqa: E402
    SENTINEL, label_census, label_census_plain, label_components, label_components_plain, sweeps,
    sweeps_plain)
from vofod_tpu_torch.ops.explore import (  # noqa: E402
    demote_floating, demote_floating_plain, explore, explore_plain, explore_sequential_,
    explore_sequential_plain)
from vofod_tpu_torch.ops.morphology import (  # noqa: E402
    ball_pool, ball_pool_plain, ball_taps, hascloseto_pool_any, hascloseto_taps, shell_pool,
    shell_taps, tap_pool_plain)
from vofod_tpu_torch.ops.raycast import (  # noqa: E402
    RayConsts, cone_sweep, cone_sweep_plain, dda_emissions_plain, gate_faces, gate_faces_plain,
    dda_n_steps, make_angular_gate, ray_ema_grid_, ray_ema_plain, ray_window_update_,
    ray_window_update_plain_, raycast_dda, raycast_dda_plain, row_table, sweep_window)
from vofod_tpu_torch.pipeline.background import (  # noqa: E402
    point_ema, point_ema_plain, split_and_update)
from vofod_tpu_torch.pipeline.classify import (  # noqa: E402
    CLS_MAV, classify, cluster_stats, cluster_stats_plain, explore_queries)
from vofod_tpu_torch.pipeline.detect import (  # noqa: E402
    DetectConsts, detect_slots, detect_slots_plain)
from vofod_tpu_torch.pipeline.sepclusters import (  # noqa: E402
    demote_ema, demote_ema_plain, demote_weights, exact_demote_ema, exact_demote_ema_plain,
    pool_sum_coarse, quirk_sure_counts, quirk_sure_counts_plain)
from vofod_tpu_torch.pipeline.step import exact_rays, ray_ema  # noqa: E402
from vofod_tpu_torch.pipeline.frontend import (  # noqa: E402
    frontend_bin, frontend_bin_plain, run_frontend, unpack, unpack_plain)
from vofod_tpu_torch.pipeline.state import ScanInput, VoFODState  # noqa: E402
from vofod_tpu_torch.runtime.node import NodeOptions, VoFOD, _pack, _unpack  # noqa: E402
from vofod_tpu_torch.io.staging import HostStaging  # noqa: E402
from vofod_tpu_torch.ops.raycast import (  # noqa: E402
    RayEma, cone_lat_step_plain, cone_z_round_plain, raycast_update_, raycast_update_zsharded,
    sweep_zsharded)
from vofod_tpu_torch.parallel.comm import LocalComm  # noqa: E402
from vofod_tpu_torch.parallel.gridops import (  # noqa: E402
    ZShardOps, halo_exchange_plain, halo_fold_min_plain)
from vofod_tpu_torch.parallel.grid_step import (  # noqa: E402
    gather_state, make_grid_sharded_step, shard_state)
from vofod_tpu_torch.sensor import make_lut, make_lut_ouster  # noqa: E402

# K4 tolerance: T lies in [0, 1] and is stored in bf16; kernel and plain
# version follow the same rounding steps, so they may differ by at most one
# bf16 ulp at 1.0 (2^-8) where an f32 sum rounds across a bf16 tie.
K4_TOL = 2.0**-8
# K9 float outputs (OBB centre, extent, size in m; axes unitless, each
# compared up to its sign): the member sums run in another order than the
# plain version's matmul and einsum, a few float32 ulps of coordinates up
# to ~120 m
K9_TOL = 1e-4
# K5a faces lie in [0, 1]; kernel and plain version follow the same
# rounding steps (bit-equal expected)
K5A_TOL = 1e-6
# K5b: the grid within 1e-5 x |score_ray| (the bound tests/test_torch_raycast.py
# holds the ray EMA to against JAX); the set of voxels it changed bit-equal
K5B_TOL_REL = 1e-5
# K10 confidence relative; pdet and covariance relative (the window sum is
# replayed in the kernel's order, so bit-equal is expected)
K10_CONF_RTOL = 1e-5
K10_RTOL = 1e-6
# K12 raylen against the plain version's sequential (JAX-order) float32 sum:
# the kernel sums in float64 and rounds once, so the two differ by the
# sequential sum's own rounding, largest in the voxel holding the sensor,
# which sums ~all 131,072 rays' first chords (1.08e-4 on the checked scan,
# from the host's float64 sum); against that float64 sum rounded once the
# kernel is held to one float32 ulp
K12_RAYLEN_RTOL = 5e-4
N_SCANS = 36
N_EXACT_SCANS = 36
# the kernels of each path, and those its flagship step launches once per scan
SWEEP_KERNELS = ("ball_pool", "propagate_sweep", "frontend_bin", "cone_sweep", "masked_compact",
                 "explore_bfs", "demote", "cluster_stats", "gate_faces", "ray_update", "detect",
                 "point_ema", "demote_ema")
EXACT_KERNELS = ("ball_pool", "propagate_sweep", "frontend_bin", "masked_compact", "explore_bfs",
                 "demote", "cluster_stats", "detect", "point_ema", "dda", "ray_ema",
                 "label_census", "quirk_counts", "exact_demote_ema")
ONCE_PER_SCAN = ("gate_faces", "ray_update", "detect", "point_ema", "demote_ema")
ONCE_PER_EXACT_SCAN = ("dda", "ray_ema", "detect", "point_ema", "label_census", "quirk_counts",
                       "exact_demote_ema")
# the sequential explore path: the exact path with K7s in place of K7 and K8
SEQUENTIAL_KERNELS = tuple(k for k in EXACT_KERNELS if k not in ("explore_bfs", "demote")) + (
    "explore_seq",)
ONCE_PER_SEQUENTIAL_SCAN = ONCE_PER_EXACT_SCAN + ("explore_seq",)
# tests/test_sequential_demotion.py's scene: relative (x, y) cells carved as
# unknown in a wall of ray-carved voxels, members A = (0, 0) and B = (2, 0)
# of one cluster with Manhattan bound 8; A fails and demotes B's escape
SEQ_CARVED = ((0, 0), (1, 0), (2, 0), (2, 1), (2, 2), (1, 2), (1, 3), (1, 4), (0, 4), (0, 5))
SEQ_BASE = (120, 100, 25)  # (x, y, z) of the scene's origin in the flagship grid
# the card's published peaks (H100 SXM data sheet, at 700 W): device memory
# rate, and float32 outside the tensor cores, the rate every op of these
# kernels (float or integer compare, add, select) is counted at
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

KERNEL_INFO = {
    "ball_pool": ("vofod_tpu_torch/csrc/ball_pool.cu", "vofod_tpu/ops/morphology.py:70"),
    "propagate_sweep": ("vofod_tpu_torch/csrc/propagate.cu", "vofod_tpu/ops/components.py:88"),
    "frontend_bin": ("vofod_tpu_torch/csrc/frontend_bin.cu", "vofod_tpu/ops/binning.py:44"),
    "cone_sweep": ("vofod_tpu_torch/csrc/cone_sweep.cu", "vofod_tpu/ops/raycast.py:210"),
    "masked_compact": ("vofod_tpu_torch/csrc/compact.cu", "vofod_tpu/ops/compaction.py:49"),
    "explore_bfs": ("vofod_tpu_torch/csrc/explore.cu", "vofod_tpu/ops/explore.py:34"),
    "demote": ("vofod_tpu_torch/csrc/explore.cu", "vofod_tpu/ops/explore.py:168"),
    "explore_seq": ("vofod_tpu_torch/csrc/explore.cu", "vofod_tpu/pipeline/classify.py:211"),
    "cluster_stats": ("vofod_tpu_torch/csrc/classify_stats.cu",
                      "vofod_tpu/pipeline/classify.py:77"),
    "gate_faces": ("vofod_tpu_torch/csrc/ray_gate.cu", "vofod_tpu/ops/raycast.py:559"),
    "ray_update": ("vofod_tpu_torch/csrc/ray_update.cu", "vofod_tpu/ops/raycast.py:822"),
    "detect": ("vofod_tpu_torch/csrc/detect.cu", "vofod_tpu/pipeline/detect.py:34"),
    "point_ema": ("vofod_tpu_torch/csrc/ema.cu", "vofod_tpu/pipeline/background.py:105"),
    "demote_ema": ("vofod_tpu_torch/csrc/ema.cu", "vofod_tpu/pipeline/sepclusters.py:150"),
    "dda": ("vofod_tpu_torch/csrc/dda.cu", "vofod_tpu/ops/raycast.py:62"),
    "ray_ema": ("vofod_tpu_torch/csrc/ray_update.cu", "vofod_tpu/pipeline/step.py:53"),
    "label_census": ("vofod_tpu_torch/csrc/census.cu", "vofod_tpu/parallel/gridops.py:134"),
    "quirk_counts": ("vofod_tpu_torch/csrc/census.cu", "vofod_tpu/pipeline/sepclusters.py:211"),
    "exact_demote_ema": ("vofod_tpu_torch/csrc/ema.cu", "vofod_tpu/pipeline/sepclusters.py:301"),
    "shell_pool": ("vofod_tpu_torch/csrc/ball_pool.cu", "vofod_tpu/ops/morphology.py:147"),
    "unpack": ("vofod_tpu_torch/csrc/unpack.cu", "vofod_tpu/pipeline/frontend.py:86"),
    "halo_exchange": ("vofod_tpu_torch/csrc/halo.cu", "vofod_tpu/parallel/gridops.py:241"),
    "halo_fold_min": ("vofod_tpu_torch/csrc/halo.cu", "vofod_tpu/parallel/gridops.py:275"),
    "cone_sweep_lat": ("vofod_tpu_torch/csrc/cone_sweep.cu", "vofod_tpu/ops/raycast.py:248"),
    "cone_sweep_z": ("vofod_tpu_torch/csrc/cone_sweep.cu", "vofod_tpu/ops/raycast.py:361"),
}
# the grid-sharded step: shards of the flagship grid (51 = 3 x 17 planes),
# all on the one card, and the kernels its path adds
GRID_SHARDS = 3
GRID_KERNELS = ("halo_exchange", "halo_fold_min", "cone_sweep_lat", "cone_sweep_z")


def say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def scan_cycle(lut, n_scans: int):
    """Content-varying cycle (bench.py make_scan_cycle): ground, a structure
    and a target orbiting while the sensor flies its own arc."""
    scans = []
    for k in range(n_scans):
        a = 2.0 * np.pi * k / n_scans
        scene = Scene(ground_z=-1.0)
        scene.add_box((50.0, 30.0, -1.0), (54.0, 34.0, 5.0))
        scene.add_sphere(
            center=(25.0 + 4.0 * np.cos(a), 15.0 + 4.0 * np.sin(a), 6.0), radius=0.5
        )
        p = hover_pose(
            (40.0 + 1.5 * np.cos(a), 20.0 + 1.5 * np.sin(a), 3.0 + 0.2 * np.sin(2 * a)),
            yaw=0.1 * np.sin(a),
        )
        scans.append((render_scan(scene, lut, p), p))
    return scans


def apriori_ground() -> np.ndarray:
    """bench.py apriori_ground: a ground plane under the scanned area."""
    xs = np.arange(10.0, 60.0, 0.4)
    ys = np.arange(0.0, 45.0, 0.4)
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, -1.0)], axis=1).astype(np.float32)


def phase0() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA GPU: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)  # as nvidia-smi gives it: "<name>, <power limit>"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("0-device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=smi,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}


def phase1() -> None:
    """Build the kernel library (nvcc) and the native host binner (g++)
    side by side."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(native.build)
        so, log = kernels.build()
        host_so = host.result()
    kernels.load()
    native.load()
    info = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    say("1-build", seconds=round(time.perf_counter() - t0, 3), library=so.name,
        host_library=host_so.name, ptxas=info)


def phase2(lut) -> list[dict]:
    """Each kernel against its plain version at flagship shapes."""
    dev = torch.device("cuda")
    cfg, dyn = VoFODConfig(), DynParams()
    grid = GridSpec.from_config(cfg)
    node = VoFOD(cfg, dyn, NodeOptions(), lut, device=dev)
    node.load_apriori_map(apriori_ground())
    # warm up for at least 5 scans, and on until a scan had explore
    # queries, so that the next scan likely gives K7/K8 main-path work
    scans = scan_cycle(lut, N_SCANS)
    n_warm = 0
    for r, p in scans[:-1]:
        node.process_scan(r, None, p)
        n_warm += 1
        if n_warm >= 5 and int(node.last_diag.n_queries) > 0:
            break
    r_np, pose_np = scans[n_warm]
    say("2-input", warm_up_scans=n_warm, queries_last_warm_up=int(node.last_diag.n_queries))
    ranges = torch.as_tensor(r_np.astype(np.float32), device=dev)
    pose = torch.as_tensor(pose_np, device=dev)
    dirs = torch.as_tensor(lut.directions, device=dev)
    offs = torch.as_tensor(lut.offsets, device=dev)
    vals = node.state.grid
    results = []

    # K3 — frontend binning of the scan
    k3 = frontend_bin(cfg, grid, dirs, offs, ranges, pose)
    p3 = frontend_bin_plain(cfg, grid, dirs, offs, ranges, pose)
    for a, b, what in zip(k3, p3, ("counts", "n_valid", "excl", "fid")):
        if not torch.equal(a, b):
            raise AssertionError(f"K3 {what} differs from the plain version")
    n_rays, nv = ranges.shape[0], grid.n_voxels
    all_fids = k3[3].long()
    results.append(dict(
        name="frontend_bin", max_abs_err=max(max_abs(a, b) for a, b in zip(k3, p3)),
        ms=cuda_ms(lambda: frontend_bin(cfg, grid, dirs, offs, ranges, pose)),
        plain_ms=cuda_ms(lambda: frontend_bin_plain(cfg, grid, dirs, offs, ranges, pose)),
        # ranges, LUT, pose in; counts grid, count, exclude flags, ids out
        bytes=n_rays * (4 + 12 + 12 + 1 + 4) + 64 + nv * 4 + 4, ops=n_rays * 42,
        library_ms=cuda_ms(lambda: torch.bincount(all_fids, minlength=nv)),
        library_call="torch.bincount of the scan's 131,072 clamped point ids",
        shapes=f"{lut.height}x{lut.width} rays -> {grid.shape}",
    ))
    counts = k3[0]
    occupied = counts > 0

    # K1 — the pools of the step: bg_near (int8 max r=3), the sepclusters
    # sure sum (int32 r=3) and demotion ball (int8 max r=1.6), int32 min r=3
    radius = cfg.ground_points_max_distance / cfg.voxel_size
    bg = vals > dyn.thr_new_obstacles
    sure = (vals > dyn.thr_sure_obstacles).to(torch.int32)
    keys = torch.where(bg, torch.arange(grid.n_voxels, dtype=torch.int32, device=dev)
                       .reshape(grid.shape), SENTINEL)
    cases = [
        (bg.to(torch.int8), radius, "max", 0),
        (sure, 3.0, "sum", 0),
        ((bg & ~occupied).to(torch.int8), 1.6, "max", 0),
        (keys, radius, "min", SENTINEL),
    ]
    err, ms, pms = 0.0, [], []
    for a, rad, op, fill in cases:
        k = ball_pool(a, rad, op, fill)
        p = ball_pool_plain(a, rad, op, fill)
        if not torch.equal(k, p):
            raise AssertionError(f"K1 {op} r={rad} {a.dtype} differs from the plain version")
        err = max(err, max_abs(k, p))
        ms.append(cuda_ms(lambda: ball_pool(a, rad, op, fill)))
        pms.append(cuda_ms(lambda: ball_pool_plain(a, rad, op, fill)))
    # the compat hasCloseTo box (r = 3, the +3 layer missing) as K1's tap set
    hct_taps = hascloseto_taps(radius)
    kh = hascloseto_pool_any(bg, radius)
    ph = tap_pool_plain(bg.to(torch.int8), hct_taps, "max", 0) > 0
    if not torch.equal(kh, ph):
        raise AssertionError("K1 hasCloseTo tap set differs from the plain version")
    hct = dict(taps=len(hct_taps), set_voxels=int(ph.sum()),
               ms=cuda_ms(lambda: hascloseto_pool_any(bg, radius)),
               plain_ms=cuda_ms(lambda: tap_pool_plain(bg.to(torch.int8), hct_taps, "max", 0),
                                reps=3))
    results.append(dict(
        name="ball_pool", max_abs_err=err, ms=ms[0], plain_ms=pms[0],
        bytes=2 * nv, ops=nv * len(ball_taps(radius)), library_ms=None, hascloseto=hct,
        shapes=f"{grid.shape}; ms/plain_ms per case (int8 max r3, int32 sum r3, "
               f"int8 max r1.6, int32 min r3): {[round(x, 4) for x in ms]} / "
               f"{[round(x, 4) for x in pms]}",
    ))

    # K2 — 8 label sweeps from the scan's seeded keys; 8 reach sweeps
    bg_near = ball_pool_plain(bg.to(torch.int8), radius, "max", 0) > 0
    seed = occupied & bg_near
    nv = grid.n_voxels
    flat = torch.arange(nv, dtype=torch.int32, device=dev).reshape(grid.shape)
    key0 = (nv - 1) - flat + torch.where(seed, 0, nv).to(torch.int32)
    keys0 = torch.where(occupied, key0, SENTINEL)
    reach0 = (bg & (sure > 0)).to(torch.uint8)
    err, ms, pms = 0.0, [], []
    for init, occ, rad in ((keys0, occupied, radius), (reach0, bg, 2.0)):
        kg, kc = sweeps(init, occ, rad, cfg.cc_sweeps)
        pg, pc = sweeps_plain(init, occ, rad, cfg.cc_sweeps)
        if not (torch.equal(kg, pg) and torch.equal(kc, pc)):
            raise AssertionError(f"K2 {init.dtype} sweeps differ from the plain version")
        err = max(err, max_abs(kg, pg))
        ms.append(cuda_ms(lambda: sweeps(init, occ, rad, cfg.cc_sweeps)) / cfg.cc_sweeps)
        pms.append(cuda_ms(lambda: sweeps_plain(init, occ, rad, cfg.cc_sweeps)) / cfg.cc_sweeps)
    results.append(dict(
        name="propagate_sweep", max_abs_err=err, ms=ms[0], plain_ms=pms[0],
        bytes=nv * (4 + 1 + 4), ops=nv * len(ball_taps(radius)), library_ms=None,
        shapes=f"{grid.shape}, per sweep; label r3 then reach r2: "
               f"{[round(x, 4) for x in ms]} / {[round(x, 4) for x in pms]}",
    ))

    # K4 — the cone sweep on the scan's blocker window
    x0, y0, wx, wy, gx, gy, gz = sweep_window(grid, pose_np[:3, 3], cfg.raycast_max_distance_bound)
    nz = grid.nz
    rel_z = torch.arange(nz, dtype=torch.float32, device=dev) + 0.5 - float(gz)
    rel_x = torch.arange(wx, dtype=torch.float32, device=dev) + float(x0) + 0.5 - float(gx)
    rel_y = torch.arange(wy, dtype=torch.float32, device=dev) + float(y0) + 0.5 - float(gy)
    op_w = occupied[:, y0:y0 + wy, x0:x0 + wx].contiguous()
    kt = cone_sweep(op_w, rel_x, rel_y, rel_z)
    pt = cone_sweep_plain(op_w, rel_x, rel_y, rel_z)
    e4 = max_abs(kt, pt)
    n_diff = int((kt != pt).sum())
    if not e4 <= K4_TOL:
        raise AssertionError(f"K4 max|dT| {e4} > {K4_TOL}")
    nw = op_w.numel()
    results.append(dict(
        name="cone_sweep", max_abs_err=e4, tol=K4_TOL, n_diff=n_diff,
        bytes=nw * (1 + 6 * 4), ops=nw * 6 * 16, library_ms=None,
        ms=cuda_ms(lambda: cone_sweep(op_w, rel_x, rel_y, rel_z)),
        plain_ms=cuda_ms(lambda: cone_sweep_plain(op_w, rel_x, rel_y, rel_z), reps=3),
        shapes=f"window {tuple(op_w.shape)}, 6 cones",
    ))
    results += phase2_classify(cfg, dyn, grid, vals, k3, node.state.bg_sufficient, pose)
    window = (x0, y0, rel_x, rel_y, rel_z)
    results += phase2_stages(cfg, dyn, grid, lut, node, r_np, vals, k3, pose, kt, window)
    results += phase2_ingest(cfg, grid, lut, scans, n_warm, k3, ranges, pose)
    results += phase2_taps(cfg, grid, vals, occupied, node.state.safe)
    for r in results:
        say("2-kernel", **r)
    return results


def _equal(a, b, what: str) -> float:
    """Raise unless every pair is bit-equal; return the max |a - b| seen."""
    for x, y, name in zip(a, b, what.split()):
        if not torch.equal(x, y):
            raise AssertionError(f"{name} differs from the plain version")
    return max(max_abs(x, y) for x, y in zip(a, b))


def _compact_cases(cfg, grid, excl, far, labels, rep_sel):
    """K6 at its three call sites, the predicate form and overflow cases."""
    dev = far.device
    g = torch.Generator(device=dev).manual_seed(6)
    dense = torch.rand(grid.shape, generator=g, device=dev) < 0.3
    rnd_labels = torch.randint(0, 64, grid.shape, generator=g, device=dev, dtype=torch.int32)
    sel = torch.tensor([3, -2, 17, 40, -2, 63, 5, 22], dtype=torch.int32, device=dev)
    far_labels = torch.unique(labels[far])[:6].to(torch.int32)  # one host sync, here only
    sel_far = torch.cat([far_labels, torch.full((2,), -2, dtype=torch.int32, device=dev)])
    small = dense.reshape(-1)[:1000].contiguous()
    return [  # (name, kernel call, plain call)
        ("far 2.47M->2048", lambda: masked_compact(far, cfg.max_far_voxels),
         lambda: masked_compact_plain(far, cfg.max_far_voxels)),
        ("excl 131072->4096", lambda: masked_compact(excl, 4096),
         lambda: masked_compact_plain(excl, 4096)),
        ("query isin(rep_sel) 2.47M->256",
         lambda: masked_compact_isin(far, labels, rep_sel, cfg.max_queries),
         lambda: masked_compact_isin_plain(far, labels, rep_sel, cfg.max_queries)),
        ("query isin(scan labels) 2.47M->256",
         lambda: masked_compact_isin(far, labels, sel_far, cfg.max_queries),
         lambda: masked_compact_isin_plain(far, labels, sel_far, cfg.max_queries)),
        ("overflow dense 2.47M->4096", lambda: masked_compact(dense, 4096),
         lambda: masked_compact_plain(dense, 4096)),
        ("overflow isin dense 2.47M->256",
         lambda: masked_compact_isin(dense, rnd_labels, sel, 256),
         lambda: masked_compact_isin_plain(dense, rnd_labels, sel, 256)),
        ("cap > n 1000->4096", lambda: masked_compact(small, 4096),
         lambda: masked_compact_plain(small, 4096)),
    ]


def synthetic_far(grid: GridSpec, n_clusters: int, seed: int):
    """A far mask and label grid of ``n_clusters`` small clusters (single
    voxels, collinear pairs and triples, L-shapes, coplanar squares, blobs)
    around the middle of the grid; labels are each cluster's least flat id."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = grid.shape
    far = np.zeros(grid.shape, bool)
    labels = np.full(grid.shape, SENTINEL, np.int32)
    shapes = [
        [(0, 0, 0)], [(0, 0, 0), (0, 0, 1)], [(0, 0, 0), (0, 1, 0), (0, 2, 0)],
        [(0, 0, 0), (0, 0, 1), (0, 1, 0)], [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)],
        [(0, y, x) for y in range(3) for x in range(3)], [(0, 0, 0), (1, 0, 0)],
    ]
    for c in range(n_clusters):
        base = np.array([rng.integers(4, nz - 8), rng.integers(20, ny - 20),
                         rng.integers(20, nx - 20)])
        if c < 2 * len(shapes):
            offs = np.array(shapes[c % len(shapes)])
        else:
            offs = rng.integers(0, 4, size=(int(rng.integers(4, 30)), 3))
        pts = base + offs
        if far[pts[:, 0], pts[:, 1], pts[:, 2]].any() or any(
            far[max(z - 2, 0):z + 3, max(y - 2, 0):y + 3, max(x - 2, 0):x + 3].any()
            for z, y, x in pts
        ):
            continue  # keep clusters apart
        fid = (pts[:, 0] * ny + pts[:, 1]) * nx + pts[:, 2]
        far[pts[:, 0], pts[:, 1], pts[:, 2]] = True
        labels[pts[:, 0], pts[:, 1], pts[:, 2]] = fid.min()
    return far, labels


def _stats_compare(ks, ps, what: str) -> dict:
    exact = ("reps", "slot_valid", "npts", "aabb_min", "aabb_max", "gated", "m_k", "qgate",
             "rep_sel", "cluster_overflow")
    for f in exact:
        a, b = getattr(ks, f), getattr(ps, f)
        if not torch.equal(a, b):
            n = int((a != b).sum())
            raise AssertionError(f"K9 {what}: {f} differs from the plain version in {n} entries")
    v = ps.slot_valid
    errs = {f: max_abs(getattr(ks, f)[v], getattr(ps, f)[v]) if bool(v.any()) else 0.0
            for f in ("obb_center", "obb_extent", "obb_size")}
    # an eigenvector's sign is arbitrary (the OBB is the same box either
    # way): each axis is compared as a line, and sign flips are counted
    d_same = (ks.axes[v] - ps.axes[v]).abs().amax(-1)
    d_flip = (ks.axes[v] + ps.axes[v]).abs().amax(-1)
    errs["axes"] = float(torch.minimum(d_same, d_flip).max()) if bool(v.any()) else 0.0
    flipped = (d_same > K9_TOL) & (d_flip <= K9_TOL)  # [slots, 3 axes]
    worst = max(errs.values())
    if not worst <= K9_TOL:
        raise AssertionError(f"K9 {what}: float max|d| {errs} > {K9_TOL}")
    flips = dict(rows=int(flipped.sum()),
                 slot_points=ps.npts[v][flipped.any(-1)].tolist())
    return dict(n_slots=int(v.sum()), cluster_overflow=bool(ps.cluster_overflow),
                n_gated=int(ps.gated.sum()), max_abs=errs, axis_sign_flips=flips)


def _random_field(grid: GridSpec, dyn: DynParams, seed: int, dev) -> torch.Tensor:
    """Air / unknown / ground voxels at 62 / 33 / 5 %: unknown pockets just
    above the percolation threshold, some touching ground, some not."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand(grid.shape, generator=g, device=dev)
    unk = 0.5 * (dyn.thr_frontiers + dyn.thr_new_obstacles)
    return torch.where(u < 0.62, -900.0, torch.where(u < 0.95, unk, -100.0)).float()


def _serpentine(grid: GridSpec, dyn: DynParams, dev):
    """All air but a winding one-voxel unknown corridor from one query voxel:
    a Jacobi BFS capped at 8 sweeps stops 8 voxels along it."""
    nz, ny, nx = grid.shape
    vals = np.full(grid.shape, -900.0, np.float32)
    unk = 0.5 * (dyn.thr_frontiers + dyn.thr_new_obstacles)
    z, y0, x0 = nz // 2, ny // 2, nx // 2
    path = []
    for leg in range(6):  # a zig-zag of 10-voxel legs in the x-y plane
        x_range = range(x0, x0 + 10) if leg % 2 == 0 else range(x0 + 9, x0 - 1, -1)
        path += [(z, y0 + 2 * leg, x) for x in x_range]
        if leg < 5:
            path.append((z, y0 + 2 * leg + 1, x_range[-1]))
    for p in path:
        vals[p] = unk
    q = torch.tensor([[x0], [y0], [z]], dtype=torch.int32, device=dev)
    return torch.as_tensor(vals, device=dev), q


def phase2_classify(cfg, dyn, grid, vals, k3, prev_bg, pose) -> list[dict]:
    """K6-K9 against their plain versions on the scan's classify inputs."""
    dev = vals.device
    counts, _, excl, _ = k3
    bg = split_and_update(cfg, dyn, vals, counts, prev_bg)
    far, labels = bg.far, bg.labels
    sensor_pos = pose[:3, 3].contiguous()
    true = torch.ones((), dtype=torch.bool, device=dev)
    S, K, Q = cfg.explore_submap, cfg.max_clusters, cfg.max_queries
    thr_f, thr_g = dyn.thr_frontiers, dyn.thr_new_obstacles
    out = []

    # K9 — the scan's far list, then a synthetic far set with > K clusters
    fids, fvalid, ftotal = masked_compact_plain(far, cfg.max_far_voxels)
    flab = labels.reshape(-1)[fids.long()]  # the far voxels' labels
    stats_args = (dyn, grid, K, fids, fvalid, flab, ftotal, sensor_pos, bg.bg_sufficient, true)
    explore_on = bg.bg_sufficient & ~(ftotal > cfg.max_far_voxels)
    ks = cluster_stats(*stats_args)
    ps = cluster_stats_plain(dyn, grid, K, fids, fvalid, flab, sensor_pos, explore_on)
    scan_cmp = _stats_compare(ks, ps, "scan far list")
    k9_ms = cuda_ms(lambda: cluster_stats(*stats_args))
    k9_plain = cuda_ms(lambda: cluster_stats_plain(dyn, grid, K, fids, fvalid, flab,
                                                   sensor_pos, explore_on))
    sfar_np, slab_np = synthetic_far(grid, 48, seed=9)
    sfar, slab = torch.as_tensor(sfar_np, device=dev), torch.as_tensor(slab_np, device=dev)
    sids, svalid, stotal = masked_compact_plain(sfar, cfg.max_far_voxels)
    centre = torch.tensor(grid.origin, device=dev) + 0.5 * grid.voxel_size * torch.tensor(
        grid.shape[::-1], dtype=torch.float32, device=dev)
    slab = slab.reshape(-1)[sids.long()]
    ks2 = cluster_stats(dyn, grid, K, sids, svalid, slab, stotal, centre, true, true)
    ps2 = cluster_stats_plain(dyn, grid, K, sids, svalid, slab, centre, true)
    syn_cmp = _stats_compare(ks2, ps2, "synthetic 48 clusters")
    if not syn_cmp["cluster_overflow"]:
        raise AssertionError("K9 synthetic case did not overflow the K slots")
    out.append(dict(
        name="cluster_stats", max_abs_err=max(*scan_cmp["max_abs"].values(),
                                              *syn_cmp["max_abs"].values()),
        tol=K9_TOL, ms=k9_ms, plain_ms=k9_plain, scan=scan_cmp, synthetic=syn_cmp,
        # the far list and its labels in; K slots of statistics out
        bytes=cfg.max_far_voxels * (4 + 1 + 4) + K * 128, ops=cfg.max_far_voxels * 30 + K * 300,
        library_ms=None,
        n_far_scan=int(ftotal), n_far_synthetic=int(stotal),
        shapes=f"F={cfg.max_far_voxels}, K={K}; integers, bools, AABB bit-equal",
    ))

    # K6 — the compactions
    cases = _compact_cases(cfg, grid, excl, far, labels, ps.rep_sel)
    case_out, k6_err = {}, 0.0
    for name, kern, plain in cases:
        k, p = kern(), plain()
        k6_err = max(k6_err, _equal(k, p, f"K6[{name}].ids K6[{name}].valid K6[{name}].total"))
        case_out[name] = dict(total=int(p[2]), ms=cuda_ms(kern), plain_ms=cuda_ms(plain))
    if not case_out["overflow dense 2.47M->4096"]["total"] > 4096:
        raise AssertionError("K6 overflow case did not overflow")
    main = case_out["far 2.47M->2048"]
    nv = grid.n_voxels
    out.append(dict(name="masked_compact", max_abs_err=k6_err, ms=main["ms"],
                    plain_ms=main["plain_ms"], cases=case_out,
                    bytes=nv + cfg.max_far_voxels * 5 + 4, ops=nv, library_ms=cuda_ms(
                        lambda: torch.nonzero(far)), library_call="torch.nonzero of the far mask",
                    shapes="ms/plain_ms: the far compaction; every case bit-equal"))

    # K7 — the scan's queries (the main path's shapes)
    qids, qvalid, qtotal = masked_compact_isin_plain(far, labels, ps.rep_sel, Q)
    qx, qy, qz = grid.unflatten_id(qids)
    qlab = torch.where(qvalid, labels.reshape(-1)[qids.long()], SENTINEL)
    qslot = qvalid[:, None] & (qlab[:, None] == ps.reps[None, :])
    m_q = (qslot.to(torch.int32) * ps.m_k[None, :]).sum(dim=1).to(torch.int32)
    scan_q = (grid, bg.grid, qx, qy, qz, qvalid, m_q, thr_f, thr_g, S)
    k7_err = _equal(explore(*scan_q), explore_plain(*scan_q), "K7.connected K7.reached K7.corners")
    k7_ms, k7_plain = cuda_ms(lambda: explore(*scan_q)), cuda_ms(lambda: explore_plain(*scan_q))

    # K7 — 256 valid queries over a random field; K8 demotes their patches
    field = _random_field(grid, dyn, 7, dev)
    g = torch.Generator(device=dev).manual_seed(8)
    unk_ids = torch.nonzero(field.reshape(-1) > thr_f)[:, 0]  # queries start in the band
    pick = unk_ids[torch.randint(0, unk_ids.shape[0], (Q,), generator=g, device=dev)]
    rq = [t.to(torch.int32) for t in grid.unflatten_id(pick)]
    rq[0][:4] = torch.tensor([0, grid.nx - 1, 3, 5], dtype=torch.int32)  # grid-edge starts
    rvalid = torch.ones(Q, dtype=torch.bool, device=dev)
    rmm = torch.randint(0, 20, (Q,), generator=g, device=dev, dtype=torch.int32)
    syn_q = (grid, field, *rq, rvalid, rmm, thr_f, thr_g, S)
    kc, kr, kco = explore(*syn_q)
    k7_err = max(k7_err, _equal((kc, kr, kco), explore_plain(*syn_q),
                                "K7s.connected K7s.reached K7s.corners"))
    for side in (16, 62):  # the golden side, and 64-bit rows past 48 KB of shared memory
        q32 = (grid, field, *(t[:32] for t in rq), rvalid[:32], rmm[:32] + side // 4, thr_f,
               thr_g, side)
        k7_err = max(k7_err, _equal(explore(*q32), explore_plain(*q32),
                                    f"K7[S={side}].connected K7[S={side}].reached "
                                    f"K7[S={side}].corners"))
    syn_ms = cuda_ms(lambda: explore(*syn_q))
    syn_plain = cuda_ms(lambda: explore_plain(*syn_q))

    # K7 — the serpentine corridor, capped at 8 sweeps
    sv, sq = _serpentine(grid, dyn, dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    mm = torch.full((1,), 40, dtype=torch.int32, device=dev)
    capped = explore(grid, sv, sq[0], sq[1], sq[2], one, mm, thr_f, thr_g, S, 8)
    k7_err = max(k7_err, _equal(
        capped, explore_plain(grid, sv, sq[0], sq[1], sq[2], one, mm, thr_f, thr_g, S, 8),
        "K7c.connected K7c.reached K7c.corners"))
    free = explore(grid, sv, sq[0], sq[1], sq[2], one, mm, thr_f, thr_g, S, 96)
    n_capped = int(sum(bin(int(w)).count("1") for w in capped[1].reshape(-1).tolist()))
    n_free = int(sum(bin(int(w)).count("1") for w in free[1].reshape(-1).tolist()))
    if not n_capped < n_free:
        raise AssertionError(f"serpentine: the cap did not bind ({n_capped} vs {n_free})")
    n_q = int(qvalid.sum())
    out.append(dict(
        name="explore_bfs", max_abs_err=k7_err, ms=k7_ms, plain_ms=k7_plain,
        # each valid query's S^3 submap in, its reached rows out
        bytes=n_q * S**3 * 4 + Q * (4 * 4 + 1) + Q * S * S * 8 + Q * 13,
        ops=n_q * S**3 * 7, library_ms=None,
        scan_valid_queries=int(qvalid.sum()), synthetic_ms=syn_ms, synthetic_plain_ms=syn_plain,
        synthetic_connected=int(kc.sum()), serpentine_reached_capped=n_capped,
        serpentine_reached_free=n_free,
        shapes=f"Q={Q}, S={S}; ms/plain_ms: the scan's queries; synthetic: 256 valid queries",
    ))

    # K8 — the random batch's demotions: connected queries share slot 0,
    # the others spread over slots 1..K-1 (every slot gated), so those float
    slot_ids = torch.where(kc, 0, 1 + torch.arange(Q, device=dev) % (K - 1))
    sslot = slot_ids[:, None] == torch.arange(K, device=dev)[None, :]
    gate = torch.ones(K, dtype=torch.bool, device=dev)
    no_ovf = torch.zeros((), dtype=torch.bool, device=dev)
    dem = (kr, kco, sslot, kc, rvalid, gate, no_ovf, thr_f)
    pg, pn = demote_floating_plain(field, *dem)
    kg, kn = demote_floating(field.clone(), *dem)
    k8_err = _equal((kg, kn), (pg, pn), "K8.grid K8.n_writes")
    if int(pn) == 0:
        raise AssertionError("K8: the synthetic batch demoted nothing")
    work = field.clone()
    out.append(dict(
        name="demote", max_abs_err=k8_err,
        bytes=Q * S * S * 8 + Q * (12 + K + 2) + K + 2 * 4 * int(pn), ops=Q * S**3,
        library_ms=None,
        ms=cuda_ms(lambda: demote_floating(work, *dem)),
        plain_ms=cuda_ms(lambda: demote_floating_plain(field, *dem)),
        demotion_writes=int(pn), demoted_voxels=int((pg != field).sum()),
        shapes=f"Q={Q}, S={S}, random batch, {int((~kc).sum())} unconnected queries",
    ))
    return out


def _grid_cmp(a: torch.Tensor, b: torch.Tensor, ref: torch.Tensor, what: str) -> dict:
    """Two grids from the same input ``ref``: the same non-finite voxels, the
    same set of voxels changed from ``ref``; max |a - b| over the rest."""
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        raise AssertionError(f"{what}: non-finite voxels differ from the plain version")
    ch_a, ch_b = a != ref, b != ref
    if not torch.equal(ch_a, ch_b):
        raise AssertionError(f"{what}: the changed voxels differ from the plain version in "
                             f"{int((ch_a != ch_b).sum())} voxels")
    fin = torch.isfinite(b)
    return dict(max_abs=max_abs(a[fin], b[fin]) if bool(fin.any()) else 0.0,
                n_diff=int((a[fin] != b[fin]).sum()), n_changed=int(ch_b.sum()))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / |b| over the entries that differ (0.0 if none)."""
    a, b = a.double(), b.double()
    d = (a - b).abs()
    nz = d > 0
    return float((d[nz] / b[nz].abs().clamp(min=1e-30)).max()) if bool(nz.any()) else 0.0


def _rot(yaw: float, pitch: float, roll: float) -> np.ndarray:
    cy, sy, cp, sp, cr, sr = (np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch),
                              np.cos(roll), np.sin(roll))
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return (Rz @ Ry @ Rx).astype(np.float32)


def _synthetic_slots(cfg, grid: GridSpec, far, labels, sensor_pos, seed: int):
    """K slots for K10: clusters in two opposite grid corners and on an
    edge (their windows reach outside the grid, so every fill is read), boxes
    anywhere in the grid, and empty slots with the +-3e38 AABB of K9."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = grid.shape
    K = cfg.max_clusters
    far, labels = far.clone(), labels.clone()
    dev = far.device
    vs, org = grid.voxel_size, np.asarray(grid.origin, np.float32)
    lo = np.zeros((K, 3), np.float32)
    hi = np.zeros((K, 3), np.float32)
    reps = np.full(K, 2**31 - 1, np.int32)
    cls = rng.integers(0, 3, K).astype(np.int32)
    npts = rng.integers(0, 30, K).astype(np.int32)
    clusters = [  # (z, y, x) voxels
        [(0, 0, 0), (0, 0, 1), (1, 0, 0)],
        [(nz - 1, ny - 1, nx - 1), (nz - 1, ny - 1, nx - 2)],
        [(nz // 2, 0, nx - 1), (nz // 2, 1, nx - 1)],
    ]
    for k, vox in enumerate(clusters):
        v = np.array(vox)
        fid = (v[:, 0] * ny + v[:, 1]) * nx + v[:, 2]
        far.view(-1)[torch.as_tensor(fid, device=dev)] = True
        labels.view(-1)[torch.as_tensor(fid, device=dev)] = int(fid.min())
        c = (v[:, ::-1] + 0.5) * vs + org  # voxel centres (x, y, z)
        lo[k], hi[k] = c.min(0), c.max(0)
        reps[k], cls[k], npts[k] = fid.min(), CLS_MAV, len(vox)
    n_fixed = len(clusters)
    for k in range(n_fixed, K - 2):
        ctr = org + rng.uniform(0, 1, 3) * np.array([nx, ny, nz]) * vs
        half = rng.uniform(0, 1.0, 3)
        lo[k], hi[k] = ctr - half, ctr + half
        reps[k] = int(labels.view(-1)[int(rng.integers(0, grid.n_voxels))])
    lo[K - 2:], hi[K - 2:] = 3.0e38, -3.0e38  # empty slots
    cls[K - 2:] = 0
    obb = np.where(cls[:, None] > 0, 0.5 * (lo + hi), 0.0).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return far, labels, (t(lo), t(hi), t(reps), t(npts), t(cls), t(obb))


def _detect_compare(k, p, what: str) -> dict:
    names = ("valid", "ids", "confidence", "pdet", "covariance", "counter")
    for i in (0, 1, 5):
        if not torch.equal(k[i], p[i]):
            raise AssertionError(f"K10 {what}: {names[i]} differs from the plain version")
    errs = dict(confidence=_rel(k[2], p[2]), pdet=_rel(k[3], p[3]), covariance=_rel(k[4], p[4]))
    if not (errs["confidence"] <= K10_CONF_RTOL and errs["pdet"] <= K10_RTOL
            and errs["covariance"] <= K10_RTOL):
        raise AssertionError(f"K10 {what}: relative errors {errs}")
    return dict(rel_err=errs, mav_slots=int(p[0].sum()),
                max_abs=max(max_abs(k[i], p[i]) for i in (2, 3, 4)))


def phase2_stages(cfg, dyn, grid, lut, node, r_np, vals, k3, pose, kt, window) -> list[dict]:
    """K5a, K5b, K10 and both K11 entry points against their plain versions
    on the scan's inputs, plus synthetic cases."""
    dev = vals.device
    x0, y0, rel_x, rel_y, rel_z = window
    counts = k3[0]
    occupied = counts > 0
    rot = pose[:3, :3].contiguous()
    sensor_pos = pose[:3, 3].contiguous()
    H, W = lut.height, lut.width
    out = []

    # K5a — the step's image (all pixels cast: default mask, unit
    # intensity), the returns only, a random image under a pitched and
    # rolled pose, and a calibrated LUT (per-row elevation table)
    rng = np.random.default_rng(5)
    gate = make_angular_gate(lut)
    fd = torch.as_tensor(gate.face_dirs.reshape(-1, 3), device=dev)
    u = np.linspace(-1.0, 1.0, H)
    cal = make_lut_ouster(W, H, 3.0 * np.sin(np.linspace(0, 2 * np.pi, H)),
                          -22.5 * np.sign(u) * np.abs(u) ** 1.3, 15.806)
    gate_cal = make_angular_gate(cal)
    if gate_cal.el_rows is None:
        raise AssertionError("the calibrated LUT did not take the per-row elevation table")
    rand_img = torch.as_tensor(rng.random((H, W)) < 0.7, device=dev)
    rot2 = torch.as_tensor(_rot(0.7, 0.3, -0.2), device=dev)
    ranges = torch.as_tensor(r_np.astype(np.float32).reshape(H, W), device=dev)
    cases = [
        ("scan", gate, torch.ones((H, W), dtype=torch.bool, device=dev), rot),
        ("returns only", gate, ranges > 0, rot),
        ("random, pitched", gate, rand_img, rot2),
        ("calibrated, random, pitched", gate_cal, rand_img, rot2),
    ]
    k5a, faces = {}, None
    for name, gt, img, R in cases:
        fdt = torch.as_tensor(gt.face_dirs.reshape(-1, 3), device=dev)
        tbl = row_table(gt, dev)
        kf = gate_faces(gt, fdt, img, R, tbl)
        pf = gate_faces_plain(gt, fdt, img, R, tbl)
        e = max_abs(kf, pf)
        if not e <= K5A_TOL:
            raise AssertionError(f"K5a {name}: max|d| {e} > {K5A_TOL}")
        k5a[name] = dict(max_abs=e, n_diff=int((kf != pf).sum()), mean=float(pf.mean()))
        if faces is None:
            faces = kf
    P = fd.shape[0]
    out.append(dict(
        name="gate_faces", max_abs_err=max(c["max_abs"] for c in k5a.values()), tol=K5A_TOL,
        bytes=H * W + P * (12 + 4) + 36, ops=P * (gate.n_cols * (2 + 2 * gate.n_rows) + 40),
        library_ms=None,
        ms=cuda_ms(lambda: gate_faces(gate, fd, cases[0][2], rot)),
        plain_ms=cuda_ms(lambda: gate_faces_plain(gate, fd, cases[0][2], rot)),
        cases=k5a, shapes=f"{H}x{W} image -> {tuple(faces.shape)} faces",
    ))

    # K5b — the scan's window: K4's T6, the K5a faces, both rules, its_diff
    # 1 and 2; kernel and plain version on separate clones
    c = RayConsts.make(grid.voxel_size, dyn.raycast_max_distance, cfg.sensor.vertical_fov,
                       H, W)
    k5b = {}
    for new_rule in (True, False):
        for its in (1.0, 2.0):
            ema = ray_ema(cfg, dataclasses.replace(dyn, raycast_new_update_rule=new_rule), its)
            args = (occupied, kt, faces, rel_x, rel_y, rel_z, rot, x0, y0, c, ema)
            a = ray_window_update_(vals.clone(), *args)
            b = ray_window_update_plain_(vals.clone(), *args)
            name = f"{'new' if new_rule else 'old'} rule, its_diff {its:g}"
            cmp = _grid_cmp(a, b, vals, f"K5b {name}")
            if not cmp["max_abs"] <= K5B_TOL_REL * abs(dyn.score_ray):
                raise AssertionError(f"K5b {name}: max|d| {cmp['max_abs']}")
            if cmp["n_changed"] == 0:
                raise AssertionError(f"K5b {name}: the EMA changed nothing")
            k5b[name] = cmp
    ema1 = ray_ema(cfg, dyn, 1.0)
    # the ungated sweep (make_step_fn(raycast_gate=False)): K5b without faces
    args0 = (occupied, kt, None, rel_x, rel_y, rel_z, rot, x0, y0, c, ema1)
    a = ray_window_update_(vals.clone(), *args0)
    b = ray_window_update_plain_(vals.clone(), *args0)
    cmp = _grid_cmp(a, b, vals, "K5b ungated")
    if not (cmp["max_abs"] <= K5B_TOL_REL * abs(dyn.score_ray) and cmp["n_changed"] > 0):
        raise AssertionError(f"K5b ungated (faces=None): {cmp}")
    k5b["ungated (faces=None), new rule, its_diff 1"] = cmp
    work_k, work_p = vals.clone(), vals.clone()
    args1 = (occupied, kt, faces, rel_x, rel_y, rel_z, rot, x0, y0, c, ema1)
    nw = kt.shape[1] * kt.shape[2] * kt.shape[3]
    out.append(dict(
        name="ray_update", max_abs_err=max(v["max_abs"] for v in k5b.values()),
        bytes=nw * (4 + 4 + 1 + 4) + faces.numel() * 4, ops=nw * 80, library_ms=None,
        tol=K5B_TOL_REL * abs(dyn.score_ray),
        ms=cuda_ms(lambda: ray_window_update_(work_k, *args1)),
        plain_ms=cuda_ms(lambda: ray_window_update_plain_(work_p, *args1)),
        ungated_ms=cuda_ms(lambda: ray_window_update_(work_k, *args0)),
        cases=k5b, shapes=f"window {tuple(kt.shape[1:])} of {grid.shape}",
    ))

    # K10 — the scan's slots, then synthetic slots in grid corners and edges
    bg = split_and_update(cfg, dyn, vals, counts, node.state.bg_sufficient)
    cls = classify(cfg, dyn, grid, bg.grid, bg.far, bg.labels, bg.cc_converged, sensor_pos,
                   bg.bg_sufficient, node.state.sure_bg_sufficient)
    counter = torch.tensor(7, dtype=torch.int32, device=dev)
    dc = DetectConsts.make(cfg, dyn)
    CS = cfg.confidence_submap
    scan_args = (grid, CS, dc, cls.grid, bg.far, cls.labels, cls.aabb_min, cls.aabb_max,
                 cls.reps, cls.n_points, cls.cluster_class, cls.obb_center, sensor_pos, counter)
    scan_cmp = _detect_compare(detect_slots(*scan_args), detect_slots_plain(*scan_args), "scan")
    sfar, slab, slots = _synthetic_slots(cfg, grid, bg.far, cls.labels, sensor_pos, 10)
    syn_args = (grid, CS, dc, cls.grid, sfar, slab, *slots[:5], slots[5], sensor_pos, counter)
    syn_cmp = _detect_compare(detect_slots(*syn_args), detect_slots_plain(*syn_args),
                              "synthetic corners")
    out.append(dict(
        name="detect", max_abs_err=max(scan_cmp["max_abs"], syn_cmp["max_abs"]),
        bytes=cfg.max_clusters * (CS**3 * (4 + 1 + 4) + 100), ops=cfg.max_clusters * CS**3 * 10,
        library_ms=None,
        tol=dict(confidence_rel=K10_CONF_RTOL, pdet_cov_rel=K10_RTOL),
        ms=cuda_ms(lambda: detect_slots(*scan_args)),
        plain_ms=cuda_ms(lambda: detect_slots_plain(*scan_args)),
        scan=scan_cmp, synthetic=syn_cmp,
        shapes=f"K={cfg.max_clusters} windows of {CS}^3; ids, valid, counter bit-equal",
    ))

    # K11 — the point EMA of the scan and of random counts (> 63 included);
    # the demotion EMA of the carried reach and of a random one, with
    # sure_sufficient True and False
    g = torch.Generator(device=dev).manual_seed(11)
    rnd_counts = torch.where(torch.rand(grid.shape, generator=g, device=dev) < 0.2,
                             torch.randint(0, 90, grid.shape, generator=g, device=dev), 0
                             ).to(torch.int32)
    rnd_close = torch.rand(grid.shape, generator=g, device=dev) < 0.5
    sp, su = float(dyn.score_point), float(dyn.score_unknown)
    pe = {}
    for name, cts, cl in (("scan", counts, bg.close), ("random", rnd_counts, rnd_close)):
        kk, pp = point_ema(vals, cts, cl, sp, su), point_ema_plain(vals, cts, cl, sp, su)
        _equal(kk, pp, f"K11p[{name}].grid K11p[{name}].far K11p[{name}].n_occupied")
        pe[name] = dict(n_occupied=int(pp[2]), changed=int((pp[0] != vals).sum()))
    radius = cfg.sepclusters_max_bg_distance / cfg.voxel_size
    bgm = vals > dyn.thr_new_obstacles
    rnd_bg = torch.rand(grid.shape, generator=g, device=dev) < 0.3
    rnd_safe = torch.rand(grid.shape, generator=g, device=dev) < 0.5
    true = torch.ones((), dtype=torch.bool, device=dev)
    de = {}
    for name, b_, s_, sure, its in (
            ("carried reach", bgm, node.state.safe, node.state.sure_bg_sufficient, 1.0),
            ("random, its_diff 2", rnd_bg, rnd_safe, true, 2.0),
            ("random, not sure", rnd_bg, rnd_safe, ~true, 1.0)):
        w1, cst = demote_weights(its, dyn.score_ray)
        kk = demote_ema(vals, b_, s_, sure, radius, w1, cst)
        pp = demote_ema_plain(vals, b_, s_, sure, radius, w1, cst)
        _equal((kk,), (pp,), f"K11d[{name}].grid")
        de[name] = dict(demoted=int((pp != vals).sum()))
    if de["random, its_diff 2"]["demoted"] == 0 or de["random, not sure"]["demoted"] != 0:
        raise AssertionError(f"K11 demotion cases did not exercise both branches: {de}")
    nv = grid.n_voxels
    out.append(dict(
        name="point_ema", max_abs_err=0.0, bytes=nv * (4 + 4 + 1 + 4 + 1), ops=nv * 6,
        library_ms=None,
        ms=cuda_ms(lambda: point_ema(vals, counts, bg.close, sp, su)),
        plain_ms=cuda_ms(lambda: point_ema_plain(vals, counts, bg.close, sp, su)),
        cases=pe, shapes=f"{grid.shape}, bit-equal",
    ))
    out.append(dict(
        name="demote_ema", max_abs_err=0.0, bytes=nv * (1 + 1 + 4 + 4),
        ops=nv * len(ball_taps(radius)), library_ms=None,
        ms=cuda_ms(lambda: demote_ema(vals, bgm, node.state.safe, true, radius, 0.5, -500.0)),
        plain_ms=cuda_ms(lambda: demote_ema_plain(vals, bgm, node.state.safe, true, radius,
                                                  0.5, -500.0)),
        cases=de, shapes=f"{grid.shape}, ball r={radius:g}, bit-equal",
    ))
    return out


def phase2_ingest(cfg, grid, lut, scans, n_scan, k3, ranges, pose) -> list[dict]:
    """K15a and the native host binner on a flagship scan: the unpack
    bit-equal to its plain version, the binner's counts (clamped to 63) and
    blockers bit-equal to K3's and the raw frontend's on the same scan; the
    host bin's time over the cycle and the packed upload's."""
    dev = ranges.device
    r_np, pose_np = scans[n_scan]
    hb = HostBinner(cfg, lut)
    if not hb.native:
        raise AssertionError("the host binner is not the native one")
    b = hb.bin(r_np, pose_np)
    packed = torch.as_tensor(b.packed, device=dev)
    ku, pu = unpack(packed), unpack_plain(packed)
    _equal(ku, pu, "K15a.counts K15a.blockers")
    raw = run_frontend(cfg, grid, torch.as_tensor(lut.directions, device=dev),
                       torch.as_tensor(lut.offsets, device=dev), ranges, pose)
    _equal((ku[0], ku[1]), (k3[0].clamp(max=63), raw.blockers),
           "binner-vs-K3.counts binner-vs-raw.blockers")
    if not (b.n_valid_points == int(k3[1]) and b.n_exclude_hits == int(raw.n_exclude_hits)):
        raise AssertionError(f"binner counts ({b.n_valid_points}, {b.n_exclude_hits}) differ "
                             f"from the raw frontend's ({int(k3[1])}, {int(raw.n_exclude_hits)})")
    bin_ms = []
    for r, p in scans:
        t0 = time.perf_counter()
        hb.bin(r, p)
        bin_ms.append((time.perf_counter() - t0) * 1e3)
    staging = [torch.empty(n, dtype=dt, pin_memory=True) for n, dt in (
        (grid.n_voxels, torch.uint8), (cfg.sensor.n_points, torch.uint8), (2, torch.int32))]
    upload_ms = cuda_ms(lambda: [t.to(dev, non_blocking=True) for t in staging])
    nv = grid.n_voxels
    say("2-ingest", host_bin_ms_p50=float(np.percentile(bin_ms, 50)),
        host_bin_ms_p95=float(np.percentile(bin_ms, 95)), host_bin_scans=len(bin_ms),
        packed_upload_ms=upload_ms, packed_upload_bytes=nv + cfg.sensor.n_points + 8,
        n_valid_points=b.n_valid_points, n_exclude_hits=b.n_exclude_hits,
        clamped_voxels=int((k3[0] > 63).sum()), blocker_voxels=int(ku[1].sum()))
    return [dict(
        name="unpack", max_abs_err=0.0, ms=cuda_ms(lambda: unpack(packed)),
        plain_ms=cuda_ms(lambda: unpack_plain(packed)),
        bytes=nv * (1 + 4 + 1), ops=2 * nv,
        library_ms=cuda_ms(lambda: (packed & 0x3F, packed >= 0x80)),
        library_call="packed & 0x3F and packed >= 0x80 (two torch ops, uint8 counts)",
        shapes=f"{grid.shape} uint8 -> int32 counts + bool blockers; bit-equal, and equal to "
               f"K3 + the raw frontend on the same scan",
    )]


def phase2_taps(cfg, grid, vals, occupied, safe) -> list[dict]:
    """The stencil kernels past 256 taps (K1, K2, K11's demotion; halo 4, 5,
    6 and 7, int32 tiles above 48 KB of shared memory from halo 6), and K14's
    shell pools at the dynamic-radii path's tap sets, bit-equal to their
    plain versions; K14's time beside K1's static pool on the same ball."""
    dyn = DynParams()
    dev = vals.device
    bg = vals > dyn.thr_new_obstacles
    sure = (vals > dyn.thr_sure_obstacles).to(torch.int32)
    nv = grid.n_voxels
    keys = torch.where(bg, torch.arange(nv, dtype=torch.int32, device=dev).reshape(grid.shape),
                       SENTINEL)
    cases = {}
    for rad, a, op, fill in ((4.0, bg.to(torch.int8), "max", 0), (5.0, sure, "sum", 0),
                             (6.0, keys, "max", -2**31), (7.99, keys, "min", SENTINEL)):
        k, p = ball_pool(a, rad, op, fill), ball_pool_plain(a, rad, op, fill)
        _equal((k,), (p,), f"K1[r{rad}].out")
        cases[f"K1 {a.dtype} {op} r{rad} ({len(ball_taps(rad))} taps)"] = cuda_ms(
            lambda: ball_pool(a, rad, op, fill), reps=5)
    flat = torch.arange(nv, dtype=torch.int32, device=dev).reshape(grid.shape)
    keys0 = torch.where(occupied, (nv - 1) - flat, SENTINEL)
    reach0 = (bg & (sure > 0)).to(torch.uint8)
    for rad, init, occ in ((4.0, keys0, occupied), (5.0, reach0, bg), (7.99, keys0, occupied)):
        _equal(sweeps(init, occ, rad, 4), sweeps_plain(init, occ, rad, 4),
               f"K2[r{rad}].grid K2[r{rad}].flags")
        cases[f"K2 {init.dtype} r{rad} ({len(ball_taps(rad))} taps), per sweep"] = cuda_ms(
            lambda: sweeps(init, occ, rad, 4), reps=3) / 4
    true = torch.ones((), dtype=torch.bool, device=dev)
    for rad in (4.0, 5.0, 7.99):
        _equal((demote_ema(vals, bg, safe, true, rad, 0.5, -500.0),),
               (demote_ema_plain(vals, bg, safe, true, rad, 0.5, -500.0),), f"K11d[r{rad}].grid")
        cases[f"K11 demotion r{rad} ({len(ball_taps(rad))} taps)"] = cuda_ms(
            lambda: demote_ema(vals, bg, safe, true, rad, 0.5, -500.0), reps=5)
    # K14 at the dynamic path's tap sets: bg_near at the 2 m bound (1.0 m:
    # r² 4), the local-sure sum at bound 5 (1.9 m: r² 25, 515 taps; 0.8 m:
    # r² 9), the demotion shells at bound 4 (0.8 m: r² 2.5600002)
    shells = []
    for bound, r2, a, op in ((4.0, 4.0, bg.to(torch.int8), "max"), (5.0, 25.0, sure, "sum"),
                             (5.0, 9.0, sure, "sum"),
                             (4.0, float(np.float32(1.6) * np.float32(1.6)), bg.to(torch.int8),
                              "max")):
        taps = shell_taps(bound, r2)
        k, p = shell_pool(a, r2, bound, op, 0), tap_pool_plain(a, taps, op, 0)
        _equal((k,), (p,), f"K14[b{bound} r2 {r2}].out")
        shells.append(f"{a.dtype} {op} bound {bound} r2 {r2:.7g} ({len(taps)} taps)")
    say("2-lifted-cap", ms=cases, k14_cases=shells)
    k14_ms = cuda_ms(lambda: shell_pool(sure, 25.0, 5.0, "sum", 0))
    return [dict(
        name="shell_pool", max_abs_err=0.0, ms=k14_ms,
        plain_ms=cuda_ms(lambda: tap_pool_plain(sure, shell_taps(5.0, 25.0), "sum", 0), reps=3),
        bytes=2 * 4 * nv, ops=nv * len(shell_taps(5.0, 25.0)),
        library_ms=cuda_ms(lambda: ball_pool(sure, 5.0, "sum", 0)),
        library_call="K1's static pool on the same ball (int32 sum r5, 515 taps)",
        shapes=f"{grid.shape} int32 sum, bound 5, r² 25 (1.9 m): 515 taps, halo 5; cases "
               f"{shells} bit-equal",
    )]


def exact_config() -> VoFODConfig:
    """The reference-exact configuration at the flagship size."""
    return VoFODConfig(sepclusters_exact_census=True, compat_hascloseto_bounds=True,
                       compat_counted_indexing=True)


def _rel_stats(a: torch.Tensor, b: torch.Tensor) -> dict:
    """|a - b| / |b| over the voxels where b > 0: max and 99.9th percentile."""
    nz = b > 0
    r = ((a[nz].double() - b[nz].double()).abs() / b[nz].double())
    q = torch.quantile(r[torch.randperm(r.numel(), device=r.device)[:1_000_000]], 0.999)
    return dict(max=float(r.max()), p999=float(q), n_differ=int((a[nz] != b[nz]).sum()))


def phase2_exact(lut) -> list[dict]:
    """K12, K13 and the exact path's K1 / K2 uses against their plain
    versions, on a flagship exact scan and on synthetic cases."""
    dev = torch.device("cuda")
    cfg, dyn = exact_config(), DynParams()
    grid = GridSpec.from_config(cfg)
    nv = grid.n_voxels
    node = VoFOD(cfg, dyn, NodeOptions(raycast_mode="exact"), lut, device=dev)
    node.load_apriori_map(apriori_ground())
    scans = scan_cycle(lut, N_SCANS)
    for r, p in scans[:6]:
        node.process_scan(r, None, p)
    r_np, pose_np = scans[6]
    vals = node.state.grid
    H, W = lut.height, lut.width
    ranges_m = torch.as_tensor(r_np.astype(np.float32), device=dev) * 0.001
    ones = torch.ones(H * W, dtype=torch.float32, device=dev)
    pose = torch.as_tensor(pose_np, device=dev)
    rays = exact_rays(cfg, dyn, grid, torch.as_tensor(lut.directions, device=dev),
                      torch.as_tensor(lut.offsets, device=dev),
                      torch.ones(H * W, dtype=torch.bool, device=dev), ranges_m, ones, pose)
    bound = cfg.raycast_max_distance_bound
    out = []

    # K12 walk: against the plain version's sequential float32 sum on the
    # host CPU (the JAX order; the plain version on the card adds with
    # atomics) and against the float64 sum of the same chords rounded once,
    # which the kernel's float64 atomics give up to one ulp; five walks
    k12 = raycast_dda(grid, *rays, bound)
    cpu_rays = [t.cpu() for t in rays]
    fid_c, w_c = dda_emissions_plain(grid, *cpu_rays, bound)
    p12 = torch.zeros(nv, dtype=torch.float32).index_add_(0, fid_c, w_c).reshape(grid.shape)
    p12 = p12.to(dev)
    e64 = torch.zeros(nv, dtype=torch.float64).index_add_(0, fid_c, w_c.double())
    e64 = e64.reshape(grid.shape).to(dev)
    e12 = e64.float()
    ulp = torch.nextafter(e12, torch.full_like(e12, float("inf"))) - e12
    if not torch.equal(k12 > 0, p12 > 0):
        raise AssertionError(f"K12: nonzero voxels differ in {int(((k12 > 0) != (p12 > 0)).sum())}")
    rel = _rel_stats(k12, p12)
    walks = [k12] + [raycast_dda(grid, *rays, bound) for _ in range(4)]
    off_ulp = [int((w_ != e12).sum()) for w_ in walks]
    if not (rel["max"] <= K12_RAYLEN_RTOL
            and all(bool(((w_ - e12).abs() <= ulp).all()) for w_ in walks)):
        raise AssertionError(f"K12 raylen: {rel} (tol {K12_RAYLEN_RTOL}); voxels off the "
                             f"rounded float64 sum in five walks {off_ulp}")
    fid_d, w_d = fid_c.to(dev), w_c.to(dev)
    zero_grid = torch.zeros(nv, dtype=torch.float32, device=dev)
    n_emit = int(fid_c.numel())
    out.append(dict(
        name="dda", max_abs_err=max_abs(k12, p12), rel=rel, tol_rel=K12_RAYLEN_RTOL,
        sequential_own_rel=_rel_stats(p12.double(), e64)["max"],
        off_rounded_f64_sum_per_walk=off_ulp,
        walks_identical=all(torch.equal(w_, k12) for w_ in walks),
        nonzero_voxels=int((p12 > 0).sum()), emissions=n_emit,
        valid_rays=int(rays[3].sum()), max_voxel_raylen=float(p12.max()),
        ms=cuda_ms(lambda: raycast_dda(grid, *rays, bound)),
        plain_ms=cuda_ms(lambda: raycast_dda_plain(grid, *rays, bound), reps=3),
        # rays in, the raylen grid out once; ~20 ops per walked step
        bytes=rays[0].shape[0] * (12 + 12 + 4 + 1) + nv * 4, ops=n_emit * 20,
        library_ms=cuda_ms(lambda: zero_grid.index_add_(0, fid_d, w_d)),
        library_call="index_add_ of the walk's nonzero (id, chord) emissions",
        shapes=f"{rays[0].shape[0]} rays x <= {dda_n_steps(grid.voxel_size, bound)} steps -> "
               f"{grid.shape}",
    ))

    # K12 EMA pass: both rules, its_diff 1 and 2, on the kernel's raylen
    # (bit-equal expected), and walk + EMA against the host plain raylen
    counts = frontend_bin(cfg, grid, torch.as_tensor(lut.directions, device=dev),
                          torch.as_tensor(lut.offsets, device=dev),
                          torch.as_tensor(r_np.astype(np.float32), device=dev), pose)[0]
    had = counts > 0
    ema_cases = {}
    for new_rule in (True, False):
        for its in (1.0, 2.0):
            ema = ray_ema(cfg, dataclasses.replace(dyn, raycast_new_update_rule=new_rule), its)
            name = f"{'new' if new_rule else 'old'} rule, its_diff {its:g}"
            a = ray_ema_grid_(vals.clone(), had, k12, ema)
            b = ray_ema_plain(vals, k12, had, ema)
            _equal((a,), (b,), f"K12e[{name}].grid")
            # walk + EMA against the EMA of the sequential raylen: the same
            # nonzero raylen voxels (checked above), the grid within K5b's
            # bound; a chord of a few ulps can move w1 to or from exactly 1,
            # so the sets of changed voxels may differ by a few voxels
            c = ray_ema_plain(vals, p12, had, ema)
            fin = torch.isfinite(c)
            full = dict(max_abs=max_abs(a[fin], c[fin]), n_diff=int((a[fin] != c[fin]).sum()),
                        changed_differ=int(((a != vals) != (c != vals)).sum()))
            if not (torch.equal(fin, torch.isfinite(a))
                    and full["max_abs"] <= K5B_TOL_REL * abs(dyn.score_ray)):
                raise AssertionError(f"K12 walk+EMA {name}: {full}")
            ema_cases[name] = dict(changed=int((b != vals).sum()), walk_and_ema=full)
    ema1 = ray_ema(cfg, dyn, 1.0)
    work = vals.clone()
    out.append(dict(
        name="ray_ema", max_abs_err=0.0, cases=ema_cases,
        tol_walk_and_ema=K5B_TOL_REL * abs(dyn.score_ray),
        ms=cuda_ms(lambda: ray_ema_grid_(work, had, k12, ema1)),
        plain_ms=cuda_ms(lambda: ray_ema_plain(vals, k12, had, ema1)),
        bytes=nv * (4 + 1 + 4 + 4), ops=nv * 8, library_ms=None,
        shapes=f"{grid.shape}; EMA on the kernel's raylen bit-equal",
    ))

    # K2 to convergence: the scan's coarse cells, a random field of small
    # components (converges), voxels 3 apart (sweep 0 is the fixpoint, so
    # the even 128th launch returns the buffer no sweep wrote) and a
    # serpentine corridor across the z = 0 plane (~12,000 voxels long: the
    # cap binds)
    bg = vals > dyn.thr_new_obstacles
    sure = vals > dyn.thr_sure_obstacles
    mv = int(np.ceil(cfg.sepclusters_max_bg_distance / cfg.voxel_size))
    lsz = max(mv - 1, 1)
    occ_c = pool_sum_coarse(bg.to(torch.int32), lsz) > 0
    g = torch.Generator(device=dev).manual_seed(12)
    rnd_occ = torch.rand(grid.shape, generator=g, device=dev) < 0.01
    iso_occ = torch.zeros(grid.shape, dtype=torch.bool, device=dev)
    iso_occ[::3, ::3, ::3] = True
    serp = torch.zeros(grid.shape, dtype=torch.bool, device=dev)
    serp[0, ::4, :] = True
    for y in range(0, grid.shape[1] - 4, 4):
        serp[0, y:y + 4, -1 if (y // 4) % 2 == 0 else 0] = True
    k2 = {}
    for name, occ in (("scan cells", occ_c), ("random 1 %", rnd_occ),
                      ("isolated", iso_occ), ("serpentine", serp)):
        kl = label_components(occ, mv / lsz, 128)
        pl = label_components_plain(occ, mv / lsz, 128)
        _equal(kl, pl, f"K2c[{name}].labels K2c[{name}].converged K2c[{name}].sweeps")
        k2[name] = dict(converged=bool(pl[1]), sweeps=int(pl[2]),
                        ms=cuda_ms(lambda: label_components(occ, mv / lsz, 128), reps=3),
                        plain_ms=cuda_ms(lambda: label_components_plain(occ, mv / lsz, 128),
                                         reps=1))
    flat = torch.arange(nv, dtype=torch.int32, device=dev).reshape(grid.shape)
    if not (k2["random 1 %"]["converged"] and k2["scan cells"]["sweeps"] >= 2
            and k2["isolated"]["converged"] and k2["isolated"]["sweeps"] == 1
            and torch.equal(label_components(iso_occ, mv / lsz, 128)[0],
                            torch.where(iso_occ, flat, SENTINEL))
            and not k2["serpentine"]["converged"] and k2["serpentine"]["sweeps"] == 128):
        raise AssertionError(f"K2 convergence cases: {k2}")

    # K13b: the scan's grids, and random fields at leaf sizes 1 and 2
    k13b = {}
    rnd_bg = torch.rand(grid.shape, generator=g, device=dev) < 0.3
    rnd_sure = torch.rand(grid.shape, generator=g, device=dev) < 0.4
    for name, b_, s_, l_ in (("scan", bg, sure, lsz), ("random", rnd_bg, rnd_sure, 1),
                             ("random, leaf 2", rnd_bg, rnd_sure, 2)):
        kq = quirk_sure_counts(b_, s_, l_)
        pq = quirk_sure_counts_plain(b_, s_, l_)
        _equal((kq,), (pq,), f"K13b[{name}].counts")
        k13b[name] = dict(total=int(pq.sum()), moved_cells=int(
            (pq != pool_sum_coarse((b_ & s_).to(torch.int32), l_)).sum()))
    bg_e = bg.permute(2, 1, 0).reshape(-1).to(torch.int32)
    nc = occ_c.numel()
    out.append(dict(
        name="quirk_counts", max_abs_err=0.0, cases=k13b,
        ms=cuda_ms(lambda: quirk_sure_counts(bg, sure, lsz)),
        plain_ms=cuda_ms(lambda: quirk_sure_counts_plain(bg, sure, lsz)),
        bytes=2 * nv + nc * 4, ops=4 * nv,
        library_ms=cuda_ms(lambda: torch.cumsum(bg_e, 0)),
        library_call="torch.cumsum of the bg mask in export order (int32)",
        shapes=f"{grid.shape}, leaf {lsz}; bit-equal",
    ))

    # K13a: the census over the scan's labels (quirk counts), and random
    sure_c = quirk_sure_counts(bg, sure, lsz)
    labels, _, _ = label_components(occ_c, mv / lsz, 128)
    min_sure = float(np.float32(dyn.sepclusters_min_sure_points))
    rnd_vals = torch.randint(0, 4, grid.shape, generator=g, device=dev, dtype=torch.int32)
    rnd_lab = label_components(rnd_occ, 2.0, 128)[0]
    k13a = {}
    for name, lab, v_, o_ in (("scan", labels, sure_c, occ_c),
                              ("random", rnd_lab, rnd_vals, rnd_occ)):
        kc = label_census(lab, v_, o_, o_.numel(), min_sure)
        pc = label_census_plain(lab, v_, o_, o_.numel(), min_sure)
        _equal(kc, pc, f"K13a[{name}].census K13a[{name}].flags")
        k13a[name] = dict(flags=pc[1].tolist(), sure_cells=int((pc[0] >= min_sure).sum()))
    occ_ids = labels[occ_c].long()
    occ_vals = sure_c[occ_c].float()
    out.append(dict(
        name="label_census", max_abs_err=0.0, cases=k13a, label_components=k2,
        ms=cuda_ms(lambda: label_census(labels, sure_c, occ_c, nc, min_sure)),
        plain_ms=cuda_ms(lambda: label_census_plain(labels, sure_c, occ_c, nc, min_sure)),
        bytes=nc * (4 + 4 + 1 + 4), ops=nc * 4,
        library_ms=cuda_ms(lambda: torch.bincount(occ_ids, weights=occ_vals, minlength=nc)),
        library_call="torch.bincount of the occupied cells' labels weighted by their counts",
        shapes=f"{tuple(occ_c.shape)} cells; bit-equal",
    ))

    # K13c: sure_sufficient True (the scan) and False (no sure cell, a
    # previous value of False), its_diff 1 and 3
    census, flags = label_census(labels, sure_c, occ_c, nc, min_sure)
    radius = cfg.sepclusters_max_bg_distance / cfg.voxel_size
    t_ = torch.ones((), dtype=torch.bool, device=dev)
    no_sure = torch.stack([flags[0], ~t_])
    k13c = {}
    for name, fl, prev, its in (("scan", flags, ~t_, 1.0), ("scan, its_diff 3", flags, ~t_, 3.0),
                                ("no sure cell", no_sure, ~t_, 1.0)):
        w1, _ = demote_weights(its, dyn.score_ray)
        args = (vals, occ_c, census, fl, prev, lsz, radius, min_sure, w1,
                float(np.float32(dyn.score_ray)), float(np.float32(dyn.thr_new_obstacles)))
        kk, pp = exact_demote_ema(*args), exact_demote_ema_plain(*args)
        _equal(kk, pp, f"K13c[{name}].grid K13c[{name}].safe K13c[{name}].sure")
        k13c[name] = dict(sure_sufficient=bool(pp[2]), demoted=int((pp[0] != vals).sum()),
                          safe=int(pp[1].sum()))
    if not (k13c["scan"]["sure_sufficient"] and k13c["scan"]["demoted"] > 0
            and k13c["no sure cell"]["demoted"] == 0):
        raise AssertionError(f"K13c cases did not exercise both branches: {k13c}")
    args = (vals, occ_c, census, flags, ~t_, lsz, radius, min_sure,
            demote_weights(1.0, dyn.score_ray)[0],
            float(np.float32(dyn.score_ray)), float(np.float32(dyn.thr_new_obstacles)))
    out.append(dict(
        name="exact_demote_ema", max_abs_err=0.0, cases=k13c,
        ms=cuda_ms(lambda: exact_demote_ema(*args)),
        plain_ms=cuda_ms(lambda: exact_demote_ema_plain(*args)),
        bytes=nv * (4 + 4 + 1) + nc * (1 + 4), ops=nv * (len(ball_taps(radius)) + 10),
        library_ms=None, shapes=f"{grid.shape}, ball r={radius:g}, leaf {lsz}; bit-equal",
    ))
    for r in out:
        say("2-kernel", **r)
    return out


def sequential_config() -> VoFODConfig:
    """The reference-exact configuration with the reference's own explore
    order (tests/test_sequential_demotion.py:218-222) at the flagship size."""
    return dataclasses.replace(exact_config(), sequential_explore=True)


def _inplace_ms(fn, base: torch.Tensor, reps: int = 20) -> float:
    """Mean device time of fn(grid) over ``reps`` fresh clones of ``base``
    (for a kernel that updates the grid in place), after one warm-up."""
    clones = [base.clone() for _ in range(reps + 1)]
    fn(clones[0])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for c in clones[1:]:
        fn(c)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _seq_queries(grid: GridSpec, ids: torch.Tensor, cluster: torch.Tensor, valid: torch.Tensor,
                 m_q: torch.Tensor, Q: int, K: int):
    """A K7s query table of Q slots from flat ids, cluster slots and bounds
    (the first len(ids) slots; the rest invalid); a cluster's label is its
    least member id, as the component labels are."""
    dev = ids.device
    n = ids.shape[0]
    qids = torch.zeros(Q, dtype=torch.int32, device=dev)
    qids[:n] = ids.to(torch.int32)
    qvalid = torch.zeros(Q, dtype=torch.bool, device=dev)
    qvalid[:n] = valid
    slot = torch.full((Q,), -1, dtype=torch.int64, device=dev)
    slot[:n] = cluster
    qslot = qvalid[:, None] & (slot[:, None] == torch.arange(K, device=dev)[None, :])
    lab = torch.full((K,), SENTINEL, dtype=torch.int32, device=dev).scatter_reduce(
        0, cluster, ids.to(torch.int32), "amin")
    qlabels = torch.where(qvalid, lab[slot.clamp(min=0)], SENTINEL)
    mm = torch.zeros(Q, dtype=torch.int32, device=dev)
    mm[:n] = m_q
    qx, qy, qz = (t.to(torch.int32) for t in grid.unflatten_id(qids))
    return qx, qy, qz, qvalid, qlabels, qids, qslot, mm


def phase2_sequential(lut) -> list[dict]:
    """K7s against its plain version (a host loop over K7's and K8's plain
    versions) on the card, bit-equal on the grid, the clusters' connected
    flags and the write count: (a) the classify inputs of a flagship
    sequential-explore scan with valid queries, (b) the adversarial scene of
    tests/test_sequential_demotion.py stamped into the flagship grid
    (floating, every carved cell demoted), (c) 256 valid queries over a
    random field in 32 clusters, (d) the same under query overflow, (e) no
    valid query."""
    dev = torch.device("cuda")
    cfg, dyn = sequential_config(), DynParams()
    grid = GridSpec.from_config(cfg)
    S, K, Q = cfg.explore_submap, cfg.max_clusters, cfg.max_queries
    thr_f, thr_g = dyn.thr_frontiers, dyn.thr_new_obstacles
    no, yes = (torch.tensor(v, device=dev) for v in (False, True))
    cases, results = {}, {}

    # (a) a flagship scan of the sequential node with valid queries: its
    # classify inputs rebuilt from the state before it (frontend, split and
    # point update, K9, the query compaction), as the step builds them
    node = VoFOD(cfg, dyn, NodeOptions(raycast_mode="exact"), lut, device=dev)
    node.load_apriori_map(apriori_ground())
    dirs = torch.as_tensor(lut.directions, device=dev)
    offs = torch.as_tensor(lut.offsets, device=dev)
    for k, (r, p) in enumerate(scan_cycle(lut, N_SCANS)):
        st = node.state
        before = (st.grid.clone(), st.bg_sufficient.clone(), st.sure_bg_sufficient.clone())
        node.process_scan(r, None, p)
        if int(node.last_diag.n_queries) > 0:
            break
    prev_grid, prev_bg, prev_sure = before
    pose = torch.as_tensor(p, device=dev)
    counts = frontend_bin(cfg, grid, dirs, offs, torch.as_tensor(r.astype(np.float32), device=dev),
                          pose)[0]
    bg = split_and_update(cfg, dyn, prev_grid, counts, prev_bg)
    fids, fvalid, ftotal = masked_compact(bg.far, cfg.max_far_voxels)
    stats = cluster_stats(dyn, grid, K, fids, fvalid, bg.labels.reshape(-1)[fids.long()], ftotal,
                          pose[:3, 3].contiguous(), bg.bg_sufficient, prev_sure)
    qids, qvalid, qtotal, qx, qy, qz, qlabels, qslot, m_q = explore_queries(
        grid, bg.far, bg.labels, stats, Q)
    scan_q = (qx, qy, qz, qvalid, qlabels, qids, qslot, m_q, qtotal > Q)
    scan_base = bg.grid

    # (b) the adversarial scene
    vals_b = torch.full(grid.shape, float(np.float32(dyn.score_ray)), device=dev)
    bx, by, bz = SEQ_BASE
    for x, y in SEQ_CARVED:
        vals_b[bz, by + y, bx + x] = float(np.float32(dyn.score_unknown))
    ab = torch.tensor([(bz * grid.ny + by) * grid.nx + bx + dx for dx in (0, 2)], device=dev)
    scene_q = (*_seq_queries(grid, ab, torch.zeros(2, dtype=torch.int64, device=dev),
                             torch.ones(2, dtype=torch.bool, device=dev),
                             torch.full((2,), 8, dtype=torch.int32, device=dev), Q, K), no)

    # (c)-(e) 256 valid queries in 32 clusters, starting in the unknown band
    # of a random field below the percolation threshold (air / unknown /
    # ground at 80 / 18 / 2 %); every fourth cluster has bound 0 (its
    # members cannot connect), the others 0-19
    g = torch.Generator(device=dev).manual_seed(14)
    u = torch.rand(grid.shape, generator=g, device=dev)
    unk = 0.5 * (thr_f + thr_g)
    field = torch.where(u < 0.80, -900.0, torch.where(u < 0.98, unk, -100.0)).float()
    band = torch.nonzero(field.reshape(-1) == unk)[:, 0]
    pick = band[torch.randperm(band.shape[0], generator=g, device=dev)[:Q]]
    cluster = torch.arange(Q, device=dev) % K
    bound = torch.randint(0, 20, (Q,), generator=g, device=dev, dtype=torch.int32)
    rnd = _seq_queries(grid, pick, cluster, torch.ones(Q, dtype=torch.bool, device=dev),
                       torch.where(cluster % 4 == 0, 0, bound).to(torch.int32), Q, K)
    none = _seq_queries(grid, pick, torch.arange(Q, device=dev) % K,
                        torch.zeros(Q, dtype=torch.bool, device=dev),
                        torch.zeros(Q, dtype=torch.int32, device=dev), Q, K)

    runs = {"(a) flagship scan": (scan_base, scan_q), "(b) adversarial scene": (vals_b, scene_q),
            "(c) 256 queries, 32 clusters": (field, (*rnd, no)),
            "(d) query overflow": (field, (*rnd, yes)), "(e) no valid query": (field, (*none, no))}
    for name, (base, q) in runs.items():
        kg, kc, kn = explore_sequential_(grid, base.clone(), *q, thr_f, thr_g, S)
        pg, pc, pn = explore_sequential_plain(grid, base.clone(), *q, thr_f, thr_g, S)
        _equal((kg, kc, kn), (pg, pc, pn), f"K7s{name[:3]}.grid K7s{name[:3]}.connected "
                                           f"K7s{name[:3]}.n_writes")
        results[name] = (pg, pc, pn)
        cases[name] = dict(valid_queries=int(q[3].sum()), overflow=bool(q[8]),
                           clusters_connected=int(pc.sum()), n_writes=int(pn),
                           demoted_voxels=int((pg != base).sum()))
    a, b, c_ = (cases[n] for n in ("(a) flagship scan", "(b) adversarial scene",
                                   "(c) 256 queries, 32 clusters"))
    bg_, bc, bn = results["(b) adversarial scene"]
    carved = torch.stack([bg_[bz, by + y, bx + x] for x, y in SEQ_CARVED])
    checks = dict(
        scan_matches_step=(a["n_writes"] == int(node.last_diag.n_demoted)
                           and int(qtotal) == int(node.last_diag.n_queries)),
        scene_floating=not bool(bc[0]), scene_carved_demoted=bool((carved == thr_f).all())
        and int(bn) == len(SEQ_CARVED),
        random_both_verdicts=0 < c_["clusters_connected"] < K and c_["n_writes"] > 0,
        overflow_and_empty_untouched=all(
            cases[n]["n_writes"] == 0 and cases[n]["clusters_connected"] == 0
            for n in ("(d) query overflow", "(e) no valid query")))
    if not all(checks.values()):
        raise AssertionError(f"K7s cases: {checks} {cases}")
    ms = _inplace_ms(lambda v: explore_sequential_(grid, v, *scan_q, thr_f, thr_g, S), scan_base)
    plain_ms = _inplace_ms(lambda v: explore_sequential_plain(grid, v, *scan_q, thr_f, thr_g, S),
                           scan_base, reps=1)
    syn_ms = _inplace_ms(lambda v: explore_sequential_(grid, v, *rnd, no, thr_f, thr_g, S), field)
    n_valid = a["valid_queries"]
    out = [dict(
        name="explore_seq", max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
        # each valid query's S^3 submap read once, each write once, the
        # query table in, the K flags and the count out
        bytes=n_valid * S**3 * 4 + a["n_writes"] * 4 + Q * (6 * 4 + 1 + K) + K + 4,
        ops=n_valid * S**3 * 7 + Q * Q, library_ms=None, cases=cases, checks=checks,
        scan_index=k, synthetic_ms=syn_ms,
        shapes=f"Q={Q}, K={K}, S={S}, one block; ms/plain_ms: case (a) ({n_valid} valid "
               f"queries, each launch on a fresh copy of the grid); synthetic_ms: case (c)",
    )]
    for r_ in out:
        say("2-kernel", **r_)
    return out


def phase3() -> None:
    """tests/test_golden.py's replay and assertions, kernels on."""
    z = np.load(ROOT / "tests" / "fixtures" / "golden_small.npz")
    cfg = VoFODConfig(
        sensor=SensorConfig(vertical_rays=16, horizontal_rays=64, vertical_fov=np.deg2rad(90.0)),
        oparea=Box((0.0, 0.0, 4.0), (16.0, 16.0, 12.0)),
        background_sufficient_points_ratio=0.05,
        max_clusters=4, max_far_voxels=256, max_queries=64,
        explore_submap=16, confidence_submap=8,
    )
    node = VoFOD(cfg, DynParams(), NodeOptions(raycast_mode="sweep"), device="cuda")
    xs = np.arange(-4.0, 4.0, 0.5)
    gx, gy = np.meshgrid(xs, xs)
    node.load_apriori_map(np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=1))
    kernels.reset_launch_counts()
    msgs = [node.process_scan(r, None, p) for r, p in zip(z["ranges"], z["poses"])]
    launches = kernels.launch_counts()
    first = next(i for i, m in enumerate(msgs) if m.detections)
    assert first == int(z["first_detection_scan"]), first
    det = msgs[-1].detections
    assert len(det) == 1, len(det)
    np.testing.assert_allclose(np.array(det[0].position), z["expected_position"], atol=0.26)
    assert det[0].n_points == int(z["expected_n_points"])
    np.testing.assert_allclose(det[0].confidence, float(z["expected_confidence"]), atol=0.05)
    np.testing.assert_allclose(det[0].detection_probability, float(z["expected_pdet"]), atol=1e-4)
    g = node.state.grid.cpu().numpy()
    checksum = float(g[np.isfinite(g)].sum())
    np.testing.assert_allclose(checksum, float(z["grid_checksum"]), rtol=1e-4)
    assert all(launches[k] > 0 for k in SWEEP_KERNELS), launches
    say("3-golden", ok=True, first_detection_scan=first, position=list(det[0].position),
        n_points=det[0].n_points, confidence=det[0].confidence, grid_checksum=checksum,
        expected_checksum=float(z["grid_checksum"]), launches=launches)


def phase4(lut) -> dict:
    """The flagship main path: 36 scans through VoFOD(device="cuda")."""
    cfg = VoFODConfig()
    node = VoFOD(cfg, DynParams(), NodeOptions(), lut, device="cuda")
    n_apriori = node.load_apriori_map(apriori_ground())
    scans = scan_cycle(lut, N_SCANS)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    step_ms, syncs, n_dets, n_queries, n_demoted = [], [], [], [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for r, p in scans:
                before = len(caught)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                pending = node.process_scan_async(r, None, p)
                end.record()
                msg = node.fetch_result(pending)
                step_ms.append(start.elapsed_time(end))
                syncs.append(sum(1 for w in caught[before:] if "synchroniz" in str(w.message)))
                n_dets.append(len(msg.detections))
                n_queries.append(int(node.last_diag.n_queries))
                n_demoted.append(int(node.last_diag.n_demoted))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    launches = kernels.launch_counts()
    d = node.last_diag
    g = node.state.grid
    assert bool(d.bg_sufficient), "background never became sufficient"
    assert not bool(torch.isnan(g).any()) and not bool(torch.isneginf(g).any()), "grid not finite"
    assert max(syncs) <= 1, f"host syncs per scan: {syncs}"
    missing = [k for k in SWEEP_KERNELS if launches[k] == 0]
    assert not missing, f"kernels never launched on the sweep path: {missing}"
    # the ray stage (new update rule: one K5b launch), detect and both EMA
    # passes run once on every flagship scan
    not_once = {k: launches[k] for k in ONCE_PER_SCAN if launches[k] != N_SCANS}
    assert not not_once, f"launches over {N_SCANS} scans, expected once per scan: {not_once}"
    out = dict(
        scans=N_SCANS, grid=list(cfg.grid_shape), rays=cfg.sensor.n_points,
        apriori_voxels=n_apriori,
        step_ms_p50=float(np.percentile(step_ms, 50)),
        step_ms_p95=float(np.percentile(step_ms, 95)),
        step_ms_all=[round(x, 3) for x in step_ms],
        host_syncs_per_scan=float(np.mean(syncs)), host_syncs_max=int(max(syncs)),
        detections_last_scan=n_dets[-1], detections_total=int(sum(n_dets)),
        scans_with_detection=int(sum(1 for n in n_dets if n)),
        explore_queries_total=int(sum(n_queries)), demotion_writes_total=int(sum(n_demoted)),
        scans_with_queries=int(sum(1 for n in n_queries if n)),
        explore_queries_per_scan=n_queries, demotion_writes_per_scan=n_demoted,
        bg_sufficient=bool(d.bg_sufficient), sure_bg_sufficient=bool(d.sure_bg_sufficient),
        n_bg_voxels=int(d.n_bg_voxels), cc_iters=int(d.cc_iters),
        launches=launches, launches_per_scan={k: v / N_SCANS for k, v in launches.items()},
    )
    say("4-flagship", **out)
    return launches, out["step_ms_p50"]


def phase4_raycast_every(lut, n: int = 6) -> None:
    """``NodeOptions(raycast_every=2)`` on the flagship config: the ray
    stage (K5a, K4, K5b) runs on every second scan only."""
    node = VoFOD(VoFODConfig(), DynParams(), NodeOptions(raycast_every=2), lut, device="cuda")
    node.load_apriori_map(apriori_ground())
    scans = scan_cycle(lut, n)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for r, p in scans:
        node.process_scan(r, None, p)
    launches = kernels.launch_counts()
    g = node.state.grid
    assert not bool(torch.isnan(g).any()), "grid not finite"
    ray = {k: launches[k] for k in ("gate_faces", "cone_sweep", "ray_update")}
    assert all(v == n // 2 for v in ray.values()), f"raycast_every=2 over {n} scans: {ray}"
    assert launches["detect"] == n, launches
    say("4-raycast-every", scans=n, raycast_every=2, launches=ray)


def phase4_exact(lut, sequential: bool = False) -> dict:
    """The reference-exact main path: VoFOD(exact config, raycast_mode
    "exact") over the scan cycle, every kernel of the path launched.  With
    ``sequential``, the same with ``cfg.sequential_explore``: K7s once per
    scan and the batched K7 / K8 never."""
    cfg = sequential_config() if sequential else exact_config()
    kernels_of_path = SEQUENTIAL_KERNELS if sequential else EXACT_KERNELS
    once = ONCE_PER_SEQUENTIAL_SCAN if sequential else ONCE_PER_EXACT_SCAN
    node = VoFOD(cfg, DynParams(), NodeOptions(raycast_mode="exact"), lut, device="cuda")
    n_apriori = node.load_apriori_map(apriori_ground())
    scans = scan_cycle(lut, N_EXACT_SCANS)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    step_ms, syncs, n_dets, sweeps, sep_conv, n_queries, n_demoted = [], [], [], [], [], [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for r, p in scans:
                before = len(caught)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                pending = node.process_scan_async(r, None, p)
                end.record()
                msg = node.fetch_result(pending)
                step_ms.append(start.elapsed_time(end))
                syncs.append(sum(1 for w in caught[before:] if "synchroniz" in str(w.message)))
                n_dets.append(len(msg.detections))
                sweeps.append(int(node.last_diag.sep_sweeps))
                sep_conv.append(bool(node.last_diag.sep_converged))
                n_queries.append(int(node.last_diag.n_queries))
                n_demoted.append(int(node.last_diag.n_demoted))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    launches = kernels.launch_counts()
    d = node.last_diag
    g = node.state.grid
    what = "sequential" if sequential else "exact"
    assert bool(d.bg_sufficient), "background never became sufficient"
    assert not bool(torch.isnan(g).any()) and not bool(torch.isneginf(g).any()), "grid not finite"
    assert max(syncs) <= 1, f"host syncs per {what} scan: {syncs}"
    missing = [k for k in kernels_of_path if launches[k] == 0]
    assert not missing, f"kernels never launched on the {what} path: {missing}"
    not_once = {k: launches[k] for k in once if launches[k] != N_EXACT_SCANS}
    assert not not_once, f"launches over {N_EXACT_SCANS} {what} scans, expected once: {not_once}"
    foreign = ("cone_sweep", "gate_faces", "ray_update", "demote_ema") + (
        ("explore_bfs", "demote") if sequential else ("explore_seq",))
    foreign = {k: launches[k] for k in foreign if launches[k]}
    assert not foreign, f"kernels of other paths launched on the {what} path: {foreign}"
    out = dict(
        scans=N_EXACT_SCANS, grid=list(cfg.grid_shape), rays=cfg.sensor.n_points,
        apriori_voxels=n_apriori,
        step_ms_p50=float(np.percentile(step_ms, 50)),
        step_ms_p95=float(np.percentile(step_ms, 95)),
        step_ms_all=[round(x, 3) for x in step_ms],
        host_syncs_per_scan=float(np.mean(syncs)), host_syncs_max=int(max(syncs)),
        label_sweeps_per_scan=sweeps, sep_converged_per_scan=sep_conv,
        detections_per_scan=n_dets, detections_total=int(sum(n_dets)),
        explore_queries_total=int(sum(n_queries)), demotion_writes_total=int(sum(n_demoted)),
        scans_with_queries=int(sum(1 for n in n_queries if n)),
        explore_queries_per_scan=n_queries, demotion_writes_per_scan=n_demoted,
        bg_sufficient=bool(d.bg_sufficient), sure_bg_sufficient=bool(d.sure_bg_sufficient),
        n_bg_voxels=int(d.n_bg_voxels),
        launches=launches,
        launches_per_scan={k: v / N_EXACT_SCANS for k, v in launches.items() if v},
    )
    say("4-sequential" if sequential else "4-exact", **out)
    return launches, out["step_ms_p50"]


def _timed_scan(node, r, p, caught) -> tuple:
    """One scan through ``node``: (message, CUDA-event ms from the enqueue to
    the end of its work, host syncs it made, kernel launches it made)."""
    kernels.reset_launch_counts()
    before = len(caught)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    pending = node.process_scan_async(r, None, p)
    end.record()
    msg = node.fetch_result(pending)
    launches = kernels.launch_counts()
    syncs = sum(1 for w in caught[before:] if "synchroniz" in str(w.message))
    return msg, start.elapsed_time(end), syncs, launches


def _same_scan(a, b, what: str) -> None:
    """Two nodes' results of one scan bit-equal: grid, carried state, the
    diagnostics and the detection messages."""
    for f in ("grid", "safe", "det_counter", "sure_bg_sufficient", "bg_sufficient"):
        if not torch.equal(getattr(a[0].state, f), getattr(b[0].state, f)):
            raise AssertionError(f"{what}: state.{f} differs")
    for f in dataclasses.fields(a[0].last_diag):
        if not np.array_equal(getattr(a[0].last_diag, f.name), getattr(b[0].last_diag, f.name)):
            raise AssertionError(f"{what}: diag.{f.name} differs")
    if a[1].detections != b[1].detections:
        raise AssertionError(f"{what}: detections differ")


def _add(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def phase4_prebinned(lut) -> dict:
    """The prebinned serving ingest at the flagship size: a raw node and a
    ``NodeOptions(frontend_mode="prebinned")`` node over the same 36 scans in
    one process, held bit-equal scan for scan; K15a once per prebinned scan
    and K3 never, 1 host sync per scan on both; step p50/p95 of each and the
    count of steps over 7 ms (both ingests upload from staging buffers
    pinned once)."""
    cfg = VoFODConfig()
    nodes = {m: VoFOD(cfg, DynParams(), NodeOptions(frontend_mode=m), lut, device="cuda")
             for m in ("raw", "prebinned")}
    pre = nodes["prebinned"]
    if not (pre._binner is not None and pre._binner.native and pre._staging is not None):
        raise AssertionError("the CUDA prebinned node does not bin natively into pinned staging")
    for n in nodes.values():
        n.load_apriori_map(apriori_ground())
    scans = scan_cycle(lut, N_SCANS)
    torch.cuda.synchronize()
    ms = {m: [] for m in nodes}
    syncs = {m: [] for m in nodes}
    launches = {m: {} for m in nodes}
    host_ms, n_dets = [], 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for k, (r, p) in enumerate(scans):
            out = {}
            for m, node in nodes.items():
                torch.cuda.set_sync_debug_mode("warn")
                t0 = time.perf_counter()
                try:
                    msg, t, s_, ln = _timed_scan(node, r, p, caught)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                if m == "prebinned":
                    host_ms.append((time.perf_counter() - t0) * 1e3)
                out[m] = (node, msg)
                ms[m].append(t)
                syncs[m].append(s_)
                _add(launches[m], ln)
            _same_scan(out["prebinned"], out["raw"], f"prebinned vs raw, scan {k}")
            n_dets += len(out["raw"][1].detections)
    lp, lr = launches["prebinned"], launches["raw"]
    assert lp.get("unpack", 0) == N_SCANS and lp.get("frontend_bin", 0) == 0, lp
    assert lr.get("frontend_bin", 0) == N_SCANS and lr.get("unpack", 0) == 0, lr
    assert max(syncs["prebinned"]) <= 1 and max(syncs["raw"]) <= 1, syncs
    assert bool(pre.last_diag.bg_sufficient), "background never became sufficient"
    out = dict(
        scans=N_SCANS, bit_equal_to_raw=True, detections_total=n_dets,
        step_ms_p50={m: float(np.percentile(v, 50)) for m, v in ms.items()},
        step_ms_p95={m: float(np.percentile(v, 95)) for m, v in ms.items()},
        step_ms_all={m: [round(x, 3) for x in v] for m, v in ms.items()},
        steps_over_7ms={m: int(sum(1 for x in v if x > 7.0)) for m, v in ms.items()},
        prebinned_host_ms_p50=float(np.percentile(host_ms, 50)),
        host_syncs_per_scan={m: float(np.mean(v)) for m, v in syncs.items()},
        launches_prebinned=lp, launches_raw=lr,
    )
    say("4-prebinned", **out)
    return lp, out["step_ms_p50"]["prebinned"]


def phase4_auto(lut) -> None:
    """``NodeOptions(frontend_mode="auto")`` on the flagship config: the
    probe's choice and every number it measured."""
    node = VoFOD(VoFODConfig(), DynParams(), NodeOptions(frontend_mode="auto"), lut,
                 device="cuda")
    mode = node.options.frontend_mode
    assert mode in ("raw", "prebinned") and (node._binner is not None) == (mode == "prebinned")
    say("4-auto", chose=mode, probe=node.ingest_probe)


DYN_SEGMENTS = ((1.5, 0.8), (1.0, 1.4), (2.0, 1.9))  # (ground_points, sepclusters) m


def phase4_dynamic(lut) -> dict:
    """``cfg.dynamic_radii`` at the flagship size (bounds 2.0 / 2.0 m): the
    radii change every 12 scans, each 12-scan segment held bit-equal to a
    static node at those radii started from the same state; 1 host sync per
    scan, K14 launched, no kernel rebuild when the radii move."""
    cfg = VoFODConfig(dynamic_radii=True, ground_points_max_distance_bound=2.0,
                      sepclusters_max_bg_distance_bound=2.0)
    node = VoFOD(cfg, DynParams(), NodeOptions(), lut, device="cuda")
    node.load_apriori_map(apriori_ground())
    lib, sos = kernels.load(), sorted(kernels._BUILD_DIR.glob("*.so"))
    scans = scan_cycle(lut, N_SCANS)
    seg_len = N_SCANS // len(DYN_SEGMENTS)
    torch.cuda.synchronize()
    launches, segments, syncs = {}, [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i, (g, sep) in enumerate(DYN_SEGMENTS):
            node.update_params(ground_points_max_distance=g, sepclusters_max_bg_distance=sep)
            static = VoFOD(dataclasses.replace(cfg, dynamic_radii=False,
                                               ground_points_max_distance=g,
                                               sepclusters_max_bg_distance=sep),
                           node.dyn, NodeOptions(), lut, device="cuda")
            st = node.state
            static.state = VoFODState(st.grid.clone(), st.safe.clone(), st.det_counter.clone(),
                                      st.step, st.sure_bg_sufficient.clone(),
                                      st.bg_sufficient.clone())
            ms, dets = [], 0
            for k in range(i * seg_len, (i + 1) * seg_len):
                r, p = scans[k]
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    msg, t, s_, ln = _timed_scan(node, r, p, caught)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                ms.append(t)
                syncs.append(s_)
                _add(launches, ln)
                smsg = static.process_scan(r, None, p)
                _same_scan((node, msg), (static, smsg), f"dynamic vs static {g}/{sep} m, scan {k}")
                dets += len(msg.detections)
            segments.append(dict(ground_points_max_distance=g, sepclusters_max_bg_distance=sep,
                                 step_ms_p50=float(np.percentile(ms, 50)),
                                 step_ms_p95=float(np.percentile(ms, 95)), detections=dets))
    rebuilt = kernels.load() is not lib or sorted(kernels._BUILD_DIR.glob("*.so")) != sos
    assert not rebuilt, "the kernel library was rebuilt when the radii changed"
    assert max(syncs) <= 1, f"host syncs per dynamic scan: {syncs}"
    assert launches.get("shell_pool", 0) > 0, launches
    assert bool(node.last_diag.bg_sufficient), "background never became sufficient"
    say("4-dynamic", scans=N_SCANS, segments=segments, bit_equal_to_static=True,
        kernel_rebuilds=0, host_syncs_per_scan=float(np.mean(syncs)), launches=launches,
        launches_per_scan={k: v / N_SCANS for k, v in launches.items() if v})
    return launches, segments[-1]["step_ms_p50"]


def phase4_surface(lut) -> None:
    """The node's runtime surface on the card at the flagship size:
    ``process_rangefinder`` under both validity rules (one voxel per
    accepted hit, by the float32 formula), an NPZ snapshot round trip
    (bit-equal), the LUT consistency check on a rendered scan, a
    ``trace_dir`` window (its file written), and ``profile_stages`` (three
    routine durations > 0 per scan, bit-equal to a fused node)."""
    cfg, dyn = VoFODConfig(), DynParams()
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    scans = scan_cycle(lut, 6)
    out = {}

    pose = hover_pose((40.0, 20.0, 3.0))
    pose[:3, :3] = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32)  # x axis down
    sp = np.float32(dyn.score_point)
    for compat in (False, True):
        node = VoFOD(dataclasses.replace(cfg, compat_rangefinder_validity=compat), dyn,
                     NodeOptions(), lut, device="cuda")
        before = node.state.grid.cpu().numpy().copy()
        short = node.process_rangefinder(0.05, 0.1, 10.0, pose)  # under min_range
        hit = node.process_rangefinder(2.5, 0.1, 10.0, pose)
        after = node.state.grid.cpu().numpy()
        changed = np.nonzero(after != before)
        exact = bool(np.all(after[changed] == (before[changed] + sp) / np.float32(2.0)))
        if not (hit and short == compat and len(changed[0]) == 1 + compat and exact):
            raise AssertionError(f"rangefinder (compat {compat}): accepted {short}, {hit}; "
                                 f"{len(changed[0])} voxels changed, float32 formula {exact}")
        out[f"rangefinder_compat_{compat}"] = dict(accepted=[short, hit],
                                                   voxels_changed=len(changed[0]))

    fused = VoFOD(cfg, dyn, NodeOptions(), lut, device="cuda")
    staged = VoFOD(cfg, dyn, NodeOptions(profile_stages=True, check_consistency=True), lut,
                   device="cuda")
    stage_ms = []
    for k, (r, p) in enumerate(scans):
        pts = (lut.directions * (r.astype(np.float32) * np.float32(1e-3))[:, None]
               + lut.offsets)
        a = fused.process_scan(r, None, p)
        b = staged.process_scan(r, None, p, points_xyz=pts)
        _same_scan((fused, a), (staged, b), f"profile_stages vs fused, scan {k}")
        if not all(v > 0 for v in staged.last_stage_ms.values()):
            raise AssertionError(f"profile_stages: {staged.last_stage_ms}")
        stage_ms.append(staged.last_stage_ms)
    if not (staged._sensor_checked and staged._sensor_params_ok):
        raise AssertionError("check_consistency: the rendered scan failed the LUT check")
    out["profile_stages"] = dict(
        bit_equal_to_fused=True, scans=len(scans),
        routine_ms_p50={n: float(np.median([m[n] for m in stage_ms])) for n in stage_ms[0]},
        events=len(staged.profiling.events))
    out["check_consistency"] = dict(checked=True, ok=staged._sensor_params_ok)

    path = str(work / "snapshot.npz")
    staged.save_snapshot(path)
    back = VoFOD(cfg, dyn, NodeOptions(), lut, device="cuda")
    back.load_snapshot(path)
    for f in dataclasses.fields(back.state):
        a, b = getattr(back.state, f.name), getattr(staged.state, f.name)
        if not (a == b if f.name == "step" else torch.equal(a, b)):
            raise AssertionError(f"snapshot round trip: state.{f.name} differs")
    out["snapshot"] = dict(bit_equal=True, bytes=Path(path).stat().st_size)

    tracer = VoFOD(cfg, dyn, NodeOptions(trace_dir=str(work / "trace"), trace_skip=1,
                                         trace_scans=2), lut, device="cuda")
    for r, p in scans[:4]:
        tracer.process_scan(r, None, p)
    if not (tracer._trace_state == "done" and tracer.trace_path
            and Path(tracer.trace_path).stat().st_size > 0):
        raise AssertionError(f"trace window: {tracer._trace_state} {tracer.trace_path}")
    # the window is the process's first profiler session: its device events
    # per scan, beside phase 5's counts of later sessions
    trace = json.loads(Path(tracer.trace_path).read_text())["traceEvents"]
    cats = ("kernel", "gpu_memcpy", "gpu_memset")
    out["trace"] = dict(scans="1-2", bytes=Path(tracer.trace_path).stat().st_size,
                        device_events_per_scan={c: sum(1 for e in trace if e.get("cat") == c) / 2
                                                for c in cats})
    say("4-surface", **out)


def _global_ext(g: torch.Tensor, z0: int, nzl: int, r: int, fill) -> torch.Tensor:
    """K15b-1's result from the whole grid: its rows [z0 - r, z0 + nzl + r),
    ``fill`` past its edges."""
    pad = torch.full((r,) + tuple(g.shape[1:]), fill, dtype=g.dtype, device=g.device)
    return torch.cat([pad, g, pad])[z0:z0 + nzl + 2 * r]


def _flagship_inputs(lut, n_warm: int = 6):
    """A dense flagship node after the apriori plane and ``n_warm`` scans of
    the cycle, and the next scan (ranges, pose)."""
    node = VoFOD(VoFODConfig(), DynParams(), NodeOptions(), lut, device="cuda")
    node.load_apriori_map(apriori_ground())
    scans = scan_cycle(lut, n_warm + 1)
    for r, p in scans[:n_warm]:
        node.process_scan(r, None, p)
    return node, scans[n_warm]


def _sharded_cones_vs_plain(op, rel_x, rel_y, rel_z, comm):
    """K15b-3 and K15b-4a beside their plain versions, launch by launch, on
    a shard's window slab (inside ``comm.run``): each launch of both gets
    the same inputs, the kernels' rows and carries are exchanged as
    ops/raycast.cone_sweep_lat_sharded and cone_sweep_z_pipelined exchange
    them, and every row block and carry the two produce must be equal.
    Returns the slab's (T6 of the kernels, T6 of the plain versions)."""
    nzl, wy, wx = op.shape
    n, me, dev = comm.n, comm.rank, op.device
    pb = max(wx, wy)
    up = [(i, i + 1) for i in range(n - 1)]
    dn = [(i, i - 1) for i in range(1, n)]
    t6 = [torch.empty((6, nzl, wy, wx), dtype=torch.float32, device=dev) for _ in range(2)]
    bufs = [torch.zeros((nzl, 4, pb), dtype=torch.bfloat16, device=dev) for _ in range(2)]
    plain_out = torch.zeros_like(bufs[0])
    lo = hi = None
    for k in range(pb + 1):
        tmp_in, tmp_out = (bufs[(k + 1) % 2] if k else None), bufs[k % 2]
        kernels.cone_sweep_lat(op, rel_x, rel_y, rel_z, tmp_in, lo, hi, tmp_out, t6[0][:4], k)
        cone_lat_step_plain(op, rel_x, rel_y, rel_z, tmp_in, lo, hi, plain_out, t6[1][:4], k)
        if k < pb:
            if not torch.equal(tmp_out, plain_out):
                raise AssertionError(f"K15b-3 launch {k} shard {me}: rows differ from plain")
            lo, hi = comm.ppermutes([(tmp_out[nzl - 1:nzl], up), (tmp_out[:2], dn)])
    ones = torch.ones((wy, wx), dtype=torch.bfloat16, device=dev)
    carry = torch.stack([ones, ones])
    for r in range(n):
        keep = (me == r, me == n - 1 - r)
        out = kernels.cone_sweep_z(op, rel_x, rel_y, rel_z, carry, t6[0][4:], keep)
        if not torch.equal(out, cone_z_round_plain(op, rel_x, rel_y, rel_z, carry, t6[1][4:],
                                                   keep)):
            raise AssertionError(f"K15b-4a round {r} shard {me}: carry differs from plain")
        if r < n - 1:
            c0, c1 = comm.ppermutes([(out[0], up), (out[1], dn)])
            carry = torch.stack([ones if c0 is None else c0, ones if c1 is None else c1])
    return t6[0], t6[1]


def phase2_grid(lut) -> list[dict]:
    """The grid-sharded step's kernels against their plain versions on the
    card, with 3 shards of the flagship grid on one card: K15b-1 on f32,
    int32 and bool slabs at r = 1, 3, 8, 16 and multi-hop at r = 20 and 40
    (past every shard), bit-equal to its plain version and to the rows cut
    from the whole grid; K15b-2 at r = 16 and 20 (head and tail ranges
    overlap), bit-equal to its plain version and to the min over every
    shard's stamp; K15b-3 and K15b-4a launch by launch beside their plain
    versions on a flagship scan's window, and the step's sharded sweep, T
    bit-equal to the plain versions' and to K4's,
    and the sharded K4 + K5b ray update bit-equal to the dense one under
    both update rules; K2's sharded sweeps (fixed count and gated) on the
    background's keys, bit-equal to the dense sweeps with their flags."""
    dev = torch.device("cuda")
    cfg, dyn = VoFODConfig(), DynParams()
    grid = GridSpec.from_config(cfg)
    node, (r_np, pose_np) = _flagship_inputs(lut)
    n, nzl = GRID_SHARDS, grid.nz // GRID_SHARDS
    plane = grid.ny * grid.nx
    comm = LocalComm(n, [dev])
    ops = ZShardOps(comm, n)
    vals = node.state.grid
    keys = torch.where(vals > dyn.thr_new_obstacles,
                       torch.arange(grid.n_voxels, dtype=torch.int32, device=dev)
                       .reshape(grid.shape), SENTINEL)
    safe = node.state.safe
    results = []

    # K15b-1: every dtype of the path's exchanges, single hop and multi-hop
    for r in (1, 3, 8, 16, 20, 40):
        for g, fill in ((vals, -1e30), (keys, SENTINEL), (safe, False)):
            def shard(rank, g=g, fill=fill, r=r):
                # the step's exchange, and K15b-1 / its plain version on the
                # blocks of one more exchange
                sl = g[rank * nzl:(rank + 1) * nzl].contiguous()
                lo, hi, takes = ops.halo_recv(sl, r)
                return (ops.halo_exchange(sl, r, fill),
                        kernels.halo_exchange(sl, lo, hi, takes, fill),
                        halo_exchange_plain(sl, lo, hi, takes, fill))
            for rank, (e, k, p) in enumerate(comm.run(shard)):
                ref = _global_ext(g, rank * nzl, nzl, r, fill)
                if not (torch.equal(k, p) and torch.equal(k, ref) and torch.equal(e, ref)):
                    raise AssertionError(f"K15b-1 {g.dtype} r={r} shard {rank} differs")
    z0, h = nzl, 16  # shard 1's inputs at the explore pad
    slab = vals[z0:z0 + nzl].contiguous()
    lo, hi = [vals[z0 - h:z0].contiguous()], [vals[z0 + nzl:z0 + nzl + h].contiguous()]
    ext_bytes = (nzl + 2 * h) * plane * 4
    results.append(dict(
        name="halo_exchange", max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.halo_exchange(slab, lo, hi, [h], -1e30)),
        plain_ms=cuda_ms(lambda: halo_exchange_plain(slab, lo, hi, [h], -1e30)),
        bytes=2 * ext_bytes, ops=0,
        library_ms=cuda_ms(lambda: torch.cat(lo + [slab] + hi)),
        library_call="torch.cat of the received rows and the slab",
        shapes=f"f32 slab ({nzl}, {grid.ny}, {grid.nx}) + 2 x {h} rows -> ({nzl + 2 * h}, ...); "
               "checked at r 1, 3, 8, 16, 20, 40 on f32 / int32 / bool, 3 shards",
    ))

    # K2 on halo'd slabs with the interior change flag: the label sweeps of
    # the step (fixed count) and the gated form, labels and per-sweep flags
    occ = vals > dyn.thr_new_obstacles
    radius = cfg.ground_points_max_distance / cfg.voxel_size
    for gated in (False, True):
        want, wflags = sweeps(keys, occ, radius, cfg.cc_sweeps, gated)
        out = comm.run(lambda rank, gated=gated: ops.sweeps(
            keys[rank * nzl:(rank + 1) * nzl], occ[rank * nzl:(rank + 1) * nzl], radius,
            cfg.cc_sweeps, gated))
        if not (torch.equal(torch.cat([k for k, _ in out]), want)
                and all(torch.equal(f, wflags) for _, f in out)):
            raise AssertionError(f"sharded K2 sweeps (gated {gated}) differ from the dense ones")

    # K15b-2: each shard stamps its whole halo-extended view with 50 - rank
    base = (torch.arange(grid.n_voxels, dtype=torch.float32, device=dev) + 100.0).reshape(
        grid.shape)
    for r in (16, 20):
        def shard(rank, r=r):
            ext = ops.halo_exchange(base[rank * nzl:(rank + 1) * nzl], r, float("inf"))
            ext = torch.minimum(ext, torch.tensor(50.0 - rank, device=dev)).contiguous()
            fn, fp, takes = ops.fold_recv(ext, r)
            return (ops.halo_fold_min(ext, r), kernels.halo_fold_min(ext, r, fn, fp, takes),
                    halo_fold_min_plain(ext, r, fn, fp, takes))
        out = comm.run(shard)
        want = base.clone()
        for i in range(n):
            a, b = max(0, i * nzl - r), min(grid.nz, (i + 1) * nzl + r)
            want[a:b] = torch.minimum(want[a:b], torch.tensor(50.0 - i, device=dev))
        got_e, got_k, got_p = (torch.cat(parts) for parts in zip(*out))
        if not (torch.equal(got_k, got_p) and torch.equal(got_k, want)
                and torch.equal(got_e, want)):
            raise AssertionError(f"K15b-2 r={r} differs")
    ext = _global_ext(vals, z0, nzl, h, 0.0).contiguous()
    fn, fp = [ext[:h].clone()], [ext[-h:].clone()]
    results.append(dict(
        name="halo_fold_min", max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.halo_fold_min(ext, h, fn, fp, [h])),
        plain_ms=cuda_ms(lambda: halo_fold_min_plain(ext, h, fn, fp, [h])),
        bytes=(2 * nzl + 2 * h) * plane * 4, ops=2 * h * plane, library_ms=None,
        shapes=f"f32 ({nzl + 2 * h}, {grid.ny}, {grid.nx}) + 2 x {h} returned rows -> "
               f"({nzl}, ...); checked at r 16 and 20 (overlapping head and tail), 3 shards",
    ))

    # K15b-3 / K15b-4a: the sharded sweep of the scan's blockers, T against
    # the plain versions and K4; then K4 + K5b dense against the sharded update
    ranges = torch.as_tensor(r_np.astype(np.float32), device=dev)
    pose = torch.as_tensor(pose_np, device=dev)
    dirs = torch.as_tensor(lut.directions, device=dev)
    offs = torch.as_tensor(lut.offsets, device=dev)
    occ = frontend_bin(cfg, grid, dirs, offs, ranges, pose)[0] > 0
    origin = np.asarray(pose_np[:3, 3], np.float32)
    bound = cfg.raycast_max_distance_bound
    x0, y0, wx, wy, gx, gy, gz = sweep_window(grid, origin, bound)
    rel_z = torch.arange(grid.nz, dtype=torch.float32, device=dev) + 0.5 - float(gz)
    rel_x = torch.arange(wx, dtype=torch.float32, device=dev) + float(x0) + 0.5 - float(gx)
    rel_y = torch.arange(wy, dtype=torch.float32, device=dev) + float(y0) + 0.5 - float(gy)
    t_dense = cone_sweep(occ[:, y0:y0 + wy, x0:x0 + wx].contiguous(), rel_x, rel_y, rel_z)
    op_w = occ[:, y0:y0 + wy, x0:x0 + wx].contiguous().view(torch.uint8)
    out = comm.run(lambda rank: (
        sweep_zsharded(grid, occ[rank * nzl:(rank + 1) * nzl], origin, comm, bound)[0],
        _sharded_cones_vs_plain(op_w[rank * nzl:(rank + 1) * nzl], rel_x, rel_y,
                                rel_z[rank * nzl:(rank + 1) * nzl].contiguous(), comm)))
    t_s = torch.cat([t for t, _ in out], dim=1)
    t_k = torch.cat([k for _, (k, _) in out], dim=1)
    t_p = torch.cat([p for _, (_, p) in out], dim=1)
    if not (torch.equal(t_k, t_p) and torch.equal(t_k, t_dense) and torch.equal(t_s, t_dense)):
        raise AssertionError(
            f"sharded sweep T: kernels vs plain {int((t_k != t_p).sum())} voxels, "
            f"vs K4 {int((t_k != t_dense).sum())}, the step's vs K4 "
            f"{int((t_s != t_dense).sum())} voxels differ")
    rot = pose[:3, :3].contiguous()
    kw = dict(max_distance=float(dyn.raycast_max_distance), vertical_fov=cfg.sensor.vertical_fov,
              v_rays=lut.height, h_rays=lut.width, max_distance_bound=bound)
    for new_rule in (True, False):
        ema = RayEma(new_rule, 0.25, 1.0, 0.5, float(dyn.score_ray))
        want = raycast_update_(grid, vals.clone(), occ, occ, origin, rot, ema, **kw)
        got = torch.cat(comm.run(lambda rank: raycast_update_zsharded(
            grid, vals[rank * nzl:(rank + 1) * nzl].clone(), occ[rank * nzl:(rank + 1) * nzl],
            occ[rank * nzl:(rank + 1) * nzl], origin, rot, ema, comm=comm, **kw)))
        if not torch.equal(got, want):
            raise AssertionError(f"sharded K4 + K5b (new rule {new_rule}) differs from the dense "
                                 f"update in {int((got != want).sum())} voxels")

    # per-launch times on shard 1's window slab, the received rows fixed
    op1 = occ[nzl:2 * nzl, y0:y0 + wy, x0:x0 + wx].contiguous().view(torch.uint8)
    rz1 = rel_z[nzl:2 * nzl].contiguous()
    pb = max(wx, wy)
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = torch.rand((3, 4, pb), device=dev, generator=gen).to(torch.bfloat16)
    lo1, hi1 = rows[:1].contiguous(), rows[1:].contiguous()
    bufs = [torch.ones((nzl, 4, pb), dtype=torch.bfloat16, device=dev) for _ in range(2)]
    t4 = torch.empty((4, nzl, wy, wx), dtype=torch.float32, device=dev)

    def lat_sweep(step):
        for k in range(pb + 1):
            step(op1, rel_x, rel_y, rz1, bufs[(k + 1) % 2] if k else None, lo1, hi1,
                 bufs[k % 2], t4, k)

    nw = nzl * wy * wx
    results.append(dict(
        name="cone_sweep_lat", max_abs_err=0.0,
        ms=cuda_ms(lambda: lat_sweep(kernels.cone_sweep_lat), reps=5) / (pb + 1),
        plain_ms=cuda_ms(lambda: lat_sweep(cone_lat_step_plain), reps=2) / (pb + 1),
        # per launch: the opacity and T of one plane of each cone, the B-resampled
        # rows in (slab + 3) and out (slab), bf16
        bytes=4 * nzl * pb * (1 + 4) + 4 * (2 * nzl + 3) * pb * 2, ops=4 * nzl * pb * 40,
        library_ms=None,
        shapes=f"one of {pb + 1} launches per shard per scan: 4 cones x {nzl} rows x {pb} "
               f"lanes; sweep T bit-equal to K4 on the ({grid.nz}, {wy}, {wx}) window",
    ))
    carry = torch.ones((2, wy, wx), dtype=torch.bfloat16, device=dev)
    t2 = torch.empty((2, nzl, wy, wx), dtype=torch.float32, device=dev)
    results.append(dict(
        name="cone_sweep_z", max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.cone_sweep_z(op1, rel_x, rel_y, rz1, carry, t2, (True, True))),
        plain_ms=cuda_ms(lambda: cone_z_round_plain(op1, rel_x, rel_y, rz1, carry, t2,
                                                    (True, True)), reps=3),
        bytes=nw * (1 + 2 * 4) + 2 * 2 * wy * wx * 2, ops=nw * 2 * 16, library_ms=None,
        shapes=f"one round: 2 cones x {nzl} planes of ({wy}, {wx}); {n} rounds per shard",
    ))
    for r in results:
        say("2-grid-kernel", **r)
    return results


class GridDriver:
    """The grid-sharded step (3 shards on the card) driven as the node drives
    the dense step: the scan staged in pinned memory and uploaded once, the
    step, one packed readback of shard 0's diagnostics and detections."""

    def __init__(self, lut, state: VoFODState):
        self.cfg, self.dyn = VoFODConfig(), DynParams()
        self.comm = LocalComm(GRID_SHARDS, ["cuda"])
        self.step = make_grid_sharded_step(self.cfg, lut, self.comm)
        self.states = shard_state(state, self.comm)
        n = self.cfg.sensor.n_points
        self.staging = HostStaging(((n, torch.float32),), "cuda")
        self.ones = torch.ones(n, dtype=torch.float32, device="cuda")

    def process_scan_async(self, r, pose):
        i, (buf,) = self.staging.next()
        np.copyto(buf, np.asarray(r).reshape(-1), casting="unsafe")
        (ranges,) = self.staging.upload(i)
        scan = ScanInput(ranges_mm=ranges, intensity=self.ones, pose=np.asarray(pose, np.float32))
        self.states, out = self.step(self.states, scan, self.dyn)
        return out

    @staticmethod
    def fetch(out) -> tuple[dict, dict]:
        """(diag, detections) as numpy arrays, from one readback."""
        diag = [f.name for f in dataclasses.fields(out.diag)]
        dets = [f.name for f in dataclasses.fields(out.detections)]
        buf, layout = _pack([getattr(out.diag, f) for f in diag]
                            + [getattr(out.detections, f) for f in dets])
        host = _unpack(buf.cpu().numpy(), layout)
        return dict(zip(diag, host)), dict(zip(dets, host[len(diag):]))

    def process_scan(self, r, intensity, pose):
        return self.fetch(self.process_scan_async(r, pose))


def phase4_grid(lut) -> dict:
    """The grid-sharded step at the flagship size: 36 scans of the cycle
    through 3 shards of 17 planes on the card, each beside a dense node on
    the same scan.  Per scan: the gathered grid and safe, the carried
    scalars and the diagnostics bit-equal to the dense node's, detection
    integers equal and floats within 1e-5 relative (JAX's bound for its
    sharded step; bit-equal expected), each K15b kernel launched, at most
    1 host sync (the readback); step p50/p95 of both, K15b launches and
    collective copies per scan."""
    cfg = VoFODConfig()
    node = VoFOD(cfg, DynParams(), NodeOptions(), lut, device="cuda")
    node.load_apriori_map(apriori_ground())
    drv = GridDriver(lut, node.state)
    scans = scan_cycle(lut, N_SCANS)
    torch.cuda.synchronize()
    ms = {"dense": [], "grid": []}
    syncs, per_scan, copies, rel_err, n_dets = [], [], [], 0.0, 0
    bit_equal_dets = True
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for k, (r, p) in enumerate(scans):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            pending = node.process_scan_async(r, None, p)
            end.record()
            dense_out = pending[0]
            msg = node.fetch_result(pending)
            ms["dense"].append(start.elapsed_time(end))
            n_dets += len(msg.detections)
            kernels.reset_launch_counts()
            drv.comm.reset_copies()
            before = len(caught)
            torch.cuda.set_sync_debug_mode("warn")
            try:
                start.record()
                out = drv.process_scan_async(r, p)
                end.record()
                diag, dets = drv.fetch(out)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            ms["grid"].append(start.elapsed_time(end))
            syncs.append(sum(1 for w in caught[before:] if "synchroniz" in str(w.message)))
            launches = kernels.launch_counts()
            per_scan.append({g: launches[g] for g in GRID_KERNELS})
            copies.append(drv.comm.copies)
            missing = [g for g in GRID_KERNELS if launches[g] == 0]
            assert not missing, f"scan {k}: K15b kernels not launched: {missing}"
            g = gather_state(drv.states)
            for f in ("grid", "safe", "det_counter", "sure_bg_sufficient", "bg_sufficient"):
                if not torch.equal(getattr(g, f), getattr(node.state, f)):
                    raise AssertionError(f"grid-sharded scan {k}: state.{f} differs from dense")
            for f, v in diag.items():
                if not np.array_equal(v, getattr(node.last_diag, f)):
                    raise AssertionError(f"grid-sharded scan {k}: diag.{f} differs from dense")
            for f, v in dets.items():
                want = getattr(dense_out.detections, f).cpu().numpy()
                if v.dtype.kind == "f":
                    bit_equal_dets &= bool(np.array_equal(v, want))
                    np.testing.assert_allclose(v, want, rtol=1e-5, atol=0.0,
                                               err_msg=f"grid-sharded scan {k}: detections.{f}")
                    den = np.maximum(np.abs(want), 1e-30)
                    rel_err = max(rel_err, float(np.max(np.abs(v - want) / den, initial=0.0)))
                elif not np.array_equal(v, want):
                    raise AssertionError(f"grid-sharded scan {k}: detections.{f} differs")
    assert max(syncs) <= 1, f"host syncs per grid-sharded scan: {syncs}"
    assert bool(node.last_diag.bg_sufficient), "background never became sufficient"
    total = {g: sum(s[g] for s in per_scan) for g in GRID_KERNELS}
    out = dict(
        scans=N_SCANS, shards=GRID_SHARDS, shard_shape=[cfg.grid_shape[0] // GRID_SHARDS,
                                                        *cfg.grid_shape[1:]],
        bit_equal_state_and_diag=True, detection_floats_bit_equal=bit_equal_dets,
        detection_float_max_rel_err=rel_err, detections_total=n_dets,
        step_ms_p50={m: float(np.percentile(v, 50)) for m, v in ms.items()},
        step_ms_p95={m: float(np.percentile(v, 95)) for m, v in ms.items()},
        step_ms_all={m: [round(x, 3) for x in v] for m, v in ms.items()},
        host_syncs_per_scan=float(np.mean(syncs)), host_syncs_max=int(max(syncs)),
        k15b_launches_per_scan={g: total[g] / N_SCANS for g in GRID_KERNELS},
        k15b_launches_per_scan_min={g: min(s[g] for s in per_scan) for g in GRID_KERNELS},
        collective_copies_per_scan=float(np.mean(copies)),
    )
    say("4-grid", **out)
    return total, out["step_ms_p50"]["grid"]


def _dev_us(e, self_only: bool) -> float:
    name = "self_device_time_total" if self_only else "device_time_total"
    legacy = "self_cuda_time_total" if self_only else "cuda_time_total"
    return float(getattr(e, name, None) or getattr(e, legacy, 0.0))


def _device_events(prof, n: int) -> dict:
    """Device-side events of the trace per scan, counted one by one from
    ``prof.events()`` (not from key_averages), by kind."""
    from torch.autograd import DeviceType

    kinds = {"kernel": 0, "memcpy": 0, "memset": 0}
    names = set()
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        low = e.name.lower()
        kinds["memcpy" if "memcpy" in low else "memset" if "memset" in low else "kernel"] += 1
        names.add(e.name)
    return dict(per_scan=sum(kinds.values()) / n, by_kind={k: v / n for k, v in kinds.items()},
                distinct_names=len(names))


def phase5_profile(lut, step_ms_p50: float, n: int = 5, path: str = "sweep",
                   label: str | None = None) -> dict:
    """Where the flagship step's device time goes (torch.profiler), on the
    sweep, exact, prebinned, dynamic-radii (at its heaviest radii, 2.0 /
    1.9 m) or sequential-explore path.  Every path is counted the same way:
    a fresh node, the apriori plane, 6 warm-up scans, then one profiler
    session over ``n`` scans; device ops are counted both from key_averages
    (the earlier count) and event by event."""
    from torch.profiler import ProfilerActivity, profile

    cfg, opts = VoFODConfig(), NodeOptions()
    if path in ("exact", "sequential"):
        cfg = sequential_config() if path == "sequential" else exact_config()
        opts = NodeOptions(raycast_mode="exact")
    elif path == "prebinned":
        opts = NodeOptions(frontend_mode="prebinned")
    elif path == "dynamic":
        cfg = VoFODConfig(dynamic_radii=True, ground_points_max_distance_bound=2.0,
                          sepclusters_max_bg_distance_bound=2.0)
    node = VoFOD(cfg, DynParams(), opts, lut, device="cuda")
    if path == "dynamic":
        node.update_params(ground_points_max_distance=2.0, sepclusters_max_bg_distance=1.9)
    node.load_apriori_map(apriori_ground())
    if path == "grid":  # the 3-shard step from the same start
        node = GridDriver(lut, node.state)
    scans = scan_cycle(lut, 6 + n)
    for r, p in scans[:6]:
        node.process_scan(r, None, p)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r, p in scans[6:]:
            node.process_scan(r, None, p)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    ev = prof.key_averages()
    stages = {e.key: round(_dev_us(e, False) / n / 1e3, 3) for e in ev if e.key.startswith("vofod.")}
    ops = [e for e in ev if not e.key.startswith("vofod.") and _dev_us(e, True) > 0]
    dev_ops = [e for e in ops if not e.key.startswith("aten::")]
    busy_ms = sum(_dev_us(e, True) for e in dev_ops) / n / 1e3
    top = sorted(dev_ops, key=lambda e: -_dev_us(e, True))[:12]
    # what K5 and K10 removed: the gate expansion's matmuls, detect's pads
    gemm = sum(e.count for e in dev_ops if any(w in e.key.lower() for w in ("gemm", "bmm")))
    pads = sum(e.count for e in ops if e.key == "aten::constant_pad_nd")
    out = dict(scans=n, profiled_wall_ms_per_scan=round(wall_ms, 3),
               unprofiled_step_ms_p50=round(step_ms_p50, 3),
               device_busy_ms_per_scan=round(busy_ms, 3),
               device_ops_per_scan=sum(e.count for e in dev_ops) / n,
               device_events=_device_events(prof, n),
               idle_share_of_unprofiled_step=round(1.0 - busy_ms / step_ms_p50, 3),
               stage_device_span_ms_per_scan=stages,
               gemm_kernels_per_scan=gemm / n, pad_ops_per_scan=pads / n,
               top_device_kernels=[[round(_dev_us(e, True) / n / 1e3, 3), e.count // n,
                                    e.key[:90]] for e in top])
    say(label or ("5-profile" if path == "sweep" else f"5-profile-{path}"), **out)
    out["counts_by_name"] = {e.key: e.count for e in dev_ops}
    return out


def main() -> int:
    device = phase0()
    phase1()
    lut = make_lut(VoFODConfig().sensor)
    results = phase2(lut)
    results += phase2_exact(lut)
    results += phase2_sequential(lut)
    results += phase2_grid(lut)
    phase3()
    launches, step_ms_p50 = phase4(lut)
    phase4_raycast_every(lut)
    exact_launches, exact_ms_p50 = phase4_exact(lut)
    seq_launches, seq_ms_p50 = phase4_exact(lut, sequential=True)
    pre_launches, pre_ms_p50 = phase4_prebinned(lut)
    phase4_auto(lut)
    dyn_launches, dyn_ms_p50 = phase4_dynamic(lut)
    phase4_surface(lut)
    grid_launches, grid_ms_p50 = phase4_grid(lut)
    first = phase5_profile(lut, step_ms_p50)
    phase5_profile(lut, exact_ms_p50, path="exact")
    phase5_profile(lut, pre_ms_p50, path="prebinned")
    phase5_profile(lut, dyn_ms_p50, path="dynamic")
    phase5_profile(lut, seq_ms_p50, path="sequential")
    phase5_profile(lut, grid_ms_p50, path="grid")
    # the sweep path once more, in the last profiler session: the same code
    # counted in another session says whether the op count is the session's
    again = phase5_profile(lut, step_ms_p50, label="5-profile-sweep-again")
    a, b = first["counts_by_name"], again["counts_by_name"]
    say("5-op-count-sessions", sweep_first=first["device_ops_per_scan"],
        sweep_last=again["device_ops_per_scan"],
        sweep_events_first=first["device_events"]["per_scan"],
        sweep_events_last=again["device_events"]["per_scan"],
        session_dependent=first["device_ops_per_scan"] != again["device_ops_per_scan"],
        # why: the device ops whose count over the 5 scans differs
        differing_ops={k[:80]: [a.get(k, 0), b.get(k, 0)] for k in sorted(set(a) | set(b))
                       if a.get(k, 0) != b.get(k, 0)})
    path_launches = {"unpack": pre_launches, "shell_pool": dyn_launches,
                     "explore_seq": seq_launches, **{g: grid_launches for g in GRID_KERNELS}}
    record = []
    for r in results:
        src, replaces = KERNEL_INFO[r["name"]]
        # launches from the path that runs the kernel: the sweep path, the
        # prebinned (K15a), dynamic-radii (K14), sequential (K7s) and
        # grid-sharded (K15b) paths, else the exact path
        n = (launches[r["name"]] if r["name"] in SWEEP_KERNELS
             else path_launches.get(r["name"], exact_launches).get(r["name"], 0))
        t_bytes, t_ops = r["bytes"] / HBM_BYTES_PER_S, r["ops"] / F32_OPS_PER_S
        record.append(dict(
            name=r["name"], route="cuda", source=src, replaces=replaces,
            launches=n, max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=r["library_ms"],
        ))
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", **device}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

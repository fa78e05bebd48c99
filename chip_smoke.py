#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vofod_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits non-zero:

0. require CUDA; print the card's name and power limit (nvidia-smi) and
   pin float32 matmuls and convolutions to full precision (no TF32);
1. build the CUDA kernels from csrc/ and print the build time;
2. hold each kernel against its plain PyTorch version on the card, on
   inputs taken from a real flagship scan (OS0-128, 241x201x51 grid): K1-K3
   bit-equal, K4 within one bf16 ulp at 1.0; CUDA-event times of both;
3. replay tests/fixtures/golden_small.npz with the kernels on and check the
   tests/test_golden.py assertions;
4. drive the flagship main path — ``VoFOD(device="cuda")``, the apriori
   ground plane and 36 scans of a content-varying cycle — and check
   ``bg_sufficient``, a NaN-free grid and that every kernel was launched;
   print step p50/p95 (CUDA events) and host syncs per scan;
5. a torch.profiler trace of 5 flagship scans: device time per stage (the
   step's ``vofod.*`` ranges), the top device ops, and the device's busy
   and idle share of the step.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Needs no network and one GPU.
"""

from __future__ import annotations

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
from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig  # noqa: E402
from vofod_tpu_torch.geometry import GridSpec  # noqa: E402
from vofod_tpu_torch.io.scan_source import Scene, hover_pose, render_scan  # noqa: E402
from vofod_tpu_torch.ops.components import SENTINEL, sweeps, sweeps_plain  # noqa: E402
from vofod_tpu_torch.ops.morphology import ball_pool, ball_pool_plain  # noqa: E402
from vofod_tpu_torch.ops.raycast import cone_sweep, cone_sweep_plain, sweep_window  # noqa: E402
from vofod_tpu_torch.pipeline.frontend import frontend_bin, frontend_bin_plain  # noqa: E402
from vofod_tpu_torch.runtime.node import NodeOptions, VoFOD  # noqa: E402
from vofod_tpu_torch.sensor import make_lut  # noqa: E402

# K4 tolerance: T lies in [0, 1] and is stored in bf16; kernel and plain
# version follow the same rounding steps, so they may differ by at most one
# bf16 ulp at 1.0 (2^-8) where an f32 sum rounds across a bf16 tie.
K4_TOL = 2.0**-8
N_SCANS = 36

KERNEL_INFO = {
    "ball_pool": ("vofod_tpu_torch/csrc/ball_pool.cu", "vofod_tpu/ops/morphology.py:70"),
    "propagate_sweep": ("vofod_tpu_torch/csrc/propagate.cu", "vofod_tpu/ops/components.py:88"),
    "frontend_bin": ("vofod_tpu_torch/csrc/frontend_bin.cu", "vofod_tpu/ops/binning.py:44"),
    "cone_sweep": ("vofod_tpu_torch/csrc/cone_sweep.cu", "vofod_tpu/ops/raycast.py:210"),
}


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
    t0 = time.perf_counter()
    so, log = kernels.build()
    kernels.load()
    info = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    say("1-build", seconds=round(time.perf_counter() - t0, 3), library=so.name, ptxas=info)


def phase2(lut) -> list[dict]:
    """Each kernel against its plain version at flagship shapes."""
    dev = torch.device("cuda")
    cfg, dyn = VoFODConfig(), DynParams()
    grid = GridSpec.from_config(cfg)
    node = VoFOD(cfg, dyn, NodeOptions(), lut, device=dev)
    node.load_apriori_map(apriori_ground())
    scans = scan_cycle(lut, 6)
    for r, p in scans[:5]:
        node.process_scan(r, None, p)
    r_np, pose_np = scans[5]
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
    results.append(dict(
        name="frontend_bin", max_abs_err=max(max_abs(a, b) for a, b in zip(k3, p3)),
        ms=cuda_ms(lambda: frontend_bin(cfg, grid, dirs, offs, ranges, pose)),
        plain_ms=cuda_ms(lambda: frontend_bin_plain(cfg, grid, dirs, offs, ranges, pose)),
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
    results.append(dict(
        name="ball_pool", max_abs_err=err, ms=ms[0], plain_ms=pms[0],
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
    results.append(dict(
        name="cone_sweep", max_abs_err=e4, tol=K4_TOL, n_diff=n_diff,
        ms=cuda_ms(lambda: cone_sweep(op_w, rel_x, rel_y, rel_z)),
        plain_ms=cuda_ms(lambda: cone_sweep_plain(op_w, rel_x, rel_y, rel_z), reps=3),
        shapes=f"window {tuple(op_w.shape)}, 6 cones",
    ))
    for r in results:
        say("2-kernel", **r)
    return results


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
    assert all(v > 0 for v in launches.values()), launches
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
    step_ms, syncs, n_dets = [], [], []
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
        finally:
            torch.cuda.set_sync_debug_mode(0)
    launches = kernels.launch_counts()
    d = node.last_diag
    g = node.state.grid
    assert bool(d.bg_sufficient), "background never became sufficient"
    assert not bool(torch.isnan(g).any()) and not bool(torch.isneginf(g).any()), "grid not finite"
    assert max(syncs) <= 1, f"host syncs per scan: {syncs}"
    missing = [k for k, v in launches.items() if v == 0]
    assert not missing, f"kernels never launched on the main path: {missing}"
    out = dict(
        scans=N_SCANS, grid=list(cfg.grid_shape), rays=cfg.sensor.n_points,
        apriori_voxels=n_apriori,
        step_ms_p50=float(np.percentile(step_ms, 50)),
        step_ms_p95=float(np.percentile(step_ms, 95)),
        step_ms_all=[round(x, 3) for x in step_ms],
        host_syncs_per_scan=float(np.mean(syncs)), host_syncs_max=int(max(syncs)),
        detections_last_scan=n_dets[-1], detections_total=int(sum(n_dets)),
        scans_with_detection=int(sum(1 for n in n_dets if n)),
        bg_sufficient=bool(d.bg_sufficient), sure_bg_sufficient=bool(d.sure_bg_sufficient),
        n_bg_voxels=int(d.n_bg_voxels), cc_iters=int(d.cc_iters),
        launches=launches, launches_per_scan={k: v / N_SCANS for k, v in launches.items()},
    )
    say("4-flagship", **out)
    return launches, out["step_ms_p50"]


def _dev_us(e, self_only: bool) -> float:
    name = "self_device_time_total" if self_only else "device_time_total"
    legacy = "self_cuda_time_total" if self_only else "cuda_time_total"
    return float(getattr(e, name, None) or getattr(e, legacy, 0.0))


def phase5_profile(lut, step_ms_p50: float, n: int = 5) -> None:
    """Where the flagship step's device time goes (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = VoFODConfig()
    node = VoFOD(cfg, DynParams(), NodeOptions(), lut, device="cuda")
    node.load_apriori_map(apriori_ground())
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
    busy_ms = sum(_dev_us(e, True) for e in ops if not e.key.startswith("aten::")) / n / 1e3
    top = sorted((e for e in ops if not e.key.startswith("aten::")),
                 key=lambda e: -_dev_us(e, True))[:12]
    say("5-profile", scans=n, profiled_wall_ms_per_scan=round(wall_ms, 3),
        unprofiled_step_ms_p50=round(step_ms_p50, 3),
        device_busy_ms_per_scan=round(busy_ms, 3),
        idle_share_of_unprofiled_step=round(1.0 - busy_ms / step_ms_p50, 3),
        stage_device_span_ms_per_scan=stages,
        top_device_kernels=[[round(_dev_us(e, True) / n / 1e3, 3), e.count // n, e.key[:90]]
                            for e in top])


def main() -> int:
    device = phase0()
    phase1()
    lut = make_lut(VoFODConfig().sensor)
    results = phase2(lut)
    phase3()
    launches, step_ms_p50 = phase4(lut)
    phase5_profile(lut, step_ms_p50)
    record = []
    for r in results:
        src, replaces = KERNEL_INFO[r["name"]]
        record.append(dict(
            name=r["name"], route="cuda", source=src, replaces=replaces,
            launches=launches[r["name"]], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"],
        ))
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", **device}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

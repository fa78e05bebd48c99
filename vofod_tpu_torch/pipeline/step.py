"""The end-to-end step: scan -> (state, detections, diagnostics).

PyTorch counterpart of vofod_tpu/pipeline/step.py ``make_step_fn`` for the
single-stream configurations: the production one (gated sweep raycast,
default sepclusters; raw or prebinned ingest, static or live-tunable
stencil radii) and the reference-exact one (exact DDA raycast, exact
sepclusters census, the compat_* quirks, the sequential explore):

  1. frontend: filter + transform + voxel binning  raw: (K3); prebinned:
     the host bins (io/binner.py), the device unpacks       (K15a)
  2. background sufficiency + close/far split  (K1, K2; dynamic radii: K14)
  3. point EMA update of the confidence grid             (K11)
  4. classification + floating check + demotions
                          (K6, K9, K7, K8; sequential explore: K6, K9, K7s)
  5. detection extraction                                (K10)
  6. every raycast_every steps: freespace raycast +
     flag-guarded ray EMA update
                  sweep: (K5a, K4, K5b; ungated: K4, K5b); exact: (K12)
  7. every sepclusters_every steps: background maint.
              default: (K1, K2, K11; dynamic radii: K14, K2, K11); exact: (K13, K2)

The JAX step branches on the device (lax.cond / switch / while_loop).  Here
every branch predicate is a host value — the pause flags, the host pose's
in-limits test and the host step counter — or the branch is replaced by a
fixed-size computation with the same result (see classify.py,
ops/components.py, ops/explore.py), so a step issues no host sync.  The
state dataclass is updated in place (JAX donates it instead).

``ops`` is the dense-grid provider of vofod_tpu/parallel/gridops.py:
``DENSE`` for one device, or a ``ZShardOps`` for the grid-sharded step
(parallel/grid_step.py), which runs this same step code on every shard's
z slab.  Since no predicate here is on device data, every shard issues the
same collectives in the same order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.geometry import GridSpec, rotate, se3_apply
from vofod_tpu_torch.ops.raycast import (
    RayEma, gate_faces, make_angular_gate, ray_ema_grid_, ray_ema_plain, raycast_dda, row_table)
from vofod_tpu_torch.parallel.gridops import DENSE
from vofod_tpu_torch.pipeline.background import split_and_update
from vofod_tpu_torch.pipeline.classify import classify
from vofod_tpu_torch.pipeline.detect import extract_detections
from vofod_tpu_torch.pipeline.frontend import run_frontend, run_frontend_prebinned
from vofod_tpu_torch.pipeline.sepclusters import run_sepclusters
from vofod_tpu_torch.pipeline.state import (
    Detections,
    PrebinnedScan,
    ScanInput,
    StepDiagnostics,
    VoFODState,
)
from vofod_tpu_torch.sensor import RANGE_TO_METERS, XyzLut

Tensor = torch.Tensor
RAYCAST_MODES = ("sweep", "exact", "off")
FRONTEND_MODES = ("raw", "prebinned")


@dataclass
class StepOutput:
    detections: Detections
    diag: StepDiagnostics


def ray_ema(cfg: VoFODConfig, dyn: DynParams, its_diff: float) -> RayEma:
    """The ray EMA's rule and float32 constants (the rule is a host flag)."""
    voxel_diag = math.sqrt(3.0) * cfg.voxel_size
    coef = float(np.float32(dyn.raycast_weight_coefficient) / np.float32(voxel_diag))
    return RayEma(bool(dyn.raycast_new_update_rule), coef, float(np.float32(its_diff)),
                  float(np.float32(dyn.raycast_weight_coefficient)),
                  float(np.float32(dyn.score_ray)))


def ray_update(
    cfg: VoFODConfig,
    dyn: DynParams,
    grid_vals: Tensor,
    raylen: Tensor,
    had_point: Tensor,
    its_diff: float,
) -> Tensor:
    """Flag-guarded EMA toward the ray score on a raylen field (both
    reference update rules, vofod_nodelet.cpp:1550-1601) — the plain EMA of
    K5b and K12; the step applies it through the kernels (K5b on the sweep
    window, K12's second pass on the exact mode's full grid)."""
    return ray_ema_plain(grid_vals, raylen, had_point, ray_ema(cfg, dyn, its_diff))


def exact_rays(cfg: VoFODConfig, dyn: DynParams, grid: GridSpec, lut_dirs: Tensor,
               lut_offs: Tensor, mask: Tensor, r: Tensor, intensity: Tensor,
               pose: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The exact mode's rays (vofod_tpu step.py:275-299): (starts, world
    directions, lengths, valid) of the pixels, from the ranges ``r`` in
    metres, the intensities, the FOV mask and the [4, 4] pose."""
    # hostile-float contract (tests/test_hostile_inputs.py): NaN and negative
    # ranges are no-returns, +inf a return past any operation area
    r = torch.where(torch.isnan(r) | (r < 0.0), 0.0, torch.clamp(r, max=4.0e6))
    dirs_w = rotate(pose[:3, :3], lut_dirs)
    starts = se3_apply(pose, lut_offs)
    max_d = float(np.float32(dyn.raycast_max_distance))
    lengths = torch.where(r == 0.0, max_d, torch.clamp(r - float(cfg.voxel_size), max=max_d))
    # the negated gate (ref :1449-1450): NaN intensity passes
    valid = (~(intensity < dyn.raycast_min_intensity) & (mask | (r > 0))
             & grid.in_limits(starts))
    return starts, dirs_w, lengths, valid


def make_step_fn(
    cfg: VoFODConfig,
    lut: XyzLut,
    *,
    device,
    raycast_mode: str = "sweep",
    raycast_every: int = 1,
    mask=None,
    frontend_mode: str = "raw",
    raycast_gate: bool = True,
    ops=DENSE,
) -> Callable[..., tuple[VoFODState, StepOutput]]:
    """Build the step for ``device``.
    raycast_mode: "sweep" (the gated transmittance sweep, production),
      "exact" (per-ray DDA, the reference's traversal) or "off".
    frontend_mode: "raw" (the step takes a ScanInput and bins on the
      device) or "prebinned" (the step takes a PrebinnedScan the host binned,
      io/binner.py: the production serving ingest).  The exact DDA needs
      per-pixel ranges, so "prebinned" pairs with the sweep or no raycast.
    raycast_every: apply the freespace update on the steps with
      ``step % N == N - 1`` only, with its_diff = N (the reference's raycast
      thread skips scans under load and compensates so, ref :1540-1548).
    mask: optional uint8/bool [H*W] FOV mask (1 = usable) for the ray gate.
    raycast_gate: with the sweep, honour the per-pixel mask / intensity
      gates through the angular gate factor (K5a); False sweeps ungated (no
      K5a, K5b without faces), as the JAX step's option of the same name.
    Every VoFODConfig flag of the JAX step is ported (dynamic radii in the
    default sepclusters mode, as in the JAX step; compat_rangefinder_validity
    acts in the node only).
    ops: the dense-grid provider (parallel/gridops.py); the grid-sharded
      step passes its ZShardOps through parallel/grid_step.py, which
      refuses the modes that have no sharded form yet.

    The returned ``step(state, scan, dyn, stage_hook=None)`` calls
    ``stage_hook(name)`` where each routine starts ("cnc", "raycasting",
    "sepbgclusters") and once after the last ("end"): the node's
    ``profile_stages`` records CUDA events there.  The hook sees host
    control flow only; the result does not depend on it.
    """
    if raycast_mode not in RAYCAST_MODES:
        raise ValueError(f"unknown raycast_mode {raycast_mode!r}, expected one of {RAYCAST_MODES}")
    if frontend_mode not in FRONTEND_MODES:
        raise ValueError(f"unknown frontend_mode {frontend_mode!r}, expected one of "
                         f"{FRONTEND_MODES}")
    if frontend_mode == "prebinned" and raycast_mode == "exact":
        raise NotImplementedError(
            "the exact DDA needs per-pixel ranges; prebinned ingest pairs with the sweep "
            "raycast (vofod_tpu make_step_fn)")
    if cfg.dynamic_radii and (cfg.sepclusters_exact_census or cfg.compat_hascloseto_bounds):
        raise NotImplementedError(
            "dynamic_radii (runtime stencil radii) is supported in the default sepclusters "
            "mode only: the exact census's leaf size and the hasCloseTo box are static "
            "(VoFODConfig.dynamic_radii)")
    if raycast_every < 1:
        raise ValueError(f"raycast_every must be >= 1, got {raycast_every}")
    if ops.is_sharded:
        ops.check_step(cfg, raycast_mode, frontend_mode)
    device = torch.device(device)
    grid = GridSpec.from_config(cfg)
    H, W = cfg.sensor.vertical_rays, cfg.sensor.horizontal_rays
    lut_dirs = torch.as_tensor(lut.directions, device=device).contiguous()
    lut_offs = torch.as_tensor(lut.offsets, device=device).contiguous()
    mask_dev = (
        torch.as_tensor(np.asarray(mask).reshape(-1) > 0, device=device)
        if mask is not None
        else torch.ones(cfg.sensor.n_points, dtype=torch.bool, device=device)
    )
    gated = raycast_mode == "sweep" and raycast_gate  # the exact DDA gates per ray
    if gated:
        gate_spec = make_angular_gate(lut)
        face_dirs = torch.as_tensor(gate_spec.face_dirs.reshape(-1, 3), device=device)
        rows = row_table(gate_spec, device)
    zero_i32 = torch.zeros((), dtype=torch.int32, device=device)

    def ray_stage(scan: ScanInput | PrebinnedScan, pose: Tensor, dyn: DynParams, step_idx: int,
                  vals: Tensor, occupied: Tensor, blockers: Tensor) -> Tensor:
        """Stage 6: freespace raycast + flag-guarded ray EMA update, in
        place on ``vals`` (sweep: K5a, K4, K5b; exact: K12's walk and EMA):
        the step passes classify's output grid, a fresh tensor of this step
        that detect has already read (in stream order) and nothing reads
        after, as the JAX step donates it."""
        if raycast_mode == "off":
            return vals
        sensor_pos = scan.pose[:3, 3]
        if dyn.raycast_pause or not grid.in_limits_host(sensor_pos):
            return vals
        if step_idx % raycast_every != raycast_every - 1:
            return vals
        if raycast_mode == "exact":
            r = scan.ranges_mm * RANGE_TO_METERS
            rays = exact_rays(cfg, dyn, grid, lut_dirs, lut_offs, mask_dev, r, scan.intensity,
                              pose)
            raylen = raycast_dda(grid, *rays, cfg.raycast_max_distance_bound)
            return ray_ema_grid_(vals, occupied, raylen, ray_ema(cfg, dyn, float(raycast_every)))
        rot = pose[:3, :3]
        faces = None
        if gated:
            if frontend_mode == "prebinned":
                active = scan.active > 0  # the host binner evaluated the pixel gate
            else:
                # ref :1449-1450: skip when intensity < min, or masked with no
                # return (NaN intensity passes, as in the reference)
                r = scan.ranges_mm * RANGE_TO_METERS
                active = ~(scan.intensity < dyn.raycast_min_intensity) & (mask_dev | (r > 0))
            faces = gate_faces(gate_spec, face_dirs, active.reshape(H, W), rot, rows)
        return ops.raycast_update_(
            grid, vals, occupied, blockers, np.asarray(sensor_pos, np.float32), rot,
            ray_ema(cfg, dyn, float(raycast_every)),
            max_distance=float(dyn.raycast_max_distance),
            vertical_fov=cfg.sensor.vertical_fov,
            v_rays=H, h_rays=W, gate=faces,
            max_distance_bound=cfg.raycast_max_distance_bound,
        )

    def step(state: VoFODState, scan: ScanInput | PrebinnedScan, dyn: DynParams,
             stage_hook: Callable[[str], None] | None = None) -> tuple[VoFODState, StepOutput]:
        hook = stage_hook or (lambda name: None)
        hook("cnc")
        pose_np = np.ascontiguousarray(scan.pose, np.float32)
        pose = torch.from_numpy(pose_np)
        if device.type == "cuda":
            pose = pose.pin_memory().to(device, non_blocking=True)
        sensor_pos = pose[:3, 3]
        step_idx = state.step

        # the record_function ranges name the stages in a torch.profiler
        # trace (chip_smoke.py phase 5); off the profiler they cost ~1 us
        with record_function("vofod.frontend"):
            if frontend_mode == "prebinned":
                fe = run_frontend_prebinned(scan)
            else:
                fe = run_frontend(cfg, grid, lut_dirs, lut_offs, scan.ranges_mm, pose, ops)
        with record_function("vofod.background"):  # split + point update
            bg = split_and_update(cfg, dyn, state.grid, fe.counts, state.bg_sufficient, ops)
        with record_function("vofod.classify"):  # + floating check, demotions
            cls = classify(
                cfg, dyn, grid, bg.grid, bg.far, bg.labels, bg.cc_converged,
                sensor_pos, bg.bg_sufficient, state.sure_bg_sufficient, ops,
            )
        with record_function("vofod.detect"):
            dets, det_counter = extract_detections(
                cfg, dyn, grid, cls.grid, cls.labels, bg.far, cls, sensor_pos,
                state.det_counter, ops,
            )
        hook("raycasting")
        with record_function("vofod.raycast"):
            vals = ray_stage(scan, pose, dyn, step_idx, cls.grid, bg.occupied, fe.blockers)
        hook("sepbgclusters")
        safe, sure_bg = state.safe, state.sure_bg_sufficient
        sep_conv = torch.ones((), dtype=torch.bool, device=device)
        sep_sweeps = zero_i32
        if step_idx % cfg.sepclusters_every == 0 and not dyn.sepclusters_pause:
            with record_function("vofod.sepclusters"):
                sep = run_sepclusters(
                    cfg, dyn, vals, safe, float(cfg.sepclusters_every), prev_sure=sure_bg,
                    ops=ops,
                )
            vals, safe, sure_bg, sep_conv = sep.grid, sep.safe, sep.sure_bg_sufficient, sep.converged
            if sep.label_sweeps is not None:
                sep_sweeps = sep.label_sweeps
        hook("end")

        diag = StepDiagnostics(
            n_bg_voxels=bg.n_bg_voxels,
            bg_sufficient=bg.bg_sufficient,
            sure_bg_sufficient=sure_bg,
            n_occupied=bg.n_occupied,
            n_far=cls.n_far,
            far_overflow=cls.far_overflow,
            cc_converged=bg.cc_converged & cls.labels_converged,
            cc_iters=bg.cc_iters,
            sep_converged=sep_conv,
            n_detections=dets.valid.sum().to(torch.int32),
            n_queries=cls.n_queries,
            n_demoted=cls.n_demoted,
            sep_sweeps=sep_sweeps,
        )
        state.grid = vals
        state.safe = safe
        state.det_counter = det_counter
        state.step = step_idx + 1
        state.sure_bg_sufficient = sure_bg
        state.bg_sufficient = bg.bg_sufficient
        return state, StepOutput(detections=dets, diag=diag)

    return step

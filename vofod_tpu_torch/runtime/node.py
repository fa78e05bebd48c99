"""VoFOD host node: the thin shim that feeds scans to the PyTorch step.

PyTorch counterpart of vofod_tpu/runtime/node.py ``VoFOD`` (ref nodelet
shell, vofod_nodelet.cpp:141-303, 1296-1393) for the production
single-stream path: it owns the device-resident state, runs the step per
scan, and converts the fixed-shape outputs to Detections messages with ONE
device-to-host readback per scan.  The device is explicit: asking for CUDA
where there is none raises; the node never moves to the CPU on its own.

Ingest (``NodeOptions.frontend_mode``): "raw" uploads the ranges (and the
intensity, when the scan has one) and bins on the device (K3); "prebinned"
bins on the host with the native binner (io/binner.py); "auto" times both
on this machine once (``io.binner.probe_ingest_mode``) and takes the
cheaper.  Either way the host arrays go through two staging sets taken in
turn (io/staging.py: pinned once on CUDA, each guarded by the event of its
last copy) and one non-blocking copy per buffer.

The runtime surface of the JAX node: the rangefinder fusion, NPZ snapshots
that either package reads and checkpoint directories
(runtime/checkpoint.py), the debug voxel export, replay of a recorded NPZ,
the one-time LUT consistency check, the ProfilingInfo event stream (with
``profile_stages``, per-routine device times from the CUDA events of a
``StagedStep``, read after the scan's readback) and one ``torch.profiler``
trace window (``trace_dir``).
"""

from __future__ import annotations

import atexit
import dataclasses
import logging
import os
import time
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.geometry import GridSpec, yaw_rotation
from vofod_tpu_torch.io.binner import HostBinner, probe_ingest_mode
from vofod_tpu_torch.io.msgs import Detection, Detections, Header, ProfilingInfo, Status
from vofod_tpu_torch.io.scan_source import load_scans_npz
from vofod_tpu_torch.io.staging import HostStaging
from vofod_tpu_torch.pipeline.state import (
    PrebinnedScan, ScanInput, VoFODState, init_state, state_from_numpy, state_to_numpy)
from vofod_tpu_torch.pipeline.step import StagedStep, make_step_fn
from vofod_tpu_torch.runtime.profiling import ProfilingStream, ScopeTimer
from vofod_tpu_torch.sensor import XyzLut, check_sensor_params, load_mask, make_lut


@dataclass
class NodeOptions:
    raycast_mode: str = "sweep"  # "sweep" (production), "exact" (per-ray DDA) or "off"
    raycast_every: int = 1  # freespace update every N scans, its_diff = N
    world_frame_id: str = "world"
    throttle_period: float = 1.0
    mask_path: str = ""  # FOV mask (ref raycast/mask_filename)
    mask_mangle: bool = False  # destagger+transpose quirk (ref :527-543)
    check_consistency: bool = False  # LUT vs points check (ref :1869-1917)
    # per-routine device times (CNC, RAYCASTING, SEPBGCLUSTERS) on the
    # ProfilingInfo stream, from CUDA events at the step's stage boundaries
    # (read after the readback: no extra sync, the same result); without it
    # only CNC is timed (host) and the other two are sequence markers
    profile_stages: bool = False
    # "raw" (the device bins), "prebinned" (the host bins: the production
    # serving ingest; sweep raycast only) or "auto" (probe this machine's
    # transport once at start-up and take the cheaper; ``VoFOD.ingest_probe``)
    frontend_mode: str = "raw"
    # one torch.profiler window over scans [trace_skip, trace_skip +
    # trace_scans), exported as a Chrome trace into this directory
    trace_dir: str = ""
    trace_skip: int = 2
    trace_scans: int = 3


FRONTEND_OPTIONS = ("raw", "prebinned", "auto")
_ROUTINE_BY_STAGE = {
    "cnc": ProfilingInfo.ROUTINE_CNC,
    "raycasting": ProfilingInfo.ROUTINE_RAYCASTING,
    "sepbgclusters": ProfilingInfo.ROUTINE_SEPBGCLUSTERS,
}


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is False"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _pack(tensors: list[torch.Tensor]) -> tuple[torch.Tensor, list]:
    """Concatenate tensors' bytes into one uint8 buffer (one readback)."""
    flat, layout = [], []
    for t in tensors:
        t = t.contiguous()
        flat.append(t.reshape(-1).view(torch.uint8))
        layout.append((t.dtype, tuple(t.shape), t.numel() * t.element_size()))
    return torch.cat(flat), layout


_NP_DTYPE = {
    torch.float32: np.float32, torch.int32: np.int32, torch.bool: np.bool_,
}


def _unpack(buf: np.ndarray, layout: list) -> list[np.ndarray]:
    out, off = [], 0
    for dtype, shape, nbytes in layout:
        out.append(buf[off:off + nbytes].view(_NP_DTYPE[dtype]).reshape(shape))
        off += nbytes
    return out


def apriori_fids(cfg: VoFODConfig, grid: GridSpec, points_xyz: np.ndarray,
                 yaw_deg: float | None = None, translation=None) -> np.ndarray:
    """Flat grid ids (int64, one per point that lands in the grid, in point
    order) of an apriori cloud placed as in vofod_tpu: ``p' = R_yaw @ (p +
    t + sim_correction)`` (ref initialize_apriori_map,
    vofod_nodelet.cpp:224-225), the config's tf unless given."""
    if yaw_deg is None:
        yaw_deg = cfg.apriori_tf_yaw_deg
    if translation is None:
        translation = tuple(t + c for t, c in zip(cfg.apriori_tf, cfg.apriori_sim_correction))
    pts = np.asarray(points_xyz, np.float32)
    if pts.size == 0:
        return np.zeros(0, np.int64)
    R = yaw_rotation(np.deg2rad(yaw_deg))
    pts = (pts + np.asarray(translation, np.float32)) @ R.T
    ox, oy, oz = grid.origin
    idx = np.floor((pts - np.array([ox, oy, oz])) / grid.voxel_size).astype(np.int64)
    ok = (
        (idx[:, 0] >= 0) & (idx[:, 0] < grid.nx)
        & (idx[:, 1] >= 0) & (idx[:, 1] < grid.ny)
        & (idx[:, 2] >= 0) & (idx[:, 2] < grid.nz)
    )
    idx = idx[ok]
    return (idx[:, 2] * grid.ny + idx[:, 1]) * grid.nx + idx[:, 0]


def _close_trace_at_exit(ref) -> None:
    node = ref()
    if node is not None:
        node.close_trace()


class VoFOD:
    """The detector node.  Thread-free: call :meth:`process_scan` per scan."""

    def __init__(
        self,
        cfg: VoFODConfig | None = None,
        dyn: DynParams | None = None,
        options: NodeOptions | None = None,
        lut: XyzLut | None = None,
        *,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg or VoFODConfig()
        self.dyn = dyn or DynParams()
        self.options = options or NodeOptions()
        self.grid_spec = GridSpec.from_config(self.cfg)
        self.lut = lut or make_lut(self.cfg.sensor)
        self.profiling = ProfilingStream()
        self.mask = load_mask(
            self.options.mask_path,
            self.cfg.sensor.horizontal_rays,
            self.cfg.sensor.vertical_rays,
            mangle=self.options.mask_mangle,
        )
        if self.options.frontend_mode not in FRONTEND_OPTIONS:
            raise ValueError(f"unknown frontend_mode {self.options.frontend_mode!r}, expected "
                             f"one of {FRONTEND_OPTIONS}")
        self.ingest_probe = None
        if self.options.frontend_mode == "auto":
            mode, self.ingest_probe = probe_ingest_mode(self.cfg, self.lut, self.mask,
                                                        self.device)
            logging.getLogger("vofod_tpu_torch").info(
                "ingest probe picked %r: %s", mode, self.ingest_probe)
            self.options = dataclasses.replace(self.options, frontend_mode=mode)
        self._step = make_step_fn(
            self.cfg, self.lut, device=self.device,
            raycast_mode=self.options.raycast_mode,
            raycast_every=self.options.raycast_every,
            mask=self.mask,
            frontend_mode=self.options.frontend_mode,
        )
        # profile_stages: the same step, its routines' boundaries marked
        self._staged = StagedStep(step=self._step) if self.options.profile_stages else None
        n = self.cfg.sensor.n_points
        self._binner = None
        if self.options.frontend_mode == "prebinned":
            # native only: a failed build raises, the numpy oracle never serves
            self._binner = HostBinner(self.cfg, self.lut, mask=self.mask)
            specs = ((self._binner.n_voxels, torch.uint8), (n, torch.uint8), (2, torch.int32))
        else:
            specs = ((n, torch.float32), (n, torch.float32))  # ranges, intensity
        self._staging = HostStaging(specs, self.device)
        self._ones_dev = None  # cached all-ones intensity
        self.state: VoFODState = init_state(self.cfg, self.dyn, device=self.device)
        self.n_pose_rejected = 0
        self.last_diag = None
        self.last_scope_timer = None
        self.last_stage_ms = None  # {"cnc", "raycasting", "sepbgclusters"} device ms
        self._sensor_checked = False
        self._sensor_params_ok = True
        self._log = logging.getLogger("vofod_tpu_torch")
        self._last_log = 0.0
        self._last_pose_warn = 0.0
        # the trace window: "pending" -> "on" -> "done"
        self._trace_state = "pending" if self.options.trace_dir else "done"
        self._prof = None
        self.trace_path = None
        if self.options.trace_dir:
            # a run shorter than the window still writes its trace; the hook
            # holds the node weakly and dereferences it once
            atexit.register(_close_trace_at_exit, weakref.ref(self))

    # ------------------------------------------------------------------ scans
    def process_scan(
        self, ranges_mm: np.ndarray, intensity: np.ndarray | None, pose: np.ndarray,
        stamp: float = 0.0, points_xyz: np.ndarray | None = None,
    ) -> Detections:
        """Run one scan through the pipeline.

        ranges_mm: [H*W] or [H, W] uint32/float (0 = no return).
        intensity: same shape (None = all ones).
        pose: [4, 4] world_T_sensor.
        points_xyz: optional sensor-frame points for the one-time LUT
          consistency check (``options.check_consistency``; ref
          check_sensor_params, vofod_nodelet.cpp:903-904).
        """
        return self.fetch_result(self.process_scan_async(ranges_mm, intensity, pose, stamp,
                                                         points_xyz=points_xyz))

    def process_scan_async(self, ranges_mm, intensity, pose, stamp: float = 0.0,
                           points_xyz: np.ndarray | None = None):
        """Enqueue one scan's step without waiting for the device; resolve the
        returned handle with :meth:`fetch_result`."""
        n = self.cfg.sensor.n_points
        r = np.asarray(ranges_mm).reshape(-1)
        if self.options.check_consistency and not self._sensor_checked and points_xyz is not None:
            self._sensor_params_ok = self.check_scan_consistency(
                np.asarray(points_xyz).reshape(-1, 3), r)
            self._sensor_checked = True
        if r.shape[0] != n:
            raise ValueError(
                f"unexpected scan size {r.shape[0]}, expected {n} "
                f"({self.cfg.sensor.vertical_rays}x{self.cfg.sensor.horizontal_rays})"
            )  # ref size guard, vofod_nodelet.cpp:895-899
        stimer = ScopeTimer(f"pc proc #{self.state.step}")
        pose_np = np.asarray(pose, np.float32)
        if not np.isfinite(pose_np).all():
            # lost/invalid TF: the reference skips the scan (:900-914)
            self.n_pose_rejected += 1
            now = time.time()
            if now - self._last_pose_warn >= self.options.throttle_period:
                self._last_pose_warn = now
                self._log.warning(
                    "non-finite pose — scan skipped (%d rejected so far)",
                    self.n_pose_rejected,
                )
            return None, stamp, stimer, None
        if self._binner is not None:
            scan = self._prebinned_scan(r, intensity, pose_np)
            stimer.checkpoint("host bin")
        else:
            scan = self._raw_scan(r, intensity, pose_np)
        stimer.checkpoint("upload")
        if self._trace_state == "pending" and self.state.step >= self.options.trace_skip:
            self._start_trace()
        marks = None
        if self._staged is not None:
            self.state, out = self._staged(self.state, scan, self.dyn)
            marks = self._staged.last_marks
        else:
            with self.profiling.routine(ProfilingInfo.ROUTINE_CNC):
                self.state, out = self._step(self.state, scan, self.dyn)
        stimer.checkpoint("dispatch")
        if (self._trace_state == "on"
                and self.state.step >= self.options.trace_skip + self.options.trace_scans):
            self.close_trace()
        if not self.options.profile_stages:
            self._emit_markers(self.state.step - 1)
        return out, stamp, stimer, marks

    def _raw_scan(self, r: np.ndarray, intensity, pose_np) -> ScanInput:
        """Stage the ranges (and the intensity, when given) and upload them."""
        i, (r_buf, i_buf) = self._staging.next()
        np.copyto(r_buf, r, casting="unsafe")  # as r.astype(np.float32)
        if intensity is None:
            (ranges,) = self._staging.upload(i, 1)
            if self._ones_dev is None:
                self._ones_dev = torch.ones(r.shape[0], dtype=torch.float32, device=self.device)
            inten = self._ones_dev
        else:
            np.copyto(i_buf, np.asarray(intensity).reshape(-1), casting="unsafe")
            ranges, inten = self._staging.upload(i)
        return ScanInput(ranges_mm=ranges, intensity=inten, pose=pose_np)

    def _prebinned_scan(self, r, intensity, pose_np) -> PrebinnedScan:
        """Bin the scan on the host straight into a staging set and upload it."""
        inten = None if intensity is None else np.asarray(intensity, np.float32).reshape(-1)
        i, out = self._staging.next()
        self._binner.bin(r, pose_np, intensity=inten,
                         min_intensity=float(self.dyn.raycast_min_intensity), out=out)
        packed, active, stats = self._staging.upload(i)
        return PrebinnedScan(packed=packed.view(self._binner.shape), active=active,
                             pose=pose_np, stats=stats)

    def _emit_markers(self, step_idx: int) -> None:
        """The fused step subsumes the reference's raycast and sepclusters
        threads: their START/END markers (no duration) keep the routine
        sequence of the ProfilingInfo stream, emitted when the stage was due
        and not paused (the reference returns before its profile_start when
        paused, vofod_nodelet.cpp:1128-1133, 1400-1405)."""
        every = max(self.options.raycast_every, 1)
        if (self.options.raycast_mode != "off" and step_idx % every == every - 1
                and not self.dyn.raycast_pause):
            with self.profiling.routine(ProfilingInfo.ROUTINE_RAYCASTING):
                pass
        if step_idx % max(self.cfg.sepclusters_every, 1) == 0 and not self.dyn.sepclusters_pause:
            with self.profiling.routine(ProfilingInfo.ROUTINE_SEPBGCLUSTERS):
                pass

    def _emit_stages(self, marks) -> None:
        """Per-routine device times from the stage marks (their events are
        complete once the readback returned): ``last_stage_ms`` and one
        START/END pair per routine, stamped from the first mark's wall time
        plus the device times."""
        ms = {name: s * 1e3 for name, s in StagedStep.timings(marks).items()}
        self.last_stage_ms = ms
        t = marks[0][2]
        for name, d in ms.items():
            self.profiling.start(_ROUTINE_BY_STAGE[name], stamp=t)
            t += d / 1e3
            self.profiling.end(_ROUTINE_BY_STAGE[name], stamp=t)

    def fetch_result(self, pending) -> Detections:
        """Wait for a :meth:`process_scan_async` handle and convert it to the
        Detections message: diagnostics and detections ride ONE packed
        device-to-host copy, the only host sync of a scan."""
        out, stamp, stimer, marks = pending
        if out is None:  # scan was skipped (non-finite pose) — empty message
            return Detections(header=Header(stamp, self.options.world_frame_id))
        diag_f = dataclasses.fields(out.diag)
        det_f = dataclasses.fields(out.detections)
        tensors = [getattr(out.diag, f.name) for f in diag_f] + [
            getattr(out.detections, f.name) for f in det_f
        ]
        buf, layout = _pack(tensors)
        host = _unpack(buf.cpu().numpy(), layout)
        stimer.checkpoint("readback")
        self.last_scope_timer = stimer
        if marks:
            self._emit_stages(marks)
        self.last_diag = type(out.diag)(**{f.name: v for f, v in zip(diag_f, host)})
        dets = type(out.detections)(
            **{f.name: v for f, v in zip(det_f, host[len(diag_f):])}
        )
        self._log_throttled()
        return self._to_msg_host(dets, stamp)

    def _log_throttled(self):
        now = time.time()
        if now - self._last_log < self.options.throttle_period:
            return
        self._last_log = now
        d = self.last_diag
        self._log.info(
            "step=%d dets=%d occ=%d far=%d bg=%d active=%s cc_ok=%s",
            self.state.step, int(d.n_detections), int(d.n_occupied),
            int(d.n_far), int(d.n_bg_voxels),
            bool(d.bg_sufficient and d.sure_bg_sufficient), bool(d.cc_converged),
        )
        if not d.bg_sufficient:
            self._log.warning(
                "insufficient background (%d voxels) — classification inactive",
                int(d.n_bg_voxels),
            )  # ref :724

    def _to_msg_host(self, d, stamp: float) -> Detections:
        msg = Detections(header=Header(stamp, self.options.world_frame_id))
        for k in range(d.valid.shape[0]):
            if not d.valid[k]:
                continue
            msg.detections.append(
                Detection(
                    id=int(d.id[k]),
                    confidence=float(d.confidence[k]),
                    n_points=int(d.n_points[k]),
                    position=tuple(float(v) for v in d.position[k]),
                    covariance=tuple(float(v) for v in d.covariance[k].reshape(-1)),
                    detection_probability=float(d.detection_probability[k]),
                )
            )
        return msg

    # ------------------------------------------------------------ trace window
    def _start_trace(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._trace_state = "on"

    def close_trace(self) -> None:
        """Close an open trace window (``options.trace_dir``) and write its
        Chrome trace.  ``process_scan`` closes the window after
        ``trace_scans`` scans; this covers runs that end earlier (``replay``
        and an atexit hook call it).  The profiler stops even when the
        device flush raises.  Idempotent."""
        if self._trace_state != "on":
            return
        prof, self._prof = self._prof, None
        try:
            try:
                if self.device.type == "cuda":  # the window holds completed work
                    torch.cuda.synchronize(self.device)
            finally:
                prof.stop()
            os.makedirs(self.options.trace_dir, exist_ok=True)
            path = os.path.join(self.options.trace_dir,
                                f"vofod_trace_to_scan_{self.state.step}.json")
            prof.export_chrome_trace(path)
            self.trace_path = path
            self._log.info("device trace to scan %d written to %s", self.state.step, path)
        finally:
            self._trace_state = "done"

    # ------------------------------------------------------------ rangefinder
    def process_rangefinder(self, rng: float, min_range: float, max_range: float,
                            pose: np.ndarray) -> bool:
        """Fuse a downward rangefinder hit (ref processMsg(Range), :579-613):
        the hit's voxel becomes ``(v + score_point) / 2`` in float32.

        The reference's validity check uses && where || was intended (ref
        :585); the spec-correct check is the default, the quirk is
        ``cfg.compat_rangefinder_validity``.  The check, the hit and its
        voxel are computed on the host (the float32 floor of
        GridSpec.coord_to_idx); the update is two in-place ops on the grid
        in stream order, no sync."""
        if self.cfg.compat_rangefinder_validity:
            invalid = rng <= min_range and rng >= max_range  # ref quirk
        else:
            invalid = rng <= min_range or rng >= max_range
        if invalid:
            return False
        pt = np.asarray(pose, np.float32) @ np.array([rng, 0, 0, 1], np.float32)
        g = self.grid_spec
        idx = np.floor((pt[:3] - np.asarray(g.origin, np.float32))
                       * np.float32(g.inv_voxel)).astype(np.int64)
        if not all(0 <= idx[a] < n for a, n in enumerate((g.nx, g.ny, g.nz))):
            self._log.error("rangefinder hit outside the operation area")
            return False
        fid = int((idx[2] * g.ny + idx[1]) * g.nx + idx[0])
        # mapval = (mapval + point_score) / 2 (ref vofod_nodelet.cpp:608-611)
        self.state.grid.view(-1)[fid:fid + 1].add_(float(np.float32(self.dyn.score_point))
                                                   ).div_(2.0)
        return True

    # ------------------------------------------------------------ apriori map
    def load_apriori_map(
        self, points_xyz: np.ndarray, yaw_deg: float | None = None, translation=None,
    ) -> int:
        """Stamp an apriori static cloud into the map as +inf background
        (ref initialize_apriori_map, vofod_nodelet.cpp:305-355); placement as
        in vofod_tpu (``p' = R @ (p + t + sim_correction)``).  Returns the
        number of stamped voxels."""
        fids = apriori_fids(self.cfg, self.grid_spec, points_xyz, yaw_deg, translation)
        if fids.size:
            self.state.grid.view(-1).index_fill_(
                0, torch.as_tensor(fids, device=self.device), float("inf")
            )  # ref stamps +inf (:341)
        return int(fids.size)

    # -------------------------------------------------------------- live tuning
    def update_params(self, **kwargs) -> None:
        """Change scores/thresholds/gates between scans (the
        dynamic_reconfigure analogue; the step reads them as host values, so
        nothing is rebuilt).  The two stencil radii
        (``ground_points_max_distance``, ``sepclusters_max_bg_distance``)
        move only on a node built with ``cfg.dynamic_radii`` (the pools then
        keep the shells of the *_bound radii within them); otherwise the
        static VoFODConfig values apply and changing them raises, as in
        vofod_tpu."""
        if not self.cfg.dynamic_radii:
            for k in ("ground_points_max_distance", "sepclusters_max_bg_distance"):
                if k in kwargs:
                    raise ValueError(
                        f"{k} shapes the stencils; it is static unless the node is built "
                        "with cfg.dynamic_radii=True (VoFODConfig.dynamic_radii)")
        self.dyn = dataclasses.replace(self.dyn, **kwargs)

    def check_scan_consistency(self, points_xyz: np.ndarray, ranges_mm: np.ndarray) -> bool:
        """Validate received points against the LUT ray model
        (ref check_sensor_params, vofod_nodelet.cpp:1869-1917)."""
        return check_sensor_params(self.lut, points_xyz, ranges_mm)

    # ----------------------------------------------------------------- status
    def status(self) -> Status:
        d = self.last_diag
        enabled = bool(d.bg_sufficient and d.sure_bg_sufficient) if d else False
        return Status(detection_enabled=True, detection_active=enabled)

    def reset(self):
        """The ~reset service (ref reset_callback :566-572)."""
        self.state = init_state(self.cfg, self.dyn, device=self.device)

    # -------------------------------------------------------------- exports
    def export_voxels(self, threshold: float, above: bool = True) -> np.ndarray:
        """Voxel centers with value above (or below-or-equal) a threshold —
        the ~background_pc / ~sure_air_pc debug clouds (ref voxelsAsPC,
        voxel_map.cpp:157-184; publishers vofod_nodelet.cpp:1001-1016)."""
        vals = self.state.grid.cpu().numpy()
        m = vals > threshold if above else ~(vals > threshold)
        zz, yy, xx = np.nonzero(m)
        g = self.grid_spec
        ox, oy, oz = g.origin
        return np.stack(
            [
                (xx + 0.5) * g.voxel_size + ox,
                (yy + 0.5) * g.voxel_size + oy,
                (zz + 0.5) * g.voxel_size + oz,
            ],
            axis=1,
        ).astype(np.float32)

    # ------------------------------------------------------------------ replay
    def replay(self, npz_path: str, intensity=None, before_scan=None) -> list[Detections]:
        """Run a recorded scan sequence (fixtures written by
        io.scan_source.save_scans_npz).  ``intensity`` overrides the
        recording's channel; ``before_scan``: optional ``f(scan_index)``
        called before each scan.  A trace window still open at the end is
        written."""
        ranges, poses, stamps, inten = load_scans_npz(npz_path)
        out = []
        try:
            for k, (r, p, t) in enumerate(zip(ranges, poses, stamps)):
                if before_scan is not None:
                    before_scan(k)
                i = intensity if intensity is not None else (
                    inten[k] if inten is not None else None)
                out.append(self.process_scan(r, i, p, float(t)))
        finally:
            self.close_trace()
        return out

    # ----------------------------------------------------------- checkpointing
    def save_snapshot(self, path: str):
        """Snapshot of the full detector state.  ``*.npz`` paths write a host
        NPZ with the JAX node's keys and dtypes, so either package reads the
        other's files; any other path writes a checkpoint directory
        (runtime/checkpoint.py, the dense layout: its ``state.npz`` is such
        an NPZ)."""
        if not path.endswith(".npz"):
            from vofod_tpu_torch.runtime.checkpoint import save_state

            save_state(path, self.state)
            return
        np.savez_compressed(path, **state_to_numpy(self.state))

    def load_snapshot(self, path: str):
        """Restore a snapshot written by :meth:`save_snapshot` (either
        package's NPZ, or a checkpoint directory of any z-slab layout) onto
        this node's device."""
        if not path.endswith(".npz"):
            from vofod_tpu_torch.runtime.checkpoint import restore_state

            self.state = restore_state(path, self.state)
            return
        with np.load(path) as z:
            self.state = state_from_numpy(z, self.device)

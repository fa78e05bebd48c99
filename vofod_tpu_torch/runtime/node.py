"""VoFOD host node: the thin shim that feeds scans to the PyTorch step.

PyTorch counterpart of vofod_tpu/runtime/node.py ``VoFOD`` (ref nodelet
shell, vofod_nodelet.cpp:141-303, 1296-1393) for the production
single-stream path: it owns the device-resident state, runs the step per
scan, and converts the fixed-shape outputs to Detections messages with ONE
device-to-host readback per scan.  The device is explicit: asking for CUDA
where there is none raises; the node never moves to the CPU on its own.

Ingest (``NodeOptions.frontend_mode``): "raw" uploads the ranges and bins on
the device (K3); "prebinned" bins on the host with the native binner
(io/binner.py) straight into one of two pinned staging buffers, taken in
turn, each guarded by a CUDA event so that it is never rebinned while its
copy is in flight, and uploads the packed grid with one non-blocking copy;
"auto" times both on this machine once (``io.binner.probe_ingest_mode``)
and takes the cheaper.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.geometry import GridSpec, yaw_rotation
from vofod_tpu_torch.io.msgs import Detection, Detections, Header, Status
from vofod_tpu_torch.io.binner import HostBinner, probe_ingest_mode
from vofod_tpu_torch.pipeline.state import PrebinnedScan, ScanInput, VoFODState, init_state
from vofod_tpu_torch.pipeline.step import make_step_fn
from vofod_tpu_torch.sensor import XyzLut, load_mask, make_lut


@dataclass
class NodeOptions:
    raycast_mode: str = "sweep"  # "sweep" (production), "exact" (per-ray DDA) or "off"
    raycast_every: int = 1  # freespace update every N scans, its_diff = N
    world_frame_id: str = "world"
    throttle_period: float = 1.0
    mask_path: str = ""  # FOV mask (ref raycast/mask_filename)
    mask_mangle: bool = False  # destagger+transpose quirk (ref :527-543)
    # "raw" (the device bins), "prebinned" (the host bins: the production
    # serving ingest; sweep raycast only) or "auto" (probe this machine's
    # transport once at start-up and take the cheaper; ``VoFOD.ingest_probe``)
    frontend_mode: str = "raw"


FRONTEND_OPTIONS = ("raw", "prebinned", "auto")


class _PinnedStaging:
    """Two sets of pinned host buffers (packed grid, active mask, stats) for
    the prebinned upload, used in turn.  A set is rebinned only after the
    copy that last read it has finished (its CUDA event); by then that scan's
    readback has long waited for it, so the check does not block."""

    def __init__(self, n_voxels: int, n_pixels: int, device: torch.device):
        self.device = device
        self.sets = [
            tuple(torch.empty(n, dtype=dt, pin_memory=True)
                  for n, dt in ((n_voxels, torch.uint8), (n_pixels, torch.uint8),
                                (2, torch.int32)))
            for _ in range(2)
        ]
        self.events = [None, None]
        self.turn = 0

    def next(self) -> tuple[int, tuple[np.ndarray, ...]]:
        """(set index, numpy views of its buffers) of the set to bin into."""
        i, self.turn = self.turn, 1 - self.turn
        ev = self.events[i]
        if ev is not None and not ev.query():
            ev.synchronize()
        return i, tuple(t.numpy() for t in self.sets[i])

    def upload(self, i: int) -> tuple[torch.Tensor, ...]:
        """One non-blocking copy per buffer of set ``i``; records its event."""
        out = tuple(t.to(self.device, non_blocking=True) for t in self.sets[i])
        ev = torch.cuda.Event()
        ev.record()
        self.events[i] = ev
        return out


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
        self._binner = self._staging = None
        if self.options.frontend_mode == "prebinned":
            # native only: a failed build raises, the numpy oracle never serves
            self._binner = HostBinner(self.cfg, self.lut, mask=self.mask)
            if self.device.type == "cuda":
                self._staging = _PinnedStaging(self._binner.n_voxels, self._binner.n,
                                               self.device)
        self._ones_dev = None  # cached all-ones intensity
        self.state: VoFODState = init_state(self.cfg, self.dyn, device=self.device)
        self.n_pose_rejected = 0
        self.last_diag = None
        self._log = logging.getLogger("vofod_tpu_torch")
        self._last_log = 0.0
        self._last_pose_warn = 0.0

    # ------------------------------------------------------------------ scans
    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def process_scan(
        self, ranges_mm: np.ndarray, intensity: np.ndarray | None, pose: np.ndarray,
        stamp: float = 0.0,
    ) -> Detections:
        """Run one scan through the pipeline.

        ranges_mm: [H*W] or [H, W] uint32/float (0 = no return).
        intensity: same shape (None = all ones).
        pose: [4, 4] world_T_sensor.
        """
        return self.fetch_result(self.process_scan_async(ranges_mm, intensity, pose, stamp))

    def process_scan_async(self, ranges_mm, intensity, pose, stamp: float = 0.0):
        """Enqueue one scan's step without waiting for the device; resolve the
        returned handle with :meth:`fetch_result`."""
        n = self.cfg.sensor.n_points
        r = np.asarray(ranges_mm).reshape(-1)
        if r.shape[0] != n:
            raise ValueError(
                f"unexpected scan size {r.shape[0]}, expected {n} "
                f"({self.cfg.sensor.vertical_rays}x{self.cfg.sensor.horizontal_rays})"
            )  # ref size guard, vofod_nodelet.cpp:895-899
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
            return None, stamp
        if self._binner is not None:
            scan = self._prebinned_scan(r, intensity, pose_np)
            self.state, out = self._step(self.state, scan, self.dyn)
            return out, stamp
        if intensity is None:
            if self._ones_dev is None:
                self._ones_dev = torch.ones(n, dtype=torch.float32, device=self.device)
            inten = self._ones_dev
        else:
            inten = self._upload(np.asarray(intensity, np.float32).reshape(-1))
        scan = ScanInput(
            ranges_mm=self._upload(r.astype(np.float32)), intensity=inten, pose=pose_np
        )
        self.state, out = self._step(self.state, scan, self.dyn)
        return out, stamp

    def _prebinned_scan(self, r, intensity, pose_np) -> PrebinnedScan:
        """Bin the scan on the host and upload it (pinned staging on CUDA)."""
        inten = None if intensity is None else np.asarray(intensity, np.float32).reshape(-1)
        min_i = float(self.dyn.raycast_min_intensity)
        if self._staging is None:
            return self._binner.bin(r, pose_np, intensity=inten,
                                    min_intensity=min_i).to_device(self.device)
        i, out = self._staging.next()
        self._binner.bin(r, pose_np, intensity=inten, min_intensity=min_i, out=out)
        packed, active, stats = self._staging.upload(i)
        return PrebinnedScan(packed=packed.view(self._binner.shape), active=active,
                             pose=pose_np, stats=stats)

    def fetch_result(self, pending) -> Detections:
        """Wait for a :meth:`process_scan_async` handle and convert it to the
        Detections message: diagnostics and detections ride ONE packed
        device-to-host copy, the only host sync of a scan."""
        out, stamp = pending
        if out is None:  # scan was skipped (non-finite pose) — empty message
            return Detections(header=Header(stamp, self.options.world_frame_id))
        diag_f = dataclasses.fields(out.diag)
        det_f = dataclasses.fields(out.detections)
        tensors = [getattr(out.diag, f.name) for f in diag_f] + [
            getattr(out.detections, f.name) for f in det_f
        ]
        buf, layout = _pack(tensors)
        host = _unpack(buf.cpu().numpy(), layout)
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

    # ------------------------------------------------------------ apriori map
    def load_apriori_map(
        self, points_xyz: np.ndarray, yaw_deg: float | None = None, translation=None,
    ) -> int:
        """Stamp an apriori static cloud into the map as +inf background
        (ref initialize_apriori_map, vofod_nodelet.cpp:305-355); placement as
        in vofod_tpu (``p' = R @ (p + t + sim_correction)``).  Returns the
        number of stamped voxels."""
        if yaw_deg is None:
            yaw_deg = self.cfg.apriori_tf_yaw_deg
        if translation is None:
            translation = tuple(
                t + c for t, c in zip(self.cfg.apriori_tf, self.cfg.apriori_sim_correction)
            )
        pts = np.asarray(points_xyz, np.float32)
        if pts.size == 0:
            return 0
        R = yaw_rotation(np.deg2rad(yaw_deg))
        pts = (pts + np.asarray(translation, np.float32)) @ R.T
        g = self.grid_spec
        ox, oy, oz = g.origin
        idx = np.floor((pts - np.array([ox, oy, oz])) / g.voxel_size).astype(np.int64)
        ok = (
            (idx[:, 0] >= 0) & (idx[:, 0] < g.nx)
            & (idx[:, 1] >= 0) & (idx[:, 1] < g.ny)
            & (idx[:, 2] >= 0) & (idx[:, 2] < g.nz)
        )
        idx = idx[ok]
        fids = (idx[:, 2] * g.ny + idx[:, 1]) * g.nx + idx[:, 0]
        self.state.grid.view(-1).index_fill_(
            0, torch.as_tensor(fids, device=self.device), float("inf")
        )  # ref stamps +inf (:341)
        return int(idx.shape[0])

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

    # ----------------------------------------------------------------- status
    def status(self) -> Status:
        d = self.last_diag
        enabled = bool(d.bg_sufficient and d.sure_bg_sufficient) if d else False
        return Status(detection_enabled=True, detection_active=enabled)

    def reset(self):
        """The ~reset service (ref reset_callback :566-572)."""
        self.state = init_state(self.cfg, self.dyn, device=self.device)

"""Host-side scan binning: the prebinned ingest's CPU half, and the probe
that picks the ingest.

Copy of vofod_tpu/io/binner.py for the port (held to it by
tests/test_torch_shared_copies.py and tests/test_torch_binner.py).  The
host bins each organized scan (native/frontend.cpp, built by
:mod:`vofod_tpu_torch.io.native`) into a packed dense uint8 grid — low 6
bits = filtered point count clamped to 63 (bit-equivalent through the point
EMA, which clamps at 63 itself), bit 7 = any-return blocker flag — so the
device frontend is the elementwise unpack K15a (pipeline/frontend.py
``run_frontend_prebinned``) and the device histogram scatter K3 leaves the
step.  The numpy ``_bin_np`` has the same semantics and is the oracle of
the native path in the tests; it runs only when asked for
(``use_native=False``).

``probe_ingest_mode`` times this deployment's transport and picks the
cheaper ingest (``frontend_mode="auto"``).  Where the JAX probe prices the
device scatter at a TPU v5e figure, this one times K3 on the device it
serves, as the step pays for it.
"""

from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass

import numpy as np
import torch

from vofod_tpu_torch.config import VoFODConfig
from vofod_tpu_torch.io import native
from vofod_tpu_torch.sensor import XyzLut


@dataclass
class BinnedScan:
    """One host-binned scan (numpy; see pipeline/state.PrebinnedScan for the
    device-side form)."""

    packed: np.ndarray  # uint8 (nz, ny, nx): count & 0x3f | blocker << 7
    active: np.ndarray  # uint8 [N] per-pixel raycast gate mask
    pose: np.ndarray  # float32 [4, 4]
    n_valid_points: int
    n_exclude_hits: int

    def to_device(self, device):
        """The step's ``PrebinnedScan`` on ``device`` (the pose stays on the
        host; the two counts ride one int32 pair)."""
        from vofod_tpu_torch.pipeline.state import PrebinnedScan

        stats = np.array([self.n_valid_points, self.n_exclude_hits], np.int32)
        return PrebinnedScan(
            packed=torch.as_tensor(self.packed, device=device),
            active=torch.as_tensor(self.active, device=device),
            pose=self.pose,
            stats=torch.as_tensor(stats, device=device),
        )


class HostBinner:
    """Per-sensor host binner bound to a (config, LUT, mask) triple.
    ``use_native=True`` builds the native library (a failed build raises);
    ``use_native=False`` takes the numpy oracle."""

    def __init__(
        self,
        cfg: VoFODConfig,
        lut: XyzLut,
        mask: np.ndarray | None = None,
        use_native: bool = True,
    ):
        self.cfg = cfg
        self.dirs = np.ascontiguousarray(lut.directions, np.float32)
        self.offs = np.ascontiguousarray(lut.offsets, np.float32)
        self.n = self.dirs.shape[0]
        self.mask = (
            np.ones(self.n, np.uint8)
            if mask is None
            else np.ascontiguousarray(np.asarray(mask).reshape(-1) > 0, np.uint8)
        )
        nz, ny, nx = cfg.grid_shape
        self.shape = (nz, ny, nx)
        self.n_voxels = nz * ny * nx
        self._ctx = None
        self._lib = native.load() if use_native else None
        if self._lib is not None:
            f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
            self._boxes = [f32(cfg.exclude_box.lo), f32(cfg.exclude_box.hi),
                           f32(cfg.oparea.lo), f32(cfg.oparea.hi), f32(cfg.grid_origin)]
            self._ctx = self._lib.vofod_binner_create(
                self.dirs.ctypes.data, self.offs.ctypes.data, self.n, self.mask.ctypes.data,
                *(b.ctypes.data for b in self._boxes), nx, ny, nz, cfg.voxel_size,
            )

    @property
    def native(self) -> bool:
        return self._ctx is not None

    def __del__(self):
        if getattr(self, "_ctx", None):
            self._lib.vofod_binner_destroy(self._ctx)
            self._ctx = None

    def bin(
        self,
        ranges_mm: np.ndarray,
        pose: np.ndarray,
        intensity: np.ndarray | None = None,
        min_intensity: float = 0.0,
        out: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None,
    ) -> BinnedScan:
        """Bin one scan.  ``out``: (packed uint8 [n_voxels], active uint8
        [N], stats int32 [2]) arrays to write into — the node's pinned
        staging buffers — else fresh ones."""
        r_in = np.asarray(ranges_mm).reshape(-1)
        if np.issubdtype(r_in.dtype, np.floating):
            # Hostile-float contract (tests/test_hostile_inputs.py): NaN and
            # negative ranges are no-returns, +inf a 4e9 mm return outside
            # any operation area that still opens the raycast gate (ref
            # :1449-1450 keys on range != 0); the uint32 cast below is
            # undefined for non-finite values, so map them first.
            r_in = r_in.astype(np.float64)  # holds 4e9 exactly at any input width
            r_in[np.isnan(r_in) | (r_in < 0)] = 0.0
            np.minimum(r_in, 4.0e9, out=r_in)
        ranges_mm = np.ascontiguousarray(r_in, np.uint32)
        pose = np.asarray(pose, np.float32)
        if intensity is None:
            # the raw step substitutes intensity = ones when the source has
            # none (runtime/node.py), so the gate is `1.0 >= min_intensity`
            if not hasattr(self, "_ones"):
                self._ones = np.ones(self.n, np.float32)
            intensity = self._ones
        if out is None:
            out = (np.empty(self.n_voxels, np.uint8), np.empty(self.n, np.uint8),
                   np.empty(2, np.int32))
        if self._ctx is not None:
            self._bin_native(ranges_mm, pose, intensity, min_intensity, out)
        else:
            self._bin_np(ranges_mm, pose, intensity, min_intensity, out)
        packed, active, stats = out
        return BinnedScan(
            packed=packed.reshape(self.shape), active=active, pose=pose,
            n_valid_points=int(stats[0]), n_exclude_hits=int(stats[1]),
        )

    # -- native path ----------------------------------------------------------
    def _bin_native(self, ranges_mm, pose, intensity, min_intensity, out):
        packed, active, stats = out
        inten = np.ascontiguousarray(np.asarray(intensity).reshape(-1), np.float32)
        self._lib.vofod_binner_bin_dense(
            self._ctx, ranges_mm.ctypes.data, inten.ctypes.data,
            np.ascontiguousarray(pose).ctypes.data, ctypes.c_float(min_intensity),
            packed.ctypes.data, active.ctypes.data, stats.ctypes.data,
        )

    # -- NumPy oracle ---------------------------------------------------------
    def _bin_np(self, ranges_mm, pose, intensity, min_intensity, out):
        cfg = self.cfg
        r = ranges_mm.astype(np.float32) * np.float32(0.001)
        has_return = r > 0
        pts_s = self.dirs * r[:, None] + self.offs
        lo = np.asarray(cfg.exclude_box.lo, np.float32)
        hi = np.asarray(cfg.exclude_box.hi, np.float32)
        excl = np.all((pts_s >= lo) & (pts_s <= hi), axis=-1)
        R, t = pose[:3, :3], pose[:3, 3]
        pw = pts_s @ R.T + t
        olo = np.asarray(cfg.oparea.lo, np.float32)
        ohi = np.asarray(cfg.oparea.hi, np.float32)
        inop = np.all((pw >= olo) & (pw <= ohi), axis=-1)
        nz, ny, nx = self.shape
        origin = np.asarray(cfg.grid_origin, np.float32)
        idx = np.floor(
            (pw - origin) * np.float32(1.0 / cfg.voxel_size)
        ).astype(np.int64)
        inb = np.all((idx >= 0) & (idx < [nx, ny, nz]), axis=-1)
        fid_all = (idx[:, 2] * ny + idx[:, 1]) * nx + idx[:, 0]

        blocker = has_return & inop & inb
        valid = blocker & ~excl
        counts = np.zeros(self.n_voxels, np.int64)
        np.add.at(counts, fid_all[valid], 1)
        bmask = np.zeros(self.n_voxels, bool)
        bmask[fid_all[blocker]] = True
        packed, active, stats = out
        packed[:] = np.minimum(counts, 63).astype(np.uint8) | (bmask.astype(np.uint8) << 7)
        # ref rule is `intensity < min -> skip` (:1449): NaN passes
        act_i = ~(np.asarray(intensity).reshape(-1) < min_intensity)
        active[:] = (act_i & ((self.mask > 0) | has_return)).astype(np.uint8)
        stats[:] = (int(valid.sum()), int((blocker & excl).sum()))


# -----------------------------------------------------------------------------
# Ingest-mode startup probe
# -----------------------------------------------------------------------------


def choose_ingest(t_raw_up_ms: float, t_pre_up_ms: float, t_bin_ms: float,
                  scatter_ms: float) -> str:
    """The decision rule behind ``frontend_mode="auto"`` (vofod_tpu
    ``choose_ingest``): per scan, raw = raw upload + the device histogram
    (K3), prebinned = packed upload + the host bin; the cheaper wins, raw on
    a tie."""
    raw_cost = t_raw_up_ms + scatter_ms
    pre_cost = t_pre_up_ms + t_bin_ms
    return "raw" if raw_cost <= pre_cost else "prebinned"


def _clock_ms(fn, device: torch.device) -> float:
    """Host milliseconds of fn() to completion on ``device``."""
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3


def _mean_ms(fn, device: torch.device, reps: int) -> float:
    """Mean milliseconds of ``reps`` warm calls of fn(), back to back as the
    step issues them: between two CUDA events on the card, on the host clock
    on the CPU."""
    fn()
    fn()  # warm
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


_K3_LAUNCHES = 10  # the probe's K3 time is the mean of this many warm launches


def probe_ingest_mode(cfg: VoFODConfig, lut: XyzLut, mask: np.ndarray | None, device,
                      rounds: int = 3, with_intensity: bool = True) -> tuple[str, dict]:
    """Measure this deployment once and pick the ingest: ``(mode, details)``,
    details holding every number measured.  Each side is priced as the node
    pays for it (runtime/node.py), best of ``rounds`` on fresh random scans:

    * the host bin of a scan (native, warm) into a staging set;
    * the raw upload: the float32 ranges, and the intensity when
      ``with_intensity`` (the node uploads one whenever the scan has it),
      copied into a staging set and sent with one non-blocking copy each
      (io/staging.py, as the node does);
    * the prebinned upload: the packed grid, the active mask and the stats
      pair from a staging set;
    * the device histogram the raw path pays and prebinned removes: K3 as
      the step pays it, the mean of ``_K3_LAUNCHES`` warm launches back to
      back between two CUDA events (the plain version's host time on the
      CPU).
    The pose upload is the same on both paths and left out."""
    from vofod_tpu_torch.geometry import GridSpec
    from vofod_tpu_torch.io.staging import HostStaging
    from vofod_tpu_torch.pipeline.frontend import frontend_bin

    device = torch.device(device)
    cuda = device.type == "cuda"
    n_pts = int(lut.height * lut.width)
    hb = HostBinner(cfg, lut, mask=mask)
    rng = np.random.default_rng(0)
    pose = np.eye(4, dtype=np.float32)
    raw_st = HostStaging(((n_pts, torch.float32), (n_pts, torch.float32)), device)
    pre_st = HostStaging(((hb.n_voxels, torch.uint8), (n_pts, torch.uint8), (2, torch.int32)),
                         device)
    inten = rng.random(n_pts).astype(np.float32)

    def raw_upload(r: np.ndarray):
        i, (r_buf, i_buf) = raw_st.next()
        np.copyto(r_buf, r, casting="unsafe")
        if not with_intensity:
            return raw_st.upload(i, 1)
        np.copyto(i_buf, inten)
        return raw_st.upload(i)

    t_bin = t_raw = t_pre = float("inf")
    for k in range(rounds + 1):  # round 0 warms the binner and the copies
        r = rng.integers(0, 20000, n_pts, dtype=np.uint32)
        i, out = pre_st.next()
        t0 = time.perf_counter()
        hb.bin(r, pose, out=out)
        t_bin_k = (time.perf_counter() - t0) * 1e3
        t_pre_k = _clock_ms(lambda: pre_st.upload(i), device)
        t_raw_k = _clock_ms(lambda: raw_upload(r), device)
        if k > 0:
            t_bin, t_raw, t_pre = min(t_bin, t_bin_k), min(t_raw, t_raw_k), min(t_pre, t_pre_k)
    grid = GridSpec.from_config(cfg)
    dirs = torch.as_tensor(lut.directions, device=device)
    offs = torch.as_tensor(lut.offsets, device=device)
    pose_dev = torch.as_tensor(pose, device=device)
    ranges_dev = torch.as_tensor(r.astype(np.float32), device=device)
    t_k3 = _mean_ms(lambda: frontend_bin(cfg, grid, dirs, offs, ranges_dev, pose_dev), device,
                    _K3_LAUNCHES)
    mode = choose_ingest(t_raw, t_pre, t_bin, t_k3)
    how = f"the mean of {_K3_LAUNCHES} warm launches back to back"
    return mode, {
        "t_raw_upload_ms": t_raw,
        "t_prebinned_upload_ms": t_pre,
        "t_host_bin_ms": t_bin,
        "scatter_ms": t_k3,
        "scatter_from": (f"K3 frontend_bin, {how} between two CUDA events" if cuda
                         else f"K3 plain version, {how} on the host clock"),
        "raw_bytes": n_pts * 4 * (2 if with_intensity else 1),
        "prebinned_bytes": hb.n_voxels + n_pts + 8,
        "device": str(device),
        "native_binner": hb.native,
    }

"""FleetVoFOD: multi-stream serving on one device.

PyTorch counterpart of vofod_tpu/runtime/fleet.py ``FleetVoFOD`` with
``grid_shards=1``.  N independent sensor streams, one detector state each
(parallel/sharding.py): every tick runs each stream's scan through the
single-stream step, in stream order, on one CUDA stream, so every kernel
of the path runs once per stream exactly as in a single-stream node.  The
tick is one host round trip: the stacked ranges (and intensity) go up
through two pinned staging sets taken in turn (io/staging.py), and all
streams' diagnostics and detections come back in ONE packed device-to-host
copy, the tick's only host sync.

This replaces the reference's N pointcloud_loop worker threads over one
shared map (vofod_nodelet.cpp:1324-1328): the reference parallelizes scans
of ONE sensor into one map, the fleet serves whole detectors.

A stream whose pose is not finite (lost TF) takes a NULL scan that tick,
as in the JAX fleet, where a stream cannot sit a lockstep step out: zero
ranges and a sentinel pose far outside the operation area, so its step
bins nothing and runs no raycast (the step's host in-limits test), and its
schedule counters advance as if the sensor had seen nothing.  The
single-stream node skips such a scan instead (runtime/node.py).

Not ported: ``grid_shards > 1`` (the 2-D streams x grid fleet), and the
multi-host runbook's ``initialize_multihost``, ``probe_transport_rtt`` and
``pick_stream_knee``, whose constants are a TPU relay's.  With one process
``local_streams`` is every stream.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.io.msgs import Detection, Detections, Header
from vofod_tpu_torch.io.staging import HostStaging
from vofod_tpu_torch.parallel.sharding import init_batched_state, make_batched_step
from vofod_tpu_torch.pipeline.state import Detections as DetTensors
from vofod_tpu_torch.pipeline.state import ScanInput, StepDiagnostics, init_state
from vofod_tpu_torch.runtime.node import _pack, _unpack, apriori_fids, resolve_device
from vofod_tpu_torch.sensor import make_lut

_DIAG = tuple(f.name for f in dataclasses.fields(StepDiagnostics))
_DETS = tuple(f.name for f in dataclasses.fields(DetTensors))


def _readback(buf: torch.Tensor) -> np.ndarray:
    """The tick's one device-to-host copy (and so its one host sync)."""
    return buf.cpu().numpy()


class FleetVoFOD:
    """Batch of detectors; call :meth:`process_scans` with per-stream scans."""

    def __init__(
        self,
        cfg: VoFODConfig | None = None,
        dyn: DynParams | None = None,
        n_streams: int | None = None,
        *,
        device="cuda",
        grid_shards: int = 1,
        **step_kw,
    ):
        """``step_kw``: ``make_step_fn``'s options for every stream
        (``raycast_mode``, ``raycast_every``, ``mask``, ``raycast_gate``);
        the fleet uploads raw scans, so ``frontend_mode`` stays "raw"."""
        if int(grid_shards) != 1:
            raise NotImplementedError(
                "grid_shards > 1 is the 2-D streams x grid fleet, not ported yet "
                "(ROADMAP.md queue 1 item 4)")
        if step_kw.get("frontend_mode", "raw") != "raw":
            raise ValueError("the fleet uploads raw scans: frontend_mode must be 'raw'")
        self.device = resolve_device(device)
        self.cfg = cfg or VoFODConfig()
        self.dyn = dyn or DynParams()
        self.grid_shards = 1
        self.n_streams = int(n_streams or 1)
        self.grid_spec = GridSpec.from_config(self.cfg)
        self.lut = make_lut(self.cfg.sensor)
        self._step = make_batched_step(self.cfg, self.lut, device=self.device, **step_kw)
        self.state = init_batched_state(self.cfg, self.dyn, self.n_streams, device=self.device)
        n = self.n_streams * self.cfg.sensor.n_points
        self._staging = HostStaging(((n, torch.float32), (n, torch.float32)), self.device)
        self.last_diag = None
        # per-stream count of scans consumed as null scans for a non-finite
        # pose (lost TF — see _sanitize_rows)
        self.n_pose_rejected = np.zeros(self.n_streams, np.int64)
        self._log = logging.getLogger("vofod_tpu_torch.fleet")
        # throttle clock for pose-rejection warnings (ref throttles this
        # exact message: NODELET_ERROR_THROTTLE(1.0), vofod_nodelet.cpp:919)
        self._last_pose_warn = 0.0
        self.pose_warn_period = 1.0
        self._ones_dev = None  # cached all-ones [B, H*W] intensity

    def _sanitize_rows(self, r: np.ndarray, p: np.ndarray, global_ids) -> np.ndarray:
        """Non-finite pose (lost TF) -> NULL scan for that stream: zero
        returns (the frontend bins nothing, the point EMA is fully masked)
        and a sentinel pose far outside the operation area (the step's
        host in-limits test skips its raycast).  Its counters advance, as
        in the JAX fleet.  Zeroes the rejected rows of the staged ranges
        ``r`` in place; returns the poses to step with."""
        bad = ~np.isfinite(p.reshape(p.shape[0], -1)).all(axis=1)
        if bad.any():
            p = p.copy()
            sentinel = np.eye(4, dtype=np.float32)
            sentinel[:3, 3] = np.asarray(self.cfg.oparea.lo, np.float32) - 1.0e6
            r[bad] = 0.0
            p[bad] = sentinel
            bad_streams = []
            for li in np.nonzero(bad)[0]:
                g = global_ids[li]
                self.n_pose_rejected[g] += 1
                bad_streams.append(int(g))
            # one throttled line for ALL rejected streams this tick: a fleet
            # TF outage at sensor rate x N streams must not flood the log
            now = time.time()
            if now - self._last_pose_warn >= self.pose_warn_period:
                self._last_pose_warn = now
                self._log.warning(
                    "streams %s: non-finite pose — null scan (%d rejected total)",
                    bad_streams, int(self.n_pose_rejected.sum()),
                )
        return p

    @property
    def local_streams(self) -> list[int]:
        """Stream indices served by this process: every stream (one process)."""
        return list(range(self.n_streams))

    def process_local_scans(self, ranges_mm: np.ndarray, poses: np.ndarray, stamp: float = 0.0,
                            intensity: np.ndarray | None = None) -> dict[int, Detections]:
        """The multi-host entry point's form: this process's streams, in
        :attr:`local_streams` order; returns ``{stream id: Detections}``."""
        return dict(enumerate(self.process_scans(ranges_mm, poses, stamp, intensity)))

    def process_scans(self, ranges_mm: np.ndarray, poses: np.ndarray, stamp: float = 0.0,
                      intensity: np.ndarray | None = None) -> list[Detections]:
        """ranges_mm: [B, H*W]; poses: [B, 4, 4]; intensity: optional
        [B, H*W] (None: all-ones, as the single-stream node; the
        ``raycast/min_intensity`` gate, vofod_nodelet.cpp:1449, is live
        either way).  Returns one Detections message per stream."""
        B, n = self.n_streams, self.cfg.sensor.n_points
        r = np.asarray(ranges_mm).reshape(B, -1)
        if r.shape[1] != n:
            raise ValueError(f"unexpected scan size {r.shape[1]}, expected {n} "
                             f"({self.cfg.sensor.vertical_rays}x"
                             f"{self.cfg.sensor.horizontal_rays})")
        p = np.asarray(poses, np.float32).reshape(B, 4, 4)
        scans = self._upload(r, p, intensity)
        self.state, outs = self._step(self.state, scans, self.dyn)
        arrs = self._fetch(outs)
        return [_row_to_msg(arrs, b, b, stamp) for b in range(B)]

    def _upload(self, r: np.ndarray, p: np.ndarray, intensity) -> ScanInput:
        """Stage the stacked ranges (as float32, the rejected streams'
        zeroed) and intensity, and upload them: one non-blocking copy a
        buffer."""
        B, n = self.n_streams, self.cfg.sensor.n_points
        i, (r_buf, i_buf) = self._staging.next()
        staged = r_buf.reshape(B, n)
        np.copyto(staged, r, casting="unsafe")  # as r.astype(np.float32)
        p = self._sanitize_rows(staged, p, range(B))
        if intensity is None:
            (ranges,) = self._staging.upload(i, 1)
            if self._ones_dev is None:
                # reused every intensity-less tick: the step never writes
                # its scan arguments
                self._ones_dev = torch.ones((B, n), dtype=torch.float32, device=self.device)
            inten = self._ones_dev
        else:
            np.copyto(i_buf, np.asarray(intensity).reshape(-1), casting="unsafe")
            ranges, inten = self._staging.upload(i)
            inten = inten.view(B, n)
        return ScanInput(ranges_mm=ranges.view(B, n), intensity=inten, pose=p)

    def _fetch(self, outs) -> dict[str, np.ndarray]:
        """Every stream's diagnostics and detections in one packed readback:
        ``last_diag`` gets ``[B]`` arrays; returns the detections' ``[B, K,
        ...]`` arrays by field."""
        B = self.n_streams
        tensors = ([getattr(o.diag, f) for f in _DIAG for o in outs]
                   + [getattr(o.detections, f) for f in _DETS for o in outs])
        buf, layout = _pack(tensors)
        host = _unpack(_readback(buf), layout)
        by_field = {f: np.stack(host[k * B:(k + 1) * B]) for k, f in enumerate(_DIAG + _DETS)}
        self.last_diag = StepDiagnostics(**{f: by_field[f] for f in _DIAG})
        return {f: by_field[f] for f in _DETS}

    def load_apriori_map(self, points_xyz: np.ndarray, stream: int | None = None) -> int:
        """Stamp an apriori cloud into one stream's map (or every stream's)
        as +inf background, placed as the single-stream node places it
        (config ``apriori_map/tf`` + ``sim_correction``, ref
        vofod_nodelet.cpp:224-225).  Returns the number of stamped points."""
        fids = apriori_fids(self.cfg, self.grid_spec, points_xyz)
        if fids.size:
            ids = torch.as_tensor(fids, device=self.device)
            for b in self._chosen(stream):
                self.state[b].grid.view(-1).index_fill_(0, ids, float("inf"))
        return int(fids.size)

    def reset_stream(self, stream: int | None = None) -> None:
        """The reference's ``~reset`` service (vofod_nodelet.cpp:1610-1632)
        lifted to the fleet: one stream's detector state (or every stream's
        with ``stream=None``) back to cold start, bit-equal to
        ``init_state``, while the rest of the fleet keeps flying.  Its step
        counter restarts at 0, so its raycast / sepclusters schedule runs
        offset from the other streams'.  As in the reference, the apriori
        map is separate: re-stamp it with ``load_apriori_map(pts,
        stream=...)``."""
        for b in self._chosen(stream):
            self.state[b] = init_state(self.cfg, self.dyn, device=self.device)

    def _chosen(self, stream: int | None) -> range | list[int]:
        if stream is None:
            return range(self.n_streams)
        if not 0 <= stream < self.n_streams:
            raise IndexError(f"stream {stream} of a fleet of {self.n_streams}")
        return [stream]


def _row_to_msg(arrs: dict[str, np.ndarray], row: int, stream: int, stamp: float) -> Detections:
    """Detections message for one stream's row of the tick's outputs."""
    msg = Detections(header=Header(stamp, f"stream{stream}"))
    for k in range(arrs["valid"].shape[1]):
        if not arrs["valid"][row, k]:
            continue
        msg.detections.append(
            Detection(
                id=int(arrs["id"][row, k]),
                confidence=float(arrs["confidence"][row, k]),
                n_points=int(arrs["n_points"][row, k]),
                position=tuple(float(v) for v in arrs["position"][row, k]),
                covariance=tuple(float(v) for v in arrs["covariance"][row, k].reshape(-1)),
                detection_probability=float(arrs["detection_probability"][row, k]),
            )
        )
    return msg

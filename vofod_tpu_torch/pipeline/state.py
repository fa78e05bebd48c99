"""Device-resident detector state and the step's inputs and outputs.

PyTorch counterpart of vofod_tpu/pipeline/state.py: dataclasses of tensors
in place of the JAX NamedTuples, with the same field names.  One difference:
``VoFODState.step`` is a host int.  The schedule predicates of the step
(raycast / sepclusters every N scans) read it without a device sync; the JAX
state keeps it on the device and the JAX node mirrors it on the host.

:func:`state_from_numpy` / :func:`state_to_numpy` carry a state between the
two packages (each field as a numpy array) — for a system with no weights,
the map IS the carried-over model.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Mapping

import numpy as np
import torch

from vofod_tpu_torch.config import DynParams, VoFODConfig

Tensor = torch.Tensor


@dataclass
class VoFODState:
    grid: Tensor  # float32 (nz, ny, nx) — occupancy-confidence scores
    safe: Tensor  # bool (nz, ny, nx) — warm start for sepclusters reachability
    det_counter: Tensor  # int32 — monotonic detection id (ref :845)
    step: int  # scan counter on the host (drives periodic maintenance)
    sure_bg_sufficient: Tensor  # bool (ref m_sure_background_sufficient)
    bg_sufficient: Tensor  # bool (ref m_background_pts_sufficient)


def init_state(cfg: VoFODConfig, dyn: DynParams | None = None, *, device) -> VoFODState:
    """Fresh state — the ~reset service (ref reset(), vofod_nodelet.cpp:1610-1632):
    every voxel starts at scores/init."""
    dyn = dyn or DynParams()
    shape = cfg.grid_shape
    return VoFODState(
        grid=torch.full(shape, float(dyn.score_init), dtype=torch.float32, device=device),
        safe=torch.zeros(shape, dtype=torch.bool, device=device),
        det_counter=torch.zeros((), dtype=torch.int32, device=device),
        step=0,
        sure_bg_sufficient=torch.zeros((), dtype=torch.bool, device=device),
        bg_sufficient=torch.zeros((), dtype=torch.bool, device=device),
    )


def state_from_numpy(arrays: Mapping[str, np.ndarray], device) -> VoFODState:
    """A state from numpy arrays keyed by field name — e.g. a JAX state's
    ``jax.device_get(state)._asdict()`` or a snapshot NPZ."""
    return VoFODState(
        grid=torch.as_tensor(np.asarray(arrays["grid"], np.float32), device=device),
        safe=torch.as_tensor(np.asarray(arrays["safe"], np.bool_), device=device),
        det_counter=torch.as_tensor(np.asarray(arrays["det_counter"], np.int32), device=device),
        step=int(arrays["step"]),
        sure_bg_sufficient=torch.as_tensor(
            np.asarray(arrays["sure_bg_sufficient"], np.bool_), device=device
        ),
        bg_sufficient=torch.as_tensor(np.asarray(arrays["bg_sufficient"], np.bool_), device=device),
    )


def state_to_numpy(state: VoFODState) -> dict[str, np.ndarray]:
    """Every field as a numpy array (the JAX state's dtypes)."""
    out = {}
    for f in fields(state):
        v = getattr(state, f.name)
        out[f.name] = np.int32(v) if f.name == "step" else v.detach().cpu().numpy()
    return out


@dataclass
class ScanInput:
    """One organized LiDAR scan + pose (the reference's pc_t message + TF
    lookup, vofod_nodelet.cpp:882-928).  The pose stays on the host: the
    step reads its translation for the schedule and uploads it once."""

    ranges_mm: Tensor  # float32 [H*W] on the step's device (0 = no return)
    intensity: Tensor  # float32 [H*W]
    pose: np.ndarray  # float32 [4, 4] — world_T_sensor


@dataclass
class PrebinnedScan:
    """A host-binned scan for the prebinned ingest (io/binner.py +
    native/frontend.cpp; ``make_step_fn(frontend_mode="prebinned")``): the
    host filtered, transformed and histogrammed the scan, so the device
    frontend is the elementwise unpack K15a.  The pose stays on the host, as
    in :class:`ScanInput`."""

    packed: Tensor  # uint8 (nz, ny, nx): count & 0x3f | blocker << 7
    active: Tensor  # uint8 [H*W] per-pixel raycast gate
    pose: np.ndarray  # float32 [4, 4] — world_T_sensor
    stats: Tensor  # int32 [2]: (n_valid_points, n_exclude_hits), host-counted


@dataclass
class Detections:
    """Fixed-capacity detections output (msgs/Detection.msg fields)."""

    valid: Tensor  # bool [K]
    id: Tensor  # int32 [K]
    position: Tensor  # float32 [K, 3] — OBB center, world frame
    covariance: Tensor  # float32 [K, 3, 3]
    n_points: Tensor  # int32 [K]
    confidence: Tensor  # float32 [K]
    detection_probability: Tensor  # float32 [K]
    aabb_min: Tensor  # float32 [K, 3]
    aabb_max: Tensor  # float32 [K, 3]
    cluster_class: Tensor  # int32 [K]: 0=invalid, 1=mav, 2=unknown
    obb_center: Tensor  # float32 [K, 3]
    obb_extent: Tensor  # float32 [K, 3]
    obb_axes: Tensor  # float32 [K, 3, 3]


@dataclass
class StepDiagnostics:
    """Observability signals (ref Status.msg + throttled logs)."""

    n_bg_voxels: Tensor  # int32 — voxels over new_obstacles (ref :713)
    bg_sufficient: Tensor  # bool
    sure_bg_sufficient: Tensor  # bool
    n_occupied: Tensor  # int32 — occupied voxels this scan
    n_far: Tensor  # int32 — far (non-background) voxels this scan
    far_overflow: Tensor  # bool — far voxels exceeded static capacity
    cc_converged: Tensor  # bool — clustering fixpoint reached within cap
    cc_iters: Tensor  # int32 — label-propagation sweeps this scan
    sep_converged: Tensor  # bool — sepclusters reachability converged
    n_detections: Tensor  # int32
    # port-only counters (the JAX diagnostics have no such fields)
    n_queries: Tensor  # int32 — explore queries (gated far voxels) this scan
    n_demoted: Tensor  # int32 — demotion writes this scan (overlaps count twice)
    sep_sweeps: Tensor  # int32 — exact census: component sweeps run this scan (else 0)

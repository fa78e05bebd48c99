"""Stream data-parallelism on one device: one detector state per sensor stream.

PyTorch counterpart of vofod_tpu/parallel/sharding.py ``init_batched_state``
and ``make_batched_step``.  The JAX batched step shards the streams over a
mesh and, inside each shard, runs the UNBATCHED step once per local stream
in order (``lax.scan``), so every stream's program is the single-stream hot
path.  Here there is one device: the batched step runs the single-stream
``make_step_fn`` once per stream, in order, on the caller's current CUDA
stream.  Every kernel therefore runs exactly as in a single-stream node,
and the kernels' per-(device, CUDA stream) state (K6's look-back buffers,
K7s's ticket and scratch) is used by one step at a time.

The batched state is a list of per-stream :class:`VoFODState`, not views
into stacked tensors: the step rebinds the state's fields
(pipeline/step.py), so a view would silently stop being the state.
:func:`batched_state_to_numpy` / :func:`batched_state_from_numpy` carry it
to and from JAX's batched layout (every field ``[B, ...]``, ``step`` as
``[B]``): for a system with no weights, the maps ARE the carried-over model.

The mesh and the grid-sharded halo pools of the JAX module are not ported
(the grid-sharded step is parallel/grid_step.py).
"""

from __future__ import annotations

from dataclasses import fields
from typing import Callable, Mapping

import numpy as np

from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.pipeline.state import (
    ScanInput, VoFODState, init_state, state_from_numpy, state_to_numpy)
from vofod_tpu_torch.pipeline.step import StepOutput, make_step_fn
from vofod_tpu_torch.sensor import XyzLut


def init_batched_state(cfg: VoFODConfig, dyn: DynParams, batch: int, *,
                       device="cuda") -> list[VoFODState]:
    """One fresh detector state per stream (each equal to ``init_state``)."""
    return [init_state(cfg, dyn, device=device) for _ in range(batch)]


def make_batched_step(
    cfg: VoFODConfig, lut: XyzLut, *, device="cuda", **step_kw,
) -> Callable[..., tuple[list[VoFODState], list[StepOutput]]]:
    """The streams' step: ``step(states, scans, dyn) -> (states, outs)``.

    ``scans`` is a :class:`ScanInput` of stacked streams (ranges and
    intensity ``[B, H*W]`` on the device, pose a host ``[B, 4, 4]``);
    stream b's row goes through the single-stream step with ``states[b]``.
    ``outs[b]`` is that step's output.  ``step_kw`` are ``make_step_fn``'s
    options, the same for every stream.
    """
    step = make_step_fn(cfg, lut, device=device, **step_kw)

    def batched(states: list[VoFODState], scans: ScanInput, dyn: DynParams):
        b = scans.ranges_mm.shape[0]
        if len(states) != b or scans.intensity.shape[0] != b or len(scans.pose) != b:
            raise ValueError(f"{len(states)} stream states for a batch of {b} scans")
        new_states, outs = [], []
        for st, r, i, p in zip(states, scans.ranges_mm, scans.intensity, scans.pose):
            st, out = step(st, ScanInput(ranges_mm=r, intensity=i, pose=p), dyn)
            new_states.append(st)
            outs.append(out)
        return new_states, outs

    return batched


def batched_state_to_numpy(states: list[VoFODState]) -> dict[str, np.ndarray]:
    """Every field stacked over the streams as a numpy array, in the JAX
    batched state's layout and dtypes (``step`` int32 ``[B]``)."""
    per = [state_to_numpy(s) for s in states]
    return {f.name: np.stack([p[f.name] for p in per]) for f in fields(VoFODState)}


def batched_state_from_numpy(arrays: Mapping[str, np.ndarray], device) -> list[VoFODState]:
    """Per-stream states from batched numpy arrays keyed by field name —
    e.g. a JAX fleet's ``jax.device_get(fleet.state)._asdict()``."""
    b = np.asarray(arrays["step"]).reshape(-1).shape[0]
    return [state_from_numpy({k: np.asarray(v)[i] for k, v in arrays.items()}, device)
            for i in range(b)]

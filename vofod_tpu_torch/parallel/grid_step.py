"""Grid-sharded step: one operation area over n shards of one process.

PyTorch counterpart of vofod_tpu/parallel/grid_step.py
``make_grid_sharded_step``: every mode of the JAX 1-D grid step — the
production sweep path (the gated sweep raycast, its z cones pipelined or
transposed, default sepclusters), the reference-exact path (the exact DDA
raycast, the exact census with the counted indexing, the hasCloseTo box),
the prebinned ingest, live-tunable radii and the sequential explore.  The
confidence grid and the sepclusters warm-start mask shard along z, the
leading axis; the step of pipeline/step.py runs unchanged on every shard
with parallel/gridops.ZShardOps as its grid provider, each shard in a
thread of a parallel/comm.LocalComm with its own CUDA stream.  The state's
dense grids are per-shard slabs, its scalars are replicated, and the
step's outputs are replicated: shard 0's are returned.  A prebinned scan's
packed grid shards with the state: each shard uploads only its z slab.

:func:`shard_state` / :func:`gather_state` carry a dense state (e.g.
pipeline/state.state_from_numpy of a JAX state's arrays) into the shards
and back; ``gather_state`` is the port's counterpart of ``np.asarray`` on
a sharded JAX array.

Every output equals the dense step's bit for bit (tests/
test_torch_grid_step.py, tests/test_torch_grid_exact.py, tests/
test_torch_grid_modes.py, chip_smoke.py phases 4-grid*).  JAX's sharded
step pools the hasCloseTo box on the bare slab; this one takes its halo,
so it is held to the dense step.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.parallel.gridops import ZShardOps
from vofod_tpu_torch.pipeline.state import PrebinnedScan, VoFODState, init_state
from vofod_tpu_torch.pipeline.step import make_step_fn
from vofod_tpu_torch.sensor import XyzLut


def _validate_grid_sharding(cfg: VoFODConfig, n: int) -> None:
    """vofod_tpu grid_step._validate_grid_sharding."""
    nz, ny, nx = cfg.grid_shape
    if nz % n:
        raise ValueError(f"grid nz={nz} not divisible by {n} shards; pad the operation-area "
                         "height")
    if nz // n < 2:
        raise ValueError(f"shard height {nz // n} < 2 planes (nz={nz}, n={n})")
    if nz * ny * nx > 2**30:
        # label_seeded keys use flat_id + (1 - seed) * n_voxels in int32
        raise ValueError(f"n_voxels={nz * ny * nx} exceeds the int32 id/key ceiling of 2^30; "
                         "shrink the oparea or coarsen the voxel size")
    if cfg.sepclusters_exact_census:
        # the coarse pooling is shard-local: the leaf must tile each slab
        mv = math.ceil(cfg.sepclusters_max_bg_distance / cfg.voxel_size)
        lsz = max(mv - 1, 1)
        if (nz // n) % lsz:
            raise ValueError(f"exact-census coarse leaf {lsz} must divide the shard height "
                             f"{nz // n} (pad the operation-area height)")


def _shard(t: torch.Tensor, i: int, n: int, dev) -> torch.Tensor:
    nzl = t.shape[0] // n
    return t[i * nzl:(i + 1) * nzl].to(dev, copy=True)


def shard_state(state: VoFODState, comm) -> list[VoFODState]:
    """The dense ``state`` as one state per shard of ``comm``: the z slabs of
    grid and safe, copies of the scalars, on each shard's device."""
    n = comm.n
    if state.grid.shape[0] % n:
        raise ValueError(f"grid nz={state.grid.shape[0]} not divisible by {n} shards")
    return [
        VoFODState(
            grid=_shard(state.grid, i, n, dev),
            safe=_shard(state.safe, i, n, dev),
            det_counter=state.det_counter.to(dev, copy=True),
            step=state.step,
            sure_bg_sufficient=state.sure_bg_sufficient.to(dev, copy=True),
            bg_sufficient=state.bg_sufficient.to(dev, copy=True),
        )
        for i, dev in enumerate(comm.devices)
    ]


def gather_state(states: list[VoFODState]) -> VoFODState:
    """The inverse of :func:`shard_state`: one dense state on shard 0's
    device (the slabs concatenated, shard 0's scalars)."""
    s0 = states[0]
    dev = s0.grid.device
    return dataclasses.replace(
        s0,
        grid=torch.cat([s.grid.to(dev) for s in states]),
        safe=torch.cat([s.safe.to(dev) for s in states]),
    )


def init_grid_sharded_state(cfg: VoFODConfig, dyn: DynParams, comm) -> list[VoFODState]:
    """Fresh state (pipeline/state.init_state) with the dense grids sharded
    over ``comm``'s shards."""
    return shard_state(init_state(cfg, dyn, device=comm.devices[0]), comm)


def _scan_on(scan, dev):
    """The scan's tensors on ``dev`` (the same objects when already there)."""
    return dataclasses.replace(scan, **{
        f.name: getattr(scan, f.name).to(dev) for f in dataclasses.fields(scan)
        if isinstance(getattr(scan, f.name), torch.Tensor)})


def _slab_on(scan: PrebinnedScan, z0: int, nzl: int, dev):
    """A shard's part of a host-binned scan: its z slab of ``packed`` (z is
    the leading axis, so the slab is contiguous), ``active`` and ``stats``,
    each copied once to ``dev`` on the current (the shard's) stream,
    non-blocking from pinned memory.  Returns (the shard's scan, the CUDA
    event of the copies, None on the CPU)."""
    up = lambda t: t.to(dev, non_blocking=True, copy=True)  # noqa: E731
    out = dataclasses.replace(scan, packed=up(scan.packed[z0:z0 + nzl]), active=up(scan.active),
                              stats=up(scan.stats))
    ev = None
    if dev.type == "cuda":
        ev = torch.cuda.Event()
        ev.record()
    return out, ev


def make_grid_sharded_step(cfg: VoFODConfig, lut: XyzLut, comm, *,
                           zcone_mode: str = "pipelined", **step_kw):
    """The grid-sharded step over ``comm`` (a parallel/comm.LocalComm):
    ``step(states, scan, dyn, upload_events=None) -> (states, StepOutput)``,
    with ``states`` one VoFODState per shard (:func:`shard_state`,
    :func:`init_grid_sharded_state`).  ``step_kw``: the make_step_fn options
    (raycast_mode "sweep", "exact" or "off", raycast_every, mask,
    raycast_gate, frontend_mode "raw" or "prebinned"); ``zcone_mode``:
    "pipelined" or "transpose" (K15b-4b).  The config may set every mode the
    dense step takes (the exact census, the counted indexing, the hasCloseTo
    box, dynamic radii, the sequential explore), combined as it allows.

    The raw scan (a ScanInput) is replicated.  A prebinned scan (a
    PrebinnedScan, ``frontend_mode="prebinned"``) holds the whole packed
    grid in host memory (pinned, for the card: io/staging.py): each shard
    uploads only its z slab, so no device holds the whole grid.  Pass a list
    as ``upload_events`` to get one CUDA event per shard of those copies:
    the host buffer may be refilled once all have completed
    (io/staging.HostStaging.guard).

    Requires nz divisible by the shards, a shard height of at least 2
    planes (the sweep's lateral halo taps) and, with the exact census,
    divisible by its coarse leaf."""
    _validate_grid_sharding(cfg, comm.n)
    ops = ZShardOps(comm, comm.n, zcone_mode=zcone_mode)
    steps = {dev: make_step_fn(cfg, lut, device=dev, ops=ops, **step_kw)
             for dev in set(comm.devices)}
    prebinned = step_kw.get("frontend_mode") == "prebinned"
    nzl = cfg.grid_shape[0] // comm.n

    def step(states: list[VoFODState], scan, dyn: DynParams, upload_events: list | None = None):
        if len(states) != comm.n:
            raise ValueError(f"{len(states)} shard states for {comm.n} shards")
        events = [None] * comm.n

        def shard(rank: int):
            dev = comm.devices[rank]
            if prebinned:
                s, events[rank] = _slab_on(scan, rank * nzl, nzl, dev)
            else:
                s = _scan_on(scan, dev)
            return steps[dev](states[rank], s, dyn)

        out = comm.run(shard)
        if upload_events is not None:
            upload_events.extend(e for e in events if e is not None)
        return [s for s, _ in out], out[0][1]

    return step

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
thread of a parallel/comm.LocalComm with its own CUDA stream, or in a
process of its own over a parallel/comm.ProcessComm (one shard a process,
the collectives over torch.distributed).  The state's dense grids are
per-shard slabs, its scalars are replicated, and the step's outputs are
replicated (every shard's equals shard 0's: the detections and scalars
come from psum'd / pmax'd values and the replicated point-space work), as
JAX's ``out_specs=P()``: the first shard this process drives returns them.
A comm's ``shards`` are the shards the calling process drives (all of them
on a LocalComm, its own on a ProcessComm); every list of per-shard states
below holds those shards' slabs, and a process builds and holds only
those.  A prebinned scan's packed grid shards with the state: each shard
uploads only its z slab.

:func:`shard_state` / :func:`gather_state` carry a dense state (e.g.
pipeline/state.state_from_numpy of a JAX state's arrays) into the shards
and back; ``gather_state`` is the port's counterpart of ``np.asarray`` on
a sharded JAX array (over a ProcessComm an all-gather of the slabs, which
every process of the group calls).

Every output equals the dense step's bit for bit (tests/
test_torch_grid_step.py, tests/test_torch_grid_exact.py, tests/
test_torch_grid_modes.py, chip_smoke.py phases 4-grid*).  JAX's sharded
step pools the hasCloseTo box on the bare slab; this one takes its halo,
so it is held to the dense step.

The 2-D fleet — N sensor streams, each stream's grid z-sharded — is
:func:`make_fleet_grid_step` (vofod_tpu grid_step ``make_fleet_grid_step``):
one ``comm.run`` a tick in which each shard steps its slab of every stream
in stream order, the counterpart of the JAX ``lax.scan`` over the streams
inside the 2-D ``shard_map``.  The port's step never branches on device
data, so every shard issues the same collectives in the same order for
every stream, a null-scan stream's skipped raycast included, and the JAX
step's lockstep reductions over the data axis have no counterpart here.
``make_fleet_grid_mesh`` has no function of its own: its "axes >= 1" rule
is the comm's ``n >= 1``, and its "enough devices" rule is that the
process count divides ``n_streams`` (runtime/fleet.py: each process holds
one block of streams, its grid shards on its own ``LocalComm``, or one
grid shard of its stream group's ``ProcessComm``).
:func:`fleet_grid_state_to_numpy` / :func:`fleet_grid_state_from_numpy`
carry the 2-D state to and from JAX's layout (every grid field ``[B, nz,
ny, nx]``, ``step`` ``[B]``, the scalars per stream).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np
import torch

from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.parallel.gridops import ZShardOps
from vofod_tpu_torch.pipeline.state import (
    PrebinnedScan, ScanInput, VoFODState, init_state, state_from_numpy, state_to_numpy)
from vofod_tpu_torch.pipeline.step import make_step_fn
from vofod_tpu_torch.sensor import XyzLut


def validate_grid_sharding(cfg: VoFODConfig, n: int) -> None:
    """vofod_tpu grid_step._validate_grid_sharding: raises ValueError unless
    ``cfg``'s grid splits into ``n`` z shards."""
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


def spans_processes(comm) -> bool:
    """Whether ``comm``'s shards lie in other processes too (a ProcessComm)."""
    return len(comm.shards) < comm.n


def shard_state(state: VoFODState, comm) -> list[VoFODState]:
    """The dense ``state`` as one state per shard this process drives
    (``comm.shards``): the z slabs of grid and safe, copies of the scalars,
    on each shard's device."""
    n = comm.n
    if state.grid.shape[0] % n:
        raise ValueError(f"grid nz={state.grid.shape[0]} not divisible by {n} shards")
    return [
        VoFODState(
            grid=_shard(state.grid, i, n, comm.devices[i]),
            safe=_shard(state.safe, i, n, comm.devices[i]),
            det_counter=state.det_counter.to(comm.devices[i], copy=True),
            step=state.step,
            sure_bg_sufficient=state.sure_bg_sufficient.to(comm.devices[i], copy=True),
            bg_sufficient=state.bg_sufficient.to(comm.devices[i], copy=True),
        )
        for i in comm.shards
    ]


def gather_state(states: list[VoFODState], comm=None) -> VoFODState:
    """The inverse of :func:`shard_state`: one dense state on the first
    slab's device (the slabs concatenated, the first slab's scalars).  The
    slabs of every shard: a list of them all, or, with a ``comm`` that
    spans processes, this process's slab, the others' gathered over the
    group (a collective: every process of the group calls it, and each
    gets the whole state)."""
    s0 = states[0]
    if comm is not None and spans_processes(comm):
        grid, safe = comm.run(lambda rank: (comm.all_gather(s0.grid), comm.all_gather(s0.safe)))[0]
        return dataclasses.replace(s0, grid=grid.flatten(0, 1), safe=safe.flatten(0, 1))
    dev = s0.grid.device
    return dataclasses.replace(
        s0,
        grid=torch.cat([s.grid.to(dev) for s in states]),
        safe=torch.cat([s.safe.to(dev) for s in states]),
    )


def init_grid_sharded_state(cfg: VoFODConfig, dyn: DynParams, comm) -> list[VoFODState]:
    """Fresh state (pipeline/state.init_state) as the z slabs of the shards
    this process drives, each built on its shard's device alone: no device
    holds the whole grid."""
    nz, ny, nx = cfg.grid_shape
    if nz % comm.n:
        raise ValueError(f"grid nz={nz} not divisible by {comm.n} shards")
    return [init_state(cfg, dyn, device=comm.devices[i], shape=(nz // comm.n, ny, nx))
            for i in comm.shards]


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
    """The grid-sharded step over ``comm`` (a parallel/comm.LocalComm, or a
    ProcessComm: one shard a process): ``step(states, scan, dyn,
    upload_events=None) -> (states, StepOutput)``, with ``states`` one
    VoFODState per shard this process drives (:func:`shard_state`,
    :func:`init_grid_sharded_state`); every process of a ProcessComm calls
    it with the same scan.  ``step_kw``: the make_step_fn options
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
    step_shard = _shard_step(cfg, lut, comm, zcone_mode, step_kw)

    def step(states: list[VoFODState], scan, dyn: DynParams, upload_events: list | None = None):
        if len(states) != len(comm.shards):
            raise ValueError(f"{len(states)} shard states for {len(comm.shards)} shards")
        local = dict(zip(comm.shards, states))
        out = comm.run(lambda rank: step_shard(rank, local[rank], scan, dyn))
        if upload_events is not None:
            upload_events.extend(ev for _, _, ev in out if ev is not None)
        return [s for s, _, _ in out], out[0][1]

    return step


def _shard_step(cfg: VoFODConfig, lut: XyzLut, comm, zcone_mode: str, step_kw: dict):
    """The per-shard body of the grid-sharded steps: ``body(rank, state,
    scan, dyn) -> (state, StepOutput, upload event or None)`` runs the step
    on shard ``rank``'s slab inside ``comm.run``; a raw scan is put on the
    shard's device, a prebinned one cut to the shard's z slab
    (:func:`_slab_on`)."""
    validate_grid_sharding(cfg, comm.n)
    ops = ZShardOps(comm, comm.n, zcone_mode=zcone_mode)
    steps = {dev: make_step_fn(cfg, lut, device=dev, ops=ops, **step_kw)
             for dev in {comm.devices[r] for r in comm.shards}}
    prebinned = step_kw.get("frontend_mode") == "prebinned"
    nzl = cfg.grid_shape[0] // comm.n

    def body(rank: int, state: VoFODState, scan, dyn: DynParams):
        dev = comm.devices[rank]
        ev = None
        if prebinned:
            scan, ev = _slab_on(scan, rank * nzl, nzl, dev)
        else:
            scan = _scan_on(scan, dev)
        state, out = steps[dev](state, scan, dyn)
        return state, out, ev

    return body


# =============================================================================
# 2-D: stream data-parallelism x grid sharding
# =============================================================================


def init_fleet_grid_state(cfg: VoFODConfig, dyn: DynParams, batch: int,
                          comm) -> list[list[VoFODState]]:
    """``batch`` fresh detector states, each one list of the slabs of the
    shards this process drives (:func:`init_grid_sharded_state`)."""
    return [init_grid_sharded_state(cfg, dyn, comm) for _ in range(batch)]


def make_fleet_grid_step(cfg: VoFODConfig, lut: XyzLut, comm, *,
                         zcone_mode: str = "pipelined", **step_kw):
    """Both scaling axes in one step: ``step(states, scans, dyn,
    upload_events=None) -> (states, outs)`` with ``states`` one list of
    per-shard slabs a stream, the shards this process drives
    (:func:`init_fleet_grid_state`), and ``outs[b]`` stream b's StepOutput
    (replicated).  One ``comm.run`` a tick: each shard steps its slab of
    every stream, in stream order, with the body of
    :func:`make_grid_sharded_step`, so each stream's result is the 1-D grid
    step's bit for bit; over a ProcessComm every process of the group
    steps the same streams' scans.

    ``scans``: a ScanInput of stacked streams (ranges and intensity ``[B,
    H*W]``, pose a host ``[B, 4, 4]``), replicated to every shard; or, with
    ``frontend_mode="prebinned"``, one PrebinnedScan a stream, each shard
    uploading only its z slab of every stream's packed grid (its copy
    events go to ``upload_events``).  ``step_kw`` and ``zcone_mode``: as
    :func:`make_grid_sharded_step`.  ``sequential_explore`` is refused, as
    in JAX."""
    if cfg.sequential_explore:
        raise ValueError(
            "sequential_explore (the demotion-coupling parity instrument) does not compose "
            "with the 2-D streams x grid fleet, as in vofod_tpu's make_fleet_grid_step: run "
            "parity studies on the 1-D grid-sharded step instead")
    step_shard = _shard_step(cfg, lut, comm, zcone_mode, step_kw)
    prebinned = step_kw.get("frontend_mode") == "prebinned"

    def step(states: list[list[VoFODState]], scans, dyn: DynParams,
             upload_events: list | None = None):
        b = len(states)
        if any(len(s) != len(comm.shards) for s in states):
            raise ValueError(f"every stream needs {len(comm.shards)} shard states, got "
                             f"{[len(s) for s in states]}")
        if prebinned:
            per_stream = list(scans)
            if len(per_stream) != b:
                raise ValueError(f"{b} stream states for a batch of {len(per_stream)} scans")
        else:
            if (scans.ranges_mm.shape[0] != b or scans.intensity.shape[0] != b
                    or len(scans.pose) != b):
                raise ValueError(f"{b} stream states for a batch of "
                                 f"{scans.ranges_mm.shape[0]} scans")
            per_stream = [ScanInput(ranges_mm=r, intensity=i, pose=p)
                          for r, i, p in zip(scans.ranges_mm, scans.intensity, scans.pose)]

        def shard(rank: int):
            k = comm.shards.index(rank)
            got = [step_shard(rank, states[s][k], per_stream[s], dyn) for s in range(b)]
            return ([g[0] for g in got], [g[1] for g in got],
                    [g[2] for g in got if g[2] is not None])

        res = comm.run(shard)
        if upload_events is not None:
            upload_events.extend(ev for _, _, evs in res for ev in evs)
        return [[res[k][0][s] for k in range(len(res))] for s in range(b)], res[0][1]

    return step


def fleet_grid_state_to_numpy(states: Sequence[Sequence[VoFODState]],
                              comm=None) -> dict[str, np.ndarray]:
    """The 2-D state in JAX's layout: every field stacked over the streams
    (grid and safe ``[B, nz, ny, nx]``, each stream's slabs joined on the
    host; ``step`` int32 ``[B]``; the scalars the first slab's).  With a
    ``comm`` that spans processes each stream's slabs are gathered over the
    group first (:func:`gather_state`, a collective)."""
    out: dict[str, list] = {f.name: [] for f in dataclasses.fields(VoFODState)}
    for shards in states:
        if comm is not None and spans_processes(comm):
            shards = [gather_state(shards, comm)]
        per = [state_to_numpy(s) for s in shards]
        for name in out:
            out[name].append(np.concatenate([p[name] for p in per])
                             if name in ("grid", "safe") else per[0][name])
    return {name: np.stack(v) for name, v in out.items()}


def fleet_grid_state_from_numpy(arrays: Mapping[str, np.ndarray],
                                comm) -> list[list[VoFODState]]:
    """The 2-D state from JAX's layout (e.g. a JAX 2-D fleet's
    ``jax.device_get(state)._asdict()``): stream b's z slabs of the shards
    this process drives, each shard's slab uploaded from the host alone."""
    grid = np.asarray(arrays["grid"])
    b, nz = grid.shape[0], grid.shape[1]
    if nz % comm.n:
        raise ValueError(f"grid nz={nz} not divisible by {comm.n} shards")
    nzl = nz // comm.n
    out = []
    for s in range(b):
        row = {k: np.asarray(v)[s] for k, v in arrays.items()}
        # copies: the fleet writes its grids in place (load_apriori_map)
        out.append([state_from_numpy({**row, "grid": row["grid"][i * nzl:(i + 1) * nzl].copy(),
                                      "safe": row["safe"][i * nzl:(i + 1) * nzl].copy()},
                                     comm.devices[i])
                    for i in comm.shards])
    return out

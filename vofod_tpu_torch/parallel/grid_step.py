"""Grid-sharded step: one operation area over n shards of one process.

PyTorch counterpart of vofod_tpu/parallel/grid_step.py
``make_grid_sharded_step`` on the production sweep path (raw ingest, the
gated sweep raycast with pipelined z cones, default sepclusters, static
radii).  The confidence grid and the sepclusters warm-start mask shard
along z, the leading axis; the step of pipeline/step.py runs unchanged on
every shard with parallel/gridops.ZShardOps as its grid provider, each
shard in a thread of a parallel/comm.LocalComm with its own CUDA stream.
The state's dense grids are per-shard slabs, its scalars are replicated,
and the step's outputs are replicated: shard 0's are returned.

:func:`shard_state` / :func:`gather_state` carry a dense state (e.g.
pipeline/state.state_from_numpy of a JAX state's arrays) into the shards
and back; ``gather_state`` is the port's counterpart of ``np.asarray`` on
a sharded JAX array.

Every output equals the dense step's bit for bit (tests/
test_torch_grid_step.py, chip_smoke.py phase 4-grid).
"""

from __future__ import annotations

import dataclasses

import torch

from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.parallel.gridops import ZShardOps
from vofod_tpu_torch.pipeline.state import VoFODState, init_state
from vofod_tpu_torch.pipeline.step import make_step_fn
from vofod_tpu_torch.sensor import XyzLut


def _validate_grid_sharding(cfg: VoFODConfig, n: int) -> None:
    """vofod_tpu grid_step._validate_grid_sharding (the modes this port does
    not shard yet are refused by ZShardOps and make_step_fn)."""
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


def make_grid_sharded_step(cfg: VoFODConfig, lut: XyzLut, comm, *,
                           zcone_mode: str = "pipelined", **step_kw):
    """The grid-sharded step over ``comm`` (a parallel/comm.LocalComm):
    ``step(states, scan, dyn) -> (states, StepOutput)``, with ``states`` one
    VoFODState per shard (:func:`shard_state`, :func:`init_grid_sharded_state`)
    and the scan (a ScanInput) replicated.  ``step_kw``: the make_step_fn
    options of the sweep path (raycast_every, mask, raycast_gate,
    raycast_mode "sweep" or "off").  Requires nz divisible by the shards and
    a shard height of at least 2 planes (the sweep's lateral halo taps);
    refuses, naming ROADMAP queue 1, the modes not sharded yet: the
    prebinned ingest, the exact raycast, the exact census, the hasCloseTo
    box, dynamic radii, the sequential explore and the transposed z cones."""
    _validate_grid_sharding(cfg, comm.n)
    ops = ZShardOps(comm, comm.n, zcone_mode=zcone_mode)
    steps = {dev: make_step_fn(cfg, lut, device=dev, ops=ops, **step_kw)
             for dev in set(comm.devices)}

    def step(states: list[VoFODState], scan, dyn: DynParams):
        if len(states) != comm.n:
            raise ValueError(f"{len(states)} shard states for {comm.n} shards")

        def shard(rank: int):
            dev = comm.devices[rank]
            return steps[dev](states[rank], _scan_on(scan, dev), dyn)

        out = comm.run(shard)
        return [s for s, _ in out], out[0][1]

    return step

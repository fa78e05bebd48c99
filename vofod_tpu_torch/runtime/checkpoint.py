"""Checkpoint / resume of detector state as a directory of per-shard NPZ files.

PyTorch-port counterpart of vofod_tpu/runtime/checkpoint.py, with its API
(``save_state``, ``restore_state``, ``AsyncSaver``, ``SnapshotManager``)
in the port's own directory format: Orbax and JAX do not run where the
port runs, so the port neither reads nor writes Orbax directories.

A checkpoint is a directory holding ``manifest.json`` and one ``.npz`` per
shard or stream, each in the node NPZ's keys and dtypes
(pipeline/state.state_to_numpy: grid, safe, det_counter, step,
sure_bg_sufficient, bg_sufficient).  The manifest names the layout:

* ``dense``: one ``VoFODState`` (``state.npz``, the whole grid); the file
  is a node snapshot that either package's ``load_snapshot`` reads;
* ``zshards``: the grid-sharded step's list of z slabs
  (parallel/grid_step.shard_state), ``shard_NNN.npz`` with each file's
  z range [z0, z1) in the manifest;
* ``streams``: a fleet's list of per-stream states (parallel/sharding),
  ``stream_NNN.npz``, each a whole grid;
* ``streams_zshards``: the 2-D streams x grid fleet's state, one list of
  z slabs a stream (parallel/grid_step.init_fleet_grid_state),
  ``stream_SSS_shard_NNN.npz``; the manifest records the stream count and
  each file's stream and z range [z0, z1).

Each state tensor is copied from its own device into host memory; a
sharded save never assembles the grid.  ``restore_state(path, like)``
places the state onto ``like``'s layout and devices: a ``dense`` or
``zshards`` checkpoint restores onto a dense state or onto any number of
z shards (each target slab is filled from the files that overlap it; the
scalars are shard 0's, as in ``gather_state``); a ``streams`` or
``streams_zshards`` checkpoint onto as many streams, each a whole state
(the 1-shard fleet) or a list of z slabs of any split that divides nz
(the 2-D fleet), either way round.

Across processes (parallel/comm.ProcessComm: one z slab a process;
runtime/fleet.py: a block of streams a process or a stream group) both are
collectives over the default torch.distributed group: pass the slabs'
``comm`` and the global ids of this process's ``streams``.  ``save_state``
writes each process's own ``stream_SSS_shard_NNN.npz`` / ``shard_NNN.npz``
into one directory, and process 0 writes the manifest once every process
has written; ``restore_state`` reads only the files that overlap the
process's slabs.  Such a checkpoint is the same directory a single process
writes, so either restores onto the other's layout.

``AsyncSaver.save`` enqueues every tensor's copy into pinned host memory
on the caller's current CUDA stream before it returns, so work issued
later on that stream (the next scans' steps, the node's in-place writes
to ``state.grid`` in ``process_rangefinder`` and ``load_apriori_map``)
cannot reach the saved bytes; a worker thread waits for the copies and
writes the files.  The step itself rebinds ``grid`` and ``safe`` to fresh
tensors each scan (pipeline/step.py) and never writes the state's own.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import zipfile
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import fields

import numpy as np
import torch

from vofod_tpu_torch.pipeline.state import VoFODState

FORMAT = "vofod_tpu_torch.checkpoint"
VERSION = 1
MANIFEST = "manifest.json"
LAYOUTS = ("dense", "zshards", "streams", "streams_zshards")
_FILE = {"dense": "state.npz", "zshards": "shard_{1:03d}.npz", "streams": "stream_{0:03d}.npz",
         "streams_zshards": "stream_{0:03d}_shard_{1:03d}.npz"}
_PER_STREAM = ("streams", "streams_zshards")
_TENSORS = tuple(f.name for f in fields(VoFODState) if f.name != "step")
_NP = {torch.float32: np.float32, torch.bool: np.bool_, torch.int32: np.int32}


def _states_of(state, layout: str | None) -> tuple[str, list[VoFODState], list[tuple]]:
    """(layout, the states in file order, each one's (stream, shard))."""
    if isinstance(state, VoFODState):
        if layout not in (None, "dense"):
            raise ValueError(f"one VoFODState is the dense layout, not {layout!r}")
        return "dense", [state], [(0, 0)]
    states = list(state)
    if layout == "streams_zshards":
        rows = [list(s) for s in states]
        flat = [s for row in rows for s in row]
        if not rows or not all(rows) or not all(isinstance(s, VoFODState) for s in flat):
            raise ValueError("layout='streams_zshards' takes one non-empty list of z-slab "
                             "states a stream")
        if len({sum(int(s.grid.shape[0]) for s in row) for row in rows}) != 1:
            raise ValueError("the streams' z slabs cover different grid heights")
        return layout, flat, [(b, k) for b, row in enumerate(rows) for k in range(len(row))]
    if layout not in ("zshards", "streams"):
        raise ValueError("a list of states is either z-shard slabs or a fleet's streams: "
                         "pass layout='zshards' or layout='streams' (a list of slab lists: "
                         "layout='streams_zshards')")
    if not states or not all(isinstance(s, VoFODState) for s in states):
        raise ValueError("expected a non-empty list of VoFODState")
    keys = [(0, i) for i in range(len(states))] if layout == "zshards" else \
        [(i, 0) for i in range(len(states))]
    return layout, states, keys


def _stage(states: list[VoFODState]) -> tuple[list[dict], list]:
    """Each state's tensors copied to host memory: CUDA tensors into pinned
    buffers on their device's current stream (non-blocking; one event per
    device records the copies), CPU tensors at once.  ``step`` is a host
    int, taken now."""
    staged, events = [], {}
    for s in states:
        host = {"step": np.int32(s.step)}
        for name in _TENSORS:
            t = getattr(s, name)
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                events[t.device] = None
            elif t.device.type == "cpu":
                h = t.detach().clone()
            else:
                raise ValueError(f"checkpoint: unsupported device {t.device}")
            host[name] = h
        staged.append(host)
    evs = []
    for dev in events:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        evs.append(ev)
    return staged, evs


def _savez(path: str, arrays: dict[str, np.ndarray]) -> None:
    """``np.savez`` (uncompressed; ``np.load`` reads it) that writes each
    array's buffer as it is: ``np.savez`` copies every array to bytes while
    holding the GIL, which stalls a scan loop running beside an
    ``AsyncSaver``."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name, a in arrays.items():
            a = np.asarray(a)
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(a))
                f.write(memoryview(a.reshape(-1)).cast("B") if a.ndim else a.tobytes())


def _write_files(work: str, layout: str, keys: list[tuple], staged: list[dict],
                 z0s: list[int] | None) -> list[dict]:
    """Write each staged state's file into ``work``; returns the manifest's
    entries.  ``z0s``: each slab's first global z plane (None: the slabs of
    a stream follow each other from plane 0)."""
    files, z = [], {}
    for i, ((stream, shard), host) in enumerate(zip(keys, staged)):
        arrays = {k: (v if k == "step" else v.numpy()) for k, v in host.items()}
        name = _FILE[layout].format(stream, shard)
        _savez(os.path.join(work, name), arrays)
        entry = {"name": name}
        if layout in _PER_STREAM:
            entry["stream"] = stream
        if layout != "streams":
            z0 = z.get(stream, 0) if z0s is None else z0s[i]
            nzl = int(arrays["grid"].shape[0])
            entry.update(z0=z0, z1=z0 + nzl)
            z[stream] = z0 + nzl
        files.append(entry)
    return files


def _manifest(layout: str, files: list[dict], plane: tuple) -> dict:
    """The manifest of ``files`` (every process's entries), ``plane`` a
    slab's grid shape."""
    files = sorted(files, key=lambda e: (e.get("stream", 0), e.get("z0", 0)))
    nz = int(plane[0]) if layout == "streams" else max(e["z1"] for e in files)
    m = {"format": FORMAT, "version": VERSION, "layout": layout,
         "grid_shape": [nz, int(plane[1]), int(plane[2])], "files": files}
    if layout in _PER_STREAM:
        m["streams"] = files[-1]["stream"] + 1
    return m


def _write(path: str, layout: str, keys: list[tuple], staged: list[dict], events: list,
           overwrite: bool, z0s: list[int] | None = None) -> None:
    for ev in events:
        ev.synchronize()
    path = os.path.abspath(path)
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    work = tempfile.mkdtemp(prefix=".ckpt-", dir=parent)
    try:
        files = _write_files(work, layout, keys, staged, z0s)
        _finish(path, work, _manifest(layout, files, staged[0]["grid"].shape))
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise


def _finish(path: str, work: str, manifest: dict) -> None:
    """Write the manifest into ``work`` and move it to ``path``."""
    with open(os.path.join(work, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(work, path)


def _all_ok(dist, what):
    """``what`` of every process (an all-gather of objects); raises on every
    process if one of them holds an exception."""
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, what)
    bad = [(r, v) for r, v in enumerate(every) if isinstance(v, BaseException)]
    if bad:
        raise RuntimeError(f"checkpoint: process {bad[0][0]} failed: {bad[0][1]!r}")
    return every


def _write_collective(path: str, layout: str, keys: list[tuple], staged: list[dict],
                      events: list, z0s: list[int] | None, overwrite: bool) -> None:
    """:func:`_write` across the processes of the default group: process 0
    makes the work directory, every process writes its files into it, and
    process 0 writes the manifest of them all and moves it into place; every
    process returns once it is there."""
    import torch.distributed as dist

    path = os.path.abspath(path)
    work = None
    if dist.get_rank() == 0:
        try:
            if os.path.exists(path) and not overwrite:
                raise FileExistsError(path)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            work = tempfile.mkdtemp(prefix=".ckpt-", dir=os.path.dirname(path))
        except OSError as e:
            work = e
    work = _all_ok(dist, work)[0]
    try:
        for ev in events:
            ev.synchronize()
        files = _write_files(work, layout, keys, staged, z0s)
    except Exception as e:  # noqa: BLE001 — raised on every process below
        files = e
    try:
        every = _all_ok(dist, files)
        done = None
        if dist.get_rank() == 0:
            try:
                _finish(path, work, _manifest(layout, [e for f in every for e in f],
                                              staged[0]["grid"].shape))
            except OSError as e:
                done = e
        _all_ok(dist, done)
    except BaseException:
        if dist.get_rank() == 0:
            shutil.rmtree(work, ignore_errors=True)
        raise


def _placed(layout: str, states: list[VoFODState], keys: list[tuple], comm, streams):
    """The keys of a process's part of a checkpoint (global stream ids and
    shard indices) and each slab's first global z plane (None: one process
    holds every slab)."""
    if streams is not None:
        streams = list(streams)
        if layout not in _PER_STREAM or len(streams) != keys[-1][0] + 1:
            raise ValueError(f"streams={streams}: the state holds {keys[-1][0] + 1} streams of "
                             f"a {layout!r} layout")
    if comm is not None and layout not in ("zshards", "streams_zshards"):
        raise ValueError(f"comm= places z slabs; the {layout!r} layout has none")
    shards = comm.shards if comm is not None else None
    out, z0s = [], []
    for (b, k), s in zip(keys, states):
        k = k if shards is None else shards[k]
        out.append((b if streams is None else streams[b], k))
        z0s.append(k * int(s.grid.shape[0]))
    return out, (z0s if comm is not None else None)


def _collective(comm, streams) -> bool:
    """Whether a save / restore with these arguments spans processes."""
    import torch.distributed as dist

    return ((comm is not None or streams is not None) and dist.is_available()
            and dist.is_initialized() and dist.get_world_size() > 1)


def save_state(path: str, state, *, overwrite: bool = True, layout: str | None = None,
               comm=None, streams=None) -> None:
    """Write ``state`` as a checkpoint directory.

    ``state``: a ``VoFODState`` (dense), or a list of them with
    ``layout="zshards"`` (the grid-sharded step's slabs, shard order) or
    ``layout="streams"`` (a fleet's streams), or a list of such slab lists
    with ``layout="streams_zshards"`` (the 2-D fleet's streams).  Each
    tensor is read back from its own device.

    In a process group: ``comm`` the slabs' comm (their shards are
    ``comm.shards``), ``streams`` the global ids of this process's streams
    (a fleet's ``local_streams``); then every process of the default group
    calls it, each writing its own files, and process 0 the manifest."""
    layout, states, keys = _states_of(state, layout)
    keys, z0s = _placed(layout, states, keys, comm, streams)
    staged, events = _stage(states)
    if _collective(comm, streams):
        _write_collective(path, layout, keys, staged, events, z0s, overwrite)
    else:
        _write(path, layout, keys, staged, events, overwrite, z0s)


def read_manifest(path: str) -> dict:
    """The checkpoint's manifest; raises FileNotFoundError / ValueError for
    a directory that is not one."""
    with open(os.path.join(path, MANIFEST)) as f:
        m = json.load(f)
    if m.get("format") != FORMAT or m.get("layout") not in LAYOUTS:
        raise ValueError(f"{path!r} is not a {FORMAT} directory")
    if m.get("version") != VERSION:
        raise ValueError(f"{path!r}: checkpoint version {m.get('version')}, expected {VERSION}")
    return m


def _load(path: str, entry: dict) -> dict[str, np.ndarray]:
    with np.load(os.path.join(path, entry["name"])) as z:
        return {k: z[k] for k in z.files}


def _host_tensor(arr: np.ndarray, like: torch.Tensor, what: str) -> torch.Tensor:
    """``arr`` as a host tensor, once its dtype and shape are ``like``'s."""
    if _NP[like.dtype] != arr.dtype or tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint {what}: {arr.dtype} {tuple(arr.shape)} does not fit the "
                         f"target's {like.dtype} {tuple(like.shape)}")
    if not arr.flags.c_contiguous:
        arr = arr.copy()  # np.ascontiguousarray would make a 0-d array 1-d
    return torch.from_numpy(arr)


def _like_tensor(arr: np.ndarray, like: torch.Tensor, what: str) -> torch.Tensor:
    return _host_tensor(arr, like, what).to(like.device)


def _scalars(arrays: dict, like: VoFODState) -> dict:
    out = {name: _like_tensor(np.asarray(arrays[name]), getattr(like, name), name)
           for name in ("det_counter", "sure_bg_sufficient", "bg_sufficient")}
    out["step"] = int(arrays["step"])
    return out


def _restore_slabs(path: str, m: dict, likes: list[VoFODState],
                   z0s: list[int] | None = None) -> list[VoFODState]:
    """Fill each target z slab from the files of ``m`` (one stream's
    grid_shape and files) that overlap it.  ``z0s``: each slab's first
    global plane (None: the slabs tile the grid from plane 0)."""
    nz, ny, nx = m["grid_shape"]
    heights = [int(s.grid.shape[0]) for s in likes]
    if z0s is None:
        z0s = [sum(heights[:i]) for i in range(len(likes))]
        whole = sum(heights) == nz
    else:
        whole = all(0 <= z0 and z0 + h <= nz for z0, h in zip(z0s, heights))
    if not whole or any(tuple(s.grid.shape[1:]) != (ny, nx) for s in likes):
        raise ValueError(f"checkpoint grid {tuple(m['grid_shape'])} does not fit the target's "
                         f"slabs {[tuple(s.grid.shape) for s in likes]}")
    cache: dict[int, dict] = {}

    def arrays(i: int) -> dict:
        if i not in cache:
            cache[i] = _load(path, m["files"][i])
        return cache[i]

    out = []
    for like, t0 in zip(likes, z0s):
        t1 = t0 + int(like.grid.shape[0])
        # the scalars are every file's: take them from one this slab reads
        first = None
        dev = like.grid.device
        parts = {name: torch.empty(like.grid.shape, dtype=getattr(like, name).dtype, device=dev)
                 for name in ("grid", "safe")}
        for i, e in enumerate(m["files"]):
            a, b = max(t0, e["z0"]), min(t1, e["z1"])
            if a >= b:
                continue
            first = i if first is None else first
            src = arrays(i)
            for name, dst in parts.items():
                piece = src[name][a - e["z0"]:b - e["z0"]]
                dst[a - t0:b - t0].copy_(_host_tensor(piece, dst[a - t0:b - t0], name))
        out.append(VoFODState(grid=parts["grid"], safe=parts["safe"],
                              **_scalars(arrays(first), like)))
    return out


def _stream_parts(m: dict) -> list[dict]:
    """The checkpoint as one (grid_shape, files with z ranges) a stream."""
    layout, nz = m["layout"], m["grid_shape"][0]
    if layout == "streams":
        return [{"grid_shape": m["grid_shape"], "files": [{**e, "z0": 0, "z1": nz}]}
                for e in m["files"]]
    if layout == "streams_zshards":
        return [{"grid_shape": m["grid_shape"],
                 "files": [e for e in m["files"] if e["stream"] == b]}
                for b in range(m["streams"])]
    return [m]


def restore_state(path: str, like, *, comm=None, streams=None):
    """Restore a checkpoint onto the layout and devices of ``like``: a
    ``VoFODState`` (dense), a list of them (z slabs in shard order; a
    fleet's streams for a ``streams`` or ``streams_zshards`` checkpoint),
    or a list of z-slab lists (the 2-D fleet's streams), e.g.
    ``init_state`` / ``init_grid_sharded_state`` / ``init_batched_state``
    / ``init_fleet_grid_state``.  Returns a state of ``like``'s form.

    In a process group, as :func:`save_state`: ``comm`` the target slabs'
    comm (slab k is shard ``comm.shards[k]``), ``streams`` the global ids of
    the target's streams; only the files that overlap them are read."""
    path = os.path.abspath(path)
    m = read_manifest(path)
    parts = _stream_parts(m)
    dense = isinstance(like, VoFODState)
    likes = [like] if dense else list(like)
    nested = bool(likes) and not isinstance(likes[0], VoFODState)
    one_stream = not (dense or nested or m["layout"] in _PER_STREAM)
    # the target as one list of z slabs a stream
    rows = [list(s) for s in likes] if nested else [likes] if one_stream else \
        [[s] for s in likes]
    if streams is None:
        streams = range(len(rows))
        if len(rows) != len(parts):
            raise ValueError(f"a checkpoint of {len(parts)} streams restores onto as many "
                             f"stream states, not {len(rows)}")
    streams = list(streams)
    if len(streams) != len(rows) or any(not 0 <= b < len(parts) for b in streams):
        raise ValueError(f"streams={streams} for {len(rows)} target streams of a checkpoint "
                         f"of {len(parts)} streams")
    out = []
    for b, row in zip(streams, rows):
        z0s = None  # any split that tiles the grid
        if comm is not None:
            if int(row[0].grid.shape[0]) * comm.n != parts[b]["grid_shape"][0]:
                raise ValueError(f"checkpoint grid {tuple(parts[b]['grid_shape'])} does not "
                                 f"split into {comm.n} slabs of {tuple(row[0].grid.shape)}")
            z0s = [k * int(s.grid.shape[0]) for k, s in zip(comm.shards, row)]
        out.append(_restore_slabs(path, parts[b], row, z0s))
    if dense:
        return out[0][0]
    if nested:
        return out
    return out[0] if one_stream else [r[0] for r in out]


class AsyncSaver:
    """Background checkpointing that does not stall the scan stream.

    ``save`` returns once every tensor's copy to host memory is enqueued on
    the caller's stream; one worker thread waits for the copies and writes
    the directories in call order.  ``wait()`` (or close / leaving the
    context) joins and raises a failed save's error."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="vofod-ckpt")
        self._pending: list[Future] = []

    def save(self, path: str, state, *, overwrite: bool = True,
             layout: str | None = None) -> None:
        layout, states, keys = _states_of(state, layout)
        staged, events = _stage(states)
        self._pending.append(
            self._pool.submit(_write, path, layout, keys, staged, events, overwrite))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class SnapshotManager:
    """Rolling keep-last-K snapshots keyed by step number.

    The crash-recovery loop for long-running serving: save every N scans,
    restore the latest on restart (``latest_step`` / ``restore``).  Each
    snapshot is a checkpoint directory ``<directory>/<step>``; a save
    removes all but the newest ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(os.path.join(self.directory, name, MANIFEST)):
                steps.append(int(name))
        return sorted(steps)

    def save(self, step: int, state, *, layout: str | None = None) -> None:
        save_state(os.path.join(self.directory, str(int(step))), state, layout=layout)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like, step: int | None = None):
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no snapshots in {self.directory}")
        path = os.path.join(self.directory, str(step))
        if not os.path.exists(os.path.join(path, MANIFEST)):
            raise FileNotFoundError(f"no snapshot of step {step} in {self.directory}")
        return restore_state(path, like)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

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
  ``stream_NNN.npz``, each a whole grid.

Each state tensor is copied from its own device into host memory; a
sharded save never assembles the grid.  ``restore_state(path, like)``
places the state onto ``like``'s layout and devices: a ``dense`` or
``zshards`` checkpoint restores onto a dense state or onto any number of
z shards (each target slab is filled from the files that overlap it; the
scalars are shard 0's, as in ``gather_state``), a ``streams`` checkpoint
onto as many stream states.

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
LAYOUTS = ("dense", "zshards", "streams")
_FILE = {"dense": "state.npz", "zshards": "shard_{:03d}.npz", "streams": "stream_{:03d}.npz"}
_TENSORS = tuple(f.name for f in fields(VoFODState) if f.name != "step")
_NP = {torch.float32: np.float32, torch.bool: np.bool_, torch.int32: np.int32}


def _states_of(state, layout: str | None) -> tuple[str, list[VoFODState]]:
    if isinstance(state, VoFODState):
        if layout not in (None, "dense"):
            raise ValueError(f"one VoFODState is the dense layout, not {layout!r}")
        return "dense", [state]
    states = list(state)
    if layout not in ("zshards", "streams"):
        raise ValueError("a list of states is either z-shard slabs or a fleet's streams: "
                         "pass layout='zshards' or layout='streams'")
    if not states or not all(isinstance(s, VoFODState) for s in states):
        raise ValueError("expected a non-empty list of VoFODState")
    return layout, states


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


def _write(path: str, layout: str, staged: list[dict], events: list, overwrite: bool) -> None:
    for ev in events:
        ev.synchronize()
    path = os.path.abspath(path)
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    work = tempfile.mkdtemp(prefix=".ckpt-", dir=parent)
    try:
        files, z = [], 0
        for i, host in enumerate(staged):
            arrays = {k: (v if k == "step" else v.numpy()) for k, v in host.items()}
            name = _FILE[layout].format(i)
            _savez(os.path.join(work, name), arrays)
            entry = {"name": name}
            if layout != "streams":
                nzl = int(arrays["grid"].shape[0])
                entry.update(z0=z, z1=z + nzl)
                z += nzl
            files.append(entry)
        g = staged[0]["grid"].shape
        grid_shape = [z, int(g[1]), int(g[2])] if layout != "streams" else [int(v) for v in g]
        manifest = {"format": FORMAT, "version": VERSION, "layout": layout,
                    "grid_shape": grid_shape, "files": files}
        with open(os.path.join(work, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(work, path)
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise


def save_state(path: str, state, *, overwrite: bool = True, layout: str | None = None) -> None:
    """Write ``state`` as a checkpoint directory.

    ``state``: a ``VoFODState`` (dense), or a list of them with
    ``layout="zshards"`` (the grid-sharded step's slabs, shard order) or
    ``layout="streams"`` (a fleet's streams).  Each tensor is read back
    from its own device."""
    layout, states = _states_of(state, layout)
    staged, events = _stage(states)
    _write(path, layout, staged, events, overwrite)


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


def _restore_slabs(path: str, m: dict, likes: list[VoFODState]) -> list[VoFODState]:
    """Fill each target z slab from the files that overlap it."""
    nz, ny, nx = m["grid_shape"]
    total = sum(int(s.grid.shape[0]) for s in likes)
    if total != nz or any(tuple(s.grid.shape[1:]) != (ny, nx) for s in likes):
        raise ValueError(f"checkpoint grid {tuple(m['grid_shape'])} does not fit the target's "
                         f"slabs {[tuple(s.grid.shape) for s in likes]}")
    cache: dict[int, dict] = {}

    def arrays(i: int) -> dict:
        if i not in cache:
            cache[i] = _load(path, m["files"][i])
        return cache[i]

    out, t0 = [], 0
    for like in likes:
        t1 = t0 + int(like.grid.shape[0])
        dev = like.grid.device
        parts = {name: torch.empty(like.grid.shape, dtype=getattr(like, name).dtype, device=dev)
                 for name in ("grid", "safe")}
        for i, e in enumerate(m["files"]):
            a, b = max(t0, e["z0"]), min(t1, e["z1"])
            if a >= b:
                continue
            src = arrays(i)
            for name, dst in parts.items():
                piece = src[name][a - e["z0"]:b - e["z0"]]
                dst[a - t0:b - t0].copy_(_host_tensor(piece, dst[a - t0:b - t0], name))
        out.append(VoFODState(grid=parts["grid"], safe=parts["safe"],
                              **_scalars(arrays(0), like)))
        t0 = t1
    return out


def restore_state(path: str, like):
    """Restore a checkpoint onto the layout and devices of ``like``: a
    ``VoFODState`` (dense) or a list of them (z slabs in shard order, or a
    fleet's streams for a ``streams`` checkpoint), e.g. ``init_state`` /
    ``init_grid_sharded_state`` / ``init_batched_state``.  Returns a state
    of ``like``'s form."""
    path = os.path.abspath(path)
    m = read_manifest(path)
    dense = isinstance(like, VoFODState)
    likes = [like] if dense else list(like)
    if m["layout"] == "streams":
        if dense or len(likes) != len(m["files"]):
            raise ValueError(f"a checkpoint of {len(m['files'])} streams restores onto as many "
                             "stream states")
        out = []
        for e, s in zip(m["files"], likes):
            a = _load(path, e)
            out.append(VoFODState(grid=_like_tensor(a["grid"], s.grid, "grid"),
                                  safe=_like_tensor(a["safe"], s.safe, "safe"),
                                  **_scalars(a, s)))
        return out
    out = _restore_slabs(path, m, likes)
    return out[0] if dense else out


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
        layout, states = _states_of(state, layout)
        staged, events = _stage(states)
        self._pending.append(
            self._pool.submit(_write, path, layout, staged, events, overwrite))

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

"""One process drives n grid shards: the collectives of the grid-sharded step.

The JAX package runs its grid-sharded step (vofod_tpu/parallel/grid_step.py)
as ONE program over n devices inside ``shard_map``.  :class:`LocalComm` is
the port's counterpart for a process that drives every shard itself: each
shard runs the same step code in a host thread of its own, with its own CUDA
stream, on ``devices[i % len(devices)]`` (all on one card, or spread over a
host's cards).  The collectives carry the names of the JAX ones —
``ppermute``, ``psum``, ``pmax``, ``any``, ``all_gather``, ``all_to_all``
— and are device copies ordered by CUDA events, with no host sync:

* the sender copies its tensor once on its own stream (so later writes to
  the original cannot race the receiver) and records an event;
* the shards meet: each posts its part and passes the turn on, and reads
  the others' parts when the turn comes back to it;
* the receiver's stream waits on the sender's event, marks the copy as used
  on its stream (``record_stream``: the caching allocator must not recycle
  it before that stream is done), and reads it; reductions add in rank
  order, so float sums are the same from run to run.

The shards' threads take turns, in rank order, from one collective to the
next: one thread runs at a time.  The host work of a shard is Python and
launches, both under the GIL, so concurrent threads would only fight over
it (each GIL-releasing call handing the interpreter to another shard); the
device work of all shards still overlaps on the card.  A shard that raises
breaks the turns at once, and a shard that waits longer than ``timeout``
breaks them too, so :meth:`run` raises and never hangs.

The port's step never branches on device data (pipeline/step.py), so every
shard issues the same collectives in the same order; the JAX step needs its
``ctrl_any`` reductions for that lockstep.  ``run`` fences the shards'
streams against the caller's current stream on the way in and out.

These methods are the interface :class:`ProcessComm` implements over
``torch.distributed`` for a grid axis that crosses processes: one shard a
process, its card its own or shared with the other processes.  Both say
which shards the calling process drives (``shards``): every state list the
step code takes or returns holds those shards' slabs, in that order.
"""

from __future__ import annotations

import math
import threading
import time
from datetime import timedelta

import numpy as np
import torch

Tensor = torch.Tensor


class LocalComm:
    """``n`` shards driven by one process.

    devices: the shards' devices, shard i on ``devices[i % len(devices)]``;
      every one CUDA, or every one the CPU (the tests).  A CUDA device when
      CUDA is not available raises.
    timeout: seconds a shard may wait for its turn (and ``run`` for its
      threads) before the run fails; a shard that raises breaks the turns
      at once, so ``run`` raises its exception instead of hanging.
    """

    def __init__(self, n: int, devices=("cuda",), timeout: float = 120.0):
        if n < 1:
            raise ValueError(f"LocalComm needs n >= 1 shards, got {n}")
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("LocalComm needs at least one device")
        kinds = {d.type for d in devs}
        if kinds - {"cuda", "cpu"} or len(kinds) != 1:
            raise ValueError(f"LocalComm shards must be all CUDA or all CPU, got {devs}")
        self.is_cuda = kinds == {"cuda"}
        if self.is_cuda and not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was requested but torch.cuda.is_available() is False")
        if self.is_cuda:
            devs = [torch.device("cuda", d.index if d.index is not None else
                                 torch.cuda.current_device()) for d in devs]
        self.n = n
        self.shards = list(range(n))  # every shard is this process's
        self.timeout = float(timeout)
        self.devices = [devs[i % len(devs)] for i in range(n)]
        self.streams = [torch.cuda.Stream(device=d) if self.is_cuda else None
                        for d in self.devices]
        self._tls = threading.local()
        self._slots: list[list] = [[None] * n, [None] * n]
        self._turn = [threading.Event() for _ in range(n)]
        self._broken = False
        self._copy_lock = threading.Lock()
        self.copies = 0  # device copies made by the collectives since reset_copies()
        self.copies_by: dict[str, int] = {}  # the same, by collective

    # ---- the shards -------------------------------------------------------------
    @property
    def rank(self) -> int:
        """The calling shard's index (inside :meth:`run` only)."""
        try:
            return self._tls.rank
        except AttributeError:
            raise RuntimeError("LocalComm.rank is defined inside LocalComm.run only") from None

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    def run(self, fn) -> list:
        """Call ``fn(rank)`` for every shard, each in its own thread with its
        device and stream current; returns the results in rank order.  The
        first shard exception (or a turn timeout) is raised here."""
        self._slots = [[None] * self.n, [None] * self.n]
        self._turn = [threading.Event() for _ in range(self.n)]
        self._broken = False
        self._turn[0].set()
        results: list = [None] * self.n
        errors: list = [None] * self.n
        ends: list = [None] * self.n
        # the intra-op thread count is per thread (OpenMP): the shards take
        # the caller's, or each would open a pool of every core
        intra_op = torch.get_num_threads()
        starts = {}
        if self.is_cuda:
            for d in set(self.devices):
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(d))
                starts[d] = ev

        def body(i: int) -> None:
            self._tls.rank = i
            self._tls.seq = 0
            torch.set_num_threads(intra_op)
            try:
                self._wait_turn()
                if self.is_cuda:
                    s = self.streams[i]
                    with torch.cuda.device(self.devices[i]), torch.cuda.stream(s):
                        s.wait_event(starts[self.devices[i]])
                        results[i] = fn(i)
                        ends[i] = torch.cuda.Event()
                        ends[i].record(s)
                else:
                    results[i] = fn(i)
                self._pass_turn()
            except BaseException as e:  # noqa: BLE001 — re-raised in the caller
                errors[i] = e
                self._break()

        threads = [threading.Thread(target=body, args=(i,), daemon=True,
                                    name=f"vofod-shard-{i}") for i in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.timeout)
        if any(t.is_alive() for t in threads):
            self._break()
            raise TimeoutError(f"a shard of the LocalComm run did not finish within "
                               f"{self.timeout} s")
        # the root cause first: turns broken by another shard's failure are
        # a consequence
        first = next((e for e in errors if e is not None
                      and not isinstance(e, threading.BrokenBarrierError)), None)
        first = first or next((e for e in errors if e is not None), None)
        if first is not None:
            raise first
        if self.is_cuda:
            for d, ev in zip(self.devices, ends):
                torch.cuda.current_stream(d).wait_event(ev)
        return results

    # ---- plumbing ---------------------------------------------------------------
    def reset_copies(self) -> None:
        with self._copy_lock:
            self.copies = 0
            self.copies_by = {}

    def _count_copy(self, kind: str) -> None:
        with self._copy_lock:
            self.copies += 1
            self.copies_by[kind] = self.copies_by.get(kind, 0) + 1

    def _break(self) -> None:
        self._broken = True
        for ev in self._turn:
            ev.set()

    def _wait_turn(self) -> None:
        ev = self._turn[self.rank]
        if not ev.wait(self.timeout):
            self._break()
            raise threading.BrokenBarrierError(
                f"shard {self.rank} waited {self.timeout} s for its turn")
        if self._broken:
            raise threading.BrokenBarrierError("another shard of the run failed")
        ev.clear()

    def _pass_turn(self) -> None:
        self._turn[(self.rank + 1) % self.n].set()

    def _exchange(self, payload) -> list:
        """Post ``payload`` and meet the other shards: every shard's payload
        of this collective, in rank order.  When the turn comes back, every
        shard has posted.  Two slot lists alternate: a shard posts the next
        collective's payload into the other list, so it never overwrites a
        list still read."""
        seq = self._tls.seq
        self._tls.seq = seq + 1
        slots = self._slots[seq % 2]
        slots[self.rank] = payload
        self._pass_turn()
        self._wait_turn()
        return slots

    def _send(self, x: Tensor, kind: str):
        buf = x.detach().clone(memory_format=torch.contiguous_format)
        self._count_copy(kind)
        ev = None
        if buf.is_cuda:
            ev = torch.cuda.Event()
            ev.record()
        return buf, ev

    def _recv(self, item, kind: str) -> Tensor:
        buf, ev = item
        if ev is not None:
            s = torch.cuda.current_stream()
            s.wait_event(ev)
            buf.record_stream(s)
            if buf.device != self.device:
                buf = buf.to(self.device, non_blocking=True)
                self._count_copy(kind)
        return buf

    # ---- collectives ------------------------------------------------------------
    def ppermutes(self, items: list) -> list:
        """Several ``ppermute``s in one collective: ``items`` is a list of
        (tensor, perm) with perm a list of (source, destination) ranks; returns
        per item what this shard received, or None when no shard sends to it
        (JAX's ppermute gives zeros there; every caller here fills instead)."""
        me = self.rank
        payload = [self._send(x, "ppermute") if any(s == me for s, _ in perm) else None
                   for x, perm in items]
        slots = self._exchange(payload)
        out = []
        for j, (_, perm) in enumerate(items):
            src = next((s for s, d in perm if d == me), None)
            out.append(None if src is None else self._recv(slots[src][j], "ppermute"))
        return out

    def ppermute(self, x: Tensor, perm) -> Tensor | None:
        return self.ppermutes([(x, perm)])[0]

    def all_gather(self, x: Tensor) -> Tensor:
        """[n, *x.shape]: every shard's ``x`` in rank order."""
        slots = self._exchange(self._send(x, "all_gather"))
        return torch.stack([self._recv(slots[j], "all_gather") for j in range(self.n)])

    def all_to_all(self, x: Tensor, split_axis: int, concat_axis: int) -> Tensor:
        """JAX's tiled ``lax.all_to_all``: ``x`` split into n equal blocks
        along ``split_axis``, block j sent to shard j; returns the blocks
        received (block ``rank`` of every shard's split), concatenated in
        rank order along ``concat_axis``.  The shard's own block is kept
        without a copy; the n - 1 others are the collective's copies."""
        me, n = self.rank, self.n
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} does not "
                             f"split into {n} blocks")
        blocks = torch.chunk(x, n, dim=split_axis)
        slots = self._exchange([None if j == me else self._send(b, "all_to_all")
                                for j, b in enumerate(blocks)])
        return torch.cat([blocks[me] if j == me else self._recv(slots[j][me], "all_to_all")
                          for j in range(n)], dim=concat_axis)

    def _reduce(self, x: Tensor, op, kind: str) -> Tensor:
        slots = self._exchange(self._send(x, kind))
        acc = self._recv(slots[0], kind)
        for j in range(1, self.n):
            acc = op(acc, self._recv(slots[j], kind))
        return acc

    def psum(self, x: Tensor) -> Tensor:
        """Elementwise sum over the shards, added in rank order."""
        return self._reduce(x, torch.add, "psum")

    def pmax(self, x: Tensor) -> Tensor:
        return self._reduce(x, torch.maximum, "pmax")

    def any(self, x: Tensor) -> Tensor:
        """Elementwise OR of a bool tensor over the shards."""
        return self._reduce(x, torch.logical_or, "any")


# the dtypes a ProcessComm moves, by their index in a ppermute header
_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.uint8, torch.int8,
           torch.int16, torch.int32, torch.int64, torch.bool)
_MAX_DIMS = 8
_HDR = 2 + _MAX_DIMS  # a ppermute item's header: dtype index, ndim, the dims (padded)
_TAG_HEADER, _TAG_PAYLOAD = 1, 2
_ALIGN = 16  # a ppermute item's offset in its peer's message: a multiple of this many bytes


def _padded(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


def _bytes(t: Tensor) -> Tensor:
    """``t``'s contents as a flat uint8 tensor (a view where ``t`` is
    contiguous)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


class ProcessComm:
    """One grid shard a process: :class:`LocalComm`'s interface over a
    ``torch.distributed`` (gloo) group.

    Every process of the default group builds it alike (a collective): the
    world's W processes form W / n stream groups of n consecutive ranks,
    process p being shard ``p % n`` of group ``p // n``, so the grid axis
    is minor as in the JAX package's (data, grid) mesh.  Each group is a
    ``dist.new_group`` of its own, with ``timeout`` as its timeout: a peer
    that raises or dies makes every collective of the others raise within
    it, never hang.

    The collectives move bytes through the host, by design: gloo moves CUDA
    tensors only for ``broadcast`` and ``all_reduce``, and NCCL refuses two
    ranks on one card.  A CUDA sender copies its tensors into pinned host
    memory on the current (the comm's) stream and waits for the copies --
    one host sync a collective, counted in ``syncs`` / ``syncs_by``; the
    bytes go through gloo; the receiver uploads them non-blocking on its
    stream.  Nothing runs on the CPU in place of the card.  Float reductions
    are an all-gather and a fold in rank order on the device, as
    :meth:`LocalComm._reduce` adds, never ``dist.all_reduce``: the two
    transports' sums agree bit for bit.  ``ppermutes`` posts every receive
    and send of the call at once (a header of dtypes and shapes, then the
    payload, one message each a peer), so cyclic permutations cannot
    deadlock.

    ``copies`` / ``copies_by`` count the staged copies (down and up),
    ``syncs_by`` the host syncs, ``calls_by`` the collectives,
    ``host_ms_by`` the host milliseconds spent in them, ``sync_ms_by``
    the part of those spent waiting in the syncs (for the device work
    queued before the copies) and ``wait_ms_by`` the part spent in the gloo
    exchanges (the peers' arrival and the bytes' transfer), each by
    collective since :meth:`reset_copies`.

    n: the shards of a stream group (default: the world size).
    device: this process's device, CUDA (its current card unless an index
      is given) or the CPU (the tests); a CUDA device when CUDA is not
      available raises.
    """

    def __init__(self, n: int | None = None, device="cuda", timeout: float = 120.0):
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("ProcessComm needs a torch.distributed process group: call "
                               "runtime/fleet.initialize_multihost first")
        world, me = dist.get_world_size(), dist.get_rank()
        n = world if n is None else int(n)
        if n < 1 or world % n:
            raise ValueError(f"ProcessComm: {world} processes do not form groups of {n} shards")
        dev = torch.device(device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"ProcessComm: unsupported device {dev}")
        self.is_cuda = dev.type == "cuda"
        if self.is_cuda and not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was requested but torch.cuda.is_available() is False")
        if self.is_cuda:
            dev = torch.device("cuda", dev.index if dev.index is not None
                               else torch.cuda.current_device())
        self.n, self.rank = n, me % n
        self.shards = [self.rank]
        self.device = dev
        self.timeout = float(timeout)
        self._td = timedelta(seconds=self.timeout)
        first = me - self.rank
        self._peers = list(range(first, first + n))  # the group's global ranks
        # every process takes part in every group's creation
        groups = [dist.new_group(list(range(g, g + n)), timeout=self._td, backend="gloo")
                  for g in range(0, world, n)]
        self.group = groups[me // n]
        names = [None] * n
        dist.all_gather_object(names, str(dev), group=self.group)
        self.devices = [torch.device(x) for x in names]
        self.stream = torch.cuda.Stream(device=dev) if self.is_cuda else None
        self.reset_copies()

    def run(self, fn) -> list:
        """``[fn(rank)]``: this process's shard, in the calling thread, on the
        comm's CUDA stream, fenced against the caller's current stream on
        the way in and out; a list in :attr:`shards` order, as
        :meth:`LocalComm.run` returns."""
        if not self.is_cuda:
            return [fn(self.rank)]
        caller = torch.cuda.current_stream(self.device)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            self.stream.wait_stream(caller)
            out = fn(self.rank)
        caller.wait_stream(self.stream)
        return [out]

    # ---- plumbing ---------------------------------------------------------------
    def reset_copies(self) -> None:
        self.copies = 0
        self.copies_by: dict[str, int] = {}
        self.syncs_by: dict[str, int] = {}
        self.calls_by: dict[str, int] = {}
        self.host_ms_by: dict[str, float] = {}
        self.sync_ms_by: dict[str, float] = {}
        self.wait_ms_by: dict[str, float] = {}

    @property
    def syncs(self) -> int:
        return sum(self.syncs_by.values())

    @property
    def host_ms(self) -> float:
        return sum(self.host_ms_by.values())

    def _count(self, kind: str, copies: int = 0, syncs: int = 0) -> None:
        self.copies += copies
        if copies:
            self.copies_by[kind] = self.copies_by.get(kind, 0) + copies
        if syncs:
            self.syncs_by[kind] = self.syncs_by.get(kind, 0) + syncs

    def _done(self, kind: str, t0: float) -> None:
        self.calls_by[kind] = self.calls_by.get(kind, 0) + 1
        self.host_ms_by[kind] = self.host_ms_by.get(kind, 0.0) + (time.perf_counter() - t0) * 1e3

    def _host(self, nbytes: int) -> Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.is_cuda)

    def _down(self, parts: list[list[Tensor]], kind: str, align: bool = False) -> list[Tensor]:
        """Each list of tensors as one flat uint8 host buffer (their bytes
        back to back; with ``align`` each at an offset that is a multiple of
        ``_ALIGN``, so the receiver can view any dtype there).  CUDA tensors
        are copied into pinned buffers on the current stream, then the host
        waits for them: one sync for all."""
        out = []
        for ts in parts:
            flat = [_bytes(t) for t in ts]
            if not self.is_cuda and len(flat) == 1:
                out.append(flat[0])
                continue
            size = _padded if align else int
            buf = self._host(sum(size(f.numel()) for f in flat))
            o = 0
            for f in flat:
                buf[o:o + f.numel()].copy_(f, non_blocking=self.is_cuda)
                o += size(f.numel())
            if self.is_cuda:
                self._count(kind, copies=len(flat))
            out.append(buf)
        if self.is_cuda and out:
            t0 = time.perf_counter()
            torch.cuda.current_stream(self.device).synchronize()
            self.sync_ms_by[kind] = (self.sync_ms_by.get(kind, 0.0)
                                     + (time.perf_counter() - t0) * 1e3)
            self._count(kind, syncs=1)
        return out

    def _up(self, buf: Tensor, kind: str) -> Tensor:
        """Host bytes onto the device (non-blocking from pinned memory, on
        the current stream)."""
        if not self.is_cuda:
            return buf
        self._count(kind, copies=1)
        return buf.to(self.device, non_blocking=True)

    def _waited(self, kind: str, t0: float) -> None:
        self.wait_ms_by[kind] = self.wait_ms_by.get(kind, 0.0) + (time.perf_counter() - t0) * 1e3

    def _wait(self, works, kind: str) -> None:
        t0 = time.perf_counter()
        for w in works:
            w.wait(self._td)
        self._waited(kind, t0)

    # ---- collectives ------------------------------------------------------------
    def ppermutes(self, items: list) -> list:
        """As :meth:`LocalComm.ppermutes`: ``items`` a list of (tensor, perm),
        perm a list of (source, destination) ranks; returns per item what
        this shard received, or None when no shard sends to it."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        me = self.rank
        out: list = [None] * len(items)
        sends: dict[int, list] = {}
        recvs: dict[int, list] = {}
        for j, (x, perm) in enumerate(items):
            for s, d in perm:
                if s == me and d == me:
                    out[j] = x.detach().clone()
                elif s == me:
                    sends.setdefault(d, []).append(x)
                elif d == me:
                    recvs.setdefault(s, []).append(j)
        dsts = sorted(sends)
        heads = {}
        for d in dsts:
            h = torch.zeros((len(sends[d]), _HDR), dtype=torch.int64)
            for i, x in enumerate(sends[d]):
                if x.dim() > _MAX_DIMS:
                    raise ValueError(f"ppermute of a {x.dim()}-d tensor (at most {_MAX_DIMS})")
                h[i, 0], h[i, 1] = _DTYPES.index(x.dtype), x.dim()
                h[i, 2:2 + x.dim()] = torch.tensor(x.shape, dtype=torch.int64)
            heads[d] = h
        got_h = {s: torch.empty((len(js), _HDR), dtype=torch.int64) for s, js in recvs.items()}
        g = self.group
        works = [dist.irecv(got_h[s], src=self._peers[s], group=g, tag=_TAG_HEADER) for s in got_h]
        works += [dist.isend(heads[d], dst=self._peers[d], group=g, tag=_TAG_HEADER)
                  for d in dsts]
        payload = dict(zip(dsts, self._down([sends[d] for d in dsts], "ppermute", align=True)))
        self._wait(works, "ppermute")
        shapes = {s: [(_DTYPES[int(r[0])], tuple(int(v) for v in r[2:2 + int(r[1])]))
                      for r in h] for s, h in got_h.items()}
        sizes = {s: [math.prod(shape) * dt.itemsize for dt, shape in meta]
                 for s, meta in shapes.items()}
        bufs = {s: self._host(sum(_padded(nb) for nb in v)) for s, v in sizes.items()}
        works = [dist.irecv(bufs[s], src=self._peers[s], group=g, tag=_TAG_PAYLOAD)
                 for s in bufs]
        works += [dist.isend(payload[d], dst=self._peers[d], group=g, tag=_TAG_PAYLOAD)
                  for d in dsts]
        self._wait(works, "ppermute")
        for s, js in recvs.items():
            dev = self._up(bufs[s], "ppermute")
            o = 0
            for j, (dt, shape), nb in zip(js, shapes[s], sizes[s]):
                out[j] = dev[o:o + nb].view(dt).reshape(shape)
                o += _padded(nb)
        self._done("ppermute", t0)
        return out

    def ppermute(self, x: Tensor, perm) -> Tensor | None:
        return self.ppermutes([(x, perm)])[0]

    def broadcast_host(self, *arrays: np.ndarray) -> list[np.ndarray]:
        """Host arrays as shard 0 of the stream group holds them: one gloo
        broadcast of their bytes over the group (host memory only: no
        staging, no count)."""
        import torch.distributed as dist

        buf = torch.from_numpy(np.concatenate(
            [np.ascontiguousarray(a).reshape(-1).view(np.uint8) for a in arrays]))
        dist.broadcast(buf, src=self._peers[0], group=self.group)
        raw, out, o = buf.numpy(), [], 0
        for a in arrays:
            out.append(raw[o:o + a.nbytes].view(a.dtype).reshape(a.shape).copy())
            o += a.nbytes
        return out

    def _gather(self, x: Tensor, kind: str) -> Tensor:
        """[n, *x.shape] on the device: every shard's ``x`` in rank order."""
        import torch.distributed as dist

        (h,) = self._down([[x]], kind)
        buf = self._host(self.n * h.numel()).view(self.n, -1)
        t0 = time.perf_counter()
        dist.all_gather(list(buf.unbind(0)), h, group=self.group)
        self._waited(kind, t0)
        return self._up(buf, kind).view(x.dtype).reshape((self.n,) + tuple(x.shape))

    def all_gather(self, x: Tensor) -> Tensor:
        """[n, *x.shape]: every shard's ``x`` in rank order."""
        t0 = time.perf_counter()
        out = self._gather(x, "all_gather")
        self._done("all_gather", t0)
        return out

    def all_to_all(self, x: Tensor, split_axis: int, concat_axis: int) -> Tensor:
        """JAX's tiled ``lax.all_to_all``, as :meth:`LocalComm.all_to_all`:
        block j of ``x``'s split along ``split_axis`` to shard j; the blocks
        received concatenated in rank order along ``concat_axis``.  Every
        shard's ``x`` has the same shape."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        me, n = self.rank, self.n
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} does not "
                             f"split into {n} blocks")
        blocks = torch.chunk(x, n, dim=split_axis)
        (h,) = self._down([list(blocks)], "all_to_all")
        buf = self._host(h.numel())
        t1 = time.perf_counter()
        dist.all_to_all_single(buf, h, group=self.group)
        self._waited("all_to_all", t1)
        got = self._up(buf, "all_to_all").view(n, -1)
        shape = tuple(blocks[0].shape)
        out = torch.cat([blocks[me] if j == me else got[j].view(x.dtype).reshape(shape)
                         for j in range(n)], dim=concat_axis)
        self._done("all_to_all", t0)
        return out

    def _reduce(self, x: Tensor, op, kind: str) -> Tensor:
        t0 = time.perf_counter()
        parts = self._gather(x, kind)
        acc = parts[0]
        for j in range(1, self.n):
            acc = op(acc, parts[j])
        self._done(kind, t0)
        return acc

    def psum(self, x: Tensor) -> Tensor:
        """Elementwise sum over the shards, added in rank order."""
        return self._reduce(x, torch.add, "psum")

    def pmax(self, x: Tensor) -> Tensor:
        return self._reduce(x, torch.maximum, "pmax")

    def any(self, x: Tensor) -> Tensor:
        """Elementwise OR of a bool tensor over the shards."""
        return self._reduce(x, torch.logical_or, "any")


"""One process drives n grid shards: the collectives of the grid-sharded step.

The JAX package runs its grid-sharded step (vofod_tpu/parallel/grid_step.py)
as ONE program over n devices inside ``shard_map``.  :class:`LocalComm` is
the port's counterpart for a process that drives every shard itself: each
shard runs the same step code in a host thread of its own, with its own CUDA
stream, on ``devices[i % len(devices)]`` (all on one card, or spread over a
host's cards).  The collectives carry the names of the JAX ones —
``ppermute``, ``psum``, ``pmax``, ``any``, ``all_gather`` — and are device
copies ordered by CUDA events, with no host sync:

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

These methods are the whole interface a ``torch.distributed`` transport
would implement for hosts where each shard has a process and a card.
"""

from __future__ import annotations

import threading

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

    def _count_copy(self, n: int = 1) -> None:
        with self._copy_lock:
            self.copies += n

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

    def _send(self, x: Tensor):
        buf = x.detach().clone(memory_format=torch.contiguous_format)
        self._count_copy()
        ev = None
        if buf.is_cuda:
            ev = torch.cuda.Event()
            ev.record()
        return buf, ev

    def _recv(self, item) -> Tensor:
        buf, ev = item
        if ev is not None:
            s = torch.cuda.current_stream()
            s.wait_event(ev)
            buf.record_stream(s)
            if buf.device != self.device:
                buf = buf.to(self.device, non_blocking=True)
                self._count_copy()
        return buf

    # ---- collectives ------------------------------------------------------------
    def ppermutes(self, items: list) -> list:
        """Several ``ppermute``s in one collective: ``items`` is a list of
        (tensor, perm) with perm a list of (source, destination) ranks; returns
        per item what this shard received, or None when no shard sends to it
        (JAX's ppermute gives zeros there; every caller here fills instead)."""
        me = self.rank
        payload = [self._send(x) if any(s == me for s, _ in perm) else None for x, perm in items]
        slots = self._exchange(payload)
        out = []
        for j, (_, perm) in enumerate(items):
            src = next((s for s, d in perm if d == me), None)
            out.append(None if src is None else self._recv(slots[src][j]))
        return out

    def ppermute(self, x: Tensor, perm) -> Tensor | None:
        return self.ppermutes([(x, perm)])[0]

    def all_gather(self, x: Tensor) -> Tensor:
        """[n, *x.shape]: every shard's ``x`` in rank order."""
        slots = self._exchange(self._send(x))
        return torch.stack([self._recv(slots[j]) for j in range(self.n)])

    def _reduce(self, x: Tensor, op) -> Tensor:
        slots = self._exchange(self._send(x))
        acc = self._recv(slots[0])
        for j in range(1, self.n):
            acc = op(acc, self._recv(slots[j]))
        return acc

    def psum(self, x: Tensor) -> Tensor:
        """Elementwise sum over the shards, added in rank order."""
        return self._reduce(x, torch.add)

    def pmax(self, x: Tensor) -> Tensor:
        return self._reduce(x, torch.maximum)

    def any(self, x: Tensor) -> Tensor:
        """Elementwise OR of a bool tensor over the shards."""
        return self._reduce(x, torch.logical_or)

"""Fixed-capacity stream compaction with no host sync (K6).

PyTorch counterpart of vofod_tpu/ops/compaction.py ``masked_compact``: the
flat indices of the first ``capacity`` set elements of a boolean grid, the
bridge from dense grids to the small per-cluster computations.  For CUDA
tensors it is the hand-written kernel K6 (csrc/compact.cu); CPU tensors take
the plain versions here.  The JAX version avoids prefix sums with a
triangular MXU matmul (a TPU workaround); the plain version takes an
inclusive int32 prefix sum and a ``searchsorted`` of the slot ranks, which
gives the same ids with fixed-size outputs: slot q holds the first index
whose running count reaches q + 1.

:func:`masked_compact_isin` is the query form of the classification,
``far & isin(labels, sel)`` (classify.py:155-161 of the JAX package, where
``-2`` in ``sel`` matches nothing); the kernel evaluates that predicate
itself instead of materialising the mask.

:func:`masked_compact_lookback_plain` models the kernel's single-pass
schedule (tiles, byte offsets, the look-back's stepping order) on the CPU.
"""

from __future__ import annotations

import torch

from vofod_tpu_torch import kernels

Tensor = torch.Tensor


def masked_compact_plain(mask: Tensor, capacity: int) -> tuple[Tensor, Tensor, Tensor]:
    """Returns (ids int32 [capacity] ascending, clamped to 0 past ``total``;
    valid bool [capacity]; total int32 scalar — may exceed capacity, the
    callers' overflow signal)."""
    flat = mask.reshape(-1)
    n = flat.shape[0]
    run = torch.cumsum(flat.to(torch.int32), 0, dtype=torch.int32)
    total = run[-1]
    q = torch.arange(1, capacity + 1, dtype=torch.int32, device=mask.device)
    ids = torch.searchsorted(run, q).to(torch.int32)
    valid = q <= total
    ids = torch.where(valid, ids.clamp(max=n - 1), 0)
    return ids, valid, total


def masked_compact_isin_plain(far: Tensor, labels: Tensor, sel: Tensor,
                              capacity: int) -> tuple[Tensor, Tensor, Tensor]:
    return masked_compact_plain(far & torch.isin(labels, sel), capacity)


# csrc/compact.cu: threads a tile, 16-byte chunks a thread, status words a
# look-back window (one a lane)
_CT, _VEC, _WINDOW = kernels.COMPACT_THREADS, kernels.COMPACT_VEC, 32
_ST_AGG, _ST_PRE = 1 << 62, 2 << 62
_ST_VAL = _ST_AGG - 1


def masked_compact_lookback_plain(mask: Tensor, capacity: int, labels: Tensor | None = None,
                                  sel: Tensor | None = None, *, order=None,
                                  resident: int | None = None) -> tuple[Tensor, Tensor, Tensor]:
    """Plain model of K6's single-pass schedule (csrc/compact.cu): the same
    outputs as :func:`masked_compact_plain` (:func:`masked_compact_isin_plain`
    with ``labels`` and ``sel``), computed as the kernel computes them.

    The tiles cover ``kernels.COMPACT_TILE`` bytes from the 16-byte boundary
    at or below the mask's address (``mask.data_ptr() % 16`` is the offset
    of element 0); thread t's chunk k is the 16 bytes at (k * 256 + t) * 16;
    a thread's chunk counts ride one word in 16-bit fields through one
    exclusive scan.  The look-back state starts zeroed (the buffer the
    previous launch on the stream zeroed).  Blocks start in ticket order
    while fewer than ``resident`` (default: every tile) run; of the running
    blocks, the first in ``order`` (a permutation of the tiles, default
    ascending) that can make progress takes its next step: publish its
    aggregate, then look back one window of 32 status words at a time
    (blocked while a word in the window is zero), then finish.  A tile
    whose exclusive prefix is >= ``capacity`` writes no id; the last tile
    writes ``total``, ``valid`` and zeroes the ids past ``total``.  The
    outputs start as garbage, as the kernel's do; raises if a slot is left
    unwritten, the schedule deadlocks or a tile never publishes its
    prefix."""
    flat = mask.reshape(-1)
    if not flat.is_contiguous():
        raise ValueError("the compaction model takes a contiguous mask")
    n, dev = flat.shape[0], flat.device
    hit = flat != 0
    if labels is not None:
        hit = hit & torch.isin(labels.reshape(-1), sel)
    off = flat.data_ptr() % 16
    tile_bytes = kernels.COMPACT_TILE
    T = -(-(n + off) // tile_bytes)
    aligned = torch.zeros(T * tile_bytes, dtype=torch.int64, device=dev)
    aligned[off:off + n] = hit.to(torch.int64)
    chunks = aligned.reshape(T, _VEC, _CT, 16)  # [tile, k, thread, byte]
    cnt = chunks.sum(-1)  # [T, VEC, CT]
    packed = sum(cnt[:, k] << (16 * k) for k in range(_VEC))  # [T, CT]
    excl_packed = torch.cumsum(packed, 1) - packed
    tile_packed = packed.sum(1)  # [T]
    fields = lambda w, k: (w >> (16 * k)) & 0xFFFF  # noqa: E731
    agg = sum(fields(tile_packed, k) for k in range(_VEC)).tolist()

    # the look-back protocol
    status, ticket, finished = [0] * T, 0, 0  # ticket and status: the zeroed buffer
    prio = list(range(T)) if order is None else [0] * T
    if order is not None:
        if sorted(int(t) for t in order) != list(range(T)):
            raise ValueError(f"order must be a permutation of the {T} tiles")
        for i, t in enumerate(order):
            prio[int(t)] = i
    resident = T if resident is None else resident
    running: dict[int, list] = {}  # tile -> [step, window's last tile, excl]
    before = [0] * T
    while finished < T:
        while len(running) < resident and ticket < T:
            running[ticket] = ["publish", ticket - 1, 0]
            ticket += 1
        for t in sorted(running, key=prio.__getitem__):
            st = running[t]
            if st[0] == "publish":
                status[t] = (_ST_PRE if t == 0 else _ST_AGG) | agg[t]
                st[0] = "finish" if t == 0 else "look"
                break
            if st[0] == "look":
                words = [status[p] if p >= 0 else _ST_PRE
                         for p in range(st[1], st[1] - _WINDOW, -1)]
                if 0 in words:
                    continue  # a predecessor has published nothing yet: it polls
                pre = [w & ~_ST_VAL == _ST_PRE for w in words]
                stop = pre.index(True) if any(pre) else _WINDOW - 1
                st[2] += sum(w & _ST_VAL for w in words[:stop + 1])
                if any(pre):
                    status[t] = _ST_PRE | (st[2] + agg[t])
                    st[0] = "finish"
                else:
                    st[1] -= _WINDOW
                break
            before[t] = st[2]
            finished += 1
            del running[t]
            break
        else:
            raise RuntimeError("the look-back schedule deadlocked")
    if any(w & ~_ST_VAL != _ST_PRE for w in status) or ticket != T:
        raise RuntimeError("a tile did not publish its prefix")

    # the writes: each set element at its rank when the tile's prefix and
    # the rank are below the capacity; then the last tile's epilogue
    ids = torch.full((capacity,), -0x5EED, dtype=torch.int64, device=dev)
    valid = torch.full((capacity,), 2, dtype=torch.uint8, device=dev)
    bt = torch.tensor(before, dtype=torch.int64, device=dev)
    chunk_base = torch.stack([
        sum((fields(tile_packed, j) for j in range(k)), torch.zeros_like(tile_packed))
        for k in range(_VEC)], 1)  # [T, VEC]: the tile's count before chunk k
    thread_excl = torch.stack([fields(excl_packed, k) for k in range(_VEC)], 1)
    rank = (bt[:, None, None, None] + chunk_base[:, :, None, None] + thread_excl[..., None]
            + torch.cumsum(chunks, -1) - chunks)
    pos = torch.arange(T * tile_bytes, dtype=torch.int64, device=dev).reshape(chunks.shape)
    write = (chunks == 1) & (bt < capacity)[:, None, None, None] & (rank < capacity)
    ids[rank[write]] = pos[write] - off
    total = before[T - 1] + agg[T - 1]
    q = torch.arange(capacity, device=dev)
    valid[:] = (q < total).to(torch.uint8)
    ids[q >= total] = 0
    if bool((ids == -0x5EED).any()) or bool((valid > 1).any()):
        raise RuntimeError("the schedule left an output slot unwritten")
    return (ids.to(torch.int32), valid.to(torch.bool),
            torch.tensor(total, dtype=torch.int32, device=dev))


def _cpu_only(t: Tensor) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"masked_compact: unsupported device {t.device}")


def masked_compact(mask: Tensor, capacity: int) -> tuple[Tensor, Tensor, Tensor]:
    if mask.is_cuda:
        return kernels.masked_compact(mask, capacity)
    _cpu_only(mask)
    return masked_compact_plain(mask, capacity)


def masked_compact_isin(far: Tensor, labels: Tensor, sel: Tensor,
                        capacity: int) -> tuple[Tensor, Tensor, Tensor]:
    """``masked_compact(far & isin(labels, sel), capacity)``."""
    if far.is_cuda:
        return kernels.masked_compact(far, capacity, labels, sel)
    _cpu_only(far)
    return masked_compact_isin_plain(far, labels, sel, capacity)

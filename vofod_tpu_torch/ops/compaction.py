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

"""Fixed-capacity stream compaction with no host sync.

PyTorch counterpart of vofod_tpu/ops/compaction.py ``masked_compact``: the
flat indices of the first ``capacity`` set elements of a boolean grid, the
bridge from dense grids to the small per-cluster computations.  The JAX
version avoids prefix sums with a triangular MXU matmul (a TPU workaround);
here an inclusive int32 prefix sum and a ``searchsorted`` of the slot ranks
give the same ids with fixed-size outputs: slot q holds the first index
whose running count reaches q + 1.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def masked_compact(mask: Tensor, capacity: int) -> tuple[Tensor, Tensor, Tensor]:
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

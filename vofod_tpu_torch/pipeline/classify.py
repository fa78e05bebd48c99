"""Far-cluster classification: gates, OBB, floatingness, demotion.

PyTorch counterpart of vofod_tpu/pipeline/classify.py ``classify``, batched
path (ref classifyClusters / classify_cluster, vofod_nodelet.cpp:818-831,
1647-1731): far voxels are compacted to a fixed list (F slots), distinct
component labels fill K cluster slots in ascending order, and counts, AABB,
PCA OBB, gates and the floating check all run on that list.

Host-sync-free control flow: the explore always runs at the full Q-query
capacity (any tier >= qtotal gives the same result, classify.py:281-286,
and a run with no valid query equals the JAX branch 0), and the masked
demotion is always applied (a no-op when nothing demotes).
``sequential_explore`` is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.profiler import record_function

from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.geometry import GridSpec, to_int32
from vofod_tpu_torch.ops.compaction import masked_compact
from vofod_tpu_torch.ops.components import SENTINEL
from vofod_tpu_torch.ops.eigh3 import cross, eigh3
from vofod_tpu_torch.ops.explore import apply_demotions, explore_to_ground

Tensor = torch.Tensor

CLS_INVALID = 0
CLS_MAV = 1
CLS_UNKNOWN = 2


@dataclass
class ClassifyOut:
    grid: Tensor  # confidence grid after frontier demotions
    cluster_valid: Tensor  # bool [K] — slot holds a real far cluster
    cluster_class: Tensor  # int32 [K]
    n_points: Tensor  # int32 [K]
    aabb_min: Tensor  # f32 [K, 3]
    aabb_max: Tensor  # f32 [K, 3]
    obb_center: Tensor  # f32 [K, 3]
    obb_axes: Tensor  # f32 [K, 3, 3] (rows = principal axes)
    obb_extent: Tensor  # f32 [K, 3] (half extents)
    obb_size: Tensor  # f32 [K] — OBB diagonal (ref :1688)
    reps: Tensor  # int32 [K] — component labels (flat voxel ids)
    labels: Tensor  # int32 dense component-label grid
    n_far: Tensor
    far_overflow: Tensor
    labels_converged: Tensor


def _isin_small(x: Tensor, values: Tensor) -> Tensor:
    """``torch.isin(x, values)`` for a handful of values, by a binary search
    in the sorted values (torch.isin on a large CUDA input deduplicates it
    with a host-synchronising unique)."""
    sv = torch.sort(values).values
    pos = torch.searchsorted(sv, x).clamp(max=sv.shape[0] - 1)
    return sv[pos] == x


def classify(
    cfg: VoFODConfig,
    dyn: DynParams,
    grid: GridSpec,
    grid_vals: Tensor,
    far: Tensor,
    labels: Tensor,
    labels_converged: Tensor,
    sensor_pos: Tensor,  # [3] world
    bg_sufficient: Tensor,
    sure_bg_sufficient: Tensor,
) -> ClassifyOut:
    if cfg.sequential_explore:
        raise NotImplementedError("sequential_explore is not ported yet")
    K, F, Q = cfg.max_clusters, cfg.max_far_voxels, cfg.max_queries
    dev = grid_vals.device
    flat_labels = labels.reshape(-1)

    fids, fvalid, ftotal = masked_compact(far, F)
    overflow = ftotal > F
    fx, fy, fz = grid.unflatten_id(fids)
    centers = grid.idx_to_coord(fx, fy, fz)  # [F, 3] world
    flabels = torch.where(fvalid, flat_labels[fids.long()], SENTINEL)

    # --- distinct component labels into K slots (ascending) -----------------
    lab = flabels
    idx_f = torch.arange(F, device=dev)
    seen_before = torch.any(
        (lab[None, :] == lab[:, None]) & (idx_f[None, :] < idx_f[:, None]), dim=1
    )
    is_rep = fvalid & ~seen_before  # first occurrence of each distinct label
    rank = torch.sum(is_rep[None, :] & (lab[None, :] < lab[:, None]), dim=1)
    slot_of = torch.where(is_rep & (rank < K), rank, K)  # K: dropped
    reps = torch.full((K + 1,), SENTINEL, dtype=torch.int32, device=dev)
    reps = reps.scatter_reduce(0, slot_of, lab, "amin")[:K]
    slot_valid = reps < SENTINEL
    slot = fvalid[:, None] & (flabels[:, None] == reps[None, :])  # [F, K]
    slot_f = slot.to(torch.float32)
    cluster_overflow = torch.any(fvalid & ~torch.any(slot, dim=1))

    npts = slot.sum(dim=0).to(torch.int32)
    denom = torch.clamp(npts, min=1).to(torch.float32)

    # --- AABB over member voxel centers (ref MoI getAABB) --------------------
    big = 3.0e38
    cexp = centers[:, None, :]
    mvalid = slot[:, :, None]
    aabb_min = torch.where(mvalid, cexp, big).amin(dim=0)
    aabb_max = torch.where(mvalid, cexp, -big).amax(dim=0)

    # --- PCA OBB (replaces PCL MomentOfInertiaEstimation, ref :1655-1673) ----
    mean = (slot_f.T @ centers) / denom[:, None]  # [K, 3]
    d = centers[:, None, :] - mean[None, :, :]  # [F, K, 3]
    dm = torch.where(mvalid, d, 0.0)
    cov = torch.einsum("fki,fkj->kij", dm, dm) / denom[:, None, None]
    cov = cov + 1e-6 * torch.eye(3, device=dev)[None]
    evals, evecs = eigh3(cov)
    axes_cols = torch.flip(evecs, dims=(-1,))  # columns: major, middle, minor
    major, middle = axes_cols[:, :, 0], axes_cols[:, :, 1]
    minor = cross(major, middle)
    axes = torch.stack([major, middle, minor], dim=1)  # rows = axes [K, 3, 3]
    proj = torch.einsum("fkj,kaj->fka", d, axes)  # [F, K, 3]
    pmin = torch.where(mvalid, proj, big).amin(dim=0)
    pmax = torch.where(mvalid, proj, -big).amax(dim=0)
    obb_center = mean + torch.einsum("kaj,ka->kj", axes, (pmin + pmax) / 2.0)
    obb_extent = (pmax - pmin) / 2.0
    obb_size = torch.linalg.vector_norm(pmax - pmin, dim=-1)

    # --- gates (ref :1679-1690) ----------------------------------------------
    dist = torch.linalg.vector_norm(obb_center - sensor_pos[None, :], dim=-1)
    gated = (
        slot_valid
        & (npts.to(torch.float32) >= dyn.cls_min_points)
        & (dist <= dyn.cls_max_distance)
        & (obb_size <= dyn.cls_max_size)
    )

    # --- floating check (ref :1692-1718) --------------------------------------
    explore_on = bg_sufficient & sure_bg_sufficient & ~overflow
    m_k = to_int32(torch.floor(
        (obb_size + float(dyn.cls_max_explore_distance)) / cfg.voxel_size
    ))
    qgate = gated & explore_on  # [K]

    # member voxels of gated clusters -> second compaction
    rep_sel = torch.where(qgate, reps, -2)  # -2 matches nothing
    qmask = far & _isin_small(labels, rep_sel)
    qids, qvalid, qtotal = masked_compact(qmask, Q)
    query_overflow = qtotal > Q
    qx, qy, qz = grid.unflatten_id(qids)
    qlabels = torch.where(qvalid, flat_labels[qids.long()], SENTINEL)
    qslot = qvalid[:, None] & (qlabels[:, None] == reps[None, :])  # [Q, K]
    m_q = (qslot.to(torch.int32) * m_k[None, :]).sum(dim=1).to(torch.int32)

    with record_function("vofod.classify.explore"):
        connected, reached, corners = explore_to_ground(
            grid, grid_vals, qx, qy, qz, qvalid, m_q,
            dyn.thr_frontiers, dyn.thr_new_obstacles, cfg.explore_submap,
        )
    cluster_connected = torch.any(qslot & connected[:, None], dim=0)  # [K]
    # under query overflow some members were never explored: conservative
    floating = qgate & ~cluster_connected & ~query_overflow
    demote = qvalid & torch.any(qslot & floating[None, :], dim=1)
    with record_function("vofod.classify.demote"):
        new_vals = apply_demotions(grid_vals, reached, corners, demote, dyn.thr_frontiers)

    cls = torch.where(
        gated,
        torch.where(floating, CLS_MAV, CLS_UNKNOWN),
        CLS_INVALID,
    ).to(torch.int32)
    cls = torch.where(slot_valid, cls, CLS_INVALID).to(torch.int32)

    return ClassifyOut(
        grid=new_vals,
        cluster_valid=slot_valid,
        cluster_class=cls,
        n_points=npts,
        aabb_min=aabb_min,
        aabb_max=aabb_max,
        obb_center=obb_center,
        obb_axes=axes,
        obb_extent=obb_extent,
        obb_size=obb_size,
        reps=reps,
        labels=labels,
        n_far=ftotal,
        far_overflow=overflow | cluster_overflow,
        labels_converged=labels_converged,
    )

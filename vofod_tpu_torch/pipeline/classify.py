"""Far-cluster classification: gates, OBB, floatingness, demotion.

PyTorch counterpart of vofod_tpu/pipeline/classify.py ``classify`` (ref
classifyClusters / classify_cluster, vofod_nodelet.cpp:818-831,
1647-1731): far voxels are compacted to a fixed list (F slots), distinct
component labels fill K cluster slots in ascending order, and counts, AABB,
PCA OBB, gates and the floating check all run on that list.

On CUDA tensors the whole stage runs on hand-written kernels: the two
compactions (K6, the query one with its label predicate inside the
kernel), the cluster statistics (K9, :func:`cluster_stats`), and either the
batched explore BFS (K7) with the demotion write-back (K8, which also gives
the slots with a connected query, ``cluster_connected``), or, under
``cfg.sequential_explore``, the sequential explore with live demotion
(K7s, one launch); CPU tensors take their plain versions.

Grid layout: the dense grids go through ``ops`` (parallel/gridops.py), as
in the JAX stage: ``DENSE`` on one device, or ``ZShardOps`` on the
grid-sharded step, where the compactions merge per-shard lists, the label
lookups (K9's far labels among them) sum the owners' values over the
shards, the explore and demotion run on the shards' halo-extended slabs,
and the sequential explore walks a replicated stack of its queries'
submap bits (K15b-7a/b/c) in place of K7s.

Host-sync-free control flow: the batched explore always runs at the full
Q-query capacity (any tier >= qtotal gives the same result,
classify.py:281-286, and a run with no valid query equals the JAX branch 0;
the kernel's blocks of invalid queries return at once), and the masked
demotion is always applied (a no-op when nothing demotes).  K7s reads the
validity and overflow flags on the device and skips in the kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.profiler import record_function

from vofod_tpu_torch import kernels
from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.geometry import GridSpec, to_int32
from vofod_tpu_torch.ops.components import SENTINEL
from vofod_tpu_torch.ops.eigh3 import cross, eigh3
from vofod_tpu_torch.parallel.gridops import DENSE

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
    n_queries: Tensor  # int32 — far voxels of gated clusters (explore queries)
    n_demoted: Tensor  # int32 — demotion writes (batched: a voxel in two patches counts 2)


@dataclass
class ClusterStats:
    """Per-slot statistics of the far list (K9's outputs)."""

    reps: Tensor  # int32 [K] — component label of each slot, ascending
    slot_valid: Tensor  # bool [K]
    npts: Tensor  # int32 [K]
    aabb_min: Tensor  # f32 [K, 3]
    aabb_max: Tensor  # f32 [K, 3]
    obb_center: Tensor  # f32 [K, 3]
    axes: Tensor  # f32 [K, 3, 3] (rows = principal axes)
    obb_extent: Tensor  # f32 [K, 3]
    obb_size: Tensor  # f32 [K]
    gated: Tensor  # bool [K] — passed the point / distance / size gates
    m_k: Tensor  # int32 [K] — explore Manhattan bound of the slot
    qgate: Tensor  # bool [K] — gated and the explore is on
    rep_sel: Tensor  # int32 [K] — reps where qgate, else -2 (matches nothing)
    cluster_overflow: Tensor  # bool — more distinct far labels than K


def cluster_stats_plain(
    dyn: DynParams, grid: GridSpec, K: int, fids: Tensor, fvalid: Tensor,
    far_labels: Tensor, sensor_pos: Tensor, explore_on: Tensor,
) -> ClusterStats:
    """Plain version of K9 (vofod_tpu/pipeline/classify.py:83-157).
    ``far_labels``: the far voxels' labels, int32 [F]."""
    F = fids.shape[0]
    dev = fids.device
    fx, fy, fz = grid.unflatten_id(fids)
    centers = grid.idx_to_coord(fx, fy, fz)  # [F, 3] world
    flabels = torch.where(fvalid, far_labels, SENTINEL)

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
    m_k = to_int32(torch.floor(
        (obb_size + float(dyn.cls_max_explore_distance)) / grid.voxel_size
    ))
    qgate = gated & explore_on  # [K]
    rep_sel = torch.where(qgate, reps, -2)  # -2 matches nothing
    return ClusterStats(
        reps=reps, slot_valid=slot_valid, npts=npts, aabb_min=aabb_min,
        aabb_max=aabb_max, obb_center=obb_center, axes=axes, obb_extent=obb_extent,
        obb_size=obb_size, gated=gated, m_k=m_k, qgate=qgate, rep_sel=rep_sel,
        cluster_overflow=cluster_overflow,
    )


def cluster_slots_sorted_plain(fvalid: Tensor, far_labels: Tensor, K: int,
                               chunk: int | None = None):
    """Plain model of K9's slot schedule (csrc/classify_stats.cu): far voxel
    f's key is (its label as unsigned, f), an invalid f's sorts last, and
    a far voxel labelled SENTINEL joins no slot.  The keys are sorted in chunks
    of ``chunk`` (default: one chunk, the one-launch path); a chunk's run
    head is a label head if no earlier chunk holds the label; a head's rank
    is the sum over the chunks of their heads below its label; slot k's
    members are the runs of the label of rank k.  Returns (reps int32 [K],
    slot_valid bool [K], npts int32 [K], cluster_overflow bool, members: per
    slot the sorted far indices f), which equal ``cluster_stats_plain``'s."""
    F = fvalid.shape[0]
    none = 2**32 - 1  # the high word of an invalid key, and of label SENTINEL
    hi = torch.where(fvalid, far_labels.to(torch.int64) + 2**31, none)
    key = hi * F + torch.arange(F, dtype=torch.int64, device=hi.device)  # (hi, f) order
    C = F if chunk is None else chunk
    keys = [torch.sort(key[c:c + C]).values for c in range(0, F, C)]
    his = [k // F for k in keys]
    counts = []  # per chunk: the label heads at or before each position
    for c, h in enumerate(his):
        head = (h < none) & torch.cat([h.new_ones(1, dtype=torch.bool), h[1:] != h[:-1]])
        for e in range(c):
            j = torch.searchsorted(his[e], h).clamp(max=len(his[e]) - 1)
            head &= his[e][j] != h
        counts.append(torch.cumsum(head.to(torch.int64), 0))
    reps = torch.full((K,), SENTINEL, dtype=torch.int32, device=hi.device)
    overflow = False
    for h, n in zip(his, counts):
        head = n - torch.cat([n.new_zeros(1), n[:-1]]) > 0
        rank = torch.zeros(int(head.sum()), dtype=torch.int64, device=hi.device)
        for e_h, e_n in zip(his, counts):
            j = torch.searchsorted(e_h, h[head])
            rank += torch.where(j > 0, e_n[(j - 1).clamp(min=0)], 0)
        reps[rank[rank < K]] = (h[head][rank < K] - 2**31).to(torch.int32)
        overflow |= bool((rank >= K).any())
    members = []  # the runs of each slot's label, chunk by chunk
    for rep in reps.tolist():
        u = rep + 2**31
        runs = [k[int(torch.searchsorted(h, u)):int(torch.searchsorted(h, u + 1))] % F
                for k, h in zip(keys, his) if rep != SENTINEL]
        members.append(torch.cat(runs) if runs else key.new_zeros(0))
    npts = torch.tensor([len(m) for m in members], dtype=torch.int32, device=hi.device)
    return reps, reps < SENTINEL, npts, torch.tensor(overflow, device=hi.device), members


def cluster_stats(
    dyn: DynParams, grid: GridSpec, K: int, fids: Tensor, fvalid: Tensor, far_labels: Tensor,
    ftotal: Tensor, sensor_pos: Tensor, bg_sufficient: Tensor, sure_bg_sufficient: Tensor,
) -> ClusterStats:
    """K9: statistics of the far list ``fids``/``fvalid`` (the first F far
    voxels of ``ftotal``).  The explore runs only when the background is
    sufficient and the far list did not overflow (ref :1692).
    ``far_labels``: the far voxels' labels (int32 [F], ``ops.lookup`` of the
    label grid at ``fids``)."""
    if fids.is_cuda:
        out = kernels.cluster_stats(
            fids, fvalid, far_labels, K, grid.origin, grid.voxel_size,
            (dyn.cls_min_points, dyn.cls_max_distance, dyn.cls_max_size,
             dyn.cls_max_explore_distance),
            sensor_pos.contiguous(), bg_sufficient, sure_bg_sufficient, ftotal,
            grid_yx=(grid.ny, grid.nx),
        )
        return ClusterStats(**out)
    if fids.device.type != "cpu":
        raise ValueError(f"cluster_stats: unsupported device {fids.device}")
    explore_on = bg_sufficient & sure_bg_sufficient & ~(ftotal > fids.shape[0])
    return cluster_stats_plain(dyn, grid, K, fids, fvalid, far_labels, sensor_pos, explore_on)


def explore_queries(grid: GridSpec, far: Tensor, labels: Tensor, st: ClusterStats, Q: int,
                    ops=DENSE):
    """The explore's queries: the far voxels of the gated clusters, compacted
    to Q slots (K6's label-predicate form).  Returns (qids, qvalid, qtotal,
    qx, qy, qz, qlabels — SENTINEL where invalid, qslot bool [Q, K] — the
    query's cluster slot, m_q — its Manhattan bound)."""
    qids, qvalid, qtotal = ops.compact_isin(far, labels, st.rep_sel, Q)
    qx, qy, qz = grid.unflatten_id(qids)
    qlabels = torch.where(qvalid, ops.lookup(labels, qids), SENTINEL)
    qslot = qvalid[:, None] & (qlabels[:, None] == st.reps[None, :])  # [Q, K]
    m_q = (qslot.to(torch.int32) * st.m_k[None, :]).sum(dim=1).to(torch.int32)
    return qids, qvalid, qtotal, qx, qy, qz, qlabels, qslot, m_q


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
    ops=DENSE,
) -> ClassifyOut:
    K, F, Q = cfg.max_clusters, cfg.max_far_voxels, cfg.max_queries

    fids, fvalid, ftotal = ops.compact(far, F)
    overflow = ftotal > F
    st = cluster_stats(dyn, grid, K, fids, fvalid, ops.lookup(labels, fids), ftotal,
                       sensor_pos, bg_sufficient, sure_bg_sufficient)

    q = explore_queries(grid, far, labels, st, Q, ops)
    qids, qvalid, qtotal, qx, qy, qz, qlabels, qslot, m_q = q
    query_overflow = qtotal > Q

    thr_f, thr_g, S = dyn.thr_frontiers, dyn.thr_new_obstacles, cfg.explore_submap
    if cfg.sequential_explore:
        # on the card this writes into grid_vals in place, as K8 does
        with record_function("vofod.classify.explore_sequential"):
            new_vals, cluster_connected, n_demoted = ops.explore_sequential(
                grid, grid_vals, qx, qy, qz, qvalid, qlabels, qids, qslot, m_q,
                query_overflow, thr_f, thr_g, S)
    else:
        with record_function("vofod.classify.explore"):
            connected, reached, corners = ops.explore(grid, grid_vals, qx, qy, qz, qvalid, m_q,
                                                      thr_f, thr_g, S)
        with record_function("vofod.classify.demote"):
            # on the card this writes into grid_vals in place: the step's
            # background grid has no reader after classify (step.py); K8
            # also gives cluster_connected, any(qslot & connected) by slot
            new_vals, n_demoted, cluster_connected = ops.demote(
                grid_vals, reached, corners, qslot, connected, qvalid, st.qgate,
                query_overflow, thr_f,
            )
    # under query overflow some members were never explored: conservative
    floating = st.qgate & ~cluster_connected & ~query_overflow

    cls = torch.where(
        st.gated,
        torch.where(floating, CLS_MAV, CLS_UNKNOWN),
        CLS_INVALID,
    ).to(torch.int32)
    cls = torch.where(st.slot_valid, cls, CLS_INVALID).to(torch.int32)

    return ClassifyOut(
        grid=new_vals,
        cluster_valid=st.slot_valid,
        cluster_class=cls,
        n_points=st.npts,
        aabb_min=st.aabb_min,
        aabb_max=st.aabb_max,
        obb_center=st.obb_center,
        obb_axes=st.axes,
        obb_extent=st.obb_extent,
        obb_size=st.obb_size,
        reps=st.reps,
        labels=labels,
        n_far=ftotal,
        far_overflow=overflow | st.cluster_overflow,
        labels_converged=labels_converged,
        n_queries=qtotal,
        n_demoted=n_demoted,
    )

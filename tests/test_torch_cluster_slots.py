"""K9's slot schedule (csrc/classify_stats.cu), modelled on the CPU.

On the card K9 sorts the far list's (label, f) keys, takes each run head
of a label as its first occurrence, ranks the heads by an exclusive scan
and reduces slot k's run; past one block's shared memory it sorts chunks,
finds the label heads across chunks by binary searches and ranks them by
a merge-path sum.  ``cluster_slots_sorted_plain`` is the plain model of
both forms (``chunk`` None: one launch; else the chunked path).  Held
here, bit for bit: its reps, slot_valid, npts and cluster_overflow to
``cluster_stats_plain``'s and its slot members to the far voxels of each
rep, on the edge cases (all ties, all invalid, exactly K and K + 1
distinct labels, F = 1, F not a power of two, labels at SENTINEL - 1,
negative labels) and a chunked case whose labels span chunks; and, at
F <= 4096, to the JAX classify block (vofod_tpu/pipeline/classify.py:83-104).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.config import DynParams as JDyn, VoFODConfig as JConfig
from vofod_tpu.geometry import GridSpec as JGrid
from vofod_tpu.pipeline.classify import classify as j_classify
from vofod_tpu_torch.config import DynParams
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.ops.compaction import masked_compact_plain
from vofod_tpu_torch.pipeline.classify import cluster_slots_sorted_plain, cluster_stats_plain

# jitted as the JAX step runs it (config and grid static)
j_classify_jit = jax.jit(j_classify, static_argnums=(0, 2))
SENTINEL = 2**31 - 1
GRID = GridSpec((0.0, 0.0, 0.0), (10, 20, 30), 0.5)


def _far_list(case: str):
    """(fvalid bool [F], labels int32 [F], K) of one case."""
    rng = np.random.default_rng(sum(map(ord, case)))

    def pick(F, pool, p_valid, K):
        return rng.random(F) < p_valid, rng.choice(np.asarray(pool, np.int64), F), K

    if case == "random":
        fvalid, labels, K = pick(300, rng.integers(0, GRID.n_voxels, 12), 0.5, 8)
    elif case == "all_ties":
        fvalid, labels, K = pick(96, [4321], 0.7, 8)
    elif case == "all_invalid":
        fvalid, labels, K = pick(64, rng.integers(0, 999, 5), 0.0, 8)
    elif case in ("exactly_k", "k_plus_1"):
        n = 8 if case == "exactly_k" else 9
        fvalid, labels, K = pick(77, rng.integers(0, 5000, n), 0.8, 8)
        labels[:n] = np.unique(labels)[:n] if len(np.unique(labels)) >= n else labels[:n]
        fvalid[:n] = True  # every label present
    elif case == "f_one":
        fvalid, labels, K = np.array([True]), np.array([17]), 8
    elif case == "f_one_invalid":
        fvalid, labels, K = np.array([False]), np.array([17]), 8
    elif case == "not_pow2":
        fvalid, labels, K = pick(1000, rng.integers(0, GRID.n_voxels, 40), 0.6, 32)
    elif case == "fewer_than_k":
        fvalid, labels, K = pick(50, [3, 1, 2], 0.9, 8)
    elif case == "near_sentinel":
        fvalid, labels, K = pick(200, [SENTINEL - 1, SENTINEL - 2, SENTINEL - 33, 0, 1], 0.7, 4)
    elif case == "signed":  # int32 order, not unsigned order
        fvalid, labels, K = pick(120, [-2**31, -7, -1, 0, 5, SENTINEL - 1], 0.8, 8)
    elif case == "chunked":  # labels spread over chunks, first seen in later ones too
        F = 3000
        labels = rng.integers(0, 40, F) * 97
        labels[:600] = rng.integers(0, 5, 600) * 97  # the low chunks hold few labels
        fvalid, K = rng.random(F) < 0.7, 32
    else:
        raise ValueError(case)
    return torch.from_numpy(fvalid), torch.from_numpy(labels.astype(np.int32)), K


EDGE_CASES = ("random", "all_ties", "all_invalid", "exactly_k", "k_plus_1", "f_one",
              "f_one_invalid", "not_pow2", "fewer_than_k", "near_sentinel", "signed")


def _plain(fvalid, labels, K):
    F = fvalid.shape[0]
    fids = torch.from_numpy(np.random.default_rng(F).integers(0, GRID.n_voxels, F)
                            .astype(np.int32))
    return cluster_stats_plain(DynParams(), GRID, K, fids, fvalid, labels,
                               torch.tensor([1.0, 2.0, 3.0]), torch.tensor(True))


def _check(fvalid, labels, K, chunk):
    reps, slot_valid, npts, overflow, members = cluster_slots_sorted_plain(fvalid, labels, K,
                                                                          chunk)
    st = _plain(fvalid, labels, K)
    assert torch.equal(reps, st.reps)
    assert torch.equal(slot_valid, st.slot_valid)
    assert torch.equal(npts, st.npts)
    assert bool(overflow) == bool(st.cluster_overflow)
    for k, rep in enumerate(reps.tolist()):
        want = (torch.nonzero(fvalid & (labels == rep)).flatten() if rep != SENTINEL
                else torch.zeros(0, dtype=torch.int64))
        assert torch.equal(members[k], want), k
    return reps, overflow


@pytest.mark.parametrize("chunk", [None, 16, 7])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_schedule_matches_the_plain_version(case, chunk):
    fvalid, labels, K = _far_list(case)
    reps, overflow = _check(fvalid, labels, K, chunk)
    n_distinct = len(torch.unique(labels[fvalid]))
    assert bool(overflow) == (n_distinct > K)
    if case in ("exactly_k", "k_plus_1"):
        assert n_distinct == (K if case == "exactly_k" else K + 1)
    if case == "signed":
        assert reps[0] == -2**31


@pytest.mark.parametrize("chunk", [128, 256, 1000])
def test_chunked_schedule_labels_across_chunks(chunk):
    """The chunked path: labels first seen in a later chunk, every label in
    many chunks, more than K distinct; the port's plain version only (JAX's
    [F, F] compare is the plain version's)."""
    fvalid, labels, K = _far_list("chunked")
    reps, overflow = _check(fvalid, labels, K, chunk)
    assert bool(overflow) and len(torch.unique(labels[fvalid])) > K


@pytest.mark.parametrize("F,p_far,seed", [(256, 0.05, 0), (4096, 0.7, 1)])
def test_schedule_matches_the_jax_block(F, p_far, seed):
    """The far list of a grid scene through JAX's classify (its slots,
    reps, counts and overflow) and through the model, one launch and
    chunked."""
    shape, K = (8, 20, 24), 8
    rng = np.random.default_rng(seed)
    far = rng.random(shape) < p_far
    labels = rng.choice(rng.integers(0, 3840, 12), shape).astype(np.int32)
    jcfg = JConfig(max_clusters=K, max_far_voxels=F, max_queries=64, explore_submap=8,
                   confidence_submap=8)
    jo = j_classify_jit(jcfg, JDyn().as_arrays(), JGrid((0.0, 0.0, 0.0), shape, 0.5),
                        jnp.full(shape, -100.0, jnp.float32), jnp.asarray(far),
                        jnp.asarray(labels), jnp.bool_(True), jnp.asarray([1.0, 2.0, 1.0]),
                        jnp.bool_(True), jnp.bool_(True))
    fids, fvalid, _ = masked_compact_plain(torch.from_numpy(far), F)
    flab = torch.from_numpy(labels).reshape(-1)[fids.long()]
    for chunk in (None, 64):
        reps, slot_valid, npts, overflow, _ = cluster_slots_sorted_plain(fvalid, flab, K, chunk)
        assert np.array_equal(reps.numpy(), np.asarray(jo.reps))
        assert np.array_equal(slot_valid.numpy(), np.asarray(jo.cluster_valid))
        assert np.array_equal(npts.numpy(), np.asarray(jo.n_points))
        assert bool(overflow) == bool(jo.far_overflow)
    assert bool(overflow)  # 12 labels in K = 8 slots

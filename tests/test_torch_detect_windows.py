"""K10's window walk (csrc/detect.cu) on the CPU: the plain version
``pipeline.detect.detect_slots_plain`` against vofod_tpu's
``extract_detections`` (the bounds of tests/test_torch_classify_detect.py:
valid, ids and the counter equal, confidence within 0.2 % relative, pdet
and covariance within 1e-5) and its window sums (``window_sums_plain``)
bit for bit against a plain model of the kernel written out thread by
thread: a slot that keeps no confidence (not mav, or its window centre
outside the owned z rows) reads nothing; a slot that does walks only its
box ∩ window, a row on P lanes, each thread adding its voxels left to
right, then the shuffle tree in each warp and over the warps.

The cases are where the walk can go wrong: no mav slot, all 32 slots mav,
boxes clipped at each of the grid's six faces, boxes wider than the window
(also at CS = 40: 32 lanes a row and two x chunks), NaN AABB corners
(``to_int32`` maps them to 0), and a z window whose owned rows leave some
slots' centres outside (the grid-sharded step's slab)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.config import DynParams as JDyn, VoFODConfig as JConfig
from vofod_tpu.geometry import GridSpec as JGrid
from vofod_tpu.pipeline.classify import ClassifyOut as JClassifyOut
from vofod_tpu.pipeline.detect import extract_detections as j_extract
from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.pipeline.detect import (
    DET_WARPS, DetectConsts, detect_boxes, detect_slots_plain, window_sums_plain)

j_extract_jit = jax.jit(j_extract, static_argnums=(0, 2))

VOXEL = 0.5
INT_MAX = 2**31 - 1
SENSOR = np.array([3.5, 3.0, 2.5], np.float32)
DYN = dict(cls_min_points=2.0)


def _grids(shape, seed):
    """An air / unknown / ground field, far clumps and labels in which some
    far voxels carry the label of a slot (its members)."""
    rng = np.random.default_rng(seed)
    u = rng.random(shape)
    vals = np.where(u < 0.3, -900.0, np.where(u < 0.8, -500.0, -100.0)).astype(np.float32)
    vals += rng.uniform(-5.0, 5.0, shape).astype(np.float32)
    far = rng.random(shape) < 0.3
    labels = rng.integers(0, 6, shape).astype(np.int32)
    return vals, far, labels


def _slots(shape, K, seed, cls=None):
    """K random slots: boxes of 0.2-3 m anywhere in the grid (some reaching
    past it), labels 0-5, 0-30 points."""
    rng = np.random.default_rng(1000 + seed)
    ext = np.array(shape[::-1], np.float32) * VOXEL
    ctr = rng.uniform(-0.5, 1.0, (K, 3)).astype(np.float32) * ext
    half = rng.uniform(0.1, 1.5, (K, 3)).astype(np.float32)
    return dict(
        aabb_min=(ctr - half).astype(np.float32), aabb_max=(ctr + half).astype(np.float32),
        reps=rng.integers(0, 6, K).astype(np.int32),
        n_points=rng.integers(0, 30, K).astype(np.int32),
        cluster_class=(rng.integers(0, 3, K) if cls is None else np.full(K, cls)).astype(np.int32),
        obb_center=ctr.astype(np.float32),
    )


def _faces(shape, K, seed):
    """Six mav slots, each with a box against one face of the grid (its
    window reaches past it), then random slots."""
    s = _slots(shape, K, seed, cls=1)
    nz, ny, nx = shape
    ext = np.array([nx, ny, nz], np.float32) * VOXEL
    mid = 0.5 * ext
    for f in range(6):
        a, hi_side = f // 2, f % 2
        c = mid.copy()
        c[a] = ext[a] - 0.3 if hi_side else 0.3
        s["aabb_min"][f], s["aabb_max"][f] = c - 0.6, c + 0.6
        s["obb_center"][f] = c
    return s


def _wide(shape, K, seed, cs):
    """Mav slots whose boxes are wider than the CS³ window on every axis
    (points enough that the confidence stays above 0)."""
    s = _slots(shape, K, seed, cls=1)
    s["n_points"][:] = 2 * cs**3
    ext = np.array(shape[::-1], np.float32) * VOXEL
    w = (cs + 6) * VOXEL / 2
    for k in range(K):
        c = ext * (0.3 + 0.4 * k / K)
        s["aabb_min"][k], s["aabb_max"][k] = c - w, c + w
    return s


def _nan_corners(shape, K, seed):
    s = _slots(shape, K, seed, cls=1)
    s["aabb_min"][0, 0] = np.nan
    s["aabb_max"][1, 2] = np.nan
    s["aabb_min"][2] = np.nan
    s["aabb_max"][2] = np.nan
    return s


# name -> (grid shape, K, CS, slots(shape, K, seed))
CASES = {
    "no mav slot": ((10, 12, 14), 8, 8,
                    lambda sh, K, sd: _slots(sh, K, sd, cls=2)),
    "all 32 slots mav": ((10, 12, 14), 32, 8, lambda sh, K, sd: _slots(sh, K, sd, cls=1)),
    "boxes at the six faces": ((10, 12, 14), 8, 8, _faces),
    "boxes wider than CS": ((12, 20, 24), 8, 8, lambda sh, K, sd: _wide(sh, K, sd, 8)),
    "boxes wider than CS 40": ((8, 20, 48), 4, 40, lambda sh, K, sd: _wide(sh, K, sd, 40)),
    "NaN AABB corners": ((10, 12, 14), 8, 8, _nan_corners),
}


def kernel_model_sums(shape, cs, lo, hi, ctr, keep, vals, far, labels, reps, c, z_lo=0,
                      warps=DET_WARPS):
    """csrc/detect.cu's window sums written out thread by thread in numpy
    float32 (``lo``, ``hi``, ``ctr``: [K, 3] (x, y, z) index boxes)."""
    nz, ny, nx = shape
    f32 = np.float32
    out = np.zeros(len(keep), np.float32)
    half = cs // 2
    for k in np.flatnonzero(keep):
        b0 = [max(lo[k, a], ctr[k, a] - half) for a in range(3)]
        nw = [max(min(hi[k, a], ctr[k, a] - half + cs - 1) - b0[a] + 1, 0) for a in range(3)]
        R = nw[1] * nw[2]
        P = 1
        while P < nw[0] and P < 32:
            P *= 2
        G, C = 32 // P, -(-nw[0] // P)
        acc = np.zeros(32 * warps, np.float32)
        for t in range(32 * warps):
            w, lane = divmod(t, 32)
            s, xo = divmod(lane, P)
            r = w * G + s
            while r < R:
                for ch in range(C):
                    xoff = ch * P + xo
                    if xoff >= nw[0]:
                        continue
                    gz, gy, gx = b0[2] + r // nw[1], b0[1] + r % nw[1], b0[0] + xoff
                    lz = gz - z_lo
                    v, fv, lab = f32(0.0), False, INT_MAX
                    if 0 <= gx < nx and 0 <= gy < ny and 0 <= gz < nz and 0 <= lz < vals.shape[0]:
                        v, fv, lab = vals[lz, gy, gx], bool(far[lz, gy, gx]), labels[lz, gy, gx]
                    v_eff = f32(c.score) if (fv and lab == reps[k]) else v
                    acc[t] = acc[t] + (f32(1.0) - v_eff * f32(c.inv_score))
                r += warps * G

        def shfl_tree(x, width):  # lane l += lane l + o (its own value past the warp)
            x = x.copy()
            o = width // 2
            while o > 0:
                x = np.array([x[i] + (x[i + o] if i + o < 32 else x[i]) for i in range(32)],
                             np.float32)
                o //= 2
            return x[0]

        part = [shfl_tree(acc[32 * w:32 * (w + 1)], 32) for w in range(warps)]
        out[k] = shfl_tree(np.array(part + [0.0] * (32 - warps), np.float32), warps)
    return out


@functools.lru_cache(maxsize=None)
def _case(name, seed):
    shape, K, cs, make = CASES[name]
    vals, far, labels = _grids(shape, seed)
    s = make(shape, K, seed)
    cfg, dyn = VoFODConfig(max_clusters=K, confidence_submap=cs), DynParams(**DYN)
    grid = GridSpec((0.0, 0.0, 0.0), shape, VOXEL)
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    args = (grid, cs, DetectConsts.make(cfg, dyn), torch.from_numpy(vals), torch.from_numpy(far),
            torch.from_numpy(labels), t["aabb_min"], t["aabb_max"], t["reps"], t["n_points"],
            t["cluster_class"], t["obb_center"], torch.from_numpy(SENSOR),
            torch.tensor(5, dtype=torch.int32))
    return shape, K, cs, vals, far, labels, s, args


def _jax(shape, K, cs, vals, far, labels, s):
    z = lambda *sh: jnp.zeros(sh, jnp.float32)  # noqa: E731
    jo = JClassifyOut(
        grid=jnp.asarray(vals), cluster_valid=jnp.asarray(s["cluster_class"] > 0),
        cluster_class=jnp.asarray(s["cluster_class"]), n_points=jnp.asarray(s["n_points"]),
        aabb_min=jnp.asarray(s["aabb_min"]), aabb_max=jnp.asarray(s["aabb_max"]),
        obb_center=jnp.asarray(s["obb_center"]), obb_axes=z(K, 3, 3), obb_extent=z(K, 3),
        obb_size=z(K), reps=jnp.asarray(s["reps"]), labels=jnp.asarray(labels),
        n_far=jnp.int32(0), far_overflow=jnp.bool_(False), labels_converged=jnp.bool_(True))
    cfg = JConfig(max_clusters=K, confidence_submap=cs)
    return j_extract_jit(cfg, JDyn(**DYN).as_arrays(), JGrid((0.0, 0.0, 0.0), shape, VOXEL),
                         jnp.asarray(vals), jnp.asarray(labels), jnp.asarray(far), jo,
                         jnp.asarray(SENSOR), jnp.int32(5))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(CASES))
def test_detect_slots_plain_matches_jax(name, seed):
    shape, K, cs, vals, far, labels, s, args = _case(name, seed)
    valid, ids, conf, pdet, cov, counter = detect_slots_plain(*args)
    jd, jc = _jax(shape, K, cs, vals, far, labels, s)
    assert np.array_equal(valid.numpy(), np.asarray(jd.valid))
    assert np.array_equal(ids.numpy(), np.asarray(jd.id)) and int(counter) == int(jc)
    np.testing.assert_allclose(conf.numpy(), np.asarray(jd.confidence), rtol=2e-3, atol=1e-12)
    np.testing.assert_allclose(pdet.numpy(), np.asarray(jd.detection_probability), rtol=1e-5,
                               atol=1e-7)
    v = valid.numpy()
    np.testing.assert_allclose(cov.numpy()[v], np.asarray(jd.covariance)[v], rtol=1e-5, atol=1e-7)
    if name == "no mav slot":
        assert not v.any() and (conf.numpy() == 0).all()
    else:
        assert v.any() and (conf.numpy()[v] > 0).all()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(CASES))
def test_window_sums_match_the_kernel_model(name, seed):
    shape, K, cs, vals, far, labels, s, args = _case(name, seed)
    grid, c = args[0], args[2]
    lo, hi, ctr = detect_boxes(grid, args[6], args[7])
    keep = args[10] == 1
    got = window_sums_plain(lo, hi, ctr, cs, shape, *args[3:6], args[8], c, keep).numpy()
    want = kernel_model_sums(shape, cs, lo.numpy(), hi.numpy(), ctr.numpy(), keep.numpy(),
                             vals, far, labels, s["reps"], c)
    assert got.tobytes() == want.tobytes()
    assert (got[~keep.numpy()] == 0).all()
    if name == "NaN AABB corners":  # NaN corners read as index 0, inflated to [0, 2]
        assert lo[2].tolist() == [0, 0, 0] and hi[2].tolist() == [2, 2, 2]
    if name == "boxes wider than CS":  # every read slot walks its full CS³ window
        n = (torch.minimum(hi, ctr - cs // 2 + cs - 1) - torch.maximum(lo, ctr - cs // 2) + 1)
        assert (n[keep] == cs).all()


@pytest.mark.parametrize("own", [(0, 4), (4, 10), (3, 6)])
def test_z_window_keeps_only_the_owned_centres(own):
    """The grid step's slab: the rows [z_lo, z_lo + rows) of the grid, the
    window centres in [own_z0, own_z1) keeping their confidence.  An owned
    slot's confidence equals the full grid's bit for bit when the slab
    holds its window's rows; every other slot gives 0; the sums match the
    kernel model reading the slab."""
    shape, K, cs, vals, far, labels, s, args = _case("all 32 slots mav", 0)
    grid, c = args[0], args[2]
    z_lo = max(own[0] - cs // 2, 0)
    z_hi = min(own[1] + cs - cs // 2, shape[0])
    slab = [torch.from_numpy(a[z_lo:z_hi].copy()) for a in (vals, far, labels)]
    window = (shape[0], z_lo, *own)
    got = detect_slots_plain(args[0], cs, c, *slab, *args[6:], window)
    full = detect_slots_plain(*args)
    lo, hi, ctr = detect_boxes(grid, args[6], args[7])
    owned = ((ctr[:, 2] >= own[0]) & (ctr[:, 2] < own[1])).numpy()
    assert 0 < owned.sum() < K
    assert torch.equal(got[2][owned], full[2][owned]) and (got[2][~owned] == 0).all()
    for a, b in zip(got[:2] + got[3:], full[:2] + full[3:]):
        assert torch.equal(a, b)
    keep = torch.from_numpy(owned)
    sums = window_sums_plain(lo, hi, ctr, cs, shape, *slab, args[8], c, keep, z_lo)
    want = kernel_model_sums(shape, cs, lo.numpy(), hi.numpy(), ctr.numpy(), owned,
                             *(a.numpy() for a in slab), s["reps"], c, z_lo)
    assert sums.numpy().tobytes() == want.tobytes()

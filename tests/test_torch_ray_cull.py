"""K5b's cull (csrc/ray_update.cu) on the CPU: its plain model
``ops.raycast.ray_cull_plain`` — the tile test with its one-voxel margin,
then the range, the point flag, T and the FOV, in the kernel's order — and
the update through it (``_culled_update``), held to the plain version
``ray_window_update_plain_``.

Two assertions a case.  Every voxel the cull drops (and that had no point
this scan) has a ``ray_window_plain`` raylen of 0 or below or NaN, so the
EMA would not change it; under the old rule's first pass, which culls by
neither the point flag nor T, exactly 0, so the window max is the plain
version's, NaN included.  And the update through the cull equals the plain
update bit for bit.  The tile test is also held conservative: no voxel of
a culled tile is within range.

The cases cover both rules, its_diff 1 and 2, gated and ungated, poses
rolled and pitched up to 60°, the window clamped at x0 = y0 = 0 and at nx -
wx, ny - wy, T6 holding zeros and NaN, and faces holding NaN."""

import math

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.ops import raycast as tr

SHAPE, VOXEL = (16, 56, 60), 0.5
MAX_D = 8.0  # 16 voxels: corner tiles of the 49-voxel window lie past it
V_FOV, V_RAYS, H_RAYS = math.radians(90.0), 32, 256
SCORE_RAY = -1000.0


def _rot(yaw: float, pitch: float, roll: float) -> np.ndarray:
    cy, sy, cp, sp, cr, sr = (np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch),
                              np.cos(roll), np.sin(roll))
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return (Rz @ Ry @ Rx).astype(np.float32)


# sensor positions (m): the window centred, clamped at x0 = y0 = 0, and at
# nx - wx, ny - wy
WHERE = {"centre": (15.2, 13.9, 2.3), "low corner": (1.3, 0.8, 0.6),
         "high corner": (29.1, 27.6, 6.9)}
# name -> (new rule, its_diff, gated, sensor, (yaw, pitch, roll) deg, T6 special, NaN faces)
CASES = {
    "new rule, level": (True, 1.0, True, "centre", (0, 0, 0), None, False),
    "new rule, its 2, ungated": (True, 2.0, False, "centre", (30, 0, 0), None, False),
    "new rule, pitched 60": (True, 1.0, True, "centre", (10, 60, 0), None, False),
    "new rule, rolled 60, low corner": (True, 1.0, True, "low corner", (-40, 0, 60), None,
                                        False),
    "new rule, tilted, high corner": (True, 2.0, True, "high corner", (100, -45, 50), None,
                                      False),
    "new rule, T6 zeros and NaN": (True, 1.0, True, "centre", (0, 20, -20), "zeros+nan", False),
    "new rule, NaN faces": (True, 1.0, True, "low corner", (0, -30, 10), "zeros", True),
    "old rule, level": (False, 1.0, True, "centre", (0, 0, 0), None, False),
    "old rule, its 2, ungated, high corner": (False, 2.0, False, "high corner", (60, 0, -60),
                                              "zeros", False),
    "old rule, pitched 60, low corner": (False, 1.0, True, "low corner", (0, 60, 0), None,
                                         False),
    "old rule, T6 zeros and NaN": (False, 2.0, True, "centre", (20, -10, 30), "zeros+nan",
                                   False),
    "old rule, NaN faces": (False, 1.0, True, "high corner", (0, 45, 45), "zeros", True),
}


def _inputs(name, seed=0):
    new_rule, its, gated, where, ypr, t6_special, nan_faces = CASES[name]
    rng = np.random.default_rng(seed)
    grid = GridSpec((0.0, 0.0, 0.0), SHAPE, VOXEL)
    x0, y0, rel_x, rel_y, rel_z = tr._window_rel(grid, np.array(WHERE[where], np.float32),
                                                 MAX_D, torch.device("cpu"))
    nz, wy, wx = SHAPE[0], rel_y.shape[0], rel_x.shape[0]
    T6 = rng.uniform(0.0, 1.0, (6, nz, wy, wx)).astype(np.float32)
    if t6_special:
        T6[rng.random(T6.shape) < 0.3] = 0.0
    if t6_special == "zeros+nan":
        T6[rng.random(T6.shape) < 0.02] = np.nan
    faces = None
    if gated:
        faces = rng.uniform(0.0, 1.0, (6, 8, 8)).astype(np.float32)
        if nan_faces:
            faces[rng.random(faces.shape) < 0.05] = np.nan
        faces = torch.from_numpy(faces)
    vals = rng.uniform(-900.0, -100.0, SHAPE).astype(np.float32)
    had = rng.random(SHAPE) < 0.1
    rot = torch.from_numpy(_rot(*np.deg2rad(ypr)))
    c = tr.RayConsts.make(VOXEL, MAX_D, V_FOV, V_RAYS, H_RAYS)
    coef = float(np.float32(0.003) / np.float32(math.sqrt(3.0) * VOXEL))
    ema = tr.RayEma(new_rule, coef, float(np.float32(its)), float(np.float32(0.003)),
                    float(np.float32(SCORE_RAY)))
    return (torch.from_numpy(vals), torch.from_numpy(had), torch.from_numpy(T6), faces, rel_x,
            rel_y, rel_z, rot, x0, y0, c, ema)


def _culled_update(vals, had, T6, faces, rel_x, rel_y, rel_z, rot, x0, y0, c, ema):
    """K5b through its cull, in place on the window of ``vals``: the raylen
    of ``ray_window_plain`` where a voxel passes every test of
    ``ray_cull_plain`` and 0 where the kernel drops it, then the ray EMA
    (under the old rule the max over that raylen, as the kernel's first
    pass takes it)."""
    wy, wx = rel_y.shape[0], rel_x.shape[0]
    win = (slice(None), slice(y0, y0 + wy), slice(x0, x0 + wx))
    reach = tr.ray_cull_plain(T6, had[win], rel_x, rel_y, rel_z, rot, c, ema.new_rule)["fov"]
    raylen = torch.where(reach, tr.ray_window_plain(T6, faces, rel_x, rel_y, rel_z, rot, c), 0.0)
    vals[win] = tr.ray_ema_plain(vals[win], raylen, had[win], ema)
    return vals


@pytest.mark.parametrize("name", list(CASES))
def test_cull_drops_only_voxels_the_ema_leaves(name):
    vals, had, T6, faces, rel_x, rel_y, rel_z, rot, x0, y0, c, ema = _inputs(name)
    new_rule, _, _, where, *_ = CASES[name]
    wy, wx = rel_y.shape[0], rel_x.shape[0]
    nx, ny = SHAPE[2], SHAPE[1]
    assert {"centre": (0 < x0 < nx - wx and 0 < y0 < ny - wy),
            "low corner": x0 == 0 and y0 == 0,
            "high corner": x0 == nx - wx and y0 == ny - wy}[where]
    had_w = had[:, y0:y0 + wy, x0:x0 + wx]
    m = tr.ray_cull_plain(T6, had_w, rel_x, rel_y, rel_z, rot, c, new_rule)
    raylen = tr.ray_window_plain(T6, faces, rel_x, rel_y, rel_z, rot, c)

    # the tile test is conservative: nothing of a culled tile is in range
    X, Y, Z = rel_x[None, None, :], rel_y[None, :, None], rel_z[:, None, None]
    d = torch.sqrt((X * c.vs) ** 2 + (Y * c.vs) ** 2 + (Z * c.vs) ** 2)
    assert not bool(((d <= c.max_d) & ~m["tile"]).any())
    assert bool((~m["tile"]).any()), "no tile culled"
    culled = ~m["fov"]
    if new_rule:
        drop = culled & ~had_w
        assert bool(((raylen[drop] <= 0) | torch.isnan(raylen[drop])).all())
    else:  # the first pass's cull keeps the window max: raylen exactly 0
        assert bool((raylen[culled] == 0).all())
    assert 0 < int(m["fov"].sum()) < int(m["range"].sum())

    a = _culled_update(vals.clone(), had, T6, faces, rel_x, rel_y, rel_z, rot, x0, y0, c, ema)
    b = tr.ray_window_update_plain_(vals.clone(), had, T6, faces, rel_x, rel_y, rel_z, rot, x0,
                                    y0, c, ema)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert bool((b != vals).any()), "the EMA changed nothing"


def test_cull_stages_each_drop_voxels():
    """Each of the cull's tests drops voxels the earlier ones kept on the
    cases above (new rule), so each is exercised."""
    dropped = dict.fromkeys(("range", "had", "T", "fov"), 0)
    order = ("tile", "range", "had", "T", "fov")
    for name in CASES:
        vals, had, T6, faces, rel_x, rel_y, rel_z, rot, x0, y0, c, ema = _inputs(name)
        if not ema.new_rule:
            continue
        wy, wx = rel_y.shape[0], rel_x.shape[0]
        m = tr.ray_cull_plain(T6, had[:, y0:y0 + wy, x0:x0 + wx], rel_x, rel_y, rel_z, rot, c,
                              True)
        for prev, k in zip(order, order[1:]):
            dropped[k] += int((m[prev] & ~m[k]).sum())
    assert all(v > 0 for v in dropped.values()), dropped

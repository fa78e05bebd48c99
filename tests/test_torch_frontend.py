"""K3 parity: the frontend (range x LUT, exclude box, pose, oparea crop,
histogram, airframe blockers) against vofod_tpu's ``run_frontend``.

Counts, blockers, ``n_valid_points`` and ``n_exclude_hits`` are integers and
bools: bit-equal, on scans with NaN and zero ranges, more than the 4096
compacted airframe hits, and a rotated pose.  The port computes the point
transform elementwise in a fixed order (geometry.se3_apply; the CUDA kernel
uses the same roundings), so a point near a voxel face lands in the same
voxel as in JAX for these scans.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vofod_tpu.config import Box as JBox, SensorConfig as JSensor, VoFODConfig as JConfig
from vofod_tpu.geometry import GridSpec as JGrid
from vofod_tpu.pipeline.frontend import run_frontend as j_run_frontend
from vofod_tpu.sensor import make_lut_simulation
from vofod_tpu_torch.config import Box, SensorConfig, VoFODConfig
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.pipeline.frontend import run_frontend

H, W = 64, 128  # 8192 pixels: room for more than 4096 airframe hits


def _configs():
    kw = dict(voxel_size=0.5)
    j = JConfig(sensor=JSensor(vertical_rays=H, horizontal_rays=W),
                oparea=JBox((0.0, 0.0, 3.0), (20.0, 16.0, 8.0)), **kw)
    t = VoFODConfig(sensor=SensorConfig(vertical_rays=H, horizontal_rays=W),
                    oparea=Box((0.0, 0.0, 3.0), (20.0, 16.0, 8.0)), **kw)
    return j, t


def _pose(yaw, pitch, xyz):
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rz @ Ry
    T[:3, 3] = xyz
    return T


def _scan(kind, seed):
    rng = np.random.default_rng(seed)
    r = rng.uniform(300.0, 14000.0, H * W).astype(np.float32)
    r[rng.random(H * W) < 0.1] = 0.0  # no return
    if kind == "nan":
        r[rng.random(H * W) < 0.05] = np.nan
    if kind == "airframe":
        # >4096 returns inside the own-airframe box: the cap must clip them
        r[: 5000] = rng.uniform(100.0, 600.0, 5000)
    pose = _pose(0.3 * seed, 0.1 if kind == "rotated" else 0.0, (0.7, -0.4, 3.2))
    return r, pose


def _run_both(kind, seed):
    jcfg, tcfg = _configs()
    lut = make_lut_simulation(W, H, jcfg.sensor.vertical_fov)
    r, pose = _scan(kind, seed)
    jo = j_run_frontend(jcfg, JGrid.from_config(jcfg), jnp.asarray(lut.directions),
                        jnp.asarray(lut.offsets), jnp.asarray(r), jnp.asarray(pose))
    to = run_frontend(tcfg, GridSpec.from_config(tcfg), torch.from_numpy(lut.directions),
                      torch.from_numpy(lut.offsets), torch.from_numpy(r),
                      torch.from_numpy(pose))
    return jo, to


@pytest.mark.parametrize("kind", ["plain", "nan", "airframe", "rotated"])
@pytest.mark.parametrize("seed", [1, 2])
def test_run_frontend_bit_equal(kind, seed):
    jo, to = _run_both(kind, seed)
    assert np.array_equal(to.counts.numpy(), np.asarray(jo.counts))
    assert np.array_equal(to.blockers.numpy(), np.asarray(jo.blockers))
    assert int(to.n_valid_points) == int(jo.n_valid_points)
    assert int(to.n_exclude_hits) == int(jo.n_exclude_hits)
    assert int(to.counts.sum()) > 0
    if kind == "airframe":
        assert int(to.n_exclude_hits) > 4096

"""K5a's support walk (csrc/ray_gate.cu) on the CPU: its plain model
``ops.raycast.gate_faces_support_plain`` — the weight sum and the column
products over the columns of each texel's tent support alone, ascending —
held bit-equal (``torch.equal``) to ``gate_faces_plain``, which sums over
every pooled column, and within the tolerance of tests/test_torch_raycast.py
(5e-5: float32 trig of two libraries) of vofod_tpu's ``gate_faces``.

The cases are where the support can go wrong: the flagship gate (a column
period of 127.875 pooled columns, not a whole number), a pitched and rolled
pose, the calibrated LUT's row table, the simulation LUT (period 63 of 64
columns: the duplicated seam column), periods cut to 100.37 and 2.5 columns
(three or four columns nonzero), and texels forced onto the seam (the wrap
column after column 0) and outside the vertical FOV."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu import sensor as jsensor
from vofod_tpu.config import VoFODConfig as JConfig
from vofod_tpu.ops import raycast as jr
from vofod_tpu_torch.ops import raycast as tr

JAX_TOL = 5e-5  # tests/test_torch_raycast.py gate_faces


def _rot(yaw: float, pitch: float, roll: float) -> np.ndarray:
    cy, sy, cp, sp, cr, sr = (np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch),
                              np.cos(roll), np.sin(roll))
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return (Rz @ Ry @ Rx).astype(np.float32)


def _flagship():
    return jsensor.make_lut(JConfig().sensor)


def _calibrated():
    H, W = 128, 1024
    u = np.linspace(-1.0, 1.0, H)
    return jsensor.make_lut_ouster(W, H, 3.0 * np.sin(np.linspace(0, 2 * np.pi, H)),
                                   -22.5 * np.sign(u) * np.abs(u) ** 1.3, 15.806)


def _edge_texels(gate) -> np.ndarray:
    """The gate's face texels with the first ones replaced by directions on
    the seam (pooled column 0, just past it, just before the period, at
    half a column from it) at the middle row, and two pooled rows past the
    top and bottom rows, straight up and straight down (outside the
    vertical FOV)."""
    x = np.array([0.0, 1e-4, 0.5, gate.col_period - 1e-4, gate.col_period - 0.5,
                  gate.col_period - 1.0, -0.5])
    col = (x + 0.5) * gate.pool_h - 0.5  # the inverse of the kernel's column map
    az = gate.az_b + gate.az_a * col
    el = gate.el_b + gate.el_a * (0.5 * gate.pool_v * gate.n_rows)
    seam = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                     np.full_like(az, np.sin(el))], -1)
    H = gate.pool_v * gate.n_rows  # two pooled rows past either edge
    top = gate.el_b + gate.el_a * np.array([-2.0 * gate.pool_v, H - 1.0 + 2.0 * gate.pool_v])
    off_fov = np.stack([np.cos(top), np.zeros(2), np.sin(top)], -1)
    extra = np.concatenate([seam, off_fov, [[0, 0, 1.0], [0, 0, -1.0]]]).astype(np.float32)
    dirs = gate.face_dirs.reshape(-1, 3).copy()
    dirs[:len(extra)] = extra / np.linalg.norm(extra, axis=-1, keepdims=True)
    return dirs.reshape(gate.face_dirs.shape)


# (lut, image density, rotation (yaw, pitch, roll), gate change)
CASES = {
    "flagship": (_flagship, 1.0, (0.0, 0.0, 0.0), None),
    "flagship random": (_flagship, 0.7, (0.3, 0.0, 0.0), None),
    "pitched and rolled": (_flagship, 0.7, (0.7, 0.3, -0.2), None),
    "calibrated row table": (_calibrated, 0.7, (0.7, 0.3, -0.2), None),
    "simulation LUT": (lambda: jsensor.make_lut_simulation(64, 16, np.deg2rad(90.0)), 0.6,
                       (-1.2, 0.2, 0.1), None),
    "period 100.37": (_flagship, 0.7, (2.0, -0.1, 0.0), dict(col_period=100.37)),
    "period 2.5": (lambda: jsensor.make_lut_simulation(24, 16, np.deg2rad(90.0)), 0.6,
                   (0.4, 0.1, 0.0), dict(col_period=2.5)),
    "seam and outside the FOV": (_flagship, 0.7, (0.0, 0.0, 0.0), "edges"),
    "seam, simulation LUT": (lambda: jsensor.make_lut_simulation(64, 16, np.deg2rad(90.0)),
                             0.6, (0.0, 0.0, 0.0), "edges"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_support_walk_bit_equal(name):
    make, density, angles, change = CASES[name]
    lut = make()
    gate = jr.make_angular_gate(lut)
    if change == "edges":
        gate = gate._replace(face_dirs=_edge_texels(gate))
    elif change:
        gate = gate._replace(**change)
    rng = np.random.default_rng(len(name))
    active = rng.random((lut.height, lut.width)) < density
    R = _rot(*angles)
    fd = torch.from_numpy(gate.face_dirs.reshape(-1, 3))
    args = (gate, fd, torch.from_numpy(active), torch.from_numpy(R))
    plain = tr.gate_faces_plain(*args)
    walk = tr.gate_faces_support_plain(*args)
    assert torch.equal(walk, plain)
    # the support holds every column of nonzero weight, ascending, each once
    _, _, g_c = tr._gate_coords(*args, None if gate.el_rows is None else
                                tr.row_table(gate, "cpu"))
    cols, first = tr.gate_tent_support(gate, g_c)
    kc = torch.arange(gate.n_cols, dtype=torch.float32)
    nonzero = tr._col_weight(g_c[:, None], float(np.float32(gate.col_period)), kc[None, :]) > 0
    held = torch.zeros(nonzero.shape, dtype=torch.int32).scatter_add_(1, cols, first.int()) > 0
    assert not bool((nonzero & ~held).any())
    assert bool((cols[:, 1:] > cols[:, :-1])[first[:, 1:]].all())
    with jax.default_matmul_precision("highest"):
        jf = np.asarray(jr.gate_faces(gate, jnp.asarray(active), jnp.asarray(R)))
    np.testing.assert_allclose(walk.numpy(), jf, atol=JAX_TOL, rtol=0)
    if change == "edges":
        n_edge = 11
        assert float(walk.reshape(-1)[7:n_edge].abs().max()) == 0.0  # outside the FOV
        assert float(walk.reshape(-1)[:7].min()) > 0.0  # the seam texels see the image

"""vofod_tpu_torch — the PyTorch / CUDA port of vofod_tpu.

The production single-stream step of the JAX package, in PyTorch, with
hand-written CUDA kernels (csrc/): the Euclidean-ball pool (K1), the fused
label/reach propagation sweep (K2), the frontend binning scatter (K3), the
six-cone transmittance sweep (K4), and the classify stage's stream
compaction (K6), explore BFS (K7), demotion write-back (K8) and cluster
statistics (K9).  Module and
function names follow ``vofod_tpu`` so each counterpart sits at the same
path; grids keep the JAX layout (nz, ny, nx).  Nothing here imports JAX.
"""

from vofod_tpu_torch.config import DynParams, VoFODConfig, load_config
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.pipeline.state import VoFODState, init_state
from vofod_tpu_torch.pipeline.step import make_step_fn
from vofod_tpu_torch.runtime.node import VoFOD

__version__ = "0.1.0"

__all__ = [
    "VoFODConfig",
    "DynParams",
    "load_config",
    "GridSpec",
    "VoFODState",
    "init_state",
    "make_step_fn",
    "VoFOD",
]

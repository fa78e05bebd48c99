"""vofod_tpu_torch — the PyTorch / CUDA port of vofod_tpu.

The JAX package's step, node and serving runtime in PyTorch, with
hand-written CUDA kernels (csrc/, one ctypes library for sm_90a; the
kernel set K1-K15 of ROADMAP.md).  Every path of the JAX step runs on
them: the production sweep path (K3 binning, K1 ball pools, K2 label /
reach sweeps, K11 point and demotion EMAs, K6 compaction, K9 cluster
statistics, K7 explore and K8 demotions, K10 detections, K5a gate, K4
cone sweep, K5b ray update), the prebinned ingest (K15a), dynamic radii
(K14), the reference-exact mode (K12 DDA, K13 census) with the
sequential explore (K7s), and the grid-sharded step over z shards
(parallel/, K15b).  ``runtime/node.VoFOD`` serves one sensor stream,
``runtime/fleet.FleetVoFOD`` many on one device (each stream's step in
turn, one host sync a tick), fed by ``runtime/stream.StreamRunner`` or
``tools/serve_fleet``.  Module and function names follow ``vofod_tpu`` so
each counterpart sits at the same path; grids keep the JAX layout (nz, ny,
nx).  Nothing here imports JAX.
"""

from vofod_tpu_torch.config import DynParams, VoFODConfig, load_config
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.pipeline.state import VoFODState, init_state
from vofod_tpu_torch.pipeline.step import make_step_fn
from vofod_tpu_torch.runtime.fleet import FleetVoFOD
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
    "FleetVoFOD",
]

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vofod_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits non-zero:

0. require CUDA; print the card's name and power limit (nvidia-smi) and
   pin float32 matmuls and convolutions to full precision (no TF32);
1. build the CUDA kernels from csrc/ and, beside them, the native host
   binner (native/*.cpp, g++); print the build time;
2. hold each kernel against its plain PyTorch version on the card, on
   inputs taken from a real flagship scan (OS0-128, 241x201x51 grid): K1-K3
   bit-equal, K4 within one bf16 ulp at 1.0; CUDA-event times of both.
   K1's run-table kernel also on the flagship grid where it can go wrong
   (phase 2-k1-cases: fills that are not the op's identity, an int32 sum
   past 2^31, fewer planes than 2 h + 1, a 23-plane slab, a grid no
   multiple of the tile, rows misaligned in memory, tap sets with gaps
   inside rows up to 2,112 taps at halo 7, the asymmetric hasCloseTo box),
   each bit-equal; its two sweep-path calls with device ms (torch.profiler)
   and each call's own bound, beside one F.conv3d of the 0/1 sure grid.
   K2's persistent launch (one per ``sweeps()`` call) in grid, per-sweep
   flags and tiles computed per sweep against the plain sweeps and the
   plain model of its schedule: the scan's 8 label sweeps at r3 and 8
   reach sweeps at r2, a fixpoint at sweep 0, a grid no multiple of the
   tile, each timed; the seeded labels, reach, converged and iters.  K4
   on the scan's window, the sensor 4 m from an edge, a window clipped by
   the grid (60 m bound), A rows no multiple of the cluster,
   all opaque and all clear: bit-equal (no voxel differs), with their
   times and the cluster size.
   The classify stage's kernels on the same scan's classify inputs and on
   synthetic cases: K6 (the three compactions, the label-predicate form,
   an overflow, the far mask and the query form from views at byte
   offsets 1, 7 and 15, a mask of more tiles than the card holds resident)
   bit-equal, one launch and no memset a call; K7 (the scan's queries, 256 valid queries over
   a random air/unknown/ground field, a serpentine corridor capped at 8
   sweeps, 32 of the queries at S = 16 and 62) and K8 (demotion of the
   random batch) bit-equal; K9 (the scan's far list, a synthetic far set of
   48 clusters, degenerate ones included, and synthetic far lists of
   F = 8192, sorted in one block, and F = 20000, past the one-block sort on
   the chunked path, with > K clusters, long label ties and slots spanning
   chunks) integers, bools and AABB bit-equal, floats within K9_TOL (OBB
   axes up to their sign, with sign flips counted).  The other stages' kernels on the
   same scan: K5a (the scan's image, the returns only, a random image
   under a pitched pose, a calibrated LUT, the random image from a view at
   byte offset 1 and a 1000-column LUT, both pooled byte by byte) within
   K5A_TOL, one launch and no memset a call; K5b (the scan's
   window, both update rules, its_diff 1 and 2, kernel and plain version
   on separate clones of the grid; under both rules the sensor in the low
   and the high grid corner, the window clamped there, a pose pitched 52
   and rolled -40 degrees, T6 holding NaN and faces holding NaN) with the
   changed voxels bit-equal and the grid within K5B_TOL_REL x |score_ray|,
   its tile the cull model's RAY_TILE;
   K10 (the scan's slots, synthetic slots in two grid corners and on an
   edge, the synthetic slots all mav and none mav) with ids, valid, the
   counter and confidence bit-equal (its warps the plain version's
   DET_WARPS), pdet and covariance within K10_RTOL; K11 (the point EMA of the scan and of
   random counts; the demotion EMA with sure_sufficient True and False, on
   random masks, in one corner only (blocks that skip their pool beside
   blocks that pool) and on a grid path's slab of 17 + 2 planes; with the
   schedule the card chose) bit-equal.  The reference-exact path's kernels on a flagship exact scan
   (exact census, hasCloseTo box, counted indexing) and synthetic cases:
   K1's hasCloseTo tap set bit-equal; K12's walk (the scan's rays, and as
   many rays from the sensor in random directions, each warp diverging at
   once) with the same nonzero
   voxels as the plain version's sequential sum on the host, raylen within
   K12_RAYLEN_RTOL of it and, in five walks, within one float32 ulp of the
   float64 sum of the same chords, K15b-6c's three slabs of the random
   directions bit-equal to K12's rows, its EMA pass (both rules, its_diff 1 and 2)
   bit-equal on the kernel's raylen and within K5B_TOL_REL x |score_ray|
   after walk and EMA, and under the old rule on a raylen field holding a
   NaN (every voxel the EMA reaches turns NaN, as in the plain version's
   ``torch.max``); K2 run to convergence (the scan's coarse cells, a
   random field that converges, isolated voxels whose first sweep is the
   fixpoint, a serpentine corridor where the 128-sweep cap binds; each
   call's grid, flags and tiles per sweep too), K13b (the
   scan's grids; random fields at leaf sizes 1-4; no bg, all bg, a single
   bg voxel; a grid whose columns and cells take more look-back tiles than
   the card holds resident; each also equal to the column-walk model
   ``quirk_counts_columnwalk_plain``), K13a and K13c (sure_sufficient True
   and False; also at leaf sizes 2 and 3, on the scan's coarse cells and on
   random ones, boundary cells whose centres lie outside the grid included;
   with the schedules) bit-equal.  K13b and K15b-6b also report their device-kernel
   ms, kernel launches and memsets a call (torch.profiler) beside the
   CUDA-event mean.  The prebinned ingest on a
   flagship scan: K15a bit-equal to its plain version on the native
   binner's packed grid, whose counts (clamped to 63) and blockers are
   bit-equal to K3's and the raw frontend's, its device ms beside the two
   torch ops'; the host bin's p50/p95 over the cycle and the packed
   upload's time.  The stencils past 256 taps:
   K1 at radius 4, 5, 6 and 7.99 (257 to 2,103 taps, int32 tiles past 48 KB
   of shared memory from halo 6), K2 at 4, 5 and 7.99, K11's demotion at 4,
   5 and 7.99 and on the dynamic path's shells at 2.0 / 1.9 m (on the
   scan's masks and random ones, the flagship grid and a slab of 17 + 2h
   planes, with the schedules and device ms), and K14's shell pools at the
   dynamic path's tap sets, all
   bit-equal, K14's two calls at the dynamic path's 2.0 / 1.9 m radii with
   device ms and their bounds, beside one F.conv3d of the 0/1 sure grid;
   K5b without faces (the ungated sweep) within K5b's bounds.
   K7s, the sequential explore, bit-equal on the grid, the clusters'
   connected flags and the write count to its plain version (a host loop
   over K7's and K8's plain versions): the classify inputs of a flagship
   sequential-explore scan with valid queries, the adversarial scene of
   tests/test_sequential_demotion.py in the flagship grid (floating, every
   carved cell demoted), 256 valid queries in 32 clusters over a random
   field, the same under query overflow, and no valid query.  Phase
   2-grid: the grid-sharded step's kernels with 3 shards of the flagship
   grid on the card, each bit-equal to its plain version: K15b-1 (halo
   exchange) on f32 / int32 / bool / uint8 slabs at r 1-40 (multi-hop past
   every shard), out of place and in place, also equal to the rows cut
   from the whole grid, and on a segment past the resident blocks; its
   in-place fills at the sharded sweeps' shapes and the r 16 exchange
   timed (CUDA events, device ms and launches, bound, torch.cat); K2's
   batched launches (SWEEP_BATCH sweeps a launch on a halo of their reach,
   the 3 shards' launches concurrent on their streams) beside the same
   schedule with their plain model: slab, flags and tiles per sweep
   bit-equal, also past one slab's rows (multi-hop), with a short last
   launch, the shells and a corridor where the cap binds, slabs and flags
   equal to the dense K2's, one launch timed;
   K15b-2 (fold-min) at r 16 and 20, equal to the min over every shard's
   stamp; K15b-3 (the x/y cones) and K15b-4b (the transposed z cones),
   CONE_BATCH planes a launch on K4's clusters over a halo of the planes'
   reach, launch by launch beside their plain versions at CONE_BATCH and at
   16 planes a launch (halo refills between launches), and K15b-4a (each
   shard's kept z cones on clusters) round by round, through the sharded
   sweeps of a flagship scan, T equal to K4's, and the sharded K4 + K5b
   equal to the dense update under both rules (phase 2-grid-cones: the
   launches a shard).  Then the reference-exact grid path's kernels on a flagship
   exact scan, 3 shards, each beside its plain version on the same
   received blocks and against the dense kernel: K15b-6b's three entries
   (equal to K13b; also with no bg and all bg), K2's sharded label components (labels, converged and
   sweeps equal to the dense ones), K15b-6a's two passes (equal to K13a
   with its flags), K13c on halo'd coarse arrays through its z window
   (equal to K13c), K15b-6c's slabs (equal to K12's rows, within
   K12_RAYLEN_RTOL of the plain version's sequential sum on the host) and
   the sharded exact raycast with K12's EMA under both rules (equal to the
   dense one).  Phase 2-grid-seq: the sequential explore over the 3 shards
   in two K7s cases (a flagship scan's queries; 256 random queries in 32
   clusters, boxes overlapping and demotions chaining): K15b-7a's cut of
   each slab, the psum'd stack (equal to the whole grid's cut), K15b-7b's
   walk and K15b-7c's write-back of each slab, each bit-equal to its plain
   version, and the three through ``ZShardOps.explore_sequential`` equal to
   the dense K7s (grid, connected flags, writes);
3. replay tests/fixtures/golden_small.npz with the kernels on and check the
   tests/test_golden.py assertions and that the sweep path's thirteen
   kernels launched;
4. drive the flagship main path — ``VoFOD(device="cuda")``, the apriori
   ground plane and 36 scans of a content-varying cycle — and check
   ``bg_sufficient``, a NaN-free grid, that every kernel was launched and
   K5a, K5b, K10 and both K11 passes once per scan, K2 twice (one
   persistent launch a ``sweeps()`` call; so on every dense path) with the
   tiles they computed; print step p50/p95
   (CUDA events), host syncs per scan, and the explore queries and
   demotion writes of the 36 scans.  Then 6 scans with
   ``NodeOptions(raycast_every=2)``: the ray stage on every second scan.
   Then the reference-exact path, ``NodeOptions(raycast_mode="exact")``
   with the exact census and both compat flags, over the same 36 scans:
   1 host sync per scan, a finite grid, ``bg_sufficient``, every kernel of
   the path launched (K12's walk and EMA, K13a-c, K10 and the point EMA
   once per scan) and none of the sweep path's own; step p50/p95, label
   sweeps per scan, ``sep_converged`` and detections.  Then the prebinned
   ingest, ``NodeOptions(frontend_mode="prebinned")``, and a raw node over
   the same 36 scans in one process: bit-equal scan for scan, K15a once per
   prebinned scan and K3 never, 1 host sync per scan, step p50/p95 of both;
   the ``frontend_mode="auto"`` probe's choice and numbers; and
   ``cfg.dynamic_radii`` (bounds 2.0 / 2.0 m) over 36 scans with the radii
   changed every 12, each segment bit-equal to a static node at its radii
   started from the same state, K14 launched, 1 host sync per scan and no
   kernel rebuild; step p50/p95 per segment.  The raw node's steps over 7 ms
   are counted beside the prebinned node's.  Then the sequential explore,
   ``sequential_explore`` on the exact path, over the 36 scans: K7s once
   per scan, K7 and K8 never, 1 host sync per scan, the explore queries
   and demotion writes.  Then the node's runtime surface: the rangefinder
   under both validity rules, an NPZ snapshot round trip, the LUT
   consistency check, a ``trace_dir`` window and ``profile_stages``
   (bit-equal to a fused node).  Then phase 4-hostile, the hostile-input
   contract of tests/test_hostile_inputs.py on the sweep, exact and off
   paths with the raw ingest and the sweep path with the prebinned one:
   from a learned state, 6 scans with NaN, +-inf and negative float ranges
   and NaN intensity leave grid and safe bit-equal to the sanitized run's,
   NaN-free; a non-finite pose skips the scan (no launch, state kept) on
   both ingests.  Then phase 4-fleet, the streams' fleet
   (runtime/fleet.FleetVoFOD, the apriori plane in every stream): 4
   streams for 12 ticks, stream b fed the cycle from scan 3 b, every
   tick's detections and diagnostics and every final state bit-equal to
   single-stream nodes fed the same scans, exactly 1 host sync a tick and
   4 x phase 4's launches a scan of every sweep-path kernel; the same run
   with a NaN rotation on stream 2 at tick 6 (a null scan: bit-equal to a
   node stepped on zero ranges and the sentinel pose, the others to their
   clean runs, n_pose_rejected [0, 0, 1, 0]) and ``reset_stream(1)`` +
   ``load_apriori_map(plane, stream=1)`` before tick 8 (bit-equal to a
   fresh node with the plane, its step counter restarted); tick wall ms
   p50 / p95 and scans/s at 1, 2, 4, 8 and 16 streams, the largest held
   at 10 Hz, 4 streams' device busy ms and idle share a tick
   (torch.profiler; an empty or short profile fails), and
   tools/serve_fleet on the card (4 streams, 5 ticks).  Then phase 4-grid: 36 scans through
   ``make_grid_sharded_step`` over 3 shards of 17 planes on the card, each
   beside a dense node on the same scan: state, diagnostics and detection
   integers bit-equal, detection floats within 1e-5 relative, every K15b
   kernel launched on every scan, K2's batched launches, K15b-1's launches
   and K15b-4a's (its kept rounds only) exactly as many as the schedule
   gives, at most 1 host sync per scan; step p50/p95 of both, launches and
   collective copies per scan.  Then
   phase 4-grid-exact, the same for the reference-exact path (exact census,
   counted indexing, hasCloseTo box, exact raycast) with its own kernel
   list (K15b-1/-2, K1, K2, K15b-6a/b/c, K12's EMA, K13c on every scan; the
   dense K12 and K13a/b never), label sweeps and capped scans, and phase
   4-grid-transpose, the sweep path with ``zcone_mode="transpose"`` (K15b-4b
   on every scan, K15b-4a never; all_to_all copies per scan).  Then the
   grid step's last three modes, each beside its dense node: phase
   4-grid-prebinned (the host-binned scan, each shard uploading its slab:
   K15a once a shard, K3 never; host bin p50/p95, the slab uploads' ms),
   4-grid-dynamic (the dynamic radii's schedule on both, K14 launched, no
   kernel rebuild; p50 per segment) and 4-grid-sequential (the exact path
   with the sequential explore: K15b-7a/b/c once a shard, K7s, K7, K8 and
   the fold never; explore queries, demotion writes, copies by kind).
   Then phase 4-cli, the offline detector's runtime surface at the
   flagship size, on 12 scans of the cycle and the apriori ground, writing
   under build/chip_smoke/cli: (a) an uncompressed bag of organized 128 x
   1024 clouds (x, y, z, intensity, range) and a /tf chain world -> base
   -> sensor with a static 180-degree base -> sensor edge; ``convert_bag``
   bit-equal to the rendered ranges, poses within 1e-6; tools/detect run
   in-process on the bag (``--json --save-state DIR --markers M
   --watch-params Y``), every sweep-path kernel launched 12 x its phase-4
   count a scan and no other kernel, its JSON lines bit-equal to a node
   stepped directly on the converted NPZ, and a params edit before scan 6
   giving the state of ``update_params`` at scan 6; (b) one scan each in a
   bz2 and an lz4 bag, staggered by a metadata JSON's
   ``pixel_shift_by_row`` and destaggered on conversion, equal to the
   rendered ranges (write and conversion seconds); (c) checkpoints: a
   ``SnapshotManager`` (keep 2, every 4 scans) whose latest snapshot,
   stepped 4 more scans, equals the uninterrupted node; an ``AsyncSaver``
   save at scan 6 while scans 7-12 step equal to scan 6's state; phase
   4-grid's 3-shard states saved per shard, restored onto the dense state
   and back, bit-equal; the save ms and the step p50 with and without a
   save in flight; (d) ``MaskCreator`` on the card over the 12 scans with
   pixels zeroed, and the create_mask CLI's .npy, equal to numpy's
   ``logical_and.reduce(r > 0)``; (e) ``RosNode`` under an in-process stub
   of rospy and its message modules, 3 scans, publishing the JSON of a
   node stepped directly.  Then phase 4-fleet-grid, the 2-D streams x grid
   fleet (``FleetVoFOD(n_streams=2, grid_shards=3)``, the apriori plane,
   stream b fed the cycle from scan 3 b): 8 ticks beside dense nodes,
   diagnostics, detection integers and final states bit-equal, detection
   floats within 1e-5 relative; a NaN rotation on stream 1 at tick 4 (a
   null scan, ``n_pose_rejected`` [0, 1]); ``reset_stream(0)`` +
   ``load_apriori_map(plane, stream=0)`` before tick 6; exactly 1 host
   sync a tick and 2 x phase 4-grid's launches a scan of every kernel
   (the null tick's ray stage once), none of the others; the state after
   tick 3 saved in the ``streams_zshards`` checkpoint layout, restored onto
   a fresh 2-D fleet and onto a 1-shard fleet, both stepped to tick 8 equal
   to the uninterrupted run; one prebinned tick through
   ``make_fleet_grid_step`` equal to dense prebinned nodes; tick p50 / p95
   at 1 and 2 streams, 2 streams' device busy ms and idle share
   (torch.profiler), and tools/serve_fleet ``--grid-shards 3`` (2 streams,
   5 ticks).  Then phase 4-fleet-procs: two worker processes
   (``chip_smoke.py --fleet-worker``, started once the parent has built
   the kernels) join a gloo group on 127.0.0.1 and share the card; each
   runs ``FleetVoFOD(n_streams=4)`` on its 2 streams, 12 ticks with 1
   grid shard (past the first detections) and 3 with 3, every stream's records and final state equal to a
   single-process 4-stream fleet's (``local_streams`` [0, 1] and [2, 3]);
   then tools/serve_fleet ``--coordinator`` in two processes for 5 ticks,
   each reporting its own streams only; each process's tick host ms beside
   the single process's, and whether the card time-slices the two
   contexts or runs MPS.  A worker's non-zero exit, a timeout or a missing
   record fails the phase.  Then phase 4-grid-procs: the grid axis across
   processes (``parallel/comm.ProcessComm``, one 17-plane shard a process,
   the collectives staged through pinned host memory over gloo): three
   workers (``chip_smoke.py --grid-proc-worker``) share the card and run
   phase 4-grid's 36 sweep scans and the first 12 of phase 4-grid-exact's,
   every process's diagnostics, detections and slab bit-equal to those
   phases' in-process runs (detection floats within 1e-5 of the dense
   node's), each kernel of the path launched in every process and their
   launches summing to the in-process counts; phase 4-fleet-grid's script
   on ``FleetVoFOD(grid_shards=3, grid_shards_per_process=1)``, records
   and final states equal, its state after tick 3 saved by the three
   processes and restored onto a one-process fleet that steps on equal;
   tools/serve_fleet ``--grid-shards 3 --grid-shards-per-process 1`` in
   three processes for 5 ticks of a recording; step p50 / p95 beside the
   in-process path's, staged collectives, host syncs and transport host ms
   (and the syncs' wait in them) a scan;
5. a torch.profiler trace of 5 flagship scans of each path (sweep, exact,
   prebinned, dynamic radii at 2.0 / 1.9 m, sequential, grid-sharded,
   grid-sharded exact, grid-sharded sequential, grid-sharded with the
   transposed z cones),
   each from a fresh
   node after the same 6 warm-up scans: device time per stage (the step's
   ``vofod.*`` ranges), the top device ops, every port kernel's device ms
   and launches a scan (``PORT_KERNELS``), the device ops (kernels and
   copies) launched per scan, counted from key_averages and event by event,
   matmul kernels and pads per scan, and the device's busy and idle share
   of the step (the grid paths also K15b-1's launches and device ms a
   scan, and the direct_copy launches and device-to-device memcpys beside
   them; K6's and K5a's wrapper launches a scan, 3 and 1 on the sweep
   path, 15 and 3 on the grid path, and never fewer than their device
   launches); then the sweep path once more, to show whether the op
   count depends on the profiler session.

The line before the last is the per-kernel JSON record (launches from the
path that runs each kernel: the sweep path, the prebinned path for K15a,
the dynamic-radii path for K14, the sequential path for K7s, the
grid-sharded paths for K15b (the transposed one for K15b-4b, the exact one
for K15b-6a/b/c, the sequential one for K15b-7a/b/c, the exact one for
K2's batched launch), else the exact path; bound_ms from the bytes and
operations of the timed call and the H100's published peaks); the last
line is ``{"ok": true, "device": {...}}``.  Needs no network and one GPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings
from functools import partial
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from vofod_tpu_torch import kernels  # noqa: E402
from vofod_tpu_torch.io import native  # noqa: E402
from vofod_tpu_torch.io.binner import HostBinner  # noqa: E402
from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig  # noqa: E402
from vofod_tpu_torch.geometry import GridSpec  # noqa: E402
from vofod_tpu_torch.io.scan_source import (  # noqa: E402
    Scene, hover_pose, render_scan, save_scans_npz)
from vofod_tpu_torch.ops.compaction import (  # noqa: E402
    masked_compact, masked_compact_isin, masked_compact_isin_plain, masked_compact_plain)
from vofod_tpu_torch.ops.components import (  # noqa: E402
    SENTINEL, label_census, label_census_plain, label_components, label_components_plain,
    label_components_seeded, sweeps, sweeps_plain, sweeps_tiled_plain)
from vofod_tpu_torch.ops.explore import (  # noqa: E402
    demote_direct_plain, demote_floating, demote_floating_plain, explore,
    explore_cut_plain, explore_plain, explore_planes_plain, explore_sequential_,
    explore_sequential_plain, explore_sequential_spec_plain, explore_sequential_stack_plain)
from vofod_tpu_torch.ops.morphology import (  # noqa: E402
    Shells, ball_pool, ball_pool_plain, ball_pool_runs_plain, ball_taps, hascloseto_pool_any,
    hascloseto_taps, is_wide, pool_combines, pool_plain, run_table, shell_pool, shell_taps,
    tap_pool_plain, tap_set)
from vofod_tpu_torch.ops.raycast import (  # noqa: E402
    RAY_TILE, RayConsts, cone_sweep, cone_sweep_plain, dda_emissions_plain, gate_faces,
    gate_faces_plain, dda_n_steps, make_angular_gate, ray_cull_plain, ray_ema_grid_, ray_ema_plain,
    ray_window_update_, ray_window_update_plain_, raycast_dda, raycast_dda_plain, row_table,
    sweep_window)
from vofod_tpu_torch.pipeline.background import (  # noqa: E402
    point_ema, point_ema_plain, split_and_update)
from vofod_tpu_torch.pipeline.classify import (  # noqa: E402
    CLS_MAV, classify, cluster_stats, cluster_stats_plain, explore_queries)
from vofod_tpu_torch.pipeline.detect import (  # noqa: E402
    DET_WARPS, DetectConsts, detect_boxes, detect_slots, detect_slots_plain)
from vofod_tpu_torch.pipeline.sepclusters import (  # noqa: E402
    demote_ema, demote_ema_plain, demote_ema_runs_plain, demote_weights, exact_demote_ema,
    exact_demote_ema_plain, exact_demote_runs_plain, pool_sum_coarse, quirk_counts_columnwalk_plain, quirk_sure_counts, quirk_sure_counts_plain,
    traced_radii)
from vofod_tpu_torch.pipeline.step import exact_rays, ray_ema  # noqa: E402
from vofod_tpu_torch.pipeline.frontend import (  # noqa: E402
    frontend_bin, frontend_bin_plain, run_frontend, unpack, unpack_plain)
from vofod_tpu_torch.pipeline.state import PrebinnedScan, ScanInput, VoFODState  # noqa: E402
from vofod_tpu_torch.runtime.fleet import FleetVoFOD  # noqa: E402
from vofod_tpu_torch.runtime.node import NodeOptions, VoFOD, _pack, _unpack  # noqa: E402
from vofod_tpu_torch.io.staging import HostStaging  # noqa: E402
from vofod_tpu_torch.ops.raycast import (  # noqa: E402
    CONE_BATCH, RayEma, cone_halo_plan, cone_lat_batch_plain, cone_sweep_lat_sharded,
    cone_sweep_z_transposed, cone_z_round_plain, cone_zt_batch_plain, raycast_dda_slab,
    raycast_dda_slab_plain, raycast_update_, raycast_update_zsharded, sweep_zsharded)
from vofod_tpu_torch.ops.components import census_read_plain, census_scatter_plain  # noqa: E402
from vofod_tpu_torch.pipeline.sepclusters import (  # noqa: E402
    quirk_columns_plain, quirk_query_plain, quirk_ranks_plain, quirk_sure_counts_sharded)
from vofod_tpu_torch.parallel.comm import LocalComm  # noqa: E402
from vofod_tpu_torch.parallel.gridops import (  # noqa: E402
    DENSE, HALO_TILE_BYTES, SWEEP_BATCH, ZShardOps, batch_on_card, batch_plain,
    halo_exchange_plain, halo_fill_plain_, halo_fold_min_plain, halo_segments, sharded_sweeps)
from vofod_tpu_torch.parallel.grid_step import (  # noqa: E402
    gather_state, make_fleet_grid_step, make_grid_sharded_step, shard_state)
from vofod_tpu_torch.runtime.checkpoint import restore_state, save_state  # noqa: E402
from vofod_tpu_torch.sensor import make_lut, make_lut_ouster  # noqa: E402

# K4 tolerance: T lies in [0, 1] and is stored in bf16; kernel and plain
# version follow the same rounding steps, so they may differ by at most one
# bf16 ulp at 1.0 (2^-8) where an f32 sum rounds across a bf16 tie.
K4_TOL = 2.0**-8
# K9 float outputs (OBB centre, extent, size in m; axes unitless, each
# compared up to its sign): the member sums run in another order than the
# plain version's matmul and einsum, a few float32 ulps of coordinates up
# to ~120 m
K9_TOL = 1e-4
# K5a faces lie in [0, 1]; kernel and plain version follow the same
# rounding steps (bit-equal expected)
K5A_TOL = 1e-6
# K5b: the grid within 1e-5 x |score_ray| (the bound tests/test_torch_raycast.py
# holds the ray EMA to against JAX); the set of voxels it changed bit-equal
K5B_TOL_REL = 1e-5
# K10 confidence relative; pdet and covariance relative.  The plain version
# replays the window sum in the kernel's order (DET_WARPS, which phase 2
# holds to the kernel's), so phase 2 also holds confidence bit-equal
K10_CONF_RTOL = 1e-5
K10_RTOL = 1e-6
# K12 raylen against the plain version's sequential (JAX-order) float32 sum:
# the kernel sums in float64 and rounds once, so the two differ by the
# sequential sum's own rounding, largest in the voxel holding the sensor,
# which sums ~all 131,072 rays' first chords (1.08e-4 on the checked scan,
# from the host's float64 sum); against that float64 sum rounded once the
# kernel is held to one float32 ulp
K12_RAYLEN_RTOL = 5e-4
N_SCANS = 36
N_EXACT_SCANS = 36
# the kernels of each path, and those its flagship step launches once per scan
SWEEP_KERNELS = ("ball_pool", "propagate_sweeps", "frontend_bin", "cone_sweep", "masked_compact",
                 "explore_bfs", "demote", "cluster_stats", "gate_faces", "ray_update", "detect",
                 "point_ema", "demote_ema")
EXACT_KERNELS = ("ball_pool", "propagate_sweeps", "frontend_bin", "masked_compact", "explore_bfs",
                 "demote", "cluster_stats", "detect", "point_ema", "dda", "ray_ema",
                 "label_census", "quirk_counts", "exact_demote_ema")
ONCE_PER_SCAN = ("gate_faces", "ray_update", "detect", "point_ema", "demote_ema")
# K2 on every dense path: one persistent launch per sweeps() call, a seeded
# label and a reach call (or the census's label call) a scan; the batched
# launch only on the grid paths
K2_CALLS_PER_DENSE_SCAN = 2
ONCE_PER_EXACT_SCAN = ("dda", "ray_ema", "detect", "point_ema", "label_census", "quirk_counts",
                       "exact_demote_ema")
# the sequential explore path: the exact path with K7s in place of K7 and K8
SEQUENTIAL_KERNELS = tuple(k for k in EXACT_KERNELS if k not in ("explore_bfs", "demote")) + (
    "explore_seq",)
ONCE_PER_SEQUENTIAL_SCAN = ONCE_PER_EXACT_SCAN + ("explore_seq",)
# tests/test_sequential_demotion.py's scene: relative (x, y) cells carved as
# unknown in a wall of ray-carved voxels, members A = (0, 0) and B = (2, 0)
# of one cluster with Manhattan bound 8; A fails and demotes B's escape
SEQ_CARVED = ((0, 0), (1, 0), (2, 0), (2, 1), (2, 2), (1, 2), (1, 3), (1, 4), (0, 4), (0, 5))
SEQ_BASE = (120, 100, 25)  # (x, y, z) of the scene's origin in the flagship grid
# the K7s / K15b-7b case past the resident blocks: an H100 holds 132 x 8
# blocks of 256 threads at once
SEQ_Q_BIG = 2048
# the card's published peaks (H100 SXM data sheet, at 700 W): device memory
# rate, and float32 outside the tensor cores, the rate every op of these
# kernels (float or integer compare, add, select) is counted at
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

KERNEL_INFO = {
    "ball_pool": ("vofod_tpu_torch/csrc/ball_pool.cu", "vofod_tpu/ops/morphology.py:70"),
    "propagate_sweeps": ("vofod_tpu_torch/csrc/propagate.cu", "vofod_tpu/ops/components.py:88"),
    # the grid-sharded step's launches of k sweeps on a halo'd slab
    "propagate_batch": ("vofod_tpu_torch/csrc/propagate.cu", "vofod_tpu/parallel/gridops.py:374"),
    "frontend_bin": ("vofod_tpu_torch/csrc/frontend_bin.cu", "vofod_tpu/ops/binning.py:44"),
    "cone_sweep": ("vofod_tpu_torch/csrc/cone_sweep.cu", "vofod_tpu/ops/raycast.py:210"),
    "masked_compact": ("vofod_tpu_torch/csrc/compact.cu", "vofod_tpu/ops/compaction.py:49"),
    "explore_bfs": ("vofod_tpu_torch/csrc/explore.cu", "vofod_tpu/ops/explore.py:34"),
    "demote": ("vofod_tpu_torch/csrc/explore.cu", "vofod_tpu/ops/explore.py:168"),
    "explore_seq": ("vofod_tpu_torch/csrc/explore.cu", "vofod_tpu/pipeline/classify.py:211"),
    "cluster_stats": ("vofod_tpu_torch/csrc/classify_stats.cu",
                      "vofod_tpu/pipeline/classify.py:77"),
    "gate_faces": ("vofod_tpu_torch/csrc/ray_gate.cu", "vofod_tpu/ops/raycast.py:559"),
    "ray_update": ("vofod_tpu_torch/csrc/ray_update.cu", "vofod_tpu/ops/raycast.py:822"),
    "detect": ("vofod_tpu_torch/csrc/detect.cu", "vofod_tpu/pipeline/detect.py:34"),
    "point_ema": ("vofod_tpu_torch/csrc/ema.cu", "vofod_tpu/pipeline/background.py:105"),
    "demote_ema": ("vofod_tpu_torch/csrc/ema.cu", "vofod_tpu/pipeline/sepclusters.py:150"),
    "dda": ("vofod_tpu_torch/csrc/dda.cu", "vofod_tpu/ops/raycast.py:62"),
    "ray_ema": ("vofod_tpu_torch/csrc/ray_update.cu", "vofod_tpu/pipeline/step.py:53"),
    "label_census": ("vofod_tpu_torch/csrc/census.cu", "vofod_tpu/parallel/gridops.py:134"),
    "quirk_counts": ("vofod_tpu_torch/csrc/census.cu", "vofod_tpu/pipeline/sepclusters.py:211"),
    "exact_demote_ema": ("vofod_tpu_torch/csrc/ema.cu", "vofod_tpu/pipeline/sepclusters.py:301"),
    "shell_pool": ("vofod_tpu_torch/csrc/ball_pool.cu", "vofod_tpu/ops/morphology.py:147"),
    "unpack": ("vofod_tpu_torch/csrc/unpack.cu", "vofod_tpu/pipeline/frontend.py:86"),
    "halo_exchange": ("vofod_tpu_torch/csrc/halo.cu", "vofod_tpu/parallel/gridops.py:241"),
    "halo_fold_min": ("vofod_tpu_torch/csrc/halo.cu", "vofod_tpu/parallel/gridops.py:275"),
    "cone_sweep_lat": ("vofod_tpu_torch/csrc/cone_sweep.cu", "vofod_tpu/ops/raycast.py:248"),
    "cone_sweep_z": ("vofod_tpu_torch/csrc/cone_sweep.cu", "vofod_tpu/ops/raycast.py:361"),
    "cone_sweep_zt": ("vofod_tpu_torch/csrc/cone_sweep.cu", "vofod_tpu/ops/raycast.py:308"),
    "census_scatter": ("vofod_tpu_torch/csrc/census.cu", "vofod_tpu/parallel/gridops.py:440"),
    "census_read": ("vofod_tpu_torch/csrc/census.cu", "vofod_tpu/parallel/gridops.py:440"),
    "quirk_columns": ("vofod_tpu_torch/csrc/census.cu", "vofod_tpu/pipeline/sepclusters.py:243"),
    "quirk_ranks": ("vofod_tpu_torch/csrc/census.cu", "vofod_tpu/pipeline/sepclusters.py:243"),
    "quirk_query": ("vofod_tpu_torch/csrc/census.cu", "vofod_tpu/pipeline/sepclusters.py:243"),
    "dda_slab": ("vofod_tpu_torch/csrc/dda.cu", "vofod_tpu/parallel/gridops.py:600"),
    # K7s under ZShardOps: the per-query sharded explore and demotion
    "explore_cut": ("vofod_tpu_torch/csrc/explore.cu", "vofod_tpu/parallel/gridops.py:532"),
    "explore_seq_stack": ("vofod_tpu_torch/csrc/explore.cu",
                          "vofod_tpu/pipeline/classify.py:211"),
    # the stencils' wide forms (past halo 7)
    "ball_pool_wide": ("vofod_tpu_torch/csrc/ball_pool.cu", "vofod_tpu/ops/morphology.py:70"),
    "shell_pool_wide": ("vofod_tpu_torch/csrc/ball_pool.cu", "vofod_tpu/ops/morphology.py:147"),
    "propagate_sweeps_wide": ("vofod_tpu_torch/csrc/propagate.cu",
                              "vofod_tpu/ops/components.py:88"),
    "propagate_batch_wide": ("vofod_tpu_torch/csrc/propagate.cu",
                             "vofod_tpu/parallel/gridops.py:374"),
    "demote_ema_wide": ("vofod_tpu_torch/csrc/ema.cu", "vofod_tpu/pipeline/sepclusters.py:150"),
    "exact_demote_ema_wide": ("vofod_tpu_torch/csrc/ema.cu",
                              "vofod_tpu/pipeline/sepclusters.py:301"),
}
# the grid-sharded step: shards of the flagship grid (51 = 3 x 17 planes),
# all on the one card, and the kernels its path adds
GRID_SHARDS = 3
GRID_KERNELS = ("halo_exchange", "halo_fold_min", "cone_sweep_lat", "cone_sweep_z")
# the reference-exact grid path (no sweep: K15b-3/-4a never) and the
# sweep path with the transposed z cones (K15b-4b in place of K15b-4a)
GRID_EXACT_KERNELS = ("halo_exchange", "halo_fold_min", "ball_pool", "propagate_batch",
                      "census_scatter", "census_read", "quirk_columns", "quirk_ranks",
                      "quirk_query", "dda_slab", "ray_ema", "exact_demote_ema")
GRID_TRANSPOSE_KERNELS = ("halo_exchange", "halo_fold_min", "cone_sweep_lat", "cone_sweep_zt")
# the reference-exact grid path with the sequential explore: K15b-7a and
# K15b-7b (K15b-7c's stores in its launch) in place of K7s (and of the
# sharded K7 / K8 and their fold)
GRID_SEQ_KERNELS = tuple(k for k in GRID_EXACT_KERNELS if k != "halo_fold_min") + (
    "explore_cut", "explore_seq_stack")


def say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn, reps: int = 20, min_kernels: int = 1) -> dict:
    """The device side of fn() from torch.profiler over reps calls, after
    one warm-up: kernel ms a call (the sum of its kernels' durations),
    kernel launches a call, and the same for memsets.  Beside cuda_ms it
    says whether the host or the device holds the call.  A session that
    recorded fewer than ``min_kernels`` kernel events is taken again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a session now and then records no device event at all, or loses most
    # of them (PERF.md §7): up to three sessions, the first that saw
    # min_kernels kernels counts, else the fullest
    best = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = {"kernel": 0.0, "memset": 0.0, "memcpy": 0.0}
        n = dict.fromkeys(us, 0)
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            low = e.name.lower()
            kind = "memcpy" if "memcpy" in low else "memset" if "memset" in low else "kernel"
            us[kind] += float(getattr(e, "device_time", None) or getattr(e, "cuda_time", 0.0))
            n[kind] += 1
        if best is None or n["kernel"] > best[1]["kernel"]:
            best = us, n
        if n["kernel"] >= min_kernels:
            break
    us, n = best
    return dict(device_ms=us["kernel"] / reps / 1e3, cuda_launches=n["kernel"] / reps,
                memset_ms=us["memset"] / reps / 1e3, memsets=n["memset"] / reps,
                memcpys=n["memcpy"] / reps)


def one_launch_profile(fn, what: str) -> dict:
    """device_profile(fn) of a kernel that must be one launch and no memset
    a call.  A session loses the first kernels it should record (the first
    scan's first two in phase 5, the first call's here: 19 of 20), so the
    launches a call are its count over the calls, rounded; raises unless
    that is 1 and no memset was seen.  A session that lost more (6 of 20
    seen once) is taken again."""
    reps = 20
    prof = device_profile(fn, reps, min_kernels=reps - 1)
    if round(prof["cuda_launches"]) != 1 or prof["memsets"] != 0:
        raise AssertionError(f"{what}: {prof} (1 launch and 0 memsets a call)")
    return prof


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def scan_cycle(lut, n_scans: int):
    """Content-varying cycle (bench.py make_scan_cycle): ground, a structure
    and a target orbiting while the sensor flies its own arc."""
    scans = []
    for k in range(n_scans):
        a = 2.0 * np.pi * k / n_scans
        scene = Scene(ground_z=-1.0)
        scene.add_box((50.0, 30.0, -1.0), (54.0, 34.0, 5.0))
        scene.add_sphere(
            center=(25.0 + 4.0 * np.cos(a), 15.0 + 4.0 * np.sin(a), 6.0), radius=0.5
        )
        p = hover_pose(
            (40.0 + 1.5 * np.cos(a), 20.0 + 1.5 * np.sin(a), 3.0 + 0.2 * np.sin(2 * a)),
            yaw=0.1 * np.sin(a),
        )
        scans.append((render_scan(scene, lut, p), p))
    return scans


# fine-0125: the flagship's own 241 x 201 x 51 grid at a quarter of its
# voxel size (0.125 m) over a quarter of its extent, every radius of
# configs/detection_params.yaml kept in metres: the ground ball is r 12
# (7,153 taps: K1 int8 max and K2's label sweeps past halo 7), the local
# sure count r 8 (K1 int32 sum past halo 7), the sepclusters reach r 7 and
# the demotion r 6.4.  The capacities that scale with the voxel count: the
# explore submap covers 2 x 24 + 1 voxels of the 3 m explore distance, and
# the far voxels and explore queries hold every scan of the cycle
# (far_overflow never set: phase 4-fine checks it).
FINE_CAPACITIES = dict(explore_submap=64, max_far_voxels=16384, max_queries=1024)


def fine_config(**kw) -> VoFODConfig:
    return VoFODConfig(voxel_size=0.125,
                       oparea=Box((40.0, 20.0, -1.25 + 3.125), (30.0, 25.0, 6.25)),
                       **FINE_CAPACITIES, **kw)


def fine_scan_cycle(lut, n_scans: int):
    """fine-0125's cycle: the ground, a 2 m block standing on it and a 0.4 m
    sphere (a small drone) orbiting 4.2 m above the ground (past the 3 m
    explore distance), the sensor hovering on its own arc 2.5 m up, all
    inside the fine area."""
    scans = []
    for k in range(n_scans):
        a = 2.0 * np.pi * k / n_scans
        scene = Scene(ground_z=-1.0)
        scene.add_box((46.0, 25.0, -1.0), (48.0, 27.0, 1.0))
        scene.add_sphere(center=(36.0 + 2.0 * np.cos(a), 20.0 + 2.0 * np.sin(a), 3.2),
                         radius=0.4)
        p = hover_pose((40.0 + 1.0 * np.cos(a), 20.0 + 1.0 * np.sin(a), 1.5), yaw=0.1 * np.sin(a))
        scans.append((render_scan(scene, lut, p), p))
    return scans


def fine_apriori_ground() -> np.ndarray:
    """fine-0125's apriori ground: the plane under the fine area at its own
    0.125 m, so that the background is sufficient (15 % of the area's
    columns) from the first scan and every scan of the cycle classifies."""
    xs, ys = np.arange(25.0, 55.01, 0.125), np.arange(7.5, 32.51, 0.125)
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, -1.0)], axis=1).astype(np.float32)


def apriori_ground() -> np.ndarray:
    """bench.py apriori_ground: a ground plane under the scanned area."""
    xs = np.arange(10.0, 60.0, 0.4)
    ys = np.arange(0.0, 45.0, 0.4)
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, -1.0)], axis=1).astype(np.float32)


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def phase0() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA GPU: torch.cuda.is_available() is False")
    smi = _smi()
    print(smi, flush=True)  # as nvidia-smi gives it: "<name>, <power limit>"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("0-device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=smi,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}


def phase1() -> None:
    """Build the kernel library (nvcc) and the native host binner (g++)
    side by side."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(native.build)
        so, log = kernels.build()
        host_so = host.result()
    kernels.load()
    native.load()
    info = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    # registers and spills of the run-table kernels, by instantiation
    pool, entry = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m.group(1)
        elif entry and "spill stores" in ln:
            SPILLS[entry] = int(re.search(r"(\d+) bytes spill stores", ln).group(1))
        elif entry and "Used" in ln and "registers" in ln:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            REGISTERS[entry] = regs
            k = re.search(r"(ball_pool_kernel|demote_ema_kernel|exact_demote_kernel|"
                          r"ball_pool_wide_kernel|demote_ema_wide_kernel|"
                          r"exact_demote_wide_kernel|sweeps_kernel)(\w{0,40})", entry)
            if k:
                pool.append([k.group(0), regs, SPILLS.get(entry, 0)])
            entry = None
    say("1-build", seconds=round(time.perf_counter() - t0, 3), library=so.name,
        host_library=host_so.name, ptxas=info, run_table_kernels_registers=pool)


# every kernel's registers and spill stores in bytes (its mangled name:
# ptxas's counts), from phase 1
REGISTERS: dict[str, int] = {}
SPILLS: dict[str, int] = {}


def _registers(*parts: str, piece: bool = False) -> int | None:
    """The registers of the one kernel whose mangled name holds every
    ``parts``, a z piece's (``PieceIO``) iff ``piece`` (None: the build was
    cached)."""
    got = [r for k, r in REGISTERS.items()
           if all(p in k for p in parts) and ("PieceIO" in k) == piece]
    return got[0] if len(got) == 1 else None


@contextlib.contextmanager
def k2_tiles_recorded():
    """Within the block, record the tiles computed per sweep (device int32
    [n]) of every persistent K2 call, in order, by wrapping
    kernels.propagate_sweeps; yields the list."""
    calls, real = [], kernels.propagate_sweeps

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(out[2])
        return out
    kernels.propagate_sweeps = recording
    try:
        yield calls
    finally:
        kernels.propagate_sweeps = real


def _k2_case(init, occ, ball, n: int, until_fixpoint: bool = False, reps: int = 20) -> dict:
    """One persistent K2 call (``sweeps``) held bit-equal to the plain sweeps
    (grid, per-sweep flags) and to the plain model of its schedule (tiles
    computed per sweep); ms of the call and of the plain sweeps, and the
    blocks the launch used."""
    with k2_tiles_recorded() as calls:
        kg, kf = sweeps(init, occ, ball, n, until_fixpoint)
    kt, = calls
    pg, pf = sweeps_plain(init, occ, ball, n, until_fixpoint)
    _, _, mt = sweeps_tiled_plain(init, occ, ball, n, until_fixpoint)
    err = _equal((kg, kf, kt), (pg, pf, mt), "K2.grid K2.flags K2.tiles_per_sweep")
    taps, halo = tap_set(ball)
    *_, blocks = kernels.propagate_sweeps(init, occ.contiguous().view(torch.uint8), taps,
                                          halo, 1)
    return dict(shape=list(init.shape), dtype=str(init.dtype), taps=len(taps), halo=halo,
                max_abs_err=err, sweeps=n, sweeps_run=min(n, int(pf.sum()) + 1),
                flags=pf.int().tolist(), tiles=kt.tolist(), model_tiles=mt.tolist(),
                full_sweep_tiles=int(mt[0]), blocks=blocks,
                ms=cuda_ms(lambda: sweeps(init, occ, ball, n, until_fixpoint), reps=reps),
                plain_ms=cuda_ms(lambda: sweeps_plain(init, occ, ball, n, until_fixpoint),
                                 reps=max(reps // 4, 1)))


def _window_offsets(grid: GridSpec, x0, y0, wx, wy, gx, gy, gz, dev):
    """(rel_x, rel_y, rel_z) of a sweep window, as the step computes them."""
    rel_z = torch.arange(grid.nz, dtype=torch.float32, device=dev) + 0.5 - float(gz)
    rel_x = torch.arange(wx, dtype=torch.float32, device=dev) + float(x0) + 0.5 - float(gx)
    rel_y = torch.arange(wy, dtype=torch.float32, device=dev) + float(y0) + 0.5 - float(gy)
    return rel_x, rel_y, rel_z


def _k4_case(op_w, rel_x, rel_y, rel_z) -> dict:
    """K4 on one window against its plain version: bit-equal (n_diff 0,
    within K4_TOL); ms of it and of the plain version."""
    kt = cone_sweep(op_w, rel_x, rel_y, rel_z)
    pt = cone_sweep_plain(op_w, rel_x, rel_y, rel_z)
    e4, n_diff = max_abs(kt, pt), int((kt != pt).sum())
    if not (e4 <= K4_TOL and n_diff == 0):
        raise AssertionError(f"K4 window {tuple(op_w.shape)}: max|dT| {e4}, {n_diff} differ")
    return dict(window=list(op_w.shape), max_abs_err=e4, n_diff=n_diff,
                ms=cuda_ms(lambda: cone_sweep(op_w, rel_x, rel_y, rel_z)),
                plain_ms=cuda_ms(lambda: cone_sweep_plain(op_w, rel_x, rel_y, rel_z), reps=2))


def _bound(n_bytes: float, n_ops: float) -> dict:
    """The least time of a call on the card: its bytes at the memory rate or
    its operations at the float32 rate, whichever is longer."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _gapped_taps(h: int, n: int, seed: int) -> np.ndarray:
    """n distinct taps drawn from the (2h + 1)^3 box: rows of several runs."""
    rng = np.random.default_rng(seed)
    box = np.array([(z, y, x) for z in range(-h, h + 1) for y in range(-h, h + 1)
                    for x in range(-h, h + 1)], np.int32)
    return box[rng.permutation(len(box))[:n]]


def _k1_hard_cases(grid: GridSpec, dev) -> dict:
    """K1's run-table kernel on the flagship grid where it can go wrong,
    each bit-equal to the plain per-tap version: fills that are not the
    op's identity (max with fill 0 over negative values, min with fill 5, a
    sum with fill 7), an int32 sum past 2^31, fewer planes than 2 h + 1, a
    23-plane slab (the grid paths' halo'd slab), rows misaligned in memory
    (a view 1 or 3 bytes, 1 int32 past an allocation), tap sets of several
    runs a row (one group of pairs at halo 3; several at halo 5 and 7, up
    to 2,112 taps) and the asymmetric hasCloseTo box at r 1.5.  Returns
    {case: (taps, runs, ms)}."""
    rng = np.random.default_rng(13)
    shape = grid.shape

    def rand(lo, hi, dtype):
        return torch.as_tensor(rng.integers(lo, hi, shape).astype(dtype), device=dev)

    def misaligned(a, off):
        flat = torch.empty(a.numel() + off, dtype=a.dtype, device=dev)
        flat[off:].view(a.shape).copy_(a)
        return flat[off:].view(a.shape)

    neg8, pos8 = rand(-128, 0, np.int8), rand(0, 128, np.int8)
    neg32, pos32 = rand(-2**31, 0, np.int32), rand(0, 2**31 - 1, np.int32)
    big32, bit32 = rand(2**29, 2**30, np.int32), rand(0, 2, np.int32)
    cases = {
        "int8 max fill 0 over negatives r3": (neg8, 3.0, "max", 0),
        "int8 min fill 5 r3": (pos8, 3.0, "min", 5),
        "int32 max fill 0 over negatives r2": (neg32, 2.0, "max", 0),
        "int32 min fill 5 r3": (pos32, 3.0, "min", 5),
        "int32 sum past 2^31 r3": (big32, 3.0, "sum", 0),
        "int32 sum fill 7 r3": (bit32, 3.0, "sum", 7),
        "5 planes < 2h + 1, int8 max r3": (neg8[:5].contiguous(), 3.0, "max", 0),
        "2 planes, int32 sum r3": (big32[:2].contiguous(), 3.0, "sum", 0),
        "23-plane slab, int32 sum r3": (bit32[:23].contiguous(), 3.0, "sum", 0),
        "23-plane slab, int8 max r3": (neg8[:23].contiguous(), 3.0, "max", 0),
        "grid 50x199x237, int8 min r3": (pos8[:50, :199, :237].contiguous(), 3.0, "min", 5),
        "rows 1 byte misaligned, int8 max r3": (misaligned(neg8, 1), 3.0, "max", 0),
        "rows 3 bytes misaligned, int8 min r3": (misaligned(pos8, 3), 3.0, "min", 5),
        "rows 1 int32 misaligned, int32 sum r3": (misaligned(big32, 1), 3.0, "sum", 0),
        "60 taps with gaps at halo 3, int8 max": (neg8, _gapped_taps(3, 60, 1), "max", 0),
        "200 taps with gaps at halo 3, int32 sum": (big32, _gapped_taps(3, 200, 2), "sum", 0),
        "400 taps with gaps at halo 5, int32 max": (neg32, _gapped_taps(5, 400, 3), "max", -7),
        "2,112 taps with gaps at halo 7, int32 sum": (big32, _gapped_taps(7, 2112, 4), "sum", 0),
        "1,500 taps with gaps at halo 7, int8 min": (pos8, _gapped_taps(7, 1500, 5), "min", 5),
        "hasCloseTo box r1.5, int8 max": (neg8, hascloseto_taps(1.5), "max", 0),
    }
    out = {}
    for name, (a, ball, op, fill) in cases.items():
        taps, _ = tap_set(ball)
        _equal((ball_pool(a, ball, op, fill),), (tap_pool_plain(a, taps, op, fill),),
               f"K1[{name.replace(' ', '_')}].out")
        out[name] = (len(taps), len(run_table(ball).runs),
                     round(cuda_ms(lambda: ball_pool(a, ball, op, fill), reps=5), 4))
    say("2-k1-cases", cases=out)
    return out


def phase2(lut) -> list[dict]:
    """Each kernel against its plain version at flagship shapes."""
    dev = torch.device("cuda")
    cfg, dyn = VoFODConfig(), DynParams()
    grid = GridSpec.from_config(cfg)
    node = VoFOD(cfg, dyn, NodeOptions(), lut, device=dev)
    node.load_apriori_map(apriori_ground())
    # warm up for at least 5 scans, and on until a scan had explore
    # queries, so that the next scan likely gives K7/K8 main-path work
    scans = scan_cycle(lut, N_SCANS)
    n_warm = 0
    for r, p in scans[:-1]:
        node.process_scan(r, None, p)
        n_warm += 1
        if n_warm >= 5 and int(node.last_diag.n_queries) > 0:
            break
    r_np, pose_np = scans[n_warm]
    say("2-input", warm_up_scans=n_warm, queries_last_warm_up=int(node.last_diag.n_queries))
    ranges = torch.as_tensor(r_np.astype(np.float32), device=dev)
    pose = torch.as_tensor(pose_np, device=dev)
    dirs = torch.as_tensor(lut.directions, device=dev)
    offs = torch.as_tensor(lut.offsets, device=dev)
    vals = node.state.grid
    results = []

    # K3 — frontend binning of the scan
    k3 = frontend_bin(cfg, grid, dirs, offs, ranges, pose)
    p3 = frontend_bin_plain(cfg, grid, dirs, offs, ranges, pose)
    for a, b, what in zip(k3, p3, ("counts", "n_valid", "excl", "fid")):
        if not torch.equal(a, b):
            raise AssertionError(f"K3 {what} differs from the plain version")
    n_rays, nv = ranges.shape[0], grid.n_voxels
    all_fids = k3[3].long()
    results.append(dict(
        name="frontend_bin", max_abs_err=max(max_abs(a, b) for a, b in zip(k3, p3)),
        ms=cuda_ms(lambda: frontend_bin(cfg, grid, dirs, offs, ranges, pose)),
        plain_ms=cuda_ms(lambda: frontend_bin_plain(cfg, grid, dirs, offs, ranges, pose)),
        # ranges, LUT, pose in; counts grid, count, exclude flags, ids out
        bytes=n_rays * (4 + 12 + 12 + 1 + 4) + 64 + nv * 4 + 4, ops=n_rays * 42,
        library_ms=cuda_ms(lambda: torch.bincount(all_fids, minlength=nv)),
        library_call="torch.bincount of the scan's 131,072 clamped point ids",
        shapes=f"{lut.height}x{lut.width} rays -> {grid.shape}",
    ))
    counts = k3[0]
    occupied = counts > 0

    # K1 — the pools of the step: bg_near (int8 max r=3), the sepclusters
    # sure sum (int32 r=3) and demotion ball (int8 max r=1.6), int32 min r=3
    radius = cfg.ground_points_max_distance / cfg.voxel_size
    bg = vals > dyn.thr_new_obstacles
    sure = (vals > dyn.thr_sure_obstacles).to(torch.int32)
    keys = torch.where(bg, torch.arange(grid.n_voxels, dtype=torch.int32, device=dev)
                       .reshape(grid.shape), SENTINEL)
    cases = [
        (bg.to(torch.int8), radius, "max", 0),
        (sure, 3.0, "sum", 0),
        ((bg & ~occupied).to(torch.int8), 1.6, "max", 0),
        (keys, radius, "min", SENTINEL),
    ]
    err, ms, pms = 0.0, [], []
    for a, rad, op, fill in cases:
        k = ball_pool(a, rad, op, fill)
        p = ball_pool_plain(a, rad, op, fill)
        if not torch.equal(k, p):
            raise AssertionError(f"K1 {op} r={rad} {a.dtype} differs from the plain version")
        err = max(err, max_abs(k, p))
        ms.append(cuda_ms(lambda: ball_pool(a, rad, op, fill)))
        pms.append(cuda_ms(lambda: ball_pool_plain(a, rad, op, fill)))
    # the compat hasCloseTo box (r = 3, the +3 layer missing) as K1's tap set
    hct_taps = hascloseto_taps(radius)
    kh = hascloseto_pool_any(bg, radius)
    ph = tap_pool_plain(bg.to(torch.int8), hct_taps, "max", 0) > 0
    if not torch.equal(kh, ph):
        raise AssertionError("K1 hasCloseTo tap set differs from the plain version")
    hct = dict(taps=len(hct_taps), set_voxels=int(ph.sum()),
               ms=cuda_ms(lambda: hascloseto_pool_any(bg, radius)),
               plain_ms=cuda_ms(lambda: tap_pool_plain(bg.to(torch.int8), hct_taps, "max", 0),
                                reps=3))
    hard = _k1_hard_cases(grid, dev)
    # the two calls of the sweep path, each with its own bound: inputs read
    # and outputs written once, the run decomposition's combines a voxel
    calls = []
    for (a, rad, op, fill), what, t, pt in zip(cases[:2], ("bg_near", "local sure count"),
                                              ms, pms):
        n_bytes, n_ops = 2 * a.numel() * a.element_size(), nv * run_table(rad).combines()
        calls.append(dict(call=f"{what}: {a.dtype} {op} r{rad}", ms=t, plain_ms=pt,
                          device_ms=device_profile(lambda: ball_pool(a, rad, op, fill))[
                              "device_ms"],
                          schedule=kernels.ball_pool_schedule(a, *tap_set(rad), op, fill)[1],
                          bytes=n_bytes, ops=n_ops, **_bound(n_bytes, n_ops)))
    # one float32 convolution of the 0/1 sure grid with the r3 ball of ones:
    # the sum call's values on the step's 0/1 inputs only
    ball_w = torch.zeros((1, 1, 7, 7, 7), dtype=torch.float32, device=dev)
    for dz, dy, dx in ball_taps(3.0).tolist():
        ball_w[0, 0, dz + 3, dy + 3, dx + 3] = 1.0
    sure_f = sure.to(torch.float32)[None, None]
    conv = torch.nn.functional.conv3d(sure_f, ball_w, padding=3)[0, 0]
    if not torch.equal(conv.to(torch.int32), ball_pool(sure, 3.0, "sum", 0)):
        raise AssertionError("F.conv3d of the 0/1 sure grid differs from K1's sum")
    results.append(dict(
        name="ball_pool", max_abs_err=err, ms=calls[1]["ms"], plain_ms=calls[1]["plain_ms"],
        device_ms=calls[1]["device_ms"], bytes=calls[1]["bytes"], ops=calls[1]["ops"],
        library_ms=cuda_ms(lambda: torch.nn.functional.conv3d(sure_f, ball_w, padding=3)),
        library_call="F.conv3d of the 0/1 sure grid (float32, cudnn tf32 off) with the r3 "
                     "ball of ones: the local sure count's values on the step's 0/1 inputs "
                     "only; the record's ms and bound are that call's",
        calls=calls, hascloseto=hct, cases=hard,
        shapes=f"{grid.shape}; ms/plain_ms per case (int8 max r3, int32 sum r3, "
               f"int8 max r1.6, int32 min r3): {[round(x, 4) for x in ms]} / "
               f"{[round(x, 4) for x in pms]}",
    ))

    # K2 — the persistent launch: 8 label sweeps at r3 from the scan's seeded
    # keys, 8 reach sweeps at r2, a fixpoint at sweep 0 (voxels 3 apart at
    # r2) and a grid that is no multiple of the 32 x 8 x 4 tile
    bg_near = ball_pool_plain(bg.to(torch.int8), radius, "max", 0) > 0
    seed = occupied & bg_near
    nv = grid.n_voxels
    flat = torch.arange(nv, dtype=torch.int32, device=dev).reshape(grid.shape)
    key0 = (nv - 1) - flat + torch.where(seed, 0, nv).to(torch.int32)
    keys0 = torch.where(occupied, key0, SENTINEL)
    reach0 = (bg & (sure > 0)).to(torch.uint8)
    iso = torch.zeros(grid.shape, dtype=torch.bool, device=dev)
    iso[::3, ::3, ::3] = True
    odd = (slice(0, 50), slice(0, 199), slice(0, 237))
    k2 = {}
    for name, init, occ, rad in (
            ("label r3", keys0, occupied, radius), ("reach r2", reach0, bg, 2.0),
            ("fixpoint at sweep 0", torch.where(iso, flat, SENTINEL), iso, 2.0),
            ("grid 50x199x237", keys0[odd].contiguous(), occupied[odd].contiguous(), radius)):
        k2[name] = _k2_case(init, occ, rad, cfg.cc_sweeps)
    if not (k2["fixpoint at sweep 0"]["sweeps_run"] == 1
            and k2["fixpoint at sweep 0"]["tiles"][1:] == [0] * (cfg.cc_sweeps - 1)):
        raise AssertionError(f"K2 fixpoint at sweep 0: {k2['fixpoint at sweep 0']}")
    # the seeded labelling end to end: labels, reach, converged, iters
    kl = label_components_seeded(occupied, seed, radius, cfg.cc_sweeps)
    pl = label_components_seeded(occupied, seed, radius, cfg.cc_sweeps, sweep_fn=sweeps_plain)
    _equal(kl, pl, "K2s.labels K2s.reached K2s.converged K2s.iters")
    say("2-k2", cases=k2, seeded=dict(converged=bool(pl[2]), iters=int(pl[3])))
    lab = k2["label r3"]
    n_taps = len(ball_taps(radius))
    per_call = {k: round(v["ms"], 4) for k, v in k2.items()}
    results.append(dict(
        name="propagate_sweeps", max_abs_err=lab["max_abs_err"], ms=lab["ms"], plain_ms=lab["plain_ms"],
        # one call: the keys and the mask read once, the keys written once;
        # the taps of every tile this call's schedule computed
        bytes=nv * (4 + 1 + 4), ops=sum(lab["tiles"]) * 32 * 8 * 4 * n_taps, library_ms=None,
        shapes=f"{grid.shape}, one call of {cfg.cc_sweeps} label sweeps at r3 ({n_taps} taps); "
               f"ms per call: {per_call}",
    ))

    # K4 — the cone sweep on the scan's blocker window, and four more windows
    x0, y0, wx, wy, gx, gy, gz = sweep_window(grid, pose_np[:3, 3], cfg.raycast_max_distance_bound)
    rel_x, rel_y, rel_z = _window_offsets(grid, x0, y0, wx, wy, gx, gy, gz, dev)
    op_w = occupied[:, y0:y0 + wy, x0:x0 + wx].contiguous()
    k4 = {"flagship": _k4_case(op_w, rel_x, rel_y, rel_z)}
    # the sensor 4 m from the grid's x and 6 m from its y edge: the window
    # shifts against the edge; at a 60 m bound it is clipped to the grid
    # (wx 241, wy 201)
    edge = np.array([grid.origin[0] + 4.0, grid.origin[1] + 6.0, pose_np[2, 3]], np.float32)
    for name, bound in (("sensor 4 m from an edge", cfg.raycast_max_distance_bound),
                        ("clipped by the grid, 60 m bound", 60.0)):
        w = sweep_window(grid, edge, bound)
        ex, ey, ez = _window_offsets(grid, *w, dev)
        k4[name] = _k4_case(occupied[:, w[1]:w[1] + w[3], w[0]:w[0] + w[2]].contiguous(),
                            ex, ey, ez)
    cut = op_w[:45, :93].contiguous()  # A rows 45 (x/y cones) and 93 (z cones): no multiple of C
    k4["rows not a multiple of C"] = _k4_case(cut, rel_x, rel_y[:93], rel_z[:45])
    for name, fill in (("all opaque", 1), ("all transparent", 0)):
        k4[name] = _k4_case(torch.full_like(op_w, fill), rel_x, rel_y, rel_z)
    say("2-k4", cluster=kernels.CONE_CLUSTER, cases=k4)
    nw = op_w.numel()
    results.append(dict(
        name="cone_sweep", max_abs_err=k4["flagship"]["max_abs_err"], tol=K4_TOL, n_diff=0,
        bytes=nw * (1 + 6 * 4), ops=nw * 6 * 16, library_ms=None,
        ms=k4["flagship"]["ms"], plain_ms=k4["flagship"]["plain_ms"],
        shapes=f"window {tuple(op_w.shape)}, 6 cones on clusters of "
               f"{kernels.CONE_CLUSTER} blocks",
    ))
    kt = cone_sweep(op_w, rel_x, rel_y, rel_z)
    results += phase2_classify(cfg, dyn, grid, vals, k3, node.state.bg_sufficient, pose)
    window = (x0, y0, rel_x, rel_y, rel_z)
    results += phase2_stages(cfg, dyn, grid, lut, node, r_np, vals, k3, pose, kt, window)
    results += phase2_ingest(cfg, grid, lut, scans, n_warm, k3, ranges, pose)
    results += phase2_taps(cfg, grid, vals, occupied, node.state.safe)
    results += phase2_wide(cfg, grid, vals, occupied)
    for r in results:
        say("2-kernel", **r)
    return results


def _equal(a, b, what: str) -> float:
    """Raise unless every pair is bit-equal; return the max |a - b| seen."""
    for x, y, name in zip(a, b, what.split()):
        if not torch.equal(x, y):
            raise AssertionError(f"{name} differs from the plain version")
    return max(max_abs(x, y) for x, y in zip(a, b))


def _compact_cases(cfg, grid, excl, far, labels, rep_sel):
    """K6 at its three call sites, the predicate form and overflow cases."""
    dev = far.device
    g = torch.Generator(device=dev).manual_seed(6)
    dense = torch.rand(grid.shape, generator=g, device=dev) < 0.3
    rnd_labels = torch.randint(0, 64, grid.shape, generator=g, device=dev, dtype=torch.int32)
    sel = torch.tensor([3, -2, 17, 40, -2, 63, 5, 22], dtype=torch.int32, device=dev)
    far_labels = torch.unique(labels[far])[:6].to(torch.int32)  # one host sync, here only
    sel_far = torch.cat([far_labels, torch.full((2,), -2, dtype=torch.int32, device=dev)])
    small = dense.reshape(-1)[:1000].contiguous()
    # views of the far mask at byte offsets 1, 7 and 15 (allocations are
    # 512-byte aligned): a scalar head and tail around the 16-byte loads
    buf = torch.zeros(far.numel() + 64, dtype=torch.bool, device=dev)
    views = {off: buf[off:off + far.numel()].view(grid.shape) for off in (1, 7, 15)}
    tile, resident = kernels.compact_geometry()
    if tile != kernels.COMPACT_TILE:  # the wrapper sizes the look-back state from its own
        raise AssertionError(f"K6 tile {tile} bytes, kernels.COMPACT_TILE {kernels.COMPACT_TILE}")
    past = torch.rand((resident + 37) * tile + 5, generator=g, device=dev) < 0.01
    past_view = torch.zeros(past.numel() + 16, dtype=torch.bool, device=dev)[3:3 + past.numel()]
    past_view.copy_(past)

    cases = [  # (name, kernel call, plain call)
        ("far 2.47M->2048", lambda: masked_compact(far, cfg.max_far_voxels),
         lambda: masked_compact_plain(far, cfg.max_far_voxels)),
        ("excl 131072->4096", lambda: masked_compact(excl, 4096),
         lambda: masked_compact_plain(excl, 4096)),
        ("query isin(rep_sel) 2.47M->256",
         lambda: masked_compact_isin(far, labels, rep_sel, cfg.max_queries),
         lambda: masked_compact_isin_plain(far, labels, rep_sel, cfg.max_queries)),
        ("query isin(scan labels) 2.47M->256",
         lambda: masked_compact_isin(far, labels, sel_far, cfg.max_queries),
         lambda: masked_compact_isin_plain(far, labels, sel_far, cfg.max_queries)),
        ("overflow dense 2.47M->4096", lambda: masked_compact(dense, 4096),
         lambda: masked_compact_plain(dense, 4096)),
        ("overflow isin dense 2.47M->256",
         lambda: masked_compact_isin(dense, rnd_labels, sel, 256),
         lambda: masked_compact_isin_plain(dense, rnd_labels, sel, 256)),
        ("cap > n 1000->4096", lambda: masked_compact(small, 4096),
         lambda: masked_compact_plain(small, 4096)),
        (f"past resident {past.numel()} at byte 3 ->4096",
         lambda: masked_compact(past_view, 4096), lambda: masked_compact_plain(past_view, 4096)),
    ]
    for off in (1, 7, 15):
        views[off].copy_(far)
        cases += [
            (f"far at byte {off} 2.47M->2048",
             lambda o=off: masked_compact(views[o], cfg.max_far_voxels),
             lambda o=off: masked_compact_plain(views[o], cfg.max_far_voxels)),
            (f"query at byte {off} 2.47M->256",
             lambda o=off: masked_compact_isin(views[o], labels, sel_far, cfg.max_queries),
             lambda o=off: masked_compact_isin_plain(views[o], labels, sel_far, cfg.max_queries)),
        ]
    return cases


def synthetic_far(grid: GridSpec, n_clusters: int, seed: int):
    """A far mask and label grid of ``n_clusters`` small clusters (single
    voxels, collinear pairs and triples, L-shapes, coplanar squares, blobs)
    around the middle of the grid; labels are each cluster's least flat id."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = grid.shape
    far = np.zeros(grid.shape, bool)
    labels = np.full(grid.shape, SENTINEL, np.int32)
    shapes = [
        [(0, 0, 0)], [(0, 0, 0), (0, 0, 1)], [(0, 0, 0), (0, 1, 0), (0, 2, 0)],
        [(0, 0, 0), (0, 0, 1), (0, 1, 0)], [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)],
        [(0, y, x) for y in range(3) for x in range(3)], [(0, 0, 0), (1, 0, 0)],
    ]
    for c in range(n_clusters):
        base = np.array([rng.integers(4, nz - 8), rng.integers(20, ny - 20),
                         rng.integers(20, nx - 20)])
        if c < 2 * len(shapes):
            offs = np.array(shapes[c % len(shapes)])
        else:
            offs = rng.integers(0, 4, size=(int(rng.integers(4, 30)), 3))
        pts = base + offs
        if far[pts[:, 0], pts[:, 1], pts[:, 2]].any() or any(
            far[max(z - 2, 0):z + 3, max(y - 2, 0):y + 3, max(x - 2, 0):x + 3].any()
            for z, y, x in pts
        ):
            continue  # keep clusters apart
        fid = (pts[:, 0] * ny + pts[:, 1]) * nx + pts[:, 2]
        far[pts[:, 0], pts[:, 1], pts[:, 2]] = True
        labels[pts[:, 0], pts[:, 1], pts[:, 2]] = fid.min()
    return far, labels


def synthetic_far_list(grid: GridSpec, F: int, n_far: int, seed: int, dev):
    """A far list of capacity F (K6's form: ascending flat ids, then an
    invalid tail) holding ~n_far far voxels: synthetic_far's 48 compact
    clusters labelled with their least flat ids, two 3-plane columns labelled
    0 and 1 (slots 0 and 1) across the planes where the list crosses each
    multiple of the chunk kernels.K9_CHUNK, and scattered voxels in long
    ties of 100 labels just below SENTINEL.  Returns (fids, fvalid, labels
    of the list, ftotal)."""
    rng = np.random.default_rng(seed)
    far, labels = synthetic_far(grid, 48, seed)
    nz, ny, nx = grid.shape
    n_bg = max(n_far - int(far.sum()), 0)
    bg = rng.choice(grid.n_voxels, n_bg, replace=False)
    bg = bg[~far.reshape(-1)[bg]]
    far.reshape(-1)[bg] = True
    labels.reshape(-1)[bg] = SENTINEL - 1 - rng.integers(0, 100, len(bg))
    before = np.cumsum(far.sum(axis=(1, 2)))  # far voxels up to each plane
    crossings = [int(np.searchsorted(before, m)) for m in
                 range(kernels.K9_CHUNK, int(before[-1]), kernels.K9_CHUNK)]
    for i, z in enumerate(crossings[:2]):
        z = min(max(z, 1), nz - 2)
        y, x = 4 + 3 * i, 4
        far[z - 1:z + 2, y, x] = True
        labels[z - 1:z + 2, y, x] = i
    fids, fvalid, ftotal = masked_compact_plain(torch.as_tensor(far, device=dev), F)
    flab = torch.as_tensor(labels, device=dev).reshape(-1)[fids.long()]
    return fids, fvalid, flab, ftotal


def _stats_compare(ks, ps, what: str) -> dict:
    exact = ("reps", "slot_valid", "npts", "aabb_min", "aabb_max", "gated", "m_k", "qgate",
             "rep_sel", "cluster_overflow")
    for f in exact:
        a, b = getattr(ks, f), getattr(ps, f)
        if not torch.equal(a, b):
            n = int((a != b).sum())
            raise AssertionError(f"K9 {what}: {f} differs from the plain version in {n} entries")
    v = ps.slot_valid
    errs = {f: max_abs(getattr(ks, f)[v], getattr(ps, f)[v]) if bool(v.any()) else 0.0
            for f in ("obb_center", "obb_extent", "obb_size")}
    # an eigenvector's sign is arbitrary (the OBB is the same box either
    # way): each axis is compared as a line, and sign flips are counted
    d_same = (ks.axes[v] - ps.axes[v]).abs().amax(-1)
    d_flip = (ks.axes[v] + ps.axes[v]).abs().amax(-1)
    errs["axes"] = float(torch.minimum(d_same, d_flip).max()) if bool(v.any()) else 0.0
    flipped = (d_same > K9_TOL) & (d_flip <= K9_TOL)  # [slots, 3 axes]
    worst = max(errs.values())
    if not worst <= K9_TOL:
        raise AssertionError(f"K9 {what}: float max|d| {errs} > {K9_TOL}")
    flips = dict(rows=int(flipped.sum()),
                 slot_points=ps.npts[v][flipped.any(-1)].tolist())
    return dict(n_slots=int(v.sum()), cluster_overflow=bool(ps.cluster_overflow),
                n_gated=int(ps.gated.sum()), max_abs=errs, axis_sign_flips=flips)


def _random_field(grid: GridSpec, dyn: DynParams, seed: int, dev) -> torch.Tensor:
    """Air / unknown / ground voxels at 62 / 33 / 5 %: unknown pockets just
    above the percolation threshold, some touching ground, some not."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand(grid.shape, generator=g, device=dev)
    unk = 0.5 * (dyn.thr_frontiers + dyn.thr_new_obstacles)
    return torch.where(u < 0.62, -900.0, torch.where(u < 0.95, unk, -100.0)).float()


def _serpentine(grid: GridSpec, dyn: DynParams, dev):
    """All air but a winding one-voxel unknown corridor from one query voxel:
    a Jacobi BFS capped at 8 sweeps stops 8 voxels along it."""
    nz, ny, nx = grid.shape
    vals = np.full(grid.shape, -900.0, np.float32)
    unk = 0.5 * (dyn.thr_frontiers + dyn.thr_new_obstacles)
    z, y0, x0 = nz // 2, ny // 2, nx // 2
    path = []
    for leg in range(6):  # a zig-zag of 10-voxel legs in the x-y plane
        x_range = range(x0, x0 + 10) if leg % 2 == 0 else range(x0 + 9, x0 - 1, -1)
        path += [(z, y0 + 2 * leg, x) for x in x_range]
        if leg < 5:
            path.append((z, y0 + 2 * leg + 1, x_range[-1]))
    for p in path:
        vals[p] = unk
    q = torch.tensor([[x0], [y0], [z]], dtype=torch.int32, device=dev)
    return torch.as_tensor(vals, device=dev), q


def phase2_classify(cfg, dyn, grid, vals, k3, prev_bg, pose) -> list[dict]:
    """K6-K9 against their plain versions on the scan's classify inputs."""
    dev = vals.device
    counts, _, excl, _ = k3
    bg = split_and_update(cfg, dyn, vals, counts, prev_bg)
    far, labels = bg.far, bg.labels
    sensor_pos = pose[:3, 3].contiguous()
    true = torch.ones((), dtype=torch.bool, device=dev)
    S, K, Q = cfg.explore_submap, cfg.max_clusters, cfg.max_queries
    thr_f, thr_g = dyn.thr_frontiers, dyn.thr_new_obstacles
    out = []

    # K9 — the scan's far list, then a synthetic far set with > K clusters
    fids, fvalid, ftotal = masked_compact_plain(far, cfg.max_far_voxels)
    flab = labels.reshape(-1)[fids.long()]  # the far voxels' labels
    stats_args = (dyn, grid, K, fids, fvalid, flab, ftotal, sensor_pos, bg.bg_sufficient, true)
    explore_on = bg.bg_sufficient & ~(ftotal > cfg.max_far_voxels)
    ks = cluster_stats(*stats_args)
    ps = cluster_stats_plain(dyn, grid, K, fids, fvalid, flab, sensor_pos, explore_on)
    scan_cmp = _stats_compare(ks, ps, "scan far list")
    k9_ms = cuda_ms(lambda: cluster_stats(*stats_args))
    k9_plain = cuda_ms(lambda: cluster_stats_plain(dyn, grid, K, fids, fvalid, flab,
                                                   sensor_pos, explore_on))
    sfar_np, slab_np = synthetic_far(grid, 48, seed=9)
    sfar, slab = torch.as_tensor(sfar_np, device=dev), torch.as_tensor(slab_np, device=dev)
    sids, svalid, stotal = masked_compact_plain(sfar, cfg.max_far_voxels)
    centre = torch.tensor(grid.origin, device=dev) + 0.5 * grid.voxel_size * torch.tensor(
        grid.shape[::-1], dtype=torch.float32, device=dev)
    slab = slab.reshape(-1)[sids.long()]
    ks2 = cluster_stats(dyn, grid, K, sids, svalid, slab, stotal, centre, true, true)
    ps2 = cluster_stats_plain(dyn, grid, K, sids, svalid, slab, centre, true)
    syn_cmp = _stats_compare(ks2, ps2, "synthetic 48 clusters")
    if not syn_cmp["cluster_overflow"]:
        raise AssertionError("K9 synthetic case did not overflow the K slots")
    # large far lists: F = 8192 sorts in one block; past kernels.K9_SMEM_KEYS
    # the chunked path, its slots 0 and 1 spanning chunks
    large = {}
    for F in (8192, 20000):
        args = synthetic_far_list(grid, F, F - 600, seed=F, dev=dev)
        kl = cluster_stats(dyn, grid, K, *args, centre, true, true)
        pl = cluster_stats_plain(dyn, grid, K, *args[:3], centre, true)
        large[F] = _stats_compare(kl, pl, f"synthetic far list F = {F}")
        if not large[F]["cluster_overflow"] or large[F]["n_slots"] != K:
            raise AssertionError(f"K9 F = {F}: expected K full slots and an overflow")
        large[F].update(n_far=int(args[3]), chunked=F > kernels.K9_SMEM_KEYS,
                        ms=cuda_ms(lambda: cluster_stats(dyn, grid, K, *args, centre, true, true)))
    # the entry holds the scratch to its own SMEM_KEYS and CHUNK: a wrapper
    # whose constant sends F = 20000 down the one-launch sizing (no scratch)
    # is refused, not written past
    kernels.K9_SMEM_KEYS, keys = 1 << 20, kernels.K9_SMEM_KEYS
    try:
        cluster_stats(dyn, grid, K, *args, centre, true, true)
    except RuntimeError:
        refused = True
    else:
        refused = False
    finally:
        kernels.K9_SMEM_KEYS = keys
    if not refused:
        raise AssertionError("K9: a chunked call without its scratch was not refused")
    out.append(dict(
        name="cluster_stats", undersized_scratch_refused=refused, max_abs_err=max(*scan_cmp["max_abs"].values(),
                                              *syn_cmp["max_abs"].values(),
                                              *(v for c in large.values()
                                                for v in c["max_abs"].values())),
        tol=K9_TOL, ms=k9_ms, plain_ms=k9_plain, scan=scan_cmp, synthetic=syn_cmp,
        large_far_lists=large,
        # the far list and its labels in; K slots of statistics out
        bytes=cfg.max_far_voxels * (4 + 1 + 4) + K * 128, ops=cfg.max_far_voxels * 30 + K * 300,
        library_ms=None,
        n_far_scan=int(ftotal), n_far_synthetic=int(stotal),
        shapes=f"F={cfg.max_far_voxels}, K={K}; integers, bools, AABB bit-equal",
    ))

    # K6 — the compactions
    cases = _compact_cases(cfg, grid, excl, far, labels, ps.rep_sel)
    case_out, k6_err = {}, 0.0
    for name, kern, plain in cases:
        k, p = kern(), plain()
        k6_err = max(k6_err, _equal(k, p, f"K6[{name}].ids K6[{name}].valid K6[{name}].total"))
        case_out[name] = dict(total=int(p[2]), ms=cuda_ms(kern), plain_ms=cuda_ms(plain))
        # one launch and no memset a call (the step's three calls, the
        # misaligned views, the tiles past the resident blocks)
        if name.startswith(("far", "excl", "query isin(rep_sel)", "query at", "past")):
            case_out[name].update(one_launch_profile(kern, f"K6[{name}]"))
    if not case_out["overflow dense 2.47M->4096"]["total"] > 4096:
        raise AssertionError("K6 overflow case did not overflow")
    main = case_out["far 2.47M->2048"]
    nv = grid.n_voxels
    library = device_profile(lambda: torch.nonzero(far))
    out.append(dict(name="masked_compact", max_abs_err=k6_err, ms=main["ms"],
                    plain_ms=main["plain_ms"], device_ms=main["device_ms"],
                    device_ms_sweep_scan_calls=sum(case_out[c]["device_ms"] for c in (
                        "far 2.47M->2048", "excl 131072->4096",
                        "query isin(rep_sel) 2.47M->256")),
                    geometry=dict(zip(("tile_bytes", "resident_blocks"),
                                      kernels.compact_geometry())),
                    cases=case_out,
                    bytes=nv + cfg.max_far_voxels * 5 + 4, ops=nv, library_ms=cuda_ms(
                        lambda: torch.nonzero(far)), library_call="torch.nonzero of the far mask",
                    library_device_ms=library["device_ms"],
                    library_launches=library["cuda_launches"],
                    shapes="ms/plain_ms/device_ms: the far compaction; every case bit-equal"))

    # K7 — the scan's queries (the main path's shapes)
    qids, qvalid, qtotal = masked_compact_isin_plain(far, labels, ps.rep_sel, Q)
    qx, qy, qz = grid.unflatten_id(qids)
    qlab = torch.where(qvalid, labels.reshape(-1)[qids.long()], SENTINEL)
    qslot = qvalid[:, None] & (qlab[:, None] == ps.reps[None, :])
    m_q = (qslot.to(torch.int32) * ps.m_k[None, :]).sum(dim=1).to(torch.int32)
    scan_q = (grid, bg.grid, qx, qy, qz, qvalid, m_q, thr_f, thr_g, S)
    k7_err = _equal(explore(*scan_q), explore_plain(*scan_q), "K7.connected K7.reached K7.corners")
    k7_ms, k7_plain = cuda_ms(lambda: explore(*scan_q)), cuda_ms(lambda: explore_plain(*scan_q))
    # the Jacobi sweeps of the slowest valid query (K7's plain model)
    scan_sweeps = int(explore_planes_plain(*scan_q)[3].max())

    # K7 — 256 valid queries over a random field; K8 demotes their patches
    field = _random_field(grid, dyn, 7, dev)
    g = torch.Generator(device=dev).manual_seed(8)
    unk_ids = torch.nonzero(field.reshape(-1) > thr_f)[:, 0]  # queries start in the band
    pick = unk_ids[torch.randint(0, unk_ids.shape[0], (Q,), generator=g, device=dev)]
    rq = [t.to(torch.int32) for t in grid.unflatten_id(pick)]
    rq[0][:4] = torch.tensor([0, grid.nx - 1, 3, 5], dtype=torch.int32)  # grid-edge starts
    rvalid = torch.ones(Q, dtype=torch.bool, device=dev)
    rmm = torch.randint(0, 20, (Q,), generator=g, device=dev, dtype=torch.int32)
    syn_q = (grid, field, *rq, rvalid, rmm, thr_f, thr_g, S)
    kc, kr, kco = explore(*syn_q)
    k7_err = max(k7_err, _equal((kc, kr, kco), explore_plain(*syn_q),
                                "K7s.connected K7s.reached K7s.corners"))
    syn_sweeps = explore_planes_plain(*syn_q)[3]
    for side in (16, 62):  # the golden side, and 64-bit rows past 48 KB of shared memory
        q32 = (grid, field, *(t[:32] for t in rq), rvalid[:32], rmm[:32] + side // 4, thr_f,
               thr_g, side)
        k7_err = max(k7_err, _equal(explore(*q32), explore_plain(*q32),
                                    f"K7[S={side}].connected K7[S={side}].reached "
                                    f"K7[S={side}].corners"))
    # the grid path's call: shard 1 of 3's slab extended by the explore pad
    # (its z window), the random queries it owns
    nzl, pad = grid.nz // GRID_SHARDS, S // 2
    ext = _global_ext(field, nzl, nzl, pad, -1e30)
    own = rvalid & (rq[2] >= nzl) & (rq[2] < 2 * nzl)
    slab_q = (grid, ext, *rq, own, rmm, thr_f, thr_g, S, 96, (nzl - pad, grid.nz))
    k7_err = max(k7_err, _equal(explore(*slab_q), explore_plain(*slab_q),
                                "K7[slab].connected K7[slab].reached K7[slab].corners"))
    syn_ms = cuda_ms(lambda: explore(*syn_q))
    syn_plain = cuda_ms(lambda: explore_plain(*syn_q))

    # K7 — the serpentine corridor, capped at 8 sweeps
    sv, sq = _serpentine(grid, dyn, dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    mm = torch.full((1,), 40, dtype=torch.int32, device=dev)
    capped = explore(grid, sv, sq[0], sq[1], sq[2], one, mm, thr_f, thr_g, S, 8)
    k7_err = max(k7_err, _equal(
        capped, explore_plain(grid, sv, sq[0], sq[1], sq[2], one, mm, thr_f, thr_g, S, 8),
        "K7c.connected K7c.reached K7c.corners"))
    free = explore(grid, sv, sq[0], sq[1], sq[2], one, mm, thr_f, thr_g, S, 96)
    n_capped = int(sum(bin(int(w)).count("1") for w in capped[1].reshape(-1).tolist()))
    n_free = int(sum(bin(int(w)).count("1") for w in free[1].reshape(-1).tolist()))
    if not n_capped < n_free:
        raise AssertionError(f"serpentine: the cap did not bind ({n_capped} vs {n_free})")
    n_q = int(qvalid.sum())
    out.append(dict(
        name="explore_bfs", max_abs_err=k7_err, ms=k7_ms, plain_ms=k7_plain,
        # each valid query's S^3 submap in, its reached rows out
        bytes=n_q * S**3 * 4 + Q * (4 * 4 + 1) + Q * S * S * 8 + Q * 13,
        ops=n_q * S**3 * 7, library_ms=None,
        device=one_launch_profile(lambda: explore(*scan_q), "K7"),
        scan_valid_queries=int(qvalid.sum()), scan_max_sweeps=scan_sweeps,
        synthetic_ms=syn_ms, synthetic_plain_ms=syn_plain,
        synthetic_connected=int(kc.sum()), synthetic_max_sweeps=int(syn_sweeps.max()),
        synthetic_mean_sweeps=float(syn_sweeps.float().mean()),
        slab_valid_queries=int(own.sum()), serpentine_reached_capped=n_capped,
        serpentine_reached_free=n_free,
        shapes=f"Q={Q}, S={S}; ms/plain_ms: the scan's queries; synthetic: 256 valid queries",
    ))

    # K8 — the random batch's demotions: connected queries share slot 0,
    # the others spread over slots 1..K-1 (every slot gated), so those float
    slot_ids = torch.where(kc, 0, 1 + torch.arange(Q, device=dev) % (K - 1))
    sslot = slot_ids[:, None] == torch.arange(K, device=dev)[None, :]
    gate = torch.ones(K, dtype=torch.bool, device=dev)
    no_ovf = torch.zeros((), dtype=torch.bool, device=dev)
    dem = (kr, kco, sslot, kc, rvalid, gate, no_ovf, thr_f)
    pg, pn, pcc = demote_floating_plain(field, *dem)
    kg, kn, kcc = demote_floating(field.clone(), *dem)  # the count K7's launch zeroed
    k8_err = _equal((kg, kn, kcc), (pg, pn, pcc), "K8.grid K8.n_writes K8.cluster_connected")
    if int(pn) == 0:
        raise AssertionError("K8: the synthetic batch demoted nothing")
    # under query overflow: nothing demotes, cluster_connected still written
    kernels.demote_count(kco).zero_()
    ovf = torch.ones((), dtype=torch.bool, device=dev)
    k8_err = max(k8_err, _equal(demote_floating(field.clone(), *dem[:6], ovf, thr_f),
                                demote_floating_plain(field, *dem[:6], ovf, thr_f),
                                "K8o.grid K8o.n_writes K8o.cluster_connected"))
    work = field.clone()
    out.append(dict(
        name="demote", max_abs_err=k8_err,
        bytes=Q * S * S * 8 + Q * (12 + K + 2) + K + 2 * 4 * int(pn), ops=Q * S**3,
        library_ms=None,
        ms=cuda_ms(lambda: demote_floating(work, *dem)),
        plain_ms=cuda_ms(lambda: demote_floating_plain(field, *dem)),
        # one launch and no fill or memset a call
        device=one_launch_profile(lambda: demote_floating(work, *dem), "K8"),
        demotion_writes=int(pn), demoted_voxels=int((pg != field).sum()),
        connected_slots=int(pcc.sum()),
        shapes=f"Q={Q}, S={S}, random batch, {int((~kc).sum())} unconnected queries",
    ))
    return out


def _grid_cmp(a: torch.Tensor, b: torch.Tensor, ref: torch.Tensor, what: str) -> dict:
    """Two grids from the same input ``ref``: the same non-finite voxels, the
    same set of voxels changed from ``ref``; max |a - b| over the rest."""
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        raise AssertionError(f"{what}: non-finite voxels differ from the plain version")
    ch_a, ch_b = a != ref, b != ref
    if not torch.equal(ch_a, ch_b):
        raise AssertionError(f"{what}: the changed voxels differ from the plain version in "
                             f"{int((ch_a != ch_b).sum())} voxels")
    fin = torch.isfinite(b)
    return dict(max_abs=max_abs(a[fin], b[fin]) if bool(fin.any()) else 0.0,
                n_diff=int((a[fin] != b[fin]).sum()), n_changed=int(ch_b.sum()))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / |b| over the entries that differ (0.0 if none)."""
    a, b = a.double(), b.double()
    d = (a - b).abs()
    nz = d > 0
    return float((d[nz] / b[nz].abs().clamp(min=1e-30)).max()) if bool(nz.any()) else 0.0


def _rot(yaw: float, pitch: float, roll: float) -> np.ndarray:
    cy, sy, cp, sp, cr, sr = (np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch),
                              np.cos(roll), np.sin(roll))
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return (Rz @ Ry @ Rx).astype(np.float32)


def _synthetic_slots(cfg, grid: GridSpec, far, labels, sensor_pos, seed: int):
    """K slots for K10: clusters in two opposite grid corners and on an
    edge (their windows reach outside the grid, so every fill is read), boxes
    anywhere in the grid, and empty slots with the +-3e38 AABB of K9."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = grid.shape
    K = cfg.max_clusters
    far, labels = far.clone(), labels.clone()
    dev = far.device
    vs, org = grid.voxel_size, np.asarray(grid.origin, np.float32)
    lo = np.zeros((K, 3), np.float32)
    hi = np.zeros((K, 3), np.float32)
    reps = np.full(K, 2**31 - 1, np.int32)
    cls = rng.integers(0, 3, K).astype(np.int32)
    npts = rng.integers(0, 30, K).astype(np.int32)
    clusters = [  # (z, y, x) voxels
        [(0, 0, 0), (0, 0, 1), (1, 0, 0)],
        [(nz - 1, ny - 1, nx - 1), (nz - 1, ny - 1, nx - 2)],
        [(nz // 2, 0, nx - 1), (nz // 2, 1, nx - 1)],
    ]
    for k, vox in enumerate(clusters):
        v = np.array(vox)
        fid = (v[:, 0] * ny + v[:, 1]) * nx + v[:, 2]
        far.view(-1)[torch.as_tensor(fid, device=dev)] = True
        labels.view(-1)[torch.as_tensor(fid, device=dev)] = int(fid.min())
        c = (v[:, ::-1] + 0.5) * vs + org  # voxel centres (x, y, z)
        lo[k], hi[k] = c.min(0), c.max(0)
        reps[k], cls[k], npts[k] = fid.min(), CLS_MAV, len(vox)
    n_fixed = len(clusters)
    for k in range(n_fixed, K - 2):
        ctr = org + rng.uniform(0, 1, 3) * np.array([nx, ny, nz]) * vs
        half = rng.uniform(0, 1.0, 3)
        lo[k], hi[k] = ctr - half, ctr + half
        reps[k] = int(labels.view(-1)[int(rng.integers(0, grid.n_voxels))])
    lo[K - 2:], hi[K - 2:] = 3.0e38, -3.0e38  # empty slots
    cls[K - 2:] = 0
    obb = np.where(cls[:, None] > 0, 0.5 * (lo + hi), 0.0).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return far, labels, (t(lo), t(hi), t(reps), t(npts), t(cls), t(obb))


def _detect_compare(k, p, what: str, conf_equal: bool = True) -> dict:
    """K10's outputs ``k`` against the plain version's ``p``: valid, ids and
    the counter bit-equal, confidence too unless ``conf_equal`` is False (a
    sum in another order), and the floats within their bounds."""
    names = ("valid", "ids", "confidence", "pdet", "covariance", "counter")
    for i in (0, 1, 2, 5) if conf_equal else (0, 1, 5):
        if not torch.equal(k[i], p[i]):
            raise AssertionError(f"K10 {what}: {names[i]} differs from the plain version")
    errs = dict(confidence=_rel(k[2], p[2]), pdet=_rel(k[3], p[3]), covariance=_rel(k[4], p[4]))
    if not (errs["confidence"] <= K10_CONF_RTOL and errs["pdet"] <= K10_RTOL
            and errs["covariance"] <= K10_RTOL):
        raise AssertionError(f"K10 {what}: relative errors {errs}")
    return dict(rel_err=errs, mav_slots=int(p[0].sum()),
                max_abs=max(max_abs(k[i], p[i]) for i in (2, 3, 4)))


def phase2_stages(cfg, dyn, grid, lut, node, r_np, vals, k3, pose, kt, window) -> list[dict]:
    """K5a, K5b, K10 and both K11 entry points against their plain versions
    on the scan's inputs, plus synthetic cases."""
    dev = vals.device
    x0, y0, rel_x, rel_y, rel_z = window
    counts = k3[0]
    occupied = counts > 0
    rot = pose[:3, :3].contiguous()
    sensor_pos = pose[:3, 3].contiguous()
    H, W = lut.height, lut.width
    out = []

    # K5a — the step's image (all pixels cast: default mask, unit
    # intensity), the returns only, a random image under a pitched and
    # rolled pose, and a calibrated LUT (per-row elevation table)
    rng = np.random.default_rng(5)
    gate = make_angular_gate(lut)
    fd = torch.as_tensor(gate.face_dirs.reshape(-1, 3), device=dev)
    u = np.linspace(-1.0, 1.0, H)
    cal = make_lut_ouster(W, H, 3.0 * np.sin(np.linspace(0, 2 * np.pi, H)),
                          -22.5 * np.sign(u) * np.abs(u) ** 1.3, 15.806)
    gate_cal = make_angular_gate(cal)
    if gate_cal.el_rows is None:
        raise AssertionError("the calibrated LUT did not take the per-row elevation table")
    rand_img = torch.as_tensor(rng.random((H, W)) < 0.7, device=dev)
    rot2 = torch.as_tensor(_rot(0.7, 0.3, -0.2), device=dev)
    ranges = torch.as_tensor(r_np.astype(np.float32).reshape(H, W), device=dev)
    # the byte-by-byte pooling: an image view at byte offset 1, and a LUT
    # of 1000 columns (pooled by 5, which does not divide 16)
    shifted = torch.zeros(H * W + 16, dtype=torch.bool, device=dev)[1:1 + H * W].view(H, W)
    shifted.copy_(rand_img)
    lut1000 = make_lut_ouster(1000, H, np.zeros(H), np.linspace(22.5, -22.5, H), 15.806)
    gate1000 = make_angular_gate(lut1000)
    img1000 = torch.as_tensor(rng.random((H, 1000)) < 0.6, device=dev)
    cases = [
        ("scan", gate, torch.ones((H, W), dtype=torch.bool, device=dev), rot),
        ("returns only", gate, ranges > 0, rot),
        ("random, pitched", gate, rand_img, rot2),
        ("calibrated, random, pitched", gate_cal, rand_img, rot2),
        ("random, pitched, at byte 1", gate, shifted, rot2),
        (f"1000 columns pooled by {gate1000.pool_h}, pitched", gate1000, img1000, rot2),
    ]
    k5a, faces = {}, None
    for name, gt, img, R in cases:
        fdt = torch.as_tensor(gt.face_dirs.reshape(-1, 3), device=dev)
        tbl = row_table(gt, dev)
        kf = gate_faces(gt, fdt, img, R, tbl)
        pf = gate_faces_plain(gt, fdt, img, R, tbl)
        e = max_abs(kf, pf)
        if not e <= K5A_TOL:
            raise AssertionError(f"K5a {name}: max|d| {e} > {K5A_TOL}")
        k5a[name] = dict(max_abs=e, n_diff=int((kf != pf).sum()), mean=float(pf.mean()))
        if faces is None:
            faces = kf
    P = fd.shape[0]
    k5a_dev = one_launch_profile(lambda: gate_faces(gate, fd, cases[0][2], rot), "K5a")
    out.append(dict(
        name="gate_faces", max_abs_err=max(c["max_abs"] for c in k5a.values()), tol=K5A_TOL,
        # the image pooled, and each texel's trig and its tent support: at
        # most 2 x 4 cells, a weight and two products each
        bytes=H * W + P * (12 + 4) + 36, ops=H * W + P * (4 * 8 + 40),
        library_ms=None, **k5a_dev,
        ms=cuda_ms(lambda: gate_faces(gate, fd, cases[0][2], rot)),
        plain_ms=cuda_ms(lambda: gate_faces_plain(gate, fd, cases[0][2], rot)),
        cases=k5a, shapes=f"{H}x{W} image -> {tuple(faces.shape)} faces",
    ))

    # K5b — the scan's window: K4's T6, the K5a faces, both rules, its_diff
    # 1 and 2; kernel and plain version on separate clones.  The cull model
    # (ray_cull_plain, the bound's counts) tiles the window as the kernel does
    if kernels.ray_update_geometry() != RAY_TILE:
        raise AssertionError(f"K5b tile {kernels.ray_update_geometry()}, RAY_TILE {RAY_TILE}")
    c = RayConsts.make(grid.voxel_size, dyn.raycast_max_distance, cfg.sensor.vertical_fov,
                       H, W)
    k5b = {}
    for new_rule in (True, False):
        for its in (1.0, 2.0):
            ema = ray_ema(cfg, dataclasses.replace(dyn, raycast_new_update_rule=new_rule), its)
            args = (occupied, kt, faces, rel_x, rel_y, rel_z, rot, x0, y0, c, ema)
            a = ray_window_update_(vals.clone(), *args)
            b = ray_window_update_plain_(vals.clone(), *args)
            name = f"{'new' if new_rule else 'old'} rule, its_diff {its:g}"
            cmp = _grid_cmp(a, b, vals, f"K5b {name}")
            if not cmp["max_abs"] <= K5B_TOL_REL * abs(dyn.score_ray):
                raise AssertionError(f"K5b {name}: max|d| {cmp['max_abs']}")
            if cmp["n_changed"] == 0:
                raise AssertionError(f"K5b {name}: the EMA changed nothing")
            k5b[name] = cmp
    ema1 = ray_ema(cfg, dyn, 1.0)
    # the ungated sweep (make_step_fn(raycast_gate=False)): K5b without faces
    args0 = (occupied, kt, None, rel_x, rel_y, rel_z, rot, x0, y0, c, ema1)
    a = ray_window_update_(vals.clone(), *args0)
    b = ray_window_update_plain_(vals.clone(), *args0)
    cmp = _grid_cmp(a, b, vals, "K5b ungated")
    if not (cmp["max_abs"] <= K5B_TOL_REL * abs(dyn.score_ray) and cmp["n_changed"] > 0):
        raise AssertionError(f"K5b ungated (faces=None): {cmp}")
    k5b["ungated (faces=None), new rule, its_diff 1"] = cmp
    # where the cull can go wrong: a pitched and rolled pose (the FOV test
    # off the level), the sensor in a grid corner (the window clamped at
    # x0 = y0 = 0 and at nx - wx, ny - wy; its T6 from K4), T6 holding NaN
    # (the new rule culls it) and faces holding NaN (the old rule's max
    # keeps it, as torch.max does: every voxel the EMA reaches turns NaN)
    sz_ = float(sensor_pos[2])
    nz_, ny_, nx_ = grid.shape
    for where, pos in (("low", (1.5, 1.5)), ("high", (nx_ * grid.voxel_size - 2.0,
                                                      ny_ * grid.voxel_size - 1.5))):
        w = sweep_window(grid, np.array([grid.origin[0] + pos[0], grid.origin[1] + pos[1], sz_],
                                        np.float32), cfg.raycast_max_distance_bound)
        if (w[0], w[1]) != ((0, 0) if where == "low" else (nx_ - w[2], ny_ - w[3])):
            raise AssertionError(f"K5b case: the window {w[:4]} is not in the {where} corner")
        ex, ey, ez = _window_offsets(grid, *w, dev)
        tc = cone_sweep(occupied[:, w[1]:w[1] + w[3], w[0]:w[0] + w[2]].contiguous(), ex, ey, ez)
        for new_rule in (True, False):
            k5b[f"sensor in the {where} grid corner, {'new' if new_rule else 'old'} rule"] = (
                occupied, tc, faces, ex, ey, ez, rot, w[0], w[1], new_rule)
    rot_t = torch.as_tensor(_rot(0.4, 0.9, -0.7), device=dev)
    t_nan = kt.clone()
    t_nan.view(-1)[::101] = float("nan")
    f_nan = faces.clone()
    f_nan.view(-1)[::13] = float("nan")
    for new_rule in (True, False):
        r = "new" if new_rule else "old"
        k5b[f"pitched 52 and rolled -40 degrees, {r} rule"] = (
            occupied, kt, faces, rel_x, rel_y, rel_z, rot_t, x0, y0, new_rule)
        k5b[f"T6 holding NaN, {r} rule"] = (
            occupied, t_nan, faces, rel_x, rel_y, rel_z, rot, x0, y0, new_rule)
        k5b[f"faces holding NaN, {r} rule"] = (
            occupied, kt, f_nan, rel_x, rel_y, rel_z, rot, x0, y0, new_rule)
    for name, case in list(k5b.items()):
        if isinstance(case, dict):
            continue
        *a, new_rule = case
        ema = ray_ema(cfg, dataclasses.replace(dyn, raycast_new_update_rule=new_rule), 1.0)
        ka = ray_window_update_(vals.clone(), *a, c, ema)
        pa = ray_window_update_plain_(vals.clone(), *a, c, ema)
        cmp = _grid_cmp(ka, pa, vals, f"K5b {name}")
        if not (cmp["max_abs"] <= K5B_TOL_REL * abs(dyn.score_ray) and cmp["n_changed"] > 0):
            raise AssertionError(f"K5b {name}: {cmp}")
        cmp["non_finite"] = int((~torch.isfinite(pa)).sum())
        k5b[name] = cmp
    if k5b["faces holding NaN, old rule"]["non_finite"] == 0:
        raise AssertionError("K5b: NaN faces under the old rule made no voxel NaN")
    work_k, work_p = vals.clone(), vals.clone()
    args1 = (occupied, kt, faces, rel_x, rel_y, rel_z, rot, x0, y0, c, ema1)
    # the bytes this call needs: the point flag of the voxels in range, T of
    # those with no point, the grid value of those past the FOV test read
    # and of those changed written, the faces; the range test of the kept
    # tiles' voxels and the raylen and EMA of those past the FOV
    m = ray_cull_plain(kt, occupied[:, y0:y0 + rel_y.shape[0], x0:x0 + rel_x.shape[0]], rel_x,
                       rel_y, rel_z, rot, c, True)
    n_changed = k5b["new rule, its_diff 1"]["n_changed"]
    culls = {k: int(v.sum()) for k, v in m.items()}
    out.append(dict(
        name="ray_update", max_abs_err=max(v["max_abs"] for v in k5b.values()),
        bytes=culls["range"] + 4 * culls["had"] + 4 * culls["fov"] + 4 * n_changed
        + faces.numel() * 4, ops=culls["tile"] * 12 + culls["fov"] * 80, library_ms=None,
        tol=K5B_TOL_REL * abs(dyn.score_ray),
        ms=cuda_ms(lambda: ray_window_update_(work_k, *args1)),
        device_ms=device_profile(lambda: ray_window_update_(work_k, *args1))["device_ms"],
        plain_ms=cuda_ms(lambda: ray_window_update_plain_(work_p, *args1)),
        ungated_ms=cuda_ms(lambda: ray_window_update_(work_k, *args0)),
        window_voxels=m["tile"].numel(), passing=culls, cases=k5b,
        shapes=f"window {tuple(kt.shape[1:])} of {grid.shape}",
    ))

    # K10 — the scan's slots, then synthetic slots in grid corners and edges;
    # the plain version replays the window sum on DET_WARPS warps
    if kernels.detect_geometry() != DET_WARPS:
        raise AssertionError(f"K10 on {kernels.detect_geometry()} warps, DET_WARPS {DET_WARPS}")
    bg = split_and_update(cfg, dyn, vals, counts, node.state.bg_sufficient)
    cls = classify(cfg, dyn, grid, bg.grid, bg.far, bg.labels, bg.cc_converged, sensor_pos,
                   bg.bg_sufficient, node.state.sure_bg_sufficient)
    counter = torch.tensor(7, dtype=torch.int32, device=dev)
    dc = DetectConsts.make(cfg, dyn)
    CS = cfg.confidence_submap
    scan_args = (grid, CS, dc, cls.grid, bg.far, cls.labels, cls.aabb_min, cls.aabb_max,
                 cls.reps, cls.n_points, cls.cluster_class, cls.obb_center, sensor_pos, counter)
    scan_cmp = _detect_compare(detect_slots(*scan_args), detect_slots_plain(*scan_args), "scan")
    sfar, slab, slots = _synthetic_slots(cfg, grid, bg.far, cls.labels, sensor_pos, 10)
    syn_args = (grid, CS, dc, cls.grid, sfar, slab, *slots[:5], slots[5], sensor_pos, counter)
    syn_cmp = _detect_compare(detect_slots(*syn_args), detect_slots_plain(*syn_args),
                              "synthetic corners")
    # every slot mav (each reads its box ∩ window, boxes anywhere) and none
    k10 = {}
    for name, cls_all in (("every slot mav", CLS_MAV), ("no slot mav", 0)):
        a = (*syn_args[:10], torch.full_like(slots[4], cls_all), *syn_args[11:])
        k10[name] = _detect_compare(detect_slots(*a), detect_slots_plain(*a), name)
        if k10[name]["mav_slots"] != (cfg.max_clusters if cls_all else 0):
            raise AssertionError(f"K10 {name}: {k10[name]['mav_slots']} mav slots")
    # the bytes this call needs: the box ∩ window of each slot that keeps a
    # confidence (vals, far, labels), each slot's scalars and outputs
    lo, hi, ctr = detect_boxes(grid, cls.aabb_min, cls.aabb_max)
    keep = (cls.cluster_class == CLS_MAV).cpu()
    n_read = int(torch.clamp(torch.minimum(hi, ctr - CS // 2 + CS - 1)
                             - torch.maximum(lo, ctr - CS // 2) + 1, min=0).prod(1).cpu()[keep]
                 .sum())
    out.append(dict(
        name="detect", max_abs_err=max(scan_cmp["max_abs"], syn_cmp["max_abs"],
                                       *(v["max_abs"] for v in k10.values())),
        bytes=n_read * (4 + 1 + 4) + cfg.max_clusters * 100, ops=n_read * 4 + cfg.max_clusters * 40,
        library_ms=None,
        tol=dict(confidence_rel=K10_CONF_RTOL, pdet_cov_rel=K10_RTOL),
        ms=cuda_ms(lambda: detect_slots(*scan_args)),
        device_ms=device_profile(lambda: detect_slots(*scan_args))["device_ms"],
        plain_ms=cuda_ms(lambda: detect_slots_plain(*scan_args)),
        box_window_voxels_read=n_read, scan=scan_cmp, synthetic=syn_cmp, **k10,
        shapes=f"K={cfg.max_clusters} windows of {CS}^3; ids, valid, counter, confidence "
               "bit-equal",
    ))

    # K11 — the point EMA of the scan and of random counts (> 63 included);
    # the demotion EMA of the carried reach and of a random one, with
    # sure_sufficient True and False
    g = torch.Generator(device=dev).manual_seed(11)
    rnd_counts = torch.where(torch.rand(grid.shape, generator=g, device=dev) < 0.2,
                             torch.randint(0, 90, grid.shape, generator=g, device=dev), 0
                             ).to(torch.int32)
    rnd_close = torch.rand(grid.shape, generator=g, device=dev) < 0.5
    sp, su = float(dyn.score_point), float(dyn.score_unknown)
    pe = {}
    for name, cts, cl in (("scan", counts, bg.close), ("random", rnd_counts, rnd_close)):
        kk, pp = point_ema(vals, cts, cl, sp, su), point_ema_plain(vals, cts, cl, sp, su)
        _equal(kk, pp, f"K11p[{name}].grid K11p[{name}].far K11p[{name}].n_occupied")
        pe[name] = dict(n_occupied=int(pp[2]), changed=int((pp[0] != vals).sum()))
    radius = cfg.sepclusters_max_bg_distance / cfg.voxel_size
    bgm = vals > dyn.thr_new_obstacles
    rnd_bg = torch.rand(grid.shape, generator=g, device=dev) < 0.3
    rnd_safe = torch.rand(grid.shape, generator=g, device=dev) < 0.5
    true = torch.ones((), dtype=torch.bool, device=dev)
    # unsafe voxels in one corner: blocks that pool beside blocks that skip
    corner = torch.zeros_like(rnd_bg)
    corner[:20, :64, :96] = True
    de = {}
    for name, b_, s_, sure, its in (
            ("carried reach", bgm, node.state.safe, node.state.sure_bg_sufficient, 1.0),
            ("random, its_diff 2", rnd_bg, rnd_safe, true, 2.0),
            ("random, not sure", rnd_bg, rnd_safe, ~true, 1.0),
            ("random in one corner", rnd_bg & corner, rnd_safe, true, 1.0)):
        w1, cst = demote_weights(its, dyn.score_ray)
        kk = demote_ema(vals, b_, s_, sure, radius, w1, cst)
        pp = demote_ema_plain(vals, b_, s_, sure, radius, w1, cst)
        _equal((kk,), (pp,), f"K11d[{name}].grid")
        de[name] = dict(demoted=int((pp != vals).sum()))
    if (de["random, its_diff 2"]["demoted"] == 0 or de["random, not sure"]["demoted"] != 0
            or not 0 < de["random in one corner"]["demoted"] < grid.n_voxels // 4):
        raise AssertionError(f"K11 demotion cases did not exercise both branches: {de}")
    # case (a): the sweep scan's demotion at r 1.6 (19 taps, halo 1), and the
    # schedule the card chose for the flagship grid and for the grid paths'
    # slab (17 + 2 halo planes)
    de["schedule (a), flagship"] = kernels.demote_ema_schedule(
        vals, bgm, node.state.safe, true, *tap_set(radius), 0.5, -500.0)[1]
    slab = slice(0, grid.nz // GRID_SHARDS + 2 * tap_set(radius)[1])
    kk, de["schedule (a), grid slab"] = kernels.demote_ema_schedule(
        vals[slab].contiguous(), rnd_bg[slab].contiguous(), rnd_safe[slab].contiguous(), true,
        *tap_set(radius), 0.5, -500.0)
    _equal((kk,), (demote_ema_plain(vals[slab], rnd_bg[slab], rnd_safe[slab], true, radius, 0.5,
                                    -500.0),), "K11d[grid slab].grid")
    nv = grid.n_voxels
    out.append(dict(
        name="point_ema", max_abs_err=0.0, bytes=nv * (4 + 4 + 1 + 4 + 1), ops=nv * 6,
        library_ms=None,
        ms=cuda_ms(lambda: point_ema(vals, counts, bg.close, sp, su)),
        plain_ms=cuda_ms(lambda: point_ema_plain(vals, counts, bg.close, sp, su)),
        cases=pe, shapes=f"{grid.shape}, bit-equal",
    ))
    out.append(dict(
        name="demote_ema", max_abs_err=0.0, bytes=nv * (1 + 1 + 4 + 4),
        ops=nv * run_table(radius).combines(), library_ms=None,
        device_ms=device_profile(lambda: demote_ema(vals, bgm, node.state.safe, true, radius, 0.5,
                                                    -500.0))["device_ms"],
        ms=cuda_ms(lambda: demote_ema(vals, bgm, node.state.safe, true, radius, 0.5, -500.0)),
        plain_ms=cuda_ms(lambda: demote_ema_plain(vals, bgm, node.state.safe, true, radius,
                                                  0.5, -500.0)),
        cases=de, shapes=f"{grid.shape}, ball r={radius:g}, bit-equal",
    ))
    return out


def phase2_ingest(cfg, grid, lut, scans, n_scan, k3, ranges, pose) -> list[dict]:
    """K15a and the native host binner on a flagship scan: the unpack
    bit-equal to its plain version, the binner's counts (clamped to 63) and
    blockers bit-equal to K3's and the raw frontend's on the same scan; the
    host bin's time over the cycle and the packed upload's."""
    dev = ranges.device
    r_np, pose_np = scans[n_scan]
    hb = HostBinner(cfg, lut)
    if not hb.native:
        raise AssertionError("the host binner is not the native one")
    b = hb.bin(r_np, pose_np)
    packed = torch.as_tensor(b.packed, device=dev)
    ku, pu = unpack(packed), unpack_plain(packed)
    _equal(ku, pu, "K15a.counts K15a.blockers")
    raw = run_frontend(cfg, grid, torch.as_tensor(lut.directions, device=dev),
                       torch.as_tensor(lut.offsets, device=dev), ranges, pose)
    _equal((ku[0], ku[1]), (k3[0].clamp(max=63), raw.blockers),
           "binner-vs-K3.counts binner-vs-raw.blockers")
    if not (b.n_valid_points == int(k3[1]) and b.n_exclude_hits == int(raw.n_exclude_hits)):
        raise AssertionError(f"binner counts ({b.n_valid_points}, {b.n_exclude_hits}) differ "
                             f"from the raw frontend's ({int(k3[1])}, {int(raw.n_exclude_hits)})")
    bin_ms = []
    for r, p in scans:
        t0 = time.perf_counter()
        hb.bin(r, p)
        bin_ms.append((time.perf_counter() - t0) * 1e3)
    staging = [torch.empty(n, dtype=dt, pin_memory=True) for n, dt in (
        (grid.n_voxels, torch.uint8), (cfg.sensor.n_points, torch.uint8), (2, torch.int32))]
    upload_ms = cuda_ms(lambda: [t.to(dev, non_blocking=True) for t in staging])
    nv = grid.n_voxels
    lib_counts = torch.empty(packed.shape, dtype=torch.int32, device=dev)
    lib_blockers = torch.empty(packed.shape, dtype=torch.bool, device=dev)
    say("2-ingest", host_bin_ms_p50=float(np.percentile(bin_ms, 50)),
        host_bin_ms_p95=float(np.percentile(bin_ms, 95)), host_bin_scans=len(bin_ms),
        packed_upload_ms=upload_ms, packed_upload_bytes=nv + cfg.sensor.n_points + 8,
        n_valid_points=b.n_valid_points, n_exclude_hits=b.n_exclude_hits,
        clamped_voxels=int((k3[0] > 63).sum()), blocker_voxels=int(ku[1].sum()))
    two_ops = (lambda: (torch.bitwise_and(packed, 0x3F, out=lib_counts),
                        torch.ge(packed, 0x80, out=lib_blockers)))
    return [dict(
        name="unpack", max_abs_err=0.0, ms=cuda_ms(lambda: unpack(packed)),
        device_ms=device_profile(lambda: unpack(packed))["device_ms"],
        plain_ms=cuda_ms(lambda: unpack_plain(packed)),
        bytes=nv * (1 + 4 + 1), ops=2 * nv,
        library_ms=cuda_ms(two_ops), library_device_ms=device_profile(two_ops)["device_ms"],
        library_call="torch.bitwise_and(packed, 0x3F, out=int32 counts) and torch.ge(packed, "
                     "0x80, out=bool blockers): two torch ops writing the kernel's outputs",
        library_uint8_ms=cuda_ms(lambda: (packed & 0x3F, packed >= 0x80)),
        shapes=f"{grid.shape} uint8 -> int32 counts + bool blockers; bit-equal, and equal to "
               f"K3 + the raw frontend on the same scan",
    )]


def phase2_taps(cfg, grid, vals, occupied, safe) -> list[dict]:
    """The stencil kernels past 256 taps (K1, K2, K11's demotion; halo 4, 5,
    6 and 7, int32 tiles above 48 KB of shared memory from halo 6), and K14's
    shell pools at the dynamic-radii path's tap sets, bit-equal to their
    plain versions; K14's time beside K1's static pool on the same ball."""
    dyn = DynParams()
    dev = vals.device
    bg = vals > dyn.thr_new_obstacles
    sure = (vals > dyn.thr_sure_obstacles).to(torch.int32)
    nv = grid.n_voxels
    keys = torch.where(bg, torch.arange(nv, dtype=torch.int32, device=dev).reshape(grid.shape),
                       SENTINEL)
    cases = {}
    for rad, a, op, fill in ((4.0, bg.to(torch.int8), "max", 0), (5.0, sure, "sum", 0),
                             (6.0, keys, "max", -2**31), (7.99, keys, "min", SENTINEL)):
        k, p = ball_pool(a, rad, op, fill), ball_pool_plain(a, rad, op, fill)
        _equal((k,), (p,), f"K1[r{rad}].out")
        cases[f"K1 {a.dtype} {op} r{rad} ({len(ball_taps(rad))} taps)"] = cuda_ms(
            lambda: ball_pool(a, rad, op, fill), reps=5)
    flat = torch.arange(nv, dtype=torch.int32, device=dev).reshape(grid.shape)
    keys0 = torch.where(occupied, (nv - 1) - flat, SENTINEL)
    reach0 = (bg & (sure > 0)).to(torch.uint8)
    # K2's persistent launch up to halo 7 (2,103 taps: the large tap struct
    # and the int32 tile above 48 KB), its blocks from the occupancy
    # calculator at that tile
    for rad, init, occ in ((4.0, keys0, occupied), (5.0, reach0, bg), (7.99, keys0, occupied)):
        c = _k2_case(init, occ, rad, 4, reps=3)
        cases[f"K2 {init.dtype} r{rad} ({c['taps']} taps), 4 sweeps, one call"] = dict(
            ms=c["ms"], blocks=c["blocks"],
            tiles=c["tiles"])
    true = torch.ones((), dtype=torch.bool, device=dev)
    # K11's demotion past 256 taps, and the dynamic path's shells at 2.0 /
    # 1.9 m (case (b): bound 4, r² 14.44) and halo 7 (case (c)), on random
    # masks (demotions everywhere) and the scan's; the schedule the card
    # chose for the flagship grid and for the grid paths' slab of 17 + 2h
    # planes
    g = torch.Generator(device=dev).manual_seed(12)
    rnd_bg = torch.rand(grid.shape, generator=g, device=dev) < 0.02
    rnd_safe = torch.rand(grid.shape, generator=g, device=dev) < 0.5
    mdi = traced_radii(dynamic_config(), DynParams(sepclusters_max_bg_distance=1.9))[1]
    k11 = {}
    for name, ball in (("r4", 4.0), ("r5", 5.0),
                       ("(b) shells b4 r² 14.44", Shells(4.0, mdi * mdi)), ("(c) r7.99", 7.99)):
        taps, h = tap_set(ball)
        hit = 0
        for b_, s_ in ((bg, safe), (rnd_bg, rnd_safe)):
            k = demote_ema(vals, b_, s_, true, ball, 0.5, -500.0)
            _equal((k,), (demote_ema_plain(vals, b_, s_, true, ball, 0.5, -500.0),),
                   f"K11d[{name}].grid")
            hit += int((k != vals).sum())
        nzl = grid.nz // GRID_SHARDS + 2 * h
        slab = kernels.demote_ema_schedule(vals[:nzl].contiguous(), rnd_bg[:nzl].contiguous(),
                                           rnd_safe[:nzl].contiguous(), true, taps, h, 0.5,
                                           -500.0)
        _equal((slab[0],), (demote_ema_plain(vals[:nzl], rnd_bg[:nzl], rnd_safe[:nzl], true, ball,
                                             0.5, -500.0),), f"K11d[{name}, slab].grid")
        fn = lambda: demote_ema(vals, bg, safe, true, ball, 0.5, -500.0)  # noqa: E731
        k11[name] = dict(
            taps=len(taps), halo=h, demoted=hit, ms=cuda_ms(fn, reps=5),
            device_ms=device_profile(fn, reps=5)["device_ms"],
            schedule=kernels.demote_ema_schedule(vals, bg, safe, true, taps, h, 0.5, -500.0)[1],
            slab_schedule=dict(planes=nzl, **slab[1]))
        if hit == 0:
            raise AssertionError(f"K11 demotion [{name}] demoted nothing")
        cases[f"K11 demotion {name} ({len(taps)} taps)"] = k11[name]
    # K14 at the dynamic path's tap sets: bg_near at the 2 m bound (1.0 m:
    # r² 4), the local-sure sum at bound 5 (1.9 m: r² 25, 515 taps; 0.8 m:
    # r² 9), the demotion shells at bound 4 (0.8 m: r² 2.5600002)
    shells = []
    for bound, r2, a, op in ((4.0, 4.0, bg.to(torch.int8), "max"), (5.0, 25.0, sure, "sum"),
                             (5.0, 9.0, sure, "sum"),
                             (4.0, float(np.float32(1.6) * np.float32(1.6)), bg.to(torch.int8),
                              "max")):
        taps = shell_taps(bound, r2)
        k, p = shell_pool(a, r2, bound, op, 0), tap_pool_plain(a, taps, op, 0)
        _equal((k,), (p,), f"K14[b{bound} r2 {r2}].out")
        shells.append(f"{a.dtype} {op} bound {bound} r2 {r2:.7g} ({len(taps)} taps)")
    say("2-lifted-cap", ms=cases, k14_cases=shells)
    # the dynamic path's two K14 calls at its 2.0 / 1.9 m radii (bounds 4
    # and 5 index units): bg_near, int8 max r² 16 (257 taps), and the local
    # sure count, int32 sum r² 25 (515 taps)
    calls = []
    for a, r2, bound, op, what in ((bg.to(torch.int8), 16.0, 4.0, "max", "bg_near"),
                                   (sure, 25.0, 5.0, "sum", "local sure count")):
        n_bytes = 2 * a.numel() * a.element_size()
        n_ops = nv * run_table(Shells(bound, r2)).combines()
        calls.append(dict(
            call=f"{what}: {a.dtype} {op}, bound {bound}, r² {r2:g}",
            ms=cuda_ms(lambda: shell_pool(a, r2, bound, op, 0)),
            device_ms=device_profile(lambda: shell_pool(a, r2, bound, op, 0))["device_ms"],
            schedule=kernels.ball_pool_schedule(a, *tap_set(Shells(bound, r2)), op, 0)[1],
            bytes=n_bytes, ops=n_ops, **_bound(n_bytes, n_ops)))
    # one float32 convolution of the 0/1 sure grid with the r5 ball of ones:
    # the local sure count's values on the step's 0/1 inputs only
    ball_w = torch.zeros((1, 1, 11, 11, 11), dtype=torch.float32, device=dev)
    for dz, dy, dx in shell_taps(5.0, 25.0).tolist():
        ball_w[0, 0, dz + 5, dy + 5, dx + 5] = 1.0
    sure_f = sure.to(torch.float32)[None, None]
    conv = torch.nn.functional.conv3d(sure_f, ball_w, padding=5)[0, 0]
    if not torch.equal(conv.to(torch.int32), shell_pool(sure, 25.0, 5.0, "sum", 0)):
        raise AssertionError("F.conv3d of the 0/1 sure grid differs from K14's sum")
    return [dict(
        name="shell_pool", max_abs_err=0.0, ms=calls[1]["ms"], device_ms=calls[1]["device_ms"],
        plain_ms=cuda_ms(lambda: tap_pool_plain(sure, shell_taps(5.0, 25.0), "sum", 0), reps=3),
        bytes=calls[1]["bytes"], ops=calls[1]["ops"],
        library_ms=cuda_ms(lambda: torch.nn.functional.conv3d(sure_f, ball_w, padding=5)),
        library_call="F.conv3d of the 0/1 sure grid (float32, cudnn tf32 off) with the r5 "
                     "ball of ones: the local sure count's values on the step's 0/1 inputs only",
        k1_static_ms=cuda_ms(lambda: ball_pool(sure, 5.0, "sum", 0)), calls=calls,
        shapes=f"{grid.shape} int32 sum, bound 5, r² 25 (1.9 m): 515 taps, halo 5; cases "
               f"{shells} bit-equal",
    )]


# the wide forms' halos: fine-0125's ground ball (12), a local sure count
# past halo 7 (8) and a ball past K2's parameter limit (16)
WIDE_HALOS = (8, 12, 16)


def _crop_model(kernel_out, model_out, what: str) -> None:
    if not torch.equal(kernel_out, model_out):
        raise AssertionError(f"{what}: the kernel differs from its schedule's plain model")


def _pool_smem(table, dtype) -> int:
    """Dynamic shared bytes of K1's launch on ``table`` (csrc/ball_pool.cuh
    launch_pool: two pool buffers of a group's pairs, two staged planes,
    the rows' offsets; launch_pool_wide: the wide form's, its largest z
    piece's)."""
    if table.wide:
        return max(kernels.wide_pool_smem(p.halo, p.group, dtype, len(p.blob))
                   for p in table.pieces)
    txu, ty, nw, sw = 16, 16, 4, 48 if dtype == torch.int8 else 80
    sy = ty + 2 * table.halo
    g = min(len(table.runs), kernels.BALL_RUN_GROUP)
    return (2 * g * sy * txu * nw + 2 * sy * sw + len(table.rows)) * 4


def _sweep_smem(plan, halo: int, itemsize: int) -> int:
    """Dynamic shared bytes of K2's wide launch (csrc/propagate.cu
    launch_sweeps_wide: two pool buffers, the carry, two staged planes,
    the table)."""
    return kernels.sweep_wide_smem(halo, plan.group, itemsize, len(plan.blob))


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


_OPS = {"min": 0, "max": 1, "sum": 2}


def _k2_executed(plan) -> float:
    """Combines a voxel of a tile in K2's wide pool: its dz slices' rows,
    and its share of the x chains (2 a width) and other pairs of the tile's
    staged rows over its 4 + 2 h planes."""
    tz, ty, tx = kernels.TILE_ZYX
    h = plan.halo
    rows = sum(int(plan.slices[q, 1] - plan.slices[q, 0])
               for g in range(plan.n_groups) for q in plan.zslice[g].tolist() if q >= 0)
    xs = 2 * max(int(c1) for _, c1, _ in plan.chain.tolist()) + sum(
        hi - lo for lo, hi in plan.runs.tolist() if lo != -hi)
    return rows + (tz + 2 * h) * (ty + 2 * h) * tx * xs / (tz * ty * tx)


def _timed(fn, name: str, n_bytes: float, n_ops: float) -> dict:
    """One call of a wide form: event ms, device ms and kernels a call
    (torch.profiler), its launches a call (the wrapper's count) and its
    bound."""
    kernels.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()[name]
    dp = device_profile(fn, reps=3)
    return dict(ms=cuda_ms(fn, reps=5), device_ms=dp["device_ms"],
                device_kernels=dp["cuda_launches"], launches_a_call=launches,
                bytes=n_bytes, ops=n_ops, **_bound(n_bytes, n_ops))


def phase2_wide(cfg, grid, vals, occupied) -> list[dict]:
    """The stencil kernels past halo 7 (their wide forms) at halo 8, 12 and
    16 on the flagship scan's inputs: K1 int8 max and int32 sum, K14's
    shells (the shells of a bound b kept at r² b²), K2's label and reach
    sweeps (one persistent call of 8), K2's batched launch on the 3 shards
    at r 12, K11's demotion and K13c (leaf ceil(r) - 1, as the exact census
    takes it).  Each bit-equal to its plain version on the whole grid and,
    on the grid's first 20 planes, to the plain model of its schedule (K1's
    wide table through ``ball_pool_runs_plain``, K2's tile pool through
    ``sweeps_tiled_plain``, the demotions' through their runs models) at
    the z chunk the card chose; event ms, device ms, launches a call, the
    combines a voxel (the function's and the schedule's), registers,
    shared bytes and blocks an SM, and the bound of each case (on the
    function's combines: K2's at every voxel of the tiles computed), and
    K1's r 8 sum beside ``F.conv3d``.  Returns the kernels' records."""
    dyn = DynParams()
    dev = vals.device
    nv = grid.n_voxels
    bg = vals > dyn.thr_new_obstacles
    sure = (vals > dyn.thr_sure_obstacles).to(torch.int32)
    bg8 = bg.to(torch.int8)
    crop = slice(0, 20)
    flat = torch.arange(nv, dtype=torch.int32, device=dev).reshape(grid.shape)
    keys0 = torch.where(occupied, (nv - 1) - flat, SENTINEL)
    reach0 = (bg & (sure > 0)).to(torch.uint8)
    true = torch.ones((), dtype=torch.bool, device=dev)
    cases: dict = {"K1": {}, "K14": {}, "K2": {}, "K11": {}, "K13c": {}}

    def pool_case(a, ball, op, what, wrapper, count):
        taps, h = tap_set(ball)
        table = run_table(ball)
        k = wrapper(a)
        _equal((k,), (pool_plain(a, ball, op, 0),), f"{what}.out")
        ac = a[crop].contiguous()
        kc, used = kernels.ball_pool_schedule(ac, taps, h, op, 0)
        _crop_model(kc, ball_pool_runs_plain(ac, table, op, 0,
                                             kernels.BALL_POOL_TILE[a.dtype], used["zchunk"]),
                    what)
        # the function's combines, whatever the schedule (the table's own beside them)
        n_bytes, n_ops = 2 * a.numel() * a.element_size(), nv * pool_combines(taps)
        sched = kernels.ball_pool_schedule(a, taps, h, op, 0)[1]
        code = "a" if a.dtype == torch.int8 else "i"
        return dict(taps=len(taps), halo=h, pieces=table.n_pieces, set_voxels=int((k > 0).sum()),
                    combines_a_voxel=pool_combines(taps),
                    executed_combines_a_voxel=table.combines(),
                    groups=[p.n_groups for p in table.pieces],
                    registers=_registers(f"ball_pool_wide_kernelI{code}Li{_OPS[op]}E",
                                         piece=table.n_pieces > 1),
                    smem_bytes=_pool_smem(table, a.dtype), schedule=sched,
                    blocks_per_sm=sched["blocks_per_sm"],
                    plain_ms=cuda_ms(lambda: pool_plain(a, ball, op, 0), reps=3),
                    **_timed(lambda: wrapper(a), count, n_bytes, n_ops))

    for h in WIDE_HALOS:
        for a, op in ((bg8, "max"), (sure, "sum")):
            cases["K1"][f"{a.dtype} {op} r{h}"] = pool_case(
                a, float(h), op, f"K1w[{op} r{h}]", lambda x, h=h, op=op: ball_pool(x, float(h), op, 0),
                "ball_pool_wide")
        a, op = (sure, "sum") if h == 12 else (bg8, "max")
        sh = Shells(float(h), float(h * h))
        cases["K14"][f"{a.dtype} {op} bound {h}, r² {h * h}"] = pool_case(
            a, sh, op, f"K14w[b{h}]",
            lambda x, h=h, op=op: shell_pool(x, float(h * h), float(h), op, 0), "shell_pool_wide")
    # a set past WIDE_ZHALO in z: two z pieces (PieceIO, the fold scratch)
    z_cut = cases["K1"]["torch.int8 max r20, z cut"] = pool_case(
        bg8, 20.0, "max", "K1w[max r20]", lambda x: ball_pool(x, 20.0, "max", 0),
        "ball_pool_wide")
    if z_cut["launches_a_call"] != 2 or z_cut["pieces"] != 2:
        raise AssertionError(f"K1w[max r20]: {z_cut['launches_a_call']} launches, "
                             f"{z_cut['pieces']} pieces; 2 z pieces expected")
    # the library call: F.conv3d of the 0/1 sure grid with the r 8 ball (the
    # int32 sum's values on 0/1 inputs only)
    sure_f = sure.to(torch.float32)[None, None]
    w8 = torch.zeros((17, 17, 17), dtype=torch.float32, device=dev)
    t8 = torch.from_numpy(ball_taps(8.0)).to(dev).long() + 8
    w8[t8[:, 0], t8[:, 1], t8[:, 2]] = 1.0
    conv = torch.nn.functional.conv3d(sure_f, w8[None, None], padding=8)
    if not torch.equal(conv[0, 0].round().to(torch.int32), ball_pool(sure, 8.0, "sum", 0)):
        raise AssertionError("F.conv3d of the sure grid differs from K1's r 8 sum")
    cases["K1"]["torch.int32 sum r8"]["library_ms"] = cuda_ms(
        lambda: torch.nn.functional.conv3d(sure_f, w8[None, None], padding=8), reps=5)
    say("2-wide-k1", k1=cases["K1"], k14=cases["K14"])

    for h in WIDE_HALOS:
        for what, init, occ in (("label", keys0, occupied), ("reach", reach0, bg)):
            c = _k2_case(init, occ, float(h), cfg.cc_sweeps, reps=3)
            crop_k = sweeps(init[crop].contiguous(), occ[crop].contiguous(), float(h),
                            cfg.cc_sweeps)
            crop_m = sweeps_tiled_plain(init[crop].contiguous(), occ[crop].contiguous(), float(h),
                                        cfg.cc_sweeps)
            _equal(crop_k, crop_m[:2], "K2w.crop_grid K2w.crop_flags")
            taps = tap_set(float(h))[0]
            plan = kernels.sweep_plan(taps, h, init.element_size())
            n_bytes = nv * (2 * init.element_size() + 1)
            # the function's combines at every voxel of the tiles computed
            n_ops = sum(c["tiles"]) * 32 * 8 * 4 * pool_combines(taps)
            mode = "Ii" if init.dtype == torch.int32 else "Ih"
            c.update(pairs=len(plan.runs), groups=plan.n_groups, table_ints=len(plan.blob),
                     combines_a_voxel=pool_combines(taps),
                     executed_combines_a_voxel=_k2_executed(plan),
                     registers=_registers(f"sweeps_kernel{mode}", "WideTaps"),
                     smem_bytes=_sweep_smem(plan, h, init.element_size()),
                     blocks_per_sm=c["blocks"] / _sms(),
                     **_timed(lambda init=init, occ=occ, h=h: sweeps(init, occ, float(h),
                                                                      cfg.cc_sweeps),
                              "propagate_sweeps_wide", n_bytes, n_ops))
            cases["K2"][f"{what} r{h}, {cfg.cc_sweeps} sweeps"] = c
    say("2-wide-k2", cases=cases["K2"])

    g = torch.Generator(device=dev).manual_seed(27)
    rnd_bg = torch.rand(grid.shape, generator=g, device=dev) < 0.01
    rnd_safe = torch.rand(grid.shape, generator=g, device=dev) < 0.5
    for h in WIDE_HALOS + (20,):  # r 20.5: two z pieces
        ball = h + 0.5
        taps, hh = tap_set(ball)
        k = demote_ema(vals, rnd_bg, rnd_safe, true, ball, 0.5, -500.0)
        _equal((k,), (demote_ema_plain(vals, rnd_bg, rnd_safe, true, ball, 0.5, -500.0),),
               f"K11w[r{ball}].grid")
        args = (vals[crop].contiguous(), rnd_bg[crop].contiguous(), rnd_safe[crop].contiguous(),
                true, taps, hh, 0.5, -500.0)
        kc, used = kernels.demote_ema_schedule(*args)
        _crop_model(kc, demote_ema_runs_plain(*args[:4], ball, 0.5, -500.0, used["zchunk"]),
                    f"K11w[r{ball}]")
        pieces = run_table(ball).n_pieces
        cases["K11"][f"r{ball}"] = dict(
            taps=len(taps), halo=hh, demoted=int((k != vals).sum()),
            pieces=pieces, combines_a_voxel=pool_combines(taps),
            executed_combines_a_voxel=run_table(ball).combines(),
            registers=_registers("demote_ema_wide_kernel", "DemoteIO", piece=pieces > 1),
            smem_bytes=_pool_smem(run_table(ball), torch.int8),
            blocks_per_sm=kernels.demote_ema_schedule(vals, rnd_bg, rnd_safe, true, taps, hh,
                                                      0.5, -500.0)[1]["blocks_per_sm"],
            plain_ms=cuda_ms(lambda: demote_ema_plain(vals, rnd_bg, rnd_safe, true, ball, 0.5,
                                                      -500.0), reps=3),
            **_timed(lambda ball=ball: demote_ema(vals, rnd_bg, rnd_safe, true, ball, 0.5, -500.0),
                     "demote_ema_wide", nv * (1 + 1 + 4 + 4), nv * pool_combines(taps)))
    for h in WIDE_HALOS:
        rad, lsz = float(h), h - 1
        cshape = tuple(-(-n // lsz) for n in grid.shape)
        occ_c = torch.rand(cshape, generator=g, device=dev) < 0.3
        census = torch.randint(0, 10, cshape, generator=g, device=dev, dtype=torch.int32)
        flags = torch.tensor([True, True], device=dev)
        prev = torch.zeros((), dtype=torch.bool, device=dev)
        args = (occ_c, census, flags, prev, lsz, rad, 5.0, 0.9, -500.0, -300.0)
        _equal(exact_demote_ema(vals, *args), exact_demote_ema_plain(vals, *args),
               f"K13cw[r{h}].grid K13cw[r{h}].safe K13cw[r{h}].sure")
        vc = vals[:2 * lsz].contiguous()  # whole coarse rows
        occ_cc, census_c = occ_c[:2].contiguous(), census[:2].contiguous()
        kc = kernels.exact_demote_ema_schedule(vc, occ_cc, census_c, flags, prev, lsz,
                                               *tap_set(rad), 5.0, 0.9, -500.0, -300.0)
        mc = exact_demote_runs_plain(vc, occ_cc, census_c, flags, prev, lsz, rad, 5.0, 0.9,
                                     -500.0, -300.0, None, kc[3]["zchunk"])
        _equal(kc[:3], mc, f"K13cw[r{h}, model].grid K13cw[r{h}, model].safe "
                           f"K13cw[r{h}, model].sure")
        n_cells = occ_c.numel()
        cases["K13c"][f"r{h} leaf {lsz}"] = dict(
            taps=len(ball_taps(rad)), halo=h, pieces=run_table(rad).n_pieces,
            combines_a_voxel=pool_combines(ball_taps(rad)),
            executed_combines_a_voxel=run_table(rad).combines(),
            registers=_registers("exact_demote_wide_kernel", "CentreIO"),
            smem_bytes=_pool_smem(run_table(rad), torch.int8),
            blocks_per_sm=kc[3]["blocks_per_sm"],
            demoted=int((exact_demote_ema(vals, *args)[0] != vals).sum()),
            plain_ms=cuda_ms(lambda: exact_demote_ema_plain(vals, *args), reps=3),
            **_timed(lambda args=args: exact_demote_ema(vals, *args), "exact_demote_ema_wide",
                     nv * (4 + 4 + 1) + n_cells * 5, nv * pool_combines(ball_taps(rad))))
    say("2-wide-demotions", k11=cases["K11"], k13c=cases["K13c"])

    def record(name, case, **kw):
        return dict(name=name, max_abs_err=0.0, ms=case["ms"], device_ms=case["device_ms"],
                    plain_ms=case["plain_ms"], bytes=case["bytes"], ops=case["ops"],
                    library_ms=case.get("library_ms"), launches_a_call=case["launches_a_call"],
                    **kw)
    k1 = cases["K1"]["torch.int8 max r12"]
    return [
        record("ball_pool_wide", k1, cases=cases["K1"],
               shapes=f"{grid.shape}; the record: int8 max r 12 (fine-0125's ground ball, "
                      f"{k1['taps']} taps, {k1['pieces']} launch; F.conv3d of the 0/1 grid "
                      "with the r 8 ball beside the int32 sum r 8 case)"),
        record("shell_pool_wide", cases["K14"]["torch.int32 sum bound 12, r² 144"],
               cases=cases["K14"], shapes=f"{grid.shape}; the record: int32 sum, bound 12"),
        record("propagate_sweeps_wide", cases["K2"][f"label r12, {cfg.cc_sweeps} sweeps"],
               cases=cases["K2"], shapes=f"{grid.shape}; the record: {cfg.cc_sweeps} label "
                                         "sweeps at r 12 from the scan's keys"),
        record("demote_ema_wide", cases["K11"]["r8.5"], cases=cases["K11"],
               shapes=f"{grid.shape}; random 1 % bg, 50 % safe; the record: r 8.5"),
        record("exact_demote_ema_wide", cases["K13c"]["r8 leaf 7"], cases=cases["K13c"],
               shapes=f"{grid.shape}; random coarse cells; the record: r 8, leaf 7"),
    ]


def exact_config() -> VoFODConfig:
    """The reference-exact configuration at the flagship size."""
    return VoFODConfig(sepclusters_exact_census=True, compat_hascloseto_bounds=True,
                       compat_counted_indexing=True)


def _rel_stats(a: torch.Tensor, b: torch.Tensor) -> dict:
    """|a - b| / |b| over the voxels where b > 0: max and 99.9th percentile."""
    nz = b > 0
    r = ((a[nz].double() - b[nz].double()).abs() / b[nz].double())
    q = torch.quantile(r[torch.randperm(r.numel(), device=r.device)[:1_000_000]], 0.999)
    return dict(max=float(r.max()), p999=float(q), n_differ=int((a[nz] != b[nz]).sum()))


def _dda_check(grid: GridSpec, rays, bound: float, k12: torch.Tensor, what: str) -> dict:
    """K12's walk ``k12`` of ``rays`` against the plain version's sequential
    float32 sum on the host CPU (the JAX order; the plain version on the
    card adds with atomics) and against the float64 sum of the same chords
    rounded once, which the kernel's float64 adds give up to one ulp; five
    walks.  Raises past the contract."""
    nv = grid.n_voxels
    cpu_rays = [t.cpu() for t in rays]
    fid_c, w_c = dda_emissions_plain(grid, *cpu_rays, bound)
    p12 = torch.zeros(nv, dtype=torch.float32).index_add_(0, fid_c, w_c).reshape(grid.shape)
    p12 = p12.to(k12.device)
    e64 = torch.zeros(nv, dtype=torch.float64).index_add_(0, fid_c, w_c.double())
    e64 = e64.reshape(grid.shape).to(k12.device)
    e12 = e64.float()
    ulp = torch.nextafter(e12, torch.full_like(e12, float("inf"))) - e12
    if not torch.equal(k12 > 0, p12 > 0):
        raise AssertionError(f"K12 {what}: nonzero voxels differ in "
                             f"{int(((k12 > 0) != (p12 > 0)).sum())}")
    rel = _rel_stats(k12, p12)
    walks = [k12] + [raycast_dda(grid, *rays, bound) for _ in range(4)]
    off_ulp = [int((w_ != e12).sum()) for w_ in walks]
    if not (rel["max"] <= K12_RAYLEN_RTOL
            and all(bool(((w_ - e12).abs() <= ulp).all()) for w_ in walks)):
        raise AssertionError(f"K12 {what} raylen: {rel} (tol {K12_RAYLEN_RTOL}); voxels off "
                             f"the rounded float64 sum in five walks {off_ulp}")
    return dict(
        max_abs_err=max_abs(k12, p12), rel=rel,
        sequential_own_rel=_rel_stats(p12.double(), e64)["max"],
        off_rounded_f64_sum_per_walk=off_ulp,
        walks_identical=all(torch.equal(w_, k12) for w_ in walks),
        nonzero_voxels=int((p12 > 0).sum()), emissions=int(fid_c.numel()),
        valid_rays=int(rays[3].sum()), max_voxel_raylen=float(p12.max()),
        emissions_dev=(fid_c.to(k12.device), w_c.to(k12.device)), plain_dev=p12)


def phase2_exact(lut) -> list[dict]:
    """K12, K13 and the exact path's K1 / K2 uses against their plain
    versions, on a flagship exact scan and on synthetic cases."""
    dev = torch.device("cuda")
    cfg, dyn = exact_config(), DynParams()
    grid = GridSpec.from_config(cfg)
    nv = grid.n_voxels
    node = VoFOD(cfg, dyn, NodeOptions(raycast_mode="exact"), lut, device=dev)
    node.load_apriori_map(apriori_ground())
    scans = scan_cycle(lut, N_SCANS)
    for r, p in scans[:6]:
        node.process_scan(r, None, p)
    r_np, pose_np = scans[6]
    vals = node.state.grid
    H, W = lut.height, lut.width
    ranges_m = torch.as_tensor(r_np.astype(np.float32), device=dev) * 0.001
    ones = torch.ones(H * W, dtype=torch.float32, device=dev)
    pose = torch.as_tensor(pose_np, device=dev)
    rays = exact_rays(cfg, dyn, grid, torch.as_tensor(lut.directions, device=dev),
                      torch.as_tensor(lut.offsets, device=dev),
                      torch.ones(H * W, dtype=torch.bool, device=dev), ranges_m, ones, pose)
    bound = cfg.raycast_max_distance_bound
    out = []

    # K12 walk on the scan's rays, and on as many rays from the sensor in
    # random directions (each warp diverging at once, few shared voxels)
    k12 = raycast_dda(grid, *rays, bound)
    g = torch.Generator(device=dev).manual_seed(12)
    n_rays = rays[0].shape[0]
    rdirs = torch.randn((n_rays, 3), generator=g, device=dev)
    rdirs = rdirs / torch.linalg.vector_norm(rdirs, dim=1, keepdim=True)
    scattered = (pose[:3, 3].expand(n_rays, 3).contiguous(), rdirs,
                 torch.rand(n_rays, generator=g, device=dev) * bound,
                 torch.ones(n_rays, dtype=torch.bool, device=dev))
    rec = _dda_check(grid, rays, bound, k12, "scan rays")
    fid_d, w_d = rec.pop("emissions_dev")
    p12 = rec.pop("plain_dev")
    zero_grid = torch.zeros(nv, dtype=torch.float32, device=dev)
    k12_scattered = raycast_dda(grid, *scattered, bound)
    random_dirs = _dda_check(grid, scattered, bound, k12_scattered, "random directions")
    del random_dirs["emissions_dev"], random_dirs["plain_dev"]
    # K15b-6c's skip and stop rules on the diverging rays: the grid-exact
    # path's three slabs bit-equal to K12's rows
    nzl = grid.nz // GRID_SHARDS
    slabs = [raycast_dda_slab(grid, *scattered, bound, (i * nzl, nzl))
             for i in range(GRID_SHARDS)]
    if not torch.equal(torch.cat(slabs), k12_scattered):
        raise AssertionError(f"K15b-6c slabs of the random directions differ from K12 in "
                             f"{int((torch.cat(slabs) != k12_scattered).sum())} voxels")
    random_dirs["slabs_equal"] = True
    random_dirs["ms"] = cuda_ms(lambda: raycast_dda(grid, *scattered, bound))
    out.append(dict(
        name="dda", max_abs_err=max(rec["max_abs_err"], random_dirs["max_abs_err"]),
        **{k: v for k, v in rec.items() if k != "max_abs_err"}, tol_rel=K12_RAYLEN_RTOL,
        random_directions=random_dirs,
        ms=cuda_ms(lambda: raycast_dda(grid, *rays, bound)),
        plain_ms=cuda_ms(lambda: raycast_dda_plain(grid, *rays, bound), reps=3),
        # rays in, the raylen grid out once; ~20 ops per walked step
        bytes=n_rays * (12 + 12 + 4 + 1) + nv * 4, ops=rec["emissions"] * 20,
        library_ms=cuda_ms(lambda: zero_grid.index_add_(0, fid_d, w_d)),
        library_call="index_add_ of the walk's nonzero (id, chord) emissions: the scatter "
                     "half only (the walk that finds the emissions is not timed)",
        shapes=f"{n_rays} rays x <= {dda_n_steps(grid.voxel_size, bound)} steps -> "
               f"{grid.shape}",
    ))

    # K12 EMA pass: both rules, its_diff 1 and 2, on the kernel's raylen
    # (bit-equal expected), and walk + EMA against the host plain raylen
    counts = frontend_bin(cfg, grid, torch.as_tensor(lut.directions, device=dev),
                          torch.as_tensor(lut.offsets, device=dev),
                          torch.as_tensor(r_np.astype(np.float32), device=dev), pose)[0]
    had = counts > 0
    ema_cases = {}
    for new_rule in (True, False):
        for its in (1.0, 2.0):
            ema = ray_ema(cfg, dataclasses.replace(dyn, raycast_new_update_rule=new_rule), its)
            name = f"{'new' if new_rule else 'old'} rule, its_diff {its:g}"
            a = ray_ema_grid_(vals.clone(), had, k12, ema)
            b = ray_ema_plain(vals, k12, had, ema)
            _equal((a,), (b,), f"K12e[{name}].grid")
            # walk + EMA against the EMA of the sequential raylen: the same
            # nonzero raylen voxels (checked above), the grid within K5b's
            # bound; a chord of a few ulps can move w1 to or from exactly 1,
            # so the sets of changed voxels may differ by a few voxels
            c = ray_ema_plain(vals, p12, had, ema)
            fin = torch.isfinite(c)
            full = dict(max_abs=max_abs(a[fin], c[fin]), n_diff=int((a[fin] != c[fin]).sum()),
                        changed_differ=int(((a != vals) != (c != vals)).sum()))
            if not (torch.equal(fin, torch.isfinite(a))
                    and full["max_abs"] <= K5B_TOL_REL * abs(dyn.score_ray)):
                raise AssertionError(f"K12 walk+EMA {name}: {full}")
            ema_cases[name] = dict(changed=int((b != vals).sum()), walk_and_ema=full)
    # the old rule's max keeps a NaN raylen, as torch.max does: every voxel
    # the EMA reaches turns NaN, in the kernel as in the plain version
    ema = ray_ema(cfg, dataclasses.replace(dyn, raycast_new_update_rule=False), 1.0)
    rl_nan = k12.clone()
    rl_nan.view(-1)[::100003] = float("nan")
    a = ray_ema_grid_(vals.clone(), had, rl_nan, ema)
    b = ray_ema_plain(vals, rl_nan, had, ema)
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not (torch.equal(nan_a, nan_b) and torch.equal(a[~nan_a], b[~nan_b])
            and int(nan_b.sum()) > 0):
        raise AssertionError(f"K12e old rule, raylen holding NaN: {int(nan_a.sum())} NaN voxels "
                             f"against the plain version's {int(nan_b.sum())}")
    ema_cases["old rule, raylen holding NaN"] = dict(nan_voxels=int(nan_b.sum()))
    ema1 = ray_ema(cfg, dyn, 1.0)
    ema_touched = int(((k12 > 0) & ~had).sum())
    work = vals.clone()
    out.append(dict(
        name="ray_ema", max_abs_err=0.0, cases=ema_cases,
        tol_walk_and_ema=K5B_TOL_REL * abs(dyn.score_ray),
        ms=cuda_ms(lambda: ray_ema_grid_(work, had, k12, ema1)),
        plain_ms=cuda_ms(lambda: ray_ema_plain(vals, k12, had, ema1)),
        # the bytes the new rule's launch moves: raylen and the point flag
        # read at every voxel, the grid read and written only where a chord
        # reached a voxel without a point (the kernel returns before them
        # elsewhere); the operations of those voxels' EMA
        bytes=nv * (4 + 1) + 8 * ema_touched, ops=ema_touched * 8, library_ms=None,
        ema_voxels_updated=ema_touched,
        shapes=f"{grid.shape}; EMA on the kernel's raylen bit-equal",
    ))

    # K2 to convergence: the scan's coarse cells, a random field of small
    # components (converges), voxels 3 apart (sweep 0 is the fixpoint, so
    # the even 128th launch returns the buffer no sweep wrote) and a
    # serpentine corridor across the z = 0 plane (~12,000 voxels long: the
    # cap binds)
    bg = vals > dyn.thr_new_obstacles
    sure = vals > dyn.thr_sure_obstacles
    mv = int(np.ceil(cfg.sepclusters_max_bg_distance / cfg.voxel_size))
    lsz = max(mv - 1, 1)
    occ_c = pool_sum_coarse(bg.to(torch.int32), lsz) > 0
    g = torch.Generator(device=dev).manual_seed(12)
    rnd_occ = torch.rand(grid.shape, generator=g, device=dev) < 0.01
    iso_occ = torch.zeros(grid.shape, dtype=torch.bool, device=dev)
    iso_occ[::3, ::3, ::3] = True
    serp = torch.zeros(grid.shape, dtype=torch.bool, device=dev)
    serp[0, ::4, :] = True
    for y in range(0, grid.shape[1] - 4, 4):
        serp[0, y:y + 4, -1 if (y // 4) % 2 == 0 else 0] = True
    k2 = {}
    flat = torch.arange(nv, dtype=torch.int32, device=dev).reshape(grid.shape)
    for name, occ in (("scan cells", occ_c), ("random 1 %", rnd_occ),
                      ("isolated", iso_occ), ("serpentine", serp)):
        kl = label_components(occ, mv / lsz, 128)
        pl = label_components_plain(occ, mv / lsz, 128)
        _equal(kl, pl, f"K2c[{name}].labels K2c[{name}].converged K2c[{name}].sweeps")
        # the one call under it: grid, flags and tiles per sweep
        c = _k2_case(torch.where(occ, flat, SENTINEL), occ, mv / lsz, 128, until_fixpoint=True,
                     reps=3)
        k2[name] = dict(converged=bool(pl[1]), sweeps=int(pl[2]),
                        ms=cuda_ms(lambda: label_components(occ, mv / lsz, 128), reps=3),
                        plain_ms=cuda_ms(lambda: label_components_plain(occ, mv / lsz, 128),
                                         reps=1),
                        sweeps_call_ms=c["ms"],
                        tiles_computed=sum(c["tiles"]), tiles_per_sweep=c["tiles"],
                        full_sweep_tiles=c["full_sweep_tiles"])
    if not (k2["random 1 %"]["converged"] and k2["scan cells"]["sweeps"] >= 2
            and k2["isolated"]["converged"] and k2["isolated"]["sweeps"] == 1
            and torch.equal(label_components(iso_occ, mv / lsz, 128)[0],
                            torch.where(iso_occ, flat, SENTINEL))
            and not k2["serpentine"]["converged"] and k2["serpentine"]["sweeps"] == 128):
        raise AssertionError(f"K2 convergence cases: {k2}")
    say("2-k2-convergence", cases=k2)

    # K13b: the scan's grids; random fields at leaf sizes 1-4 (51 rows:
    # leaves 2 and 4 leave a partial top cell, 3 and 4 partial x cells);
    # no bg, all bg, one bg voxel; a grid whose columns and cells take more
    # look-back tiles than the card holds blocks of the two scans resident.
    # Each bit-equal to the plain version and to the column-walk model.
    geo = kernels.quirk_geometry()
    if (geo["col_tile"], geo["cell_tile"]) != (kernels.QUIRK_COL_TILE, kernels.QUIRK_CELL_TILE):
        raise AssertionError(f"csrc/census.cu's tiles {geo} differ from kernels.QUIRK_*_TILE")
    side = 1 + int(np.ceil(np.sqrt(max((geo["col_resident"] + 1) * geo["col_tile"],
                                       (geo["cell_resident"] + 1) * geo["cell_tile"] / 3))))
    wide = (3, side, side)
    tiles = (-(-side * side // geo["col_tile"]), -(-3 * side * side // geo["cell_tile"]))
    if not (tiles[0] > geo["col_resident"] and tiles[1] > geo["cell_resident"]):
        raise AssertionError(f"K13b wide case: tiles {tiles} within {geo}")
    rnd_bg = torch.rand(grid.shape, generator=g, device=dev) < 0.3
    rnd_sure = torch.rand(grid.shape, generator=g, device=dev) < 0.4
    no_bg = torch.zeros_like(rnd_bg)
    one_bg = no_bg.clone()
    one_bg[grid.nz // 2, grid.ny // 2, grid.nx // 2] = True
    g_wide = torch.Generator(device=dev).manual_seed(13)  # g's later draws stay as they were
    wide_bg = torch.rand(wide, generator=g_wide, device=dev) < 0.3
    wide_sure = torch.rand(wide, generator=g_wide, device=dev) < 0.4
    k13b = {"geometry": geo, "wide tiles": tiles}
    for name, b_, s_, l_ in (("scan", bg, sure, lsz), ("random", rnd_bg, rnd_sure, 1),
                             ("random, leaf 2", rnd_bg, rnd_sure, 2),
                             ("random, leaf 3", rnd_bg, rnd_sure, 3),
                             ("random, leaf 4", rnd_bg, rnd_sure, 4),
                             ("no bg", no_bg, rnd_sure, 1), ("all bg", ~no_bg, rnd_sure, 1),
                             ("all bg, leaf 3", ~no_bg, rnd_sure, 3),
                             ("single bg", one_bg, one_bg, 1),
                             (f"{wide}, tiles past resident", wide_bg, wide_sure, 1)):
        kq = quirk_sure_counts(b_, s_, l_)
        pq = quirk_sure_counts_plain(b_, s_, l_)
        _equal((kq, quirk_counts_columnwalk_plain(b_, s_, l_)), (pq, pq),
               f"K13b[{name}].counts K13b[{name}].column-walk-model")
        k13b[name] = dict(total=int(pq.sum()), moved_cells=int(
            (pq != pool_sum_coarse((b_ & s_).to(torch.int32), l_)).sum()))
    if not (k13b["no bg"]["total"] == 0 and k13b["single bg"]["total"] == 1):
        raise AssertionError(f"K13b edge cases: {k13b}")
    bg_e = bg.permute(2, 1, 0).reshape(-1).to(torch.int32)
    nc = occ_c.numel()
    out.append(dict(
        name="quirk_counts", max_abs_err=0.0, cases=k13b,
        ms=cuda_ms(lambda: quirk_sure_counts(bg, sure, lsz)),
        **device_profile(lambda: quirk_sure_counts(bg, sure, lsz)),
        plain_ms=cuda_ms(lambda: quirk_sure_counts_plain(bg, sure, lsz)),
        bytes=2 * nv + nc * 4, ops=4 * nv,
        library_ms=cuda_ms(lambda: torch.cumsum(bg_e, 0)),
        library_call="torch.cumsum of the bg mask in export order (int32)",
        shapes=f"{grid.shape}, leaf {lsz}; bit-equal",
    ))

    # K13a: the census over the scan's labels (quirk counts), and random
    sure_c = quirk_sure_counts(bg, sure, lsz)
    labels, _, _ = label_components(occ_c, mv / lsz, 128)
    min_sure = float(np.float32(dyn.sepclusters_min_sure_points))
    rnd_vals = torch.randint(0, 4, grid.shape, generator=g, device=dev, dtype=torch.int32)
    rnd_lab = label_components(rnd_occ, 2.0, 128)[0]
    k13a = {}
    for name, lab, v_, o_ in (("scan", labels, sure_c, occ_c),
                              ("random", rnd_lab, rnd_vals, rnd_occ)):
        kc = label_census(lab, v_, o_, o_.numel(), min_sure)
        pc = label_census_plain(lab, v_, o_, o_.numel(), min_sure)
        _equal(kc, pc, f"K13a[{name}].census K13a[{name}].flags")
        k13a[name] = dict(flags=pc[1].tolist(), sure_cells=int((pc[0] >= min_sure).sum()))
    occ_ids = labels[occ_c].long()
    occ_vals = sure_c[occ_c].float()
    out.append(dict(
        name="label_census", max_abs_err=0.0, cases=k13a, label_components=k2,
        ms=cuda_ms(lambda: label_census(labels, sure_c, occ_c, nc, min_sure)),
        plain_ms=cuda_ms(lambda: label_census_plain(labels, sure_c, occ_c, nc, min_sure)),
        bytes=nc * (4 + 4 + 1 + 4), ops=nc * 4,
        library_ms=cuda_ms(lambda: torch.bincount(occ_ids, weights=occ_vals, minlength=nc)),
        library_call="torch.bincount of the occupied cells' labels weighted by their counts",
        shapes=f"{tuple(occ_c.shape)} cells; bit-equal",
    ))

    # K13c: sure_sufficient True (the scan) and False (no sure cell, a
    # previous value of False), its_diff 1 and 3
    census, flags = label_census(labels, sure_c, occ_c, nc, min_sure)
    radius = cfg.sepclusters_max_bg_distance / cfg.voxel_size
    t_ = torch.ones((), dtype=torch.bool, device=dev)
    no_sure = torch.stack([flags[0], ~t_])
    k13c = {}
    for name, fl, prev, its in (("scan", flags, ~t_, 1.0), ("scan, its_diff 3", flags, ~t_, 3.0),
                                ("no sure cell", no_sure, ~t_, 1.0)):
        w1, _ = demote_weights(its, dyn.score_ray)
        args = (vals, occ_c, census, fl, prev, lsz, radius, min_sure, w1,
                float(np.float32(dyn.score_ray)), float(np.float32(dyn.thr_new_obstacles)))
        kk, pp = exact_demote_ema(*args), exact_demote_ema_plain(*args)
        _equal(kk, pp, f"K13c[{name}].grid K13c[{name}].safe K13c[{name}].sure")
        k13c[name] = dict(sure_sufficient=bool(pp[2]), demoted=int((pp[0] != vals).sum()),
                          safe=int(pp[1].sum()))
    if not (k13c["scan"]["sure_sufficient"] and k13c["scan"]["demoted"] > 0
            and k13c["no sure cell"]["demoted"] == 0):
        raise AssertionError(f"K13c cases did not exercise both branches: {k13c}")
    args = (vals, occ_c, census, flags, ~t_, lsz, radius, min_sure,
            demote_weights(1.0, dyn.score_ray)[0],
            float(np.float32(dyn.score_ray)), float(np.float32(dyn.thr_new_obstacles)))
    k13c["schedule (d), flagship"] = kernels.exact_demote_ema_schedule(
        *args[:6], ball_taps(radius), int(np.floor(radius)), *args[7:])[-1]
    k13c.update(_k13c_leaf_cases(vals, dyn, g))
    out.append(dict(
        name="exact_demote_ema", max_abs_err=0.0, cases=k13c,
        device_ms=device_profile(lambda: exact_demote_ema(*args))["device_ms"],
        ms=cuda_ms(lambda: exact_demote_ema(*args)),
        plain_ms=cuda_ms(lambda: exact_demote_ema_plain(*args)),
        bytes=nv * (4 + 4 + 1) + nc * (1 + 4), ops=nv * (run_table(radius).combines() + 10),
        library_ms=None, shapes=f"{grid.shape}, ball r={radius:g}, leaf {lsz}; bit-equal",
    ))
    for r in out:
        say("2-kernel", **r)
    return out


def _k13c_leaf_cases(vals: torch.Tensor, dyn: DynParams, g: torch.Generator) -> dict:
    """K13c at leaf sizes 2 (case (e): 1.2 m, r 2.4) and 3 (1.8 m, r 3.6) on the
    flagship grid (no multiple of either: boundary cells' centres lie
    outside it), on the scan's coarse cells and on random ones (occupied
    cells everywhere, the boundary's included), sure_sufficient True and
    False, bit-equal to the plain version; the schedule the card chose."""
    dev = vals.device
    bg, sure = vals > dyn.thr_new_obstacles, vals > dyn.thr_sure_obstacles
    min_sure = float(np.float32(dyn.sepclusters_min_sure_points))
    consts = (demote_weights(1.0, dyn.score_ray)[0], float(np.float32(dyn.score_ray)),
              float(np.float32(dyn.thr_new_obstacles)))
    t_ = torch.ones((), dtype=torch.bool, device=dev)
    out = {}
    for max_bg in (1.2, 1.8):
        radius = max_bg / 0.5
        mv = int(np.ceil(radius))
        lsz = max(mv - 1, 1)
        occ_c = pool_sum_coarse(bg.to(torch.int32), lsz) > 0
        sure_c = quirk_sure_counts(bg, sure, lsz)
        labels, _, _ = label_components(occ_c, mv / lsz, 128)
        census, flags = label_census(labels, sure_c, occ_c, occ_c.numel(), min_sure)
        rnd_occ = torch.rand(occ_c.shape, generator=g, device=dev) < 0.05
        rnd_census = torch.randint(0, 50, occ_c.shape, generator=g, device=dev,
                                   dtype=torch.int32)
        hits = {}
        for name, o, ce, fl in (("scan", occ_c, census, flags),
                                ("random", rnd_occ, rnd_census, torch.stack([t_, t_])),
                                ("random, not sure", rnd_occ, rnd_census, torch.stack([t_, ~t_]))):
            args = (vals, o, ce, fl, ~t_, lsz, radius, min_sure, *consts)
            kk, pp = exact_demote_ema(*args), exact_demote_ema_plain(*args)
            _equal(kk, pp, f"K13c[lsz {lsz} {name}].grid K13c[lsz {lsz} {name}].safe "
                           f"K13c[lsz {lsz} {name}].sure")
            hits[name] = int((pp[0] != vals).sum())
        if hits["random"] == 0 or hits["random, not sure"] != 0:
            raise AssertionError(f"K13c lsz {lsz} cases did not exercise both branches: {hits}")
        args = (vals, occ_c, census, flags, ~t_, lsz, ball_taps(radius), int(np.floor(radius)),
                min_sure, *consts)
        fn = lambda: kernels.exact_demote_ema(*args)  # noqa: E731
        out[f"lsz {lsz} (r {radius:g})"] = dict(
            demoted=hits, ms=cuda_ms(fn), device_ms=device_profile(fn)["device_ms"],
            schedule=kernels.exact_demote_ema_schedule(*args)[-1])
    return out


def sequential_config() -> VoFODConfig:
    """The reference-exact configuration with the reference's own explore
    order (tests/test_sequential_demotion.py:218-222) at the flagship size."""
    return dataclasses.replace(exact_config(), sequential_explore=True)


def _inplace_ms(fn, base: torch.Tensor, reps: int = 20) -> float:
    """Mean device time of fn(grid) over ``reps`` fresh clones of ``base``
    (for a kernel that updates the grid in place), after one warm-up."""
    clones = [base.clone() for _ in range(reps + 1)]
    fn(clones[0])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for c in clones[1:]:
        fn(c)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _seq_queries(grid: GridSpec, ids: torch.Tensor, cluster: torch.Tensor, valid: torch.Tensor,
                 m_q: torch.Tensor, Q: int, K: int):
    """A K7s query table of Q slots from flat ids, cluster slots and bounds
    (the first len(ids) slots; the rest invalid); a cluster's label is its
    least member id, as the component labels are."""
    dev = ids.device
    n = ids.shape[0]
    qids = torch.zeros(Q, dtype=torch.int32, device=dev)
    qids[:n] = ids.to(torch.int32)
    qvalid = torch.zeros(Q, dtype=torch.bool, device=dev)
    qvalid[:n] = valid
    slot = torch.full((Q,), -1, dtype=torch.int64, device=dev)
    slot[:n] = cluster
    qslot = qvalid[:, None] & (slot[:, None] == torch.arange(K, device=dev)[None, :])
    lab = torch.full((K,), SENTINEL, dtype=torch.int32, device=dev).scatter_reduce(
        0, cluster, ids.to(torch.int32), "amin")
    qlabels = torch.where(qvalid, lab[slot.clamp(min=0)], SENTINEL)
    mm = torch.zeros(Q, dtype=torch.int32, device=dev)
    mm[:n] = m_q
    qx, qy, qz = (t.to(torch.int32) for t in grid.unflatten_id(qids))
    return qx, qy, qz, qvalid, qlabels, qids, qslot, mm


_SEQ_CASES: dict = {}


def _seq_cases(lut) -> tuple[dict, dict]:
    """The sequential explore's cases on the card, made once: ({name:
    (grid, query table)}, {the sequential node, the scan's index in the
    cycle, its query count}): (a) the classify inputs of a flagship
    sequential-explore scan with valid queries, (b) the adversarial scene of
    tests/test_sequential_demotion.py stamped into the flagship grid, (c) 256
    valid queries over a random field in 32 clusters, (d) the same under
    query overflow, (e) no valid query, (f) 64 queries whose boxes overlap
    and whose floods never meet (none flooded again), (g) 7 queries in one
    closed pocket (each after the first flooded again), (h) (c)'s queries
    scattered over SEQ_Q_BIG slots, more blocks than the card holds."""
    if _SEQ_CASES:
        return _SEQ_CASES["runs"], _SEQ_CASES["info"]
    dev = torch.device("cuda")
    cfg, dyn = sequential_config(), DynParams()
    grid = GridSpec.from_config(cfg)
    K, Q = cfg.max_clusters, cfg.max_queries
    thr_f, thr_g = dyn.thr_frontiers, dyn.thr_new_obstacles
    no, yes = (torch.tensor(v, device=dev) for v in (False, True))

    # (a) a flagship scan of the sequential node with valid queries: its
    # classify inputs rebuilt from the state before it (frontend, split and
    # point update, K9, the query compaction), as the step builds them
    node = VoFOD(cfg, dyn, NodeOptions(raycast_mode="exact"), lut, device=dev)
    node.load_apriori_map(apriori_ground())
    dirs = torch.as_tensor(lut.directions, device=dev)
    offs = torch.as_tensor(lut.offsets, device=dev)
    for k, (r, p) in enumerate(scan_cycle(lut, N_SCANS)):
        st = node.state
        before = (st.grid.clone(), st.bg_sufficient.clone(), st.sure_bg_sufficient.clone())
        node.process_scan(r, None, p)
        if int(node.last_diag.n_queries) > 0:
            break
    prev_grid, prev_bg, prev_sure = before
    pose = torch.as_tensor(p, device=dev)
    counts = frontend_bin(cfg, grid, dirs, offs, torch.as_tensor(r.astype(np.float32), device=dev),
                          pose)[0]
    bg = split_and_update(cfg, dyn, prev_grid, counts, prev_bg)
    fids, fvalid, ftotal = masked_compact(bg.far, cfg.max_far_voxels)
    stats = cluster_stats(dyn, grid, K, fids, fvalid, bg.labels.reshape(-1)[fids.long()], ftotal,
                          pose[:3, 3].contiguous(), bg.bg_sufficient, prev_sure)
    qids, qvalid, qtotal, qx, qy, qz, qlabels, qslot, m_q = explore_queries(
        grid, bg.far, bg.labels, stats, Q)
    scan_q = (qx, qy, qz, qvalid, qlabels, qids, qslot, m_q, qtotal > Q)
    scan_base = bg.grid

    # (b) the adversarial scene
    vals_b = torch.full(grid.shape, float(np.float32(dyn.score_ray)), device=dev)
    bx, by, bz = SEQ_BASE
    for x, y in SEQ_CARVED:
        vals_b[bz, by + y, bx + x] = float(np.float32(dyn.score_unknown))
    ab = torch.tensor([(bz * grid.ny + by) * grid.nx + bx + dx for dx in (0, 2)], device=dev)
    scene_q = (*_seq_queries(grid, ab, torch.zeros(2, dtype=torch.int64, device=dev),
                             torch.ones(2, dtype=torch.bool, device=dev),
                             torch.full((2,), 8, dtype=torch.int32, device=dev), Q, K), no)

    # (c)-(e) 256 valid queries in 32 clusters, starting in the unknown band
    # of a random field below the percolation threshold (air / unknown /
    # ground at 80 / 18 / 2 %); every fourth cluster has bound 0 (its
    # members cannot connect), the others 0-19
    g = torch.Generator(device=dev).manual_seed(14)
    u = torch.rand(grid.shape, generator=g, device=dev)
    unk = 0.5 * (thr_f + thr_g)
    field = torch.where(u < 0.80, -900.0, torch.where(u < 0.98, unk, -100.0)).float()
    band = torch.nonzero(field.reshape(-1) == unk)[:, 0]
    pick = band[torch.randperm(band.shape[0], generator=g, device=dev)[:Q]]
    cluster = torch.arange(Q, device=dev) % K
    bound = torch.randint(0, 20, (Q,), generator=g, device=dev, dtype=torch.int32)
    rnd = _seq_queries(grid, pick, cluster, torch.ones(Q, dtype=torch.bool, device=dev),
                       torch.where(cluster % 4 == 0, 0, bound).to(torch.int32), Q, K)
    none = _seq_queries(grid, pick, torch.arange(Q, device=dev) % K,
                        torch.zeros(Q, dtype=torch.bool, device=dev),
                        torch.zeros(Q, dtype=torch.int32, device=dev), Q, K)

    # (f) 64 closed 3^3 pockets of band on a lattice 8 voxels apart, a query
    # at each centre (slots cycling), bound 6: every query fails, the S^3
    # boxes overlap, no two floods meet, so the walk floods none again.
    # (g) one such pocket and 7 queries in it (its centre and face centres)
    # in 7 slots: the first fails and demotes the pocket, and every later
    # one is flooded again.
    air = torch.full(grid.shape, -900.0, device=dev)
    centres = [(z, y, x) for z in (10, 18, 26, 34) for y in (90, 98, 106, 114)
               for x in (110, 118, 126, 134)]
    pockets = air.clone()
    for z, y, x in centres + [(30, 150, 150)]:
        pockets[z - 1:z + 2, y - 1:y + 2, x - 1:x + 2] = unk
    flat = lambda zyx: (zyx[0] * grid.ny + zyx[1]) * grid.nx + zyx[2]
    lat = torch.tensor([flat(c) for c in centres], device=dev)
    apart = _seq_queries(grid, lat, torch.arange(64, device=dev) % K,
                         torch.ones(64, dtype=torch.bool, device=dev),
                         torch.full((64,), 6, dtype=torch.int32, device=dev), Q, K)
    one = torch.tensor([flat((30 + dz, 150 + dy, 150 + dx)) for dz, dy, dx in (
        (0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))],
        device=dev)
    chain = _seq_queries(grid, one, torch.arange(7, device=dev),
                         torch.ones(7, dtype=torch.bool, device=dev),
                         torch.full((7,), 6, dtype=torch.int32, device=dev), Q, K)
    # (h) Q_BIG slots, past the blocks the card holds at once, case (c)'s
    # 256 queries scattered over them
    big = _seq_queries(grid, pick, cluster, torch.ones(Q, dtype=torch.bool, device=dev),
                       torch.where(cluster % 4 == 0, 0, bound).to(torch.int32), SEQ_Q_BIG, K)
    perm = torch.randperm(SEQ_Q_BIG, generator=g, device=dev)
    big = tuple(t[perm] for t in big)

    runs = {"(a) flagship scan": (scan_base, scan_q), "(b) adversarial scene": (vals_b, scene_q),
            "(c) 256 queries, 32 clusters": (field, (*rnd, no)),
            "(d) query overflow": (field, (*rnd, yes)), "(e) no valid query": (field, (*none, no)),
            "(f) no flood meets another": (pockets, (*apart, no)),
            "(g) every later query flooded again": (pockets, (*chain, no)),
            f"(h) {SEQ_Q_BIG} slots": (field, (*big, no))}
    _SEQ_CASES.update(runs=runs, info=dict(node=node, scan_index=k, qtotal=qtotal))
    return runs, _SEQ_CASES["info"]


def _seq_walk_check(grid: GridSpec, base: torch.Tensor, q: tuple, stats: torch.Tensor,
                    what: str, S: int, thr_f: float, thr_g: float) -> dict:
    """After a K7s or K15b-7b launch on ``q`` that wrote ``stats``: its walk's
    counts equal the schedule's plain model's (``explore_sequential_spec_plain``
    on the cut of ``base``: the floods redone above all), and the launch left
    the ticket of this stream at 0.  Returns the counts."""
    stack = explore_cut_plain(base, *q[:4], thr_f, thr_g, S)
    *_, demoted, redo = explore_sequential_spec_plain(grid, stack, *q)
    torch.cuda.synchronize()
    got = dict(zip(("redo", "walked", "failed", "valid"), stats.tolist()))
    ticket = int(kernels.seq_ticket(base.device, kernels._stream()))
    if got["redo"] != redo or got["failed"] != int(demoted.sum()) or ticket != 0:
        raise AssertionError(f"{what}: walk counts {got} (ticket {ticket}), the model's redo "
                             f"{redo} and failed {int(demoted.sum())}")
    return dict(got, ticket_after=ticket)


def phase2_sequential(lut) -> list[dict]:
    """K7s against its plain version (a host loop over K7's and K8's plain
    versions) on the card, bit-equal on the grid, the clusters' connected
    flags and the write count, in the eight cases of :func:`_seq_cases`: (b)
    floating, every carved cell demoted; (c) both verdicts; (d) and (e)
    nothing written; (f) no query flooded again; (g) every query after the
    first; (h) past the resident blocks.  The walk's counts (floods redone,
    failed queries) equal the schedule model's, and each launch leaves its
    ticket at 0."""
    cfg, dyn = sequential_config(), DynParams()
    grid = GridSpec.from_config(cfg)
    S, K, Q = cfg.explore_submap, cfg.max_clusters, cfg.max_queries
    thr_f, thr_g = dyn.thr_frontiers, dyn.thr_new_obstacles
    no = torch.tensor(False, device="cuda")
    runs, info = _seq_cases(lut)
    node, k, qtotal = info["node"], info["scan_index"], info["qtotal"]
    scan_base, scan_q = runs["(a) flagship scan"]
    field, c_q = runs["(c) 256 queries, 32 clusters"]
    rnd = c_q[:-1]
    bx, by, bz = SEQ_BASE
    cases, results = {}, {}
    for name, (base, q) in runs.items():
        stats = torch.full((4,), -1, dtype=torch.int32, device="cuda")
        kg = base.clone()
        kc, kn = kernels.explore_sequential_(kg, *q, thr_f, thr_g, S, 96, stats=stats)
        walk = _seq_walk_check(grid, base, q, stats, f"K7s{name[:3]}", S, thr_f, thr_g)
        pg, pc, pn = explore_sequential_plain(grid, base.clone(), *q, thr_f, thr_g, S)
        _equal((kg, kc, kn), (pg, pc, pn), f"K7s{name[:3]}.grid K7s{name[:3]}.connected "
                                           f"K7s{name[:3]}.n_writes")
        results[name] = (pg, pc, pn)
        cases[name] = dict(slots=int(q[0].shape[0]), valid_queries=int(q[3].sum()),
                           overflow=bool(q[8]), clusters_connected=int(pc.sum()),
                           n_writes=int(pn), demoted_voxels=int((pg != base).sum()), walk=walk)
    a, b, c_ = (cases[n] for n in ("(a) flagship scan", "(b) adversarial scene",
                                   "(c) 256 queries, 32 clusters"))
    f_, g_ = cases["(f) no flood meets another"], cases["(g) every later query flooded again"]
    bg_, bc, bn = results["(b) adversarial scene"]
    carved = torch.stack([bg_[bz, by + y, bx + x] for x, y in SEQ_CARVED])
    checks = dict(
        scan_matches_step=(a["n_writes"] == int(node.last_diag.n_demoted)
                           and int(qtotal) == int(node.last_diag.n_queries)),
        scene_floating=not bool(bc[0]), scene_carved_demoted=bool((carved == thr_f).all())
        and int(bn) == len(SEQ_CARVED),
        random_both_verdicts=0 < c_["clusters_connected"] < K and c_["n_writes"] > 0,
        overflow_and_empty_untouched=all(
            cases[n]["n_writes"] == 0 and cases[n]["clusters_connected"] == 0
            for n in ("(d) query overflow", "(e) no valid query")),
        none_flooded_again=f_["walk"]["redo"] == 0 and f_["walk"]["failed"] == 64,
        every_later_flooded_again=g_["walk"]["redo"] == 6 and g_["walk"]["failed"] == 7,
        past_resident=cases[f"(h) {SEQ_Q_BIG} slots"]["slots"] > 132 * 8)
    if not all(checks.values()):
        raise AssertionError(f"K7s cases: {checks} {cases}")
    say("2-sequential-walk", flagship_redo=a["walk"]["redo"],
        flagship_walked=a["walk"]["walked"], flagship_valid=a["walk"]["valid"],
        **{n: c["walk"] for n, c in cases.items()})
    ms = _inplace_ms(lambda v: explore_sequential_(grid, v, *scan_q, thr_f, thr_g, S), scan_base)
    plain_ms = _inplace_ms(lambda v: explore_sequential_plain(grid, v, *scan_q, thr_f, thr_g, S),
                           scan_base, reps=1)
    syn_ms = _inplace_ms(lambda v: explore_sequential_(grid, v, *rnd, no, thr_f, thr_g, S), field)
    n_valid = a["valid_queries"]
    out = [dict(
        name="explore_seq", max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
        # each valid query's S^3 submap read once, each write once, the
        # query table in, the K flags and the count out
        bytes=n_valid * S**3 * 4 + a["n_writes"] * 4 + Q * (6 * 4 + 1 + K) + K + 4,
        ops=n_valid * S**3 * 7 + Q * Q, library_ms=None, cases=cases, checks=checks,
        scan_index=k, synthetic_ms=syn_ms,
        shapes=f"Q={Q}, K={K}, S={S}, a block a slot, then the last one's walk; ms/plain_ms: "
               f"case (a) ({n_valid} valid queries, {a['walk']['redo']} flooded again, each "
               f"launch on a fresh copy of the grid); synthetic_ms: case (c)",
    )]
    for r_ in out:
        say("2-kernel", **r_)
    return out


def phase3() -> None:
    """tests/test_golden.py's replay and assertions, kernels on."""
    z = np.load(ROOT / "tests" / "fixtures" / "golden_small.npz")
    cfg = VoFODConfig(
        sensor=SensorConfig(vertical_rays=16, horizontal_rays=64, vertical_fov=np.deg2rad(90.0)),
        oparea=Box((0.0, 0.0, 4.0), (16.0, 16.0, 12.0)),
        background_sufficient_points_ratio=0.05,
        max_clusters=4, max_far_voxels=256, max_queries=64,
        explore_submap=16, confidence_submap=8,
    )
    node = VoFOD(cfg, DynParams(), NodeOptions(raycast_mode="sweep"), device="cuda")
    xs = np.arange(-4.0, 4.0, 0.5)
    gx, gy = np.meshgrid(xs, xs)
    node.load_apriori_map(np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=1))
    kernels.reset_launch_counts()
    msgs = [node.process_scan(r, None, p) for r, p in zip(z["ranges"], z["poses"])]
    launches = kernels.launch_counts()
    first = next(i for i, m in enumerate(msgs) if m.detections)
    assert first == int(z["first_detection_scan"]), first
    det = msgs[-1].detections
    assert len(det) == 1, len(det)
    np.testing.assert_allclose(np.array(det[0].position), z["expected_position"], atol=0.26)
    assert det[0].n_points == int(z["expected_n_points"])
    np.testing.assert_allclose(det[0].confidence, float(z["expected_confidence"]), atol=0.05)
    np.testing.assert_allclose(det[0].detection_probability, float(z["expected_pdet"]), atol=1e-4)
    g = node.state.grid.cpu().numpy()
    checksum = float(g[np.isfinite(g)].sum())
    np.testing.assert_allclose(checksum, float(z["grid_checksum"]), rtol=1e-4)
    assert all(launches[k] > 0 for k in SWEEP_KERNELS), launches
    say("3-golden", ok=True, first_detection_scan=first, position=list(det[0].position),
        n_points=det[0].n_points, confidence=det[0].confidence, grid_checksum=checksum,
        expected_checksum=float(z["grid_checksum"]), launches=launches)


def _k2_dense_scans(launches: dict, calls: list | None, n_scans: int, what: str) -> dict:
    """K2 on a dense path: exactly K2_CALLS_PER_DENSE_SCAN persistent launches
    a scan and no batched (grid) launch; from ``calls`` (k2_tiles_recorded over
    the run, read after it) the tiles computed a scan and the sweeps each
    call ran, beside a full sweep's tiles."""
    want = K2_CALLS_PER_DENSE_SCAN * n_scans
    got = (launches.get("propagate_sweeps", 0), launches.get("propagate_batch", 0))
    assert got == (want, 0), (
        f"{what}: K2 persistent / batched launches {got}, expected ({want}, 0)")
    if calls is None:
        return {}
    assert len(calls) == want, f"{what}: {len(calls)} K2 calls recorded, expected {want}"
    k = K2_CALLS_PER_DENSE_SCAN
    per_call = [int(t.sum()) for t in calls]
    per_scan = [sum(per_call[i * k:(i + 1) * k]) for i in range(n_scans)]
    full = int(np.prod([-(-n // t) for n, t in zip(VoFODConfig().grid_shape, kernels.TILE_ZYX)]))
    return dict(k2_launches_per_scan=k, k2_tiles_per_scan=per_scan,
                k2_tiles_per_scan_mean=float(np.mean(per_scan)), k2_full_sweep_tiles=full,
                k2_sweeps_run_per_call=[int((t > 0).sum()) for t in calls])


# the stencils' wide forms (past halo 7): never launched by a flagship path
WIDE_KERNELS = ("ball_pool_wide", "shell_pool_wide", "propagate_sweeps_wide",
                "propagate_batch_wide", "demote_ema_wide", "exact_demote_ema_wide")


def _no_wide(launches: dict, what: str) -> None:
    wide = {k: launches[k] for k in WIDE_KERNELS if launches[k]}
    assert not wide, f"{what}: the wide stencil forms launched {wide}"


def phase4(lut) -> dict:
    """The flagship main path: 36 scans through VoFOD(device="cuda")."""
    cfg = VoFODConfig()
    node = VoFOD(cfg, DynParams(), NodeOptions(), lut, device="cuda")
    n_apriori = node.load_apriori_map(apriori_ground())
    scans = scan_cycle(lut, N_SCANS)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    step_ms, syncs, n_dets, n_queries, n_demoted = [], [], [], [], []
    with k2_tiles_recorded() as calls, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for r, p in scans:
                before = len(caught)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                pending = node.process_scan_async(r, None, p)
                end.record()
                msg = node.fetch_result(pending)
                step_ms.append(start.elapsed_time(end))
                syncs.append(sum(1 for w in caught[before:] if "synchroniz" in str(w.message)))
                n_dets.append(len(msg.detections))
                n_queries.append(int(node.last_diag.n_queries))
                n_demoted.append(int(node.last_diag.n_demoted))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    launches = kernels.launch_counts()
    _no_wide(launches, "sweep path")
    d = node.last_diag
    g = node.state.grid
    assert bool(d.bg_sufficient), "background never became sufficient"
    assert not bool(torch.isnan(g).any()) and not bool(torch.isneginf(g).any()), "grid not finite"
    assert max(syncs) <= 1, f"host syncs per scan: {syncs}"
    k2 = _k2_dense_scans(launches, calls, N_SCANS, "sweep path")
    missing = [k for k in SWEEP_KERNELS if launches[k] == 0]
    assert not missing, f"kernels never launched on the sweep path: {missing}"
    # the ray stage (new update rule: one K5b launch), detect and both EMA
    # passes run once on every flagship scan
    not_once = {k: launches[k] for k in ONCE_PER_SCAN if launches[k] != N_SCANS}
    assert not not_once, f"launches over {N_SCANS} scans, expected once per scan: {not_once}"
    out = dict(
        scans=N_SCANS, grid=list(cfg.grid_shape), rays=cfg.sensor.n_points,
        apriori_voxels=n_apriori,
        step_ms_p50=float(np.percentile(step_ms, 50)),
        step_ms_p95=float(np.percentile(step_ms, 95)),
        step_ms_all=[round(x, 3) for x in step_ms],
        host_syncs_per_scan=float(np.mean(syncs)), host_syncs_max=int(max(syncs)),
        detections_last_scan=n_dets[-1], detections_total=int(sum(n_dets)),
        scans_with_detection=int(sum(1 for n in n_dets if n)),
        explore_queries_total=int(sum(n_queries)), demotion_writes_total=int(sum(n_demoted)),
        scans_with_queries=int(sum(1 for n in n_queries if n)),
        explore_queries_per_scan=n_queries, demotion_writes_per_scan=n_demoted,
        bg_sufficient=bool(d.bg_sufficient), sure_bg_sufficient=bool(d.sure_bg_sufficient),
        n_bg_voxels=int(d.n_bg_voxels), cc_iters=int(d.cc_iters),
        launches=launches, launches_per_scan={k: v / N_SCANS for k, v in launches.items()},
        **k2,
    )
    say("4-flagship", **out)
    return launches, out["step_ms_p50"]


# phase 4-fine: fine-0125's scans, its dense node's kernels (K1's and K2's
# wide forms in place of K1 and K2's label call: K2's reach at r 7 keeps
# the narrow form) and its grid path's
N_FINE_SCANS = 24
N_FINE_PLAIN = 6
FINE_KERNELS = tuple(k for k in SWEEP_KERNELS if k != "ball_pool") + (
    "ball_pool_wide", "propagate_sweeps_wide")
FINE_GRID_KERNELS = GRID_KERNELS + ("ball_pool_wide", "propagate_batch_wide")


@contextlib.contextmanager
def wide_forms_plain():
    """Within the block, K1's and K2's dense wrappers run a tap set in the
    wide forms (``is_wide``) through plain versions on the card (K1:
    ``pool_plain``; K2: ``sweeps_tiled_plain``), and launch their kernels
    for any other set."""
    real_pool, real_sweeps = kernels.ball_pool, kernels.propagate_sweeps

    def pool(a, taps, halo, op, fill):
        if not is_wide(taps, halo):
            return real_pool(a, taps, halo, op, fill)
        return pool_plain(a, taps, op, fill)

    def sweeps_(init, occ, taps, halo, n):
        if not is_wide(taps, halo):
            return real_sweeps(init, occ, taps, halo, n)
        out, flags, tiles = sweeps_tiled_plain(init, occ.view(torch.bool), taps, n)
        return out, flags.to(torch.int32), tiles, 0
    kernels.ball_pool, kernels.propagate_sweeps = pool, sweeps_
    try:
        yield
    finally:
        kernels.ball_pool, kernels.propagate_sweeps = real_pool, real_sweeps


def phase4_fine(lut) -> tuple[dict, dict, float, float]:
    """fine-0125's main path: N_FINE_SCANS scans of its cycle through the
    dense node (``VoFOD(fine_config(), device="cuda")``), each beside the
    3-shard grid step on the same scan (17-plane slabs: K2's label sweeps at
    r 12 take a halo of 8 x 12 rows), and the first N_FINE_PLAIN beside a
    dense node whose wide forms run their plain versions on the card.  Per
    scan: the grid path's state and every diagnostic bit-equal to the dense
    node's, detection integers equal and floats within 1e-5 relative; the
    plain node's state bit-equal (the integer parts are required to be, the
    grid within K5b's 1e-5 x |score_ray|).  Every kernel of both paths
    launched, K1 only in its wide form, far_overflow never set, detections
    on the cycle, every scan classified (the background sufficient from the
    apriori plane on), at most 1 host sync a dense scan.  Returns (dense
    launches, grid launches, dense step p50, grid step p50)."""
    cfg = fine_config()
    dyn = DynParams()
    scans = fine_scan_cycle(lut, N_FINE_SCANS)
    node = VoFOD(cfg, dyn, NodeOptions(), lut, device="cuda")
    n_apriori = node.load_apriori_map(fine_apriori_ground())
    plain = VoFOD(cfg, dyn, NodeOptions(), lut, device="cuda")
    plain.load_apriori_map(fine_apriori_ground())
    drv = GridDriver(lut, node.state, cfg)
    torch.cuda.synchronize()
    dense_l = dict.fromkeys(kernels.LAUNCHES, 0)
    grid_l = dict.fromkeys(kernels.LAUNCHES, 0)
    ms = {"dense": [], "grid": []}
    syncs, n_dets, n_far, n_q, n_inactive, plain_err, rel_err = [], [], [], [], [], 0.0, 0.0
    tol = K5B_TOL_REL * abs(dyn.score_ray)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for k, (r, p) in enumerate(scans):
            kernels.reset_launch_counts()
            before = len(caught)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.set_sync_debug_mode("warn")
            try:
                start.record()
                pending = node.process_scan_async(r, None, p)
                end.record()
                dense_out = pending[0]
                msg = node.fetch_result(pending)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            ms["dense"].append(start.elapsed_time(end))
            syncs.append(sum(1 for w in caught[before:] if "synchroniz" in str(w.message)
                             and "prototype" not in str(w.message)))
            _add(dense_l, kernels.launch_counts())
            d = node.last_diag
            n_dets.append(len(msg.detections))
            n_far.append(int(d.n_far))
            n_q.append(int(d.n_queries))
            n_inactive.append(int(not (bool(d.bg_sufficient) and bool(d.sure_bg_sufficient))))
            assert not bool(d.far_overflow), f"fine scan {k}: far voxels past max_far_voxels"
            kernels.reset_launch_counts()
            start.record()
            diag, dets = drv.fetch(drv.process_scan_async(r, p))
            end.record()
            torch.cuda.synchronize()
            ms["grid"].append(start.elapsed_time(end))
            launches = kernels.launch_counts()
            _add(grid_l, launches)
            missing = [g for g in FINE_GRID_KERNELS if launches[g] == 0]
            assert not missing, f"fine grid scan {k}: kernels not launched: {missing}"
            g = gather_state(drv.states)
            for f in ("grid", "safe", "det_counter", "sure_bg_sufficient", "bg_sufficient"):
                if not torch.equal(getattr(g, f), getattr(node.state, f)):
                    raise AssertionError(f"fine grid scan {k}: state.{f} differs from dense")
            for f, v in diag.items():
                if not np.array_equal(v, getattr(node.last_diag, f)):
                    raise AssertionError(f"fine grid scan {k}: diag.{f} differs from dense")
            for f, v in dets.items():
                want = getattr(dense_out.detections, f).cpu().numpy()
                if v.dtype.kind == "f":
                    np.testing.assert_allclose(v, want, rtol=1e-5, atol=0.0,
                                               err_msg=f"fine grid scan {k}: detections.{f}")
                    den = np.maximum(np.abs(want), 1e-30)
                    rel_err = max(rel_err, float(np.max(np.abs(v - want) / den, initial=0.0)))
                elif not np.array_equal(v, want):
                    raise AssertionError(f"fine grid scan {k}: detections.{f} differs")
            if k < N_FINE_PLAIN:
                with wide_forms_plain():
                    plain.process_scan(r, None, p)
                for f in ("safe", "det_counter", "sure_bg_sufficient", "bg_sufficient"):
                    if not torch.equal(getattr(plain.state, f), getattr(node.state, f)):
                        raise AssertionError(f"fine scan {k}: state.{f} differs from the node "
                                             "on the wide forms' plain versions")
                a, b = plain.state.grid, node.state.grid
                fin = torch.isfinite(b)
                if not (torch.equal(fin, torch.isfinite(a)) and max_abs(a[fin], b[fin]) <= tol):
                    raise AssertionError(f"fine scan {k}: the grid differs from the plain node's")
                plain_err = max(plain_err, max_abs(a[fin], b[fin]))
    missing = [g for g in FINE_KERNELS if dense_l[g] == 0]
    assert not missing, f"kernels never launched on the fine path: {missing}"
    assert dense_l["ball_pool"] == 0 and dense_l["propagate_sweeps_wide"] == N_FINE_SCANS, dense_l
    assert max(syncs) <= 1, f"host syncs per fine scan: {syncs}"
    assert sum(n_dets) > 0 and n_dets[-1] > 0, f"fine-0125 detected nothing: {n_dets}"
    # (the first scan's sure flag is the initial state's; every later scan
    # classifies)
    assert not any(n_inactive[1:]), f"scans not classified: {n_inactive}"
    out = dict(
        config="fine-0125", scans=N_FINE_SCANS, grid=list(cfg.grid_shape),
        voxel_size=cfg.voxel_size, rays=cfg.sensor.n_points, capacities=FINE_CAPACITIES,
        radii_voxels=dict(ground=cfg.ground_points_max_distance / cfg.voxel_size,
                          local_sure=math.ceil(cfg.sepclusters_max_bg_distance / cfg.voxel_size)
                          + 1.0, reach=float(math.ceil(cfg.sepclusters_max_bg_distance
                                                       / cfg.voxel_size)),
                          demotion=cfg.sepclusters_max_bg_distance / cfg.voxel_size),
        apriori_voxels=n_apriori, shards=GRID_SHARDS,
        step_ms_p50={m: float(np.percentile(v, 50)) for m, v in ms.items()},
        step_ms_p95={m: float(np.percentile(v, 95)) for m, v in ms.items()},
        step_ms_all={m: [round(x, 3) for x in v] for m, v in ms.items()},
        host_syncs_per_scan=float(np.mean(syncs)), host_syncs_max=int(max(syncs)),
        detections_per_scan=n_dets, detections_total=int(sum(n_dets)),
        first_detection_scan=next(i for i, n in enumerate(n_dets) if n),
        far_voxels_max=max(n_far), explore_queries_max=max(n_q),
        classification_inactive_per_scan=n_inactive,
        grid_bit_equal_state_and_diag=True, grid_detection_float_max_rel_err=rel_err,
        plain_node_scans=N_FINE_PLAIN, plain_node_grid_max_abs=plain_err,
        launches_per_scan={g: v / N_FINE_SCANS for g, v in dense_l.items() if v},
        grid_launches_per_scan={g: v / N_FINE_SCANS for g, v in grid_l.items() if v},
    )
    say("4-fine", **out)
    return dense_l, grid_l, out["step_ms_p50"]["dense"], out["step_ms_p50"]["grid"]


def phase4_raycast_every(lut, n: int = 6) -> None:
    """``NodeOptions(raycast_every=2)`` on the flagship config: the ray
    stage (K5a, K4, K5b) runs on every second scan only."""
    node = VoFOD(VoFODConfig(), DynParams(), NodeOptions(raycast_every=2), lut, device="cuda")
    node.load_apriori_map(apriori_ground())
    scans = scan_cycle(lut, n)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for r, p in scans:
        node.process_scan(r, None, p)
    launches = kernels.launch_counts()
    g = node.state.grid
    assert not bool(torch.isnan(g).any()), "grid not finite"
    ray = {k: launches[k] for k in ("gate_faces", "cone_sweep", "ray_update")}
    assert all(v == n // 2 for v in ray.values()), f"raycast_every=2 over {n} scans: {ray}"
    assert launches["detect"] == n, launches
    say("4-raycast-every", scans=n, raycast_every=2, launches=ray)


def phase4_exact(lut, sequential: bool = False) -> dict:
    """The reference-exact main path: VoFOD(exact config, raycast_mode
    "exact") over the scan cycle, every kernel of the path launched.  With
    ``sequential``, the same with ``cfg.sequential_explore``: K7s once per
    scan and the batched K7 / K8 never."""
    cfg = sequential_config() if sequential else exact_config()
    kernels_of_path = SEQUENTIAL_KERNELS if sequential else EXACT_KERNELS
    once = ONCE_PER_SEQUENTIAL_SCAN if sequential else ONCE_PER_EXACT_SCAN
    node = VoFOD(cfg, DynParams(), NodeOptions(raycast_mode="exact"), lut, device="cuda")
    n_apriori = node.load_apriori_map(apriori_ground())
    scans = scan_cycle(lut, N_EXACT_SCANS)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    step_ms, syncs, n_dets, sweeps, sep_conv, n_queries, n_demoted = [], [], [], [], [], [], []
    with k2_tiles_recorded() as calls, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for r, p in scans:
                before = len(caught)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                pending = node.process_scan_async(r, None, p)
                end.record()
                msg = node.fetch_result(pending)
                step_ms.append(start.elapsed_time(end))
                syncs.append(sum(1 for w in caught[before:] if "synchroniz" in str(w.message)))
                n_dets.append(len(msg.detections))
                sweeps.append(int(node.last_diag.sep_sweeps))
                sep_conv.append(bool(node.last_diag.sep_converged))
                n_queries.append(int(node.last_diag.n_queries))
                n_demoted.append(int(node.last_diag.n_demoted))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    launches = kernels.launch_counts()
    _no_wide(launches, "sequential path" if sequential else "exact path")
    d = node.last_diag
    g = node.state.grid
    what = "sequential" if sequential else "exact"
    k2 = _k2_dense_scans(launches, calls, N_EXACT_SCANS, f"{what} path")
    assert bool(d.bg_sufficient), "background never became sufficient"
    assert not bool(torch.isnan(g).any()) and not bool(torch.isneginf(g).any()), "grid not finite"
    assert max(syncs) <= 1, f"host syncs per {what} scan: {syncs}"
    missing = [k for k in kernels_of_path if launches[k] == 0]
    assert not missing, f"kernels never launched on the {what} path: {missing}"
    not_once = {k: launches[k] for k in once if launches[k] != N_EXACT_SCANS}
    assert not not_once, f"launches over {N_EXACT_SCANS} {what} scans, expected once: {not_once}"
    foreign = ("cone_sweep", "gate_faces", "ray_update", "demote_ema") + (
        ("explore_bfs", "demote") if sequential else ("explore_seq",))
    foreign = {k: launches[k] for k in foreign if launches[k]}
    assert not foreign, f"kernels of other paths launched on the {what} path: {foreign}"
    out = dict(
        scans=N_EXACT_SCANS, grid=list(cfg.grid_shape), rays=cfg.sensor.n_points,
        apriori_voxels=n_apriori,
        step_ms_p50=float(np.percentile(step_ms, 50)),
        step_ms_p95=float(np.percentile(step_ms, 95)),
        step_ms_all=[round(x, 3) for x in step_ms],
        host_syncs_per_scan=float(np.mean(syncs)), host_syncs_max=int(max(syncs)),
        label_sweeps_per_scan=sweeps, sep_converged_per_scan=sep_conv,
        detections_per_scan=n_dets, detections_total=int(sum(n_dets)),
        explore_queries_total=int(sum(n_queries)), demotion_writes_total=int(sum(n_demoted)),
        scans_with_queries=int(sum(1 for n in n_queries if n)),
        explore_queries_per_scan=n_queries, demotion_writes_per_scan=n_demoted,
        bg_sufficient=bool(d.bg_sufficient), sure_bg_sufficient=bool(d.sure_bg_sufficient),
        n_bg_voxels=int(d.n_bg_voxels),
        capped_scans=int(sum(1 for c in sep_conv if not c)),
        launches=launches,
        launches_per_scan={k: v / N_EXACT_SCANS for k, v in launches.items() if v},
        **k2,
    )
    say("4-sequential" if sequential else "4-exact", **out)
    return launches, out["step_ms_p50"]


def _timed_scan(node, r, p, caught) -> tuple:
    """One scan through ``node``: (message, CUDA-event ms from the enqueue to
    the end of its work, host syncs it made, kernel launches it made)."""
    kernels.reset_launch_counts()
    before = len(caught)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    pending = node.process_scan_async(r, None, p)
    end.record()
    msg = node.fetch_result(pending)
    launches = kernels.launch_counts()
    syncs = sum(1 for w in caught[before:] if "synchroniz" in str(w.message))
    return msg, start.elapsed_time(end), syncs, launches


def _same_scan(a, b, what: str) -> None:
    """Two nodes' results of one scan bit-equal: grid, carried state, the
    diagnostics and the detection messages."""
    for f in ("grid", "safe", "det_counter", "sure_bg_sufficient", "bg_sufficient"):
        if not torch.equal(getattr(a[0].state, f), getattr(b[0].state, f)):
            raise AssertionError(f"{what}: state.{f} differs")
    for f in dataclasses.fields(a[0].last_diag):
        if not np.array_equal(getattr(a[0].last_diag, f.name), getattr(b[0].last_diag, f.name)):
            raise AssertionError(f"{what}: diag.{f.name} differs")
    if a[1].detections != b[1].detections:
        raise AssertionError(f"{what}: detections differ")


def _add(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def phase4_prebinned(lut) -> dict:
    """The prebinned serving ingest at the flagship size: a raw node and a
    ``NodeOptions(frontend_mode="prebinned")`` node over the same 36 scans in
    one process, held bit-equal scan for scan; K15a once per prebinned scan
    and K3 never, 1 host sync per scan on both; step p50/p95 of each and the
    count of steps over 7 ms (both ingests upload from staging buffers
    pinned once)."""
    cfg = VoFODConfig()
    nodes = {m: VoFOD(cfg, DynParams(), NodeOptions(frontend_mode=m), lut, device="cuda")
             for m in ("raw", "prebinned")}
    pre = nodes["prebinned"]
    if not (pre._binner is not None and pre._binner.native and pre._staging is not None):
        raise AssertionError("the CUDA prebinned node does not bin natively into pinned staging")
    for n in nodes.values():
        n.load_apriori_map(apriori_ground())
    scans = scan_cycle(lut, N_SCANS)
    torch.cuda.synchronize()
    ms = {m: [] for m in nodes}
    syncs = {m: [] for m in nodes}
    launches = {m: {} for m in nodes}
    host_ms, n_dets = [], 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for k, (r, p) in enumerate(scans):
            out = {}
            for m, node in nodes.items():
                torch.cuda.set_sync_debug_mode("warn")
                t0 = time.perf_counter()
                try:
                    msg, t, s_, ln = _timed_scan(node, r, p, caught)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                if m == "prebinned":
                    host_ms.append((time.perf_counter() - t0) * 1e3)
                out[m] = (node, msg)
                ms[m].append(t)
                syncs[m].append(s_)
                _add(launches[m], ln)
            _same_scan(out["prebinned"], out["raw"], f"prebinned vs raw, scan {k}")
            n_dets += len(out["raw"][1].detections)
    lp, lr = launches["prebinned"], launches["raw"]
    for m, got in launches.items():
        _no_wide({k: got.get(k, 0) for k in WIDE_KERNELS}, f"{m} path")
    assert lp.get("unpack", 0) == N_SCANS and lp.get("frontend_bin", 0) == 0, lp
    assert lr.get("frontend_bin", 0) == N_SCANS and lr.get("unpack", 0) == 0, lr
    _k2_dense_scans(lp, None, N_SCANS, "prebinned path")
    _k2_dense_scans(lr, None, N_SCANS, "raw path beside the prebinned one")
    assert max(syncs["prebinned"]) <= 1 and max(syncs["raw"]) <= 1, syncs
    assert bool(pre.last_diag.bg_sufficient), "background never became sufficient"
    out = dict(
        scans=N_SCANS, bit_equal_to_raw=True, detections_total=n_dets,
        step_ms_p50={m: float(np.percentile(v, 50)) for m, v in ms.items()},
        step_ms_p95={m: float(np.percentile(v, 95)) for m, v in ms.items()},
        step_ms_all={m: [round(x, 3) for x in v] for m, v in ms.items()},
        steps_over_7ms={m: int(sum(1 for x in v if x > 7.0)) for m, v in ms.items()},
        prebinned_host_ms_p50=float(np.percentile(host_ms, 50)),
        host_syncs_per_scan={m: float(np.mean(v)) for m, v in syncs.items()},
        launches_prebinned=lp, launches_raw=lr,
    )
    say("4-prebinned", **out)
    return lp, out["step_ms_p50"]["prebinned"]


def phase4_auto(lut) -> None:
    """``NodeOptions(frontend_mode="auto")`` on the flagship config: the
    probe's choice and every number it measured."""
    node = VoFOD(VoFODConfig(), DynParams(), NodeOptions(frontend_mode="auto"), lut,
                 device="cuda")
    mode = node.options.frontend_mode
    assert mode in ("raw", "prebinned") and (node._binner is not None) == (mode == "prebinned")
    say("4-auto", chose=mode, probe=node.ingest_probe)


DYN_SEGMENTS = ((1.5, 0.8), (1.0, 1.4), (2.0, 1.9))  # (ground_points, sepclusters) m


def phase4_dynamic(lut) -> dict:
    """``cfg.dynamic_radii`` at the flagship size (bounds 2.0 / 2.0 m): the
    radii change every 12 scans, each 12-scan segment held bit-equal to a
    static node at those radii started from the same state; 1 host sync per
    scan, K14 launched, no kernel rebuild when the radii move."""
    cfg = VoFODConfig(dynamic_radii=True, ground_points_max_distance_bound=2.0,
                      sepclusters_max_bg_distance_bound=2.0)
    node = VoFOD(cfg, DynParams(), NodeOptions(), lut, device="cuda")
    node.load_apriori_map(apriori_ground())
    lib, sos = kernels.load(), sorted(kernels._BUILD_DIR.glob("*.so"))
    scans = scan_cycle(lut, N_SCANS)
    seg_len = N_SCANS // len(DYN_SEGMENTS)
    torch.cuda.synchronize()
    launches, segments, syncs = {}, [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i, (g, sep) in enumerate(DYN_SEGMENTS):
            node.update_params(ground_points_max_distance=g, sepclusters_max_bg_distance=sep)
            static = VoFOD(dataclasses.replace(cfg, dynamic_radii=False,
                                               ground_points_max_distance=g,
                                               sepclusters_max_bg_distance=sep),
                           node.dyn, NodeOptions(), lut, device="cuda")
            st = node.state
            static.state = VoFODState(st.grid.clone(), st.safe.clone(), st.det_counter.clone(),
                                      st.step, st.sure_bg_sufficient.clone(),
                                      st.bg_sufficient.clone())
            ms, dets = [], 0
            for k in range(i * seg_len, (i + 1) * seg_len):
                r, p = scans[k]
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    msg, t, s_, ln = _timed_scan(node, r, p, caught)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                ms.append(t)
                syncs.append(s_)
                _add(launches, ln)
                smsg = static.process_scan(r, None, p)
                _same_scan((node, msg), (static, smsg), f"dynamic vs static {g}/{sep} m, scan {k}")
                dets += len(msg.detections)
            segments.append(dict(ground_points_max_distance=g, sepclusters_max_bg_distance=sep,
                                 step_ms_p50=float(np.percentile(ms, 50)),
                                 step_ms_p95=float(np.percentile(ms, 95)), detections=dets))
    rebuilt = kernels.load() is not lib or sorted(kernels._BUILD_DIR.glob("*.so")) != sos
    assert not rebuilt, "the kernel library was rebuilt when the radii changed"
    assert max(syncs) <= 1, f"host syncs per dynamic scan: {syncs}"
    assert launches.get("shell_pool", 0) > 0, launches
    _no_wide({k: launches.get(k, 0) for k in WIDE_KERNELS}, "dynamic path")
    _k2_dense_scans(launches, None, N_SCANS, "dynamic path")
    assert bool(node.last_diag.bg_sufficient), "background never became sufficient"
    say("4-dynamic", scans=N_SCANS, segments=segments, bit_equal_to_static=True,
        kernel_rebuilds=0, host_syncs_per_scan=float(np.mean(syncs)), launches=launches,
        launches_per_scan={k: v / N_SCANS for k, v in launches.items() if v})
    return launches, segments[-1]["step_ms_p50"]


def poison(ranges_u32: np.ndarray, seed: int):
    """tests/test_hostile_inputs.py's ``poison``: a float copy of a rendered
    scan with NaN, +inf, -inf and negative pixels (a sixteenth of them
    each), its sanitized equivalent (NaN, -inf and negatives -> 0, +inf ->
    4e9) and the four pixel sets."""
    rng = np.random.default_rng(seed)
    r = ranges_u32.astype(np.float32).ravel().copy()
    n = r.size
    qs = np.array_split(rng.choice(n, size=4 * (n // 16), replace=False), 4)
    r[qs[0]] = np.nan
    r[qs[1]] = np.inf
    r[qs[2]] = -np.inf
    r[qs[3]] = -1234.5
    sane = r.copy()
    sane[qs[0]] = 0.0
    sane[qs[1]] = 4.0e9
    sane[qs[2]] = 0.0
    sane[qs[3]] = 0.0
    return r, sane, qs


# the dense paths of the hostile-input phase: (config, node options, the
# kernels that read the poisoned scan first)
HOSTILE_PATHS = {
    "sweep/raw": (VoFODConfig, {}, ("frontend_bin",)),
    "exact/raw": (exact_config, dict(raycast_mode="exact"), ("frontend_bin", "dda")),
    "sweep/prebinned": (VoFODConfig, dict(frontend_mode="prebinned"), ("unpack",)),
    "off/raw": (VoFODConfig, dict(raycast_mode="off"), ("frontend_bin",)),
}


def phase4_hostile(lut, n: int = 6) -> None:
    """The hostile-input contract of tests/test_hostile_inputs.py on the
    card, at the flagship size: from a learned state, n scans of the cycle
    with poisoned float ranges and NaN intensity on a quarter of the poisoned pixels (1e9 in
    the sanitized twin, which passes the intensity gate as NaN does) leave
    grid and safe bit-equal to the sanitized run's, with no NaN and the grid
    moved, on each dense path; a non-finite pose (all NaN, a NaN rotation with a finite
    translation, an infinite translation) skips the scan, launching nothing
    and leaving the state as it was, on the raw and the prebinned ingest."""
    cycle = scan_cycle(lut, 2 * n)
    # both runs of a path start from the state of a sweep node after the
    # apriori plane and n clean scans, so that the raycast-off path's point
    # EMA has a background to land near
    warm = VoFOD(VoFODConfig(), DynParams(), NodeOptions(), lut, device="cuda")
    warm.load_apriori_map(apriori_ground())
    for r, p in cycle[n:]:
        warm.process_scan(r, None, p)
    seq = []
    for i, (r, p) in enumerate(cycle[:n]):
        bad, sane, qs = poison(r, seed=100 + i)
        inten_bad = np.full(r.size, 100.0, np.float32)
        inten_sane = inten_bad.copy()
        inten_bad[qs[0]] = np.nan
        inten_sane[qs[0]] = 1.0e9
        seq.append((bad, inten_bad, sane, inten_sane, p))
    out = {}
    for path, (make_cfg, opts, readers) in HOSTILE_PATHS.items():
        nodes = [VoFOD(make_cfg(), DynParams(), NodeOptions(**opts), lut, device="cuda")
                 for _ in range(2)]
        for node in nodes:
            node.state = dataclasses.replace(warm.state, **{
                k: v.clone() for k, v in vars(warm.state).items() if isinstance(v, torch.Tensor)})
        reads = []
        for node, poisoned in zip(nodes, (True, False)):
            kernels.reset_launch_counts()
            for k, (bad, ib, sane, isane, p) in enumerate(seq):
                if poisoned:
                    node.process_scan(bad, ib, p, stamp=0.1 * k)
                else:
                    node.process_scan(sane, isane, p, stamp=0.1 * k)
            launched = kernels.launch_counts()
            reads.append({k: launched[k] for k in readers})
        a, b = (node.state for node in nodes)
        nan = int(torch.isnan(a.grid).sum())
        differ = dict(grid=int((a.grid != b.grid).sum()), safe=int((a.safe != b.safe).sum()))
        moved = int((a.grid != warm.state.grid).sum())
        out[path] = dict(nan_voxels=nan, differ=differ, reader_launches=reads[0],
                         voxels_moved_by_the_scans=moved)
        if (nan or any(differ.values()) or not moved or not all(reads[0].values())
                or reads[0] != reads[1]):
            raise AssertionError(f"hostile inputs on the {path} path: {out[path]}")
    for path in ("sweep/raw", "sweep/prebinned"):
        make_cfg, opts, _ = HOSTILE_PATHS[path]
        node = VoFOD(make_cfg(), DynParams(), NodeOptions(**opts), lut, device="cuda")
        r, p = scan_cycle(lut, 1)[0]
        node.process_scan(r, None, p)
        before = {k: v.clone() for k, v in vars(node.state).items()
                  if isinstance(v, torch.Tensor)}
        step = node.state.step
        rot_nan = p.astype(np.float32).copy()
        rot_nan[:3, :3] = np.nan
        inf_pose = p.astype(np.float32).copy()
        inf_pose[2, 3] = np.inf
        kernels.reset_launch_counts()
        for k, bad_pose in enumerate((np.full((4, 4), np.nan, np.float32), rot_nan, inf_pose)):
            msg = node.process_scan(r, None, bad_pose, stamp=1.0 + k)
            if msg.detections or node.n_pose_rejected != k + 1:
                raise AssertionError(f"{path}: non-finite pose {k} was not skipped")
        launched = sum(kernels.launch_counts().values())
        kept = all(torch.equal(getattr(node.state, k), v) for k, v in before.items())
        if launched or not kept or node.state.step != step:
            raise AssertionError(f"{path}: a skipped scan launched {launched} kernels, state "
                                 f"kept {kept}, step {step} -> {node.state.step}")
        node.process_scan(r, None, p)
        if node.state.step != step + 1:
            raise AssertionError(f"{path}: the node stopped after the skipped scans")
        out[f"pose skip, {path}"] = dict(rejected=node.n_pose_rejected, launches=launched)
    say("4-hostile", scans=n, **out)


def phase4_surface(lut) -> None:
    """The node's runtime surface on the card at the flagship size:
    ``process_rangefinder`` under both validity rules (one voxel per
    accepted hit, by the float32 formula), an NPZ snapshot round trip
    (bit-equal), the LUT consistency check on a rendered scan, a
    ``trace_dir`` window (its file written), and ``profile_stages`` (three
    routine durations > 0 per scan, bit-equal to a fused node)."""
    cfg, dyn = VoFODConfig(), DynParams()
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    scans = scan_cycle(lut, 6)
    out = {}

    pose = hover_pose((40.0, 20.0, 3.0))
    pose[:3, :3] = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32)  # x axis down
    sp = np.float32(dyn.score_point)
    for compat in (False, True):
        node = VoFOD(dataclasses.replace(cfg, compat_rangefinder_validity=compat), dyn,
                     NodeOptions(), lut, device="cuda")
        before = node.state.grid.cpu().numpy().copy()
        short = node.process_rangefinder(0.05, 0.1, 10.0, pose)  # under min_range
        hit = node.process_rangefinder(2.5, 0.1, 10.0, pose)
        after = node.state.grid.cpu().numpy()
        changed = np.nonzero(after != before)
        exact = bool(np.all(after[changed] == (before[changed] + sp) / np.float32(2.0)))
        if not (hit and short == compat and len(changed[0]) == 1 + compat and exact):
            raise AssertionError(f"rangefinder (compat {compat}): accepted {short}, {hit}; "
                                 f"{len(changed[0])} voxels changed, float32 formula {exact}")
        out[f"rangefinder_compat_{compat}"] = dict(accepted=[short, hit],
                                                   voxels_changed=len(changed[0]))

    fused = VoFOD(cfg, dyn, NodeOptions(), lut, device="cuda")
    staged = VoFOD(cfg, dyn, NodeOptions(profile_stages=True, check_consistency=True), lut,
                   device="cuda")
    stage_ms = []
    for k, (r, p) in enumerate(scans):
        pts = (lut.directions * (r.astype(np.float32) * np.float32(1e-3))[:, None]
               + lut.offsets)
        a = fused.process_scan(r, None, p)
        b = staged.process_scan(r, None, p, points_xyz=pts)
        _same_scan((fused, a), (staged, b), f"profile_stages vs fused, scan {k}")
        if not all(v > 0 for v in staged.last_stage_ms.values()):
            raise AssertionError(f"profile_stages: {staged.last_stage_ms}")
        stage_ms.append(staged.last_stage_ms)
    if not (staged._sensor_checked and staged._sensor_params_ok):
        raise AssertionError("check_consistency: the rendered scan failed the LUT check")
    out["profile_stages"] = dict(
        bit_equal_to_fused=True, scans=len(scans),
        routine_ms_p50={n: float(np.median([m[n] for m in stage_ms])) for n in stage_ms[0]},
        events=len(staged.profiling.events))
    out["check_consistency"] = dict(checked=True, ok=staged._sensor_params_ok)

    path = str(work / "snapshot.npz")
    staged.save_snapshot(path)
    back = VoFOD(cfg, dyn, NodeOptions(), lut, device="cuda")
    back.load_snapshot(path)
    for f in dataclasses.fields(back.state):
        a, b = getattr(back.state, f.name), getattr(staged.state, f.name)
        if not (a == b if f.name == "step" else torch.equal(a, b)):
            raise AssertionError(f"snapshot round trip: state.{f.name} differs")
    out["snapshot"] = dict(bit_equal=True, bytes=Path(path).stat().st_size)

    tracer = VoFOD(cfg, dyn, NodeOptions(trace_dir=str(work / "trace"), trace_skip=1,
                                         trace_scans=2), lut, device="cuda")
    for r, p in scans[:4]:
        tracer.process_scan(r, None, p)
    if not (tracer._trace_state == "done" and tracer.trace_path
            and Path(tracer.trace_path).stat().st_size > 0):
        raise AssertionError(f"trace window: {tracer._trace_state} {tracer.trace_path}")
    # the window is the process's first profiler session: its device events
    # per scan, beside phase 5's counts of later sessions
    trace = json.loads(Path(tracer.trace_path).read_text())["traceEvents"]
    cats = ("kernel", "gpu_memcpy", "gpu_memset")
    out["trace"] = dict(scans="1-2", bytes=Path(tracer.trace_path).stat().st_size,
                        device_events_per_scan={c: sum(1 for e in trace if e.get("cat") == c) / 2
                                                for c in cats})
    say("4-surface", **out)


# phase 4-fleet: the streams' fleet at the flagship size (runtime/fleet.py)
FLEET_B = 4
FLEET_TICKS = 12
FLEET_OFFSET = 3  # stream b starts the cycle at scan FLEET_OFFSET * b
FLEET_NAN = (6, 2)  # (tick, stream) of the NaN rotation
FLEET_RESET = (8, 1)  # (tick, stream) reset and re-stamped before that tick
FLEET_TIMING_B = (1, 2, 4, 8, 16)
FLEET_WARM_TICKS, FLEET_TIMED_TICKS = 2, 12
FLEET_PROFILE_TICKS = 5
FLEET_BUDGET_MS = 100.0  # a 10 Hz sensor's period
STATE_FIELDS = ("grid", "safe", "det_counter", "step", "sure_bg_sufficient", "bg_sufficient")


def _fleet_tick(cycle, n_streams: int, k: int):
    """Tick k's stacked scans: stream b takes the cycle's scan
    FLEET_OFFSET * b + k (wrapping)."""
    idx = [(FLEET_OFFSET * b + k) % len(cycle) for b in range(n_streams)]
    return (np.stack([cycle[i][0] for i in idx]),
            np.stack([cycle[i][1] for i in idx]).astype(np.float32))


def _stream_record(fleet, msgs, b: int) -> tuple:
    """One stream's result of a fleet tick: (detections, diagnostics)."""
    d = fleet.last_diag
    return (msgs[b].detections,
            {f.name: np.asarray(getattr(d, f.name))[b] for f in dataclasses.fields(d)})


def _node_record(node, msg) -> tuple:
    return (msg.detections, {f.name: np.asarray(getattr(node.last_diag, f.name))
                             for f in dataclasses.fields(node.last_diag)})


def _same_record(a: tuple, b: tuple, what: str) -> None:
    if a[0] != b[0]:
        raise AssertionError(f"{what}: detections differ")
    for f, v in a[1].items():
        if not np.array_equal(v, b[1][f]):
            raise AssertionError(f"{what}: diag.{f} differs")


def _same_stream_state(st, other, what: str) -> None:
    """A fleet stream's state bit-equal to another state (a node's)."""
    for f in STATE_FIELDS:
        x, y = getattr(st, f), getattr(other, f)
        if not (x == y if f == "step" else torch.equal(x, y)):
            raise AssertionError(f"{what}: state.{f} differs")


def _fresh_node(lut, plane):
    node = VoFOD(VoFODConfig(), DynParams(), NodeOptions(), lut, device="cuda")
    node.load_apriori_map(plane)
    return node


def _fleet(n_streams: int, plane):
    fleet = FleetVoFOD(VoFODConfig(), DynParams(), n_streams, device="cuda")
    fleet.load_apriori_map(plane)
    return fleet


def _fleet_parity(lut, cycle, plane, sweep_launches: dict) -> dict:
    """(a) and (d): FLEET_B streams for FLEET_TICKS ticks beside FLEET_B
    single-stream nodes fed the same scans: every tick's detections and
    diagnostics and every final state bit-equal; each tick exactly one host
    sync (sync-debug mode on the fleet's tick only) and the kernel launches
    of the nodes' FLEET_B scans, which are FLEET_B x phase 4's per-scan
    count of every sweep-path kernel.  Returns the per-tick records."""
    fleet = _fleet(FLEET_B, plane)
    nodes = [_fresh_node(lut, plane) for _ in range(FLEET_B)]
    per_scan = {k: sweep_launches[k] / N_SCANS for k in SWEEP_KERNELS}
    records, syncs, tick_launches = [], [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for k in range(FLEET_TICKS):
            r, p = _fleet_tick(cycle, FLEET_B, k)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            before = len(caught)
            torch.cuda.set_sync_debug_mode("warn")
            try:
                msgs = fleet.process_scans(r, p)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            syncs.append(sum(1 for w in caught[before:] if "synchroniz" in str(w.message)
                             and "prototype" not in str(w.message)))
            fl = kernels.launch_counts()
            kernels.reset_launch_counts()
            node_msgs = [n.process_scan(r[b], None, p[b]) for b, n in enumerate(nodes)]
            nl = kernels.launch_counts()
            tick_launches.append({kk: fl[kk] for kk in SWEEP_KERNELS})
            if fl != nl:
                raise AssertionError(f"tick {k}: fleet launches {fl}, the nodes' {nl}")
            want = {kk: FLEET_B * v for kk, v in per_scan.items()}
            got = {kk: fl[kk] for kk in SWEEP_KERNELS}
            if got != want or not all(got.values()):
                raise AssertionError(f"tick {k}: launches {got}, {FLEET_B} x phase 4's {want}")
            tick = []
            for b, (n, m) in enumerate(zip(nodes, node_msgs)):
                rec = _stream_record(fleet, msgs, b)
                _same_record(rec, _node_record(n, m), f"(a) tick {k}, stream {b}")
                tick.append(rec)
            records.append(tick)
    if syncs != [1] * FLEET_TICKS:
        raise AssertionError(f"(d) host syncs per tick {syncs}, expected exactly 1")
    for b, n in enumerate(nodes):
        _same_stream_state(fleet.state[b], n.state, f"(a) final state, stream {b}")
        if torch.isnan(fleet.state[b].grid).any():
            raise AssertionError(f"(a) stream {b}: grid holds NaN")
    return dict(records=records, nodes=nodes, syncs=syncs, launches=tick_launches[-1],
                detections=[sum(len(t[b][0]) for t in records) for b in range(FLEET_B)])


def _fleet_events(lut, cycle, plane, clean: dict) -> dict:
    """(b) and (c): the same run with a NaN rotation on one stream at one
    tick (a null scan: that stream equal to a node stepped on zero ranges
    and the sentinel pose there, the others equal to their clean runs) and
    one stream reset and re-stamped before a later tick (equal to a fresh
    node with the plane stamped, then to that node fed the stream's scans;
    its step counter restarted)."""
    (t_nan, s_nan), (t_reset, s_reset) = FLEET_NAN, FLEET_RESET
    fleet = _fleet(FLEET_B, plane)
    null_node = _fresh_node(lut, plane)
    sentinel = np.eye(4, dtype=np.float32)
    sentinel[:3, 3] = np.asarray(VoFODConfig().oparea.lo, np.float32) - 1.0e6
    reset_node = None
    steps_after_reset = None
    for k in range(FLEET_TICKS):
        if k == t_reset:
            fleet.reset_stream(s_reset)
            fleet.load_apriori_map(plane, stream=s_reset)
            reset_node = _fresh_node(lut, plane)
            _same_stream_state(fleet.state[s_reset], reset_node.state, "(c) just after reset")
            steps_after_reset = [s.step for s in fleet.state]
        r, p = _fleet_tick(cycle, FLEET_B, k)
        if k == t_nan:
            p[s_nan, :3, :3] = np.nan  # finite translation, NaN rotation
        msgs = fleet.process_scans(r, p)
        for b in range(FLEET_B):
            rec = _stream_record(fleet, msgs, b)
            if b == s_nan:
                rb, pb = (np.zeros_like(r[b]), sentinel) if k == t_nan else (r[b], p[b])
                ref = _node_record(null_node, null_node.process_scan(rb, None, pb))
            elif b == s_reset and k >= t_reset:
                ref = _node_record(reset_node, reset_node.process_scan(r[b], None, p[b]))
            else:
                ref = clean["records"][k][b]
            _same_record(rec, ref, f"(b/c) tick {k}, stream {b}")
    rejected = [int(x) for x in fleet.n_pose_rejected]
    if rejected != [1 if b == s_nan else 0 for b in range(FLEET_B)]:
        raise AssertionError(f"(b) n_pose_rejected {rejected}")
    if torch.isnan(fleet.state[s_nan].grid).any():
        raise AssertionError("(b) the null-scan stream's grid holds NaN")
    _same_stream_state(fleet.state[s_nan], null_node.state, "(b) final state, null stream")
    _same_stream_state(fleet.state[s_reset], reset_node.state, "(c) final state, reset stream")
    for b in range(FLEET_B):
        if b not in (s_nan, s_reset):
            _same_stream_state(fleet.state[b], clean["nodes"][b].state, f"(b) stream {b}")
    # tests/test_fleet.py:124-131: the reset stream restarts at 0 while the
    # others keep counting, and stays offset
    want = [0 if b == s_reset else t_reset for b in range(FLEET_B)]
    final = [s.step for s in fleet.state]
    if steps_after_reset != want or final != [FLEET_TICKS - t_reset if b == s_reset
                                              else FLEET_TICKS for b in range(FLEET_B)]:
        raise AssertionError(f"(c) step counters {steps_after_reset} after the reset, {final}")
    return dict(n_pose_rejected=rejected, steps_after_reset=steps_after_reset,
                steps_final=final)


def _fleet_profile(fleet, cycle, tick_ms_p50: float) -> dict:
    """B = fleet.n_streams's device busy ms and idle share a tick over
    FLEET_PROFILE_TICKS ticks (torch.profiler).  A session that saw no
    device time, or fewer of the port's kernel launches than the wrappers
    made less the first few a session loses (PERF.md section 7), is taken
    again, up to three sessions; then the phase fails."""
    from torch.profiler import ProfilerActivity, profile

    n = FLEET_PROFILE_TICKS
    got = []
    for _ in range(3):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for k in range(n):
                fleet.process_scans(*_fleet_tick(cycle, fleet.n_streams, k))
            torch.cuda.synchronize()
        wrappers = sum(kernels.launch_counts().values())
        ev = prof.key_averages()
        dev_ops = [e for e in ev if not e.key.startswith(("vofod.", "aten::"))
                   and _dev_us(e, True) > 0]
        busy = sum(_dev_us(e, True) for e in dev_ops) / n / 1e3
        port = sum(v[1] for v in port_kernel_ms(dev_ops, n).values()) * n
        got.append(dict(busy=busy, port_launches=port, wrapper_launches=wrappers))
        if busy > 0 and port >= wrappers - 4:
            return dict(device_busy_ms_per_tick=round(busy, 3),
                        idle_share_of_tick=round(1.0 - busy / tick_ms_p50, 3),
                        device_ops_per_tick=sum(e.count for e in dev_ops) / n,
                        port_kernel_launches=port, wrapper_launches=wrappers,
                        sessions=len(got),
                        port_kernels_ms_per_tick=port_kernel_ms(dev_ops, n))
    raise AssertionError(f"(e) fleet profile empty or short in three sessions: {got}")


def _host_timed(obj, names: tuple, acc: dict) -> None:
    """Wrap obj's methods ``names`` to add each call's host ms to acc[name]."""
    for name in names:
        def wrap(*a, _fn=getattr(obj, name), _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                acc[_name] = acc.get(_name, 0.0) + (time.perf_counter() - t0) * 1e3
        setattr(obj, name, wrap)


FLEET_PARTS = ("_upload", "_step", "_fetch")


def _fleet_timing(cycle, plane) -> dict:
    """(e) For each B of FLEET_TIMING_B: tick wall ms (host clock from the
    stacked upload to the host messages, as serve_fleet measures) p50 / p95
    over FLEET_TIMED_TICKS ticks after FLEET_WARM_TICKS, aggregate scans/s,
    the tick's host ms by part (staging and upload; the streams' steps,
    enqueued; the packed readback, waiting for the device), and B = 4's
    device busy ms and idle share a tick."""
    out, profiled = {}, None
    for n_streams in FLEET_TIMING_B:
        fleet = _fleet(n_streams, plane)
        acc, parts = {}, []
        _host_timed(fleet, FLEET_PARTS, acc)
        ms = []
        for k in range(FLEET_WARM_TICKS + FLEET_TIMED_TICKS):
            r, p = _fleet_tick(cycle, n_streams, k)
            acc.clear()
            t0 = time.perf_counter()
            fleet.process_scans(r, p)
            if k >= FLEET_WARM_TICKS:
                ms.append((time.perf_counter() - t0) * 1e3)
                parts.append(dict(acc))
        out[n_streams] = dict(
            tick_ms_p50=float(np.percentile(ms, 50)), tick_ms_p95=float(np.percentile(ms, 95)),
            scans_per_s=n_streams * len(ms) / (sum(ms) / 1e3),
            tick_ms_per_stream_p50=float(np.percentile(ms, 50)) / n_streams,
            host_ms_p50_by_part={n: round(float(np.median([q[n] for q in parts])), 3)
                                 for n in FLEET_PARTS},
            tick_ms_all=[round(x, 3) for x in ms])
        if n_streams == FLEET_B:
            profiled = _fleet_profile(fleet, cycle, out[n_streams]["tick_ms_p50"])
        del fleet
    held = [b for b, v in out.items() if v["tick_ms_p95"] <= FLEET_BUDGET_MS]
    return dict(by_streams=out, largest_streams_at_10hz=max(held) if held else 0,
                profile_b4=profiled)


def _fleet_cli(cycle) -> dict:
    """(f) tools/serve_fleet.main on the card: 4 streams over an NPZ of the
    cycle, 5 ticks; its summary must count 5 ticks."""
    import io

    from vofod_tpu_torch.io.scan_source import save_scans_npz
    from vofod_tpu_torch.tools import serve_fleet

    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    path = str(work / "fleet_cycle.npz")
    save_scans_npz(path, np.stack([r for r, _ in cycle[:12]]),
                   np.stack([p for _, p in cycle[:12]]))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = serve_fleet.main(["--streams", "4", "--scans", path, "--ticks", "5", "--loop",
                               "--json", "--device", "cuda"])
    lines = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
    summary = [ln for ln in lines if ln.get("summary")]
    ticks = [ln for ln in lines if "latency_ms" in ln]
    if rc != 0 or len(summary) != 1 or summary[0]["ticks"] != 5 or len(ticks) != 5:
        raise AssertionError(f"(f) serve_fleet: rc {rc}, summary {summary}, "
                             f"{len(ticks)} tick lines; stderr {err.getvalue()[-2000:]}")
    return dict(summary=summary[0], stderr=err.getvalue().strip().splitlines()[-1],
                detection_records=sum(1 for ln in lines if "stream" in ln))


def phase4_fleet(lut, sweep_launches: dict) -> None:
    """The streams' fleet (runtime/fleet.FleetVoFOD) at the flagship size,
    VoFODConfig() and DynParams(), the apriori plane stamped in every
    stream: (a) FLEET_B streams, stream b fed the cycle from scan 3 b,
    bit-equal to single-stream nodes tick by tick; (b) a NaN rotation as a
    null scan; (c) reset_stream and load_apriori_map(stream=); (d) one host
    sync a tick and FLEET_B x the sweep path's launches a scan; (e) tick
    times at 1-16 streams and B = 4's device busy and idle share; (f) the
    serving CLI on the card."""
    cycle = scan_cycle(lut, N_SCANS)
    plane = apriori_ground()
    clean = _fleet_parity(lut, cycle, plane, sweep_launches)
    events = _fleet_events(lut, cycle, plane, clean)
    say("4-fleet", streams=FLEET_B, ticks=FLEET_TICKS, bit_equal_to_nodes=True,
        host_syncs_per_tick=clean["syncs"], launches_per_tick=clean["launches"],
        detections_per_stream=clean["detections"], null_scan=dict(
            tick=FLEET_NAN[0], stream=FLEET_NAN[1], n_pose_rejected=events["n_pose_rejected"]),
        reset=dict(tick=FLEET_RESET[0], stream=FLEET_RESET[1],
                   steps_after_reset=events["steps_after_reset"],
                   steps_final=events["steps_final"]))
    del clean
    timing = _fleet_timing(cycle, plane)
    say("4-fleet-timing", nvidia_smi=_smi(), budget_ms=FLEET_BUDGET_MS,
        warm_ticks=FLEET_WARM_TICKS, timed_ticks=FLEET_TIMED_TICKS, **timing)
    say("4-fleet-cli", nvidia_smi=_smi(), **_fleet_cli(cycle))


def _global_ext(g: torch.Tensor, z0: int, nzl: int, r: int, fill) -> torch.Tensor:
    """K15b-1's result from the whole grid: its rows [z0 - r, z0 + nzl + r),
    ``fill`` past its edges."""
    pad = torch.full((r,) + tuple(g.shape[1:]), fill, dtype=g.dtype, device=g.device)
    return torch.cat([pad, g, pad])[z0:z0 + nzl + 2 * r]


def _flagship_inputs(lut, n_warm: int = 6):
    """A dense flagship node after the apriori plane and ``n_warm`` scans of
    the cycle, and the next scan (ranges, pose)."""
    node = VoFOD(VoFODConfig(), DynParams(), NodeOptions(), lut, device="cuda")
    node.load_apriori_map(apriori_ground())
    scans = scan_cycle(lut, n_warm + 1)
    for r, p in scans[:n_warm]:
        node.process_scan(r, None, p)
    return node, scans[n_warm]


@contextlib.contextmanager
def _cone_launches_vs_plain(batch: int):
    """K15b-3's and K15b-4b's wrappers replaced, for a grid sweep at
    ``batch`` planes a launch, by ones that launch the kernel and run its
    plain model on copies of the same inputs, launch by launch (the carry
    as the kernels left it and the halo refilled, as
    ops/raycast.cone_sweep_lat_sharded and cone_sweep_z_transposed run
    them): the T rows and the carry each writes must be bit-equal.  Yields
    (the mismatches, the launches by (kernel, shard))."""
    import vofod_tpu_torch.ops.raycast as rc

    bad, seen = [], {}
    real = kernels.cone_sweep_lat, kernels.cone_sweep_zt, rc.CONE_BATCH

    def paired(name, kernel, plain):
        def call(window, rel_x, rel_y, rel_z, carry, T, slab, rows, p0, m):
            n_planes = max(window.shape[1:]) if name == "cone_sweep_lat" else window.shape[0]
            carry_p = None if carry is None else carry.clone()
            T_p = T.clone()
            kernel(window, rel_x, rel_y, rel_z, carry, T, slab, rows, p0, m)
            plain(window, rel_x, rel_y, rel_z, carry_p, T_p, slab, rows, p0, m)
            key = (name, torch.cuda.current_stream().cuda_stream)
            seen[key] = seen.get(key, 0) + 1
            # bits, not values: the planes no launch has reached yet hold
            # whatever the allocation held, NaN patterns too
            if not (torch.equal(T.view(torch.int32), T_p.view(torch.int32)) and (
                    carry is None or torch.equal(carry.view(torch.int16),
                                                 carry_p.view(torch.int16)))):
                bad.append(dict(kernel=name, slab=slab, rows=rows, p0=p0, m=m,
                                carry_out=p0 + m < n_planes))
        return call

    kernels.cone_sweep_lat = paired("cone_sweep_lat", real[0], cone_lat_batch_plain)
    kernels.cone_sweep_zt = paired("cone_sweep_zt", real[1], cone_zt_batch_plain)
    rc.CONE_BATCH = batch
    try:
        yield bad, seen
    finally:
        kernels.cone_sweep_lat, kernels.cone_sweep_zt, rc.CONE_BATCH = real


def _cones_vs_plain(window, op, rel_x, rel_y, rel_z_g, comm):
    """The x/y cones and the transposed z cones of a shard's rows of the
    window (K15b-3, K15b-4b; inside ``comm.run``), and K15b-4a beside its
    plain version round by round, the carries passed as
    ops/raycast.cone_sweep_z_pipelined passes them (the kept rounds' carry
    and T must be equal).  Returns (the slab's T6 with the pipelined z
    cones, the transposed z cones' T2, K15b-4a's mismatches)."""
    nzl, wy, wx = op.shape
    n, me, dev = comm.n, comm.rank, op.device
    z0 = me * nzl
    rel_z = rel_z_g[z0:z0 + nzl].contiguous()
    t6 = torch.empty((6, nzl, wy, wx), dtype=torch.float32, device=dev)
    t2 = torch.empty((2, nzl, wy, wx), dtype=torch.float32, device=dev)
    cone_sweep_lat_sharded(window, rel_x, rel_y, rel_z_g, t6[:4], comm)
    cone_sweep_z_transposed(window, rel_x, rel_y, rel_z_g, t2, comm)
    bad = []
    carry = torch.ones((2, wy, wx), dtype=torch.bfloat16, device=dev)
    tp = torch.empty((2, nzl, wy, wx), dtype=torch.float32, device=dev)
    for r in range(n):
        keep = (me == r, me == n - 1 - r)
        if any(keep):
            out = kernels.cone_sweep_z(op, rel_x, rel_y, rel_z, carry, t6[4:], keep)
            want = cone_z_round_plain(op, rel_x, rel_y, rel_z, carry, tp, keep)
            if not all(torch.equal(out[c], want[c]) and torch.equal(t6[4 + c], tp[c])
                       for c in (0, 1) if keep[c]):
                bad.append(dict(kernel="cone_sweep_z", round=r, shard=me))
            carry = out
        if r < n - 1:
            got = comm.ppermutes([(carry[0], [(r, r + 1)]), (carry[1], [(n - 1 - r, n - 2 - r)])])
            for c, recv in enumerate(got):
                if recv is not None:
                    carry[c] = recv
    return t6, t2, bad


def _serpentine_xz(grid: GridSpec, dev) -> torch.Tensor:
    """Occupancy of one winding corridor in the x-z plane y = ny / 2: rows of
    x on every other z, joined at alternate ends, through every shard."""
    occ = torch.zeros(grid.shape, dtype=torch.bool, device=dev)
    y, nx = grid.ny // 2, grid.nx
    for z in range(0, grid.nz, 2):
        occ[z, y, 4:nx - 4] = True
        if z + 2 < grid.nz:
            occ[z + 1, y, nx - 5 if (z // 2) % 2 == 0 else 4] = True
    return occ


def _sharded_k2_cases(comm, ops, grid: GridSpec, cfg, dyn, vals, keys) -> dict:
    """K2's batched launches (up to SWEEP_BATCH sweeps a launch on a halo of
    as many sweeps' reach) through parallel/gridops.sharded_sweeps on the 3
    shards at once, each shard's launches on its own stream, beside the same
    schedule with the plain model of each launch on the same inputs: slab,
    global per-sweep flags and tiles per sweep bit-equal, and the slabs and
    flags equal to the dense K2's.  Cases: the step's 8 label sweeps at r3
    (one launch, a halo of 24 rows: 2 hops of 17), 20 gated ones (a short
    last launch), 8 reach sweeps at r2, the dynamic path's shells at bound
    4 (a halo of 32 rows) and 40 gated sweeps along a corridor through every
    shard (the cap binds: every launch runs).  Times one launch of the
    step's label sweeps on shard 1 (a fresh scratch each: its memset
    included; fresh buffers, the second at the fill) beside its plain
    model; the bound is by bytes: the keys and the mask of the rows the
    interior's result depends on (within k sweeps' reach of it, clipped to
    the grid: no row past its edges) read once, the interior's keys written
    once."""
    dev = vals.device
    n, nzl = GRID_SHARDS, grid.nz // GRID_SHARDS
    bg = vals > dyn.thr_new_obstacles
    sure = vals > dyn.thr_sure_obstacles
    radius = cfg.ground_points_max_distance / cfg.voxel_size
    serp = _serpentine_xz(grid, dev)
    flat = torch.arange(grid.n_voxels, dtype=torch.int32, device=dev).reshape(grid.shape)
    cases = {
        "label r3, 8 sweeps": (keys, bg, radius, cfg.cc_sweeps, False),
        "label r3, 20 gated": (keys, bg, radius, 20, True),
        "reach r2, 8 sweeps": ((bg & sure).to(torch.uint8), bg, 2.0, cfg.cc_sweeps, False),
        "shells bound 4, 8 sweeps": (keys, bg, Shells(4.0, 14.44), cfg.cc_sweeps, False),
        "corridor r1.5, 40 gated": (torch.where(serp, flat, SENTINEL), serp, 1.5, 40, True),
    }
    out = {}
    for name, (init, occ, ball, n_sw, gated) in cases.items():
        want, wflags = sweeps(init, occ, ball, n_sw, gated)
        kernels.reset_launch_counts()

        def shard(rank, init=init, occ=occ, ball=ball, n_sw=n_sw, gated=gated):
            sl = slice(rank * nzl, (rank + 1) * nzl)
            args = (init[sl].contiguous(), occ[sl].contiguous(), ball, n_sw, gated)
            return (sharded_sweeps(ops, *args, batch_on_card),
                    sharded_sweeps(ops, *args, batch_plain))
        got = comm.run(shard)
        launches = kernels.launch_counts()["propagate_batch"]
        for rank, (k, p) in enumerate(got):
            for x, y, what in zip(k, p, ("slab", "flags", "tiles per sweep")):
                if not torch.equal(x, y):
                    raise AssertionError(f"sharded K2 [{name}] shard {rank}: {what} differs "
                                         "from the plain model")
        if not (torch.equal(torch.cat([k[0] for k, _ in got]), want)
                and all(torch.equal(k[1], wflags) for k, _ in got)):
            raise AssertionError(f"sharded K2 [{name}] differs from the dense sweeps")
        k = min(SWEEP_BATCH, n_sw)
        if launches != n * -(-n_sw // k):
            raise AssertionError(f"sharded K2 [{name}]: {launches} launches")
        _, reach = tap_set(ball)
        grow = int(ball.bound) if isinstance(ball, Shells) else reach
        out[name] = dict(sweeps=n_sw, gated=gated, sweeps_a_launch=k, halo_rows=k * grow,
                         hops=-(-k * grow // nzl), launches=launches,
                         flags=wflags.int().tolist(),
                         tiles_per_sweep=[t.tolist() for (_, _, t), _ in got])
    if not (out["label r3, 8 sweeps"]["hops"] >= 2 and 20 % SWEEP_BATCH
            and out["label r3, 20 gated"]["launches"] == n * -(-20 // SWEEP_BATCH) > n
            and out["corridor r1.5, 40 gated"]["flags"][-1] == 1):
        raise AssertionError(f"sharded K2 cases: {out}")
    say("2-grid-k2", cases=out)
    # one launch of the step's label sweeps on shard 1's extended slab
    taps, reach = tap_set(radius)
    k = min(SWEEP_BATCH, cfg.cc_sweeps)
    h = k * reach
    z0 = nzl
    # the launch's two buffers, the second at the fill, a fresh copy a call
    pair = torch.stack(kernels.sweep_buffers(_global_ext(keys, z0, nzl, h, SENTINEL)))
    occ_e = _global_ext(bg.view(torch.uint8), z0, nzl, h, 0).contiguous()
    rows = (h, h + nzl)

    def launch(bufs):
        sc = kernels.sweeps_scratch(bufs.shape[1:], k, 1, dev)
        kernels.propagate_batch(bufs[0], bufs[1], occ_e, taps, reach, sc, 0, 0, k, reach, rows,
                                None, n)
        return sc

    def plain(bufs):
        sc = kernels.sweeps_scratch(bufs.shape[1:], k, 1, dev)
        batch_plain(bufs[0], bufs[1], occ_e, radius, taps, reach, sc, 0, 0, k, reach, rows,
                    None, n)
        return sc

    tiles = launch(pair.clone())[1]
    if not torch.equal(tiles, plain(pair.clone())[1]):
        raise AssertionError("K2b: one launch's tiles differ from the plain model's")
    plane = grid.ny * grid.nx
    cone = min(grid.nz, z0 + nzl + h) - max(0, z0 - h)  # rows the interior depends on
    return dict(
        name="propagate_batch", max_abs_err=0.0, ms=_inplace_ms(launch, pair),
        plain_ms=_inplace_ms(plain, pair, reps=2),
        bytes=cone * plane * (4 + 1) + nzl * plane * 4,
        ops=int(tiles.sum()) * 32 * 8 * 4 * len(taps),
        library_ms=None, cases=out, tiles_per_sweep=tiles.tolist(),
        shapes=f"shard 1's slab ({nzl}, {grid.ny}, {grid.nx}) + 2 x {h} halo rows, "
               f"{k} label sweeps at r3 ({len(taps)} taps) a launch; checked bit-equal "
               f"to its plain model on 3 concurrent shards in {len(out)} cases; bound: "
               f"{cone} rows read (keys, mask), {nzl} written",
    )


def _sharded_k2_wide(comm, ops, grid: GridSpec, cfg, dyn, vals, keys) -> dict:
    """K2's batched launch in its wide form (fine-0125's ground ball, r 12:
    the step's 8 label sweeps a launch on a halo of 96 rows, 6 hops of 17)
    through parallel/gridops.sharded_sweeps on the 3 shards at once, beside
    the plain model of each launch (slab, flags, tiles per sweep bit-equal)
    and the dense sweeps; one launch on shard 1 timed beside its plain
    model, bound as ``_sharded_k2_cases``'s."""
    dev = vals.device
    n, nzl = GRID_SHARDS, grid.nz // GRID_SHARDS
    bg = vals > dyn.thr_new_obstacles
    radius = 12.0
    want, wflags = sweeps(keys, bg, radius, cfg.cc_sweeps)
    kernels.reset_launch_counts()

    def shard(rank):
        sl = slice(rank * nzl, (rank + 1) * nzl)
        args = (keys[sl].contiguous(), bg[sl].contiguous(), radius, cfg.cc_sweeps, False)
        return (sharded_sweeps(ops, *args, batch_on_card), sharded_sweeps(ops, *args, batch_plain))
    got = comm.run(shard)
    launches = kernels.launch_counts()
    for rank, (k, p) in enumerate(got):
        _equal(k, p, f"K2bw[{rank}].slab K2bw[{rank}].flags K2bw[{rank}].tiles")
    if not (torch.equal(torch.cat([k[0] for k, _ in got]), want)
            and all(torch.equal(k[1], wflags) for k, _ in got)):
        raise AssertionError("sharded K2 wide form differs from the dense sweeps")
    if (launches["propagate_batch_wide"], launches["propagate_batch"]) != (n, 0):
        raise AssertionError(f"sharded K2 wide form: launches {launches}")
    taps, reach = tap_set(radius)
    k = min(SWEEP_BATCH, cfg.cc_sweeps)
    h, z0 = k * reach, nzl
    pair = torch.stack(kernels.sweep_buffers(_global_ext(keys, z0, nzl, h, SENTINEL)))
    occ_e = _global_ext(bg.view(torch.uint8), z0, nzl, h, 0).contiguous()
    rows = (h, h + nzl)

    def launch(bufs):
        sc = kernels.sweeps_scratch(bufs.shape[1:], k, 1, dev)
        kernels.propagate_batch(bufs[0], bufs[1], occ_e, taps, reach, sc, 0, 0, k, reach, rows,
                                None, n)
        return sc

    def plain(bufs):
        sc = kernels.sweeps_scratch(bufs.shape[1:], k, 1, dev)
        batch_plain(bufs[0], bufs[1], occ_e, radius, taps, reach, sc, 0, 0, k, reach, rows,
                    None, n)
        return sc

    tiles = launch(pair.clone())[1]
    if not torch.equal(tiles, plain(pair.clone())[1]):
        raise AssertionError("K2bw: one launch's tiles differ from the plain model's")
    plane = grid.ny * grid.nx
    cone = min(grid.nz, z0 + nzl + h) - max(0, z0 - h)
    clones = [pair.clone() for _ in range(12)]
    dp = device_profile(lambda: launch(clones.pop()), reps=3)
    plan = kernels.sweep_plan(taps, reach, 4)
    out = dict(sweeps=cfg.cc_sweeps, halo_rows=h, hops=-(-h // nzl), launches=launches[
        "propagate_batch_wide"], pairs=len(plan.runs), groups=plan.n_groups,
        combines_a_voxel=pool_combines(taps), executed_combines_a_voxel=_k2_executed(plan),
        registers=_registers("sweeps_kernelIi", "WideTaps"), smem_bytes=_sweep_smem(plan, reach, 4),
        tiles_per_sweep=tiles.tolist(), flags=wflags.int().tolist())
    say("2-grid-k2-wide", **out)
    return dict(
        name="propagate_batch_wide", max_abs_err=0.0, ms=_inplace_ms(launch, pair, reps=5),
        device_ms=dp["device_ms"], plain_ms=_inplace_ms(plain, pair, reps=2),
        bytes=cone * plane * (4 + 1) + nzl * plane * 4,
        ops=int(tiles.sum()) * 32 * 8 * 4 * pool_combines(taps), library_ms=None, cases=out,
        shapes=f"shard 1's slab ({nzl}, {grid.ny}, {grid.nx}) + 2 x {h} halo rows, {k} label "
               f"sweeps at r 12 ({len(taps)} taps, {len(plan.runs)} pairs) a launch, bound on "
               "the function's combines at every voxel of the tiles computed; the device ms "
               "includes the zero fill of the launch's scratch",
    )


def phase2_grid(lut) -> list[dict]:
    """The grid-sharded step's kernels against their plain versions on the
    card, with 3 shards of the flagship grid on one card: K15b-1 on f32,
    int32, bool and uint8 slabs at r = 1, 2, 3, 8, 16 and multi-hop at r =
    20 and 40 (past every shard), out of place and in place (the halo rows
    of a poisoned buffer), bit-equal to its plain versions and to the rows
    cut from the whole grid, and on a 51-row slab whose interior segment
    runs past the blocks the card holds resident; timed in place at the
    sharded sweeps' shapes (int32 r = 3, uint8 r = 2) and out of place at
    the explore pad's (f32 r = 16), each with its device time, bound and
    torch.cat's time (phase 2-grid-halo); K15b-2 at r = 16 and 20 (head and tail ranges
    overlap), bit-equal to its plain version and to the min over every
    shard's stamp; K15b-3, K15b-4a and K15b-4b launch by launch beside their
    plain versions on a flagship scan's window (K15b-3 and K15b-4b at
    CONE_BATCH and at 16 planes a launch, K15b-4a on each shard's kept cones
    only), and the step's sharded sweeps, T bit-equal to K4's, and the
    sharded K4 + K5b ray update bit-equal to the dense one under both update
    rules; K2's batched launches on the 3 shards at once beside their plain
    model (_sharded_k2_cases)."""
    dev = torch.device("cuda")
    cfg, dyn = VoFODConfig(), DynParams()
    grid = GridSpec.from_config(cfg)
    node, (r_np, pose_np) = _flagship_inputs(lut)
    n, nzl = GRID_SHARDS, grid.nz // GRID_SHARDS
    plane = grid.ny * grid.nx
    comm = LocalComm(n, [dev])
    ops = ZShardOps(comm, n)
    vals = node.state.grid
    keys = torch.where(vals > dyn.thr_new_obstacles,
                       torch.arange(grid.n_voxels, dtype=torch.int32, device=dev)
                       .reshape(grid.shape), SENTINEL)
    safe = node.state.safe
    results = []

    # K15b-1: every dtype of the path's exchanges, single hop and multi-hop,
    # out of place and in place (the sharded sweeps' form: only the halo
    # rows of a halo'd buffer written, its interior left as it was)
    reach = (vals > dyn.thr_new_obstacles).to(torch.uint8)
    for r in (1, 2, 3, 8, 16, 20, 40):
        for g, fill in ((vals, -1e30), (keys, SENTINEL), (safe, False), (reach, 0)):
            def shard(rank, g=g, fill=fill, r=r):
                # the step's exchange, and K15b-1 / its plain versions on the
                # blocks of one more exchange; the in-place forms on a
                # poisoned buffer holding the slab
                sl = g[rank * nzl:(rank + 1) * nzl].contiguous()
                lo, hi, takes = ops.halo_recv(sl, r)
                bufs = []
                for _ in range(3):
                    b = torch.empty((nzl + 2 * r,) + tuple(sl.shape[1:]), dtype=sl.dtype,
                                    device=dev)
                    b.view(torch.uint8).fill_(0xA5)
                    b[r:r + nzl] = sl
                    bufs.append(b)
                kernels.halo_fill_(bufs[0], r, lo, hi, takes, fill)
                halo_fill_plain_(bufs[1], r, lo, hi, takes, fill)
                ops.halo_fill_(bufs[2], r, fill)
                return (ops.halo_exchange(sl, r, fill),
                        kernels.halo_exchange(sl, lo, hi, takes, fill),
                        halo_exchange_plain(sl, lo, hi, takes, fill), *bufs)
            for rank, outs in enumerate(comm.run(shard)):
                ref = _global_ext(g, rank * nzl, nzl, r, fill)
                if not all(torch.equal(o, ref) for o in outs):
                    raise AssertionError(f"K15b-1 {g.dtype} r={r} shard {rank} differs")
    # one segment past the blocks the card holds resident: the whole grid
    # as the slab (51 rows, 9.9 MB of f32), one hop each side
    geo = kernels.halo_geometry()
    if geo["tile_bytes"] != HALO_TILE_BYTES:
        raise AssertionError(f"K15b-1's tile {geo['tile_bytes']} B != the model's")
    big = vals.contiguous()
    lo1, hi1 = [vals[-1:].contiguous()], [vals[:1].contiguous()]
    seg_tiles = [t["tiles"] for t in halo_segments(grid.nz, 1, [1], plane * 4, big.data_ptr())]
    if max(seg_tiles) <= geo["resident"]:
        raise AssertionError(f"no K15b-1 segment past the {geo['resident']} resident blocks")
    if not torch.equal(kernels.halo_exchange(big, lo1, hi1, [1], -1e30),
                       halo_exchange_plain(big, lo1, hi1, [1], -1e30)):
        raise AssertionError("K15b-1 differs on a segment past the resident blocks")
    say("2-grid-halo-geometry", tile_bytes=geo["tile_bytes"], resident_blocks=geo["resident"],
        segment_tiles=max(seg_tiles))
    # the timed calls: the sharded sweeps' in-place fills (int32 labels at
    # r = 3, uint8 reach at r = 2) and the explore pad's exchange (f32, r =
    # 16), shard 1's inputs; library: torch.cat of the whole extended slab
    # (what the out-of-place exchange computes; the in-place fill writes its
    # 2r halo rows of it)
    z0 = nzl
    halo_lines = {}
    for case, g, h, fill, in_place in (("inplace_int32_r3", keys, 3, SENTINEL, True),
                                       ("inplace_uint8_r2", reach, 2, 0, True),
                                       ("f32_r16", vals, 16, -1e30, False)):
        slab = g[z0:z0 + nzl].contiguous()
        lo, hi = [g[z0 - h:z0].contiguous()], [g[z0 + nzl:z0 + nzl + h].contiguous()]
        row = plane * g.element_size()
        if in_place:
            ext = _global_ext(g, z0, nzl, h, fill).contiguous()
            call = partial(kernels.halo_fill_, ext, h, lo, hi, [h], fill)
            plain = partial(halo_fill_plain_, ext, h, lo, hi, [h], fill)
            moved = 2 * (2 * h * row)  # the blocks read, the halo rows written
        else:
            call = partial(kernels.halo_exchange, slab, lo, hi, [h], fill)
            plain = partial(halo_exchange_plain, slab, lo, hi, [h], fill)
            moved = 2 * (nzl + 2 * h) * row
        line = dict(case=case, dtype=str(g.dtype), r=h, rows_out=nzl + 2 * h,
                    ms=cuda_ms(call), plain_ms=cuda_ms(plain),
                    library_ms=cuda_ms(partial(torch.cat, lo + [slab] + hi)),
                    bytes=moved, bound_ms=moved / HBM_BYTES_PER_S * 1e3, **device_profile(call))
        line["device_share_of_bound"] = (line["bound_ms"] / line["device_ms"]
                                         if line["device_ms"] else None)  # not measured
        say("2-grid-halo", **line)
        halo_lines[case] = line
    f16 = halo_lines["f32_r16"]
    results.append(dict(
        name="halo_exchange", max_abs_err=0.0, ms=f16["ms"], plain_ms=f16["plain_ms"],
        bytes=f16["bytes"], ops=0, library_ms=f16["library_ms"], device_ms=f16["device_ms"],
        library_call="torch.cat of the received rows and the slab",
        shapes=f"f32 slab ({nzl}, {grid.ny}, {grid.nx}) + 2 x 16 rows -> ({nzl + 32}, ...); "
               "checked at r 1, 2, 3, 8, 16, 20, 40 on f32 / int32 / bool / uint8, in and out "
               "of place, 3 shards, and a 51-row slab past the resident blocks",
    ))

    # K2's batched launches on halo'd slabs, beside their plain model
    results.append(_sharded_k2_cases(comm, ops, grid, cfg, dyn, vals, keys))
    results.append(_sharded_k2_wide(comm, ops, grid, cfg, dyn, vals, keys))

    # K15b-2: each shard stamps its whole halo-extended view with 50 - rank
    base = (torch.arange(grid.n_voxels, dtype=torch.float32, device=dev) + 100.0).reshape(
        grid.shape)
    for r in (16, 20):
        def shard(rank, r=r):
            ext = ops.halo_exchange(base[rank * nzl:(rank + 1) * nzl], r, float("inf"))
            ext = torch.minimum(ext, torch.tensor(50.0 - rank, device=dev)).contiguous()
            fn, fp, takes = ops.fold_recv(ext, r)
            return (ops.halo_fold_min(ext, r), kernels.halo_fold_min(ext, r, fn, fp, takes),
                    halo_fold_min_plain(ext, r, fn, fp, takes))
        out = comm.run(shard)
        want = base.clone()
        for i in range(n):
            a, b = max(0, i * nzl - r), min(grid.nz, (i + 1) * nzl + r)
            want[a:b] = torch.minimum(want[a:b], torch.tensor(50.0 - i, device=dev))
        got_e, got_k, got_p = (torch.cat(parts) for parts in zip(*out))
        if not (torch.equal(got_k, got_p) and torch.equal(got_k, want)
                and torch.equal(got_e, want)):
            raise AssertionError(f"K15b-2 r={r} differs")
    h = 16  # shard 1's inputs at the explore pad
    ext = _global_ext(vals, z0, nzl, h, 0.0).contiguous()
    fn, fp = [ext[:h].clone()], [ext[-h:].clone()]
    results.append(dict(
        name="halo_fold_min", max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.halo_fold_min(ext, h, fn, fp, [h])),
        plain_ms=cuda_ms(lambda: halo_fold_min_plain(ext, h, fn, fp, [h])),
        bytes=(2 * nzl + 2 * h) * plane * 4, ops=2 * h * plane, library_ms=None,
        shapes=f"f32 ({nzl + 2 * h}, {grid.ny}, {grid.nx}) + 2 x {h} returned rows -> "
               f"({nzl}, ...); checked at r 16 and 20 (overlapping head and tail), 3 shards",
    ))

    # K15b-3 / K15b-4a / K15b-4b: the sharded sweeps of the scan's blockers,
    # launch by launch against the plain versions at the module's planes a
    # launch and at 16 (7 launches of K15b-3, 4 of K15b-4b, their halo of two
    # hops above, clipped at the grid's edges, refilled between), T against
    # K4; then K4 + K5b dense against the sharded update
    ranges = torch.as_tensor(r_np.astype(np.float32), device=dev)
    pose = torch.as_tensor(pose_np, device=dev)
    dirs = torch.as_tensor(lut.directions, device=dev)
    offs = torch.as_tensor(lut.offsets, device=dev)
    occ = frontend_bin(cfg, grid, dirs, offs, ranges, pose)[0] > 0
    origin = np.asarray(pose_np[:3, 3], np.float32)
    bound = cfg.raycast_max_distance_bound
    x0, y0, wx, wy, gx, gy, gz = sweep_window(grid, origin, bound)
    rel_z = torch.arange(grid.nz, dtype=torch.float32, device=dev) + 0.5 - float(gz)
    rel_x = torch.arange(wx, dtype=torch.float32, device=dev) + float(x0) + 0.5 - float(gx)
    rel_y = torch.arange(wy, dtype=torch.float32, device=dev) + float(y0) + 0.5 - float(gy)
    t_dense = cone_sweep(occ[:, y0:y0 + wy, x0:x0 + wx].contiguous(), rel_x, rel_y, rel_z)
    op_w = occ[:, y0:y0 + wy, x0:x0 + wx].contiguous().view(torch.uint8)
    pb = max(wx, wy)
    checked = {}
    for batch in sorted({CONE_BATCH, 16}):
        with _cone_launches_vs_plain(batch) as (bad, seen):
            out = comm.run(lambda rank: _cones_vs_plain(
                op_w, op_w[rank * nzl:(rank + 1) * nzl], rel_x, rel_y, rel_z, comm))
        t_k = torch.cat([t for t, _, _ in out], dim=1)
        t_t = torch.cat([t for _, t, _ in out], dim=1)
        bad = bad + [m for _, _, mis in out for m in mis]
        want = {"cone_sweep_lat": -(-pb // min(batch, pb)),
                "cone_sweep_zt": -(-grid.nz // min(batch, grid.nz))}
        launches = {name: sorted(c for (k, _), c in seen.items() if k == name) for name in want}
        if bad or not (torch.equal(t_k, t_dense) and torch.equal(t_t, t_dense[4:])) or any(
                launches[k] != [w] * n for k, w in want.items()):
            raise AssertionError(
                f"sharded sweeps at {batch} planes a launch: launches against their plain "
                f"versions {bad[:4]}; x/y and pipelined z cones vs K4 "
                f"{int((t_k != t_dense).sum())} voxels, transposed z cones vs K4 "
                f"{int((t_t != t_dense[4:]).sum())}; launches a shard {launches}, want {want}")
        checked[batch] = launches
    say("2-grid-cones", planes_a_launch=CONE_BATCH, cluster=kernels.CONE_CLUSTER,
        launches_a_shard=checked)
    t_s = torch.cat(comm.run(lambda rank: sweep_zsharded(
        grid, occ[rank * nzl:(rank + 1) * nzl], origin, comm, bound)[0]), dim=1)
    t_t = torch.cat(comm.run(lambda rank: sweep_zsharded(
        grid, occ[rank * nzl:(rank + 1) * nzl], origin, comm, bound, "transpose")[0][4:]), dim=1)
    if not (torch.equal(t_s, t_dense) and torch.equal(t_t, t_dense[4:])):
        raise AssertionError(f"the step's sharded sweep T vs K4: {int((t_s != t_dense).sum())} "
                             f"voxels, its transposed z cones {int((t_t != t_dense[4:]).sum())}")
    rot = pose[:3, :3].contiguous()
    kw = dict(max_distance=float(dyn.raycast_max_distance), vertical_fov=cfg.sensor.vertical_fov,
              v_rays=lut.height, h_rays=lut.width, max_distance_bound=bound)
    for new_rule in (True, False):
        ema = RayEma(new_rule, 0.25, 1.0, 0.5, float(dyn.score_ray))
        want = raycast_update_(grid, vals.clone(), occ, occ, origin, rot, ema, **kw)
        got = torch.cat(comm.run(lambda rank: raycast_update_zsharded(
            grid, vals[rank * nzl:(rank + 1) * nzl].clone(), occ[rank * nzl:(rank + 1) * nzl],
            occ[rank * nzl:(rank + 1) * nzl], origin, rot, ema, comm=comm, **kw)))
        if not torch.equal(got, want):
            raise AssertionError(f"sharded K4 + K5b (new rule {new_rule}) differs from the dense "
                                 f"update in {int((got != want).sum())} voxels")

    # one launch of each at the module's planes a launch, on shard 1's slab
    # (its rows extended by the halo, clipped at the grid's edges)
    k = min(CONE_BATCH, pb)
    own, lo_t, hi_t = cone_halo_plan(n, nzl, grid.nz, k)
    slab = (own[1][0] - sum(lo_t[1]), own[1][1] + sum(hi_t[1]))
    n_e = slab[1] - slab[0]
    carry = (torch.ones((n_e, 4, pb), dtype=torch.bfloat16, device=dev) if k < pb else None)
    t4 = torch.empty((4, nzl, wy, wx), dtype=torch.float32, device=dev)
    lat_args = (op_w, rel_x, rel_y, rel_z, carry, t4, slab, own[1], 0, k)
    nw = n_e * wy * wx
    results.append(dict(
        name="cone_sweep_lat", max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.cone_sweep_lat(*lat_args)),
        device_ms=device_profile(lambda: kernels.cone_sweep_lat(*lat_args))["device_ms"],
        plain_ms=cuda_ms(lambda: cone_lat_batch_plain(*lat_args), reps=2),
        # the slab's opacity read once, T of the own rows and the carry of
        # every slab row written once; 16 operations a lane a plane (two
        # 4-tap resamples and the attenuation) on every slab row
        bytes=nw + 4 * nzl * wy * wx * 4 + (n_e * 4 * pb * 2 if carry is not None else 0),
        ops=4 * nw * 16 * k // pb, library_ms=None,
        shapes=f"shard 1's launch of {k} of {pb} planes ({-(-pb // k)} a shard a scan): 4 "
               f"cones on the z rows {slab[0]}-{slab[1] - 1} of the ({grid.nz}, {wy}, {wx}) "
               f"window, T of its {nzl} rows, each cone on a cluster of "
               f"{kernels.CONE_CLUSTER} blocks; launch by launch bit-equal to the plain "
               f"version at {CONE_BATCH} and 16 planes a launch, the sweep's T to K4's",
    ))
    carry = torch.ones((2, wy, wx), dtype=torch.bfloat16, device=dev)
    op1 = op_w[nzl:2 * nzl]
    rz1 = rel_z[nzl:2 * nzl].contiguous()
    t2 = torch.empty((2, nzl, wy, wx), dtype=torch.float32, device=dev)
    both = (True, True)
    nw = nzl * wy * wx
    results.append(dict(
        name="cone_sweep_z", max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.cone_sweep_z(op1, rel_x, rel_y, rz1, carry, t2, both)),
        one_cone_ms=cuda_ms(lambda: kernels.cone_sweep_z(op1, rel_x, rel_y, rz1, carry, t2,
                                                         (True, False))),
        device_ms=device_profile(lambda: kernels.cone_sweep_z(op1, rel_x, rel_y, rz1, carry,
                                                              t2, both))["device_ms"],
        plain_ms=cuda_ms(lambda: cone_z_round_plain(op1, rel_x, rel_y, rz1, carry, t2, both),
                         reps=3),
        bytes=nw * (1 + 2 * 4) + 2 * 2 * wy * wx * 2, ops=nw * 2 * 16, library_ms=None,
        shapes=f"the middle shard's launch: 2 cones x {nzl} planes of ({wy}, {wx}), each on a "
               f"cluster of {kernels.CONE_CLUSTER} blocks; one_cone_ms: an end shard's launch; "
               f"{2 * n - n % 2} launches a scan over {n} shards",
    ))
    # K15b-4b: shard 1's rows of the window's y, extended by the halo
    kz = min(CONE_BATCH, grid.nz)
    nyl = -(-wy // n)
    own, lo_t, hi_t = cone_halo_plan(n, nyl, wy, kz)
    slab = (own[1][0] - sum(lo_t[1]), own[1][1] + sum(hi_t[1]))
    n_e = slab[1] - slab[0]
    carry = (torch.ones((n_e, 2, wx), dtype=torch.bfloat16, device=dev) if kz < grid.nz
             else None)
    tt = torch.empty((2, grid.nz, nyl, wx), dtype=torch.float32, device=dev)
    zt_args = (op_w, rel_x, rel_y, rel_z, carry, tt, slab, own[1], 0, kz)
    nw = grid.nz * n_e * wx
    results.append(dict(
        name="cone_sweep_zt", max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.cone_sweep_zt(*zt_args)),
        device_ms=device_profile(lambda: kernels.cone_sweep_zt(*zt_args))["device_ms"],
        plain_ms=cuda_ms(lambda: cone_zt_batch_plain(*zt_args), reps=2),
        bytes=nw + 2 * grid.nz * nyl * wx * 4 + (n_e * 2 * wx * 2 if carry is not None else 0),
        ops=2 * nw * 16 * kz // grid.nz, library_ms=None,
        shapes=f"shard 1's launch of {kz} of {grid.nz} planes ({-(-grid.nz // kz)} a shard a "
               f"scan): 2 cones on the y rows {slab[0]}-{slab[1] - 1} of the ({grid.nz}, {wy}, "
               f"{wx}) window, T of its {nyl} rows, each cone on a cluster of "
               f"{kernels.CONE_CLUSTER} blocks; launch by launch bit-equal to the plain "
               f"version, T to K4's z cones",
    ))
    for r in results:
        say("2-grid-kernel", **r)
    return results


def phase2_grid_exact(lut) -> list[dict]:
    """The reference-exact grid path's kernels with 3 shards of a flagship
    exact scan on the card, each against its plain version on the same
    received blocks and against the dense kernel on the gathered grid:
    K15b-6b (column sums, ranks, cell queries) bit-equal, equal to K13b;
    K2's sharded label components equal to the dense labels, converged flag
    and sweep count; K15b-6a (scatter, read-back) bit-equal, equal to K13a
    with the flags; K13c on the halo'd coarse arrays through its z window
    bit-equal, equal to K13c; K15b-6c's slabs equal to K12's rows, within
    K12_RAYLEN_RTOL of the plain version's sequential sum on the host, and
    the sharded exact raycast (walk + EMA, both rules) equal to the dense."""
    dev = torch.device("cuda")
    cfg, dyn = exact_config(), DynParams()
    grid = GridSpec.from_config(cfg)
    nv = grid.n_voxels
    n, nzl = GRID_SHARDS, grid.nz // GRID_SHARDS
    node = VoFOD(cfg, dyn, NodeOptions(raycast_mode="exact"), lut, device=dev)
    node.load_apriori_map(apriori_ground())
    scans = scan_cycle(lut, 7)
    for r, p in scans[:6]:
        node.process_scan(r, None, p)
    r_np, pose_np = scans[6]
    vals = node.state.grid
    comm = LocalComm(n, [dev])
    ops = ZShardOps(comm, n)
    sl = [slice(i * nzl, (i + 1) * nzl) for i in range(n)]
    bg = vals > dyn.thr_new_obstacles
    sure = vals > dyn.thr_sure_obstacles
    mv = int(np.ceil(cfg.sepclusters_max_bg_distance / cfg.voxel_size))
    lsz = max(mv - 1, 1)
    radius = cfg.sepclusters_max_bg_distance / cfg.voxel_size
    min_sure = float(np.float32(dyn.sepclusters_min_sure_points))
    results, checks = [], {}

    # K15b-6b: each pass beside its plain version on the same gathered
    # columns and psum'd table; the slabs' counts against K13b; the same on
    # grids with no bg and all bg
    def quirk_shard(rank, bg_, what):
        b, s_ = bg_[sl[rank]].contiguous(), sure[sl[rank]].contiguous()
        cols = kernels.quirk_columns(b, s_)
        _equal((cols,), (quirk_columns_plain(b, s_),), f"K15b-6b{what}.columns[{rank}]")
        blocks = comm.all_gather(cols)
        u_k, below = kernels.quirk_ranks(b, s_, blocks, rank, nv)
        _equal((u_k, below), quirk_ranks_plain(b, s_, blocks, rank, nv),
               f"K15b-6b{what}.u[{rank}] K15b-6b{what}.below[{rank}]")
        u = comm.psum(u_k)
        q = kernels.quirk_query(b, lsz, u, below)
        _equal((q,), (quirk_query_plain(b, lsz, u, below),), f"K15b-6b{what}.query[{rank}]")
        return q, quirk_sure_counts_sharded(b, s_, lsz, comm)

    no_bg = torch.zeros_like(bg)
    for bg_, what in ((bg, ""), (no_bg, "[no bg]"), (~no_bg, "[all bg]")):
        out = comm.run(lambda rank: quirk_shard(rank, bg_, what))
        sure_c = quirk_sure_counts(bg_, sure, lsz)
        if not (torch.equal(torch.cat([q for q, _ in out]), sure_c)
                and torch.equal(torch.cat([q for _, q in out]), sure_c)):
            raise AssertionError(f"K15b-6b{what}: the sharded quirk counts differ from K13b")
    sure_c = quirk_sure_counts(bg, sure, lsz)
    checks["quirk_moved_cells"] = int((sure_c != pool_sum_coarse((bg & sure).to(torch.int32),
                                                                 lsz)).sum())

    # K2's sharded label components against the dense ones
    occ_c = pool_sum_coarse(bg.to(torch.int32), lsz) > 0
    labels, conv, n_sweeps = label_components(occ_c, mv / lsz, 128)
    out = comm.run(lambda rank: ops.label_components(occ_c[sl[rank]], mv / lsz, 128))
    if not (torch.equal(torch.cat([o[0] for o in out]), labels)
            and all(bool(o[1]) == bool(conv) and int(o[2]) == int(n_sweeps) for o in out)):
        raise AssertionError("sharded K2 label components differ from the dense ones")
    checks.update(label_sweeps=int(n_sweeps), converged=bool(conv))

    # K15b-6a: scatter and read-back beside their plain versions around the
    # psum; the cells and the flags against K13a
    cell_d, flags_d = label_census(labels, sure_c, occ_c, nv, min_sure)

    def census_shard(rank):
        lab, v, o = (t[sl[rank]].contiguous() for t in (labels, sure_c, occ_c))
        cen = kernels.census_scatter(lab, v, o, nv)
        _equal((cen,), (census_scatter_plain(lab, v, o, nv),), f"K15b-6a.census[{rank}]")
        cen = comm.psum(cen)
        got = kernels.census_read(lab, o, cen, min_sure)
        _equal(got, census_read_plain(lab, o, cen, min_sure),
               f"K15b-6a.cells[{rank}] K15b-6a.flags[{rank}]")
        return got[0], comm.any(got[1]), ops.label_census(lab, v, o, nv, min_sure)

    out = comm.run(census_shard)
    if not (torch.equal(torch.cat([c for c, _, _ in out]), cell_d)
            and torch.equal(torch.cat([st[0] for _, _, st in out]), cell_d)
            and all(torch.equal(f, flags_d) and torch.equal(st[1], flags_d)
                    for _, f, st in out)):
        raise AssertionError("K15b-6a: the sharded census differs from K13a")

    # K13c on the halo'd coarse arrays through its z window, beside its
    # plain version on the same arrays; the slabs against K13c
    w1, _ = demote_weights(1.0, dyn.score_ray)
    consts = (min_sure, w1, float(np.float32(dyn.score_ray)),
              float(np.float32(dyn.thr_new_obstacles)))
    prev = torch.zeros((), dtype=torch.bool, device=dev)
    dense13c = exact_demote_ema(vals, occ_c, cell_d, flags_d, prev, lsz, radius, *consts)

    def demote_shard(rank):
        (o_h, c_h), win = ops.halo_window((occ_c[sl[rank]], cell_d[sl[rank]]), (False, 0),
                                          -(-int(np.floor(radius)) // lsz), grid.nz // lsz)
        args = (vals[sl[rank]], o_h, c_h, flags_d, prev, lsz, radius, *consts,
                (win[2] * lsz, win[1], grid.nz // lsz))
        k = exact_demote_ema(*args)
        _equal(k, exact_demote_ema_plain(*args),
               f"K13c-win.grid[{rank}] K13c-win.safe[{rank}] K13c-win.sure[{rank}]")
        taps = (ball_taps(radius), int(np.floor(radius)))
        sched = kernels.exact_demote_ema_schedule(*args[:6], *taps, *args[7:])[-1]
        return k + (sched,)

    out = comm.run(demote_shard)
    checks["k13c_window_schedules"] = [o[3] for o in out]
    for j, what in enumerate(("grid", "safe")):
        if not torch.equal(torch.cat([o[j] for o in out]), dense13c[j]):
            raise AssertionError(f"windowed K13c {what} differs from the dense K13c")
    checks["k13c_demoted"] = int((dense13c[0] != vals).sum())

    # K15b-6c: the slabs against K12's rows (bit-equal) and the plain
    # version's sequential sum on the host; walk + EMA under both rules
    H, W = lut.height, lut.width
    ranges_m = torch.as_tensor(r_np.astype(np.float32), device=dev) * 0.001
    pose = torch.as_tensor(pose_np, device=dev)
    rays = exact_rays(cfg, dyn, grid, torch.as_tensor(lut.directions, device=dev),
                      torch.as_tensor(lut.offsets, device=dev),
                      torch.ones(H * W, dtype=torch.bool, device=dev), ranges_m,
                      torch.ones(H * W, dtype=torch.float32, device=dev), pose)
    bound = cfg.raycast_max_distance_bound
    k12 = raycast_dda(grid, *rays, bound)
    slabs = comm.run(lambda rank: raycast_dda_slab(grid, *rays, bound, ops.slab(grid.nz)))
    if not torch.equal(torch.cat(slabs), k12):
        raise AssertionError(f"K15b-6c slabs differ from K12 in "
                             f"{int((torch.cat(slabs) != k12).sum())} voxels")
    cpu_rays = [t.cpu() for t in rays]
    rel, err = [], 0.0
    for rank, k in enumerate(slabs):
        p_ = raycast_dda_slab_plain(grid, *cpu_rays, bound, (rank * nzl, nzl)).to(dev)
        if not torch.equal(k > 0, p_ > 0):
            raise AssertionError(f"K15b-6c shard {rank}: nonzero voxels differ from plain")
        rel.append(_rel_stats(k, p_) if bool((p_ > 0).any()) else dict(max=0.0))
        err = max(err, max_abs(k, p_))
    if max(r_["max"] for r_ in rel) > K12_RAYLEN_RTOL:
        raise AssertionError(f"K15b-6c against plain: {rel} (tol {K12_RAYLEN_RTOL})")
    had = node.state.grid > 1e30  # no voxel: every ray EMA applies where raylen > 0
    for new_rule in (True, False):
        ema = ray_ema(cfg, dataclasses.replace(dyn, raycast_new_update_rule=new_rule), 1.0)
        want = DENSE.raycast_dda_update_(grid, vals.clone(), had, *rays, bound, ema)
        got = torch.cat(comm.run(lambda rank: ops.raycast_dda_update_(
            grid, vals[sl[rank]].clone(), had[sl[rank]], *rays, bound, ema)))
        if not torch.equal(got, want):
            raise AssertionError(f"sharded exact raycast (new rule {new_rule}) differs from "
                                 f"the dense one in {int((got != want).sum())} voxels")
    say("2-grid-exact-checks", **checks, dda_slab_rel=rel)

    # per-call times on the slab with the most background (the ground's)
    t = int(torch.stack([bg[x].sum() for x in sl]).argmax())
    b1, s1 = bg[sl[t]].contiguous(), sure[sl[t]].contiguous()
    plane = grid.ny * grid.nx
    blocks = torch.stack([kernels.quirk_columns(bg[x].contiguous(), sure[x].contiguous())
                          for x in sl])
    u1, below1 = kernels.quirk_ranks(b1, s1, blocks, t, nv)
    nb1 = int(b1.sum())
    bg_e1 = b1.permute(2, 1, 0).reshape(-1).to(torch.int32)
    results.append(dict(
        name="quirk_columns", max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.quirk_columns(b1, s1)),
        **device_profile(lambda: kernels.quirk_columns(b1, s1)),
        plain_ms=cuda_ms(lambda: quirk_columns_plain(b1, s1)),
        bytes=2 * nzl * plane + 8 * plane, ops=2 * nzl * plane,
        library_ms=cuda_ms(lambda: b1.sum(0, dtype=torch.int32)),
        library_call="torch.sum of the bg slab over z (int32)",
        shapes=f"shard {t}'s slab ({nzl}, {grid.ny}, {grid.nx}) -> {plane} columns; bit-equal",
    ))
    results.append(dict(
        name="quirk_ranks", max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.quirk_ranks(b1, s1, blocks, t, nv)),
        **device_profile(lambda: kernels.quirk_ranks(b1, s1, blocks, t, nv)),
        plain_ms=cuda_ms(lambda: quirk_ranks_plain(b1, s1, blocks, t, nv)),
        bytes=2 * nzl * plane + 8 * n * plane + 4 * (nv + 2), ops=4 * nzl * plane,
        library_ms=cuda_ms(lambda: torch.cumsum(bg_e1, 0)),
        library_call="torch.cumsum of the bg slab in export order (int32)",
        shapes=f"slab ({nzl}, {grid.ny}, {grid.nx}), {n} x {plane} gathered columns -> "
               f"the {nv + 2}-entry rank table ({nb1} bg ranks written); bit-equal",
    ))
    u = u1.clone()
    nc1 = nzl * plane
    results.append(dict(
        name="quirk_query", max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.quirk_query(b1, lsz, u, below1)),
        **device_profile(lambda: kernels.quirk_query(b1, lsz, u, below1)),
        plain_ms=cuda_ms(lambda: quirk_query_plain(b1, lsz, u, below1)),
        bytes=nzl * plane + 8 * nc1 + 4 * nc1, ops=4 * nc1, library_ms=None,
        shapes=f"{nc1} cells of the slab, leaf {lsz}; bit-equal",
    ))
    lab1, v1, o1 = (x[sl[t]].contiguous() for x in (labels, sure_c, occ_c))
    cen = torch.zeros(nv, dtype=torch.int32, device=dev)
    lab_occ = torch.where(o1, lab1, 0).reshape(-1).long()
    v_occ = torch.where(o1, v1, 0).reshape(-1)
    cen_psum = census_scatter_plain(labels, sure_c, occ_c, nv)  # the psum'd census
    results.append(dict(
        name="census_scatter", max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.census_scatter(lab1, v1, o1, nv)),
        plain_ms=cuda_ms(lambda: census_scatter_plain(lab1, v1, o1, nv)),
        bytes=nc1 * (4 + 4 + 1) + nv * 4, ops=nc1,
        library_ms=cuda_ms(lambda: cen.zero_().index_add_(0, lab_occ, v_occ)),
        library_call="index_add_ of the slab's counts at its cells' labels",
        shapes=f"{nc1} cells into the global label space of {nv}; bit-equal",
    ))
    results.append(dict(
        name="census_read", max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.census_read(lab1, o1, cen_psum, min_sure)),
        plain_ms=cuda_ms(lambda: census_read_plain(lab1, o1, cen_psum, min_sure)),
        bytes=nc1 * (4 + 1 + 4 + 4), ops=nc1 * 3, library_ms=None,
        shapes=f"{nc1} cells read back from {nv} buckets, with the two flags; bit-equal",
    ))
    # the DDA on the slab with the most chords
    fid_c, w_c = dda_emissions_plain(grid, *cpu_rays, bound)
    t = int(torch.bincount(fid_c // (nzl * plane), minlength=n).argmax())
    slab1 = (t * nzl, nzl)
    own = fid_c // (nzl * plane) == t
    lf1, w1_ = (fid_c[own] - t * nzl * plane).to(dev), w_c[own].to(dev)
    acc1 = torch.zeros(nzl * plane, dtype=torch.float32, device=dev)
    results.append(dict(
        name="dda_slab", max_abs_err=err, rel=rel, tol_rel=K12_RAYLEN_RTOL,
        emissions=int(fid_c.numel()), slab_emissions=int(own.sum()),
        ms=cuda_ms(lambda: raycast_dda_slab(grid, *rays, bound, slab1)),
        plain_ms=cuda_ms(lambda: raycast_dda_slab_plain(grid, *rays, bound, slab1), reps=3),
        # rays in, the slab out once; ~20 ops per walked step of every ray
        bytes=rays[0].shape[0] * (12 + 12 + 4 + 1) + nzl * plane * 4,
        ops=int(fid_c.numel()) * 20,
        library_ms=cuda_ms(lambda: acc1.index_add_(0, lf1, w1_)),
        library_call="index_add_ of the slab's nonzero (id, chord) emissions: the scatter "
                     "half only (the walk that finds the emissions is not timed)",
        shapes=f"{rays[0].shape[0]} rays walked, slab rows [{t * nzl}, {(t + 1) * nzl}) of "
               f"{grid.shape}; every slab equal to K12's rows",
    ))
    for r in results:
        say("2-grid-kernel", **r)
    return results


def _voxels_read(grid: GridSpec, qx, qy, qz, qvalid, S: int, z0: int, nzl: int) -> int:
    """The grid voxels the valid queries' submaps hold inside the z rows
    [z0, z0 + nzl) (what K15b-7a reads)."""
    half = S // 2

    def span(c, lo, hi):
        a = torch.clamp(c.long() - half, min=lo)
        b = torch.clamp(c.long() - half + S, max=hi)
        return torch.clamp(b - a, min=0)

    n = span(qz, z0, z0 + nzl) * span(qy, 0, grid.ny) * span(qx, 0, grid.nx)
    return int((n * qvalid).sum())


def _cut_cases(grid: GridSpec, base: torch.Tensor, Q: int) -> dict:
    """K15b-7a's cases past the K7s cases (query slots only; the rest of
    the Q slots invalid): boxes that straddle a seam between the shards'
    slabs, boxes that miss a slab (planes 0-2 and 48-50: the S = 32 box of
    one misses the far slab), boxes at the grid's x / y edges, and case
    (c)'s random field's queries at S = 40 (64-bit words)."""
    dev = base.device
    g = torch.Generator(device=dev).manual_seed(22)
    nzl = grid.nz // GRID_SHARDS

    def table(z, y, x, n_valid):
        n = z.shape[0]
        qx, qy, qz = (torch.zeros(Q, dtype=torch.int32, device=dev) for _ in range(3))
        qz[:n], qy[:n], qx[:n] = z, y, x
        qvalid = torch.arange(Q, device=dev) < n_valid
        return qx, qy, qz, qvalid

    def rand(hi, n):
        return torch.randint(0, hi, (n,), generator=g, device=dev, dtype=torch.int32)

    seams = torch.tensor([nzl - 1, nzl, nzl + 1, 2 * nzl - 1, 2 * nzl, 2 * nzl + 1],
                         dtype=torch.int32, device=dev)
    n = 48
    seam_z = seams[torch.arange(n, device=dev) % seams.shape[0]]
    out_z = torch.tensor([0, 1, 2, grid.nz - 3, grid.nz - 2, grid.nz - 1], dtype=torch.int32,
                         device=dev)[torch.arange(n, device=dev) % 6]
    ex = torch.tensor([0, 1, grid.nx - 2, grid.nx - 1], dtype=torch.int32, device=dev)
    ey = torch.tensor([0, 1, grid.ny - 2, grid.ny - 1], dtype=torch.int32, device=dev)
    k = torch.arange(n, device=dev)
    edge_x = torch.where(k % 2 == 0, ex[k % 4], rand(grid.nx, n))
    edge_y = torch.where(k % 2 == 1, ey[k % 4], rand(grid.ny, n))
    return {
        "(s) seam-straddling boxes": (32, table(seam_z, rand(grid.ny, n), rand(grid.nx, n), 40)),
        "(t) boxes outside a slab": (32, table(out_z, rand(grid.ny, n), rand(grid.nx, n), 40)),
        "(u) S = 40": (40, table(rand(grid.nz, 256), rand(grid.ny, 256), rand(grid.nx, 256),
                                 256)),
        "(v) boxes at the x / y edges": (32, table(rand(grid.nz, n), edge_y, edge_x, 40)),
    }


def _cut_vs_plain(comm, base: torch.Tensor, qt: tuple, S: int, thr_f: float, thr_g: float,
                  tag: str) -> torch.Tensor:
    """K15b-7a on each shard's slab of ``base`` at once, each bit-equal to
    its plain version, and the psum'd stack equal to the plain cut of the
    whole grid; returns the whole grid's plain cut."""
    nzl = base.shape[0] // GRID_SHARDS
    whole = explore_cut_plain(base, *qt, thr_f, thr_g, S)

    def cut_shard(rank):
        slab = base[rank * nzl:(rank + 1) * nzl].contiguous()
        k = kernels.explore_cut(slab, *qt, thr_f, thr_g, S, rank * nzl)
        _equal((k,), (explore_cut_plain(slab, *qt, thr_f, thr_g, S, rank * nzl),),
               f"K15b-7a{tag}[{rank}]")
        return comm.psum(k)

    for rank, st in enumerate(comm.run(cut_shard)):
        _equal((st,), (whole,), f"K15b-7a{tag}.stack[{rank}]")
    return whole


def _fused_vs_plain(grid: GridSpec, whole: torch.Tensor, base: torch.Tensor, q: tuple, rank: int,
                    thr_f: float, tag: str, stats: torch.Tensor | None = None) -> dict:
    """K15b-7b's launch with K15b-7c's stores on shard ``rank``'s slab (a
    copy of ``base``'s rows): the walk bit-equal to its plain version, and
    the slab and count bit-equal to ``demote_direct_plain`` of the launch's
    own reached / corners / demoted on the slab.  Returns the count and
    the slab's voxels the stores changed."""
    nzl = grid.nz // GRID_SHARDS
    z0 = rank * nzl
    slab = base[z0:z0 + nzl].clone()
    walk = kernels.explore_seq_stack(whole, grid.shape, *q, 96, slab, z0, thr_f, stats=stats)
    _equal(walk[:4], explore_sequential_stack_plain(grid, whole, *q),
           " ".join(f"K15b-7b{tag}[{rank}].{f}" for f in ("connected", "reached", "corners",
                                                          "demoted")))
    want = demote_direct_plain(base[z0:z0 + nzl].clone(), *walk[1:4], thr_f, (z0, grid.nz))
    _equal((slab, walk[4]), want, f"K15b-7c{tag}.slab[{rank}] K15b-7c{tag}.n_writes[{rank}]")
    return dict(n_writes=int(walk[4]), changed=int((slab != base[z0:z0 + nzl]).sum()))


def phase2_grid_seq(lut) -> list[dict]:
    """The sequential explore over z shards (K15b-7a, and K15b-7b with
    K15b-7c's stores in its launch) with 3 shards of 17 planes of the
    flagship grid on the card.  K15b-7a's cut of each slab bit-equal to its
    plain version, and the psum'd stack equal to the plain cut of the whole grid, in K7s cases (a)
    a flagship scan's queries and (c) 256 random queries over 32 clusters
    (boxes overlap, demotions chain) of :func:`_seq_cases`, and in
    :func:`_cut_cases`.  In (a) and (c) the fused launch on each slab:
    its walk bit-equal to its plain version, its slab and count to
    ``demote_direct_plain`` of its own outputs; and the two through
    ``ZShardOps.explore_sequential`` bit-equal to the dense K7s on the same
    grid: the grid, cluster_connected and n_writes.  Then the fused launch
    on every shard in all eight cases (its walk's counts equal the schedule
    model's, its ticket 0 after), the shared-memory bodies' stores at S =
    40 on case (c)'s queries (the fused launch on every slab, K7s on the
    whole grid), and the 3 shards' launches of case (c) at once on their
    own streams and tickets.  CUDA-event ms of each kernel
    and its plain version, on case (a) (case (c) beside it)."""
    dev = torch.device("cuda")
    cfg, dyn = sequential_config(), DynParams()
    grid = GridSpec.from_config(cfg)
    S, K, Q = cfg.explore_submap, cfg.max_clusters, cfg.max_queries
    thr_f, thr_g = dyn.thr_frontiers, dyn.thr_new_obstacles
    n, nzl = GRID_SHARDS, grid.nz // GRID_SHARDS
    sl = [slice(i * nzl, (i + 1) * nzl) for i in range(n)]
    comm = LocalComm(n, [dev])
    ops = ZShardOps(comm, n)
    runs, _ = _seq_cases(lut)
    cases, timed = {}, {}
    field = runs["(c) 256 queries, 32 clusters"][0]
    for name, (s_, qt) in _cut_cases(grid, field, Q).items():
        _cut_vs_plain(comm, field, qt, s_, thr_f, thr_g, name[:3])
        cases[name] = dict(S=s_, valid_queries=int(qt[3].sum()))
    for name in ("(a) flagship scan", "(c) 256 queries, 32 clusters"):
        tag = name[:3]
        base, q = runs[name]
        qx, qy, qz, qvalid, qlabels, qids, qslot, mm, ov = q
        whole = _cut_vs_plain(comm, base, q[:4], S, thr_f, thr_g, tag)
        fused = [_fused_vs_plain(grid, whole, base, q, rank, thr_f, tag) for rank in range(n)]
        conn, reached, corners, demoted = explore_sequential_stack_plain(grid, whole, *q)
        dg, dc, dn = explore_sequential_(grid, base.clone(), *q, thr_f, thr_g, S)
        outs = comm.run(lambda rank: ops.explore_sequential(grid, base[sl[rank]].clone(), *q,
                                                            thr_f, thr_g, S))
        for rank, (_, c, w) in enumerate(outs):
            _equal((c, w), (dc, dn), f"K15b-7{tag}.connected[{rank}] K15b-7{tag}.n_writes[{rank}]")
        _equal((torch.cat([o[0] for o in outs]),), (dg,), f"K15b-7{tag}.grid")
        if sum(f["n_writes"] for f in fused) != int(dn):
            raise AssertionError(f"K15b-7c{tag}: the shards' counts {fused}, the dense {int(dn)}")
        # boxes that overlap an earlier failed query's (what the walk's
        # clearing reads)
        gz = corners.long()
        idx = torch.nonzero(demoted)[:, 0]
        close = ((gz[:, None, :] - gz[idx][None, :, :]).abs() < S).all(-1)
        close &= torch.arange(Q, device=dev)[:, None] != idx[None, :]
        overlap = close.any(-1) & qvalid
        cases[name] = dict(valid_queries=int(qvalid.sum()), failed_queries=int(demoted.sum()),
                           clusters_connected=int(dc.sum()), n_writes=int(dn),
                           shard_writes=[f["n_writes"] for f in fused],
                           queries_overlapping_a_failed_box=int(overlap.sum()))
        mid = 1  # the middle shard's slab
        z0 = mid * nzl
        slab = base[sl[mid]].contiguous()

        # the walk on the shard with the most stores
        ws = max(range(n), key=lambda r: fused[r]["n_writes"])
        wslab, wwin = base[sl[ws]].contiguous(), (ws * nzl, grid.nz)

        def walk_plain(v):
            c = explore_sequential_stack_plain(grid, whole, *q)
            return demote_direct_plain(v, *c[1:], thr_f, wwin)

        timed[name] = dict(
            cut=(cuda_ms(lambda: kernels.explore_cut(slab, qx, qy, qz, qvalid, thr_f, thr_g, S,
                                                     z0)),
                 cuda_ms(lambda: explore_cut_plain(slab, qx, qy, qz, qvalid, thr_f, thr_g, S,
                                                   z0), reps=3)),
            walk=(_inplace_ms(lambda v: kernels.explore_seq_stack(whole, grid.shape, *q, 96, v,
                                                                  ws * nzl, thr_f), wslab),
                  _inplace_ms(walk_plain, wslab, reps=1)),
            voxels_read=_voxels_read(grid, qx, qy, qz, qvalid, S, z0, nzl),
            slab_writes=fused[ws]["n_writes"], walk_shard=ws)
    c_ = cases["(c) 256 queries, 32 clusters"]
    if not (c_["n_writes"] > 0 and 0 < c_["clusters_connected"] < K
            and c_["queries_overlapping_a_failed_box"] > 0
            and sum(w > 0 for w in c_["shard_writes"]) >= 2):
        raise AssertionError(f"K15b-7 case (c) does not chain demotions over shards: {c_}")
    # the fused launch on every shard in every case of _seq_cases, on the
    # whole grid's stack, its walk's counts held to the schedule model's
    walks = {}
    for name, (base, q) in runs.items():
        whole = explore_cut_plain(base, *q[:4], thr_f, thr_g, S)
        stats = [torch.full((4,), -1, dtype=torch.int32, device=dev) for _ in range(n)]
        fused = [_fused_vs_plain(grid, whole, base, q, rank, thr_f, name[:3], stats[rank])
                 for rank in range(n)]
        walks[name] = _seq_walk_check(grid, base, q, stats[0], f"K15b-7b{name[:3]}", S, thr_f,
                                      thr_g)
        if any(st.tolist() != stats[0].tolist() for st in stats):
            raise AssertionError(f"K15b-7b{name[:3]}: the shards' walk counts differ")
        walks[name]["shard_writes"] = [f["n_writes"] for f in fused]
    # the shared-memory body's stores (S = 40, 64-bit words) on case (c)'s
    # queries: K7s's on the whole grid, the fused launch's on every slab
    base, q = runs["(c) 256 queries, 32 clusters"]
    whole = explore_cut_plain(base, *q[:4], thr_f, thr_g, 40)
    fused = [_fused_vs_plain(grid, whole, base, q, rank, thr_f, "(c)S40") for rank in range(n)]
    dense = explore_sequential_(grid, base.clone(), *q, thr_f, thr_g, 40)
    _equal(dense, explore_sequential_plain(grid, base.clone(), *q, thr_f, thr_g, 40),
           "K7s(c)S40.grid K7s(c)S40.connected K7s(c)S40.n_writes")
    if sum(f["n_writes"] for f in fused) != int(dense[2]) or int(dense[2]) == 0:
        raise AssertionError(f"K15b-7c(c)S40: the shards' counts {fused}, K7s's {int(dense[2])}")
    walks["(c) at S = 40"] = dict(shard_writes=[f["n_writes"] for f in fused])
    # the 3 shards' launches at once, each on its stream with its own ticket
    base, q = runs["(c) 256 queries, 32 clusters"]
    whole = explore_cut_plain(base, *q[:4], thr_f, thr_g, S)

    def shard_walk(rank):
        stats = torch.full((4,), -1, dtype=torch.int32, device=dev)
        f = _fused_vs_plain(grid, whole, base, q, rank, thr_f, f"(c)@{rank}", stats)
        return f, stats, kernels.seq_ticket(whole.device, kernels._stream())

    outs = comm.run(shard_walk)
    torch.cuda.synchronize()
    for rank, (_, stats, _) in enumerate(outs):
        if stats.tolist() != outs[0][1].tolist():
            raise AssertionError(f"K15b-7b shard {rank}'s walk counts {stats.tolist()}")
    tickets = [int(t) for _, _, t in outs]
    if len({t.data_ptr() for _, _, t in outs}) != n or any(tickets):
        raise AssertionError(f"K15b-7b shards' tickets {tickets}: not 0, or shared")
    say("2-grid-seq-walk", concurrent_shards=n, shard_tickets_after=tickets,
        shard_walk=outs[0][1].tolist(), shard_writes=[f["n_writes"] for f, _, _ in outs],
        **walks)
    a, ta, tc = (cases["(a) flagship scan"], timed["(a) flagship scan"],
                 timed["(c) 256 queries, 32 clusters"])
    word = 4 if S <= 32 else 8
    rows = Q * S * S * word
    qtab = Q * (6 * 4 + 1 + K)
    shapes = (f"Q={Q}, K={K}, S={S}, {n} shards of {nzl} planes; ms/plain_ms: case (a) "
              f"({a['valid_queries']} valid queries, {a['failed_queries']} failed), the cut on "
              f"the middle shard's slab, the walk on shard {ta['walk_shard']}'s (the most "
              f"stores); synthetic_ms: case (c) ({c_['valid_queries']} valid, "
              f"{c_['failed_queries']} failed, {c_['n_writes']} writes)")
    common = dict(max_abs_err=0.0, library_ms=None, cases=cases, shapes=shapes)
    out = [
        # the slab voxels of the submaps read once, the stack written once,
        # the slots' corners and flags read
        dict(name="explore_cut", ms=ta["cut"][0], plain_ms=ta["cut"][1],
             synthetic_ms=tc["cut"][0],
             bytes=ta["voxels_read"] * 4 + 2 * rows + Q * 13, ops=ta["voxels_read"] * 3,
             **common),
        # each valid query's stack rows read once, the reached rows written
        # once, the slab's demotions stored (no read); K7s's op count
        dict(name="explore_seq_stack", ms=ta["walk"][0], plain_ms=ta["walk"][1],
             synthetic_ms=tc["walk"][0], slab_writes=ta["slab_writes"],
             bytes=(a["valid_queries"] * 2 * S * S * word + rows + Q * 14 + qtab + K
                    + ta["slab_writes"] * 4),
             ops=a["valid_queries"] * S**3 * 7 + Q * Q + ta["slab_writes"], **common),
    ]
    for r_ in out:
        say("2-grid-seq", **r_)
    return out


class GridDriver:
    """The grid-sharded step (3 shards on the card) driven as the node drives
    the dense step: the scan staged in pinned memory, the step, one packed
    readback of shard 0's diagnostics and detections.  The raw scan is
    uploaded once; a prebinned one (``frontend_mode="prebinned"``) is binned
    on the host into a staging set, each shard uploads its slab, and the set
    is guarded by the shards' copy events.  ``cfg`` and ``step_kw``: the
    step's config and make_grid_sharded_step options (default the flagship
    sweep path; ``comm``: default 3 shards of a LocalComm on the card, or
    a ProcessComm, whose process holds its own shard)."""

    def __init__(self, lut, state: VoFODState, cfg: VoFODConfig | None = None, comm=None,
                 **step_kw):
        self.cfg, self.dyn = cfg or VoFODConfig(), DynParams()
        self.comm = comm or LocalComm(GRID_SHARDS, ["cuda"])
        self.step = make_grid_sharded_step(self.cfg, lut, self.comm, **step_kw)
        self.states = shard_state(state, self.comm)
        n = self.cfg.sensor.n_points
        self.binner = None
        self.bin_ms = []
        if step_kw.get("frontend_mode") == "prebinned":
            self.binner = HostBinner(self.cfg, lut)
            self.staging = HostStaging(((self.binner.n_voxels, torch.uint8), (n, torch.uint8),
                                        (2, torch.int32)), "cuda")
        else:
            self.staging = HostStaging(((n, torch.float32),), "cuda")
            self.ones = torch.ones(n, dtype=torch.float32, device="cuda")

    def process_scan_async(self, r, pose):
        pose = np.asarray(pose, np.float32)
        i, bufs = self.staging.next()
        if self.binner is None:
            np.copyto(bufs[0], np.asarray(r).reshape(-1), casting="unsafe")
            (ranges,) = self.staging.upload(i)
            scan = ScanInput(ranges_mm=ranges, intensity=self.ones, pose=pose)
            self.states, out = self.step(self.states, scan, self.dyn)
            return out
        t0 = time.perf_counter()
        self.binner.bin(r, pose, min_intensity=float(self.dyn.raycast_min_intensity), out=bufs)
        self.bin_ms.append((time.perf_counter() - t0) * 1e3)
        packed, active, stats = self.staging.sets[i]
        scan = PrebinnedScan(packed=packed.view(self.binner.shape), active=active, pose=pose,
                             stats=stats)
        events = []
        self.states, out = self.step(self.states, scan, self.dyn, upload_events=events)
        self.staging.guard(i, events)
        return out

    @staticmethod
    def fetch(out) -> tuple[dict, dict]:
        """(diag, detections) as numpy arrays, from one readback."""
        diag = [f.name for f in dataclasses.fields(out.diag)]
        dets = [f.name for f in dataclasses.fields(out.detections)]
        buf, layout = _pack([getattr(out.diag, f) for f in diag]
                            + [getattr(out.detections, f) for f in dets])
        host = _unpack(buf.cpu().numpy(), layout)
        return dict(zip(diag, host)), dict(zip(dets, host[len(diag):]))

    def process_scan(self, r, intensity, pose):
        return self.fetch(self.process_scan_async(r, pose))


def dynamic_config() -> VoFODConfig:
    """The dynamic-radii configuration (bounds 2.0 / 2.0 m)."""
    return VoFODConfig(dynamic_radii=True, ground_points_max_distance_bound=2.0,
                       sepclusters_max_bg_distance_bound=2.0)


_EXACT_NEVER = ("dda", "label_census", "quirk_counts", "cone_sweep_lat", "cone_sweep_z",
                "cone_sweep_zt", "propagate_sweeps")


def _grid_counts(other_halo: int, *calls: int, cones: tuple = ()) -> dict:
    """K2's batched launches and K15b-1's launches a grid scan, from the
    sweeps a shard's sweeps() calls run (SWEEP_BATCH a launch): per call
    one exchange of the occupancy and one halo fill a launch, beside the
    ``other_halo`` exchanges the path makes for its other stencils; and for
    each sharded cone sweep of ``cones`` ((kernel, planes), CONE_BATCH
    planes a launch) its launches and one halo fill between two."""
    launches = [-(-n // min(SWEEP_BATCH, n)) for n in calls]
    out = {"propagate_batch": GRID_SHARDS * sum(launches),
           "halo_exchange": other_halo + GRID_SHARDS * sum(1 + k for k in launches)}
    for name, planes in cones:
        k = -(-planes // min(CONE_BATCH, planes))
        out[name] = GRID_SHARDS * k
        out["halo_exchange"] += GRID_SHARDS * (k - 1)
    return out


# a grid scan's sweeps() calls: the seeded labels and the reach (cc_sweeps
# and sepclusters' 8), or the seeded labels and the exact census's labels
# (its cap of 128); K15b-3 over the flagship window's x / y planes, K15b-4b
# over its z planes; K15b-4a: each shard's kept cones, one launch a round
# that keeps one
_CC = VoFODConfig().cc_sweeps
_FLAGSHIP = GridSpec.from_config(VoFODConfig())
_WINDOW = sweep_window(_FLAGSHIP, np.asarray(_FLAGSHIP.origin, np.float32),
                       VoFODConfig().raycast_max_distance_bound)[2:4]
_LAT = ("cone_sweep_lat", max(_WINDOW))
_SWEEP_COUNTS = {**_grid_counts(30, _CC, 8, cones=(_LAT,)),
                 "cone_sweep_z": 2 * GRID_SHARDS - GRID_SHARDS % 2}
# the grid-sharded paths: (config, node options, make_grid_sharded_step
# options, the kernels each scan must launch, kernels it must never launch,
# kernels it must launch exactly so many times a scan)
GRID_PATHS = {
    "sweep": (VoFODConfig, {}, {}, GRID_KERNELS, ("cone_sweep_zt", "propagate_sweeps"),
              _SWEEP_COUNTS),
    "exact": (exact_config, dict(raycast_mode="exact"), dict(raycast_mode="exact"),
              GRID_EXACT_KERNELS, _EXACT_NEVER, _grid_counts(24, _CC, 128)),
    "transpose": (VoFODConfig, {}, dict(zcone_mode="transpose"), GRID_TRANSPOSE_KERNELS,
                  ("cone_sweep_z", "propagate_sweeps"),
                  _grid_counts(30, _CC, 8, cones=(_LAT, ("cone_sweep_zt", _FLAGSHIP.nz)))),
    "prebinned": (VoFODConfig, dict(frontend_mode="prebinned"), dict(frontend_mode="prebinned"),
                  GRID_KERNELS + ("unpack",), ("frontend_bin", "cone_sweep_zt", "propagate_sweeps"),
                  {"unpack": GRID_SHARDS, **_SWEEP_COUNTS}),
    "dynamic": (dynamic_config, {}, {}, GRID_KERNELS + ("shell_pool", "propagate_batch"),
                ("ball_pool", "cone_sweep_zt", "propagate_sweeps"), _SWEEP_COUNTS),
    "sequential": (sequential_config, dict(raycast_mode="exact"), dict(raycast_mode="exact"),
                   GRID_SEQ_KERNELS, _EXACT_NEVER + ("halo_fold_min", "explore_seq",
                                                     "explore_bfs", "demote"),
                   {**{k: GRID_SHARDS for k in ("explore_cut", "explore_seq_stack")},
                    **_grid_counts(18, _CC, 128)}),
}
GRID_PHASES = {"sweep": "4-grid", "exact": "4-grid-exact", "transpose": "4-grid-transpose",
               "prebinned": "4-grid-prebinned", "dynamic": "4-grid-dynamic",
               "sequential": "4-grid-sequential"}


def phase4_grid(lut, path: str = "sweep") -> tuple[dict, float]:
    """A grid-sharded path at the flagship size: 36 scans of the cycle
    through 3 shards of 17 planes on the card, each beside a dense node of
    the same path on the same scan.  Paths: "sweep" (phase 4-grid), "exact"
    (4-grid-exact: the reference-exact config and raycast), "transpose"
    (4-grid-transpose: the sweep with the transposed z cones), "prebinned"
    (4-grid-prebinned: the host-binned scan, each shard uploading its slab;
    host bin p50 and the slab uploads' ms), "dynamic" (4-grid-dynamic: the
    radii of DYN_SEGMENTS, changed every 12 scans on both; p50 per segment,
    no kernel rebuild) and "sequential" (4-grid-sequential: the exact path
    with the sequential explore; explore queries and demotion writes).  Per
    scan: the gathered grid and safe, the carried scalars and every
    diagnostic (label sweeps and sep_converged included) bit-equal to the
    dense node's, detection integers equal and floats within 1e-5 relative
    (JAX's bound for its sharded step; bit-equal expected), each kernel of
    the path launched (some exactly once a shard) and none of the dense
    forms it replaces, at most 1 host sync (the readback); step p50/p95 of
    both, launches and collective copies per scan.  Returns (launches
    summed over the scans, grid step p50)."""
    make_cfg, node_kw, step_kw, path_kernels, never, exactly = GRID_PATHS[path]
    cfg = make_cfg()
    node = VoFOD(cfg, DynParams(), NodeOptions(**node_kw), lut, device="cuda")
    node.load_apriori_map(apriori_ground())
    drv = GridDriver(lut, node.state, cfg, **step_kw)
    scans = scan_cycle(lut, N_SCANS)
    seg_len = N_SCANS // len(DYN_SEGMENTS)
    lib, sos = kernels.load(), sorted(kernels._BUILD_DIR.glob("*.so"))
    torch.cuda.synchronize()
    ms = {"dense": [], "grid": []}
    syncs, per_scan, copies, rel_err, n_dets = [], [], [], 0.0, 0
    sweeps, capped, queries, demoted = [], [], [], []
    kept = []  # per scan, for phase 4-grid-procs
    bit_equal_dets = True
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for k, (r, p) in enumerate(scans):
            if path == "dynamic" and k % seg_len == 0:
                g, sep = DYN_SEGMENTS[k // seg_len]
                node.update_params(ground_points_max_distance=g, sepclusters_max_bg_distance=sep)
                drv.dyn = node.dyn
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            pending = node.process_scan_async(r, None, p)
            end.record()
            dense_out = pending[0]
            msg = node.fetch_result(pending)
            ms["dense"].append(start.elapsed_time(end))
            n_dets += len(msg.detections)
            kernels.reset_launch_counts()
            drv.comm.reset_copies()
            before = len(caught)
            torch.cuda.set_sync_debug_mode("warn")
            try:
                start.record()
                out = drv.process_scan_async(r, p)
                end.record()
                diag, dets = drv.fetch(out)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            ms["grid"].append(start.elapsed_time(end))
            # (the sync-debug mode's own first-use notice says "Synchronization")
            synced = [f"{w.filename}:{w.lineno}" for w in caught[before:]
                      if "synchroniz" in str(w.message) and "prototype" not in str(w.message)]
            syncs.append(len(synced))
            assert len(synced) <= 1, f"{path} grid scan {k}: host syncs at {synced}"
            launches = kernels.launch_counts()
            _no_wide(launches, f"{path} grid scan {k}")
            per_scan.append(launches)
            copies.append(dict(drv.comm.copies_by, total=drv.comm.copies))
            missing = [g for g in path_kernels if launches[g] == 0]
            assert not missing, f"{path} grid scan {k}: kernels not launched: {missing}"
            foreign = {g: launches[g] for g in never if launches[g]}
            assert not foreign, f"{path} grid scan {k}: other paths' kernels launched: {foreign}"
            off = {g: launches[g] for g, want in exactly.items() if launches[g] != want}
            assert not off, f"{path} grid scan {k}: launches {off}, expected {exactly}"
            g = gather_state(drv.states)
            for f in ("grid", "safe", "det_counter", "sure_bg_sufficient", "bg_sufficient"):
                if not torch.equal(getattr(g, f), getattr(node.state, f)):
                    raise AssertionError(f"{path} grid scan {k}: state.{f} differs from dense")
            for f, v in diag.items():
                if not np.array_equal(v, getattr(node.last_diag, f)):
                    raise AssertionError(f"{path} grid scan {k}: diag.{f} differs from dense")
            sweeps.append(int(diag["sep_sweeps"]))
            capped.append(not bool(diag["sep_converged"]))
            queries.append(int(diag["n_queries"]))
            demoted.append(int(diag["n_demoted"]))
            for f, v in dets.items():
                want = getattr(dense_out.detections, f).cpu().numpy()
                if v.dtype.kind == "f":
                    bit_equal_dets &= bool(np.array_equal(v, want))
                    np.testing.assert_allclose(v, want, rtol=1e-5, atol=0.0,
                                               err_msg=f"{path} grid scan {k}: detections.{f}")
                    den = np.maximum(np.abs(want), 1e-30)
                    rel_err = max(rel_err, float(np.max(np.abs(v - want) / den, initial=0.0)))
                elif not np.array_equal(v, want):
                    raise AssertionError(f"{path} grid scan {k}: detections.{f} differs")
            if k < GRID_KEEP.get(path, 0):
                kept.append(dict(diag=diag, dets=dets, slabs=[_slab_digest(x) for x in drv.states],
                                 dense_dets={f: getattr(dense_out.detections, f).cpu().numpy()
                                             for f in dets}, launches=launches))
    assert max(syncs) <= 1, f"host syncs per {path} grid scan: {syncs}"
    assert bool(node.last_diag.bg_sufficient), "background never became sufficient"
    total = {g: sum(s[g] for s in per_scan) for g in per_scan[0]}
    kinds = sorted({c for s in copies for c in s})
    out = dict(
        path=path, scans=N_SCANS, shards=GRID_SHARDS,
        shard_shape=[cfg.grid_shape[0] // GRID_SHARDS, *cfg.grid_shape[1:]],
        bit_equal_state_and_diag=True, detection_floats_bit_equal=bit_equal_dets,
        detection_float_max_rel_err=rel_err, detections_total=n_dets,
        step_ms_p50={m: float(np.percentile(v, 50)) for m, v in ms.items()},
        step_ms_p95={m: float(np.percentile(v, 95)) for m, v in ms.items()},
        step_ms_all={m: [round(x, 3) for x in v] for m, v in ms.items()},
        host_syncs_per_scan=float(np.mean(syncs)), host_syncs_max=int(max(syncs)),
        path_launches_per_scan={g: total[g] / N_SCANS for g in path_kernels},
        path_launches_per_scan_min={g: min(s[g] for s in per_scan) for g in path_kernels},
        launches_per_scan={g: v / N_SCANS for g, v in total.items() if v},
        collective_copies_per_scan=float(np.mean([c["total"] for c in copies])),
        collective_copies_per_scan_by_kind={c: float(np.mean([s.get(c, 0) for s in copies]))
                                            for c in kinds if c != "total"},
    )
    if path in ("exact", "sequential"):
        out.update(label_sweeps_per_scan=sweeps, capped_scans=int(sum(capped)),
                   capped_scan_indices=[i for i, c in enumerate(capped) if c])
    if path == "sequential":
        out.update(explore_queries_per_scan=queries, demotion_writes_per_scan=demoted,
                   explore_queries_total=sum(queries), demotion_writes_total=sum(demoted))
    if path == "prebinned":
        packed = drv.staging.sets[0][0].view(drv.binner.shape)
        nzl = cfg.grid_shape[0] // GRID_SHARDS
        out.update(host_bin_ms_p50=float(np.percentile(drv.bin_ms, 50)),
                   host_bin_ms_p95=float(np.percentile(drv.bin_ms, 95)),
                   # the three slabs' copies from pinned memory, one stream
                   slab_upload_ms=cuda_ms(lambda: [
                       packed[i * nzl:(i + 1) * nzl].to("cuda", non_blocking=True)
                       for i in range(GRID_SHARDS)]))
    if path == "dynamic":
        rebuilt = kernels.load() is not lib or sorted(kernels._BUILD_DIR.glob("*.so")) != sos
        assert not rebuilt, "the kernel library was rebuilt when the radii changed"
        out.update(kernel_rebuilds=0, segments=[dict(
            ground_points_max_distance=g, sepclusters_max_bg_distance=sep,
            step_ms_p50={m: float(np.percentile(v[i * seg_len:(i + 1) * seg_len], 50))
                         for m, v in ms.items()})
            for i, (g, sep) in enumerate(DYN_SEGMENTS)])
    say(GRID_PHASES[path], **out)
    if path == "sweep":
        GRID_FINAL[path] = (drv.states, node.state, drv.comm)
    if kept:
        GRID_RECORDS[path] = dict(scans=kept, ms=ms["grid"])
    return total, out["step_ms_p50"]["grid"]


# ---------------------------------------------------------------------------
# phase 4-cli: the offline detector's runtime surface at the flagship size
# ---------------------------------------------------------------------------

CLI_SCANS = 12
CLI_EDIT_SCAN = 6  # the watched params file changes before this scan
CLI_EDIT = ("raycast: {weight_coefficient: 0.003}\n", "raycast: {weight_coefficient: 0.004}\n",
            dict(raycast_weight_coefficient=0.004))
CLI_KEEP, CLI_EVERY = 2, 4  # SnapshotManager: keep 2 snapshots, one every 4 scans
CLI_ASYNC_SCAN = 6
CLI_ROS_SCANS = 3
# the static base -> sensor edge: 180 degrees about z (as os_sensor -> os_lidar)
CLI_BASE_SENSOR = dict(txyz=(0.0, 0.0, 0.0), quat=(0.0, 0.0, 1.0, 0.0))
GRID_FINAL: dict = {}  # phase 4-grid's final states, by path: (shard states, dense state, comm)
# phase 4-grid-procs' references: the scans of each grid path it replays
# across processes, and per scan what phase 4-grid's run gave
GRID_KEEP = {"sweep": N_SCANS, "exact": 12}
GRID_RECORDS: dict = {}


def _slab_digest(s: VoFODState) -> str:
    """A digest of a state's (or slab's) tensors and step."""
    h = hashlib.sha1(str(s.step).encode())
    for f in STATE_FIELDS:
        if f != "step":
            h.update(getattr(s, f).cpu().numpy().tobytes())
    return h.hexdigest()


def _quat(R: np.ndarray) -> tuple:
    """A unit quaternion (x, y, z, w) of a rotation matrix (Shepperd)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0.0:
        s = 2.0 * np.sqrt(1.0 + t)
        q = ((R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s, 0.25 * s)
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k])
        v = [0.0, 0.0, 0.0]
        v[i], v[j], v[k] = 0.25 * s, (R[j, i] + R[i, j]) / s, (R[k, i] + R[i, k]) / s
        q = (*v, (R[k, j] - R[j, k]) / s)
    q = np.asarray(q)
    return tuple(float(x) for x in q / np.linalg.norm(q))


def _cloud_record(lut, r: np.ndarray, k: int) -> np.ndarray:
    """An Ouster-like organized cloud: x, y, z (sensor frame), intensity, range."""
    rec = np.zeros(r.size, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                  ("intensity", "<f4"), ("range", "<u4")])
    pts = lut.directions * (r.astype(np.float32) * np.float32(1e-3))[:, None] + lut.offsets
    rec["x"], rec["y"], rec["z"] = pts.T
    rec["intensity"] = 100.0 + (np.arange(r.size) % 7) + 0.5 * k
    rec["range"] = r
    return rec


_CLOUD_FIELDS = [("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1), ("intensity", 12, 7, 1),
                 ("range", 16, 6, 1)]


def _write_cli_bag(path, lut, scans, first_stamp: float, compression="none", shift=None):
    """A bag of the scans' organized clouds (staggered by ``shift`` when
    given: destagger(stagger(x)) == x) and the TF chain world -> base ->
    sensor, base -> sensor static."""
    from vofod_tpu_torch.io import rosbag_lite
    from vofod_tpu_torch.runtime.ros_adapter import transform_to_pose

    H, W = lut.height, lut.width
    T_bs = transform_to_pose(*CLI_BASE_SENSOR["txyz"], *CLI_BASE_SENSOR["quat"])
    with rosbag_lite.BagWriter(str(path), compression=compression) as w:
        w.write_tf("/tf_static", 0.0, [dict(stamp=0.0, parent="base", child="os_sensor",
                                            **CLI_BASE_SENSOR)])
        for k, (r, pose) in enumerate(scans):
            t = first_stamp + 0.1 * k
            T_wb = pose.astype(np.float64) @ np.linalg.inv(T_bs.astype(np.float64))
            w.write_tf("/tf", t, [dict(stamp=t, parent="world", child="base",
                                       txyz=tuple(float(v) for v in T_wb[:3, 3]),
                                       quat=_quat(T_wb[:3, :3]))])
            rec = _cloud_record(lut, r, k).reshape(H, W)
            if shift is not None:
                cols = (np.arange(W)[None, :] - np.asarray(shift)[:, None]) % W
                rec = np.take_along_axis(rec, cols, axis=1)
            w.write_pointcloud2("/os_cloud_node/points", t, frame_id="os_sensor", height=H,
                                width=W, fields=_CLOUD_FIELDS, point_step=rec.dtype.itemsize,
                                data=rec.tobytes())


def _check_converted(npz, scans, what: str) -> dict:
    from vofod_tpu_torch.io.scan_source import load_scans_npz

    ranges, poses, _, inten = load_scans_npz(str(npz))
    want_r = np.stack([r for r, _ in scans])
    if not (ranges.dtype == np.uint32 and np.array_equal(ranges, want_r)):
        raise AssertionError(f"{what}: converted ranges differ from the rendered ones")
    err = float(np.max(np.abs(poses.astype(np.float64)
                              - np.stack([p for _, p in scans]).astype(np.float64))))
    if err > 1e-6:
        raise AssertionError(f"{what}: converted poses {err} from the rendered ones (> 1e-6)")
    if inten is None:
        raise AssertionError(f"{what}: the intensity channel was not converted")
    return dict(ranges_bit_equal=True, pose_max_abs_err=err)


def _state_np(state) -> dict:
    from vofod_tpu_torch.pipeline.state import state_to_numpy

    return {k: np.array(v, copy=True) for k, v in state_to_numpy(state).items()}


def _same_np(a: dict, b: dict, what: str) -> None:
    for k, v in a.items():
        if not (v.dtype == b[k].dtype and np.array_equal(v, b[k])):
            raise AssertionError(f"{what}: state.{k} differs")


def _cli_node(lut, cloud_path):
    """A node as tools/detect builds it with no config files."""
    from vofod_tpu_torch.io.pc_loader import load_cloud

    cfg = VoFODConfig()
    node = VoFOD(cfg, DynParams(), NodeOptions(throttle_period=cfg.throttle_period), lut,
                 device="cuda")
    node.load_apriori_map(load_cloud(str(cloud_path)))
    return node


class _Rec:
    """A recording stand-in for rospy's publishers, services and timers."""

    def __init__(self):
        self.subs, self.pubs, self.srvs, self.timers, self.warnings = {}, {}, {}, [], []


def _ros_stub(rec: _Rec, tf_lookup) -> dict:
    """Minimal in-process rospy, std_msgs, std_srvs, sensor_msgs,
    visualization_msgs and tf2_ros modules for RosNode."""
    import types
    from types import SimpleNamespace as NS

    class Pub:
        def __init__(self, topic, typ, queue_size=1):
            self.topic, self.published = topic, []
            rec.pubs[topic] = self

        def publish(self, msg):
            self.published.append(msg)

        def get_num_connections(self):
            return 1

    class Time:
        def __init__(self, t=0.0):
            self._t = t

        def to_sec(self):
            return self._t

        @staticmethod
        def now():
            return Time(0.0)

    class String:
        def __init__(self, data=""):
            self.data = data

    class Header:
        def __init__(self):
            self.stamp, self.frame_id = Time(), ""

    class TriggerResponse:
        def __init__(self, success=False, message=""):
            self.success, self.message = success, message

    class Marker:
        SPHERE, ADD = 2, 0

        def __init__(self):
            self.header = Header()
            self.pose = NS(position=NS(x=0, y=0, z=0), orientation=NS(x=0, y=0, z=0, w=0))
            self.scale, self.color = NS(x=0, y=0, z=0), NS(r=0, g=0, b=0, a=0)

    class MarkerArray:
        def __init__(self):
            self.markers = []

    class Buffer:
        def lookup_transform(self, target, source, stamp):
            return tf_lookup(target, source, stamp.to_sec())

    def read_points(msg, field_names):
        cols = [msg.columns[n] for n in field_names]
        return list(zip(*cols))

    m = {name: types.ModuleType(name) for name in (
        "rospy", "std_msgs", "std_msgs.msg", "std_srvs", "std_srvs.srv", "sensor_msgs",
        "sensor_msgs.msg", "sensor_msgs.point_cloud2", "visualization_msgs",
        "visualization_msgs.msg", "tf2_ros")}
    r = m["rospy"]
    r.Subscriber = lambda topic, typ, cb, queue_size=1: rec.subs.__setitem__(topic, cb)
    r.Service = lambda name, typ, cb: rec.srvs.__setitem__(name, cb)
    r.Publisher, r.Duration, r.Time = Pub, (lambda s: s), Time
    r.Timer = lambda dur, cb: rec.timers.append((dur, cb))
    r.get_time = lambda: 0.0
    r.logwarn_throttle = lambda period, msg: rec.warnings.append(msg)
    m["std_msgs.msg"].String, m["std_msgs.msg"].Header = String, Header
    m["std_srvs.srv"].Trigger, m["std_srvs.srv"].TriggerResponse = object, TriggerResponse
    m["sensor_msgs.msg"].PointCloud2 = m["sensor_msgs.msg"].Range = object
    m["sensor_msgs.msg"].Image = object
    m["sensor_msgs.point_cloud2"].read_points = read_points
    m["sensor_msgs.point_cloud2"].create_cloud_xyz32 = lambda h, pts: NS(header=h, n=len(pts))
    m["visualization_msgs.msg"].Marker = Marker
    m["visualization_msgs.msg"].MarkerArray = MarkerArray
    m["tf2_ros"].Buffer, m["tf2_ros"].TransformListener = Buffer, (lambda buf: None)
    m["_Time"] = Time
    return m


def _cli_ros(lut, scans, poses, stamps, snapshot) -> dict:
    """(e) RosNode under the stub over CLI_ROS_SCANS scans against a node
    stepped directly; both start from ``snapshot``."""
    from types import SimpleNamespace as NS

    from vofod_tpu_torch.runtime.ros_adapter import RosNode, detections_to_json

    by_stamp = {float(t): p for t, p in zip(stamps, poses)}

    def tf_lookup(target, source, t):
        p = by_stamp[t]
        q = _quat(p[:3, :3])
        return NS(transform=NS(translation=NS(x=float(p[0, 3]), y=float(p[1, 3]),
                                              z=float(p[2, 3])),
                               rotation=NS(x=q[0], y=q[1], z=q[2], w=q[3])))

    rec = _Rec()
    mods = _ros_stub(rec, tf_lookup)
    Time = mods.pop("_Time")
    saved = {name: sys.modules.get(name) for name in mods}
    sys.modules.update(mods)
    try:
        from vofod_tpu_torch.runtime.ros_adapter import transform_to_pose

        wrapped, direct = (VoFOD(VoFODConfig(), DynParams(), NodeOptions(), lut, device="cuda")
                           for _ in range(2))
        wrapped.load_snapshot(str(snapshot))
        direct.load_snapshot(str(snapshot))
        ros = RosNode(wrapped)
        cb = rec.subs["~pointcloud"]
        want = []
        for (r, _), t in zip(scans, stamps):
            msg = NS(height=lut.height, width=lut.width, fields=[NS(name="range")],
                     header=NS(stamp=Time(float(t)), frame_id="os_sensor"),
                     columns={"range": r.tolist()})
            cb(msg)
            tf = tf_lookup("world", "os_sensor", float(t)).transform
            pose = transform_to_pose(tf.translation.x, tf.translation.y, tf.translation.z,
                                     tf.rotation.x, tf.rotation.y, tf.rotation.z,
                                     tf.rotation.w)
            want.append(detections_to_json(direct.process_scan(r, None, pose, float(t))))
        got = [m.data for m in rec.pubs["~detections_json"].published]
        if got != want or ros.tf_failures:
            raise AssertionError(f"RosNode: published {len(got)} lines, equal "
                                 f"{got == want}, tf failures {ros.tf_failures}")
        rec.timers[0][1](None)  # the status timer
        status = json.loads(rec.pubs["~status_json"].published[-1].data)
        _same_np(_state_np(wrapped.state), _state_np(direct.state), "RosNode")
        return dict(scans=len(got), json_equal_to_direct_node=True,
                    detections=[len(json.loads(g)["detections"]) for g in got],
                    status=status, markers_published=len(rec.pubs["~detections_mks"].published))
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod


def phase4_cli(lut, sweep_launches: dict) -> None:
    """Phase 4-cli: the offline detector and its runtime surface on the
    card (see the module docstring); fails on any check."""
    import contextlib as _cl
    import io
    import os
    import shutil

    from vofod_tpu_torch.io.pc_loader import save_cloud
    from vofod_tpu_torch.io.scan_source import load_scans_npz, save_scans_npz
    from vofod_tpu_torch.pipeline.state import init_state
    from vofod_tpu_torch.parallel.grid_step import init_grid_sharded_state
    from vofod_tpu_torch.runtime import checkpoint
    from vofod_tpu_torch.runtime.mask_creator import MaskCreator
    from vofod_tpu_torch.runtime.node import VoFOD as NodeClass
    from vofod_tpu_torch.tools import bag_to_npz, create_mask, detect

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke" / "cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out: dict = {}
    scans = scan_cycle(lut, CLI_SCANS)
    cloud = work / "ground.pts"
    save_cloud(str(cloud), apriori_ground())

    # (a) the uncompressed bag through the detect CLI
    bag = work / "flight.bag"
    t0 = time.perf_counter()
    _write_cli_bag(bag, lut, scans, 100.0)
    write_s = time.perf_counter() - t0
    npz = work / "flight.npz"
    t0 = time.perf_counter()
    n = bag_to_npz.convert_bag(str(bag), str(npz), "/os_cloud_node/points")
    conv_s = time.perf_counter() - t0
    assert n == CLI_SCANS, f"convert_bag: {n} scans"
    out["bag"] = dict(bytes=bag.stat().st_size, write_s=write_s, convert_s=conv_s,
                      **_check_converted(npz, scans, "uncompressed bag"))
    params = work / "params.yaml"
    params.write_text(CLI_EDIT[0])
    os.utime(params, (1.0e9, 1.0e9))
    real_replay = NodeClass.replay

    def replay(self, path, intensity=None, before_scan=None):
        def edit_then_poll(k):
            if k == CLI_EDIT_SCAN:
                params.write_text(CLI_EDIT[1])
                os.utime(params, (1.0e9 + 1.0, 1.0e9 + 1.0))
            before_scan(k)
        return real_replay(self, path, intensity, edit_then_poll)

    ckpt, markers = work / "state", work / "markers.npz"
    stdout = io.StringIO()
    NodeClass.replay = replay
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        with _cl.redirect_stdout(stdout):
            rc = detect.main(["--scans", str(bag), "--apriori-cloud", str(cloud), "--json",
                              "--save-state", str(ckpt), "--markers", str(markers),
                              "--watch-params", str(params)])
        cli_s = time.perf_counter() - t0
    finally:
        NodeClass.replay = real_replay
    launches = kernels.launch_counts()
    assert rc == 0, f"tools.detect returned {rc}"
    per_scan = {k: sweep_launches[k] // N_SCANS for k in SWEEP_KERNELS}
    assert all(sweep_launches[k] == per_scan[k] * N_SCANS for k in SWEEP_KERNELS), (
        "phase 4's launches are not a whole number a scan")
    off = {k: (launches[k], CLI_SCANS * per_scan[k]) for k in SWEEP_KERNELS
           if launches[k] != CLI_SCANS * per_scan[k]}
    assert not off, f"tools.detect: launches (got, 12 x phase 4's a scan): {off}"
    foreign = {k: v for k, v in launches.items() if v and k not in SWEEP_KERNELS}
    assert not foreign, f"tools.detect launched other paths' kernels: {foreign}"
    lines = stdout.getvalue().splitlines()
    direct = _cli_node(lut, cloud)
    rr, pp, ss, ii = load_scans_npz(str(npz))
    want, step_ms = [], []
    mgr_dir = work / "snapshots"
    with checkpoint.SnapshotManager(str(mgr_dir), max_to_keep=CLI_KEEP) as mgr:
        for k in range(CLI_SCANS):
            if k == CLI_EDIT_SCAN:
                direct.update_params(**CLI_EDIT[2])
            t0 = time.perf_counter()
            msg = direct.process_scan(rr[k], ii[k], pp[k], float(ss[k]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            want.append(detect.json_line(msg))
            if (k + 1) % CLI_EVERY == 0:
                mgr.save(direct.state.step, direct.state)
        if lines != want:
            bad = [k for k, (a, b) in enumerate(zip(lines, want)) if a != b]
            raise AssertionError(f"tools.detect JSON differs from the direct node: {len(lines)} "
                                 f"lines, scans {bad[:5]}")
        cli_state = checkpoint.restore_state(str(ckpt), init_state(direct.cfg, device="cuda"))
        _same_np(_state_np(cli_state), _state_np(direct.state), "tools.detect --save-state")
        with np.load(markers) as z:
            n_markers = {k: int(z[k].shape[0]) for k in z.files if k.endswith("_points")}
        out["detect_cli"] = dict(
            seconds=cli_s, scans=len(lines), json_bit_equal_to_direct_node=True,
            detections=int(sum(len(json.loads(x)["detections"]) for x in lines)),
            params_edit_scan=CLI_EDIT_SCAN, params_edit_equals_update_params=True,
            launches_equal_12x_phase4=True, launches=launches, marker_points=n_markers)

        # (c) checkpoints: keep-last-K and resume
        steps = mgr.all_steps()
        assert steps == [8, 12], f"SnapshotManager kept {steps}"
        resumed = _cli_node(lut, cloud)
        t0 = time.perf_counter()
        resumed.state = mgr.restore(resumed.state)
        restore_ms = (time.perf_counter() - t0) * 1e3
    resumed.update_params(**CLI_EDIT[2])
    for k in range(CLI_EVERY):
        a = direct.process_scan(rr[k], ii[k], pp[k], float(ss[k]) + 10.0)
        b = resumed.process_scan(rr[k], ii[k], pp[k], float(ss[k]) + 10.0)
        if detect.json_line(a) != detect.json_line(b):
            raise AssertionError(f"resumed node's scan {k} differs")
    _same_np(_state_np(resumed.state), _state_np(direct.state), "SnapshotManager resume")
    t0 = time.perf_counter()
    checkpoint.save_state(str(work / "sync"), direct.state)
    save_ms = (time.perf_counter() - t0) * 1e3

    # the async save at scan 6 while the later scans step
    node = _cli_node(lut, cloud)
    saved_at, enqueue_ms, inflight_ms = None, [], []
    with checkpoint.AsyncSaver() as saver:
        for k in range(CLI_SCANS):
            if k >= 1:
                path = work / ("async_at6" if k == CLI_ASYNC_SCAN else f"async_{k % 2}")
                if k == CLI_ASYNC_SCAN:
                    saved_at = _state_np(node.state)
                t0 = time.perf_counter()
                saver.save(str(path), node.state)
                enqueue_ms.append((time.perf_counter() - t0) * 1e3)
                if k == CLI_ASYNC_SCAN:  # an in-place write right after the save
                    rf = np.eye(4, dtype=np.float32)
                    rf[:3, 3] = (40.0, 20.0, 3.0)
                    assert node.process_rangefinder(5.0, 0.1, 30.0, rf)
            t0 = time.perf_counter()
            node.process_scan(rr[k], ii[k], pp[k], float(ss[k]))
            if k >= 1:
                inflight_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        saver.wait()
        drain_ms = (time.perf_counter() - t0) * 1e3
    got = checkpoint.restore_state(str(work / "async_at6"), init_state(node.cfg, device="cuda"))
    _same_np(_state_np(got), saved_at, "AsyncSaver at scan 6")
    assert got.step == CLI_ASYNC_SCAN and node.state.step == CLI_SCANS
    assert not np.array_equal(_state_np(node.state)["grid"], saved_at["grid"])

    # phase 4-grid's 3-shard states: per shard onto the dense state and back
    states, dense_state, comm = GRID_FINAL["sweep"]
    t0 = time.perf_counter()
    checkpoint.save_state(str(work / "grid"), states, layout="zshards")
    shard_save_ms = (time.perf_counter() - t0) * 1e3
    m = checkpoint.read_manifest(str(work / "grid"))
    onto_dense = checkpoint.restore_state(str(work / "grid"), init_state(VoFODConfig(),
                                                                            device="cuda"))
    _same_np(_state_np(onto_dense), _state_np(dense_state), "3-shard checkpoint onto dense")
    checkpoint.save_state(str(work / "grid_dense"), onto_dense)
    back = checkpoint.restore_state(str(work / "grid_dense"),
                                    init_grid_sharded_state(VoFODConfig(), DynParams(), comm))
    for i, (a, b) in enumerate(zip(back, states)):
        _same_np(_state_np(a), _state_np(b), f"dense checkpoint onto shard {i}")
        assert a.grid.device == b.grid.device
    out["checkpoints"] = dict(
        snapshot_manager=dict(kept=steps, resumed_4_scans_bit_equal=True, restore_ms=restore_ms),
        async_save=dict(at_scan=CLI_ASYNC_SCAN, restored_equals_scan_6=True,
                        enqueue_ms_p50=float(np.percentile(enqueue_ms, 50)),
                        drain_ms=drain_ms),
        save_ms_dense=save_ms, save_ms_3_shards=shard_save_ms,
        shard_files=[(e["name"], e["z0"], e["z1"]) for e in m["files"]],
        grid_3_shards_onto_dense_and_back_bit_equal=True,
        step_ms_p50_without_save=float(np.percentile(step_ms[1:], 50)),
        step_ms_p50_with_save_in_flight=float(np.percentile(inflight_ms, 50)),
        host_clock="process_scan wall ms, the readback included")

    # (b) compressed and staggered bags, one scan each
    H, W = lut.height, lut.width
    shift = np.asarray([(12, 4, -4, -12)[u % 4] % W for u in range(H)], np.int64)
    meta = work / "metadata.json"
    meta.write_text(json.dumps({
        "beam_intrinsics": {"beam_altitude_angles": list(np.linspace(45.0, -45.0, H)),
                            "beam_azimuth_angles": [0.0] * H,
                            "lidar_origin_to_beam_origin_mm": 0.0},
        "lidar_data_format": {"pixels_per_column": H, "columns_per_frame": W,
                              "pixel_shift_by_row": [int(v) for v in shift]}}))
    out["compressed_bags"] = {}
    for comp in ("bz2", "lz4"):
        one = scans[5:6]
        path = work / f"one_{comp}.bag"
        t0 = time.perf_counter()
        _write_cli_bag(path, lut, one, 50.0, compression=comp, shift=shift)
        w_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bag_to_npz.convert_bag(str(path), str(work / f"one_{comp}.npz"), "/os_cloud_node/points",
                               do_destagger=True, metadata_json=str(meta))
        c_s = time.perf_counter() - t0
        out["compressed_bags"][comp] = dict(
            bytes=path.stat().st_size, write_s=w_s, convert_s=c_s, staggered=True,
            **_check_converted(work / f"one_{comp}.npz", one, f"{comp} bag"))

    # (d) the mask creator on the card and its CLI
    rng = np.random.default_rng(24)
    zeroed = []
    for r, _ in scans:
        r = r.copy()
        r[rng.random(r.size) < 0.01] = 0
        zeroed.append(r)
    mc = MaskCreator(H, W)
    for r in zeroed:
        mc.add_scan(r)
    want_mask = np.logical_and.reduce(np.stack(zeroed) > 0, axis=0).reshape(H, W).astype(np.uint8)
    assert np.array_equal(mc.mask(), want_mask), "MaskCreator differs from numpy's reduce"
    mask_npz = work / "masked.npz"
    save_scans_npz(str(mask_npz), np.stack(zeroed), np.stack([p for _, p in scans]))
    with _cl.redirect_stderr(io.StringIO()):
        assert create_mask.main(["--scans", str(mask_npz), "--out", str(work / "mask.npy"),
                                 "--rays", f"{H}x{W}"]) == 0
    assert np.array_equal(np.load(work / "mask.npy"), want_mask), "create_mask's .npy differs"
    out["mask"] = dict(scans=len(zeroed), occluded_px=int((want_mask == 0).sum()),
                       equal_to_numpy=True, cli_equal=True)

    # (e) the ROS adapter under a stub
    out["ros_node"] = _cli_ros(lut, scans[:CLI_ROS_SCANS], pp[:CLI_ROS_SCANS],
                               ss[:CLI_ROS_SCANS] + 20.0, ckpt)
    shutil.rmtree(work, ignore_errors=True)
    say("4-cli", nvidia_smi=_smi(), seconds=time.perf_counter() - t_phase,
        checks=["a: bag -> tools.detect", "b: bz2 and lz4 staggered bags",
                "c: SnapshotManager, AsyncSaver, 3-shard checkpoint", "d: MaskCreator + CLI",
                "e: RosNode"], **out)


# ---------------------------------------------------------------------------
# phase 4-fleet-grid: the 2-D streams x grid fleet at the flagship size
# ---------------------------------------------------------------------------

FG_B = 2
FG_TICKS = 8
FG_NAN = (4, 1)  # (tick, stream) of the NaN rotation
FG_RESET = (6, 0)  # (tick, stream) reset and re-stamped before that tick
FG_SAVE = 4  # the checkpoint holds the state after ticks 0-3
FG_TIMING_B = (1, 2)
FG_TIMED_TICKS = 10
FG_DET_RTOL = 1e-5  # detection floats against the dense nodes (JAX's bound for its sharded step)
# the kernels of the ray stage, which a null scan's step does not launch
RAY_STAGE = ("gate_faces", "ray_update", "cone_sweep_lat", "cone_sweep_z")


def _fg_fleet(n_streams: int, plane, grid_shards: int = GRID_SHARDS):
    fleet = FleetVoFOD(VoFODConfig(), DynParams(), n_streams, device="cuda",
                       grid_shards=grid_shards)
    fleet.load_apriori_map(plane)
    return fleet


def _fg_events(fleet, plane, k: int, r, p) -> None:
    """The phase's script at tick k, on a fleet: reset and re-stamp stream
    FG_RESET[1] before tick FG_RESET[0]; a NaN rotation on stream FG_NAN[1]
    at tick FG_NAN[0] (in ``p``, in place)."""
    if k == FG_RESET[0]:
        fleet.reset_stream(FG_RESET[1])
        fleet.load_apriori_map(plane, stream=FG_RESET[1])
    if k == FG_NAN[0]:
        p[FG_NAN[1], :3, :3] = np.nan  # finite translation, NaN rotation


def _close_record(a: tuple, b: tuple, what: str) -> bool:
    """Two (detections, diagnostics) records: diagnostics and detection
    integers equal, detection floats within FG_DET_RTOL relative; returns
    whether the floats are bit-equal too."""
    for f, v in a[1].items():
        if not np.array_equal(v, b[1][f]):
            raise AssertionError(f"{what}: diag.{f} differs")
    if len(a[0]) != len(b[0]):
        raise AssertionError(f"{what}: {len(a[0])} detections, {len(b[0])} expected")
    bit = True
    for x, y in zip(a[0], b[0]):
        if (x.id, x.n_points) != (y.id, y.n_points):
            raise AssertionError(f"{what}: detection ids / n_points differ")
        fx, fy = (np.array([d.confidence, d.detection_probability, *d.position, *d.covariance],
                           np.float64) for d in (x, y))
        np.testing.assert_allclose(fx, fy, rtol=FG_DET_RTOL, atol=0.0, err_msg=what)
        bit &= bool(np.array_equal(fx, fy))
    return bit


def _fg_states_equal(a: list, b: list, what: str) -> None:
    """Two fleets' states (2-D slab lists or 1-shard states) bit-equal."""
    for s, (x, y) in enumerate(zip(a, b)):
        _same_stream_state(x if isinstance(x, VoFODState) else gather_state(x),
                           y if isinstance(y, VoFODState) else gather_state(y),
                           f"{what}, stream {s}")


def _fg_parity(lut, cycle, plane, grid_launches: dict, ckpt: Path) -> dict:
    """(a)-(d) and the checkpoint's save: FG_B streams of 3 shards for
    FG_TICKS ticks beside FG_B dense nodes fed the same scans (the null scan
    a node step on zero ranges and the sentinel pose, the reset a fresh node
    with the plane); each tick one host sync and, but on the null-scan
    tick, FG_B x phase 4-grid's launches a scan of every kernel (the null
    tick: the ray stage's once); the state after tick FG_SAVE - 1 saved in
    the ``streams_zshards`` layout."""
    fleet = _fg_fleet(FG_B, plane)
    nodes = [_fresh_node(lut, plane) for _ in range(FG_B)]
    sentinel = np.eye(4, dtype=np.float32)
    sentinel[:3, 3] = np.asarray(VoFODConfig().oparea.lo, np.float32) - 1.0e6
    per_scan = {k: v / N_SCANS for k, v in grid_launches.items()}
    records, syncs, launches, bit_equal, save_ms = [], [], [], True, None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for k in range(FG_TICKS):
            if k == FG_SAVE:
                t0 = time.perf_counter()
                save_state(str(ckpt), fleet.state, layout="streams_zshards")
                save_ms = (time.perf_counter() - t0) * 1e3
            r, p = _fleet_tick(cycle, FG_B, k)
            _fg_events(fleet, plane, k, r, p)
            if k == FG_RESET[0]:
                nodes[FG_RESET[1]] = _fresh_node(lut, plane)
                _same_stream_state(gather_state(fleet.state[FG_RESET[1]]),
                                   nodes[FG_RESET[1]].state, "(c) just after the reset")
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            before = len(caught)
            torch.cuda.set_sync_debug_mode("warn")
            try:
                msgs = fleet.process_scans(r, p)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            syncs.append(sum(1 for w in caught[before:] if "synchroniz" in str(w.message)
                             and "prototype" not in str(w.message)))
            fl = kernels.launch_counts()
            launches.append({g: v for g, v in fl.items() if v})
            null = k == FG_NAN[0]
            want = {g: (FG_B - (null and g in RAY_STAGE)) * v for g, v in per_scan.items()}
            off = {g: (fl[g], w) for g, w in want.items() if fl[g] != w}
            if off:
                raise AssertionError(f"(d) tick {k}: launches (got, {FG_B} x phase 4-grid's "
                                     f"a scan) {off}")
            tick = []
            for b, node in enumerate(nodes):
                rb, pb = (np.zeros_like(r[b]), sentinel) if not np.isfinite(p[b]).all() \
                    else (r[b], p[b])
                ref = _node_record(node, node.process_scan(rb, None, pb))
                rec = _stream_record(fleet, msgs, b)
                bit_equal &= _close_record(rec, ref, f"(a) tick {k}, stream {b}")
                tick.append(rec)
            records.append(tick)
    if syncs != [1] * FG_TICKS:
        raise AssertionError(f"(d) host syncs per tick {syncs}, expected exactly 1")
    _fg_states_equal(fleet.state, [n.state for n in nodes], "(a) final state")
    rejected = [int(x) for x in fleet.n_pose_rejected]
    if rejected != [int(b == FG_NAN[1]) for b in range(FG_B)]:
        raise AssertionError(f"(b) n_pose_rejected {rejected}")
    for b, s in enumerate(fleet.state):
        if any(torch.isnan(sh.grid).any() for sh in s):
            raise AssertionError(f"(b) stream {b}: grid holds NaN")
    steps = [s[0].step for s in fleet.state]
    if steps != [FG_TICKS - FG_RESET[0] if b == FG_RESET[1] else FG_TICKS for b in range(FG_B)]:
        raise AssertionError(f"(c) step counters {steps}")
    return dict(fleet=fleet, records=records, syncs=syncs, bit_equal_dets=bit_equal,
                launches_per_tick=launches[0], null_tick_launches=launches[FG_NAN[0]],
                n_pose_rejected=rejected, steps_final=steps, save_ms=save_ms,
                detections_per_stream=[sum(len(t[b][0]) for t in records) for b in range(FG_B)])


def _fg_resumed(lut, cycle, plane, ckpt: Path, clean: dict) -> dict:
    """The checkpoint restored onto a fresh 2-D fleet and onto a 1-shard
    fleet, each stepped through ticks FG_SAVE..FG_TICKS - 1 of the script:
    every tick's records and the final states equal the uninterrupted
    run's."""
    out = {}
    for name, shards in (("2-D", GRID_SHARDS), ("1-shard", 1)):
        fleet = _fg_fleet(FG_B, plane, shards)
        t0 = time.perf_counter()
        fleet.state = restore_state(str(ckpt), fleet.state)
        ms = (time.perf_counter() - t0) * 1e3
        for k in range(FG_SAVE, FG_TICKS):
            r, p = _fleet_tick(cycle, FG_B, k)
            _fg_events(fleet, plane, k, r, p)
            msgs = fleet.process_scans(r, p)
            for b in range(FG_B):
                _close_record(_stream_record(fleet, msgs, b), clean["records"][k][b],
                              f"(e) {name} resumed, tick {k}, stream {b}")
        _fg_states_equal(fleet.state, clean["fleet"].state, f"(e) {name} resumed")
        out[name] = dict(restore_ms=ms, ticks=FG_TICKS - FG_SAVE)
    return out


def _fg_prebinned(lut, cycle, plane) -> dict:
    """(f) One prebinned tick of FG_B streams through make_fleet_grid_step
    (each shard uploading its slab of each stream's host-binned grid) beside
    dense prebinned nodes: state, diagnostics and detections equal."""
    cfg = VoFODConfig()
    comm = LocalComm(GRID_SHARDS, ["cuda"])
    step = make_fleet_grid_step(cfg, lut, comm, frontend_mode="prebinned")
    nodes = []
    for _ in range(FG_B):
        node = VoFOD(cfg, DynParams(), NodeOptions(frontend_mode="prebinned"), lut, device="cuda")
        node.load_apriori_map(plane)
        nodes.append(node)
    states = [shard_state(n.state, comm) for n in nodes]
    hb = HostBinner(cfg, lut)
    r, p = _fleet_tick(cycle, FG_B, 0)
    bins = [hb.bin(r[b], p[b], min_intensity=float(DynParams().raycast_min_intensity))
            .to_device("cpu") for b in range(FG_B)]
    events = []
    states, outs = step(states, bins, DynParams(), upload_events=events)
    if len(events) != FG_B * GRID_SHARDS:
        raise AssertionError(f"(f) {len(events)} upload events, expected {FG_B * GRID_SHARDS}")
    fetched = [GridDriver.fetch(o) for o in outs]
    for b, node in enumerate(nodes):
        pending = node.process_scan_async(r[b], None, p[b])
        dense_out = pending[0]
        node.fetch_result(pending)
        _same_stream_state(gather_state(states[b]), node.state, f"(f) prebinned stream {b}")
        diag, dets = fetched[b]
        for f, v in diag.items():
            if not np.array_equal(v, getattr(node.last_diag, f)):
                raise AssertionError(f"(f) prebinned stream {b}: diag.{f} differs")
        for f, v in dets.items():
            want = getattr(dense_out.detections, f).cpu().numpy()
            if v.dtype.kind == "f":
                np.testing.assert_allclose(v, want, rtol=FG_DET_RTOL, atol=0.0,
                                           err_msg=f"(f) prebinned stream {b}: detections.{f}")
            elif not np.array_equal(v, want):
                raise AssertionError(f"(f) prebinned stream {b}: detections.{f} differs")
    return dict(streams=FG_B, upload_events=len(events), equal_to_dense_prebinned=True)


def _fg_timing(cycle, plane) -> dict:
    """(g) For B of FG_TIMING_B: tick wall ms p50 / p95 (host clock from the
    stacked upload to the host messages) over FG_TIMED_TICKS ticks after
    FLEET_WARM_TICKS, and B = 2's device busy ms and idle share a tick."""
    out, profiled = {}, None
    for n_streams in FG_TIMING_B:
        fleet = _fg_fleet(n_streams, plane)
        ms = []
        for k in range(FLEET_WARM_TICKS + FG_TIMED_TICKS):
            r, p = _fleet_tick(cycle, n_streams, k)
            t0 = time.perf_counter()
            fleet.process_scans(r, p)
            if k >= FLEET_WARM_TICKS:
                ms.append((time.perf_counter() - t0) * 1e3)
        out[n_streams] = dict(tick_ms_p50=float(np.percentile(ms, 50)),
                              tick_ms_p95=float(np.percentile(ms, 95)),
                              tick_ms_per_stream_p50=float(np.percentile(ms, 50)) / n_streams,
                              tick_ms_all=[round(x, 3) for x in ms])
        if n_streams == FG_B:
            profiled = _fleet_profile(fleet, cycle, out[n_streams]["tick_ms_p50"])
        del fleet
    return dict(by_streams=out, profile_b2=profiled)


def _fg_cli() -> dict:
    """(h) tools/serve_fleet --grid-shards 3 --streams 2 --sim --ticks 5
    --json on the card, in-process."""
    import io

    from vofod_tpu_torch.tools import serve_fleet

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = serve_fleet.main(["--grid-shards", str(GRID_SHARDS), "--streams", str(FG_B),
                               "--sim", "--ticks", "5", "--json", "--device", "cuda"])
    lines = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
    summary = [ln for ln in lines if ln.get("summary")]
    ticks = [ln for ln in lines if "latency_ms" in ln]
    if (rc != 0 or len(summary) != 1 or summary[0]["ticks"] != 5
            or summary[0]["streams"] != FG_B or len(ticks) != 5):
        raise AssertionError(f"(h) serve_fleet --grid-shards: rc {rc}, summary {summary}, "
                             f"{len(ticks)} tick lines; stderr {err.getvalue()[-2000:]}")
    return dict(summary=summary[0], stderr=err.getvalue().strip().splitlines()[-1])


FG_CLEAN: dict = {}  # phase 4-fleet-grid's records by tick and its streams' final digests


def phase4_fleet_grid(lut, grid_launches: dict) -> None:
    """The 2-D streams x grid fleet (FleetVoFOD(n_streams=2, grid_shards=3))
    at the flagship size, the apriori plane in every stream, stream b fed
    the cycle from scan 3 b: (a) 8 ticks beside dense nodes, diagnostics,
    detection integers and final states bit-equal, detection floats within
    1e-5 relative; (b) a NaN rotation on stream 1 at tick 4 (a null scan,
    n_pose_rejected [0, 1]); (c) reset_stream(0) + load_apriori_map(plane,
    stream=0) before tick 6; (d) 1 host sync a tick and 2 x phase 4-grid's
    launches a scan of every kernel, none of the others; (e) the state
    after tick 3 saved in the ``streams_zshards`` layout, restored onto a
    fresh 2-D fleet and onto a 1-shard fleet, both stepped to tick 8 equal
    to the uninterrupted run; (f) one prebinned tick through
    make_fleet_grid_step equal to dense prebinned nodes; (g) tick p50 / p95
    at B = 1 and 2, B = 2's device busy and idle share; (h) serve_fleet
    --grid-shards 3 on the card."""
    t_phase = time.perf_counter()
    cycle = scan_cycle(lut, N_SCANS)
    plane = apriori_ground()
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    ckpt = work / "fleet_grid_ckpt"
    clean = _fg_parity(lut, cycle, plane, grid_launches, ckpt)
    resumed = _fg_resumed(lut, cycle, plane, ckpt, clean)
    shutil.rmtree(ckpt, ignore_errors=True)
    prebinned = _fg_prebinned(lut, cycle, plane)
    say("4-fleet-grid", streams=FG_B, shards=GRID_SHARDS, ticks=FG_TICKS,
        bit_equal_state_and_diag=True, detection_floats_bit_equal=clean["bit_equal_dets"],
        host_syncs_per_tick=clean["syncs"], launches_per_tick=clean["launches_per_tick"],
        null_tick_launches=clean["null_tick_launches"],
        detections_per_stream=clean["detections_per_stream"],
        null_scan=dict(tick=FG_NAN[0], stream=FG_NAN[1],
                       n_pose_rejected=clean["n_pose_rejected"]),
        reset=dict(tick=FG_RESET[0], stream=FG_RESET[1], steps_final=clean["steps_final"]),
        checkpoint=dict(saved_after_tick=FG_SAVE - 1, save_ms=clean["save_ms"], **resumed),
        prebinned=prebinned, seconds=time.perf_counter() - t_phase)
    FG_CLEAN.update(records=clean["records"],
                    final=[_slab_digest(gather_state(s)) for s in clean["fleet"].state])
    del clean
    say("4-fleet-grid-timing", nvidia_smi=_smi(), warm_ticks=FLEET_WARM_TICKS,
        timed_ticks=FG_TIMED_TICKS, **_fg_timing(cycle, plane))
    say("4-fleet-grid-cli", nvidia_smi=_smi(), **_fg_cli())


# ---------------------------------------------------------------------------
# phase 4-fleet-procs: the fleet served by two processes on the one card
# ---------------------------------------------------------------------------

PROC_B = 4
# 1-shard ticks past the 6 a check needs: a cold map's first detections
# come at ticks 8-9 of the cycle (phase 4-fleet), and these compare them
PROC_TICKS, PROC_GRID_TICKS = 12, 3
PROC_TIMEOUT = 300.0  # seconds a worker process may take


def _procs_run(fleet, cycle, plane, ticks: int, local: bool) -> dict:
    """A fleet of PROC_B streams through ``ticks`` ticks of the cycle (stream
    b from scan 3 b), the apriori plane first; ``local``: through
    process_local_scans with this process's streams only.  Returns the
    records by tick and global stream id, each tick's host ms and a digest
    of each stream's final state."""
    fleet.load_apriori_map(plane)
    ticks_out, ms = [], []
    for k in range(ticks):
        r, p = _fleet_tick(cycle, PROC_B, k)
        t0 = time.perf_counter()
        if local:
            ids = fleet.local_streams
            msgs = fleet.process_local_scans(r[ids], p[ids])
        else:
            msgs = dict(enumerate(fleet.process_scans(r, p)))
        ms.append((time.perf_counter() - t0) * 1e3)
        d = fleet.last_diag
        ticks_out.append({b: ([dataclasses.astuple(x) for x in m.detections],
                              {f.name: np.asarray(getattr(d, f.name))[i].tolist()
                               for f in dataclasses.fields(d)})
                          for i, (b, m) in enumerate(msgs.items())})
    final = {}
    for b, s in zip(fleet.local_streams, fleet.state):
        s = s if isinstance(s, VoFODState) else gather_state(s)
        final[b] = [s.step] + [hashlib.sha1(getattr(s, f).cpu().numpy().tobytes()).hexdigest()
                               for f in STATE_FIELDS if f != "step"]
    return dict(local=fleet.local_streams, ticks=ticks_out, ms=ms, final=final)


def fleet_worker(rank: int, port: int, out: str) -> int:
    """``python3 chip_smoke.py --fleet-worker RANK PORT OUT``: one of phase
    4-fleet-procs' two processes.  Joins the gloo group on 127.0.0.1:PORT,
    runs FleetVoFOD(n_streams=4) through PROC_TICKS ticks with 1 grid shard
    and PROC_GRID_TICKS with 3, feeding its own streams only, and writes
    its records to OUT.  Any failure raises (a non-zero exit)."""
    import pickle

    from vofod_tpu_torch.runtime.fleet import initialize_multihost

    if not torch.cuda.is_available():
        raise RuntimeError("the fleet worker needs a CUDA GPU")
    initialize_multihost(f"127.0.0.1:{port}", 2, rank)
    try:
        lut = make_lut(VoFODConfig().sensor)
        cycle, plane = scan_cycle(lut, N_SCANS), apriori_ground()
        res = {shards: _procs_run(FleetVoFOD(VoFODConfig(), DynParams(), PROC_B, device="cuda",
                                             grid_shards=shards), cycle, plane, ticks, True)
               for shards, ticks in ((1, PROC_TICKS), (GRID_SHARDS, PROC_GRID_TICKS))}
        res["device"] = torch.cuda.current_device()
        with open(out, "wb") as f:
            pickle.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()
    print("FLEET_WORKER_OK", rank, flush=True)
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _processes(cmds: list, logs: list) -> list[int]:
    """Run the commands at once (output to ``logs``), each within
    PROC_TIMEOUT; a process still running then is killed and fails the
    phase.  Returns the exit codes."""
    procs = []
    for cmd, log in zip(cmds, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(cmd, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT))
    t_end = time.time() + PROC_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, t_end - time.time()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"a process of {cmds[0][:4]} ran past {PROC_TIMEOUT} s: "
                             + " | ".join(Path(x).read_text()[-1500:] for x in logs)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs]


def _mps_state() -> dict:
    """Whether the card runs MPS (a control daemon's pipe, an MPS server
    process) or time-slices the two processes' contexts, and its compute
    mode."""
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    server = subprocess.run(["pgrep", "-f", "nvidia-cuda-mps"], capture_output=True,
                            text=True).stdout.split()
    pipe = Path("/tmp/nvidia-mps").exists()
    return dict(compute_mode=mode, mps_processes=len(server), mps_pipe_dir=pipe,
                sharing="mps" if server else "time-sliced contexts")


def phase4_fleet_procs(lut) -> None:
    """The fleet served by two processes on the one card (runtime/fleet.py
    initialize_multihost, a gloo group on 127.0.0.1): two workers
    (``--fleet-worker``) each run FleetVoFOD(n_streams=4) with 1 grid shard
    for 12 ticks and with 3 for 3 ticks, feeding only their streams; every
    stream's records and final state equal a single-process 4-stream fleet
    on the same scans, local_streams [0, 1] and [2, 3]; then serve_fleet
    --coordinator in two processes for 5 ticks, each reporting only its own
    streams.  A worker's non-zero exit, a timeout or a missing record
    fails the phase.  Recorded, not claimed: each process's tick host ms
    beside the single process's, and whether the card time-slices the two
    contexts or runs MPS."""
    import pickle

    t_phase = time.perf_counter()
    kernels.build()  # built in phase 1: the workers load it, none compiles
    native.build()
    cycle, plane = scan_cycle(lut, N_SCANS), apriori_ground()
    single = {shards: _procs_run(FleetVoFOD(VoFODConfig(), DynParams(), PROC_B, device="cuda",
                                            grid_shards=shards), cycle, plane, ticks, False)
              for shards, ticks in ((1, PROC_TICKS), (GRID_SHARDS, PROC_GRID_TICKS))}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    work = ROOT / "build" / "chip_smoke" / "procs"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    outs = [work / f"rank{r}.pkl" for r in range(2)]
    port = _free_port()
    t0 = time.perf_counter()
    rcs = _processes(
        [[sys.executable, str(ROOT / "chip_smoke.py"), "--fleet-worker", str(r), str(port),
          str(outs[r])] for r in range(2)], [work / f"worker{r}.log" for r in range(2)])
    workers_s = time.perf_counter() - t0
    for r, rc in enumerate(rcs):
        log = (work / f"worker{r}.log").read_text()
        if rc != 0 or f"FLEET_WORKER_OK {r}" not in log or not outs[r].exists():
            raise AssertionError(f"(a) worker {r}: exit {rc}, log {log[-3000:]}")
    res = [pickle.loads(p.read_bytes()) for p in outs]
    timing = {}
    for shards in (1, GRID_SHARDS):
        one = single[shards]
        if [w[shards]["local"] for w in res] != [[0, 1], [2, 3]]:
            raise AssertionError(f"(a) local_streams {[w[shards]['local'] for w in res]}")
        for r, w in enumerate(res):
            run = w[shards]
            if len(run["ticks"]) != len(one["ticks"]):
                raise AssertionError(f"(a) worker {r}, {shards} shards: "
                                     f"{len(run['ticks'])} ticks recorded")
            for k, tick in enumerate(run["ticks"]):
                if sorted(tick) != run["local"]:
                    raise AssertionError(f"(a) worker {r} tick {k}: streams {sorted(tick)}")
                for b, rec in tick.items():
                    if rec != one["ticks"][k][b]:
                        raise AssertionError(f"(a) {shards} shards, tick {k}, stream {b}: "
                                             "records differ from the single process's")
            for b, digest in run["final"].items():
                if digest != one["final"][b]:
                    raise AssertionError(f"(a) {shards} shards, stream {b}: final state differs")
        timing[shards] = dict(
            single_process_tick_ms_p50=float(np.percentile(one["ms"][1:], 50)),
            per_process_tick_ms_p50=[float(np.percentile(w[shards]["ms"][1:], 50)) for w in res],
            single_process_tick_ms_all=[round(x, 3) for x in one["ms"]],
            per_process_tick_ms_all=[[round(x, 3) for x in w[shards]["ms"]] for w in res])
    detections = sum(len(rec[0]) for t in single[1]["ticks"] for rec in t.values())
    # (b) the serving CLI across the two processes
    port = _free_port()
    logs = [work / f"cli{r}.log" for r in range(2)]
    rcs = _processes(
        [[sys.executable, "-m", "vofod_tpu_torch.tools.serve_fleet", "--streams", str(PROC_B),
          "--sim", "--ticks", "5", "--json", "--device", "cuda", "--coordinator",
          f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(r)]
         for r in range(2)], logs)
    cli = []
    for r, (rc, log) in enumerate(zip(rcs, logs)):
        text = log.read_text()
        lines = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
        summary = [ln for ln in lines if ln.get("summary")]
        streams = sorted({ln["stream"] for ln in lines if "stream" in ln})
        if (rc != 0 or len(summary) != 1 or summary[0]["ticks"] != 5
                or summary[0]["streams"] != PROC_B // 2
                or not set(streams) <= {2 * r, 2 * r + 1}):
            raise AssertionError(f"(b) serve_fleet process {r}: exit {rc}, summary {summary}, "
                                 f"streams {streams}; log {text[-3000:]}")
        cli.append(dict(summary=summary[0], detection_streams=streams))
    say("4-fleet-procs", nvidia_smi=_smi(), processes=2, streams=PROC_B,
        ticks={1: PROC_TICKS, GRID_SHARDS: PROC_GRID_TICKS}, bit_equal_to_one_process=True,
        local_streams=[[0, 1], [2, 3]], worker_devices=[w["device"] for w in res],
        detections_one_process=detections, workers_wall_s=workers_s, tick_host_ms=timing,
        cli=cli, card_sharing=_mps_state(), seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# phase 4-grid-procs: the grid axis across processes, one shard a process
# ---------------------------------------------------------------------------

GP_PATHS = tuple(GRID_KEEP.items())  # (path, scans) replayed across processes
GP_CLI_TICKS = 5
GP_CLI_WARM = 12  # ticks of the cycle in the state (d) resumes from: past the first detection


def _gp_scans(lut, comm, path: str, n_scans: int) -> list[dict]:
    """One grid path's first ``n_scans`` scans of the cycle through this
    process's shard of ``comm`` (phase 4-grid's start: the apriori plane on
    a fresh map): per scan the diagnostics, the detections, the slab's
    digest, the launches, the transport's calls, host syncs and host ms
    by collective, and the step's ms (CUDA events, as phase 4-grid; and
    the host clock through the readback)."""
    make_cfg, node_kw, step_kw, *_ = GRID_PATHS[path]
    cfg = make_cfg()
    node = VoFOD(cfg, DynParams(), NodeOptions(**node_kw), lut, device="cuda")
    node.load_apriori_map(apriori_ground())
    drv = GridDriver(lut, node.state, cfg, comm=comm, **step_kw)
    del node
    out = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for r, p in scan_cycle(lut, N_SCANS)[:n_scans]:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        comm.reset_copies()
        t0, c0 = time.perf_counter(), time.process_time()
        start.record()
        pending = drv.process_scan_async(r, p)
        end.record()
        diag, dets = drv.fetch(pending)
        host_ms = (time.perf_counter() - t0) * 1e3
        out.append(dict(diag=diag, dets=dets, slab=_slab_digest(drv.states[0]),
                        launches={g: v for g, v in kernels.launch_counts().items() if v},
                        calls=dict(comm.calls_by), syncs=dict(comm.syncs_by),
                        transport_ms=dict(comm.host_ms_by), sync_ms=dict(comm.sync_ms_by),
                        exchange_ms=dict(comm.wait_ms_by),
                        cpu_ms=(time.process_time() - c0) * 1e3,
                        ms=start.elapsed_time(end), host_ms=host_ms))
    return out


def _gp_fleet(lut, ckpt: Path) -> dict:
    """Phase 4-fleet-grid's script on FleetVoFOD(n_streams=2, grid_shards=3,
    grid_shards_per_process=1): this process's records by tick, tick host
    ms, the streams' final digests (gathered over the group), and the state
    before tick FG_SAVE saved by the three processes into ``ckpt``."""
    cycle, plane = scan_cycle(lut, N_SCANS), apriori_ground()
    fleet = FleetVoFOD(VoFODConfig(), DynParams(), FG_B, device="cuda", grid_shards=GRID_SHARDS,
                       grid_shards_per_process=1)
    fleet.load_apriori_map(plane)
    records, ms = [], []
    for k in range(FG_TICKS):
        if k == FG_SAVE:
            save_state(str(ckpt), fleet.state, layout="streams_zshards", comm=fleet.comm,
                       streams=fleet.local_streams)
        r, p = _fleet_tick(cycle, FG_B, k)
        _fg_events(fleet, plane, k, r, p)
        t0 = time.perf_counter()
        msgs = fleet.process_local_scans(r, p)
        ms.append((time.perf_counter() - t0) * 1e3)
        records.append([_stream_record(fleet, msgs, b) for b in range(FG_B)])
    final = [_slab_digest(gather_state(s, fleet.comm)) for s in fleet.state]
    return dict(local=fleet.local_streams, shard=fleet.comm.rank, records=records, ms=ms,
                final=final, rejected=[int(x) for x in fleet.n_pose_rejected])


def grid_proc_worker(rank: int, port: int, out: str) -> int:
    """``python3 chip_smoke.py --grid-proc-worker RANK PORT OUT``: one of
    phase 4-grid-procs' three processes, grid shard RANK.  Joins the gloo
    group on 127.0.0.1:PORT, runs the sweep and exact grid paths over a
    ProcessComm(3) on the card (GP_PATHS) and the 2-D fleet with one shard
    a process, and writes its records to OUT.  Any failure raises (a
    non-zero exit)."""
    import pickle

    from vofod_tpu_torch.parallel.comm import ProcessComm
    from vofod_tpu_torch.runtime.fleet import initialize_multihost

    if not torch.cuda.is_available():
        raise RuntimeError("the grid worker needs a CUDA GPU")
    initialize_multihost(f"127.0.0.1:{port}", GRID_SHARDS, rank)
    try:
        lut = make_lut(VoFODConfig().sensor)
        comm = ProcessComm(GRID_SHARDS, "cuda")
        res = {path: _gp_scans(lut, comm, path, n) for path, n in GP_PATHS}
        res["host"] = dict(torch_threads=torch.get_num_threads(),
                           cpus=len(os.sched_getaffinity(0)))
        res["fleet"] = _gp_fleet(lut, Path(out).parent / "fleet_ckpt")
        res["device"] = str(comm.device)
        with open(out, "wb") as f:
            pickle.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()
    print("GRID_WORKER_OK", rank, flush=True)
    return 0


def _gp_check_path(path: str, n: int, runs: list) -> dict:
    """(a) / (b): each process's scans against phase 4-grid's in-process
    run of the path: diagnostics, detections and its slab bit-equal,
    detection floats within 1e-5 relative of the dense node's; each kernel
    of the path launched in every process on every scan, none of the
    others, the processes' launches summing to phase 4-grid's a scan."""
    _, _, _, path_kernels, never, _ = GRID_PATHS[path]
    ref = GRID_RECORDS[path]["scans"]
    rel_err, n_dets = 0.0, 0
    for r, run in enumerate(runs):
        if len(run) != n:
            raise AssertionError(f"{path} process {r}: {len(run)} scans recorded")
        for k, (got, want) in enumerate(zip(run, ref)):
            what = f"{path} process {r} scan {k}"
            for f, v in want["diag"].items():
                if not np.array_equal(got["diag"][f], v):
                    raise AssertionError(f"{what}: diag.{f} differs from phase 4-grid's")
            for f, v in want["dets"].items():
                if not np.array_equal(got["dets"][f], v):
                    raise AssertionError(f"{what}: detections.{f} differs from phase 4-grid's")
                d = want["dense_dets"][f]
                if v.dtype.kind == "f":
                    np.testing.assert_allclose(got["dets"][f], d, rtol=1e-5, atol=0.0,
                                               err_msg=f"{what}: detections.{f} vs dense")
                    den = np.maximum(np.abs(d), 1e-30)
                    rel_err = max(rel_err, float(np.max(np.abs(got["dets"][f] - d) / den,
                                                        initial=0.0)))
                elif not np.array_equal(got["dets"][f], d):
                    raise AssertionError(f"{what}: detections.{f} differs from the dense node's")
            if got["slab"] != want["slabs"][r]:
                raise AssertionError(f"{what}: slab differs from phase 4-grid's shard {r}")
            missing = [g for g in path_kernels if not got["launches"].get(g)]
            if missing:
                raise AssertionError(f"{what}: kernels not launched: {missing}")
            foreign = [g for g in never if got["launches"].get(g)]
            if foreign:
                raise AssertionError(f"{what}: other paths' kernels launched: {foreign}")
            if r == 0:
                n_dets += int(got["dets"]["valid"].sum())
    for k in range(n):
        want = {g: v for g, v in ref[k]["launches"].items() if v}
        total = {}
        for run in runs:
            for g, v in run[k]["launches"].items():
                total[g] = total.get(g, 0) + v
        if total != want:
            off = {g: (total.get(g, 0), want.get(g, 0)) for g in set(total) | set(want)
                   if total.get(g, 0) != want.get(g, 0)}
            raise AssertionError(f"{path} scan {k}: the processes' launches (got, phase "
                                 f"4-grid's) {off}")
    kinds = sorted({c for run in runs for s in run for c in s["calls"]})

    def per_scan(key: str, run: list) -> dict:
        return {c: float(np.mean([s[key].get(c, 0) for s in run])) for c in kinds}

    ms_ref = GRID_RECORDS[path]["ms"][:n]
    return dict(
        scans=n, bit_equal_to_in_process=True, detection_float_max_rel_err_vs_dense=rel_err,
        detections=n_dets,
        launches_per_scan_per_process=[
            {g: float(np.mean([s["launches"].get(g, 0) for s in run]))
             for g in sorted({g for s in run for g in s["launches"]})} for run in runs],
        step_ms_p50=[float(np.percentile([s["ms"] for s in run], 50)) for run in runs],
        step_ms_p95=[float(np.percentile([s["ms"] for s in run], 95)) for run in runs],
        step_host_ms_p50=[float(np.percentile([s["host_ms"] for s in run], 50)) for run in runs],
        in_process_step_ms_p50=float(np.percentile(ms_ref, 50)),
        in_process_step_ms_p95=float(np.percentile(ms_ref, 95)),
        staged_collectives_per_scan=[per_scan("calls", run) for run in runs],
        host_syncs_per_scan=[dict(per_scan("syncs", run), readback=1.0) for run in runs],
        transport_host_ms_per_scan=[per_scan("transport_ms", run) for run in runs],
        transport_sync_wait_ms_per_scan=[per_scan("sync_ms", run) for run in runs],
        transport_exchange_ms_per_scan=[per_scan("exchange_ms", run) for run in runs],
        process_cpu_ms_per_scan_p50=[float(np.percentile([s["cpu_ms"] for s in run], 50))
                                     for run in runs],
        step_ms_all=[[round(s["ms"], 3) for s in run] for run in runs])


def _gp_check_fleet(lut, runs: list, ckpt: Path) -> dict:
    """(c): every process's records and final digests equal phase
    4-fleet-grid's; the processes' checkpoint restored onto a one-process
    2-D fleet steps to tick FG_TICKS equal to the run not interrupted."""
    for r, run in enumerate(runs):
        if (run["local"], run["shard"]) != ([0, 1], r):
            raise AssertionError(f"(c) process {r}: streams {run['local']}, shard {run['shard']}")
        for k, tick in enumerate(run["records"]):
            for b, rec in enumerate(tick):
                _same_record(rec, FG_CLEAN["records"][k][b],
                             f"(c) process {r} tick {k} stream {b}")
        if run["final"] != FG_CLEAN["final"]:
            raise AssertionError(f"(c) process {r}: final states differ from phase 4-fleet-grid's")
        if run["rejected"] != [int(b == FG_NAN[1]) for b in range(FG_B)]:
            raise AssertionError(f"(c) process {r}: n_pose_rejected {run['rejected']}")
    cycle, plane = scan_cycle(lut, N_SCANS), apriori_ground()
    fleet = _fg_fleet(FG_B, plane)
    t0 = time.perf_counter()
    fleet.state = restore_state(str(ckpt), fleet.state)
    restore_ms = (time.perf_counter() - t0) * 1e3
    for k in range(FG_SAVE, FG_TICKS):
        r, p = _fleet_tick(cycle, FG_B, k)
        _fg_events(fleet, plane, k, r, p)
        msgs = fleet.process_scans(r, p)
        for b in range(FG_B):
            _same_record(_stream_record(fleet, msgs, b), FG_CLEAN["records"][k][b],
                         f"(c) resumed on one process, tick {k}, stream {b}")
    if [_slab_digest(gather_state(s)) for s in fleet.state] != FG_CLEAN["final"]:
        raise AssertionError("(c) resumed on one process: final states differ")
    return dict(streams=FG_B, ticks=FG_TICKS, records_and_states_equal=True,
                tick_host_ms_p50=[float(np.percentile(run["ms"][1:], 50)) for run in runs],
                tick_host_ms_all=[[round(x, 3) for x in run["ms"]] for run in runs],
                checkpoint=dict(saved_after_tick=FG_SAVE - 1, restored_on_one_process=True,
                                restore_ms=restore_ms, files=len(list(ckpt.glob("*.npz")))))


def _gp_cli_record(d) -> dict:
    """A detection as serve_fleet --json prints it (floats through JSON)."""
    return json.loads(json.dumps({"id": d.id, "position": list(d.position),
                                  "confidence": d.confidence,
                                  "detection_probability": d.detection_probability}))


def _gp_check_cli(lut, work: Path) -> list:
    """(d): serve_fleet --coordinator --grid-shards 3
    --grid-shards-per-process 1 in three processes for GP_CLI_TICKS ticks
    of a looped recording of the cycle, resumed (``--load-state``) from a
    one-process 2-D fleet's state after GP_CLI_WARM ticks of it (the
    apriori plane first).  Process 0 alone prints the streams; every
    process reports the same frames a tick; process 0's detections, a
    tick and a stream, equal that one-process fleet's fed the same frames
    from the same state, and are not empty."""
    cycle, plane = scan_cycle(lut, N_SCANS), apriori_ground()
    ranges = np.stack([r for r, _ in cycle])
    poses = np.stack([p for _, p in cycle]).astype(np.float32)
    save_scans_npz(str(work / "scans.npz"), ranges, poses)
    fleet = _fg_fleet(FG_B, plane)
    for k in range(GP_CLI_WARM):
        fleet.process_scans(*_fleet_tick(cycle, FG_B, k))
    save_state(str(work / "cli_ckpt"), fleet.state, layout="streams_zshards")
    port = _free_port()
    logs = [work / f"cli{r}.log" for r in range(GRID_SHARDS)]
    rcs = _processes(
        [[sys.executable, "-m", "vofod_tpu_torch.tools.serve_fleet", "--streams", str(FG_B),
          "--scans", str(work / "scans.npz"), "--loop", "--ticks", str(GP_CLI_TICKS),
          "--json", "--device", "cuda", "--load-state", str(work / "cli_ckpt"),
          "--grid-shards", str(GRID_SHARDS), "--grid-shards-per-process", "1",
          "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(GRID_SHARDS),
          "--process-id", str(r)] for r in range(GRID_SHARDS)], logs)
    cli, frames = [], None
    for r, (rc, log) in enumerate(zip(rcs, logs)):
        text = log.read_text()
        lines = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
        summary = [ln for ln in lines if ln.get("summary")]
        ticks = [ln for ln in lines if "latency_ms" in ln]
        dets = [ln for ln in lines if "stream" in ln]
        if (rc != 0 or len(summary) != 1 or summary[0]["ticks"] != GP_CLI_TICKS
                or summary[0]["streams"] != FG_B or len(ticks) != GP_CLI_TICKS
                or (r and dets)):
            raise AssertionError(f"(d) serve_fleet process {r}: exit {rc}, summary {summary}, "
                                 f"{len(ticks)} ticks, {len(dets)} detection lines; "
                                 f"log {text[-3000:]}")
        got = [ln["frames"] for ln in ticks]
        if frames is None:
            frames, printed = got, dets
        elif got != frames:
            raise AssertionError(f"(d) process {r} stepped frames {got}, process 0 {frames}")
        cli.append(dict(summary=summary[0], frames=got, detection_lines=len(dets)))
    # the one-process fleet, still at the saved state, fed process 0's frames
    want = []
    for t, idx in enumerate(frames, start=1):
        idx = [k % N_SCANS for k in idx]
        msgs = fleet.process_scans(ranges[idx], poses[idx])
        want += [{"tick": t, "stream": b, **_gp_cli_record(d)}
                 for b in range(FG_B) for d in msgs[b].detections]
    if not want or printed != want:
        raise AssertionError(f"(d) process 0 printed {len(printed)} detections, the one-process "
                             f"fleet on its frames {len(want)}: {printed[:3]} / {want[:3]}")
    cli[0]["detections_equal_to_one_process"] = len(want)
    return cli


def phase4_grid_procs(lut) -> None:
    """The grid axis across processes (parallel/comm.ProcessComm: one z
    shard a process, the collectives staged through the host over gloo) at
    the flagship size: three worker processes (``--grid-proc-worker``,
    started once the parent has built the kernels) share the card, each
    holding one 17-plane shard: (a) the sweep path's 36 scans and (b) the
    exact path's 12, every process's diagnostics, detections and slab
    bit-equal to phase 4-grid's in-process run (and the detection floats
    within 1e-5 of its dense node's), every kernel of the path launched in
    each process, their launches summing to phase 4-grid's; (c) phase
    4-fleet-grid's script on FleetVoFOD(n_streams=2, grid_shards=3,
    grid_shards_per_process=1), records and final states equal to that
    phase's, the state after tick 3 saved by the three processes and
    restored onto a one-process fleet that steps to tick 8 equal; (d)
    serve_fleet --coordinator --grid-shards 3 --grid-shards-per-process 1
    in three processes (:func:`_gp_check_cli`), process 0's detections
    equal to a one-process fleet's on the frames it stepped.  Recorded: step p50
    / p95 beside the in-process path's, the staged collectives, host syncs,
    transport host ms and the syncs' share of them a scan by collective.  A worker's non-zero exit, a timeout or a missing record
    fails the phase."""
    import pickle

    t_phase = time.perf_counter()
    kernels.build()  # built in phase 1: the workers load it, none compiles
    native.build()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    work = ROOT / "build" / "chip_smoke" / "grid_procs"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    outs = [work / f"rank{r}.pkl" for r in range(GRID_SHARDS)]
    port = _free_port()
    t0 = time.perf_counter()
    rcs = _processes(
        [[sys.executable, str(ROOT / "chip_smoke.py"), "--grid-proc-worker", str(r), str(port),
          str(outs[r])] for r in range(GRID_SHARDS)],
        [work / f"worker{r}.log" for r in range(GRID_SHARDS)])
    workers_s = time.perf_counter() - t0
    for r, rc in enumerate(rcs):
        log = (work / f"worker{r}.log").read_text()
        if rc != 0 or f"GRID_WORKER_OK {r}" not in log or not outs[r].exists():
            raise AssertionError(f"worker {r}: exit {rc}, log {log[-3000:]}")
    res = [pickle.loads(p.read_bytes()) for p in outs]
    paths = {path: _gp_check_path(path, n, [w[path] for w in res]) for path, n in GP_PATHS}
    fleet = _gp_check_fleet(lut, [w["fleet"] for w in res], work / "fleet_ckpt")
    cli = _gp_check_cli(lut, work)
    say("4-grid-procs", nvidia_smi=_smi(), processes=GRID_SHARDS,
        shard_planes=_FLAGSHIP.nz // GRID_SHARDS, worker_devices=[w["device"] for w in res],
        sweep=paths["sweep"], exact=paths["exact"], fleet=fleet, cli=cli,
        worker_host=[w["host"] for w in res],
        workers_wall_s=workers_s, card_sharing=_mps_state(),
        seconds=time.perf_counter() - t_phase)


def _dev_us(e, self_only: bool) -> float:
    name = "self_device_time_total" if self_only else "device_time_total"
    legacy = "self_cuda_time_total" if self_only else "cuda_time_total"
    return float(getattr(e, name, None) or getattr(e, legacy, 0.0))


def _device_events(prof, n: int) -> dict:
    """Device-side events of the trace per scan, counted one by one from
    ``prof.events()`` (not from key_averages), by kind."""
    from torch.autograd import DeviceType

    kinds = {"kernel": 0, "memcpy": 0, "memset": 0}
    names = set()
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        low = e.name.lower()
        kinds["memcpy" if "memcpy" in low else "memset" if "memset" in low else "kernel"] += 1
        names.add(e.name)
    return dict(per_scan=sum(kinds.values()) / n, by_kind={k: v / n for k, v in kinds.items()},
                distinct_names=len(names))


# the device functions of csrc/*.cu, as torch.profiler names them: each
# path profile reports every one's device ms and launches a scan
PORT_KERNELS = (
    "ball_pool_kernel", "demote_ema_kernel", "exact_demote_kernel", "point_ema_kernel",
    "sweeps_kernel", "frontend_bin_kernel", "cone_cluster_kernel",
    "cone_cluster_lat_kernel", "cone_cluster_zt_kernel", "compact_kernel",
    "explore_planes_kernel", "explore_kernel", "demote_kernel", "explore_spec_kernel",
    "explore_cut_kernel", "slots_kernel",
    "chunk_sort_kernel", "chunk_heads_kernel", "chunk_rank_kernel", "chunk_stats_kernel",
    "gate_faces_kernel", "ray_update_kernel", "ray_ema_grid_kernel", "detect_kernel",
    "dda_kernel", "round_kernel", "census_add_kernel", "census_read_kernel",
    "quirk_columns_kernel", "quirk_colprefix_kernel", "quirk_walk_kernel", "quirk_cells_kernel",
    "unpack_kernel", "halo_exchange_kernel", "halo_fold_min_kernel")
_PORT_KERNEL_RE = re.compile(r"\b(" + "|".join(PORT_KERNELS) + r")\b")


def port_kernel_ms(dev_ops, n: int) -> dict:
    """{device function: [device ms a scan, launches a scan]} of the port's
    kernels among a profile's device ops (key_averages over n scans)."""
    out = {}
    for e in dev_ops:
        m = _PORT_KERNEL_RE.search(e.key)
        if m:
            ms, k = out.get(m.group(1), (0.0, 0.0))
            out[m.group(1)] = (ms + _dev_us(e, True) / n / 1e3, k + e.count / n)
    return {k: [round(ms, 4), cnt] for k, (ms, cnt) in sorted(out.items())}


def phase5_profile(lut, step_ms_p50: float, n: int = 5, path: str = "sweep",
                   label: str | None = None) -> dict:
    """Where the flagship step's device time goes (torch.profiler), on the
    sweep, exact, prebinned, dynamic-radii (at its heaviest radii, 2.0 /
    1.9 m), sequential-explore, grid-sharded sweep, grid-sharded exact,
    grid-sharded sequential-explore or grid-sharded sweep with the
    transposed z cones path.  Every path is counted the same way:
    a fresh node, the apriori plane, 6 warm-up scans, then one profiler
    session over ``n`` scans; device ops are counted both from key_averages
    (the earlier count) and event by event."""
    from torch.profiler import ProfilerActivity, profile

    cfg, opts = VoFODConfig(), NodeOptions()
    if path in ("exact", "sequential", "grid-exact", "grid-sequential"):
        cfg = sequential_config() if path.endswith("sequential") else exact_config()
        opts = NodeOptions(raycast_mode="exact")
    elif path == "prebinned":
        opts = NodeOptions(frontend_mode="prebinned")
    elif path == "dynamic":
        cfg = VoFODConfig(dynamic_radii=True, ground_points_max_distance_bound=2.0,
                          sepclusters_max_bg_distance_bound=2.0)
    elif path.endswith("fine"):
        cfg = fine_config()
    node = VoFOD(cfg, DynParams(), opts, lut, device="cuda")
    if path == "dynamic":
        node.update_params(ground_points_max_distance=2.0, sepclusters_max_bg_distance=1.9)
    node.load_apriori_map(fine_apriori_ground() if path.endswith("fine") else apriori_ground())
    if path == "grid":  # the 3-shard step from the same start
        node = GridDriver(lut, node.state)
    elif path == "grid-transpose":
        node = GridDriver(lut, node.state, zcone_mode="transpose")
    elif path in ("grid-exact", "grid-sequential", "grid-fine"):
        node = GridDriver(lut, node.state, cfg,
                          **({} if path == "grid-fine" else dict(raycast_mode="exact")))
    scans = (fine_scan_cycle if path.endswith("fine") else scan_cycle)(lut, 6 + n)
    for r, p in scans[:6]:
        node.process_scan(r, None, p)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r, p in scans[6:]:
            node.process_scan(r, None, p)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    calls = kernels.launch_counts()
    ev = prof.key_averages()
    stages = {e.key: round(_dev_us(e, False) / n / 1e3, 3) for e in ev if e.key.startswith("vofod.")}
    ops = [e for e in ev if not e.key.startswith("vofod.") and _dev_us(e, True) > 0]
    dev_ops = [e for e in ops if not e.key.startswith("aten::")]
    busy_ms = sum(_dev_us(e, True) for e in dev_ops) / n / 1e3
    top = sorted(dev_ops, key=lambda e: -_dev_us(e, True))[:12]
    # what K5 and K10 removed: the gate expansion's matmuls, detect's pads
    gemm = sum(e.count for e in dev_ops if any(w in e.key.lower() for w in ("gemm", "bmm")))
    pads = sum(e.count for e in ops if e.key == "aten::constant_pad_nd")
    out = dict(scans=n, profiled_wall_ms_per_scan=round(wall_ms, 3),
               unprofiled_step_ms_p50=round(step_ms_p50, 3),
               device_busy_ms_per_scan=round(busy_ms, 3),
               device_ops_per_scan=sum(e.count for e in dev_ops) / n,
               device_events=_device_events(prof, n),
               idle_share_of_unprofiled_step=round(1.0 - busy_ms / step_ms_p50, 3),
               stage_device_span_ms_per_scan=stages,
               gemm_kernels_per_scan=gemm / n, pad_ops_per_scan=pads / n,
               top_device_kernels=[[round(_dev_us(e, True) / n / 1e3, 3), e.count // n,
                                    e.key[:90]] for e in top],
               port_kernels_ms_per_scan=port_kernel_ms(dev_ops, n))
    # K6 and K5a: their wrappers' launches a scan (one kernel launch each:
    # phase 2's one_launch_profile), 3 and 1 on the sweep path, 15 and 3 on
    # the grid path (5 compactions and a gate a shard); the profile never
    # sees more device launches than that (it may see fewer: a session
    # loses the first kernels of its first scan, PERF.md section 7)
    pk = out["port_kernels_ms_per_scan"]
    expect = {"sweep": (3, 1), "grid": (15, 3), "fine": (3, 1), "grid-fine": (15, 3)}.get(path)
    for i, (fn, wrapper) in enumerate((("compact_kernel", "masked_compact"),
                                       ("gate_faces_kernel", "gate_faces"))):
        got, want = pk.get(fn, [0.0, 0.0])[1], calls[wrapper] / n
        out[f"{wrapper}_launches_per_scan"] = want
        out[f"{fn}_device_launches_per_scan"] = got
        if got > want or (expect is not None and want != expect[i]):
            raise AssertionError(f"{path}: {wrapper} {want} launches a scan (expected "
                                 f"{expect and expect[i]}), {got} {fn} on the device")
    if path.startswith("grid"):
        # K15b-1 (both forms are one kernel) and the device copies beside it
        for key, match in (("k15b1", "halo_exchange_kernel"), ("direct_copy", "direct_copy"),
                           ("memcpy_dtod", "memcpy dtod")):
            hit = [e for e in dev_ops if match in e.key.lower()]
            out[f"{key}_launches_per_scan"] = sum(e.count for e in hit) / n
            ms = sum(_dev_us(e, True) for e in hit) / n / 1e3
            out[f"{key}_device_ms_per_scan"] = round(ms, 4)
    say(label or ("5-profile" if path == "sweep" else f"5-profile-{path}"), **out)
    out["counts_by_name"] = {e.key: e.count for e in dev_ops}
    return out


def main() -> int:
    device = phase0()
    phase1()
    lut = make_lut(VoFODConfig().sensor)
    results = phase2(lut)
    results += phase2_exact(lut)
    results += phase2_sequential(lut)
    results += phase2_grid(lut)
    results += phase2_grid_exact(lut)
    results += phase2_grid_seq(lut)
    phase3()
    launches, step_ms_p50 = phase4(lut)
    phase4_raycast_every(lut)
    exact_launches, exact_ms_p50 = phase4_exact(lut)
    seq_launches, seq_ms_p50 = phase4_exact(lut, sequential=True)
    pre_launches, pre_ms_p50 = phase4_prebinned(lut)
    phase4_auto(lut)
    dyn_launches, dyn_ms_p50 = phase4_dynamic(lut)
    phase4_surface(lut)
    phase4_hostile(lut)
    phase4_fleet(lut, launches)
    grid_launches, grid_ms_p50 = phase4_grid(lut)
    gx_launches, gx_ms_p50 = phase4_grid(lut, "exact")
    gt_launches, gt_ms_p50 = phase4_grid(lut, "transpose")
    phase4_grid(lut, "prebinned")
    phase4_grid(lut, "dynamic")
    gs_launches, gs_ms_p50 = phase4_grid(lut, "sequential")
    fine_launches, fine_grid_launches, fine_ms_p50, fine_grid_ms_p50 = phase4_fine(lut)
    phase4_cli(lut, launches)
    phase4_fleet_grid(lut, grid_launches)
    phase4_fleet_procs(lut)
    phase4_grid_procs(lut)
    first = phase5_profile(lut, step_ms_p50)
    phase5_profile(lut, exact_ms_p50, path="exact")
    phase5_profile(lut, pre_ms_p50, path="prebinned")
    phase5_profile(lut, dyn_ms_p50, path="dynamic")
    phase5_profile(lut, seq_ms_p50, path="sequential")
    phase5_profile(lut, grid_ms_p50, path="grid")
    phase5_profile(lut, gx_ms_p50, path="grid-exact")
    phase5_profile(lut, gs_ms_p50, path="grid-sequential")
    phase5_profile(lut, gt_ms_p50, path="grid-transpose")
    phase5_profile(lut, fine_ms_p50, path="fine")
    phase5_profile(lut, fine_grid_ms_p50, path="grid-fine")
    # the sweep path once more, in the last profiler session: the same code
    # counted in another session says whether the op count is the session's
    again = phase5_profile(lut, step_ms_p50, label="5-profile-sweep-again")
    a, b = first["counts_by_name"], again["counts_by_name"]
    say("5-op-count-sessions", sweep_first=first["device_ops_per_scan"],
        sweep_last=again["device_ops_per_scan"],
        sweep_events_first=first["device_events"]["per_scan"],
        sweep_events_last=again["device_events"]["per_scan"],
        session_dependent=first["device_ops_per_scan"] != again["device_ops_per_scan"],
        # why: the device ops whose count over the 5 scans differs
        differing_ops={k[:80]: [a.get(k, 0), b.get(k, 0)] for k in sorted(set(a) | set(b))
                       if a.get(k, 0) != b.get(k, 0)})
    path_launches = {"unpack": pre_launches, "shell_pool": dyn_launches,
                     "propagate_batch": gx_launches,
                     "explore_seq": seq_launches, "cone_sweep_zt": gt_launches,
                     **{g: grid_launches for g in GRID_KERNELS},
                     **{g: gs_launches for g in ("explore_cut", "explore_seq_stack")},
                     **{g: gx_launches for g in ("census_scatter", "census_read", "quirk_columns",
                                                 "quirk_ranks", "quirk_query", "dda_slab")},
                     # the wide forms: fine-0125's dense and grid paths (K14's,
                     # K11's and K13c's wide forms run on no path of the script)
                     **{g: fine_launches for g in WIDE_KERNELS},
                     "propagate_batch_wide": fine_grid_launches}
    record = []
    for r in results:
        src, replaces = KERNEL_INFO[r["name"]]
        # launches from the path that runs the kernel: the sweep path, the
        # prebinned (K15a), dynamic-radii (K14), sequential (K7s) and
        # grid-sharded (K15b: sweep, exact, transposed, sequential; K2's
        # batched launch: exact) paths, else the exact path
        n = (launches[r["name"]] if r["name"] in SWEEP_KERNELS
             else path_launches.get(r["name"], exact_launches).get(r["name"], 0))
        t_bytes, t_ops = r["bytes"] / HBM_BYTES_PER_S, r["ops"] / F32_OPS_PER_S
        record.append(dict(
            name=r["name"], route="cuda", source=src, replaces=replaces,
            launches=n, max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=r["library_ms"],
        ))
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", **device}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fleet-worker"]:
        sys.exit(fleet_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--grid-proc-worker"]:
        sys.exit(grid_proc_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())

#!/usr/bin/env python3
"""Diagnosis of the DDA walk (K12, K15b-6c) and K9 on one card: variants of
their CUDA sources, built by text substitution and timed side by side.

    python3 dda_k9_probe.py PARENT_DIR

Run from the root of the tree that committed this script, with PARENT_DIR a
checkout of commit 47688f1 (``git archive 47688f1`` unpacked into a
git-ignored directory): the tree whose walk issued one float64 atomicAdd a
chord and whose K9 ranked its slots by two O(F^2) passes.  The text edits
match those two trees' ``csrc/dda.cu`` and this tree's
``csrc/classify_stats.cu`` exactly and raise on any other source, so the
script applies to that pair only.

DDA variants, each built alone under build/probe: the parent's walk and
this tree's warp-combined one, each also with its adds replaced by one
register sum a ray written once (what the walk costs without its scatter)
and with a counter of the adds it issues (a debug atomic, never timed), on
a flagship exact scan's rays (6 warm-up scans), on each of 3 shards' rows
and on as many rays in random directions from the sensor.  K9 variants of
this tree's source: its one launch at a sort width matched to F, at a fixed
512 or 1024 threads, and its chunked path (four launches) at every F, on
the sweep scan's far list and synthetic far lists at F = 2048 and 8192.
Prints the card's name and power limit, then one JSON line.  Needs one GPU.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")
import chip_smoke as cs
from vofod_tpu_torch import kernels
from vofod_tpu_torch.config import DynParams
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.ops.raycast import _dda_consts, dda_n_steps
from vofod_tpu_torch.pipeline.step import exact_rays
from vofod_tpu_torch.runtime.node import NodeOptions, VoFOD

COUNTER = ('__device__ unsigned long long probe_adds;\n'
           'VOFOD_API unsigned long long vofod_probe_adds() {\n'
           '  unsigned long long v = 0, z = 0;\n'
           '  cudaMemcpyFromSymbol(&v, probe_adds, sizeof v);\n'
           '  cudaMemcpyToSymbol(probe_adds, &z, sizeof z);\n'
           '  return v;\n}\n')


def edit(src, pairs):
    for a, b in pairs:
        if src.count(a) != 1:
            raise RuntimeError(f"probe: {a!r} found {src.count(a)} times")
        src = src.replace(a, b)
    return src


def counted(src, add):
    head = '#include "common.cuh"\n'
    return edit(src, [(add, "{ " + add + " atomicAdd(&probe_adds, 1ull); }"),
                      (head, head + COUNTER.split("VOFOD_API")[0])]) + (
        "VOFOD_API" + COUNTER.split("VOFOD_API")[1])


par = (Path(sys.argv[1]) / "vofod_tpu_torch/csrc/dda.cu").read_text()
chg = Path("vofod_tpu_torch/csrc/dda.cu").read_text()
P_ADD, C_ADD = "atomicAdd(acc + lf, (double)ddist);", "atomicAdd(acc + lf, w);"
variants = {
    "parent": par,
    "parent_register_sum": edit(par, [
        (P_ADD, "reg += ddist;"),
        ("  float prev = 0.0f;\n", "  float prev = 0.0f;\n  double reg = 0.0;\n"),
        ("if (!(dist < L) || at_edge) return;",
         "if (!(dist < L) || at_edge) { acc[r] = reg; return; }"),
        ("    prev = dist;\n  }\n}", "    prev = dist;\n  }\n  acc[r] = reg;\n}")]),
    "parent_counted": counted(par, P_ADD),
    "change": chg,
    "change_register_sum": edit(chg, [
        ("  bool more = __any_sync(FULL, alive);",
         "  bool more = __any_sync(FULL, alive);\n  double reg = 0.0;"),
        ("    if (!(votes & 1u)) continue;", "    reg += w;\n    continue;"),
        (C_ADD + "\n  }\n}", C_ADD + "\n  }\n  if (r < n_rays) acc[r] = reg;\n}")]),
    "change_counted": counted(chg, C_ADD),
}
k9_src = Path("vofod_tpu_torch/csrc/classify_stats.cu").read_text()
WIDTH = "while (t < SORT_T && 2 * t < F) t <<= 1;"
k9_variants = {
    "k9_matched_width": k9_src,
    "k9_fixed_512": edit(k9_src, [(WIDTH, "t = SORT_T;")]),
    "k9_fixed_1024": edit(k9_src, [(WIDTH, "t = SORT_T;"), ("SORT_T = 512;", "SORT_T = 1024;")]),
    "k9_chunked": edit(k9_src, [("SMEM_KEYS = 8192;", "SMEM_KEYS = 0;")]),
}
out_dir = Path("build/probe")
out_dir.mkdir(parents=True, exist_ok=True)
nvcc = kernels._nvcc()
jobs = {}
for name, src in {**variants, **k9_variants}.items():
    (out_dir / f"{name}.cu").write_text(src)
    cmd = [nvcc, *kernels.NVCC_FLAGS, "-shared", "-I", str(kernels._CSRC), "-o",
           str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")]
    jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
libs, k9_libs = {}, {}
for name, job in jobs.items():
    log = job.communicate()[0]
    if job.returncode != 0:
        raise RuntimeError(f"nvcc {name}: {log[-3000:]}")
    lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
    if name.startswith("k9_"):
        lib.vofod_cluster_stats.argtypes = kernels.load().vofod_cluster_stats.argtypes
        k9_libs[name] = lib
        continue
    lib.vofod_dda.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 5
    if "counted" in name:
        lib.vofod_probe_adds.restype = ctypes.c_ulonglong
    libs[name] = lib

lut = cs.make_lut(cs.VoFODConfig().sensor)
cfg, dyn = cs.exact_config(), DynParams()
grid = GridSpec.from_config(cfg)
node = VoFOD(cfg, dyn, NodeOptions(raycast_mode="exact"), lut, device="cuda")
node.load_apriori_map(cs.apriori_ground())
scans = cs.scan_cycle(lut, 7)
for r, p in scans[:6]:
    node.process_scan(r, None, p)
r6, p6 = scans[6]
pose = torch.as_tensor(p6, device="cuda")
H, W = lut.height, lut.width
rays = exact_rays(cfg, dyn, grid, torch.as_tensor(lut.directions, device="cuda"),
                  torch.as_tensor(lut.offsets, device="cuda"),
                  torch.ones(H * W, dtype=torch.bool, device="cuda"),
                  torch.as_tensor(r6.astype(np.float32), device="cuda") * 0.001,
                  torch.ones(H * W, dtype=torch.float32, device="cuda"), pose)
g = torch.Generator(device="cuda").manual_seed(12)
R = rays[0].shape[0]
rdirs = torch.randn((R, 3), generator=g, device="cuda")
rdirs = rdirs / torch.linalg.vector_norm(rdirs, dim=1, keepdim=True)
bound = cfg.raycast_max_distance_bound
nzl = grid.nz // 3
cases = {"exact_scan": (rays, (0, grid.nz)),
         **{f"shard{i}_of_3": (rays, (i * nzl, nzl)) for i in range(3)},
         "random_directions": ((pose[:3, 3].expand(R, 3).contiguous(), rdirs,
                                torch.rand(R, generator=g, device="cuda") * bound,
                                torch.ones(R, dtype=torch.bool, device="cuda")), (0, grid.nz))}
fl = _dda_consts(grid).astype(np.float32)
steps = dda_n_steps(grid.voxel_size, bound)
res = {}
for case, (rs, (z0, nzl)) in cases.items():
    ints = np.array([grid.nx, grid.ny, grid.nz, steps, z0, nzl], np.int32)
    acc = torch.zeros((nzl, grid.ny, grid.nx), dtype=torch.float64, device="cuda")
    raylen = torch.empty((nzl, grid.ny, grid.nx), dtype=torch.float32, device="cuda")
    res[case] = {}
    for name, lib in libs.items():
        def call(lib=lib):
            acc.zero_()
            err = lib.vofod_dda(*(t.data_ptr() for t in rs), R, fl.ctypes.data, ints.ctypes.data,
                                acc.data_ptr(), raylen.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        call()
        torch.cuda.synchronize()
        row = {}
        if "counted" in name:
            lib.vofod_probe_adds()  # reset
            call()
            torch.cuda.synchronize()
            row["adds"] = int(lib.vofod_probe_adds())
        else:
            for _ in range(3):  # a session now and then records no device event
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        call()
                    torch.cuda.synchronize()
                walk = [float(getattr(e, "device_time", None) or getattr(e, "cuda_time", 0.0))
                        for e in prof.events()
                        if e.device_type == DeviceType.CUDA and "dda_kernel" in e.name]
                if walk:
                    break
            row["walk_device_ms"] = sum(walk) / len(walk) / 1e3 if walk else None
        res[case][name] = row


def device_ms(fn, reps=20):
    # the device ms a call of every kernel fn launches
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(float(getattr(e, "device_time", None) or getattr(e, "cuda_time", 0.0))
               for e in ev) / reps / 1e3, len(ev) / reps


# K9 on the sweep scan's far list (a sweep node after 6 scans) and on the
# change's synthetic far lists at F = 2048 and 8192
from vofod_tpu_torch.pipeline.background import split_and_update
scfg = cs.VoFODConfig()
snode = VoFOD(scfg, dyn, NodeOptions(), lut, device="cuda")
snode.load_apriori_map(cs.apriori_ground())
for r, p in scans[:6]:
    snode.process_scan(r, None, p)
k3 = cs.frontend_bin(scfg, grid, torch.as_tensor(lut.directions, device="cuda"),
                     torch.as_tensor(lut.offsets, device="cuda"),
                     torch.as_tensor(r6.astype(np.float32), device="cuda"), pose)
bg = split_and_update(scfg, dyn, snode.state.grid, k3[0], snode.state.bg_sufficient)
fids, fvalid, ftotal = cs.masked_compact_plain(bg.far, scfg.max_far_voxels)
true = torch.ones((), dtype=torch.bool, device="cuda")
k9_cases = {"sweep_scan": (fids, fvalid, bg.labels.reshape(-1)[fids.long()], ftotal,
                           pose[:3, 3].contiguous(), bg.bg_sufficient, true)}
for F in (2048, 8192):
    k9_cases[f"F{F}"] = (*cs.synthetic_far_list(grid, F, F - 600, seed=F, dev="cuda"),
                         pose[:3, 3].contiguous(), true, true)
K = scfg.max_clusters
CH = kernels.K9_CHUNK
grid_f = np.array([*grid.origin, grid.voxel_size], np.float32)
gates = np.array([dyn.cls_min_points, dyn.cls_max_distance, dyn.cls_max_size,
                  dyn.cls_max_explore_distance], np.float32)
k9 = {}
for case, (fi, fv, lab, tot, sp, b1, b2) in k9_cases.items():
    F = fi.shape[0]
    scratch = torch.empty(3 * CH * -(-F // CH), dtype=torch.float32, device="cuda")
    k9[case] = {}
    ref = None
    for name, lib in k9_libs.items():
        outs = torch.zeros(26 * K + K, dtype=torch.float32, device="cuda")
        def call(lib=lib, outs=outs):
            err = lib.vofod_cluster_stats(
                fi.data_ptr(), fv.data_ptr(), lab.data_ptr(), F, K, grid.ny, grid.nx,
                grid_f.ctypes.data, gates.ctypes.data, sp.data_ptr(), b1.data_ptr(),
                b2.data_ptr(), tot.data_ptr(), outs.data_ptr(), scratch.data_ptr(),
                4 * scratch.numel(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        call()
        # StatsOut's layout (csrc/classify_stats.cu carve): 22 K floats, then
        # reps, npts, m_k and rep_sel as int32 [4, K]
        ints = outs[22 * K:26 * K].view(torch.int32).clone()
        ms, n = device_ms(call)
        k9[case][name] = dict(device_ms=ms, launches=n,
                              ints_equal=True if ref is None else bool(torch.equal(ints, ref)))
        ref = ints if ref is None else ref
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip())
print(json.dumps(dict(dda_probe=res, rays=R, steps=steps, k9_probe=k9)))

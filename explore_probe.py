#!/usr/bin/env python3
"""Diagnosis of K7 (the explore BFS) and K8 (the demotion) on one card:
variants of csrc/explore.cu, built by text substitution and timed side by
side on the calls the step makes.

    python3 explore_probe.py PARENT_DIR [VARIANT ...]

Run from the root of the tree that committed this script, with PARENT_DIR a
checkout of commit b0eb04b (``git archive b0eb04b`` unpacked into a
git-ignored directory): the tree whose K7 loaded a query's submap one row a
warp at a time and swept it in shared memory, and whose K8 walked all Q
queries for each of its slots.  The text edits match those two trees'
``csrc/explore.cu`` exactly and raise on any other source, so the script
applies to that pair only.  Each variant is built alone under build/probe
(one ``nvcc`` each, started together) and called through its C entry
points.  Variants (VARIANT names select some; all by default):

- parent, change: the two trees' sources;
- *_load_only: K7 loads the submap and stores its rows, with no sweep and
  no closure (unchecked: what the load costs);
- *_verdict_only: K8 decides and returns, with no store (unchecked);
- change_warps4, change_warps16: K7's planes on 4 warps of 8 planes or 16
  warps of 2 (the tree's: 8 of 4); change_warps4_rows32: 4 warps with 32
  rows in flight, this tree's first schedule;
- change_rows8, change_rows32: K7's warps with 8 or 32 submap rows in
  flight (the tree's: 16);
- change_demote_t128: K8 on 128-thread blocks (the tree's: 256);
- change_cp_async: K7's load as 4-byte ``cp.async`` copies of each warp's
  rows into shared memory (128 KB a block), then the ballots on shared
  memory.

Every K7 variant also runs with ``max_iters = 0`` (the load and the
closure, no sweep).  Cases: the calls of the 7th to 11th flagship scans
of a fresh node after the apriori plane (the scans chip_smoke's phase 5
profiles; the 7th sweep scan has no valid query), as the step makes them
(``kernels.explore`` and ``kernels.demote_`` recorded): the sweep step's K7
and K8 and the exact step's K7, each scan's and their mean; and a batch of 256 valid queries on a random field whose
unconnected queries all demote (chip_smoke's K8 case).  Each checked call
is held bit-equal to the plain version (K7: ``explore_plain``; K8:
``demote_floating_plain``, the grid and the count, and the change's
``cluster_connected`` to the plain ``any``); K8 runs on a fresh copy of its
grid every call.  Per case: the slowest valid query's Jacobi sweeps and the
valid queries' mean (``explore_planes_plain``).  Prints the card's name
and power limit, then one JSON line: per variant and case the device ms a
call of the variant's kernel (torch.profiler, 20 calls), its launches and
memsets a call and the CUDA-event ms.  Needs one GPU.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")
import chip_smoke as cs
from vofod_tpu_torch import kernels
from vofod_tpu_torch.config import DynParams
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.ops.explore import (
    demote_floating_plain, explore_plain, explore_planes_plain)
from vofod_tpu_torch.runtime.node import NodeOptions, VoFOD

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def edit(src, pairs):
    for a, b in pairs:
        if src.count(a) != 1:
            raise RuntimeError(f"probe: {a!r} found {src.count(a)} times")
        src = src.replace(a, b)
    return src


PAR_SWEEPS = "  __syncthreads();\n  return bfs_sweeps<W>(bound, S, max_iters, expandable, ground, cur, nxt);\n}"
PAR_VERDICT = "  if (!__syncthreads_or(floats)) return;\n"
CHG_LOADED = "  // the submap is loaded\n"
CHG_VERDICT = "  if (!__syncthreads_or(floats)) return;  // the verdict\n"


def variants(par: str, chg: str) -> dict:
    out = {
        "parent": par,
        "parent_load_only": edit(par, [(PAR_SWEEPS, "  __syncthreads();\n  return false;\n}")]),
        "parent_verdict_only": edit(par, [(PAR_VERDICT, (
            "  if (__syncthreads_or(floats) && threadIdx.x == 0 && S < 0) n_writes[1] = 1;\n"
            "  return;\n"))]),
    }
    if chg == par:  # this tree still holds the parent's kernels
        return out
    out.update({
        "change": chg,
        "change_load_only": edit(chg, [(CHG_LOADED, (
            "  for (int j = 0; j < EXPLORE_PLANES; ++j)\n"
            "    if (warp * EXPLORE_PLANES + j < S && lane < S)\n"
            "      rout[(warp * EXPLORE_PLANES + j) * S + lane] = expd[j] | gnd[j];\n"
            "  return;\n"))]),
        "change_verdict_only": edit(chg, [(CHG_VERDICT, (
            "  if (__syncthreads_or(floats) && threadIdx.x == 0 && S < 0) n_writes[1] = 1;\n"
            "  return;\n"))]),
        "change_warps4": edit(chg, [WARPS4]),
        "change_warps4_rows32": edit(chg, [WARPS4, ROWS32]),
        "change_warps16": edit(chg, [WARPS16]),
        "change_rows8": edit(chg, [("constexpr int LOAD_ROWS = 16;",
                                    "constexpr int LOAD_ROWS = 8;")]),
        "change_rows32": edit(chg, [ROWS32]),
        "change_demote_t128": edit(chg, [("constexpr int DEMOTE_T = 256;",
                                          "constexpr int DEMOTE_T = 128;")]),
        "change_cp_async": edit(chg, CP_ASYNC),
    })
    return out


WARPS4 = ("constexpr int EXPLORE_WARPS = 8;", "constexpr int EXPLORE_WARPS = 4;")
WARPS16 = ("constexpr int EXPLORE_WARPS = 8;", "constexpr int EXPLORE_WARPS = 16;")
ROWS32 = ("constexpr int LOAD_ROWS = 16;", "constexpr int LOAD_ROWS = 32;")
# K7's load as 4-byte cp.async copies of each warp's rows into shared memory
# (128 KB a block), then the ballots on shared memory
CP_ASYNC = [(
    """#pragma unroll
  for (int j = 0; j < EXPLORE_PLANES; ++j) {
    expd[j] = 0;
    gnd[j] = 0;
    const int lz = z0 + zw + j - z_lo;  // the row's plane in the buffer
    if (zw + j >= S) continue;          // warp-uniform
    const bool z_in = lz >= 0 && lz < nz;
    for (int yc = 0; yc < S; yc += LOAD_ROWS) {
      float v[LOAD_ROWS];
#pragma unroll
      for (int b = 0; b < LOAD_ROWS; ++b) {
        const int gy = y0 + yc + b;
        v[b] = -1e30f;  // outside the grid or the buffer: certain air
        if (x_in && z_in && yc + b < S && gy >= 0 && gy < ny)
          v[b] = __ldg(grid + ((size_t)lz * ny + gy) * nx + gx);
      }
#pragma unroll
      for (int b = 0; b < LOAD_ROWS; ++b) {
        const uint32_t bu = __ballot_sync(0xffffffffu, v[b] > thr_f && v[b] <= thr_g);
        const uint32_t bg = __ballot_sync(0xffffffffu, v[b] > thr_g);
        if (lane == yc + b) {
          expd[j] = bu;
          gnd[j] = bg;
        }
      }
    }
  }
""", """  extern __shared__ float box[];  // each warp's rows: [PLANES][32][32]
  float* wbox = box + warp * EXPLORE_PLANES * 32 * 32;
#pragma unroll
  for (int j = 0; j < EXPLORE_PLANES; ++j) {
    const int lz = z0 + zw + j - z_lo;
    if (zw + j >= S) continue;
    const bool z_in = lz >= 0 && lz < nz;
    for (int y = 0; y < S; ++y) {
      const int gy = y0 + y;
      float* dst = wbox + (j * 32 + y) * 32 + lane;
      if (x_in && z_in && gy >= 0 && gy < ny) {
        const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(d),
                     "l"(grid + ((size_t)lz * ny + gy) * nx + gx));
      } else {
        *dst = -1e30f;
      }
    }
  }
  asm volatile("cp.async.wait_all;\\n" ::: "memory");
  __syncwarp();
#pragma unroll
  for (int j = 0; j < EXPLORE_PLANES; ++j) {
    expd[j] = 0;
    gnd[j] = 0;
    if (zw + j >= S) continue;
    for (int y = 0; y < S; ++y) {
      const float v = wbox[(j * 32 + y) * 32 + lane];
      const uint32_t bu = __ballot_sync(0xffffffffu, v > thr_f && v <= thr_g);
      const uint32_t bg = __ballot_sync(0xffffffffu, v > thr_g);
      if (lane == y) {
        expd[j] = bu;
        gnd[j] = bg;
      }
    }
  }
"""), ("""    explore_planes_kernel<<<Q, EXPLORE_WARPS * 32, 0, s>>>(""",
       """    const size_t box = (size_t)EXPLORE_WARPS * EXPLORE_PLANES * 32 * 32 * sizeof(float);
    if (const int e = allow_smem(explore_planes_kernel, box)) return e;
    explore_planes_kernel<<<Q, EXPLORE_WARPS * 32, box, s>>>(""")]


def build(srcs: dict) -> dict:
    out_dir = Path("build/probe")
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._nvcc()
    jobs = {}
    for name, src in srcs.items():
        (out_dir / f"{name}.cu").write_text(src)
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-shared", "-I", str(kernels._CSRC), "-o",
               str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs, regs = {}, {}
    for name, job in jobs.items():
        log = job.communicate()[0]
        if job.returncode != 0:
            raise RuntimeError(f"nvcc {name}: {log[-3000:]}")
        regs[name] = {}  # K7's and K8's kernels: ptxas's registers line
        fn = None
        for ln in log.splitlines():
            if "Compiling entry" in ln:
                fn = next((k for k in ("explore_planes_kernel", "explore_kernel",
                                       "demote_kernel") if f"{len(k)}{k}" in ln), None)
            elif "registers" in ln and fn:
                regs[name][fn] = ln.split(":", 1)[1].strip()
                fn = None
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        change = name.startswith("change")
        # the change's entry points take K8's count (K7 zeroes it) and K8's
        # cluster_connected
        lib.vofod_explore.argtypes = ([_P, _I, _I, _I, _I, _I] + [_P] * 5 + [_F, _F, _I, _I, _I]
                                      + [_P] * (5 if change else 4))
        lib.vofod_demote.argtypes = ([_P, _I, _I, _I, _I, _I, _P, _P, _I] + [_P] * 5
                                     + [_I, _I, _F] + [_P] * (3 if change else 2))
        libs[name] = lib
    return libs, regs


def step_calls(lut, cfg, opts, first=7, n=5):
    """[(kernels.explore args, kernels.demote_ args)] of scans first ..
    first + n - 1 of a fresh node (chip_smoke's phase 5 profiles scans 7-11)."""
    node = VoFOD(cfg, DynParams(), opts, lut, device="cuda")
    node.load_apriori_map(cs.apriori_ground())
    scans = cs.scan_cycle(lut, first - 1 + n)
    for r, p in scans[:first - 1]:
        node.process_scan(r, None, p)
    names = ("explore", "demote_")
    orig, got = {k: getattr(kernels, k) for k in names}, {}

    def recorder(name):
        def record(*a):
            got[name] = tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in a)
            return orig[name](*a)
        return record

    out = []
    for k in names:
        setattr(kernels, k, recorder(k))
    try:
        for r, p in scans[first - 1:]:
            node.process_scan(r, None, p)
            torch.cuda.synchronize()
            out.append((got["explore"], got["demote_"]))
    finally:
        for k in names:
            setattr(kernels, k, orig[k])
    return out


def random_batch(lut):
    """chip_smoke's K8 case: 256 valid queries on a random field, the
    connected ones in slot 0, the others spread over the other slots (all
    gated), so those demote."""
    cfg, dyn = cs.VoFODConfig(), DynParams()
    grid = GridSpec.from_config(cfg)
    dev = torch.device("cuda")
    S, K, Q = cfg.explore_submap, cfg.max_clusters, cfg.max_queries
    thr_f, thr_g = dyn.thr_frontiers, dyn.thr_new_obstacles
    field = cs._random_field(grid, dyn, 7, dev)
    g = torch.Generator(device=dev).manual_seed(8)
    unk_ids = torch.nonzero(field.reshape(-1) > thr_f)[:, 0]
    pick = unk_ids[torch.randint(0, unk_ids.shape[0], (Q,), generator=g, device=dev)]
    rq = [t.to(torch.int32) for t in grid.unflatten_id(pick)]
    rvalid = torch.ones(Q, dtype=torch.bool, device=dev)
    rmm = torch.randint(0, 20, (Q,), generator=g, device=dev, dtype=torch.int32)
    k7 = (field, *rq, rvalid, rmm, thr_f, thr_g, S, 96, None)
    kc, kr, kco = explore_plain(grid, field, *rq, rvalid, rmm, thr_f, thr_g, S)
    slot_ids = torch.where(kc, 0, 1 + torch.arange(Q, device=dev) % (K - 1))
    sslot = slot_ids[:, None] == torch.arange(K, device=dev)[None, :]
    gate = torch.ones(K, dtype=torch.bool, device=dev)
    no_ovf = torch.zeros((), dtype=torch.bool, device=dev)
    return k7, (field, kr, kco, sslot, kc, rvalid, gate, no_ovf, thr_f, None)


def profiled(fn, match: str, reps: int = 20) -> dict:
    """Device ms a call of the kernels whose name holds ``match``, their
    launches and the memsets a call (up to three profiler sessions: one now
    and then records no device event)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        mine = [e for e in ev if match in e.name]
        if mine:
            break
    us = sum(float(getattr(e, "device_time", None) or getattr(e, "cuda_time", 0.0))
             for e in mine)
    return dict(device_ms=round(us / reps / 1e3, 5), launches=len(mine) / reps,
                memsets=sum("memset" in e.name.lower() for e in ev) / reps)


def k7_call(lib, name, a, max_iters=None):
    vmap, qx, qy, qz, qvalid, mm, thr_f, thr_g, S, iters, zw = a
    Q, dev = qx.shape[0], vmap.device
    z_lo, nz_g = kernels._z_window(vmap, zw)
    out = (torch.empty(Q, dtype=torch.bool, device=dev),
           torch.empty((Q, S, S), dtype=torch.int64, device=dev),
           torch.empty((Q, 3), dtype=torch.int32, device=dev),
           torch.empty((), dtype=torch.int32, device=dev))
    extra = [out[3].data_ptr()] if name.startswith("change") else []

    def launch():
        err = lib.vofod_explore(
            vmap.data_ptr(), *vmap.shape, z_lo, nz_g, qx.data_ptr(), qy.data_ptr(),
            qz.data_ptr(), qvalid.data_ptr(), mm.data_ptr(), float(thr_f), float(thr_g), Q, S,
            int(iters if max_iters is None else max_iters), *(t.data_ptr() for t in out[:3]),
            *extra, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return out
    return launch


def k8_call(lib, name, a):
    vmap, reached, corners, qslot, connected, qvalid, qgate, ovf, thr, zw = a
    Q, S, K = reached.shape[0], reached.shape[1], qgate.shape[0]
    z_lo, nz_g = kernels._z_window(vmap, zw)
    work = vmap.clone()
    n_writes = torch.zeros((), dtype=torch.int32, device=vmap.device)
    conn = torch.empty(K, dtype=torch.bool, device=vmap.device)
    extra = [conn.data_ptr()] if name.startswith("change") else []

    def launch():
        work.copy_(vmap)  # a fresh grid every call: every demotion stores
        err = lib.vofod_demote(
            work.data_ptr(), *work.shape, z_lo, nz_g, reached.data_ptr(), corners.data_ptr(), S,
            qslot.data_ptr(), connected.data_ptr(), qvalid.data_ptr(), qgate.data_ptr(),
            ovf.data_ptr(), Q, K, float(thr), n_writes.data_ptr(), *extra,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return work, n_writes, conn
    return launch


def main() -> int:
    par = (Path(sys.argv[1]) / "vofod_tpu_torch/csrc/explore.cu").read_text()
    chg = Path("vofod_tpu_torch/csrc/explore.cu").read_text()
    srcs = variants(par, chg)
    if sys.argv[2:]:
        srcs = {k: v for k, v in srcs.items() if k in sys.argv[2:]}
    libs, regs = build(srcs)

    lut = cs.make_lut(cs.VoFODConfig().sensor)
    grid = GridSpec.from_config(cs.VoFODConfig())
    sweep = step_calls(lut, cs.VoFODConfig(), NodeOptions())
    exact = step_calls(lut, cs.exact_config(), NodeOptions(raycast_mode="exact"))
    rnd_k7, rnd_k8 = random_batch(lut)
    k7_cases = {**{f"sweep scan {7 + i}": c[0] for i, c in enumerate(sweep)},
                **{f"exact scan {7 + i}": c[0] for i, c in enumerate(exact)},
                "random 256": rnd_k7}
    k8_cases = {**{f"sweep scan {7 + i}": c[1] for i, c in enumerate(sweep)},
                "random 256": rnd_k8}

    res = {"k7": {}, "k8": {}, "registers": regs}
    for case, a in k7_cases.items():
        vmap, qx, qy, qz, qvalid, mm, thr_f, thr_g, S, iters, zw = a
        want = explore_plain(grid, vmap, qx, qy, qz, qvalid, mm, thr_f, thr_g, S, iters, zw)
        sweeps = explore_planes_plain(grid, vmap, qx, qy, qz, qvalid, mm, thr_f, thr_g, S, iters,
                                      zw)[3][qvalid]
        row = dict(valid_queries=int(qvalid.sum()), connected=int(want[0].sum()),
                   max_sweeps=int(sweeps.max()) if sweeps.numel() else 0,
                   mean_sweeps=float(sweeps.float().mean()) if sweeps.numel() else 0.0)
        for name, lib in libs.items():
            if "verdict_only" in name:
                continue
            fn = k7_call(lib, name, a)
            got = fn()
            if "load_only" not in name and not all(
                    torch.equal(x, y) for x, y in zip(got[:3], want)):
                raise AssertionError(f"K7 {name} {case}: differs from explore_plain")
            row[name] = dict(**profiled(fn, "explore"), ms=cs.cuda_ms(fn))
            if "load_only" not in name:
                row[name + " max_iters=0"] = profiled(k7_call(lib, name, a, 0), "explore")
        res["k7"][case] = row
    for case, a in k8_cases.items():
        want_grid, want_n = demote_floating_plain(*a)[:2]
        want_conn = torch.any(a[3] & a[4][:, None], dim=0)
        row = dict(demotion_writes=int(want_n),
                   demoted_voxels=int((want_grid != a[0]).sum()))
        for name, lib in libs.items():
            if "load_only" in name:
                continue
            fn = k8_call(lib, name, a)
            grid_out, n, conn = fn()
            if "verdict_only" not in name and not (
                    torch.equal(grid_out, want_grid) and int(n) == int(want_n)
                    and (not name.startswith("change") or torch.equal(conn, want_conn))):
                raise AssertionError(f"K8 {name} {case}: differs from demote_floating_plain")
            row[name] = dict(**profiled(fn, "demote"), ms=cs.cuda_ms(fn))
        res["k8"][case] = row
    # a scan's K7 and K8 in each path: the mean over the five scans
    for k, path in (("k7", "sweep"), ("k7", "exact"), ("k8", "sweep")):
        rows = [r for c, r in res[k].items() if c.startswith(path + " scan")]
        res[k][path + " scans 7-11 mean"] = {
            n: round(sum(r[n]["device_ms"] for r in rows) / len(rows), 5)
            for n in rows[0] if isinstance(rows[0][n], dict)}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(json.dumps(res))  # short enough for the end of a log
    return 0


if __name__ == "__main__":
    sys.exit(main())

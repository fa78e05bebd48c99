#!/usr/bin/env python3
"""Diagnosis of K11's demotion EMA and K13c on one card: variants of
csrc/ema.cu (with csrc/ball_pool.cuh), built by text substitution and timed
side by side in the cases of ``chip_ab.py --demote-only``.

    python3 demote_probe.py [VARIANT ...]

Run from the root of a tree whose ema.cu runs both kernels on K1's
run-table pool (the text edits match that source and raise on any other).
Each variant's ema.cu is built alone into a shared library under
build/probe (one ``nvcc`` each, started together) and called through its C
entry points with the arguments ``kernels.demote_ema`` /
``kernels.exact_demote_ema`` pass; every call is checked bit-equal to the
plain version.  Variants:

- base: the tree's source;
- lb3: the demotion kernels at 3 resident blocks an SM
  (``__launch_bounds__(256, 3)``);
- combined: the staged value built at the load (one register a cell; the
  load's consumer then waits for both loads in the same step);
- noskip: no block skips its pool (the tree's skip a chunk that stages
  nothing but 0), at K1's z chunk;
- k1chunk: K1's z chunk from the occupancy (6 planes at the flagship
  radius; the tree's: 3 up to halo 3); z3, z4, z9, z13: a fixed z chunk;
- ty8, ty32: int8 column tiles of 8 or 32 rows (the tree's 16);
- nogridconst: the run table a plain kernel parameter (the compiler copies
  the tiny table to local memory, 104 bytes a thread);
- k11_no_grid_io, k11_one_load, k11_no_stage_load, k11_no_loads: K11
  without the grid's load and store, staging bg alone, staging a pattern
  with no load, both (not the kernel's function: unchecked, what each part
  costs).

Cases: the inputs the step passes (``chip_ab.DEMOTE_INPUTS``: the calls of
the 7th flagship scan): (a) the sweep step's demotion, r 1.6; (b) the
dynamic step's shells at 2.0 / 1.9 m; (c) (a)'s inputs at halo 7, r 7.99;
(d) K13c of the exact step, leaf size 1; (e) the exact step's at 1.2 m,
leaf size 2; (f) the grid-exact step's on shard 1 of 3; "a dense": (a) on
random masks (2 % bg, half of it safe), "c dense" the same at halo 7, "d
dense": (d) on random coarse cells (5 % occupied, a third of them unsure),
every tile busy.
Prints the card's name and power limit, then one JSON line: per variant
and case the device ms a call (torch.profiler, 20 calls), the CUDA-event ms
and the schedule.  Needs one GPU.
"""

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_ab
import chip_smoke as cs
from vofod_tpu_torch import kernels
from vofod_tpu_torch.ops import morphology as tm
from vofod_tpu_torch.pipeline import sepclusters as ts

CSRC = Path("vofod_tpu_torch/csrc")
OUT = Path("build/probe")
LB = "__global__ void __launch_bounds__(Lanes<int8_t>::TXU* Lanes<int8_t>::TY)"
K11_RAW = ("""  struct Raw {
    uint8_t bg, safe;
  };
  Raw none;  // {0, 0}: 0 outside the grid""", """  using Raw = int8_t;
  Raw none;""")
K11_LOAD = ("""    return {__ldg(bg + i), __ldg(safe + i)};
  }
  __device__ __forceinline__ int8_t stage(Raw r) const {
    return (int8_t)(r.bg != 0 && r.safe == 0);
  }""", """    return (int8_t)((__ldg(bg + i) != 0) & (__ldg(safe + i) == 0));
  }
  __device__ __forceinline__ int8_t stage(Raw r) const { return r; }""")
K13_RAW = ("""  struct Raw {
    uint8_t occ;
    int32_t census;
  };
  Raw none;  // {0, 0}: no centre""", """  using Raw = int8_t;
  Raw none;""")
K13_LOAD = ("""    return {__ldg(occ_c + i), __ldg(census + i)};
  }
  __device__ __forceinline__ int8_t stage(Raw r) const {
    return (int8_t)(r.occ != 0 && !((float)r.census >= c.min_sure));
  }""", """    return (int8_t)((__ldg(occ_c + i) != 0) & !((float)__ldg(census + i) >= c.min_sure));
  }
  __device__ __forceinline__ int8_t stage(Raw r) const { return r; }""")
LB3 = [(LB + "\n    " + k, LB.replace("TY)", "TY, 3)") + "\n    " + k)
       for k in ("demote_ema_kernel", "exact_demote_kernel")]
COMBINED = [K11_RAW, K11_LOAD, K13_RAW, K13_LOAD]
SKIP_ON = "  static constexpr bool SKIP = true;"
NOSKIP = [(SKIP_ON, SKIP_ON.replace("true", "false"))] * 2  # SKIP off: K1's chunk too
ZCHUNK = ("  return (nz + chunks - 1) / chunks;", "  return {0} < nz ? {0} : nz;")
K1_CHUNK = ("constexpr int SKIP_ZCHUNK = 3, SKIP_HALO = 3;",
            "constexpr int SKIP_ZCHUNK = 3, SKIP_HALO = -1;")
K11_NO_GRID_IO = [("    load8(vals + g, n, v);", "    for (int j = 0; j < 8; ++j) v[j] = 0.0f;"),
                  ("    store8(out + g, n, v);",
                   "    if (lane_s16(pooled, 0) == 77) store8(out + g, n, v);")]
TILE = ("NW = 4, VX = 8, TXU = 16, TY = 16, SW = 48;",
        "NW = 4, VX = 8, TXU = 16, TY = {0}, SW = 48;")
VARIANTS = {
    "base": ([], []),
    "lb3": (LB3, []),
    "combined": (COMBINED, []),
    "noskip": (NOSKIP, []),
    "k1chunk": ([], [K1_CHUNK]),
    "z3": ([], [(ZCHUNK[0], ZCHUNK[1].format(3)), K1_CHUNK]),
    "z4": ([], [(ZCHUNK[0], ZCHUNK[1].format(4)), K1_CHUNK]),
    "z9": ([], [(ZCHUNK[0], ZCHUNK[1].format(9)), K1_CHUNK]),
    "z13": ([], [(ZCHUNK[0], ZCHUNK[1].format(13)), K1_CHUNK]),
    "ty8": ([], [(TILE[0], TILE[1].format(8))]),
    "ty32": ([], [(TILE[0], TILE[1].format(32))]),
    # not the kernel's function (unchecked): K11 without the grid's load and
    # store, staging bg alone
    "k11_no_grid_io": (K11_NO_GRID_IO, []),
    "k11_one_load": ([("return {__ldg(bg + i), __ldg(safe + i)};",
                       "return {__ldg(bg + i), (uint8_t)0};")], []),
    "k11_no_stage_load": ([("return {__ldg(bg + i), __ldg(safe + i)};",
                            "return {(uint8_t)((i & 4095) == 0), (uint8_t)0};")], []),
    "k11_no_loads": ([("return {__ldg(bg + i), __ldg(safe + i)};",
                       "return {(uint8_t)((i & 4095) == 0), (uint8_t)0};")] + K11_NO_GRID_IO, []),
}
NOGRIDCONST = [("const __grid_constant__ Tab tab", "const Tab tab")] * 2
VARIANTS["nogridconst"] = (NOGRIDCONST, [])
UNCHECKED = ("k11_no_grid_io", "k11_one_load", "k11_no_stage_load", "k11_no_loads")


def edit(src, pairs):
    for a, b in pairs:
        n = src.count(a)
        if n == 0:
            raise RuntimeError(f"probe: {a[:60]!r} not found")
        src = src.replace(a, b, 1)
    return src


def build(name, ema_edits, header_edits):
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
    (d / "ball_pool.cuh").write_text(edit((CSRC / "ball_pool.cuh").read_text(), header_edits))
    (d / "ema.cu").write_text(edit((CSRC / "ema.cu").read_text(), ema_edits))
    so = d / f"libprobe_{name}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so), str(d / "ema.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"probe {name}: nvcc failed\n{res.stdout}{res.stderr}")
    log = res.stdout.splitlines() + res.stderr.splitlines()
    regs = [ln.split("Used ")[1].split(" registers")[0] + "/" + ln0.split(" bytes stack")[0].strip()
            for ln0, ln in zip(log, log[1:]) if "Used" in ln and "registers" in ln]
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vofod_demote_ema.argtypes = [P, P, P, P, I, I, I, P, I, F, F, P, P, P]
    lib.vofod_exact_demote_ema.argtypes = [P, P, P, P, P, I, I, I, I, P, I, P, P, P, P, P, P, P]
    return lib, regs


def main():
    names = sys.argv[1:] or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(len(names)) as pool:
        futs = {n: pool.submit(build, n, *VARIANTS[n]) for n in names}
        libs = {n: f.result() for n, f in futs.items()}
    dev = torch.device("cuda")
    stream = kernels._stream()
    ns = {}
    exec(chip_ab.DEMOTE_INPUTS, ns)
    inputs = ns["demote_inputs"](cs)
    g = torch.Generator(device=dev).manual_seed(15)
    a = inputs["a"][1]
    inputs["a dense"] = ("k11", (a[0], torch.rand(a[0].shape, generator=g, device=dev) < 0.02,
                                 torch.rand(a[0].shape, generator=g, device=dev) < 0.5) + a[3:])
    inputs["c dense"] = ("k11", inputs["a dense"][1][:4] + (7.99,) + a[5:])
    d = inputs["d"][1]
    occ = torch.rand(d[1].shape, generator=g, device=dev) < 0.05
    inputs["d dense"] = ("k13c", (d[0], occ, torch.randint(0, 36, occ.shape, generator=g,
                                                           device=dev, dtype=torch.int32),
                                  torch.ones(2, dtype=torch.bool, device=dev)) + d[4:])
    calls = {}  # case -> (launch(lib, used) -> outputs, plain outputs)
    for name, (kind, args) in inputs.items():
        if kind == "k11":
            v, bg, safe, sure, ball, w1, c = args
            table, out = tm.run_table(ball), torch.empty_like(v)

            def k11(lib, used, v=v, bg=bg, safe=safe, sure=sure, table=table, w1=w1, c=c,
                    out=out):
                nz, ny, nx = v.shape
                err = lib.vofod_demote_ema(v.data_ptr(), bg.data_ptr(), safe.data_ptr(),
                                           sure.data_ptr(), nz, ny, nx, table.blob_ptr,
                                           len(table.blob), w1, c, out.data_ptr(), used, stream)
                if err:
                    raise RuntimeError(f"vofod_demote_ema: {err}")
                return (out,)

            calls[name] = (k11, (ts.demote_ema_plain(*args),))
            continue
        v, o, ce, flags, prev, lsz, radius, min_sure, w1, score, thr, win = args
        table = tm.run_table(radius)
        floats = np.array([min_sure, w1, score, thr], np.float32)
        window = None if win is None else np.array([win[0], win[1], o.shape[0], win[2]], np.int32)
        outs = (torch.empty_like(v), torch.empty(v.shape, dtype=torch.bool, device=dev),
                torch.empty((), dtype=torch.bool, device=dev))

        def k13(lib, used, v=v, o=o, ce=ce, flags=flags, prev=prev, lsz=lsz, table=table,
                floats=floats, window=window, outs=outs):
            nz, ny, nx = v.shape
            err = lib.vofod_exact_demote_ema(
                v.data_ptr(), o.data_ptr(), ce.data_ptr(), flags.data_ptr(), prev.data_ptr(),
                nz, ny, nx, lsz, table.blob_ptr, len(table.blob), floats.ctypes.data,
                None if window is None else window.ctypes.data, outs[0].data_ptr(),
                outs[1].data_ptr(), outs[2].data_ptr(), used, stream)
            if err:
                raise RuntimeError(f"vofod_exact_demote_ema: {err}")
            return outs

        calls[name] = (k13, ts.exact_demote_ema_plain(*args))
    result = {}
    for vn, (lib, regs) in libs.items():
        row = {"registers": regs}
        for case, (fn, want) in calls.items():
            used = (ctypes.c_int * 3)()
            got = fn(lib, used)
            torch.cuda.synchronize()
            if vn not in UNCHECKED and not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"probe {vn} case {case}: differs from the plain version")
            launch = lambda fn=fn, lib=lib: fn(lib, None)  # noqa: E731
            row[case] = dict(ms=round(cs.cuda_ms(launch), 5),
                             device_ms=round(cs.device_profile(launch)["device_ms"], 5),
                             schedule=list(used))
        result[vn] = row
    print(json.dumps(dict(nvidia_smi=smi, variants=result)), flush=True)


if __name__ == "__main__":
    main()

// K3 — scan frontend binning: range x LUT + offset, exclude box (sensor
// frame), SE(3) pose, operation-area crop, clamped flat voxel id, histogram.
//
// Replaces vofod_tpu/pipeline/frontend.py `run_frontend` (front half) and
// vofod_tpu/ops/binning.py `bin_points`, whose 131,072-point scatter-add
// into the 2.47 M-voxel count grid is the step's single most expensive
// XLA op.
//
// Bound on the H100: the atomics' latency and the 2 MB of scan input; the
// 9.9 MB count grid is zeroed by the wrapper and touched only where points
// land.  One thread per pixel: integer atomicAdd into the counts (order
// free, so the histogram is bit-exact) and a warp-aggregated atomic count
// of the valid points.  The point transform is written as explicit
// per-component multiplies and adds in a fixed order with __fmul_rn /
// __fadd_rn, so the compiler cannot contract it into FMAs: the plain
// PyTorch version uses the same order elementwise, and a point near a voxel
// face lands in the same voxel in both.
//
// The kernel also emits, per pixel, the own-airframe mask (a return inside
// the exclude box and the operation area) and the clamped flat id; the
// caller compacts the first 4096 such hits (frontend.py:61-77) and marks
// them as raycast blockers.
#include "common.cuh"

namespace {

struct FrontendParams {
  float excl_lo[3], excl_hi[3];  // exclude box, sensor frame
  float op_lo[3], op_hi[3];      // operation area, world frame
  float origin[3];               // grid origin (world)
  float inv_voxel;
  float range_scale;             // mm -> m
  int nx, ny, nz;
};

__device__ __forceinline__ bool in_box(float x, float y, float z,
                                       const float* lo, const float* hi) {
  // NaN compares false: a NaN point is in no box
  return x >= lo[0] && x <= hi[0] && y >= lo[1] && y <= hi[1] &&
         z >= lo[2] && z <= hi[2];
}

// floor((c - o) * inv) clamped into [0, n - 1] BEFORE the integer cast
// (fmaxf drops a NaN, matching XLA's NaN -> 0 conversion then clip).
__device__ __forceinline__ int clamped_idx(float fl, int n) {
  return (int)fminf(fmaxf(fl, 0.0f), (float)(n - 1));
}

__global__ void frontend_bin_kernel(
    const float* __restrict__ ranges, const float* __restrict__ dirs,
    const float* __restrict__ offs, const float* __restrict__ pose, int n,
    FrontendParams p, int* __restrict__ counts, int* __restrict__ n_valid,
    uint8_t* __restrict__ excl, int* __restrict__ fid_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool valid = false;
  if (i < n) {
    const float r = __fmul_rn(ranges[i], p.range_scale);
    const bool has_return = r > 0.0f;  // NaN: no return
    const float sx = __fadd_rn(__fmul_rn(dirs[3 * i + 0], r), offs[3 * i + 0]);
    const float sy = __fadd_rn(__fmul_rn(dirs[3 * i + 1], r), offs[3 * i + 1]);
    const float sz = __fadd_rn(__fmul_rn(dirs[3 * i + 2], r), offs[3 * i + 2]);
    const bool in_excl = in_box(sx, sy, sz, p.excl_lo, p.excl_hi);
    // world = R @ s + t, row-major 4x4 pose, fixed summation order
    float w[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float* row = pose + 4 * a;
      w[a] = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(row[0], sx), __fmul_rn(row[1], sy)),
                    __fmul_rn(row[2], sz)),
          row[3]);
    }
    const bool in_op = in_box(w[0], w[1], w[2], p.op_lo, p.op_hi);
    valid = has_return && !in_excl && in_op;

    const float fx = floorf(__fmul_rn(__fsub_rn(w[0], p.origin[0]), p.inv_voxel));
    const float fy = floorf(__fmul_rn(__fsub_rn(w[1], p.origin[1]), p.inv_voxel));
    const float fz = floorf(__fmul_rn(__fsub_rn(w[2], p.origin[2]), p.inv_voxel));
    const int ix = clamped_idx(fx, p.nx), iy = clamped_idx(fy, p.ny),
              iz = clamped_idx(fz, p.nz);
    const int fid = (iz * p.ny + iy) * p.nx + ix;
    // in-limits test in the float domain: no cast of an unclamped value
    const bool inb = fx >= 0.0f && fx < (float)p.nx && fy >= 0.0f &&
                     fy < (float)p.ny && fz >= 0.0f && fz < (float)p.nz;
    if (valid && inb) atomicAdd(&counts[fid], 1);
    excl[i] = (has_return && in_op && in_excl) ? 1 : 0;
    fid_out[i] = fid;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, valid);
  if ((threadIdx.x & 31) == 0 && ballot != 0)
    atomicAdd(n_valid, __popc(ballot));
}

}  // namespace

// boxes: host float32[15] = excl_lo[3], excl_hi[3], op_lo[3], op_hi[3],
// origin[3]; pose: device float32 [4, 4].  counts and n_valid are zeroed by
// the caller.  Returns cudaGetLastError().
VOFOD_API int vofod_frontend_bin(const void* ranges, const void* dirs,
                                 const void* offs, const void* pose, int n,
                                 const float* boxes, float inv_voxel,
                                 float range_scale, int nz, int ny, int nx,
                                 void* counts, void* n_valid, void* excl,
                                 void* fid_out, void* stream) {
  FrontendParams p;
  for (int a = 0; a < 3; ++a) {
    p.excl_lo[a] = boxes[a];
    p.excl_hi[a] = boxes[3 + a];
    p.op_lo[a] = boxes[6 + a];
    p.op_hi[a] = boxes[9 + a];
    p.origin[a] = boxes[12 + a];
  }
  p.inv_voxel = inv_voxel;
  p.range_scale = range_scale;
  p.nx = nx;
  p.ny = ny;
  p.nz = nz;
  const int threads = 256;
  frontend_bin_kernel<<<(n + threads - 1) / threads, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ranges), static_cast<const float*>(dirs),
      static_cast<const float*>(offs), static_cast<const float*>(pose), n, p,
      static_cast<int*>(counts), static_cast<int*>(n_valid),
      static_cast<uint8_t*>(excl), static_cast<int*>(fid_out));
  return (int)cudaGetLastError();
}

// K10 — detection windows: confidence, detection probability, covariance
// and ids of the K cluster slots.
//
// Replaces vofod_tpu/parallel/gridops.py `DenseOps.submaps3` and
// vofod_tpu/pipeline/detect.py `extract_detections`: per slot, the AABB
// corners to voxel indices, inflated by 2 and clamped to the grid; a CS^3
// window (CS = 16 at the flagship) around the box centre; the uncertainty
// sum of 1 - v / score_ray over the window voxels inside the box, member
// voxels (far and carrying the slot's label) counting as free air;
// confidence = exp(-sum / n_points) for mav slots; the detection
// probability from the angular resolutions; covariance sqrt(dist) * sigma
// * I; ids from a counter over the mav slots.
//
// Bound on the H100: latency.  The work is at most K x CS^3 = 32 x 4,096
// voxel reads, but only a mav slot whose window centre lies in the owned z
// rows keeps a confidence (1 of 32 slots on the flagship scans), and its
// in-box voxels are the box ∩ window, a few hundred for a drone-sized box.
// The JAX form pads three full grids (vals 9.9 MB, far 2.5 MB, labels
// 9.9 MB) every scan only to gather these windows.  Here one block per slot
// computes the slot's box, valid, ids, pdet and covariance from its own
// scalars, loaded together before any window load; a slot that keeps no
// confidence reads nothing more.  A slot that does walks only its box ∩
// window, a row (z, y) on P lanes (the power of two at or above the row's
// width, at most 32), so a warp covers 32 / P contiguous rows a step and
// DET_WARPS warps cover DET_WARPS x 32 / P rows; each thread issues
// DET_BATCH voxels' loads of vals, far and labels before their adds
// (out-of-grid reads take the fills 0 / False / INT_MAX, as submaps3's
// padding), then a shuffle tree in each warp and the same tree over the
// warps.  The ids come from one ballot over the slots' classes; block 0
// also writes the new counter.  One launch, no memset.
//
// Arithmetic, fixed so that the plain PyTorch version (pipeline/detect.py
// detect_slots_plain) reproduces it bit for bit: the index math as
// GridSpec.coord_to_idx and geometry.to_int32, the int32 inflation with
// wrap-around, division by a constant as a multiply by its float32
// reciprocal (as PyTorch's CUDA division does), the distance as
// sqrt((dx dx + dy dy) + dz dz), expf and atanf as PyTorch's CUDA ops call
// them, and the window sum in this kernel's order (thread (w, lane) adds
// its voxels left to right, then the two shuffle trees), which the plain
// version replays (window_sums_plain) instead of torch.sum.
#include "common.cuh"

namespace {

constexpr int DET_WARPS = 4;  // pipeline/detect.py DET_WARPS: the sum's order
constexpr int DET_T = DET_WARPS * 32;
constexpr int DET_BATCH = 4;  // voxels whose loads a thread issues before its adds
constexpr int CLS_MAV = 1;

struct DetF {
  float ox, oy, oz, inv_vs;  // GridSpec.coord_to_idx
  float score, inv_score;    // pipeline/detect.py DetectConsts
  float inv_v, inv_h, sigma;
};

struct DetI {
  int nz, ny, nx, K, CS;
  int z_lo, nz_buf;        // the grids hold the z rows [z_lo, z_lo + nz_buf)
  int own_z0, own_z1;      // slots whose window centre lies here keep their confidence
};

// geometry.to_int32 of floor((v - o) * inv): NaN -> 0, saturating
__device__ __forceinline__ int to_idx(float v, float o, float inv) {
  float f = floorf(__fmul_rn(__fsub_rn(v, o), inv));
  if (f != f) return 0;
  f = fminf(fmaxf(f, -2147483648.0f), 2147483520.0f);
  return (int)f;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// torch.clamp(v, min=lo) / (v, max=hi): NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_max(float v, float hi) { return v != v ? v : fminf(v, hi); }

// int32 add that wraps like torch's
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned int)a + (unsigned int)b);
}

// The uncertainty sum of slot k's box ∩ window (b0: its low corner, nw: its
// extent, x y z), in this block's order; every thread returns the block's
// sum.
__device__ float window_sum(const float* __restrict__ vals, const uint8_t* __restrict__ far,
                            const int32_t* __restrict__ labels, const DetI& n, const DetF& f,
                            const int b0[3], const int nw[3], int rep) {
  __shared__ float part[DET_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = nw[1] * nw[2];  // rows (z, y)
  int P = 1;                    // lanes a row
  while (P < nw[0] && P < 32) P <<= 1;
  const int G = 32 / P, C = (nw[0] + P - 1) / P;  // rows a warp step, x chunks a row
  const int s = lane / P, xo = lane - s * P;
  const int first = warp * G + s, step = DET_WARPS * G;
  const int items = first < R ? (R - first + step - 1) / step * C : 0;
  float acc = 0.0f;
  for (int e0 = 0; e0 < items; e0 += DET_BATCH) {
    float v[DET_BATCH];
    bool fv[DET_BATCH], ok[DET_BATCH];
    int lab[DET_BATCH];
#pragma unroll
    for (int b = 0; b < DET_BATCH; ++b) {
      const int e = e0 + b, i = e / C;
      const int r = first + i * step, xoff = (e - i * C) * P + xo;
      ok[b] = e < items && xoff < nw[0];
      v[b] = 0.0f;  // submaps3 fills: 0 / False / INT_MAX
      fv[b] = false;
      lab[b] = 2147483647;
      const int gz = b0[2] + r / max(nw[1], 1), gy = b0[1] + r % max(nw[1], 1);
      const int gx = b0[0] + xoff, lz = gz - n.z_lo;
      if (ok[b] && gx >= 0 && gx < n.nx && gy >= 0 && gy < n.ny && gz >= 0 && gz < n.nz &&
          lz >= 0 && lz < n.nz_buf) {
        const size_t g = ((size_t)lz * n.ny + gy) * n.nx + gx;
        v[b] = vals[g];
        fv[b] = far[g] != 0;
        lab[b] = labels[g];
      }
    }
#pragma unroll
    for (int b = 0; b < DET_BATCH; ++b) {
      const float v_eff = (fv[b] && lab[b] == rep) ? f.score : v[b];  // members count as air
      if (ok[b]) acc = __fadd_rn(acc, __fsub_rn(1.0f, __fmul_rn(v_eff, f.inv_score)));
    }
  }
  for (int o = 16; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, o));
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  float sum = lane < DET_WARPS ? part[lane] : 0.0f;
  for (int o = DET_WARPS / 2; o > 0; o >>= 1)
    sum = __fadd_rn(sum, __shfl_down_sync(0xffffffffu, sum, o));
  return __shfl_sync(0xffffffffu, sum, 0);
}

__global__ void __launch_bounds__(DET_T)
    detect_kernel(const float* __restrict__ vals, const uint8_t* __restrict__ far,
                  const int32_t* __restrict__ labels, const float* __restrict__ aabb_min,
                  const float* __restrict__ aabb_max, const int32_t* __restrict__ reps,
                  const int32_t* __restrict__ npts, const int32_t* __restrict__ cls,
                  const float* __restrict__ obb_center, const float* __restrict__ sensor,
                  const int32_t* __restrict__ det_counter, DetI n, DetF f,
                  uint8_t* __restrict__ valid, int32_t* __restrict__ ids,
                  float* __restrict__ confidence, float* __restrict__ pdet,
                  float* __restrict__ cov, int32_t* __restrict__ new_counter) {
  const int k = blockIdx.x, lane = threadIdx.x;
  const float o[3] = {f.ox, f.oy, f.oz};
  const int lim[3] = {n.nx - 1, n.ny - 1, n.nz - 1};
  const int half = n.CS / 2;
  // the slot's scalars, loaded together before the window: its box, class
  // and label; warp 0 the classes of the ballot, thread 0 the rest
  float amin[3], amax[3];
  for (int a = 0; a < 3; ++a) {
    amin[a] = aabb_min[3 * k + a];
    amax[a] = aabb_max[3 * k + a];
  }
  const bool mav = cls[k] == CLS_MAV;
  const int rep = reps[k];
  int before = 0, total = 0;
  if (threadIdx.x < 32) {  // the ids: one ballot over the slots' classes a word of 32
    for (int q0 = 0; q0 < n.K; q0 += 32) {
      const uint32_t m = __ballot_sync(0xffffffffu, q0 + lane < n.K && cls[q0 + lane] == CLS_MAV);
      total += __popc(m);
      if (k >= q0) before += __popc(k - q0 >= 32 ? m : m & ((1u << (k - q0)) - 1u));
    }
  }
  float ctr_o[3] = {}, sens[3] = {};
  int n_pts = 0, counter = 0;
  if (threadIdx.x == 0) {
    for (int a = 0; a < 3; ++a) {
      ctr_o[a] = obb_center[3 * k + a];
      sens[a] = sensor[a];
    }
    n_pts = npts[k];
    counter = det_counter[0];
  }
  int b0[3], nw[3], ctr_z = 0;
  for (int a = 0; a < 3; ++a) {
    const int lo = clampi(wrap_add(to_idx(amin[a], o[a], f.inv_vs), -2), 0, lim[a]);
    const int hi = clampi(wrap_add(to_idx(amax[a], o[a], f.inv_vs), 2), 0, lim[a]);
    const int ws = ((lo + hi) >> 1) - half;  // floor division of a non-negative sum
    b0[a] = max(lo, ws);
    nw[a] = max(min(hi, ws + n.CS - 1) - b0[a] + 1, 0);  // the box ∩ window
    if (a == 2) ctr_z = ws + half;
  }
  const bool keep = mav && ctr_z >= n.own_z0 && ctr_z < n.own_z1;  // block-uniform
  float sum = 0.0f;
  if (keep) sum = window_sum(vals, far, labels, n, f, b0, nw, rep);
  if (threadIdx.x != 0) return;

  const float unc = __fdiv_rn(sum, (float)max(n_pts, 1));
  confidence[k] = keep ? expf(-unc) : 0.0f;
  const float dx = __fsub_rn(ctr_o[0], sens[0]);
  const float dy = __fsub_rn(ctr_o[1], sens[1]);
  const float dz = __fsub_rn(ctr_o[2], sens[2]);
  const float dist = __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
  const float ang = atanf(__fdiv_rn(1.0f, clamp_min(dist, 1e-6f)));
  const float pv = clamp_max(__fmul_rn(ang, f.inv_v), 1.0f);
  const float ph = clamp_max(__fmul_rn(ang, f.inv_h), 1.0f);
  pdet[k] = mav ? __fmul_rn(pv, ph) : 0.0f;
  const float sigma = __fmul_rn(__fsqrt_rn(clamp_min(dist, 0.0f)), f.sigma);
  for (int e = 0; e < 9; ++e) cov[9 * k + e] = __fmul_rn(sigma, e % 4 == 0 ? 1.0f : 0.0f);

  ids[k] = wrap_add(counter, mav ? before : 0);
  valid[k] = mav;
  if (k == 0) new_counter[0] = wrap_add(counter, total);
}

}  // namespace

// out[0] = DET_WARPS, the warps of a slot's block: the window sum's order,
// which pipeline/detect.py DET_WARPS mirrors
VOFOD_API int vofod_detect_geometry(int* out) {
  out[0] = DET_WARPS;
  return 0;
}

// vals: device f32 grid; far: bool grid; labels: int32 grid; aabb_min/max,
// obb_center: f32 [K, 3]; reps, n_points, cluster_class: int32 [K]; sensor:
// f32 [3]; det_counter: int32 scalar.  ints: host int32 [nz, ny, nx, K, CS,
// z_lo, nz_buf, own_z0, own_z1]: the grids hold the z rows [z_lo, z_lo +
// nz_buf) of the nz-row grid, and only the slots whose window centre lies in
// [own_z0, own_z1) get their confidence (the others 0: on the grid-sharded
// step each slot's shard, the shards' results then summed);
// floats: host f32 DetF.  Outputs: valid bool [K], ids int32 [K],
// confidence, pdet f32 [K], cov f32 [K, 3, 3], new_counter int32 scalar.
VOFOD_API int vofod_detect(const void* vals, const void* far, const void* labels,
                           const void* aabb_min, const void* aabb_max, const void* reps,
                           const void* npts, const void* cls, const void* obb_center,
                           const void* sensor, const void* det_counter, const int* ints,
                           const float* floats, void* valid, void* ids, void* confidence,
                           void* pdet, void* cov, void* new_counter, void* stream) {
  DetI n;
  n.nz = ints[0]; n.ny = ints[1]; n.nx = ints[2]; n.K = ints[3]; n.CS = ints[4];
  n.z_lo = ints[5]; n.nz_buf = ints[6]; n.own_z0 = ints[7]; n.own_z1 = ints[8];
  if (n.K <= 0 || n.CS <= 0 || n.CS > 64 || n.nz_buf < 1) return (int)cudaErrorInvalidValue;
  DetF f;
  f.ox = floats[0]; f.oy = floats[1]; f.oz = floats[2]; f.inv_vs = floats[3];
  f.score = floats[4]; f.inv_score = floats[5]; f.inv_v = floats[6]; f.inv_h = floats[7];
  f.sigma = floats[8];
  detect_kernel<<<n.K, DET_T, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const uint8_t*>(far),
      static_cast<const int32_t*>(labels), static_cast<const float*>(aabb_min),
      static_cast<const float*>(aabb_max), static_cast<const int32_t*>(reps),
      static_cast<const int32_t*>(npts), static_cast<const int32_t*>(cls),
      static_cast<const float*>(obb_center), static_cast<const float*>(sensor),
      static_cast<const int32_t*>(det_counter), n, f, static_cast<uint8_t*>(valid),
      static_cast<int32_t*>(ids), static_cast<float*>(confidence),
      static_cast<float*>(pdet), static_cast<float*>(cov),
      static_cast<int32_t*>(new_counter));
  return (int)cudaGetLastError();
}

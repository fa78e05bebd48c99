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
// Bound on the H100: latency.  The work is K x CS^3 = 32 x 4,096 voxel
// reads; the JAX form pads three full grids (vals 9.9 MB, far 2.5 MB,
// labels 9.9 MB) every scan only to gather these windows.  Here one block
// per slot reads its window straight from the grids (out-of-grid reads take
// the fills 0 / False / INT_MAX, as submaps3's padding), reduces with a
// fixed block tree, and finishes the slot in the same block; block 0 also
// writes the new counter.  One launch.
//
// Arithmetic, fixed so that the plain PyTorch version (pipeline/detect.py
// detect_slots_plain) reproduces it bit for bit: the index math as
// GridSpec.coord_to_idx and geometry.to_int32, the int32 inflation with
// wrap-around, division by a constant as a multiply by its float32
// reciprocal (as PyTorch's CUDA division does), the distance as
// sqrt((dx dx + dy dy) + dz dz), expf and atanf as PyTorch's CUDA ops call
// them, and the window sum in this kernel's order (thread t adds voxels
// t, t + 256, ... left to right, then a pairwise tree), which the plain
// version replays instead of torch.sum.
#include "common.cuh"

namespace {

constexpr int DET_T = 256;
constexpr int CLS_MAV = 1;

struct DetF {
  float ox, oy, oz, inv_vs;  // GridSpec.coord_to_idx
  float score, inv_score;    // pipeline/detect.py DetectConsts
  float inv_v, inv_h, sigma;
};

struct DetI {
  int nz, ny, nx, K, CS;
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
  __shared__ float part[DET_T];
  const int k = blockIdx.x;
  const float o[3] = {f.ox, f.oy, f.oz};
  const int lim[3] = {n.nx - 1, n.ny - 1, n.nz - 1};
  int lo[3], hi[3], ctr[3];
  for (int a = 0; a < 3; ++a) {
    lo[a] = clampi(wrap_add(to_idx(aabb_min[3 * k + a], o[a], f.inv_vs), -2), 0, lim[a]);
    hi[a] = clampi(wrap_add(to_idx(aabb_max[3 * k + a], o[a], f.inv_vs), 2), 0, lim[a]);
    ctr[a] = (lo[a] + hi[a]) >> 1;  // floor division of a non-negative sum
  }
  const int half = n.CS / 2;
  const int rep = reps[k];
  const int cs3 = n.CS * n.CS * n.CS;
  float acc = 0.0f;
  for (int w = threadIdx.x; w < cs3; w += blockDim.x) {
    const int gx = ctr[0] - half + w % n.CS;
    const int gy = ctr[1] - half + (w / n.CS) % n.CS;
    const int gz = ctr[2] - half + w / (n.CS * n.CS);
    if (gx < lo[0] || gx > hi[0] || gy < lo[1] || gy > hi[1] || gz < lo[2] || gz > hi[2])
      continue;  // outside the box: contributes 0
    float v = 0.0f;  // submaps3 fills: 0 / False / INT_MAX
    bool fv = false;
    int lab = 2147483647;
    if (gx >= 0 && gx < n.nx && gy >= 0 && gy < n.ny && gz >= 0 && gz < n.nz) {
      const size_t g = ((size_t)gz * n.ny + gy) * n.nx + gx;
      v = vals[g];
      fv = far[g] != 0;
      lab = labels[g];
    }
    const float v_eff = (fv && lab == rep) ? f.score : v;  // members count as air
    acc = __fadd_rn(acc, __fsub_rn(1.0f, __fmul_rn(v_eff, f.inv_score)));
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = DET_T / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] = __fadd_rn(part[threadIdx.x], part[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x != 0) return;

  const bool mav = cls[k] == CLS_MAV;
  int before = 0, total = 0;
  for (int q = 0; q < n.K; ++q) {
    const int m = cls[q] == CLS_MAV;
    total += m;
    if (q < k) before += m;
  }
  const float unc = __fdiv_rn(part[0], (float)max(npts[k], 1));
  confidence[k] = mav ? expf(-unc) : 0.0f;

  const float dx = __fsub_rn(obb_center[3 * k], sensor[0]);
  const float dy = __fsub_rn(obb_center[3 * k + 1], sensor[1]);
  const float dz = __fsub_rn(obb_center[3 * k + 2], sensor[2]);
  const float dist = __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
  const float ang = atanf(__fdiv_rn(1.0f, clamp_min(dist, 1e-6f)));
  const float pv = clamp_max(__fmul_rn(ang, f.inv_v), 1.0f);
  const float ph = clamp_max(__fmul_rn(ang, f.inv_h), 1.0f);
  pdet[k] = mav ? __fmul_rn(pv, ph) : 0.0f;
  const float sigma = __fmul_rn(__fsqrt_rn(clamp_min(dist, 0.0f)), f.sigma);
  for (int e = 0; e < 9; ++e) cov[9 * k + e] = __fmul_rn(sigma, e % 4 == 0 ? 1.0f : 0.0f);

  const int counter = det_counter[0];
  ids[k] = wrap_add(counter, mav ? before : 0);
  valid[k] = mav;
  if (k == 0) new_counter[0] = wrap_add(counter, total);
}

}  // namespace

// vals: device f32 grid; far: bool grid; labels: int32 grid; aabb_min/max,
// obb_center: f32 [K, 3]; reps, n_points, cluster_class: int32 [K]; sensor:
// f32 [3]; det_counter: int32 scalar.  ints: host int32 [nz, ny, nx, K, CS];
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
  if (n.K <= 0 || n.CS <= 0 || n.CS > 64) return (int)cudaErrorInvalidValue;
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

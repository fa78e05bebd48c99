// K9 — per-cluster statistics of the classification: distinct labels into
// K slots, counts, AABB, PCA OBB, gates and the explore gate.
//
// Replaces the body of vofod_tpu/pipeline/classify.py:83-157 (with
// vofod_tpu/ops/eigh3.py `eigh3`): over the F far voxels compacted by K6,
// the first occurrence and ascending rank of each distinct component label
// ([F, F] compare passes), the K smallest labels as cluster slots, then per
// slot the member count, AABB, mean, covariance + 1e-6 I, the closed-form
// 3x3 eigendecomposition, the right-handed OBB axes, projections, OBB
// centre / half extents / diagonal, the size / distance / point gates,
// m_k and the explore gate.  As plain PyTorch this is ~150 small launches
// over [F, F] and [F, K, 3] tensors.
//
// Bound on the H100: latency — F = 2048 and K = 32 are tiny.  Two launches:
//  1. one block of 1024 threads holds the F labels in shared memory and
//     computes first occurrences, ranks, the reps and every far voxel's slot;
//  2. one block per slot walks the F slots three times (sums and bounds;
//     covariance about the mean; projections on the axes) with block
//     reductions, and thread 0 runs the eigendecomposition and the gates.
// Voxel centres, min/max and the eigendecomposition follow the plain
// version's float operations one for one (explicit __f*_rn, no FMA
// contraction; torch.argmax / argmin take the FIRST extreme on ties, and
// so does this code).  Only the member sums run in another order than the
// plain version's matmul / einsum, so the float outputs carry a stated
// tolerance while integers, bools and the AABB are bit-equal.
#include "common.cuh"

namespace {

constexpr int32_t SENTINEL = 0x7fffffff;
constexpr int RANK_T = 1024;
constexpr int STATS_T = 256;
constexpr float BIG = 3.0e38f;

struct StatsParams {
  int F, K, nx, ny;
  float ox, oy, oz, voxel;
  float min_points, max_distance, max_size, explore_distance;
};

struct StatsOut {
  int32_t* reps;          // [K]
  uint8_t* slot_valid;    // [K]
  int32_t* npts;          // [K]
  float* aabb_min;        // [K, 3]
  float* aabb_max;        // [K, 3]
  float* obb_center;      // [K, 3]
  float* axes;            // [K, 3, 3] rows = major, middle, minor
  float* obb_extent;      // [K, 3]
  float* obb_size;        // [K]
  uint8_t* gated;         // [K]
  int32_t* m_k;           // [K]
  uint8_t* qgate;         // [K]
  int32_t* rep_sel;       // [K]
  uint8_t* cluster_overflow;  // scalar
};
constexpr int N_OUT = 14;

__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fd(float a, float b) { return __fdiv_rn(a, b); }
// torch.clamp(x, min=lo) / (x, max=hi): NaN stays NaN
__device__ __forceinline__ float cmin(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float cmax(float x, float hi) { return x > hi ? hi : x; }

__device__ __forceinline__ void center_of(int fid, const StatsParams& p, float c[3]) {
  const int ix = fid % p.nx, rem = fid / p.nx;
  const int iy = rem % p.ny, iz = rem / p.ny;
  c[0] = fa(fm(fa((float)ix, 0.5f), p.voxel), p.ox);
  c[1] = fa(fm(fa((float)iy, 0.5f), p.voxel), p.oy);
  c[2] = fa(fm(fa((float)iz, 0.5f), p.voxel), p.oz);
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3], float o[3]) {
  o[0] = fs(fm(a[1], b[2]), fm(a[2], b[1]));
  o[1] = fs(fm(a[2], b[0]), fm(a[0], b[2]));
  o[2] = fs(fm(a[0], b[1]), fm(a[1], b[0]));
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return fa(fa(fm(a[0], b[0]), fm(a[1], b[1])), fm(a[2], b[2]));
}

// ops/eigh3.py eigvec: the largest of the three row cross products
__device__ void eigvec(float A[3][3], float lam, float scale, float v[3], bool* ok) {
  float M[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) M[i][j] = fs(A[i][j], i == j ? lam : 0.0f);
  float c[3][3];
  cross3(M[0], M[1], c[0]);
  cross3(M[0], M[2], c[1]);
  cross3(M[1], M[2], c[2]);
  int best = 0;
  float nb = dot3(c[0], c[0]);
  for (int i = 1; i < 3; ++i) {  // torch.argmax: the first maximum
    const float n = dot3(c[i], c[i]);
    if (n > nb) {
      nb = n;
      best = i;
    }
  }
  const float n2 = dot3(c[best], c[best]);
  const float t = fm(fm(1e-12f, scale), scale);
  *ok = n2 > fm(t, t);
  const float nrm = sqrtf(cmin(n2, 1e-30f));
  for (int j = 0; j < 3; ++j) v[j] = fd(c[best][j], nrm);
}

// ops/eigh3.py eigh3 of one symmetric matrix, then the OBB axes of
// classify.py: rows major (largest eigenvalue), middle, minor = major x middle.
__device__ void obb_axes(float Ain[3][3], float axes[3][3]) {
  float A[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) A[i][j] = fm(fa(Ain[i][j], Ain[j][i]), 0.5f);
  const float q = fm(fa(fa(A[0][0], A[1][1]), A[2][2]), 1.0f / 3.0f);
  float B[3][3];
  float ss = 0.0f;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      B[i][j] = fs(A[i][j], i == j ? q : 0.0f);
      ss = fa(ss, fm(B[i][j], B[i][j]));
    }
  const float p2 = fm(ss, 1.0f / 6.0f);
  const float p = sqrtf(cmin(p2, 1e-30f));
  const float det = fs(fs(fs(fa(fa(fm(fm(B[0][0], B[1][1]), B[2][2]),
                                   fm(fm(B[0][1], B[1][2]), B[2][0])),
                                fm(fm(B[0][2], B[1][0]), B[2][1])),
                             fm(fm(B[0][2], B[1][1]), B[2][0])),
                          fm(fm(B[0][0], B[1][2]), B[2][1])),
                       fm(fm(B[0][1], B[1][0]), B[2][2]));
  float r = fd(det, fa(fm(2.0f, fm(fm(p, p), p)), 1e-30f));
  r = cmax(cmin(r, -1.0f), 1.0f);
  const float phi = fm(acosf(r), 1.0f / 3.0f);
  const float two_p = fm(2.0f, p);
  const float e1 = fa(q, fm(two_p, cosf(phi)));
  const float e3 = fa(q, fm(two_p, cosf(fa(phi, 2.09439510239319549f))));
  const float scale = cmin(fabsf(e1), 1e-20f);

  float v3[3], v1[3];
  bool ok3, ok1;
  eigvec(A, e3, scale, v3, &ok3);
  if (!ok3) {  // degenerate: any axis works
    v3[0] = 1.0f;
    v3[1] = 0.0f;
    v3[2] = 0.0f;
  }
  eigvec(A, e1, scale, v1, &ok1);
  const float d13 = dot3(v1, v3);
  for (int j = 0; j < 3; ++j) v1[j] = fs(v1[j], fm(d13, v3[j]));
  const float n1 = dot3(v1, v1);
  int amin = 0;  // torch.argmin(|v3|): the first minimum
  for (int i = 1; i < 3; ++i)
    if (fabsf(v3[i]) < fabsf(v3[amin])) amin = i;
  float u[3] = {0.0f, 0.0f, 0.0f};
  u[amin] = 1.0f;
  const float du = dot3(u, v3);
  for (int j = 0; j < 3; ++j) u[j] = fs(u[j], fm(du, v3[j]));
  const float un = sqrtf(cmin(dot3(u, u), 1e-30f));
  for (int j = 0; j < 3; ++j) u[j] = fd(u[j], un);
  if (n1 > 1e-24f) {
    const float s = sqrtf(cmin(n1, 1e-30f));
    for (int j = 0; j < 3; ++j) v1[j] = fd(v1[j], s);
  } else {
    for (int j = 0; j < 3; ++j) v1[j] = u[j];
  }
  float v2[3];
  cross3(v3, v1, v2);
  for (int j = 0; j < 3; ++j) {
    axes[0][j] = v1[j];
    axes[1][j] = v2[j];
  }
  cross3(axes[0], axes[1], axes[2]);
}

// Block-wide reduction (all threads get the result); sh holds >= 32 T.
template <typename T, typename Op>
__device__ __forceinline__ T block_reduce(T v, Op op, T* sh) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = sh[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = op(r, sh[w]);
  __syncthreads();
  return r;
}

struct AddF {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct AddI {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct MinF {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct MaxF {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Pass 1: labels, first occurrences, ranks, reps and each far voxel's slot.
__global__ void __launch_bounds__(RANK_T) rank_kernel(
    const int32_t* __restrict__ fids, const uint8_t* __restrict__ fvalid,
    const int32_t* __restrict__ labels, StatsParams p, int32_t* __restrict__ slot_of,
    StatsOut out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int32_t* lab = reinterpret_cast<int32_t*>(smem_raw);
  uint8_t* is_rep = reinterpret_cast<uint8_t*>(lab + p.F);
  for (int f = threadIdx.x; f < p.F; f += blockDim.x)
    lab[f] = fvalid[f] ? labels[fids[f]] : SENTINEL;
  for (int k = threadIdx.x; k < p.K; k += blockDim.x) out.reps[k] = SENTINEL;
  __syncthreads();
  for (int f = threadIdx.x; f < p.F; f += blockDim.x) {
    bool rep = fvalid[f] != 0;
    for (int g = 0; g < f && rep; ++g) rep = lab[g] != lab[f];
    is_rep[f] = rep;
  }
  __syncthreads();
  int overflow = 0;
  for (int f = threadIdx.x; f < p.F; f += blockDim.x) {
    int slot = -1;
    if (fvalid[f]) {
      const int32_t l = lab[f];
      int rank = 0;
      for (int g = 0; g < p.F; ++g) rank += (is_rep[g] && lab[g] < l) ? 1 : 0;
      if (rank < p.K) {
        slot = rank;
        if (is_rep[f]) out.reps[rank] = l;
      } else {
        overflow = 1;  // a valid far voxel whose label got no slot
      }
    }
    slot_of[f] = slot;
  }
  overflow = __syncthreads_or(overflow);
  if (threadIdx.x == 0) out.cluster_overflow[0] = overflow ? 1 : 0;
}

// Pass 2: one block per slot.
__global__ void __launch_bounds__(STATS_T) stats_kernel(
    const int32_t* __restrict__ fids, const int32_t* __restrict__ slot_of,
    const float* __restrict__ sensor_pos, const uint8_t* __restrict__ bg_sufficient,
    const uint8_t* __restrict__ sure_bg_sufficient, const int32_t* __restrict__ ftotal,
    StatsParams p, StatsOut out) {
  __shared__ float shf[32];
  __shared__ int shi[32];
  __shared__ float mean_s[3], axes_s[3][3];
  const int k = blockIdx.x;

  int cnt = 0;
  float mn[3] = {BIG, BIG, BIG}, mx[3] = {-BIG, -BIG, -BIG}, sm[3] = {0.0f, 0.0f, 0.0f};
  for (int f = threadIdx.x; f < p.F; f += blockDim.x) {
    if (slot_of[f] != k) continue;
    float c[3];
    center_of(fids[f], p, c);
    ++cnt;
    for (int a = 0; a < 3; ++a) {
      mn[a] = fminf(mn[a], c[a]);
      mx[a] = fmaxf(mx[a], c[a]);
      sm[a] = fa(sm[a], c[a]);
    }
  }
  cnt = block_reduce(cnt, AddI(), shi);
  for (int a = 0; a < 3; ++a) {
    mn[a] = block_reduce(mn[a], MinF(), shf);
    mx[a] = block_reduce(mx[a], MaxF(), shf);
    sm[a] = block_reduce(sm[a], AddF(), shf);
  }
  const float denom = (float)max(cnt, 1);
  if (threadIdx.x == 0)
    for (int a = 0; a < 3; ++a) mean_s[a] = fd(sm[a], denom);
  __syncthreads();
  const float mean[3] = {mean_s[0], mean_s[1], mean_s[2]};

  float cv[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // xx xy xz yy yz zz
  for (int f = threadIdx.x; f < p.F; f += blockDim.x) {
    if (slot_of[f] != k) continue;
    float c[3];
    center_of(fids[f], p, c);
    const float d[3] = {fs(c[0], mean[0]), fs(c[1], mean[1]), fs(c[2], mean[2])};
    cv[0] = fa(cv[0], fm(d[0], d[0]));
    cv[1] = fa(cv[1], fm(d[0], d[1]));
    cv[2] = fa(cv[2], fm(d[0], d[2]));
    cv[3] = fa(cv[3], fm(d[1], d[1]));
    cv[4] = fa(cv[4], fm(d[1], d[2]));
    cv[5] = fa(cv[5], fm(d[2], d[2]));
  }
  for (int i = 0; i < 6; ++i) cv[i] = block_reduce(cv[i], AddF(), shf);
  if (threadIdx.x == 0) {
    const int ij[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
    float C[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) C[i][j] = fa(fd(cv[ij[i][j]], denom), i == j ? 1e-6f : 0.0f);
    obb_axes(C, axes_s);
  }
  __syncthreads();
  float ax[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) ax[i][j] = axes_s[i][j];

  float pmn[3] = {BIG, BIG, BIG}, pmx[3] = {-BIG, -BIG, -BIG};
  for (int f = threadIdx.x; f < p.F; f += blockDim.x) {
    if (slot_of[f] != k) continue;
    float c[3];
    center_of(fids[f], p, c);
    const float d[3] = {fs(c[0], mean[0]), fs(c[1], mean[1]), fs(c[2], mean[2])};
    for (int a = 0; a < 3; ++a) {
      const float pr = dot3(d, ax[a]);
      pmn[a] = fminf(pmn[a], pr);
      pmx[a] = fmaxf(pmx[a], pr);
    }
  }
  for (int a = 0; a < 3; ++a) {
    pmn[a] = block_reduce(pmn[a], MinF(), shf);
    pmx[a] = block_reduce(pmx[a], MaxF(), shf);
  }
  if (threadIdx.x != 0) return;

  const int32_t rep = out.reps[k];
  const bool slot_valid = rep < SENTINEL;
  float mid[3], ext[3], span[3], ctr[3];
  for (int a = 0; a < 3; ++a) {
    mid[a] = fm(fa(pmn[a], pmx[a]), 0.5f);
    span[a] = fs(pmx[a], pmn[a]);
    ext[a] = fm(span[a], 0.5f);
  }
  for (int j = 0; j < 3; ++j)
    ctr[j] = fa(mean[j], fa(fa(fm(ax[0][j], mid[0]), fm(ax[1][j], mid[1])), fm(ax[2][j], mid[2])));
  const float size = sqrtf(dot3(span, span));
  const float dv[3] = {fs(ctr[0], sensor_pos[0]), fs(ctr[1], sensor_pos[1]),
                       fs(ctr[2], sensor_pos[2])};
  const float dist = sqrtf(dot3(dv, dv));
  const bool gated = slot_valid && (float)cnt >= p.min_points && dist <= p.max_distance &&
                     size <= p.max_size;
  const bool explore_on = bg_sufficient[0] && sure_bg_sufficient[0] && !(ftotal[0] > p.F);
  // to_int32(floor((size + explore) / voxel)): NaN -> 0, saturate
  float m = floorf(fm(fa(size, p.explore_distance), 1.0f / p.voxel));
  if (m != m) m = 0.0f;
  m = fminf(fmaxf(m, -2147483648.0f), 2147483520.0f);
  const bool qgate = gated && explore_on;

  out.slot_valid[k] = slot_valid;
  out.npts[k] = cnt;
  for (int a = 0; a < 3; ++a) {
    out.aabb_min[3 * k + a] = mn[a];
    out.aabb_max[3 * k + a] = mx[a];
    out.obb_center[3 * k + a] = ctr[a];
    out.obb_extent[3 * k + a] = ext[a];
    for (int j = 0; j < 3; ++j) out.axes[9 * k + 3 * a + j] = ax[a][j];
  }
  out.obb_size[k] = size;
  out.gated[k] = gated;
  out.m_k[k] = (int32_t)m;
  out.qgate[k] = qgate;
  out.rep_sel[k] = qgate ? rep : -2;
}

}  // namespace

// fids: int32 [F]; fvalid: bool [F]; labels: int32 label grid; sensor_pos:
// float32 [3]; bg_sufficient / sure_bg_sufficient: bool scalars; ftotal:
// int32 scalar (far voxels in the whole grid).  grid_f: host float32
// [origin x, y, z, voxel]; gates: host float32 [min_points, max_distance,
// max_size, max_explore_distance].  slot_scratch: device int32 [F].
// outs: host int64 [14] device pointers, in StatsOut order.
VOFOD_API int vofod_cluster_stats(const void* fids, const void* fvalid, const void* labels,
                                  int F, int K, int ny, int nx, const float* grid_f,
                                  const float* gates, const void* sensor_pos,
                                  const void* bg_sufficient, const void* sure_bg_sufficient,
                                  const void* ftotal, void* slot_scratch,
                                  const long long* outs, void* stream) {
  if (F <= 0 || K <= 0 || F > 16384) return (int)cudaErrorInvalidValue;
  StatsParams p{F, K, nx, ny, grid_f[0], grid_f[1], grid_f[2], grid_f[3],
                gates[0], gates[1], gates[2], gates[3]};
  void* o[N_OUT];
  for (int i = 0; i < N_OUT; ++i) o[i] = reinterpret_cast<void*>(outs[i]);
  StatsOut out{static_cast<int32_t*>(o[0]), static_cast<uint8_t*>(o[1]),
               static_cast<int32_t*>(o[2]), static_cast<float*>(o[3]),
               static_cast<float*>(o[4]), static_cast<float*>(o[5]),
               static_cast<float*>(o[6]), static_cast<float*>(o[7]),
               static_cast<float*>(o[8]), static_cast<uint8_t*>(o[9]),
               static_cast<int32_t*>(o[10]), static_cast<uint8_t*>(o[11]),
               static_cast<int32_t*>(o[12]), static_cast<uint8_t*>(o[13])};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)F * (sizeof(int32_t) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int32_t* slot_of = static_cast<int32_t*>(slot_scratch);
  rank_kernel<<<1, RANK_T, smem, s>>>(static_cast<const int32_t*>(fids),
                                      static_cast<const uint8_t*>(fvalid),
                                      static_cast<const int32_t*>(labels), p, slot_of, out);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  stats_kernel<<<K, STATS_T, 0, s>>>(
      static_cast<const int32_t*>(fids), slot_of, static_cast<const float*>(sensor_pos),
      static_cast<const uint8_t*>(bg_sufficient), static_cast<const uint8_t*>(sure_bg_sufficient),
      static_cast<const int32_t*>(ftotal), p, out);
  return (int)cudaGetLastError();
}

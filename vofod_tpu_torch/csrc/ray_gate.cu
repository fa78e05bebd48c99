// K5a — the raycast's angular gate: the active-ray image sampled onto the
// six cube faces.
//
// Replaces vofod_tpu/ops/raycast.py `gate_faces` (with `_row_from_elevation`):
// pool the H x W active-ray image (bool) to n_rows x n_cols cells (the
// active fraction of each pool_v x pool_h patch), then for each of the
// 6 x F x F face texels take the texel direction into the sensor frame,
// its elevation and azimuth, the continuous pooled row / column, and sum the
// tent-weighted cells: a plain tent over rows (zero outside the vertical
// FOV), a circular tent over columns with the true azimuth period,
// normalised by its weight sum.
//
// Bound on the H100: neither bytes nor operations — the flagship image is
// 128 KB and the 6,534 texels each touch at most 2 x 4 cells.  One launch,
// no intermediate in device memory:
//
//   - texel blocks of GATE_T = 128 threads (56 blocks at the flagship),
//     spread over the card;
//   - the pooled grid (32 x 128 f32 = 16 KB at the flagship) is built in
//     each block's shared memory, the blocks in thread-block clusters of
//     GATE_CLUSTER = 8: each block pools 1 / 8 of the pooled rows and
//     copies the others' from their shared memory (distributed shared
//     memory), so the cluster reads the image once.  A thread pools a
//     pooled row's 16-byte column chunk: pool_v 16-byte loads, per-byte
//     counts summed four bytes to a word, then each cell's pool_h bytes
//     (where pool_h divides 16 and the rows are 16-byte aligned; any other
//     layout pools each cell byte by byte);
//   - each texel walks only the support of its circular column tent:
//     floor(g) and floor(g) + 1 for g the pooled column and g -+ period, in
//     [0, n_cols), without duplicates, in ascending column order (across
//     the seam the wrap column n_cols - 1 comes after column 0), once for
//     the weight sum and once for the two rows the row tent touches.  Off
//     the support every distance is >= 1, so the weight is +0 and adding it
//     leaves a non-negative float sum unchanged: the sum over the support is
//     the sum over all columns in ascending order, bit for bit.
//
// Arithmetic, fixed so that the plain PyTorch version (gate_faces_plain)
// reproduces it bit for bit: the pooled mean as count x (1 / n) in f32;
// directions ((d0 R0j + d1 R1j) + d2 R2j) with __fmul_rn / __fadd_rn;
// division by a constant as a multiply by its float32 reciprocal, as
// PyTorch's CUDA division by a scalar does; the column-weight sum and the
// column products accumulated in ascending column order; asinf, atan2f and
// fmodf as PyTorch's CUDA ops call them.  ops/raycast.py
// gate_faces_support_plain models the support walk.
#include <climits>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int GATE_T = 128;       // texel threads a block
constexpr int GATE_CLUSTER = 8;   // blocks a cluster, each pooling 1/8 of the rows

// float32 constants, in the order of ops/raycast.py _gate_scalars
struct GateF {
  float inv_pool;  // 1 / (pool_v * pool_h)
  float el_b;      // linear row map: row = (el - el_b) * inv_el_a
  float inv_el_a;
  float sgn;       // +-1: the row table is sgn * el_rows, increasing
  float az_b;      // column map: col = (az - az_b) * inv_az_a
  float inv_az_a;
  float inv_pv;    // 1 / pool_v
  float inv_ph;    // 1 / pool_h
  float period;    // azimuth period in pooled columns
};

struct GateI {
  int H, W, pool_v, pool_h, n_rows, n_cols, n_tex, n_tbl;  // n_tbl: 0 = linear
  int vec;  // 1: pool 16-byte column chunks (pool_h | 16, rows 16-byte aligned)
};

// torch.clamp: NaN passes through
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// the circular column tent of pooled column c at coordinate g
__device__ __forceinline__ float col_weight(float g, float period, int c) {
  const float k = (float)c;
  const float d0 = fabsf(__fsub_rn(g, k));
  const float dm = fabsf(__fsub_rn(__fsub_rn(g, period), k));
  const float dp = fabsf(__fsub_rn(__fadd_rn(g, period), k));
  return fmaxf(__fsub_rn(1.0f, fminf(d0, fminf(dm, dp))), 0.0f);
}

// the cells of pooled rows [r0, r1) into G [n_rows][n_cols]
__device__ __forceinline__ void pool_rows(const uint8_t* __restrict__ active, const GateI& n,
                                          float inv_pool, int r0, int r1, float* G) {
  if (n.vec) {
    const int chunks = n.W >> 4;  // 16-byte column chunks of a row
    const int cells = 16 / n.pool_h;
    for (int i = threadIdx.x; i < (r1 - r0) * chunks; i += blockDim.x) {
      const int r = r0 + i / chunks, j = i - (i / chunks) * chunks;
      const uint4* src =
          reinterpret_cast<const uint4*>(active + (size_t)r * n.pool_v * n.W) + j;
      unsigned int w[4] = {0u, 0u, 0u, 0u};  // per-byte counts (pool_v <= 255)
#pragma unroll 4
      for (int a = 0; a < n.pool_v; ++a) {
        const uint4 v = src[(size_t)a * chunks];
        w[0] = __vadd4(w[0], __vcmpne4(v.x, 0u) & 0x01010101u);
        w[1] = __vadd4(w[1], __vcmpne4(v.y, 0u) & 0x01010101u);
        w[2] = __vadd4(w[2], __vcmpne4(v.z, 0u) & 0x01010101u);
        w[3] = __vadd4(w[3], __vcmpne4(v.w, 0u) & 0x01010101u);
      }
      float* out = G + r * n.n_cols + j * cells;
      int cnt = 0;
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        cnt += (w[b >> 2] >> (8 * (b & 3))) & 0xffu;
        if ((b + 1) % n.pool_h == 0) {
          *out++ = __fmul_rn((float)cnt, inv_pool);
          cnt = 0;
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < (r1 - r0) * n.n_cols; i += blockDim.x) {
      const int r = r0 + i / n.n_cols, c = i - (i / n.n_cols) * n.n_cols;
      int cnt = 0;
      for (int a = 0; a < n.pool_v; ++a) {
        const uint8_t* row = active + (size_t)(r * n.pool_v + a) * n.W + (size_t)c * n.pool_h;
        for (int b = 0; b < n.pool_h; ++b) cnt += row[b] != 0;
      }
      G[r * n.n_cols + c] = __fmul_rn((float)cnt, inv_pool);
    }
  }
}

// The pooled grid in this block's shared memory (cluster barriers).
__device__ __forceinline__ void pool_grid(const uint8_t* __restrict__ active, const GateI& n,
                                          float inv_pool, float* G) {
  cg::cluster_group cluster = cg::this_cluster();
  const int per = (n.n_rows + GATE_CLUSTER - 1) / GATE_CLUSTER;
  const int me = (int)cluster.block_rank();
  pool_rows(active, n, inv_pool, min(me * per, n.n_rows), min((me + 1) * per, n.n_rows), G);
  cluster.sync();
  for (int q = 1; q < GATE_CLUSTER; ++q) {  // the others' rows, nearest rank first
    const int src = (me + q) % GATE_CLUSTER;
    const int c0 = min(src * per, n.n_rows) * n.n_cols;
    const int c1 = min((src + 1) * per, n.n_rows) * n.n_cols;
    const float* remote = cluster.map_shared_rank(G, src);
    for (int i = c0 + threadIdx.x; i < c1; i += blockDim.x) G[i] = remote[i];
  }
  cluster.sync();  // no block leaves while another reads its rows
}

// sort a[0:6] ascending
__device__ __forceinline__ void sort6(int* a) {
#pragma unroll
  for (int i = 1; i < 6; ++i)
#pragma unroll
    for (int j = i; j > 0; --j) {
      const int lo = min(a[j - 1], a[j]), hi = max(a[j - 1], a[j]);
      a[j - 1] = lo;
      a[j] = hi;
    }
}

__global__ void __launch_bounds__(GATE_T) __cluster_dims__(GATE_CLUSTER, 1, 1)
    gate_faces_kernel(const uint8_t* __restrict__ active,
                      const float* __restrict__ face_dirs,
                      const float* __restrict__ rot,
                      const float* __restrict__ table, GateI n, GateF f,
                      float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* G = smem;                       // [n_rows][n_cols]
  float* tbl = G + n.n_rows * n.n_cols;  // [n_tbl]
  for (int i = threadIdx.x; i < n.n_tbl; i += blockDim.x) tbl[i] = table[i];
  pool_grid(active, n, f.inv_pool, G);

  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n.n_tex) return;
  const float d0 = face_dirs[3 * t], d1 = face_dirs[3 * t + 1],
              d2 = face_dirs[3 * t + 2];
  float s[3];  // sensor frame: s = R^T w
  for (int j = 0; j < 3; ++j)
    s[j] = __fadd_rn(__fadd_rn(__fmul_rn(d0, rot[j]), __fmul_rn(d1, rot[3 + j])),
                     __fmul_rn(d2, rot[6 + j]));
  const float el = asinf(clampf(s[2], -1.0f, 1.0f));
  const float az = atan2f(s[1], s[0]);

  float row;
  if (n.n_tbl == 0) {
    row = __fmul_rn(__fsub_rn(el, f.el_b), f.inv_el_a);
  } else {  // exact monotone inverse of the per-row elevation table
    const float tv = __fmul_rn(f.sgn, el);
    int cnt = 0;
    for (int i = 0; i < n.n_tbl; ++i) cnt += tv >= tbl[i];
    const int idx = min(max(cnt - 1, 0), n.n_tbl - 2);
    const float f0 = tbl[idx], f1 = tbl[idx + 1];
    row = __fadd_rn((float)idx, __fdiv_rn(__fsub_rn(tv, f0), __fsub_rn(f1, f0)));
  }
  const float g_r = __fsub_rn(__fmul_rn(__fadd_rn(row, 0.5f), f.inv_pv), 0.5f);
  const float x = __fsub_rn(
      __fmul_rn(__fadd_rn(__fmul_rn(__fsub_rn(az, f.az_b), f.inv_az_a), 0.5f),
                f.inv_ph),
      0.5f);
  float g_c = fmodf(x, f.period);  // torch.remainder
  if (g_c != 0.0f && ((f.period < 0.0f) != (g_c < 0.0f)))
    g_c = __fadd_rn(g_c, f.period);

  // the row tent: taps floor(g_r) and floor(g_r) + 1 inside [0, n_rows)
  float wr[2] = {0.0f, 0.0f};
  int rr[2] = {0, 0};
  const float fr = floorf(g_r);
  for (int k = 0; k < 2; ++k) {
    const float kr = fr + (float)k;
    if (kr >= 0.0f && kr <= (float)(n.n_rows - 1)) {
      wr[k] = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(g_r, kr))), 0.0f);
      rr[k] = (int)kr;
    }
  }
  float val = 0.0f;
  if (wr[0] > 0.0f || wr[1] > 0.0f) {
    // the column tent's support: the two columns around each of g - period,
    // g and g + period (as col_weight rounds them) inside [0, n_cols),
    // INT_MAX elsewhere; ascending, each once
    const float centre[3] = {__fsub_rn(g_c, f.period), g_c, __fadd_rn(g_c, f.period)};
    int cols[6];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float fc = floorf(centre[i]);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float kc = fc + (float)k;
        cols[2 * i + k] = kc >= 0.0f && kc <= (float)(n.n_cols - 1) ? (int)kc : INT_MAX;
      }
    }
    sort6(cols);
    float wsum = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i)
      if (cols[i] != INT_MAX && (i == 0 || cols[i] != cols[i - 1]))
        wsum = __fadd_rn(wsum, col_weight(g_c, f.period, cols[i]));
    wsum = fmaxf(wsum, 1e-6f);
    float in0 = 0.0f, in1 = 0.0f;
    const float* G0 = G + rr[0] * n.n_cols;
    const float* G1 = G + rr[1] * n.n_cols;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      if (cols[i] == INT_MAX || (i > 0 && cols[i] == cols[i - 1])) continue;
      const float w = col_weight(g_c, f.period, cols[i]);
      if (w > 0.0f) {
        const float wn = __fdiv_rn(w, wsum);
        in0 = __fadd_rn(in0, __fmul_rn(wn, G0[cols[i]]));
        in1 = __fadd_rn(in1, __fmul_rn(wn, G1[cols[i]]));
      }
    }
    val = __fadd_rn(__fmul_rn(wr[0], in0), __fmul_rn(wr[1], in1));
  }
  out[t] = val;
}

}  // namespace

// active: device bool [H, W]; face_dirs: device f32 [n_tex, 3]; rot: device
// f32 [3, 3] sensor-to-world; table: device f32 [n_tbl] (sgn * el_rows) or
// NULL with n_tbl = 0; ints: host int32 [H, W, pool_v, pool_h, n_rows,
// n_cols, n_tex, n_tbl]; floats: host f32 GateF.  out: device f32 [n_tex].
VOFOD_API int vofod_gate_faces(const void* active, const void* face_dirs,
                               const void* rot, const void* table,
                               const int* ints, const float* floats, void* out,
                               void* stream) {
  GateI n;
  n.H = ints[0]; n.W = ints[1]; n.pool_v = ints[2]; n.pool_h = ints[3];
  n.n_rows = ints[4]; n.n_cols = ints[5]; n.n_tex = ints[6]; n.n_tbl = ints[7];
  n.vec = n.pool_h > 0 && 16 % n.pool_h == 0 && n.W % 16 == 0 && n.pool_v <= 255 &&
          reinterpret_cast<uintptr_t>(active) % 16 == 0;
  if (n.n_rows * n.pool_v != n.H || n.n_cols * n.pool_h != n.W || n.n_tex <= 0 ||
      n.n_tbl == 1 || (n.n_tbl > 0 && table == nullptr))
    return (int)cudaErrorInvalidValue;
  GateF f;
  f.inv_pool = floats[0]; f.el_b = floats[1]; f.inv_el_a = floats[2];
  f.sgn = floats[3]; f.az_b = floats[4]; f.inv_az_a = floats[5];
  f.inv_pv = floats[6]; f.inv_ph = floats[7]; f.period = floats[8];
  const size_t smem = sizeof(float) * ((size_t)n.n_rows * n.n_cols + n.n_tbl);
  if (smem > 48 * 1024) {
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        gate_faces_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks =
      (n.n_tex + GATE_T * GATE_CLUSTER - 1) / (GATE_T * GATE_CLUSTER) * GATE_CLUSTER;
  gate_faces_kernel<<<blocks, GATE_T, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(active), static_cast<const float*>(face_dirs),
      static_cast<const float*>(rot), static_cast<const float*>(table), n, f,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

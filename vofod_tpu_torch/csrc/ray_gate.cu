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
// 128 KB and the 6,534 texels each touch a few cells.  The JAX form is two
// small matmuls over all 32 x 128 cells; here each block pools the whole
// image into shared memory (32 x 128 f32 = 16 KB) and each thread walks one
// texel's column weights once for their sum and once for the two rows the
// row tent touches.  One launch, no intermediate in device memory.
//
// Arithmetic, fixed so that the plain PyTorch version (gate_faces_plain)
// reproduces it bit for bit: the pooled mean as count x (1 / n) in f32;
// directions ((d0 R0j + d1 R1j) + d2 R2j) with __fmul_rn / __fadd_rn;
// division by a constant as a multiply by its float32 reciprocal, as
// PyTorch's CUDA division by a scalar does; the column-weight sum and the
// column products accumulated in ascending column order; asinf, atan2f and
// fmodf as PyTorch's CUDA ops call them.
#include "common.cuh"

namespace {

constexpr int GATE_T = 256;

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

__global__ void __launch_bounds__(GATE_T)
    gate_faces_kernel(const uint8_t* __restrict__ active,
                      const float* __restrict__ face_dirs,
                      const float* __restrict__ rot,
                      const float* __restrict__ table, GateI n, GateF f,
                      float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* G = smem;                     // [n_rows][n_cols]
  float* tbl = G + n.n_rows * n.n_cols;  // [n_tbl]
  for (int i = threadIdx.x; i < n.n_rows * n.n_cols; i += blockDim.x) {
    const int r = i / n.n_cols, c = i - r * n.n_cols;
    int cnt = 0;
    for (int a = 0; a < n.pool_v; ++a) {
      const uint8_t* row =
          active + (size_t)(r * n.pool_v + a) * n.W + (size_t)c * n.pool_h;
      for (int b = 0; b < n.pool_h; ++b) cnt += row[b] != 0;
    }
    G[i] = __fmul_rn((float)cnt, f.inv_pool);
  }
  for (int i = threadIdx.x; i < n.n_tbl; i += blockDim.x) tbl[i] = table[i];
  __syncthreads();

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
    float wsum = 0.0f;
    for (int c = 0; c < n.n_cols; ++c)
      wsum = __fadd_rn(wsum, col_weight(g_c, f.period, c));
    wsum = fmaxf(wsum, 1e-6f);
    float in0 = 0.0f, in1 = 0.0f;
    const float* G0 = G + rr[0] * n.n_cols;
    const float* G1 = G + rr[1] * n.n_cols;
    for (int c = 0; c < n.n_cols; ++c) {
      const float w = col_weight(g_c, f.period, c);
      if (w > 0.0f) {
        const float wn = __fdiv_rn(w, wsum);
        in0 = __fadd_rn(in0, __fmul_rn(wn, G0[c]));
        in1 = __fadd_rn(in1, __fmul_rn(wn, G1[c]));
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
  const int blocks = (n.n_tex + GATE_T - 1) / GATE_T;
  gate_faces_kernel<<<blocks, GATE_T, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(active), static_cast<const float*>(face_dirs),
      static_cast<const float*>(rot), static_cast<const float*>(table), n, f,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

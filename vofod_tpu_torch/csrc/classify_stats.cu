// K9 — per-cluster statistics of the classification: distinct labels into
// K slots, counts, AABB, PCA OBB, gates and the explore gate.
//
// Replaces the body of vofod_tpu/pipeline/classify.py:83-157 (with
// vofod_tpu/ops/eigh3.py `eigh3`): over the F far voxels compacted by K6,
// the distinct component labels in ascending order as K cluster slots (the
// JAX code ranks them with [F, F] compare passes), then per slot the member
// count, AABB, mean, covariance + 1e-6 I, the closed-form 3x3
// eigendecomposition, the right-handed OBB axes, projections, OBB centre /
// half extents / diagonal, the size / distance / point gates, m_k and the
// explore gate.  As plain PyTorch this is ~150 small launches over [F, F]
// and [F, K, 3] tensors.
//
// Slots from a sort.  Far voxel f is a 64-bit key: its label (sign bit
// flipped, so that unsigned order is int32 order) in the high word and f in
// the low word; an invalid f is ~0 and sorts last.  In sorted order the
// keys of one label form a run whose head holds the label's smallest f, its
// first occurrence (classify.py:89-95); an exclusive scan of the heads gives
// each label's rank, slot k's members are the run of the head of rank k, and
// cluster_overflow is "more than K heads".  A far voxel labelled SENTINEL
// (the label grid's "no label", never a far voxel's) joins no slot.
//
// Bound on the H100: latency (F = 2048 and K = 32 at the flagship).
//  - F <= SMEM_KEYS, one launch: K blocks of one thread per two keys (32 to
//    SORT_T) each load all F keys into shared memory and sort them
//    (bitonic), so the K sorts run side by side in one sort's time; block k
//    finds the run of rank k and reduces its members three times (sums and
//    bounds; covariance about the mean; projections on the axes), and its
//    thread 0 runs the eigendecomposition and the gates.
//  - F > SMEM_KEYS, four launches: chunks of CHUNK keys, each sorted by one
//    block into global scratch; a chunk's run head is the label's head if no
//    earlier chunk holds the label (a binary search in each), and each chunk
//    stores its inclusive count of heads; a head's rank is the sum over the
//    chunks of their heads below its label (a merge-path rank: one binary
//    search a chunk); then one block a slot finds its label's run in every
//    chunk and reduces those runs as above.
// Voxel centres, min/max and the eigendecomposition follow the plain
// version's float operations one for one (explicit __f*_rn, no FMA
// contraction; torch.argmax / argmin take the FIRST extreme on ties, and
// so does this code).  Only the member sums run in another order than the
// plain version's matmul / einsum (run order, then a block tree), so the
// float outputs carry a stated tolerance while integers, bools and the
// AABB are bit-equal.
#include "common.cuh"

namespace {

constexpr int32_t SENTINEL = 0x7fffffff;
constexpr float BIG = 3.0e38f;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NO_KEY = ~0ull;  // an invalid far voxel
constexpr uint32_t NO_HI = 0xffffffffu;       // its high word, and label SENTINEL's
constexpr int SORT_T = 512;                   // the one-launch path's widest block
constexpr int SMEM_KEYS = 8192;               // its largest F: 64 KB of keys
constexpr int CHUNK = 8192;                   // the chunked path's keys a block
constexpr int CHUNK_T = 1024;
constexpr int STATS_T = 256;  // the chunked path's threads a slot
static_assert(CHUNK / CHUNK_T <= 32, "chunk_heads_kernel keeps a thread's heads in 32 bits");

struct StatsParams {
  int F, K, nx, ny;
  float ox, oy, oz, voxel;
  float min_points, max_distance, max_size, explore_distance;
};

struct GateIn {
  const float* sensor_pos;           // [3]
  const uint8_t* bg_sufficient;      // scalar
  const uint8_t* sure_bg_sufficient; // scalar
  const int32_t* ftotal;             // scalar: far voxels in the whole grid
};

// The outputs, carved from one allocation in this order (kernels.py
// cluster_stats views the same layout): float32 aabb_min, aabb_max,
// obb_center, obb_extent [K, 3], axes [K, 3, 3] (rows major, middle,
// minor), obb_size [K]; int32 reps, npts, m_k, rep_sel [K]; bool
// slot_valid, gated, qgate [K] and cluster_overflow (a scalar).
struct StatsOut {
  float *aabb_min, *aabb_max, *obb_center, *obb_extent, *axes, *obb_size;
  int32_t *reps, *npts, *m_k, *rep_sel;
  uint8_t *slot_valid, *gated, *qgate, *cluster_overflow;
};

StatsOut carve(void* base, int K) {
  StatsOut o;
  float* f = static_cast<float*>(base);
  o.aabb_min = f;
  o.aabb_max = f + 3 * K;
  o.obb_center = f + 6 * K;
  o.obb_extent = f + 9 * K;
  o.axes = f + 12 * K;
  o.obb_size = f + 21 * K;
  int32_t* i = reinterpret_cast<int32_t*>(f + 22 * K);
  o.reps = i;
  o.npts = i + K;
  o.m_k = i + 2 * K;
  o.rep_sel = i + 3 * K;
  uint8_t* b = reinterpret_cast<uint8_t*>(i + 4 * K);
  o.slot_valid = b;
  o.gated = b + K;
  o.qgate = b + 2 * K;
  o.cluster_overflow = b + 3 * K;
  return o;
}

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

__device__ __forceinline__ unsigned long long key_of(bool valid, int32_t label, int f) {
  if (!valid) return NO_KEY;
  return ((unsigned long long)((uint32_t)label ^ 0x80000000u) << 32) | (uint32_t)f;
}
__device__ __forceinline__ uint32_t hi_of(unsigned long long key) { return (uint32_t)(key >> 32); }
__device__ __forceinline__ int32_t label_of(uint32_t hi) { return (int32_t)(hi ^ 0x80000000u); }
// the run head at i of sorted keys a (a key of a slot that starts a label's run)
__device__ __forceinline__ bool run_head(const unsigned long long* a, int i) {
  const uint32_t h = hi_of(a[i]);
  return h != NO_HI && (i == 0 || hi_of(a[i - 1]) != h);
}

__device__ __forceinline__ void cmpx(unsigned long long* a, int i, int j) {
  const unsigned long long x = a[i], y = a[j];
  if (y < x) {
    a[i] = y;
    a[j] = x;
  }
}

// Ascending bitonic sort of a[0, n) in shared memory by the whole block.  n
// need not be a power of two: every comparator of this form (a "flip" of
// each block, then half-cleaners) puts the smaller key first, so the keys
// missing up to the next power of two act as +inf and never move.
__device__ void block_sort(unsigned long long* a, int n) {
  int lg = 0;
  while ((1 << lg) < n) ++lg;
  const int pairs = (1 << lg) >> 1;
  for (int s = 1; s <= lg; ++s) {
    const int hb = (1 << (s - 1)) - 1;
    for (int t = threadIdx.x; t < pairs; t += blockDim.x) {
      const int base = (t >> (s - 1)) << s, off = t & hb;
      const int j = base + (1 << s) - 1 - off;
      if (j < n) cmpx(a, base + off, j);
    }
    __syncthreads();
    for (int d = s - 2; d >= 0; --d) {
      for (int t = threadIdx.x; t < pairs; t += blockDim.x) {
        const int i = ((t >> d) << (d + 1)) + (t & ((1 << d) - 1));
        if (i + (1 << d) < n) cmpx(a, i, i + (1 << d));
      }
      __syncthreads();
    }
  }
}

// Exclusive prefix of v over the block's threads (blockDim a multiple of 32);
// *total gets the sum.  sh: >= 32 ints.
__device__ int block_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < nw ? sh[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    sh[lane] = s;
  }
  __syncthreads();
  const int before = (w > 0 ? sh[w - 1] : 0) + x - v;
  *total = sh[nw - 1];
  __syncthreads();
  return before;
}

// the first index of sorted a[0, n) whose high word is >= h (upper: > h)
__device__ __forceinline__ int lower_hi(const unsigned long long* a, int n, uint32_t h,
                                        bool upper = false) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    const uint32_t m = hi_of(a[lo + half]);
    if (m < h || (upper && m == h)) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// Block-wide reduction of N floats at once (all threads get the results);
// op(i, x, y) combines entry i.  sh holds >= 32 N floats.
template <int N, typename Op>
__device__ __forceinline__ void block_reduce(float (&v)[N], Op op, float* sh) {
  for (int o = 16; o > 0; o >>= 1)
    for (int i = 0; i < N; ++i) v[i] = op(i, v[i], __shfl_down_sync(FULL, v[i], o));
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0)
    for (int i = 0; i < N; ++i) sh[w * N + i] = v[i];
  __syncthreads();
  for (int i = 0; i < N; ++i) {
    float r = sh[i];
    for (int x = 1; x < nw; ++x) r = op(i, r, sh[x * N + i]);
    v[i] = r;
  }
  __syncthreads();
}

// fn(f) for every member of the slot: the keys [lo[s], hi[s]) of the nseg
// sorted runs keys + s * stride, one thread a key
template <typename Fn>
__device__ __forceinline__ void for_members(const unsigned long long* keys, int stride,
                                            const int* lo, const int* hi, int nseg, Fn fn) {
  for (int s = 0; s < nseg; ++s) {
    const unsigned long long* a = keys + (size_t)s * stride;
    for (int i = lo[s] + threadIdx.x; i < hi[s]; i += blockDim.x) fn((int)(uint32_t)a[i]);
  }
}

// Slot k's statistics from its cnt members (label rep, SENTINEL for an empty
// slot), by the whole block; thread 0 writes every output but reps.
__device__ void slot_stats(int k, int32_t rep, int cnt, const unsigned long long* keys,
                           int stride, const int* lo, const int* hi, int nseg,
                           const int32_t* __restrict__ fids, const GateIn& gi,
                           const StatsParams& p, const StatsOut& out) {
  __shared__ float shf[32 * 9];
  __shared__ float axes_s[3][3];
  // pass 1: bounds and sums
  float b[9] = {BIG, BIG, BIG, -BIG, -BIG, -BIG, 0.0f, 0.0f, 0.0f};  // min, max, sum
  for_members(keys, stride, lo, hi, nseg, [&](int f) {
    float c[3];
    center_of(fids[f], p, c);
    for (int a = 0; a < 3; ++a) {
      b[a] = fminf(b[a], c[a]);
      b[3 + a] = fmaxf(b[3 + a], c[a]);
      b[6 + a] = fa(b[6 + a], c[a]);
    }
  });
  block_reduce(b, [](int i, float x, float y) {
    return i < 3 ? fminf(x, y) : (i < 6 ? fmaxf(x, y) : fa(x, y));
  }, shf);
  const float denom = (float)max(cnt, 1);
  const float mean[3] = {fd(b[6], denom), fd(b[7], denom), fd(b[8], denom)};

  // pass 2: covariance about the mean
  float cv[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // xx xy xz yy yz zz
  for_members(keys, stride, lo, hi, nseg, [&](int f) {
    float c[3];
    center_of(fids[f], p, c);
    const float d[3] = {fs(c[0], mean[0]), fs(c[1], mean[1]), fs(c[2], mean[2])};
    cv[0] = fa(cv[0], fm(d[0], d[0]));
    cv[1] = fa(cv[1], fm(d[0], d[1]));
    cv[2] = fa(cv[2], fm(d[0], d[2]));
    cv[3] = fa(cv[3], fm(d[1], d[1]));
    cv[4] = fa(cv[4], fm(d[1], d[2]));
    cv[5] = fa(cv[5], fm(d[2], d[2]));
  });
  block_reduce(cv, [](int, float x, float y) { return fa(x, y); }, shf);
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

  // pass 3: projections on the axes
  float pr[6] = {BIG, BIG, BIG, -BIG, -BIG, -BIG};  // min, max
  for_members(keys, stride, lo, hi, nseg, [&](int f) {
    float c[3];
    center_of(fids[f], p, c);
    const float d[3] = {fs(c[0], mean[0]), fs(c[1], mean[1]), fs(c[2], mean[2])};
    for (int a = 0; a < 3; ++a) {
      const float q = dot3(d, ax[a]);
      pr[a] = fminf(pr[a], q);
      pr[3 + a] = fmaxf(pr[3 + a], q);
    }
  });
  block_reduce(pr, [](int i, float x, float y) { return i < 3 ? fminf(x, y) : fmaxf(x, y); },
               shf);
  if (threadIdx.x != 0) return;

  const bool slot_valid = rep < SENTINEL;
  float mid[3], ext[3], span[3], ctr[3];
  for (int a = 0; a < 3; ++a) {
    mid[a] = fm(fa(pr[a], pr[3 + a]), 0.5f);
    span[a] = fs(pr[3 + a], pr[a]);
    ext[a] = fm(span[a], 0.5f);
  }
  for (int j = 0; j < 3; ++j)
    ctr[j] = fa(mean[j], fa(fa(fm(ax[0][j], mid[0]), fm(ax[1][j], mid[1])), fm(ax[2][j], mid[2])));
  const float size = sqrtf(dot3(span, span));
  const float dv[3] = {fs(ctr[0], gi.sensor_pos[0]), fs(ctr[1], gi.sensor_pos[1]),
                       fs(ctr[2], gi.sensor_pos[2])};
  const float dist = sqrtf(dot3(dv, dv));
  const bool gated = slot_valid && (float)cnt >= p.min_points && dist <= p.max_distance &&
                     size <= p.max_size;
  const bool explore_on =
      gi.bg_sufficient[0] && gi.sure_bg_sufficient[0] && !(gi.ftotal[0] > p.F);
  // to_int32(floor((size + explore) / voxel)): NaN -> 0, saturate
  float m = floorf(fm(fa(size, p.explore_distance), 1.0f / p.voxel));
  if (m != m) m = 0.0f;
  m = fminf(fmaxf(m, -2147483648.0f), 2147483520.0f);
  const bool qgate = gated && explore_on;

  out.slot_valid[k] = slot_valid;
  out.npts[k] = cnt;
  for (int a = 0; a < 3; ++a) {
    out.aabb_min[3 * k + a] = b[a];
    out.aabb_max[3 * k + a] = b[3 + a];
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

// F <= SMEM_KEYS: block k sorts every key, finds the run of rank k and
// reduces it; it writes reps[k], block 0 the overflow.
__global__ void __launch_bounds__(SORT_T) slots_kernel(
    const int32_t* __restrict__ fids, const uint8_t* __restrict__ fvalid,
    const int32_t* __restrict__ labels, GateIn gi, StatsParams p, StatsOut out) {
  extern __shared__ unsigned long long keys[];
  __shared__ int shi[32];
  __shared__ int seg[2];
  const int k = blockIdx.x;
  int nm = 0;
  for (int f = threadIdx.x; f < p.F; f += blockDim.x) {
    const unsigned long long key = key_of(fvalid[f] != 0, labels[f], f);
    keys[f] = key;
    nm += hi_of(key) != NO_HI;
  }
  int n_mem;  // keys of a slot: they sort first
  block_scan(nm, shi, &n_mem);
  block_sort(keys, p.F);

  // heads over contiguous ranges of the sorted keys, ranked by a block scan
  const int per = (n_mem + (int)blockDim.x - 1) / (int)blockDim.x;
  const int i0 = min((int)threadIdx.x * per, n_mem), i1 = min(i0 + per, n_mem);
  int nh = 0;
  for (int i = i0; i < i1; ++i) nh += run_head(keys, i);
  if (threadIdx.x == 0) seg[0] = seg[1] = n_mem;  // an empty slot: no run
  int n_distinct;
  int r = block_scan(nh, shi, &n_distinct);
  for (int i = i0; i < i1; ++i) {
    if (!run_head(keys, i)) continue;
    if (r == k) seg[0] = i;
    if (r == k + 1) seg[1] = i;
    ++r;
  }
  __syncthreads();
  const int32_t rep = seg[0] < seg[1] ? label_of(hi_of(keys[seg[0]])) : SENTINEL;
  if (threadIdx.x == 0) {
    out.reps[k] = rep;
    if (k == 0) out.cluster_overflow[0] = n_distinct > p.K;
  }
  slot_stats(k, rep, seg[1] - seg[0], keys, 0, &seg[0], &seg[1], 1, fids, gi, p, out);
}

// F > SMEM_KEYS, launch 1: sort chunk blockIdx.x into gkeys; block 0 resets
// reps and the overflow for launch 3.
__global__ void __launch_bounds__(CHUNK_T) chunk_sort_kernel(
    const uint8_t* __restrict__ fvalid, const int32_t* __restrict__ labels, StatsParams p,
    unsigned long long* __restrict__ gkeys, StatsOut out) {
  extern __shared__ unsigned long long keys[];
  const int f0 = blockIdx.x * CHUNK, n = min(CHUNK, p.F - f0);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    keys[i] = key_of(fvalid[f0 + i] != 0, labels[f0 + i], f0 + i);
  if (blockIdx.x == 0) {
    for (int k = threadIdx.x; k < p.K; k += blockDim.x) out.reps[k] = SENTINEL;
    if (threadIdx.x == 0) out.cluster_overflow[0] = 0;
  }
  __syncthreads();
  block_sort(keys, n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) gkeys[f0 + i] = keys[i];
}

// launch 2: gheads[i] = the label heads at or before position i of its
// chunk: run heads whose label no earlier chunk holds
__global__ void __launch_bounds__(CHUNK_T) chunk_heads_kernel(
    const unsigned long long* __restrict__ gkeys, StatsParams p, int32_t* __restrict__ gheads) {
  __shared__ int shi[32];
  const int c = blockIdx.x, f0 = c * CHUNK, n = min(CHUNK, p.F - f0);
  const unsigned long long* a = gkeys + f0;
  const int per = (n + (int)blockDim.x - 1) / (int)blockDim.x;
  const int i0 = min((int)threadIdx.x * per, n), i1 = min(i0 + per, n);
  uint32_t heads = 0;
  for (int i = i0; i < i1; ++i) {
    bool head = run_head(a, i);
    const uint32_t h = hi_of(a[i]);
    for (int e = 0; e < c && head; ++e) {  // earlier chunks are whole
      const unsigned long long* b = gkeys + (size_t)e * CHUNK;
      const int j = lower_hi(b, CHUNK, h);
      head = !(j < CHUNK && hi_of(b[j]) == h);
    }
    heads |= (uint32_t)head << (i - i0);
  }
  int total;
  int r = block_scan(__popc(heads), shi, &total);
  for (int i = i0; i < i1; ++i) {
    r += (heads >> (i - i0)) & 1u;
    gheads[f0 + i] = r;
  }
}

// launch 3: each label head's rank = the heads below its label over every
// chunk; reps[rank] for the first K, the overflow past them
__global__ void __launch_bounds__(CHUNK_T) chunk_rank_kernel(
    const unsigned long long* __restrict__ gkeys, const int32_t* __restrict__ gheads,
    StatsParams p, int nch, StatsOut out) {
  const int f0 = blockIdx.x * CHUNK, n = min(CHUNK, p.F - f0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (gheads[f0 + i] == (i > 0 ? gheads[f0 + i - 1] : 0)) continue;  // not a label head
    const uint32_t h = hi_of(gkeys[f0 + i]);
    int rank = 0;
    for (int e = 0; e < nch; ++e) {
      const int j = lower_hi(gkeys + (size_t)e * CHUNK, min(CHUNK, p.F - e * CHUNK), h);
      rank += j > 0 ? gheads[e * CHUNK + j - 1] : 0;
    }
    if (rank < p.K)
      out.reps[rank] = label_of(h);
    else
      out.cluster_overflow[0] = 1;
  }
}

// launch 4: block k reduces the runs of label reps[k] in every chunk
__global__ void __launch_bounds__(STATS_T) chunk_stats_kernel(
    const unsigned long long* __restrict__ gkeys, const int32_t* __restrict__ fids, GateIn gi,
    StatsParams p, int nch, StatsOut out) {
  extern __shared__ int segs[];  // lo [nch], hi [nch]
  __shared__ int shi[32];
  const int k = blockIdx.x;
  const int32_t rep = out.reps[k];
  const uint32_t h = (uint32_t)rep ^ 0x80000000u;
  int cnt = 0;
  for (int e = threadIdx.x; e < nch; e += blockDim.x) {
    int lo = 0, hi = 0;
    if (rep != SENTINEL) {
      const unsigned long long* b = gkeys + (size_t)e * CHUNK;
      const int ne = min(CHUNK, p.F - e * CHUNK);
      lo = lower_hi(b, ne, h);
      hi = lower_hi(b, ne, h, true);
    }
    segs[e] = lo;
    segs[nch + e] = hi;
    cnt += hi - lo;
  }
  int total;
  block_scan(cnt, shi, &total);
  slot_stats(k, rep, total, gkeys, CHUNK, segs, segs + nch, nch, fids, gi, p, out);
}

}  // namespace

// fids: int32 [F]; fvalid: bool [F]; labels: int32 [F], the far voxels'
// labels (the caller looks them up: one gather on one device, a lookup over
// the shards on the grid-sharded step); (ny, nx): the grid's; sensor_pos:
// float32 [3]; bg_sufficient / sure_bg_sufficient: bool scalars; ftotal:
// int32 scalar (far voxels in the whole grid).  grid_f: host float32
// [origin x, y, z, voxel]; gates: host float32 [min_points, max_distance,
// max_size, max_explore_distance].  outs: the outputs, device, in
// StatsOut's layout (108 K + 1 bytes).  scratch: device, 8-byte aligned,
// scratch_bytes long; used when F > SMEM_KEYS, which needs 12 x CHUNK x
// ceil(F / CHUNK) bytes (else cudaErrorInvalidValue).
VOFOD_API int vofod_cluster_stats(const void* fids, const void* fvalid, const void* labels,
                                  int F, int K, int ny, int nx, const float* grid_f,
                                  const float* gates, const void* sensor_pos,
                                  const void* bg_sufficient, const void* sure_bg_sufficient,
                                  const void* ftotal, void* outs, void* scratch,
                                  long long scratch_bytes, void* stream) {
  if (F <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const StatsParams p{F, K, nx, ny, grid_f[0], grid_f[1], grid_f[2], grid_f[3],
                      gates[0], gates[1], gates[2], gates[3]};
  const StatsOut out = carve(outs, K);
  const GateIn gi{static_cast<const float*>(sensor_pos),
                  static_cast<const uint8_t*>(bg_sufficient),
                  static_cast<const uint8_t*>(sure_bg_sufficient),
                  static_cast<const int32_t*>(ftotal)};
  const int32_t* fid = static_cast<const int32_t*>(fids);
  const uint8_t* fv = static_cast<const uint8_t*>(fvalid);
  const int32_t* lab = static_cast<const int32_t*>(labels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (F <= SMEM_KEYS) {
    int t = 32;  // a thread per two keys
    while (t < SORT_T && 2 * t < F) t <<= 1;
    const size_t smem = (size_t)F * sizeof(unsigned long long);
    if ((err = allow_smem(slots_kernel, smem)) != 0) return err;
    slots_kernel<<<K, t, smem, s>>>(fid, fv, lab, gi, p, out);
    return (int)cudaGetLastError();
  }
  const int nch = (F + CHUNK - 1) / CHUNK;
  if (scratch == nullptr || scratch_bytes < 12LL * CHUNK * nch) return (int)cudaErrorInvalidValue;
  unsigned long long* gkeys = static_cast<unsigned long long*>(scratch);
  int32_t* gheads = reinterpret_cast<int32_t*>(gkeys + (size_t)nch * CHUNK);
  const size_t key_smem = CHUNK * sizeof(unsigned long long);
  const size_t seg_smem = 2 * (size_t)nch * sizeof(int);
  if ((err = allow_smem(chunk_sort_kernel, key_smem)) != 0) return err;
  if ((err = allow_smem(chunk_stats_kernel, seg_smem)) != 0) return err;
  chunk_sort_kernel<<<nch, CHUNK_T, key_smem, s>>>(fv, lab, p, gkeys, out);
  chunk_heads_kernel<<<nch, CHUNK_T, 0, s>>>(gkeys, p, gheads);
  chunk_rank_kernel<<<nch, CHUNK_T, 0, s>>>(gkeys, gheads, p, nch, out);
  chunk_stats_kernel<<<K, STATS_T, seg_smem, s>>>(gkeys, fid, gi, p, nch, out);
  return (int)cudaGetLastError();
}

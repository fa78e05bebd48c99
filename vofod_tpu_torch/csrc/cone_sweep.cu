// K4 — six-cone plane-sweep transmittance (the freespace raycast's core).
//
// Replaces vofod_tpu/ops/raycast.py `_sweep_cones` / `_cone_scan_step`
// inside `_sweep_frame`: for each of the six axis cones (x+, x-, y+, y-,
// z+, z-) a sequential recurrence over the planes moving away from the
// sensor, T_in(plane) = seed ? 1 : resample(carry), carry = T_in * (1 -
// opacity), where the resample is a separable 4-tap interpolation of the
// previous plane toward the sensor (first along the lateral B axis, then
// along A).  The carry is bf16, as in the JAX sweep.
//
// Bound on the H100: latency, not bytes.  The flagship window is 97 x 97 x
// 51 voxels around the sensor, so the x/y cones step through 97 planes of
// 51 x 97 and the z cones through 51 planes of 97 x 97; each plane step
// depends on the previous one, so the time is planes x the latency of one
// step.  The design (`cone_cluster_kernel`) shortens that step:
//   * each cone runs on a thread-block cluster of C = 16 blocks (a
//     non-portable size), each block owning a band of the plane's A
//     rows (z for the x/y cones, y for the z cones): 96 SMs in place of 6;
//   * the B pass (along a row) reads only the block's own carry rows; the
//     A pass at row a reads the B-resampled rows a - 1 .. a + 2, at a
//     band's edge from the neighbouring blocks through distributed shared
//     memory.  The B-resampled plane is double-buffered by plane parity, so
//     one cluster barrier and one block barrier a plane suffice: no block
//     can overwrite a buffer a neighbour still reads;
//   * nothing inside the recurrence reads device memory: before the plane
//     loop each block packs its band's opacity for every plane as bits (32
//     voxels of x a word, from aligned 16-byte loads) and copies the
//     offsets into shared memory;
//     each plane's tap weights (bf16, 8 bytes a lane) are computed during
//     the plane before, by the threads the passes leave idle, into a
//     buffer of the other parity;
//   * T is written in runs along x: the y and z cones' lanes are x already;
//     the x cones stage 32 planes of their lanes in shared memory (bf16: T
//     is bf16-exact) and store each lane's 32 planes as one 128-byte run.
// The carry stays in bf16 in shared memory as before.
//
// Arithmetic, fixed so that the plain PyTorch version reproduces it: tap
// weights in f32 exactly as `_tap_weights`, rounded to bf16; each resample
// is w0*p[i-1] + w1*p[i] + w2*p[i+1] + w3*p[i+2] in f32, summed left to
// right with __fmul_rn / __fadd_rn (no FMA), out-of-plane taps reading 1.0,
// and rounded to bf16 after each of the two lateral passes.  So T is
// bit-equal to the plain version's.
//
// The grid-sharded sweep (vofod_tpu/ops/raycast.py raycast_sweep_zsharded)
// runs on the same cluster kernel, with K4's arithmetic, so its T is
// bit-equal to the dense sweep's.  Three launches of it keep kernels of
// their own (`cone_cluster_lat_kernel`, `cone_cluster_zt_kernel`: one body,
// one symbol each, so a profile tells them apart):
//
// K15b-3 `vofod_cone_sweep_lat` replaces `_sweep_cones_lat_sharded`
// (raycast.py:248): the x and y cones of a shard holding nzl of the nz z
// rows.  A plane step's A (= z) pass at row a reads rows a - 1 .. a + 2, so
// a slab whose edges are not the grid's loses one exact row a plane below
// and two above; a global edge reads 1.0 and stays exact.  A launch sweeps
// k planes over the shard's rows extended by k rows below and 2k above
// (clipped to the grid: no row past its edges), writes T only for the
// shard's own rows and leaves the carry of every row of the slab; the host
// refills the halo rows from the neighbours' own rows (K15b-1's in-place
// fill) before the next launch.  ceil(max(wx, wy) / k) launches a shard a
// scan; at the flagship's 3 x 17 rows any k >= 34 reaches the whole column.
//
// K15b-4a `vofod_cone_sweep_z` replaces `_sweep_cones_z_pipelined`
// (raycast.py:361): the z cones with the sweep axis sharded, n rounds with
// the carry plane passed along (cone 0 up, cone 1 down), shard s keeping
// cone 0 from round s and cone 1 from round n - 1 - s.  The rounds a shard
// does not keep compute values no kept round reads (JAX's SPMD program runs
// them because every shard runs one program), so a launch sweeps only the
// shard's kept cones of its round: one to two launches a shard a scan, a
// cone sweep each kept cone.  Bound: latency, the planes' dependent steps.
// A launch is K4's cluster kernel on the shard's planes (`cones` its kept
// cones, each on a cluster of CONE_CLUSTER blocks with bands of y rows),
// starting from the received carry plane and leaving the last plane's
// carry.
//
// K15b-4b `vofod_cone_sweep_zt` replaces `_sweep_cones_z_transposed`
// (raycast.py:308, zcone_mode="transpose"): both z cones over all nz planes
// on a shard's nyl = ceil(wy / n) rows of the window's y, K15b-3's scheme
// with A = y: k planes a launch on the rows extended by k below and 2k
// above, clipped at the window's true extent wy (the rows past it read 1.0
// at the slab's edge, the value the dense sweep's taps read there, so no
// row is pinned).  Both cones are written in grid order (z ascending), as
// K4 writes them.  ceil(nz / k) launches a shard a scan.
//
// Bound of both: latency, k dependent plane steps a launch at K4's step.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// `_tap_weights` for one lateral lane: sample the previous plane at
// -rel_lat / rel_s (clipped to +-1 voxel per plane), 4 bf16-rounded weights.
__device__ __forceinline__ void tap_weights(float rel_s, float rel_lat,
                                            float* w) {
  const float rs = fabsf(rel_s) < 0.5f ? 0.5f : rel_s;
  const float f = fminf(fmaxf(__fdiv_rn(-rel_lat, rs), -1.0f), 1.0f);
  const float lo = floorf(f);
  const float frac = __fsub_rn(f, lo);
  const float omf = __fsub_rn(1.0f, frac);
  w[0] = round_bf16(lo == -1.0f ? omf : 0.0f);
  w[1] = round_bf16(__fadd_rn(lo == -1.0f ? frac : 0.0f, lo == 0.0f ? omf : 0.0f));
  w[2] = round_bf16(__fadd_rn(lo == 0.0f ? frac : 0.0f, lo == 1.0f ? omf : 0.0f));
  w[3] = round_bf16(lo == 1.0f ? frac : 0.0f);
}

__device__ __forceinline__ float lerp4(const float* w, float m1, float c,
                                       float p1, float p2) {
  float v = __fmul_rn(w[0], m1);
  v = __fadd_rn(v, __fmul_rn(w[1], c));
  v = __fadd_rn(v, __fmul_rn(w[2], p1));
  return __fadd_rn(v, __fmul_rn(w[3], p2));
}

// the B pass of a carry row at lane b (1.0 past its ends), before rounding
__device__ __forceinline__ float row_b_pass(const float* wb, const __nv_bfloat16* crow, int b,
                                            int nB) {
  const float m1 = b >= 1 ? __bfloat162float(crow[b - 1]) : 1.0f;
  const float c0 = __bfloat162float(crow[b]);
  const float p1 = b + 1 < nB ? __bfloat162float(crow[b + 1]) : 1.0f;
  const float p2 = b + 2 < nB ? __bfloat162float(crow[b + 2]) : 1.0f;
  return lerp4(wb, m1, c0, p1, p2);
}

// One cone's geometry in the window: nS planes of nA x nB lanes, the
// strides of the sweep axis S and the lateral axes A, B in T's [nz, ny,
// nx] layout, and the voxel-centre offsets along each.
struct Cone {
  int nS, nA, nB;
  size_t st_s, st_a, st_b;
  const float *rel_s, *rel_a, *rel_b;
};

__device__ __forceinline__ Cone cone_of(int axis, const float* rel_x, const float* rel_y,
                                        const float* rel_z, int nz, int ny, int nx) {
  if (axis == 0)  // x cones: A = z, B = y
    return {nx, nz, ny, 1, (size_t)ny * nx, (size_t)nx, rel_x, rel_z, rel_y};
  if (axis == 1)  // y cones: A = z, B = x
    return {ny, nz, nx, (size_t)nx, (size_t)ny * nx, 1, rel_y, rel_z, rel_x};
  return {nz, ny, nx, (size_t)ny * nx, (size_t)nx, 1, rel_z, rel_y, rel_x};  // z: A = y, B = x
}

constexpr int CLUSTER_THREADS = 1024;
constexpr int CONE_CLUSTER = 16;  // blocks a cone: 96 SMs for the six cones
constexpr int STAGE = 32;        // planes of the x cones' T staged per store run
constexpr int STAGE_PITCH = 34;  // bf16 a staged lane: 17 words, so lanes hit distinct banks

// Byte offsets of one block's shared memory, the same in every block of the
// launch (sized for the largest of the three cone shapes at cluster size C;
// the host sizes the launch with the same function).
struct ClusterSmem {
  size_t rs, rel_b, rel_a, wb, wa, bits, rowp, carry, tmp, stage, total;
};

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~(size_t)15; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline ClusterSmem cluster_smem(int nz, int ny, int nx, int C) {
  const int band_z = (nz + C - 1) / C, band_y = (ny + C - 1) / C;
  const int band = imax(band_z, band_y), n_b = imax(nx, ny);
  const int n_s = imax(nx, imax(ny, nz));
  const int lanes = imax(band_z * n_b, band_y * nx);
  const int words = imax(band_z * ny, nz * band_y) * ((nx + 31) / 32);
  ClusterSmem m;
  m.rs = 0;
  m.rel_b = align16(m.rs + 4 * (size_t)n_s);
  m.rel_a = align16(m.rel_b + 4 * (size_t)n_b);
  m.wb = align16(m.rel_a + 4 * (size_t)band);
  m.wa = align16(m.wb + 8 * 2 * (size_t)n_b);
  m.bits = align16(m.wa + 8 * 2 * (size_t)band);
  m.rowp = align16(m.bits + 4 * (size_t)words);
  m.carry = align16(m.rowp + 8 * 2 * (size_t)(band + 3));
  m.tmp = align16(m.carry + 2 * (size_t)lanes);
  m.stage = align16(m.tmp + 2 * 2 * (size_t)lanes);
  m.total = align16(m.stage + 2 * (size_t)STAGE_PITCH * band_z * ny);
  return m;
}

// Tap weights of plane p for lane i of the block: B lane i < nB, else its
// own A row i - nB; packed as 4 bf16 (each weight is bf16-rounded, so its
// upper 16 bits are the bf16).
__device__ __forceinline__ void plane_weights(const float* rs, const float* rel_b,
                                              const float* rel_a, int p, int i, int nB,
                                              uint2* wb, uint2* wa) {
  float w[4];
  tap_weights(rs[p], i < nB ? rel_b[i] : rel_a[i - nB], w);
  const uint2 packed =
      make_uint2((__float_as_uint(w[0]) >> 16) | (__float_as_uint(w[1]) & 0xffff0000u),
                 (__float_as_uint(w[2]) >> 16) | (__float_as_uint(w[3]) & 0xffff0000u));
  if (i < nB)
    wb[i] = packed;
  else
    wa[i - nB] = packed;
}

__device__ __forceinline__ void unpack_weights(uint2 p, float* w) {
  w[0] = __uint_as_float(p.x << 16);
  w[1] = __uint_as_float(p.x & 0xffff0000u);
  w[2] = __uint_as_float(p.y << 16);
  w[3] = __uint_as_float(p.y & 0xffff0000u);
}

// One launch of the cluster sweep.  The slab is (nz, ny, nx) voxels of the
// window; `opaque` points at its first voxel, its z rows op_ny y rows apart
// (op_ny > ny where the slab is a band of the window's y); rel_* at the
// slab's first row of each axis.  Each cone sweeps its planes [p0, p1)
// counted from the sensor side (clipped to its own nS).  T holds the cones
// from `t_first` on, [cone - t_first][t_nz][t_ny][nx]; of a cone's A rows
// only the slab's [t_lo, t_hi) are written, at T row a - t_lo.  carry_in
// (NULL: the carry starts at 1.0) and carry_out (NULL: not written) hold
// the carry of every row of the slab before the first plane and after the
// last, element (cone - t_first) c_cone + a c_row + b; they may be one
// buffer (a block reads only the rows it writes, before it writes them).
struct ConeLaunch {
  const uint8_t* opaque;
  const float *rel_x, *rel_y, *rel_z;
  float* T;
  const __nv_bfloat16* carry_in;
  __nv_bfloat16* carry_out;
  long long c_cone, c_row;
  int nz, ny, nx, op_ny;
  int t_nz, t_ny, t_lo, t_hi;
  int p0, p1, cones, t_first;
};

// The cluster sweep: cluster c = blockIdx.x / C sweeps the c-th cone set in
// `cones` (bit i: cone i of x+, x-, y+, y-, z+, z-); block rank k of the
// cluster owns the A rows [k nA / C, (k + 1) nA / C).
__device__ __forceinline__ void cone_cluster_body(const ConeLaunch& L) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  int cone = 0;
  for (int c = blockIdx.x / C;; ++cone)
    if (((L.cones >> cone) & 1) && c-- == 0) break;
  const int axis = cone >> 1;
  const bool back = cone & 1;
  const int nz = L.nz, ny = L.ny, nx = L.nx;
  const Cone g = cone_of(axis, L.rel_x, L.rel_y, L.rel_z, nz, ny, nx);
  const Cone gt = cone_of(axis, L.rel_x, L.rel_y, L.rel_z, L.t_nz, L.t_ny, nx);  // T's strides
  const int nS = g.nS, nA = g.nA, nB = g.nB;
  const int p0 = L.p0, p_end = L.p1 < nS ? L.p1 : nS;
  const int a0 = rank * nA / C, band = (rank + 1) * nA / C - a0;
  const int band_max = (nA + C - 1) / C;  // the tmp rows of every block of the cluster
  const int lanes = band * nB;
  const int nwx = (nx + 31) / 32;
  const int tid = threadIdx.x, nthr = blockDim.x;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ClusterSmem m = cluster_smem(nz, ny, nx, C);
  float* rs = reinterpret_cast<float*>(smem_raw + m.rs);        // [nS] signed rel_s a plane
  float* rel_b = reinterpret_cast<float*>(smem_raw + m.rel_b);  // [nB]
  float* rel_a = reinterpret_cast<float*>(smem_raw + m.rel_a);  // [band], own rows
  uint2* wb = reinterpret_cast<uint2*>(smem_raw + m.wb);        // [2][nB] by plane parity
  uint2* wa = reinterpret_cast<uint2*>(smem_raw + m.wa);        // [2][band]
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem_raw + m.bits);
  const __nv_bfloat16** rowp = reinterpret_cast<const __nv_bfloat16**>(smem_raw + m.rowp);
  __nv_bfloat16* carry = reinterpret_cast<__nv_bfloat16*>(smem_raw + m.carry);  // [band][nB]
  __nv_bfloat16* tmp = reinterpret_cast<__nv_bfloat16*>(smem_raw + m.tmp);  // [2][band_max][nB]
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem_raw + m.stage);
  // --- prologue: offsets, the first plane's weights, opacity bits, carry,
  // the A pass's row pointers, all in shared memory
  for (int i = tid; i < nS + nB + band; i += nthr) {
    if (i < nS) {
      const int s = back ? nS - 1 - i : i;
      rs[i] = back ? -g.rel_s[s] : g.rel_s[s];
    } else if (i < nS + nB) {
      rel_b[i - nS] = g.rel_b[i - nS];
    } else {
      rel_a[i - nS - nB] = g.rel_a[a0 + i - nS - nB];
    }
  }
  // opacity rows (z, y) of this block as bits, 32 voxels of x a word: the
  // band's z rows and every y (x/y cones), or every z and the band's y rows
  // (z cones).  For each z those rows are one run of bytes, read in aligned
  // 16-byte loads, 4 in flight a thread; the opaque voxels are OR-ed in.
  const int rz = axis < 2 ? band : nz, ry = axis < 2 ? ny : band;
  const int z0 = axis < 2 ? a0 : 0, y0 = axis < 2 ? 0 : a0;
  const int n_words = rz * ry * nwx;
  for (int w = tid; w < n_words; w += nthr) bits[w] = 0u;
  __syncthreads();
  const long run = (long)ry * nx;
  const int n16 = (int)((run + 30) / 16);  // 16-byte words a run spans at most
  constexpr int IN_FLIGHT = 4;
  for (int q0 = tid; q0 < rz * n16; q0 += IN_FLIGHT * nthr) {
    uint4 v[IN_FLIGHT];
    long first[IN_FLIGHT];  // byte offset of each load's first byte in its run
    int zr[IN_FLIGHT];
#pragma unroll
    for (int k = 0; k < IN_FLIGHT; ++k) {
      const int q = q0 + k * nthr;
      zr[k] = q / n16;
      const uint8_t* base = L.opaque + ((size_t)(z0 + zr[k]) * L.op_ny + y0) * nx;
      const uintptr_t lo = reinterpret_cast<uintptr_t>(base) & ~(uintptr_t)15;
      first[k] = (long)(lo - reinterpret_cast<uintptr_t>(base)) + 16L * (q - zr[k] * n16);
      v[k] = make_uint4(0u, 0u, 0u, 0u);
      if (q < rz * n16 && first[k] < run)
        v[k] = *reinterpret_cast<const uint4*>(reinterpret_cast<const uint8_t*>(lo) +
                                               16L * (q - zr[k] * n16));
    }
#pragma unroll
    for (int k = 0; k < IN_FLIGHT; ++k) {
      const uint32_t w4[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
      for (int j = 0; j < 16; ++j) {
        const long off = first[k] + j;
        if (((w4[j >> 2] >> (8 * (j & 3))) & 0xffu) == 0u || off < 0 || off >= run) continue;
        const int r = (int)(off / nx), x = (int)(off - (long)r * nx);
        atomicOr(&bits[(zr[k] * ry + r) * nwx + (x >> 5)], 1u << (x & 31));
      }
    }
  }
  // the band's carry: lane i = (row al, lane b) at element c0 + al c_row + b
  const long long c0 = (long long)(cone - L.t_first) * L.c_cone + (long long)a0 * L.c_row;
  for (int i = tid; i < lanes; i += nthr) {
    const int al = i / nB, b = i - al * nB;
    carry[i] = L.carry_in != nullptr ? L.carry_in[c0 + al * L.c_row + b]
                                     : __float2bfloat16_rn(1.0f);
  }
  // rowp[par][k]: row a0 - 1 + k of the B-resampled plane of parity par, in
  // the shared memory of the block that owns it; NULL past the slab (1.0)
  for (int i = tid; i < 2 * (band + 3); i += nthr) {
    const int par = i / (band + 3), r = a0 - 1 + i % (band + 3);
    const __nv_bfloat16* ptr = nullptr;
    if (r >= 0 && r < nA) {
      const int owner = ((r + 1) * C - 1) / nA;
      __nv_bfloat16* local = tmp + ((size_t)par * band_max + r - owner * nA / C) * nB;
      ptr = cluster.map_shared_rank(local, owner);
    }
    rowp[i] = ptr;
  }
  __syncthreads();
  if (p0 < p_end)
    for (int i = tid; i < nB + band; i += nthr)
      plane_weights(rs, rel_b, rel_a, p0, i, nB, wb + (p0 & 1) * nB, wa + (p0 & 1) * band);
  __syncthreads();

  float* Tc = L.T + (size_t)(cone - L.t_first) * L.t_nz * L.t_ny * nx;
  for (int p = p0; p < p_end; ++p) {
    const int s = back ? nS - 1 - p : p;
    const bool seed = rs[p] <= 1.0f;
    const int par = p & 1;
    __nv_bfloat16* tb = tmp + (size_t)par * band_max * nB;
    const uint2* wbp = wb + par * nB;
    const uint2* wap = wa + par * band;
    // pass 1: resample the own carry rows along B
    for (int i = tid; i < lanes; i += nthr) {
      const int al = i / nB, b = i - al * nB;
      float w[4];
      unpack_weights(wbp[b], w);
      tb[i] = __float2bfloat16_rn(row_b_pass(w, carry + al * nB, b, nB));
    }
    cluster.sync();  // every block's B-resampled rows of this plane are ready
    // pass 2: resample along A (rows a - 1 .. a + 2, some in the
    // neighbours' shared memory), seed, T, attenuate into the carry
    const __nv_bfloat16* const* rows = rowp + par * (band + 3);
    for (int i = tid; i < lanes; i += nthr) {
      const int al = i / nB, b = i - al * nB;
      float t = 1.0f;
      if (!seed) {
        float w[4], v[4];
        unpack_weights(wap[al], w);
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const __nv_bfloat16* src = rows[al + d];
          v[d] = src != nullptr ? __bfloat162float(src[b]) : 1.0f;
        }
        t = round_bf16(lerp4(w, v[0], v[1], v[2], v[3]));
      }
      int x, word;
      if (axis == 0) {  // (z, y) = (a, b), x = s
        x = s;
        word = (al * ny + b) * nwx;
      } else if (axis == 1) {  // (z, y) = (a, s), x = b
        x = b;
        word = (al * ny + s) * nwx;
      } else {  // (z, y) = (s, a), x = b
        x = b;
        word = (s * band + al) * nwx;
      }
      const bool op = (bits[word + (x >> 5)] >> (x & 31)) & 1u;
      const int a = a0 + al;
      if (axis == 0)
        stage[i * STAGE_PITCH + p % STAGE] = __float2bfloat16_rn(t);  // bf16-exact
      else if (a >= L.t_lo && a < L.t_hi)
        Tc[(size_t)s * gt.st_s + (size_t)(a - L.t_lo) * gt.st_a + (size_t)b * gt.st_b] = t;
      carry[i] = __float2bfloat16_rn(op ? 0.0f : t);
    }
    // the next plane's weights, off the recurrence, by the highest threads
    // (idle in the passes above where the block has fewer lanes)
    if (p + 1 < p_end)
      for (int i = nthr - 1 - tid; i < nB + band; i += nthr)
        plane_weights(rs, rel_b, rel_a, p + 1, i, nB, wb + (par ^ 1) * nB,
                      wa + (par ^ 1) * band);
    __syncthreads();  // the carry, the staged planes and the weights complete
    if (axis == 0 && (p % STAGE == STAGE - 1 || p == p_end - 1)) {
      // each lane's staged planes as one run along x (descending for x-),
      // from the launch's first plane or the run's; the next plane's A pass
      // rewrites `stage` only after its cluster barrier, which every thread
      // reaches after this loop
      const int pr = p - p % STAGE, j0 = (pr > p0 ? pr : p0) - pr, j1 = p - pr;
      for (int i = tid; i < lanes * STAGE; i += nthr) {
        const int l = i / STAGE, j = i - l * STAGE;
        const int al = l / nB, b = l - al * nB, a = a0 + al;
        if (j < j0 || j > j1 || a < L.t_lo || a >= L.t_hi) continue;
        const int sj = back ? nS - 1 - (pr + j) : pr + j;
        Tc[(size_t)(a - L.t_lo) * gt.st_a + (size_t)b * gt.st_b + sj] =
            __bfloat162float(stage[l * STAGE_PITCH + j]);
      }
    }
  }
  // the last plane's carry (its barrier above completed it)
  if (L.carry_out != nullptr)
    for (int i = tid; i < lanes; i += nthr) {
      const int al = i / nB, b = i - al * nB;
      L.carry_out[c0 + al * L.c_row + b] = carry[i];
    }
  cluster.sync();  // no block leaves while a neighbour may read its rows
}

// K4 and K15b-4a
__global__ void __launch_bounds__(CLUSTER_THREADS) cone_cluster_kernel(const ConeLaunch L) {
  cone_cluster_body(L);
}

// K15b-3
__global__ void __launch_bounds__(CLUSTER_THREADS) cone_cluster_lat_kernel(const ConeLaunch L) {
  cone_cluster_body(L);
}

// K15b-4b
__global__ void __launch_bounds__(CLUSTER_THREADS) cone_cluster_zt_kernel(const ConeLaunch L) {
  cone_cluster_body(L);
}

}  // namespace

namespace {

// `kernel`'s clusters of L.cones (one each, C blocks, non-portable past 8)
// on the slab; clusters the card cannot hold at once run one after
// another.  Returns cudaGetLastError(), or the refusal of a cluster the
// card cannot schedule at all (never another launch).
int launch_cone_clusters(void (*kernel)(const ConeLaunch), const ConeLaunch& L, int C,
                         void* stream) {
  if (L.nz < 1 || L.ny < 1 || L.nx < 1 || L.cones <= 0 || L.cones >= 64 || C < 1 || C > 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = cluster_smem(L.nz, L.ny, L.nx, C).total;
  if (smem > 232448) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(__builtin_popcount(L.cones) * C);
  cfg.blockDim = dim3(CLUSTER_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (active < 1) return (int)cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kernel, L);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The window (nz, ny, nx) whole: every row of every cone written, carries
// as [cone][nA][nB] planes.
ConeLaunch whole_window(const void* opaque, const void* rel_x, const void* rel_y,
                        const void* rel_z, void* T, int nz, int ny, int nx, int cones,
                        int t_first) {
  ConeLaunch L = {};
  L.opaque = static_cast<const uint8_t*>(opaque);
  L.rel_x = static_cast<const float*>(rel_x);
  L.rel_y = static_cast<const float*>(rel_y);
  L.rel_z = static_cast<const float*>(rel_z);
  L.T = static_cast<float*>(T);
  L.nz = nz;
  L.ny = ny;
  L.nx = nx;
  L.op_ny = ny;
  L.t_nz = nz;
  L.t_ny = ny;
  L.t_lo = 0;
  L.t_hi = nz > ny ? nz : ny;
  L.p0 = 0;
  L.p1 = 0x7fffffff;
  L.cones = cones;
  L.t_first = t_first;
  return L;
}

// The sharded sweeps' slab [lo, hi) of the A axis of a window (nz, wy, wx)
// and its launch fields (K15b-3: A = z, K15b-4b: A = y); carry [hi - lo]
// [n_cones][pitch] bf16, read from plane p0 > 0 and written when more
// planes follow.  False on arguments out of range.
bool sharded_launch(ConeLaunch* L, const void* opaque, const void* rel_x, const void* rel_y,
                    const void* rel_z, void* carry, void* T, int nz, int wy, int wx, int lo,
                    int hi, int t_lo, int t_hi, int p0, int m, int n_s, int n_cones, int pitch,
                    bool a_is_z) {
  const int extent = a_is_z ? nz : wy;
  if (nz < 1 || wy < 1 || wx < 1 || lo < 0 || hi > extent || lo >= hi || t_lo < lo ||
      t_hi > hi || t_lo >= t_hi || p0 < 0 || m < 1 || p0 >= n_s)
    return false;
  const bool more = p0 + m < n_s;
  if ((p0 > 0 || more) && carry == nullptr) return false;
  const int rows = hi - lo;
  const uint8_t* op = static_cast<const uint8_t*>(opaque);
  if (a_is_z) {
    *L = whole_window(op + (size_t)lo * wy * wx, rel_x, rel_y,
                      static_cast<const float*>(rel_z) + lo, T, rows, wy, wx, 0x0f, 0);
    L->t_nz = t_hi - t_lo;
  } else {
    *L = whole_window(op + (size_t)lo * wx, rel_x, static_cast<const float*>(rel_y) + lo, rel_z,
                      T, nz, rows, wx, 0x30, 4);
    L->op_ny = wy;
  }
  L->t_lo = t_lo - lo;
  L->t_hi = t_hi - lo;
  L->p0 = p0;
  L->p1 = p0 + m;
  L->c_cone = pitch;
  L->c_row = (long long)n_cones * pitch;
  L->carry_in = p0 > 0 ? static_cast<const __nv_bfloat16*>(carry) : nullptr;
  L->carry_out = more ? static_cast<__nv_bfloat16*>(carry) : nullptr;
  return true;
}

}  // namespace

// opaque: device uint8 (nz, ny, nx); rel_*: device f32 voxel-centre offsets
// from the sensor; T: device f32 [6, nz, ny, nx].  Each cone runs on a
// cluster of CONE_CLUSTER blocks (non-portable); clusters the card cannot
// hold at once run one after another.  Returns cudaGetLastError(), or the
// refusal of a cluster the card cannot schedule at all (never another
// launch).
VOFOD_API int vofod_cone_sweep(const void* opaque, const void* rel_x, const void* rel_y,
                               const void* rel_z, void* T, int nz, int ny, int nx,
                               void* stream) {
  return launch_cone_clusters(cone_cluster_kernel,
                              whole_window(opaque, rel_x, rel_y, rel_z, T, nz, ny, nx, 0x3f, 0),
                              CONE_CLUSTER, stream);
}

// K15b-3, one launch: planes [p0, p0 + m) of the x and y cones (clipped to
// each cone's planes; p0 < max(wx, wy)) on the window's z rows [lo, hi).
// opaque: device uint8 window [nz, wy, wx]; rel_x [wx], rel_y [wy], rel_z
// [nz]: device f32 offsets (the whole window's); carry: device bf16 [hi -
// lo][4][max(wx, wy)] (cone c's lane b of row r at (r * 4 + c) * pb + b),
// read when p0 > 0 and written when planes follow, else may be NULL; T:
// device f32 [4, t_hi - t_lo, wy, wx], the x and y cones of the z rows
// [t_lo, t_hi) (within [lo, hi)).  Each cone on a cluster of CONE_CLUSTER
// blocks.
VOFOD_API int vofod_cone_sweep_lat(const void* opaque, const void* rel_x, const void* rel_y,
                                   const void* rel_z, void* carry, void* T, int nz, int wy,
                                   int wx, int lo, int hi, int t_lo, int t_hi, int p0, int m,
                                   void* stream) {
  const int pb = wx > wy ? wx : wy;
  ConeLaunch L;
  if (!sharded_launch(&L, opaque, rel_x, rel_y, rel_z, carry, T, nz, wy, wx, lo, hi, t_lo, t_hi,
                      p0, m, pb, 4, pb, true))
    return (int)cudaErrorInvalidValue;
  return launch_cone_clusters(cone_cluster_lat_kernel, L, CONE_CLUSTER, stream);
}

// K15b-4a, a shard's kept cones of one round.  opaque: device uint8 local
// window [nzl, wy, wx]; rel_x [wx], rel_y [wy], rel_z [nzl] (the slab's rows
// of the global column): device f32; carry_in / carry_out: device bf16 [2,
// wy, wx], of which the kept cones' planes are read / written; T: device
// f32 [2, nzl, wy, wx] (the z cones of the local T6); keep_mask: bit c
// sweeps cone c (z+, z-), at least one.
VOFOD_API int vofod_cone_sweep_z(const void* opaque, const void* rel_x, const void* rel_y,
                                 const void* rel_z, const void* carry_in, void* carry_out,
                                 void* T, int nzl, int wy, int wx, int keep_mask,
                                 void* stream) {
  if (keep_mask < 1 || keep_mask > 3 || carry_in == nullptr || carry_out == nullptr)
    return (int)cudaErrorInvalidValue;
  ConeLaunch L = whole_window(opaque, rel_x, rel_y, rel_z, T, nzl, wy, wx, keep_mask << 4, 4);
  L.carry_in = static_cast<const __nv_bfloat16*>(carry_in);
  L.carry_out = static_cast<__nv_bfloat16*>(carry_out);
  L.c_cone = (long long)wy * wx;
  L.c_row = wx;
  return launch_cone_clusters(cone_cluster_kernel, L, CONE_CLUSTER, stream);
}

// K15b-4b, one launch: planes [p0, p0 + m) of both z cones (p0 < nz) on the
// window's y rows [lo, hi) (hi <= wy).  opaque: device uint8 window [nz,
// wy, wx]; rel_x [wx], rel_y [wy], rel_z [nz]: device f32; carry: device
// bf16 [hi - lo][2][wx], read when p0 > 0 and written when planes follow,
// else may be NULL; T: device f32 [2, nz, t_ny, wx], the y rows [t_lo,
// t_hi) (within [lo, hi), t_hi - t_lo <= t_ny) at its rows from 0.  Each
// cone on a cluster of CONE_CLUSTER blocks.
VOFOD_API int vofod_cone_sweep_zt(const void* opaque, const void* rel_x, const void* rel_y,
                                  const void* rel_z, void* carry, void* T, int nz, int wy,
                                  int wx, int lo, int hi, int t_lo, int t_hi, int t_ny, int p0,
                                  int m, void* stream) {
  ConeLaunch L;
  if (t_ny < t_hi - t_lo ||
      !sharded_launch(&L, opaque, rel_x, rel_y, rel_z, carry, T, nz, wy, wx, lo, hi, t_lo, t_hi,
                      p0, m, nz, 2, wx, false))
    return (int)cudaErrorInvalidValue;
  L.t_ny = t_ny;
  return launch_cone_clusters(cone_cluster_zt_kernel, L, CONE_CLUSTER, stream);
}

// The streamed run-table pool of K1 (csrc/ball_pool.cu; the design is
// described there), shared by the kernels that are K1 with another staging
// rule and another store: K11's demotion EMA and K13c (csrc/ema.cu).
//
// pool_stream is the kernel body.  Its policy IO says what a staged cell
// holds and what becomes of a pooled output unit:
//
//   plane(zi, ok), row(gy, ok),  the source index of input plane zi (the
//   col(gx, ok)                  chunk's rows, local to the output), row gy
//                                and column gx; ok false stages none
//   Raw, load(i), none           what a staged cell loads from source index
//                                i (none: the cell outside the source), held
//                                in registers for a plane step
//   stage(raw)                   the staged value built from it when it is
//                                put into shared memory (nothing intermediate
//                                stored; a value that needs two loads waits
//                                for neither at the load)
//   SKIP, row_any(zi, gy, lo,    with SKIP, whether staged row gy of input
//   hi)                          plane zi, columns [lo, hi), may stage a
//                                value other than 0 (true when unsure): a
//                                block whose whole chunk stages none runs
//                                only its epilogue, on a pool of nothing
//   store(zo, gy, gx, v)         the epilogue: output plane zo, row gy, the
//                                unit's first column gx and its pooled lanes
//                                v (the unit may reach past nx)
#pragma once

#include "common.cuh"

namespace {

constexpr int BP_GROUP = 8;                      // pair pools held in shared memory at once
constexpr int BP_XPAD = 8;                       // staged columns each side (>= halo)

// The run table (ops/morphology.RunTable): the distinct x-run pairs
// (lo, hi), in groups of BP_GROUP; per group, sym[g][w] the index in the
// group of the pair (-w, w) (-1: none), and its z slices
// [gslice[g], gslice[g + 1]), slice q the rows [sbegin[q], send[q]) feeding
// the accumulators of kmask[q] (bit k: k = halo - dz); a row is
// (dy + 7) << 8 | its pair's index in the group.
template <int MAXR, int MAXROWS, int MAXSL, int HMAX_>
struct RunTableN {
  static constexpr int HMAX = HMAX_;
  static constexpr int MAX_RUNS = MAXR;
  static constexpr int MAX_ROWS = MAXROWS;
  static constexpr int MAX_SLICES = MAXSL;
  static constexpr int MAX_GROUPS = (MAXR + BP_GROUP - 1) / BP_GROUP;
  int halo, n_runs, n_rows, n_slices;
  signed char lo[MAXR], hi[MAXR];
  signed char sym[MAX_GROUPS][8];
  unsigned short gslice[MAX_GROUPS + 1];
  unsigned short sbegin[MAXSL], send[MAXSL], kmask[MAXSL];
  unsigned short row[MAXROWS];
};
// the tiny table: every tap set within halo 1 (the 6 (lo, hi) pairs, 3 x 3
// (dz, dy) rows of at most 2 runs, 3 slices): 3 accumulators a thread,
// which the demotion balls of the flagship radius (1.6) take; the small
// table: the production radii (at most 16 pairs, 256 rows and 14 slices,
// halo 3; 668 bytes of parameters); the large one: every (lo, hi) pair
// within halo 7 (120), 15 slices a group of 8 pairs, and every row set of
// 15 x 15 (dz, dy) rows of at most 8 runs each (5.4 KB)
using RunTableTiny = RunTableN<8, 18, 3, 1>;
using RunTableSmall = RunTableN<16, 256, 14, 3>;
using RunTableLarge = RunTableN<120, 1800, 225, VOFOD_MAX_HALO>;

// The packed table (int16): halo, n_runs, n_rows, n_slices; lo, hi per
// pair; sym (8 a group); gslice; sbegin, send, kmask per slice; row.  False
// when it breaks a bound the kernel's shared-memory indexing relies on.
template <typename Tab>
bool parse_table(const short* b, int len, Tab* t) {
  if (len < 4) return false;
  const int h = b[0], nr = b[1], nrows = b[2], nsl = b[3];
  if (h < 0 || h > Tab::HMAX || nr < 1 || nr > Tab::MAX_RUNS || nrows < 1 ||
      nrows > Tab::MAX_ROWS || nsl < 1 || nsl > Tab::MAX_SLICES)
    return false;
  const int ng = (nr + BP_GROUP - 1) / BP_GROUP;
  if (len != 4 + 2 * nr + 8 * ng + ng + 1 + 3 * nsl + nrows) return false;
  t->halo = h;
  t->n_runs = nr;
  t->n_rows = nrows;
  t->n_slices = nsl;
  const short* p = b + 4;
  for (int i = 0; i < nr; ++i, p += 2) {
    if (p[0] < -h || p[1] > h || p[0] > p[1]) return false;
    t->lo[i] = (signed char)p[0];
    t->hi[i] = (signed char)p[1];
  }
  for (int g = 0; g < ng; ++g, p += 8) {
    const int in_group = nr - g * BP_GROUP < BP_GROUP ? nr - g * BP_GROUP : BP_GROUP;
    for (int w = 0; w < 8; ++w) {
      const int i = p[w];
      if (i < -1 || i >= in_group || (i >= 0 && (w > h || t->lo[g * BP_GROUP + i] != -w ||
                                                t->hi[g * BP_GROUP + i] != w)))
        return false;
      t->sym[g][w] = (signed char)i;
    }
    // every symmetric pair is the chain's: the kernel pools no other way
    for (int i = 0; i < in_group; ++i)
      if (t->lo[g * BP_GROUP + i] == -t->hi[g * BP_GROUP + i] &&
          t->sym[g][t->hi[g * BP_GROUP + i]] != i)
        return false;
  }
  for (int g = 0; g <= ng; ++g, ++p) {
    if (p[0] < (g == 0 ? 0 : t->gslice[g - 1]) || p[0] > nsl || (g == 0 && p[0] != 0)) return false;
    t->gslice[g] = (unsigned short)p[0];
  }
  if (t->gslice[ng] != nsl) return false;
  for (int q = 0; q < nsl; ++q, p += 3) {
    if (p[0] < 0 || p[0] > p[1] || p[1] > nrows || p[2] < 0 || (p[2] >> (2 * h + 1)) != 0)
      return false;
    t->sbegin[q] = (unsigned short)p[0];
    t->send[q] = (unsigned short)p[1];
    t->kmask[q] = (unsigned short)p[2];
  }
  for (int i = 0; i < nrows; ++i) t->row[i] = (unsigned short)p[i];
  for (int g = 0; g < ng; ++g) {
    const int in_group = nr - g * BP_GROUP < BP_GROUP ? nr - g * BP_GROUP : BP_GROUP;
    for (int q = t->gslice[g]; q < t->gslice[g + 1]; ++q)
      for (int i = t->sbegin[q]; i < t->send[q]; ++i) {
        const int dy = (t->row[i] >> 8) - VOFOD_MAX_HALO;
        if (dy < -h || dy > h || (t->row[i] & 0xFF) >= in_group) return false;
      }
  }
  return true;
}

// A thread's unit of the tile: NW words of VX voxels in x; a block is
// TXU x TY units, one a thread.  int8 voxels are carried
// as sign-extended 16-bit pairs, two a word, whose min / max the H100 does
// in one instruction (its DPX max.s16x2 / min.s16x2; four packed bytes
// would take six); int32 voxels one a word.  SW: a staged row, in words
// (int8: bytes; 16 mod 32 words, so that a warp's two rows take different
// banks; int32: a multiple of 4, so that a unit's window loads are 16-byte
// loads).
template <typename T>
struct Lanes;
template <>
struct Lanes<int8_t> {
  using W = uint32_t;
  static constexpr int NW = 4, VX = 8, TXU = 16, TY = 16, SW = 48;
};
template <>
struct Lanes<int32_t> {
  using W = int32_t;
  static constexpr int NW = 4, VX = 4, TXU = 16, TY = 16, SW = 80;
};

template <typename W, int NW>
struct alignas(4 * NW) Vec {
  W w[NW];
};

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;  // selector nibbles with bit 3 set replicate the byte's sign
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// the prmt selector taking bytes b and b + 1 of (a, b) as two s16 lanes
__device__ __forceinline__ constexpr uint32_t sext_pair(int b) {
  return b | (b | 8) << 4 | (b + 1) << 8 | ((b + 1) | 8) << 12;
}

// int8 pairs: OP 0 = min, 1 = max, 2 = sum.  The sum is one 32-bit add of
// the two 16-bit lanes: exact only while every lane stays in [0, 2^16) (no
// carry into the high lane), which K13c's 0/1 centre masks keep (a voxel sums
// at most the ball's 2,112 taps); ball_pool takes no int8 sum
template <int OP>
__device__ __forceinline__ uint32_t combine1(uint32_t a, uint32_t b) {
  uint32_t d;
  if (OP == 0) {
    asm("min.s16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  } else if (OP == 1) {
    asm("max.s16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  } else {
    d = a + b;
  }
  return d;
}

template <int OP>  // OP 0 = min, 1 = max, 2 = sum (wraps like XLA's int32 add)
__device__ __forceinline__ int32_t combine1(int32_t a, int32_t b) {
  if (OP == 0) return a < b ? a : b;
  if (OP == 1) return a > b ? a : b;
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

template <int OP, typename W, int NW>
__device__ __forceinline__ Vec<W, NW> combine(Vec<W, NW> a, const Vec<W, NW>& b) {
#pragma unroll
  for (int j = 0; j < NW; ++j) a.w[j] = combine1<OP>(a.w[j], b.w[j]);
  return a;
}

template <typename T, int OP>
__device__ __forceinline__ typename Lanes<T>::W identity() {
  if constexpr (sizeof(T) == 1) {
    return OP == 0 ? 0x007F007Fu : OP == 1 ? 0xFF80FF80u : 0u;  // 127, -128, 0 a s16 lane
  } else {
    return OP == 0 ? INT32_MAX : OP == 1 ? INT32_MIN : 0;
  }
}

template <typename T, int OP>
__device__ __forceinline__ Vec<typename Lanes<T>::W, Lanes<T>::NW> identity_vec() {
  Vec<typename Lanes<T>::W, Lanes<T>::NW> v;
#pragma unroll
  for (int j = 0; j < Lanes<T>::NW; ++j) v.w[j] = identity<T, OP>();
  return v;
}

template <typename T, int OP>
__device__ __forceinline__ Vec<typename Lanes<T>::W, 2> wide_identity() {
  Vec<typename Lanes<T>::W, 2> v;
  v.w[0] = v.w[1] = identity<T, OP>();
  return v;
}

// The unit's staged elements k columns right of its first, read from
// shared memory (the runs beside the centre of tap sets with gaps).
template <int NW>
__device__ __forceinline__ Vec<uint32_t, NW> element(const uint32_t* srow, int u, int k) {
  Vec<uint32_t, NW> v;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int o = BP_XPAD + 2 * (NW * u + j) + k;
    v.w[j] = prmt(srow[o >> 2], srow[(o >> 2) + 1], sext_pair(o & 3));
  }
  return v;
}

template <int NW>
__device__ __forceinline__ Vec<int32_t, NW> element(const int32_t* srow, int u, int k) {
  Vec<int32_t, NW> v;
#pragma unroll
  for (int j = 0; j < NW; ++j) v.w[j] = srow[BP_XPAD + NW * u + j + k];
  return v;
}

// The unit's window of staged elements k in [-HMAX, HMAX], loaded once
// into registers (int8: the aligned words its bytes span; int32: its
// values); at(k) is static in k.
template <typename T, int HMAX>
struct Window;

template <int HMAX>
struct Window<int8_t, HMAX> {
  static constexpr int NW = Lanes<int8_t>::NW;
  static constexpr int M0 = (-HMAX) >> 2, M1 = (2 * NW - 1 + HMAX) >> 2;
  uint32_t w[M1 - M0 + 2];
  __device__ __forceinline__ void load(const uint32_t* srow, int u) {
    const uint32_t* p = srow + (BP_XPAD + 2 * NW * u) / 4;
#pragma unroll
    for (int m = M0; m <= M1 + 1; ++m) w[m - M0] = p[m];
  }
  __device__ __forceinline__ Vec<uint32_t, NW> at(int k) const {
    Vec<uint32_t, NW> v;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int o = 2 * j + k, m = o >> 2;
      v.w[j] = prmt(w[m - M0], w[m - M0 + 1], sext_pair(o & 3));
    }
    return v;
  }
};

template <int HMAX>
struct Window<int32_t, HMAX> {
  static constexpr int NW = Lanes<int32_t>::NW;  // 4: a unit starts 16-byte aligned
  static constexpr int Q0 = (-HMAX) >> 2, Q1 = (NW - 1 + HMAX) >> 2;
  int32_t x[4 * (Q1 - Q0 + 1)];
  __device__ __forceinline__ void load(const int32_t* srow, int u) {
    const int4* p = reinterpret_cast<const int4*>(srow + BP_XPAD + NW * u);
#pragma unroll
    for (int q = Q0; q <= Q1; ++q) {
      const int4 v = p[q];
      x[4 * (q - Q0)] = v.x;
      x[4 * (q - Q0) + 1] = v.y;
      x[4 * (q - Q0) + 2] = v.z;
      x[4 * (q - Q0) + 3] = v.w;
    }
  }
  __device__ __forceinline__ Vec<int32_t, NW> at(int k) const {
    Vec<int32_t, NW> v;
#pragma unroll
    for (int j = 0; j < NW; ++j) v.w[j] = x[j + k - 4 * Q0];
    return v;
  }
};

template <int NW>
__device__ __forceinline__ void store_unit(int32_t* row, int gx, int nx,
                                           const Vec<int32_t, NW>& v) {
#pragma unroll
  for (int j = 0; j < NW; ++j)
    if (gx + j < nx) row[gx + j] = v.w[j];
}

// int8: two s16 pair words back to four bytes, stored as one word where
// aligned and whole, else byte by byte
template <int NW>
__device__ __forceinline__ void store_unit(int8_t* row, int gx, int nx,
                                           const Vec<uint32_t, NW>& v) {
#pragma unroll
  for (int j = 0; j < NW / 2; ++j) {
    const uint32_t bytes = prmt(v.w[2 * j], v.w[2 * j + 1], 0x6420);
    int8_t* p = row + gx + 4 * j;
    const int x = gx + 4 * j;
    if (x + 3 < nx && ((uintptr_t)p & 3) == 0) {
      *reinterpret_cast<uint32_t*>(p) = bytes;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (x + i < nx) p[i] = (int8_t)(bytes >> (8 * i));
    }
  }
}

// Lane j of an int8 unit's pooled s16 pairs, sign-extended
template <int NW>
__device__ __forceinline__ int lane_s16(const Vec<uint32_t, NW>& v, int j) {
  return (int)(short)(v.w[j >> 1] >> (16 * (j & 1)));
}

// One step is one group of pairs on one staged plane: the x pools of the
// next step are built into one pool buffer while the rows of this step read
// the other, one barrier a step.  Plane p + 2 is staged (from registers
// loaded a plane earlier) in the step that ends plane p.
template <typename T, int OP, typename Tab, typename IO>
__device__ __forceinline__ void pool_stream(const IO& io, int nz, int ny, int nx, int zchunk,
                                            const Tab& tab) {
  using L = Lanes<T>;
  using W = typename L::W;
  using V = Vec<W, L::NW>;
  constexpr int HMAX = Tab::HMAX, NACC = 2 * HMAX + 1;
  constexpr int TXU = L::TXU, TY = L::TY, TX = TXU * L::VX, NT = TXU * TY, NWARPS = NT / 32;
  constexpr int SW = L::SW, EPR = SW * 4 / (int)sizeof(T);  // staged elements a row
  constexpr int RPW = (TY + 2 * HMAX + NWARPS - 1) / NWARPS;
  constexpr int CPL = (TX + 2 * HMAX + 31) / 32;

  extern __shared__ __align__(16) uint32_t smem[];
  const int h = tab.halo, SY = TY + 2 * h, SXL = TX + 2 * h;
  const int n_groups = (tab.n_runs + BP_GROUP - 1) / BP_GROUP;
  const int G = tab.n_runs < BP_GROUP ? tab.n_runs : BP_GROUP;
  const int pool_units = G * SY * TXU;
  V* pools = reinterpret_cast<V*>(smem);                                 // [2][G][SY][TXU]
  uint32_t* stage = smem + 2 * pool_units * L::NW;                       // [2][SY][SW]
  int* roff = reinterpret_cast<int*>(stage + 2 * SY * SW);               // [n_rows]

  const int tid = threadIdx.x + TXU * threadIdx.y, lane = tid & 31, warp = tid >> 5;
  for (int t = tid; t < tab.n_rows; t += NT) {
    const int rw = tab.row[t];
    roff[t] = ((rw & 0xFF) * SY + (rw >> 8) - VOFOD_MAX_HALO) * TXU;
  }

  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int zc0 = blockIdx.z * zchunk, zc1 = min(nz, zc0 + zchunk);
  const int n_planes = zc1 - zc0 + 2 * h, n_steps = n_planes * n_groups;

  // the staged cells this thread loads: rows warp + NWARPS i, columns
  // lane + 32 j of the (SY, SXL) plane around the tile
  int rowoff[RPW], colo[CPL];
  bool row_in[RPW], row_ok[RPW], col_in[CPL], col_ok[CPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + NWARPS * i;
    row_in[i] = r < SY;
    rowoff[i] = io.row(y0 - h + r, row_ok[i]);
    row_ok[i] = row_ok[i] && row_in[i];
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    col_in[j] = c < SXL;
    colo[j] = io.col(x0 - h + c, col_ok[j]);
    col_ok[j] = col_ok[j] && col_in[j];
  }
  typename IO::Raw pf[RPW][CPL];
  auto fetch = [&](int p) {  // plane p of the chunk (input plane zc0 - h + p)
    bool z_ok;
    const long long base = io.plane(zc0 - h + p, z_ok);
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        pf[i][j] = z_ok && row_ok[i] && col_ok[j] ? io.load(base + rowoff[i] + colo[j]) : io.none;
  };
  auto put = [&](int p) {
    T* st = reinterpret_cast<T*>(stage + (p & 1) * SY * SW);
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (row_in[i] && col_in[j])
          st[(warp + NWARPS * i) * EPR + BP_XPAD - h + lane + 32 * j] = io.stage(pf[i][j]);
  };
  // the x pools of step s: its group's pairs on every staged row.  A task
  // (staged row, unit) loads its window once; the symmetric pairs (-w, w)
  // are the chain S[w] = op(S[w - 1], e[-w], e[w]), stored where the group
  // has them, any other pair element by element.
  auto xpool = [&](int s) {
    const int p = s / n_groups, g = s - p * n_groups, r0 = g * BP_GROUP;
    const int n_in = tab.n_runs - r0 < BP_GROUP ? tab.n_runs - r0 : BP_GROUP;
    const uint32_t* sbuf = stage + (p & 1) * SY * SW;
    V* pbuf = pools + (s & 1) * pool_units;
    for (int task = tid; task < SY * TXU; task += NT) {
      const int r = task / TXU, u = task % TXU;
      const auto* srow = reinterpret_cast<const W*>(sbuf + r * SW);
      V* prow = pbuf + r * TXU + u;
      Window<T, HMAX> win;
      win.load(srow, u);
      V chain = win.at(0);
      if (tab.sym[g][0] >= 0) prow[tab.sym[g][0] * SY * TXU] = chain;
#pragma unroll
      for (int w = 1; w <= HMAX; ++w) {
        if (w <= h) {
          chain = combine<OP>(combine<OP>(chain, win.at(-w)), win.at(w));
          if (tab.sym[g][w] >= 0) prow[tab.sym[g][w] * SY * TXU] = chain;
        }
      }
      for (int i = 0; i < n_in; ++i) {
        const int lo = tab.lo[r0 + i], hi = tab.hi[r0 + i];
        if (lo == -hi) continue;
        V v = element<L::NW>(srow, u, lo);
        for (int k = lo + 1; k <= hi; ++k) v = combine<OP>(v, element<L::NW>(srow, u, k));
        prow[i * SY * TXU] = v;
      }
    }
  };

  const int u = threadIdx.x, y = threadIdx.y, gy = y0 + y, gx = x0 + u * L::VX;
  if constexpr (IO::SKIP) {
    // a chunk that stages nothing but 0 pools nothing: its outputs are the
    // epilogue's on the identity (no voxel within reach of a set one), and
    // every block of the chunk's tile agrees (one barrier)
    bool any = false;
    for (int task = tid; task < n_planes * SY; task += NT)
      any |= io.row_any(zc0 - h + task / SY, y0 - h + task % SY, x0 - h, x0 + TX + h);
    if (!__syncthreads_or(any)) {
      if (gy < ny)
        for (int zo = zc0; zo < zc1; ++zo) io.store(zo, gy, gx, identity_vec<T, OP>());
      return;
    }
  }
  V acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = identity_vec<T, OP>();
  fetch(0);
  put(0);
  if (n_planes > 1) {
    fetch(1);
    put(1);
  }
  if (n_planes > 2) fetch(2);
  __syncthreads();
  xpool(0);
  __syncthreads();
  for (int s = 0; s < n_steps; ++s) {
    const int p = s / n_groups, g = s - p * n_groups, zi = zc0 - h + p;
    if (s + 1 < n_steps) xpool(s + 1);
    const V* pbase = pools + (s & 1) * pool_units + (y + h) * TXU + u;
    // the accumulators of output planes in the chunk: k = zo - (zi - h)
    const int k0 = zc0 - (zi - h) > 0 ? zc0 - (zi - h) : 0;
    const int k1 = zc1 - 1 - (zi - h) < 2 * h ? zc1 - 1 - (zi - h) : 2 * h;
    const unsigned live = k1 < k0 ? 0u : ((2u << k1) - 1u) & ~((1u << k0) - 1u);
    for (int q = tab.gslice[g]; q < tab.gslice[g + 1]; ++q) {
      const unsigned kmask = tab.kmask[q] & live;
      if (kmask == 0) continue;
      V d = identity_vec<T, OP>();
      const int t1 = tab.send[q];
#pragma unroll 4
      for (int t = tab.sbegin[q]; t < t1; ++t) d = combine<OP>(d, pbase[roff[t]]);
#pragma unroll
      for (int k = 0; k < NACC; ++k)
        if (kmask >> k & 1u) acc[k] = combine<OP>(acc[k], d);
    }
    if (g == n_groups - 1) {  // plane p is pooled: output plane zi - h is done
      if (zi - h >= zc0 && gy < ny) io.store(zi - h, gy, gx, acc[0]);
#pragma unroll
      for (int k = 0; k + 1 < NACC; ++k) acc[k] = acc[k + 1];
      acc[NACC - 1] = identity_vec<T, OP>();
      if (p + 2 < n_planes) put(p + 2);  // plane p's buffer: its last x pool ran a step ago
      if (p + 3 < n_planes) fetch(p + 3);
    }
    __syncthreads();
  }
}

// A kernel whose blocks skip an empty chunk (SKIP) takes chunks of 3
// planes up to halo 3: where few chunks pool, as on the step's demotions,
// the short ones finish first and the rest skip (flagship radius on an
// H100: 0.018 against 0.027 ms at K1's chunk, demote_probe.py); where
// every chunk pools, at halo 1 it costs a fifth more (0.042 against
// 0.035), at halo 7 twice (so the large table keeps K1's chunk)
constexpr int SKIP_ZCHUNK = 3, SKIP_HALO = 3;

// The z chunk: as many chunks as the card's
// resident blocks of this kernel take, up to 2.4 blocks an SM (measured
// best on an H100 at the flagship grid and the grid paths' 23-plane slabs:
// fewer leave SMs idle, more pay for more halo planes), every chunk of
// equal length but the last.
template <typename K>
int auto_zchunk(K* kernel, int threads, size_t smem, int tiles, int nz, int* blocks_per_sm) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, smem) !=
          cudaSuccess)
    return -1;
  const int cap = *blocks_per_sm * sms, target = cap < 12 * sms / 5 ? cap : 12 * sms / 5;
  int chunks = target / tiles;
  chunks = chunks < 1 ? 1 : chunks > nz ? nz : chunks;
  return (nz + chunks - 1) / chunks;
}

// Launch a pool_stream kernel (its parameters: the policy, nz, ny, nx, the
// z chunk and the table) over the (nz, ny, nx) output; used: if not null,
// receives the z chunk, the blocks launched and the resident blocks an SM.
template <typename T, typename IO, typename Tab>
int launch_pool(void (*kernel)(IO, int, int, int, int, Tab), const IO& io, int nz, int ny,
                int nx, const Tab& tab, int* used, cudaStream_t stream) {
  using L = Lanes<T>;
  const int SY = L::TY + 2 * tab.halo;
  const int G = tab.n_runs < BP_GROUP ? tab.n_runs : BP_GROUP;
  const size_t smem =
      (size_t)(2 * G * SY * L::TXU * L::NW + 2 * SY * L::SW + tab.n_rows) * 4;
  if (const int err = allow_smem(kernel, smem)) return err;
  const int tx = L::TXU * L::VX, gx = (nx + tx - 1) / tx, gy = (ny + L::TY - 1) / L::TY;
  int per_sm = 0;
  int zchunk = auto_zchunk(kernel, L::TXU * L::TY, smem, gx * gy, nz, &per_sm);
  if (zchunk < 1) return (int)cudaGetLastError();
  if (IO::SKIP && tab.halo <= SKIP_HALO) zchunk = zchunk < SKIP_ZCHUNK ? zchunk : SKIP_ZCHUNK;
  const dim3 grid(gx, gy, (nz + zchunk - 1) / zchunk);
  if (used != nullptr) {
    used[0] = zchunk;
    used[1] = (int)(grid.x * grid.y * grid.z);
    used[2] = per_sm;
  }
  kernel<<<grid, dim3(L::TXU, L::TY), smem, stream>>>(io, nz, ny, nx, zchunk, tab);
  return (int)cudaGetLastError();
}

// ---- The wide form: tap sets past halo 7 (K1, K14, K11's demotion, K13c) ----
//
// A tap set past halo 7 (or 2,112 taps) takes one run table of any halo
// (ops/morphology.WideRunTable) in one pass over the grid: pool_stream_wide,
// the body above with the limits of the packed table lifted.
//
// - The table travels in global memory (int32, its header parsed and
//   checked on the host by parse_wide) and each block copies it into
//   shared memory, the rows turned into offsets into the pool buffers.
// - Staged columns are padded to the halo (rounded to 4), not to 8, so
//   the chain S[w] = op(S[w - 1], e[-w], e[w]) runs to the set's own
//   halo: every x-run of a ball is a chain value, none pooled element by
//   element.  Widths up to HW come from a register window, wider ones from
//   shared memory.  A group's chain starts where the group before it left
//   (`carry`, one unit a staged row and unit), so the groups of a ball's
//   pairs together run the chain once.
// - A slice is indexed by (group, dz) (`zs`), its rows' dy of any range.
//   The 2 WIDE_ZHALO + 1 plane accumulators sit in registers at static
//   indices: the slices of dz = j and -j are taken in one unrolled step j,
//   a slice equal at both (a ball's) combined once and fed to both
//   accumulators.  A thread owns a unit of 2 words (int8: 4 voxels as s16
//   pairs; int32: 2), so the 33 accumulators take 66 registers.
// - A set reaching past WIDE_ZHALO in z is cut in z only (the host's
//   pieces, each recentred on its dz): one launch a piece, staging shifted
//   by the piece's dz, the pools folded in a scratch of units (PieceIO),
//   the last piece storing.  No set this repo runs takes more than one.
// min, max and int32 sums are exact in any order, so the result is
// bit-equal to the narrow body's and to the plain versions.  The sum of
// int8 values (K13c) stays in its s16 lanes: the host refuses a set whose
// sum could reach 2^15.

constexpr int WIDE_ZHALO = 16;  // a piece's z reach: 2 WIDE_ZHALO + 1 accumulators
// the wide kernels' blocks an SM: the host sizes the groups so that two
// blocks' shared memory fits (kernels.WIDE_POOL_SMEM), and the kernels
// are declared so, which holds a thread to 128 registers (K1 and K14 ran
// 0-9 % faster so than at one block of ~200 registers; the demotions'
// epilogues spill more and ran 5-25 % slower, on no path here)
constexpr int WIDE_BLOCKS_PER_SM = 2;

// A thread's unit of the wide form: NW words of VX voxels; a block is TXU
// x TY units; HW: the half width of the register window
template <typename T>
struct LanesW;
template <>
struct LanesW<int8_t> {
  using W = uint32_t;
  static constexpr int NW = 2, VX = 4, TXU = 16, TY = 16, HW = 16;
};
template <>
struct LanesW<int32_t> {
  using W = int32_t;
  static constexpr int NW = 2, VX = 2, TXU = 16, TY = 16, HW = 8;
};

// The packed wide table (int32): zh, h, n_pairs, group, n_groups,
// n_slices, n_rows, len; lo, hi a pair; symidx[h + 1]; c0, c1, carry-out a
// group; zs[n_groups][2 zh + 1]; sbegin, send a slice; rows (dy << 16 | the
// pair's index in its group)
struct WideTab {
  int zh, h, n_pairs, group, n_groups, n_slices, n_rows, len;
  int lo, hi, sym, c0, c1, cout, zs, sb, se, row;  // offsets into the blob
};

__host__ __device__ inline WideTab wide_tab(const int* b) {
  WideTab t;
  t.zh = b[0], t.h = b[1], t.n_pairs = b[2], t.group = b[3], t.n_groups = b[4];
  t.n_slices = b[5], t.n_rows = b[6], t.len = b[7];
  t.lo = 8, t.hi = t.lo + t.n_pairs, t.sym = t.hi + t.n_pairs, t.c0 = t.sym + t.h + 1;
  t.c1 = t.c0 + t.n_groups, t.cout = t.c1 + t.n_groups, t.zs = t.cout + t.n_groups;
  t.sb = t.zs + t.n_groups * (2 * t.zh + 1), t.se = t.sb + t.n_slices, t.row = t.se + t.n_slices;
  return t;
}

// The host's check of a packed wide table of `len` ints against every
// bound the kernels' indexing relies on; zh_max: the accumulators' reach
inline bool parse_wide(const int* b, int len, int zh_max, WideTab* out) {
  if (b == nullptr || len < 8) return false;
  const WideTab t = wide_tab(b);
  if (t.zh < 0 || t.zh > zh_max || t.h < t.zh || t.h > 120 || t.n_pairs < 1 || t.group < 1 ||
      t.n_groups != (t.n_pairs + t.group - 1) / t.group || t.n_slices < 1 || t.n_rows < 1 ||
      t.len != len || (long long)t.row + t.n_rows != len)
    return false;
  for (int i = 0; i < t.n_pairs; ++i)
    if (b[t.lo + i] < -t.h || b[t.hi + i] > t.h || b[t.lo + i] > b[t.hi + i]) return false;
  for (int w = 0; w <= t.h; ++w) {
    const int i = b[t.sym + w];
    if (i < -1 || i >= t.n_pairs || (i >= 0 && (b[t.lo + i] != -w || b[t.hi + i] != w)))
      return false;
  }
  int n_sym = 0;  // every symmetric pair is the chain's, and they come first
  for (int i = 0; i < t.n_pairs; ++i) {
    const bool sym = b[t.lo + i] == -b[t.hi + i];
    if ((sym && (i != n_sym++ || b[t.sym + b[t.hi + i]] != i))) return false;
  }
  int last = -1;
  bool carried = false;
  for (int g = 0; g < t.n_groups; ++g) {
    const int c0 = b[t.c0 + g], c1 = b[t.c1 + g];
    if (c1 >= 0) {  // widths c0..c1, from the carried chain where c0 > 0
      if (c0 != last + 1 || c1 < c0 || c1 > t.h || (c0 > 0 && !carried)) return false;
      for (int w = c0; w <= c1; ++w)
        if (b[t.sym + w] >= 0 && b[t.sym + w] / t.group != g) return false;
      last = c1, carried = b[t.cout + g] != 0;
    } else if (c0 != -1 || b[t.cout + g] != 0) {
      return false;
    }
    const int n_in = t.n_pairs - g * t.group < t.group ? t.n_pairs - g * t.group : t.group;
    for (int i = g * t.group; i < g * t.group + n_in; ++i)
      if (b[t.lo + i] == -b[t.hi + i] && (b[t.hi + i] < c0 || b[t.hi + i] > c1)) return false;
    for (int k = 0; k <= 2 * t.zh; ++k) {
      const int q = b[t.zs + g * (2 * t.zh + 1) + k];
      if (q < -1 || q >= t.n_slices) return false;
      if (q < 0) continue;
      if (b[t.sb + q] < 0 || b[t.sb + q] > b[t.se + q] || b[t.se + q] > t.n_rows) return false;
      for (int r = b[t.sb + q]; r < b[t.se + q]; ++r) {
        const int dy = b[t.row + r] >> 16, i = b[t.row + r] & 0xFFFF;
        if (dy < -t.h || dy > t.h || i >= n_in) return false;
      }
    }
  }
  *out = t;
  return true;
}

// The unit's window of staged elements k in [-HW, HW], loaded once into
// registers; the unit starts xpad + VX u elements into its staged row
template <typename T, int HW>
struct WindowW;

template <int HW>
struct WindowW<int8_t, HW> {
  static constexpr int NW = LanesW<int8_t>::NW;
  static constexpr int M0 = (-HW) >> 2, M1 = (2 * NW - 1 + HW) >> 2;
  uint32_t w[M1 - M0 + 2];
  __device__ __forceinline__ void load(const uint32_t* srow, int xpad, int u) {
    const uint32_t* p = srow + (xpad >> 2) + u;
#pragma unroll
    for (int m = M0; m <= M1 + 1; ++m) w[m - M0] = p[m];
  }
  __device__ __forceinline__ Vec<uint32_t, NW> at(int k) const {
    Vec<uint32_t, NW> v;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int o = 2 * j + k, m = o >> 2;
      v.w[j] = prmt(w[m - M0], w[m - M0 + 1], sext_pair(o & 3));
    }
    return v;
  }
};

template <int HW>
struct WindowW<int32_t, HW> {
  static constexpr int NW = LanesW<int32_t>::NW;  // 2: a unit starts 8-byte aligned
  static constexpr int Q0 = -((HW + 1) / 2), Q1 = (HW + 1) / 2;
  int32_t x[2 * (Q1 - Q0 + 1)];
  __device__ __forceinline__ void load(const int32_t* srow, int xpad, int u) {
    const int2* p = reinterpret_cast<const int2*>(srow + xpad + NW * u);
#pragma unroll
    for (int q = Q0; q <= Q1; ++q) {
      const int2 v = p[q];
      x[2 * (q - Q0)] = v.x;
      x[2 * (q - Q0) + 1] = v.y;
    }
  }
  __device__ __forceinline__ Vec<int32_t, NW> at(int k) const {
    Vec<int32_t, NW> v;
#pragma unroll
    for (int j = 0; j < NW; ++j) v.w[j] = x[j + k - 2 * Q0];
    return v;
  }
};

// The unit's staged elements k columns right of its first, from shared
// memory (wider than the window; the pairs off the chain)
template <int NW>
__device__ __forceinline__ Vec<uint32_t, NW> element_at(const uint32_t* srow, int xpad, int u,
                                                        int k) {
  Vec<uint32_t, NW> v;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int o = xpad + 2 * (NW * u + j) + k;
    v.w[j] = prmt(srow[o >> 2], srow[(o >> 2) + 1], sext_pair(o & 3));
  }
  return v;
}

template <int NW>
__device__ __forceinline__ Vec<int32_t, NW> element_at(const int32_t* srow, int xpad, int u,
                                                       int k) {
  Vec<int32_t, NW> v;
#pragma unroll
  for (int j = 0; j < NW; ++j) v.w[j] = srow[xpad + NW * u + j + k];
  return v;
}

// The x pools of group g of a wide table (tb in shared memory, hd its
// header) on one staged row, at one unit or column: the group's widths
// c0..c1 of the chain S[w] = op(S[w - 1], e(-w), e(w)), from e(0) or,
// where c0 > 0, from *carry (left there for a later group where the group
// says so), then its other pairs element by element; the group's pair i
// written to out[i * stride].  near(k): the element k columns right for
// |k| <= HW (a register window: k is static where it is called), far(k):
// any; n_sym: the table's symmetric pairs (parse_wide: they come first).
// K1's wide body and K2's wide tile pool both pool so.
template <int HW, typename V, typename Op, typename Near, typename Far>
__device__ __forceinline__ void wide_row_pools(const int* __restrict__ tb, const WideTab& hd,
                                               int g, int n_sym, Op op, Near near, Far far,
                                               V* __restrict__ carry, V* __restrict__ out,
                                               int stride) {
  const int r0 = g * hd.group, n_in = min(hd.n_pairs - r0, hd.group);
  const int c0 = tb[hd.c0 + g], c1 = tb[hd.c1 + g];
  const int* sym = tb + hd.sym;
  if (c1 >= 0) {
    V chain = c0 == 0 ? near(0) : *carry;
    if (c0 == 0 && sym[0] >= 0) out[(sym[0] - r0) * stride] = chain;
#pragma unroll
    for (int w = 1; w <= HW; ++w) {
      if (w >= c0 && w <= c1) {
        chain = op(op(chain, near(-w)), near(w));
        if (sym[w] >= 0) out[(sym[w] - r0) * stride] = chain;
      }
    }
    for (int w = c0 > HW ? c0 : HW + 1; w <= c1; ++w) {
      chain = op(op(chain, far(-w)), far(w));
      if (sym[w] >= 0) out[(sym[w] - r0) * stride] = chain;
    }
    if (tb[hd.cout + g]) *carry = chain;
  }
  for (int i = n_sym > r0 ? n_sym - r0 : 0; i < n_in; ++i) {
    const int lo = tb[hd.lo + r0 + i], hi = tb[hd.hi + r0 + i];
    V v = far(lo);
    for (int k = lo + 1; k <= hi; ++k) v = op(v, far(k));
    out[i * stride] = v;
  }
}

// The wide form's layout of one launch: staged row words, halo padding,
// staged rows and shared bytes
template <typename T>
struct WideShape {
  int xpad, sy, sw, group;
  size_t pools, carry, stage, smem;
  __host__ __device__ WideShape(const WideTab& t) {
    using L = LanesW<T>;
    constexpr int TX = L::TXU * L::VX;
    xpad = (t.h + 3) & ~3;
    sy = L::TY + 2 * t.h;
    group = t.group;
    if (sizeof(T) == 1) {
      const int w = (TX + 2 * xpad) / 4;  // 16 mod 32 words: a warp's two rows apart
      sw = w + ((16 - w % 32) % 32 + 32) % 32;
    } else {
      sw = TX + 2 * xpad;
    }
    pools = (size_t)2 * group * sy * L::TXU * 2 * 4;
    carry = (size_t)sy * L::TXU * 2 * 4;
    stage = (size_t)2 * sy * sw * 4;
    smem = pools + carry + stage + (size_t)t.len * 4;
  }
};

// The wide body: the table `tab` (device, `len` ints), staged through IO
// as pool_stream's, over output planes [zc0, zc1) of blockIdx.z's chunk.
// One step is one group of pairs on one staged plane, one barrier a step.
template <typename T, int OP, typename IO>
__device__ __forceinline__ void pool_stream_wide(const IO& io, int nz, int ny, int nx,
                                                 int zchunk, const int* __restrict__ tab,
                                                 int len) {
  using L = LanesW<T>;
  using W = typename L::W;
  using V = Vec<W, L::NW>;
  constexpr int C = WIDE_ZHALO, NACC = 2 * C + 1, HW = L::HW;
  constexpr int TXU = L::TXU, TY = L::TY, TX = TXU * L::VX, NT = TXU * TY, NWARPS = NT / 32;
  // the staging each thread holds in registers up to halo WIDE_ZHALO;
  // past it the rest of a plane is staged directly
  constexpr int RPW = (TY + 2 * C + NWARPS - 1) / NWARPS, CPL = (TX + 2 * C + 31) / 32;

  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x + TXU * threadIdx.y, lane = tid & 31, warp = tid >> 5;
  const WideTab hd = wide_tab(tab);  // (uniform loads of the header)
  const WideShape<T> sh(hd);
  const int h = hd.h, zh = hd.zh, G = hd.group, SY = sh.sy, SW = sh.sw, xpad = sh.xpad;
  const int SXL = TX + 2 * h, EPR = SW * 4 / (int)sizeof(T);
  V* pools = reinterpret_cast<V*>(smem);                       // [2][G][SY][TXU]
  V* carry = reinterpret_cast<V*>(smem + sh.pools / 4);        // [SY][TXU]
  uint32_t* stage = smem + (sh.pools + sh.carry) / 4;          // [2][SY][SW]
  int* tb = reinterpret_cast<int*>(stage + 2 * SY * SW);        // the table
  const int pool_units = G * SY * TXU;
  for (int i = tid; i < len; i += NT) {
    int v = tab[i];
    if (i >= hd.row) v = ((v & 0xFFFF) * SY + (v >> 16)) * TXU;  // a row's pool offset
    tb[i] = v;
  }

  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int zc0 = blockIdx.z * zchunk, zc1 = min(nz, zc0 + zchunk);
  const int n_planes = zc1 - zc0 + 2 * zh, n_steps = n_planes * hd.n_groups;

  int rowoff[RPW], colo[CPL];
  bool row_in[RPW], row_ok[RPW], col_in[CPL], col_ok[CPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + NWARPS * i;
    row_in[i] = r < SY;
    rowoff[i] = io.row(y0 - h + r, row_ok[i]);
    row_ok[i] = row_ok[i] && row_in[i];
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    col_in[j] = c < SXL;
    colo[j] = io.col(x0 - h + c, col_ok[j]);
    col_ok[j] = col_ok[j] && col_in[j];
  }
  typename IO::Raw pf[RPW][CPL];
  auto fetch = [&](int p) {  // plane p of the chunk (input plane zc0 - zh + p)
    bool z_ok;
    const long long base = io.plane(zc0 - zh + p, z_ok);
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        pf[i][j] = z_ok && row_ok[i] && col_ok[j] ? io.load(base + rowoff[i] + colo[j]) : io.none;
  };
  auto put = [&](int p) {
    T* st = reinterpret_cast<T*>(stage + (p & 1) * SY * SW) + xpad - h;
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (row_in[i] && col_in[j]) st[(warp + NWARPS * i) * EPR + lane + 32 * j] = io.stage(pf[i][j]);
    if (h > C) {  // the cells past the registers' (halo past WIDE_ZHALO)
      bool z_ok;
      const long long base = io.plane(zc0 - zh + p, z_ok);
      for (int r = warp; r < SY; r += NWARPS)
        for (int c = lane; c < SXL; c += 32) {
          if (r < NWARPS * RPW && c < 32 * CPL) continue;
          bool y_ok, x_ok;
          const int ro = io.row(y0 - h + r, y_ok), co = io.col(x0 - h + c, x_ok);
          st[r * EPR + c] = io.stage(z_ok && y_ok && x_ok ? io.load(base + ro + co) : io.none);
        }
    }
  };
  // the x pools of step s: its group's pairs on every staged row
  int n_sym = 0;  // (counted once the table is in shared memory)
  auto xpool = [&](int s) {
    const int p = s / hd.n_groups, g = s - p * hd.n_groups;
    const uint32_t* sbuf = stage + (p & 1) * SY * SW;
    V* pbuf = pools + (s & 1) * pool_units;
    for (int task = tid; task < SY * TXU; task += NT) {
      const int u = task % TXU;
      const auto* srow = reinterpret_cast<const W*>(sbuf + (task / TXU) * SW);
      WindowW<T, HW> win;
      win.load(srow, xpad, u);
      wide_row_pools<HW>(
          tb, hd, g, n_sym, [](const V& a, const V& b) { return combine<OP>(a, b); },
          [&](int k) { return win.at(k); },
          [&](int k) { return element_at<L::NW>(srow, xpad, u, k); }, carry + task,
          pbuf + task, SY * TXU);
    }
  };

  const int u = threadIdx.x, y = threadIdx.y, gy = y0 + y, gx = x0 + u * L::VX;
  __syncthreads();  // the table
  for (int w = 0; w <= h; ++w) n_sym += tb[hd.sym + w] >= 0;
  if constexpr (IO::SKIP) {
    // a chunk that stages nothing but 0 pools nothing (pool_stream's rule)
    bool any = false;
    for (int task = tid; task < n_planes * SY; task += NT)
      for (int lo = x0 - h; lo < x0 + TX + h; lo += 128)
        any |= io.row_any(zc0 - zh + task / SY, y0 - h + task % SY, lo,
                          lo + 128 < x0 + TX + h ? lo + 128 : x0 + TX + h);
    if (!__syncthreads_or(any)) {
      if (gy < ny)
        for (int zo = zc0; zo < zc1; ++zo) io.store(zo, gy, gx, wide_identity<T, OP>());
      return;
    }
  }
  V acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = wide_identity<T, OP>();
  fetch(0);
  put(0);
  if (n_planes > 1) {
    fetch(1);
    put(1);
  }
  if (n_planes > 2) fetch(2);
  __syncthreads();
  xpool(0);
  __syncthreads();
  for (int s = 0; s < n_steps; ++s) {
    const int p = s / hd.n_groups, g = s - p * hd.n_groups, zi = zc0 - zh + p;
    if (s + 1 < n_steps) xpool(s + 1);
    const V* pbase = pools + (s & 1) * pool_units + (y + h) * TXU + u;
    const int* zs = tb + hd.zs + g * (2 * zh + 1) + zh;  // zs[dz]
    auto slice = [&](int q) {
      V d = wide_identity<T, OP>();
      const int t1 = tb[hd.se + q];
#pragma unroll 4
      for (int t = tb[hd.sb + q]; t < t1; ++t) d = combine<OP>(d, pbase[tb[hd.row + t]]);
      return d;
    };
    // accumulator C + m: output plane zi + m; dz = j feeds C - j, -j C + j;
    // a slice equal to the one pooled last (a ball's near dz) is reused
    int last_q = -1;
    V last_d;
    auto pooled = [&](int q) {
      if (q != last_q) last_d = slice(q), last_q = q;
      return last_d;
    };
#pragma unroll
    for (int j = 0; j <= C; ++j) {
      if (j <= zh) {
        const int qa = zs[j], qb = zs[-j];
        const bool la = zi - j >= zc0 && zi - j < zc1, lb = zi + j >= zc0 && zi + j < zc1;
        if (qa >= 0 && (la || (qb == qa && lb))) {
          const V d = pooled(qa);
          if (la) acc[C - j] = combine<OP>(acc[C - j], d);
          if (j > 0 && qb == qa && lb) acc[C + j] = combine<OP>(acc[C + j], d);
        }
        if (j > 0 && qb >= 0 && qb != qa && lb) acc[C + j] = combine<OP>(acc[C + j], pooled(qb));
      }
    }
    if (g == hd.n_groups - 1) {  // plane p is pooled: output plane zi - zh is done
      V done = acc[C];
#pragma unroll
      for (int m = 0; m < C; ++m)
        if (m == C - zh) done = acc[m];
      if (zi - zh >= zc0 && gy < ny) io.store(zi - zh, gy, gx, done);
#pragma unroll
      for (int k = 0; k + 1 < NACC; ++k) acc[k] = acc[k + 1];
      acc[NACC - 1] = wide_identity<T, OP>();
      if (p + 2 < n_planes) put(p + 2);  // plane p's buffer: its last x pool ran a step ago
      if (p + 3 < n_planes) fetch(p + 3);
    }
    __syncthreads();
  }
}

// Launch a pool_stream_wide kernel (its parameters: the policy, nz, ny,
// nx, the z chunk, the device table and its length) over the (nz, ny, nx)
// output; host: the same table on the host, checked here.  used: as
// launch_pool's.
template <typename T, typename IO>
int launch_pool_wide(void (*kernel)(IO, int, int, int, int, const int*, int), const IO& io,
                     int nz, int ny, int nx, const int* host, const int* dev, int len, int* used,
                     cudaStream_t stream) {
  using L = LanesW<T>;
  WideTab t;
  if (dev == nullptr || !parse_wide(host, len, WIDE_ZHALO, &t)) return (int)cudaErrorInvalidValue;
  const size_t smem = WideShape<T>(t).smem;
  if (const int err = allow_smem(kernel, smem)) return err;
  const int tx = L::TXU * L::VX, gx = (nx + tx - 1) / tx, gy = (ny + L::TY - 1) / L::TY;
  int per_sm = 0;
  const int zchunk = auto_zchunk(kernel, L::TXU * L::TY, smem, gx * gy, nz, &per_sm);
  if (zchunk < 1) return (int)cudaGetLastError();
  const dim3 grid(gx, gy, (nz + zchunk - 1) / zchunk);
  if (used != nullptr) {
    used[0] = zchunk;
    used[1] = (int)(grid.x * grid.y * grid.z);
    used[2] = per_sm;
  }
  kernel<<<grid, dim3(L::TXU, L::TY), smem, stream>>>(io, nz, ny, nx, zchunk, dev, len);
  return (int)cudaGetLastError();
}

// A z piece of a set cut in z: the inner policy's staging shifted by the
// piece's dz, its pooled units folded into `acc` (one unit Vec a unit,
// the pool's own representation: int8 as s16 pairs) with the pool's op,
// the last piece handing the folded unit to the inner policy's store.
template <typename T, int OP, typename Inner>
struct PieceIO {
  using L = LanesW<T>;
  using V = Vec<typename L::W, L::NW>;
  using Raw = typename Inner::Raw;
  static constexpr bool SKIP = Inner::SKIP;
  Inner in;
  Raw none;
  int dz;  // staged plane zi reads the inner plane zi + dz
  V* acc;  // the fold, (nz, ny, units)
  int ny, nx, units;
  bool first, last;
  __device__ __forceinline__ long long plane(int zi, bool& ok) const {
    return in.plane(zi + dz, ok);
  }
  __device__ __forceinline__ int row(int gy, bool& ok) const { return in.row(gy, ok); }
  __device__ __forceinline__ int col(int gx, bool& ok) const { return in.col(gx, ok); }
  __device__ __forceinline__ Raw load(long long i) const { return in.load(i); }
  __device__ __forceinline__ auto stage(Raw r) const { return in.stage(r); }
  __device__ __forceinline__ bool row_any(int zi, int gy, int lo, int hi) const {
    return in.row_any(zi + dz, gy, lo, hi);
  }
  __device__ __forceinline__ void store(int zo, int gy, int gx, const V& v) const {
    if (gx >= nx) return;
    V* a = acc + ((size_t)zo * ny + gy) * units + gx / L::VX;
    const V f = first ? v : combine<OP>(*a, v);
    if (last)
      in.store(zo, gy, gx, f);
    else
      *a = f;
  }
};

// The wide form's launches: host / dev the n packed tables back to back
// (host int32, and their device copy), lens their lengths, dz each piece's
// shift; acc: device memory of (nz, ny, ceil(nx / VX)) unit Vecs (NULL for
// one piece).  used: the first piece's schedule.
template <typename T, int OP, typename Inner>
int launch_wide_pieces(void (*one)(Inner, int, int, int, int, const int*, int),
                       void (*piece)(PieceIO<T, OP, Inner>, int, int, int, int, const int*, int),
                       const Inner& inner, int nz, int ny, int nx, const int* host,
                       const int* dev, const int* lens, const int* dz, int n, void* acc,
                       int* used, cudaStream_t stream) {
  if (host == nullptr || dev == nullptr || lens == nullptr || dz == nullptr || n < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 1) {
    if (dz[0] != 0) return (int)cudaErrorInvalidValue;
    return launch_pool_wide<T>(one, inner, nz, ny, nx, host, dev, lens[0], used, stream);
  }
  if (acc == nullptr) return (int)cudaErrorInvalidValue;
  PieceIO<T, OP, Inner> io;
  io.in = inner;
  io.none = inner.none;
  io.acc = static_cast<typename PieceIO<T, OP, Inner>::V*>(acc);
  io.ny = ny, io.nx = nx, io.units = (nx + LanesW<T>::VX - 1) / LanesW<T>::VX;
  for (int i = 0, at = 0; i < n; at += lens[i++]) {
    io.dz = dz[i];
    io.first = i == 0, io.last = i + 1 == n;
    const int err = launch_pool_wide<T>(piece, io, nz, ny, nx, host + at, dev + at, lens[i],
                                        i == 0 ? used : nullptr, stream);
    if (err != 0) return err;
  }
  return 0;
}

template <typename Tab>
bool fits(const short* table) {
  return table[0] <= Tab::HMAX && table[1] <= Tab::MAX_RUNS && table[2] <= Tab::MAX_ROWS &&
         table[3] <= Tab::MAX_SLICES;
}

// The packed table (host int16) parsed into the smallest struct it fits,
// handed to launch(const auto& table); an invalid table returns
// cudaErrorInvalidValue.
template <typename F>
int with_table(const short* table, int table_len, F&& launch) {
  if (table == nullptr || table_len < 4) return (int)cudaErrorInvalidValue;
  if (fits<RunTableTiny>(table)) {
    RunTableTiny t;
    if (!parse_table(table, table_len, &t)) return (int)cudaErrorInvalidValue;
    return launch(t);
  }
  if (fits<RunTableSmall>(table)) {
    RunTableSmall t;
    if (!parse_table(table, table_len, &t)) return (int)cudaErrorInvalidValue;
    return launch(t);
  }
  RunTableLarge t;
  if (!parse_table(table, table_len, &t)) return (int)cudaErrorInvalidValue;
  return launch(t);
}

}  // namespace

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
// A tap set past halo 7 reaches past what one table holds (kmask's 15
// accumulators, a row's dy + 7 in 4 bits, BP_XPAD staged columns), so the
// host (ops/morphology.WideTable) cuts it into pieces: the taps of a box of
// at most 15 offsets on every axis, recentred on the box's centre (dz, dy,
// dx) into a table within halo 7.  Each piece runs the unchanged body with
// its staging shifted by its centre, one launch a piece in order on the
// caller's stream, and folds its pooled units into `acc` (one unit Vec a
// unit, the pool's own representation: int8 as s16 pairs) with the pool's
// own op; the last piece hands the folded unit to the inner policy's
// store.  min, max and int32 sums are exact in any order, so the result is
// bit-equal to one pool over the whole set.  The sum of int8 values (K13c)
// stays in its s16 lanes: the host refuses a set whose sum could reach 2^15.
template <typename T, int OP, typename Inner>
struct PieceIO {
  using L = Lanes<T>;
  using V = Vec<typename L::W, L::NW>;
  using Raw = typename Inner::Raw;
  static constexpr bool SKIP = Inner::SKIP;
  Inner in;
  Raw none;
  int dz, dy, dx;  // the piece's centre: staged plane zi reads the inner plane zi + dz
  V* acc;          // the fold, (nz, ny, units)
  int ny, nx, units;
  bool first, last;
  __device__ __forceinline__ long long plane(int zi, bool& ok) const {
    return in.plane(zi + dz, ok);
  }
  __device__ __forceinline__ int row(int gy, bool& ok) const { return in.row(gy + dy, ok); }
  __device__ __forceinline__ int col(int gx, bool& ok) const { return in.col(gx + dx, ok); }
  __device__ __forceinline__ Raw load(long long i) const { return in.load(i); }
  __device__ __forceinline__ auto stage(Raw r) const { return in.stage(r); }
  __device__ __forceinline__ bool row_any(int zi, int gy, int lo, int hi) const {
    return in.row_any(zi + dz, gy + dy, lo + dx, hi + dx);
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

// The pieces' launches: tables (host int16) the n packed tables back to
// back, lens their lengths, shifts (dz, dy, dx) a piece; acc: device
// memory of (nz, ny, ceil(nx / VX)) unit Vecs.  used: the first piece's
// schedule (as launch_pool's).
template <typename T, int OP, typename Inner>
int launch_pieces(void (*kernel)(PieceIO<T, OP, Inner>, int, int, int, int, RunTableLarge),
                  const Inner& inner, int nz, int ny, int nx, const short* tables,
                  const int* lens, const int* shifts, int n, void* acc, int* used,
                  cudaStream_t stream) {
  if (tables == nullptr || lens == nullptr || shifts == nullptr || acc == nullptr || n < 1)
    return (int)cudaErrorInvalidValue;
  PieceIO<T, OP, Inner> io;
  io.in = inner;
  io.none = inner.none;
  io.acc = static_cast<typename PieceIO<T, OP, Inner>::V*>(acc);
  io.ny = ny, io.nx = nx, io.units = (nx + Lanes<T>::VX - 1) / Lanes<T>::VX;
  RunTableLarge tab;
  for (int i = 0, at = 0; i < n; at += lens[i++]) {
    if (!parse_table(tables + at, lens[i], &tab)) return (int)cudaErrorInvalidValue;
    io.dz = shifts[3 * i], io.dy = shifts[3 * i + 1], io.dx = shifts[3 * i + 2];
    io.first = i == 0, io.last = i + 1 == n;
    const int err = launch_pool<T>(kernel, io, nz, ny, nx, tab, i == 0 ? used : nullptr, stream);
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

// The single-pass scan with decoupled look-back (Merrill & Garland 2016),
// shared by K13b's and K15b-6b's scans (csrc/census.cu) and K6
// (csrc/compact.cu).
//
// A scan's state is a ticket counter, then one status word per tile.  A
// block takes its tile by ticket (take_tile), so tiles are handed out in
// the order the blocks start and every tile's predecessors have started:
// forward progress whatever the number of resident blocks.  It scans its
// tile, then look_back publishes the tile's aggregate, sums its
// predecessors' words back to the nearest one holding an inclusive prefix,
// and publishes its own inclusive prefix.  The state must read as zero when
// the launch starts; each kernel says who zeroes it.
#pragma once

#include "common.cuh"

namespace {

typedef unsigned long long u64;

// a status word: the flag in the top two bits, the value (below 2^62) under
// them; zero: the tile has published nothing yet
constexpr u64 ST_AGG = 1ull << 62;  // the tile's own sum
constexpr u64 ST_PRE = 2ull << 62;  // the sum of every tile up to this one
constexpr u64 ST_VAL = ST_AGG - 1;
// polls of one predecessor's word before a launch gives up (__trap): a
// predecessor took its tile first, so it runs and publishes within
// microseconds; a hang would be a bug, and turns into an error instead
constexpr unsigned int LOOKBACK_SPIN_MAX = 1u << 22;

// The tile of this block: the ticket counter *ticket, post-incremented.
// Called by every thread; a barrier.
__device__ __forceinline__ int take_tile(u64* ticket, int* s_tile) {
  if (threadIdx.x == 0) *s_tile = (int)atomicAdd(ticket, 1ull);
  __syncthreads();
  return *s_tile;
}

__device__ __forceinline__ u64 poll(const u64* word) {
  const volatile u64* w = word;
  u64 v = *w;
  for (unsigned int k = 0; v == 0; v = *w) {
    if (++k == LOOKBACK_SPIN_MAX) __trap();
    __nanosleep(32);
  }
  return v;
}

// The sum of every tile before `tile`: warp 0 publishes the tile's
// aggregate, sums its predecessors' words 32 at a time back to the nearest
// one holding an inclusive prefix, and publishes its own inclusive prefix.
// Each word holds flag and value together (one 64-bit store), so no fence
// orders them.  Thread 0 makes both stores.  Called by every thread; a
// barrier; returns the sum to every thread through *s_excl.
__device__ __forceinline__ u64 look_back(u64* status, int tile, u64 agg, u64* s_excl) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    u64 excl = 0;
    if (tile == 0) {
      if (lane == 0) *(volatile u64*)status = ST_PRE | agg;
    } else {
      if (lane == 0) *(volatile u64*)(status + tile) = ST_AGG | agg;
      for (int last = tile - 1;; last -= 32) {
        const int p = last - lane;  // tile 0 holds a prefix: the window stops there
        const u64 w = p >= 0 ? poll(status + p) : ST_PRE;
        const unsigned int pre = __ballot_sync(0xffffffffu, (w & ~ST_VAL) == ST_PRE);
        const int stop = pre ? __ffs(pre) - 1 : 31;
        u64 v = lane <= stop ? (w & ST_VAL) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        excl += v;
        if (pre) break;
      }
      if (lane == 0) *(volatile u64*)(status + tile) = ST_PRE | (excl + agg);
    }
    if (lane == 0) *s_excl = excl;
  }
  __syncthreads();
  return *s_excl;
}

}  // namespace

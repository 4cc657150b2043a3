// Shared pieces of the window-sweep kernels (phase1_sweep.cu,
// phase2_sweep.cu, virial_sweep.cu).
//
// Contract (the same as the JAX package's window kernels): the frame is
// sorted by cell key; receiver block b = rows [b*B, (b+1)*B); for each
// cell-row offset o its candidate senders are the contiguous rows
// [win_start[b][o], win_start[b][o] + win_len[b][o]).  Each kernel has two
// pair rules, chosen by the template parameter ROWS:
//
// * field-major (ROWS = false; particlemethod_fsi_tpu/ops/pallas_windows_t.py,
//   kernels 1-3): a pair (i, j) counts when the sender's key lies in the
//   ring {key_i + off - 1 .. key_i + off + 1} and rij2 > 0;
// * row-major (ROWS = true; particlemethod_fsi_tpu/ops/pallas_pairwise.py,
//   kernels 4-6): the ring is recomputed from positions -- the sender's cell
//   coordinate within one of the receiver's in x and exactly (oy, oz) away
//   in y (z) -- and the pair also needs prop_j >= 0 (pad rows carry the
//   sentinel key but their position may lie inside the fluid), j != i and
//   rij2 <= support^2.  The key is not read.
//
// Every family then applies its own radius test.
//
// Design: one thread block per receiver block, one thread per receiver with
// its accumulators in registers.  Phases 1 and 3 walk each window exactly
// from start to start + len in tiles of FSI_TILE senders staged through
// shared memory (coalesced loads; in the pair loop all threads read the same
// sender, a shared-memory broadcast).  Phase 2 walks only each receiver's
// ring run: the frame is sorted by key, so the senders in a receiver's ring
// for one offset are one contiguous run of rows of the window, found by
// binary search on the window's keys staged in shared memory
// (fsi_lower_bound); see phase2_sweep.cu.
// Keys are compared as int32.  No atomics in the sums: each receiver sums
// its own senders in a fixed order, so results are deterministic.  Compile
// WITHOUT -use_fast_math: the viscosity term relies on 2/(inf + x) == 0 and
// the masks on rij2 > 0 exactly.
#pragma once

#include <climits>

#include <cuda_runtime.h>

#define FSI_TILE 128
#define FSI_MAX_OFFS 27
#define FSI_TYPE_COUNT 6
#define FSI_STRUCTURE_BEGIN 2
#define FSI_STRUCTURE_END 4

// float: the hardware reciprocal square root (2 ulp); double: 1/sqrt, which
// is correctly rounded and lets the double instances be held against the
// plain PyTorch version to ~1e-12.
__device__ __forceinline__ float fsi_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double fsi_rsqrt(double x) { return 1.0 / sqrt(x); }

__device__ __forceinline__ bool fsi_is_structure(int prop) {
  return prop >= FSI_STRUCTURE_BEGIN && prop < FSI_STRUCTURE_END;
}

__device__ __forceinline__ int fsi_clip_type(int prop) {
  return prop < 0 ? 0 : (prop >= FSI_TYPE_COUNT ? FSI_TYPE_COUNT - 1 : prop);
}

// InteractionRatio[a][b] with a already clipped; a sender type outside the
// table (a pad row) selects nothing, i.e. 0, as the one-hot sum of the JAX
// kernels does.
template <typename T>
__device__ __forceinline__ T fsi_ratio(const T* table, int a, int b) {
  return (b >= 0 && b < FSI_TYPE_COUNT) ? table[a * FSI_TYPE_COUNT + b] : T(0);
}

// Cooperative copy of `count` contiguous elements into shared memory.
template <typename T>
__device__ __forceinline__ void fsi_stage(T* dst, const T* src, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

// Cell coordinate of one position component, as the sort key computes it:
// a true divide by the cell width (no reciprocal multiply, which rounds
// differently for a particle exactly on a cell boundary and would split the
// ring from the key), floored and clipped into the grid.
template <typename T>
__device__ __forceinline__ int fsi_cell(T x, T dmin, T cw, int count) {
  T c = floor((x - dmin) / cw);
  c = c < T(0) ? T(0) : c;
  c = c > T(count - 1) ? T(count - 1) : c;
  return static_cast<int>(c);
}

// The row-major pair rule's geometry (ROWS = true).
template <typename T>
struct FsiRows {
  T dmin[3];
  T cw[3];
  int ncell[3];
  int three_d;              // ncell[2] > 1: the ring also tests z
  int oy[FSI_MAX_OFFS];     // row offset o's (oy, oz)
  int oz[FSI_MAX_OFFS];
};

template <typename T>
static void fsi_rows_fill(FsiRows<T>* g, int n_off, const int* offs_yz,
                          const double* geom, const int* ncell) {
  for (int d = 0; d < 3; ++d) {
    g->dmin[d] = static_cast<T>(geom[d]);
    g->cw[d] = static_cast<T>(geom[3 + d]);
    g->ncell[d] = ncell[d];
  }
  g->three_d = ncell[2] > 1;
  for (int o = 0; o < n_off; ++o) {
    g->oy[o] = offs_yz[2 * o];
    g->oz[o] = offs_yz[2 * o + 1];
  }
}

// Stage the linear cell index (x fastest) of the senders of rows
// [row0, row0 + cnt): the cell coordinates are computed once per sender
// when its tile is staged, not once per pair; a pad row (prop < 0) gets
// INT_MIN, which lies in no ring.
template <typename T>
__device__ __forceinline__ void fsi_stage_lin(int* s_lin, const T* pos,
                                              const int* prop, int row0,
                                              int cnt, const FsiRows<T>& g) {
  for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
    const T* q = pos + 3 * (size_t)(row0 + j);
    const int cx = fsi_cell(q[0], g.dmin[0], g.cw[0], g.ncell[0]);
    const int cy = fsi_cell(q[1], g.dmin[1], g.cw[1], g.ncell[1]);
    const int cz =
        g.three_d ? fsi_cell(q[2], g.dmin[2], g.cw[2], g.ncell[2]) : 0;
    s_lin[j] = prop[row0 + j] >= 0
                   ? cx + g.ncell[0] * (cy + g.ncell[1] * cz)
                   : INT_MIN;
  }
}

// The ring of row offset o for a receiver in cell (cx, cy, cz), as one range
// of linear cells [lo, lo + span]: the JAX kernel's |cx_j - cx| <= 1,
// cy_j - cy == oy and, in 3-D, cz_j - cz == oz, over cells that exist.
// (cx +- 1 is clipped to the grid, and a target row outside it makes the
// ring empty: lo = INT_MIN + 1 matches no staged sender.)  Testing a sender
// then costs one shared load and one compare, as the key ring does.
struct FsiRing {
  int lo;
  unsigned span;
};

template <typename T>
__device__ __forceinline__ FsiRing fsi_ring(int cx, int cy, int cz, int o,
                                            const FsiRows<T>& g) {
  const int ty = cy + g.oy[o], tz = cz + g.oz[o];
  if (ty < 0 || ty >= g.ncell[1] || tz < 0 || tz >= g.ncell[2])
    return FsiRing{INT_MIN + 1, 0u};
  const int x0 = cx > 0 ? cx - 1 : 0;
  const int x1 = cx < g.ncell[0] - 1 ? cx + 1 : g.ncell[0] - 1;
  return FsiRing{x0 + g.ncell[0] * (ty + g.ncell[1] * tz),
                 static_cast<unsigned>(x1 - x0)};
}

__device__ __forceinline__ bool fsi_in_ring(int lin, FsiRing r) {
  return static_cast<unsigned>(lin) - static_cast<unsigned>(r.lo) <= r.span;
}

// ---------------------------------------------------------------------------
// Used by phase 2 only for now.

// First index r in [lo, hi) with key[r] >= v, or hi: a lower bound on keys
// sorted over [lo, hi) (phase 2 searches a window's keys staged in shared
// memory).
__device__ __forceinline__ int fsi_lower_bound(const int* key, int lo, int hi,
                                               int v) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (key[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Asynchronous copy of one 4- or 8-byte element from device memory to shared
// memory (cp.async, sm_80 and later): the copies of a chunk all start
// before any is waited for, and go to shared memory without a register.
// The copying thread sees its own copies after fsi_async_wait(); the other
// threads after a __syncthreads() that follows it.
template <typename E>
__device__ __forceinline__ void fsi_async_copy(E* dst, const E* src) {
  static_assert(sizeof(E) == 4 || sizeof(E) == 8, "4- or 8-byte elements");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(E)));
}

__device__ __forceinline__ void fsi_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

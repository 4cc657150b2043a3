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
//   rij2 <= support^2.  The pair rule reads no key: kernels 4-6 take the
//   sorted key to find their runs only (the frame must be sorted from its
//   own positions, where every valid row's key is its linear cell).
//
// Every family then applies its own radius test.
//
// Design: one thread block per receiver block, one thread per receiver with
// its accumulators in registers.  Every kernel walks only each receiver's
// ring runs: the frame is sorted by key, so the senders in a receiver's ring
// for one offset are one contiguous run of rows of the window.  A block
// stages the windows of all its offsets together, in chunks, and each
// receiver finds its run in each window's part of a chunk by binary search
// on the staged keys (the ring-run walk below; see phase2_sweep.cu).
// Keys are compared as int32.  No atomics in the sums: each receiver sums
// its own senders in a fixed order, so results are deterministic.  Compile
// WITHOUT -use_fast_math: the viscosity term relies on 2/(inf + x) == 0 and
// the masks on rij2 > 0 exactly.
#pragma once

#include <climits>

#include <cuda_runtime.h>

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
// The ring-run walk (phase1_sweep.cu, phase2_sweep.cu, virial_sweep.cu).
//
// A block concatenates the windows of its offsets in offset order and
// stages them in chunks of FsiChunk senders, one shared array a field
// (fsi_window_cum, fsi_chunk_rows, fsi_async_copy); each receiver finds its
// ring run in each window's part of a chunk by two lower bounds on the
// staged keys (fsi_lower_bound) and walks it in batches of FSI_BATCH
// (fsi_walk_run): a branch-free pre-test sets one bit a sender, and the
// pair body runs over the set bits in ascending order.  A run that two
// chunks split is found in each, in order, so every receiver sums the same
// terms in the same order as a walk of its whole window would.

// Senders one chunk stages: a block's windows of all offsets together
// (about 275 rows in 2-D at the bench scene's density) fit in one float
// chunk; the double instances serve the checks and use smaller chunks,
// which also exercises the chunking.
template <typename T> struct FsiChunk;
template <> struct FsiChunk<float> { static constexpr int value = 384; };
template <> struct FsiChunk<double> { static constexpr int value = 128; };

// Senders a receiver pre-tests before it runs the pair body over the ones
// that passed: one bit each of a 32-bit mask.
#define FSI_BATCH 32

// s_cum[o]: where offset o's window starts in the concatenation of the
// block's windows (win_len: the block's row of the table); s_cum[n_off]:
// their total.  Thread 0 writes it; the caller synchronises.
__device__ __forceinline__ void fsi_window_cum(int* s_cum, const int* win_len,
                                               int n_off) {
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int o = 0; o < n_off; ++o) {
      s_cum[o] = acc;
      acc += win_len[o];
    }
    s_cum[n_off] = acc;
  }
}

// f(s, r) for each sender of the chunk [v0, v1) of the concatenation that
// this thread stages: s its index in the chunk, r its frame row (win_start:
// the block's row of the table).
template <typename F>
__device__ __forceinline__ void fsi_chunk_rows(const int* s_cum,
                                               const int* win_start, int n_off,
                                               int v0, int v1, F f) {
  for (int o = 0; o < n_off; ++o) {
    const int a = max(s_cum[o], v0), e = min(s_cum[o + 1], v1);
    // frame row = concatenation index + shift
    const int shift = win_start[o] - s_cum[o];
    for (int v = a + threadIdx.x; v < e; v += blockDim.x) f(v - v0, v + shift);
  }
}

// The row rule's linear cell of each sender this thread staged, from its own
// staged copies (the sort key's true divide; INT_MIN for a pad, in no
// ring), for the ring test; z from device memory where the planar instance
// stages none.  Call after fsi_async_wait(), before the __syncthreads()
// that publishes it.
//
// The runs are searched in the staged keys, not in these cells.  A pad's
// INT_MIN, read as unsigned, would sort after every cell only while pads
// sit at the frame's end (the sort's tail, key num_cells); a 3-D frame has
// pad rows at every plane's end (pad_frame_planes, key the plane's last
// cell), and a window of the last block of plane k reaches into plane
// k + 1, so its staged cells read [plane k, INT_MIN pads, plane k + 1]:
// not sorted, and a search in them could skip a receiver's run.  The keys
// stay sorted there.
template <typename T, bool PLANAR>
__device__ __forceinline__ void fsi_chunk_lin(
    int* s_lin, const T* s_x, const T* s_y, const T* s_z, const int* s_prop,
    const T* pos, const int* s_cum, const int* win_start, int n_off, int v0,
    int v1, const FsiRows<T>& g) {
  fsi_chunk_rows(s_cum, win_start, n_off, v0, v1, [&](int s, int r) {
    const int cx = fsi_cell(s_x[s], g.dmin[0], g.cw[0], g.ncell[0]);
    const int cy = fsi_cell(s_y[s], g.dmin[1], g.cw[1], g.ncell[1]);
    int cz = 0;
    if (g.three_d) {
      const T z = PLANAR ? pos[3 * static_cast<size_t>(r) + 2] : s_z[s];
      cz = fsi_cell(z, g.dmin[2], g.cw[2], g.ncell[2]);
    }
    s_lin[s] = s_prop[s] >= 0 ? cx + g.ncell[0] * (cy + g.ncell[1] * cz)
                              : INT_MIN;
  });
}

// First index r in [lo, hi) with key[r] >= v, or hi: a lower bound on keys
// sorted over [lo, hi).
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

// Walk the run [j0, j1) of the staged chunk: test(j), branch-free, says
// whether sender j pairs with this receiver; body(j) runs over the senders
// that passed, in ascending order.  A warp's pre-test steps are the longest
// run of its lanes and its body steps the largest count of set bits.
// Returns the number of senders that passed (the checking build counts it).
template <typename Test, typename Body>
__device__ __forceinline__ unsigned fsi_walk_run(int j0, int j1, Test test,
                                                 Body body) {
  unsigned passed = 0;
  for (int base = j0; base < j1; base += FSI_BATCH) {
    const int cnt = min(FSI_BATCH, j1 - base);
    unsigned live = 0u;
#pragma unroll
    for (int t = 0; t < FSI_BATCH; ++t) {
      if (t >= cnt) break;
      live |= static_cast<unsigned>(test(base + t)) << t;
    }
    passed += __popc(live);
    while (live) {
      const int j = base + __ffs(live) - 1;
      live &= live - 1u;
      body(j);
    }
  }
  return passed;
}

// A checking build (-DFSI_WALK_COUNT; chip_smoke.py makes one beside the
// library the solver loads) counts what the window kernels walk, summed
// over their launches: [0] the senders the receivers
// pre-test, [1] the pre-test steps of the warps (for each run, the longest
// of the 32 lanes'), [2] the senders that pass the pre-test.  The results
// are the same as without the counts.  Blocks are whole warps there.
#ifdef FSI_WALK_COUNT
struct FsiWalkCount {
  unsigned tested = 0, steps = 0, passed = 0;
  // every lane of the warp calls it for the same run
  __device__ __forceinline__ void run(int j0, int j1) {
    tested += j1 - j0;
    steps += __reduce_max_sync(0xffffffffu, static_cast<unsigned>(j1 - j0));
  }
  __device__ __forceinline__ void add_to(unsigned long long* counts) {
    const unsigned t = __reduce_add_sync(0xffffffffu, tested);
    const unsigned p = __reduce_add_sync(0xffffffffu, passed);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(&counts[0], static_cast<unsigned long long>(t));
      atomicAdd(&counts[1], static_cast<unsigned long long>(steps));
      atomicAdd(&counts[2], static_cast<unsigned long long>(p));
    }
  }
};

// Copy a kernel's counts to the host array out[3] and clear them; returns
// a cudaError_t (0 = success).
static inline int fsi_read_counts(const void* symbol, unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, symbol,
                                         3 * sizeof(unsigned long long));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[3] = {0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(symbol, zero, sizeof(zero)));
}
#endif

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

// Shared pieces of the window-sweep kernels (phase1_sweep.cu, phase2_sweep.cu).
//
// Contract (the same as the JAX package's field-major window kernels,
// particlemethod_fsi_tpu/ops/pallas_windows_t.py): the frame is sorted by
// cell key; receiver block b = rows [b*B, (b+1)*B); for each cell-row offset
// o its candidate senders are the contiguous rows
// [win_start[b][o], win_start[b][o] + win_len[b][o]).  A pair (i, j) counts
// when the sender's key lies in the ring {key_i + off - 1 .. key_i + off + 1}
// and rij2 > 0; every family then applies its own radius test.
//
// Design: one thread block per receiver block, one thread per receiver with
// its accumulators in registers.  Each window is walked exactly from start
// to start + len in tiles of FSI_TILE senders staged through shared memory
// (coalesced loads; in the pair loop all threads read the same sender, a
// shared-memory broadcast).  Keys are compared as int32.  No atomics: each
// receiver sums its own senders in a fixed order, so results are
// deterministic.  Compile WITHOUT -use_fast_math: the viscosity term relies
// on 2/(inf + x) == 0 and the masks on rij2 > 0 exactly.
#pragma once

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

// Packed-bf16 against float32 throughput probe: `reps` trips of a
// phase-2-like elementwise chain (sub, mul, rsqrt, compare, select, row sum)
// over a [b, w] tile, accumulated in float32.
//
// Replaces the TPU kernel tools/bf16_microbench.py `_kernel` (launched by
// `run` through `pl.pallas_call`; kernel 7).  It lies on no path of the
// solver: it answers, for this card, whether the pair math would run ~2x
// faster in packed bf16 than in float32.  The chain is that of `_chain`: in
// the bf16 instance mul/add/sub/select run on __nv_bfloat162 pairs, while
// the masks are float32 compares and the rsqrt is a float32 rsqrt rounded to
// bf16, as there; the row sum is float32.  Every operation is written with
// an explicit rounding intrinsic that forbids contraction into a fused
// multiply-add (`__fmul_rn`, `__hmul2_rn`, ...; a plain `__hmul2` followed by
// `__hadd2` may become one bf16 fma), so each rounds where the plain PyTorch
// twin's separate operations round.
//
// Layout: one thread per adjacent element pair (w / 2 threads a block);
// block (row, s) runs trips [s * reps / splits, (s + 1) * reps / splits) of
// one row and writes one float32 partial sum; the wrapper adds the
// `splits` partials of a row.  Splitting the trips fills the card (128 rows
// alone would give one block to each SM).  Bound: operations -- the inputs
// are 0.5 MB, read once; the chain does about 21 operations an element a
// trip.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float chain_f32(float x, float y, float k) {
  const float dxx = __fsub_rn(x, k);
  const float dyy = __fadd_rn(y, k);
  const float r2 = __fadd_rn(__fmul_rn(dxx, dxx), __fmul_rn(dyy, dyy));
  const bool m0 = r2 > 0.25f;
  const float r2s = m0 ? r2 : 1.0f;
  const float inv_r = rsqrtf(r2s);
  const float rij = __fmul_rn(r2s, inv_r);
  const float omq = __fsub_rn(1.0f, __fmul_rn(rij, 0.4f));
  const bool m = (r2 > 0.1f) && (omq > 0.0f);
  const float w1 = __fmul_rn(omq, omq);
  const float w2 = __fmul_rn(w1, rij);
  const float radial = __fadd_rn(__fmul_rn(w2, dxx), __fmul_rn(w1, dyy));
  return m ? radial : 0.0f;
}

// Two elements in packed bf16; returns their radial terms as float32.
__device__ __forceinline__ float2 chain_bf16x2(__nv_bfloat162 x,
                                               __nv_bfloat162 y,
                                               __nv_bfloat162 k) {
  const __nv_bfloat162 dxx = __hsub2_rn(x, k);
  const __nv_bfloat162 dyy = __hadd2_rn(y, k);
  const __nv_bfloat162 r2 =
      __hadd2_rn(__hmul2_rn(dxx, dxx), __hmul2_rn(dyy, dyy));
  const float2 r2f = __bfloat1622float2(r2);
  // masks by float32 compares; rsqrt in float32, then rounded to bf16
  const bool m0a = r2f.x > 0.25f, m0b = r2f.y > 0.25f;
  const float r2sfa = m0a ? r2f.x : 1.0f, r2sfb = m0b ? r2f.y : 1.0f;
  const __nv_bfloat162 inv_r =
      __floats2bfloat162_rn(rsqrtf(r2sfa), rsqrtf(r2sfb));
  const __nv_bfloat162 r2s = __floats2bfloat162_rn(r2sfa, r2sfb);
  const __nv_bfloat162 rij = __hmul2_rn(r2s, inv_r);
  const __nv_bfloat162 one = __float2bfloat162_rn(1.0f);
  const __nv_bfloat162 c04 = __float2bfloat162_rn(0.4f);
  const __nv_bfloat162 omq = __hsub2_rn(one, __hmul2_rn(rij, c04));
  const float2 omqf = __bfloat1622float2(omq);
  const bool ma = (r2f.x > 0.1f) && (omqf.x > 0.0f);
  const bool mb = (r2f.y > 0.1f) && (omqf.y > 0.0f);
  const __nv_bfloat162 w1 = __hmul2_rn(omq, omq);
  const __nv_bfloat162 w2 = __hmul2_rn(w1, rij);
  const __nv_bfloat162 radial =
      __hadd2_rn(__hmul2_rn(w2, dxx), __hmul2_rn(w1, dyy));
  const float2 rf = __bfloat1622float2(radial);
  return make_float2(ma ? rf.x : 0.0f, mb ? rf.y : 0.0f);
}

template <bool BF16>
__global__ void bf16_microbench_kernel(const void* x, const void* y,
                                       float* partial, int b, int w, int reps,
                                       int splits) {
  __shared__ float s_sum[32];
  const int row = blockIdx.x, s = blockIdx.y;
  const int pair = threadIdx.x;  // elements 2 pair, 2 pair + 1
  const int t0 = (int)((long long)reps * s / splits);
  const int t1 = (int)((long long)reps * (s + 1) / splits);
  const size_t at = (size_t)row * w + 2 * pair;
  float acc = 0.0f;
  if (BF16) {
    const __nv_bfloat162 xv =
        reinterpret_cast<const __nv_bfloat162*>(x)[at / 2];
    const __nv_bfloat162 yv =
        reinterpret_cast<const __nv_bfloat162*>(y)[at / 2];
    for (int i = t0; i < t1; ++i) {
      // the trip's scalar is float32 math rounded to bf16, as there
      const float kf = __fadd_rn(1.0f, __fmul_rn((float)i, 0.0625f));
      const float2 r = chain_bf16x2(xv, yv, __float2bfloat162_rn(kf));
      acc = __fadd_rn(acc, __fadd_rn(r.x, r.y));
    }
  } else {
    const float2 xv = reinterpret_cast<const float2*>(x)[at / 2];
    const float2 yv = reinterpret_cast<const float2*>(y)[at / 2];
    for (int i = t0; i < t1; ++i) {
      const float kf = __fadd_rn(1.0f, __fmul_rn((float)i, 0.0625f));
      acc = __fadd_rn(acc, __fadd_rn(chain_f32(xv.x, yv.x, kf),
                                     chain_f32(xv.y, yv.y, kf)));
    }
  }
  // block sum: warp shuffles, then the warps' sums through shared memory
  for (int d = 16; d > 0; d >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, d);
  if ((threadIdx.x & 31) == 0) s_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int nwarps = blockDim.x >> 5;
    float v = threadIdx.x < nwarps ? s_sum[threadIdx.x] : 0.0f;
    for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
    if (threadIdx.x == 0) partial[(size_t)s * b + row] = v;
  }
}

// Plain C entry point.  x and y are device [b, w] arrays of float32
// (bf16 == 0) or bf16 (bf16 == 1); partial is a device [splits, b] float32
// array.  w must be even, w / 2 a multiple of 32 and at most 1024.  Returns
// cudaGetLastError() of the launch (0 = success), or -1 for arguments the
// kernel does not take.
extern "C" int fsi_bf16_microbench(int bf16, const void* x, const void* y,
                                   void* partial, int b, int w, int reps,
                                   int splits, void* stream) {
  if (b <= 0 || w <= 0 || w % 64 != 0 || w / 2 > 1024 || reps < 0 ||
      splits <= 0 || splits > 65535)
    return -1;
  const dim3 grid(b, splits), threads(w / 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(partial);
  if (bf16)
    bf16_microbench_kernel<true><<<grid, threads, 0, s>>>(x, y, out, b, w,
                                                          reps, splits);
  else
    bf16_microbench_kernel<false><<<grid, threads, 0, s>>>(x, y, out, b, w,
                                                           reps, splits);
  return static_cast<int>(cudaGetLastError());
}

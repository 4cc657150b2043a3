// Packed-bf16 against float32 throughput probe: `reps` trips of a
// phase-2-like elementwise chain (sub, mul, rsqrt, compare, select, row sum)
// over a [b, w] tile, accumulated in float32.
//
// Replaces the TPU kernel tools/bf16_microbench.py `_kernel` (launched by
// `run` through `pl.pallas_call`; kernel 7).  It lies on no path of the
// solver: it answers, for this card, whether the pair math runs faster in
// packed bf16 than in float32.  The chain is that of `_chain`: in the bf16
// instance mul/add/sub/select run on __nv_bfloat162 pairs, while the masks
// are float32 compares and the rsqrt is a float32 rsqrt rounded to bf16, as
// there; the row sum is float32.  Every operation is written with an
// explicit rounding intrinsic that forbids contraction into a fused
// multiply-add (`__fmul_rn`, `__hmul2_rn`, ...), so each rounds where the
// plain PyTorch twin's separate operations round, and the value of every
// element-trip is the twin's.
//
// What bounds it on this card: instruction issue.  The tile is 0.5 MB and
// is read once into registers; every operation of the chain is one
// instruction, since none may fuse, so the least time is the chain's
// instructions over the SMs' issue rate (4 warp-instructions a clock an SM),
// half of what the float32 peak (which counts a fused multiply-add as two
// operations) suggests.  The design spends as few instructions as it can on
// what is not the chain:
// - one launch a call: every block adds its threads' sums of each row it
//   touches, and the last block to finish (an atomic ticket after
//   __threadfence, as in the CUDA C++ Programming Guide's example of
//   memory fences) adds each row's block sums in block order, so two
//   launches give bit-equal rows;
// - a grid sized to the card: `blocks` (a few per SM, from the wrapper's
//   plan) split the row-major (row, trip) units evenly, block j taking units
//   [units j / blocks, units (j + 1) / blocks); a thread owns one element
//   pair of the row for the block's trips of that row;
// - the trip loop runs four trips a pass into two accumulators, the trip's
//   scalar k = 1 + i / 16 advancing by exact float32 additions (one a trip,
//   shared by the pair) instead of a conversion of i; in bf16 one
//   conversion packs the scalars of two trips (conversions, like the rsqrt,
//   run at 16 lanes a clock an SM, an eighth of the issue rate);
// - the rsqrt's argument is 1 or above 0.25, where the flush-to-zero form
//   (one MUFU instruction) gives the same value as the IEEE form, which
//   adds a denormal test and two scalings;
// - in bf16, the masks are packed compares against bf16 constants that give
//   the float32 compare's answer for every bf16 value (0.25, 0, and
//   0.099609375 for 0.1f, which is no bf16 value; pinned over all 65,536
//   patterns by the CPU tests), and the selects are bit masks, so only the
//   rsqrt's argument and the two terms are unpacked to float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxSlots = 1 << 16;  // block sums: b + blocks - 1 at most
constexpr int kMaxReps = 1 << 20;   // k = 1 + i / 16 stays exact below this

// one block sum for each (row, block) a block touches, at slot row + block
// (unique: along the blocks the rows only grow), and the finishing ticket
__device__ float g_slots[kMaxSlots];
__device__ unsigned int g_ticket = 0;

// 1 / sqrt(v) for v = 1 or v > 0.25 (normal or +inf): the flush-to-zero
// form is one MUFU.RSQ, and on such arguments it equals rsqrtf
__device__ __forceinline__ float rsqrt_normal(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float term_f32(float x, float y, float k) {
  const float dxx = __fsub_rn(x, k);
  const float dyy = __fadd_rn(y, k);
  const float r2 = __fadd_rn(__fmul_rn(dxx, dxx), __fmul_rn(dyy, dyy));
  const float r2s = r2 > 0.25f ? r2 : 1.0f;
  const float inv_r = rsqrt_normal(r2s);
  const float rij = __fmul_rn(r2s, inv_r);
  const float omq = __fsub_rn(1.0f, __fmul_rn(rij, 0.4f));
  const bool m = (r2 > 0.1f) && (omq > 0.0f);
  const float w1 = __fmul_rn(omq, omq);
  const float w2 = __fmul_rn(w1, rij);
  const float radial = __fadd_rn(__fmul_rn(w2, dxx), __fmul_rn(w1, dyy));
  return m ? radial : 0.0f;
}

// the two elements' terms of one trip
__device__ __forceinline__ float2 terms(float2 x, float2 y, float k) {
  return make_float2(term_f32(x.x, y.x, k), term_f32(x.y, y.y, k));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  unsigned u;
  memcpy(&u, &v, sizeof u);
  return u;
}

__device__ __forceinline__ __nv_bfloat162 from_bits(unsigned u) {
  __nv_bfloat162 v;
  memcpy(&v, &u, sizeof u);
  return v;
}

// the bf16 halves of u as float32: low half first
__device__ __forceinline__ float2 unpack(unsigned u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// k: the trip's scalar in bf16, in both halves
__device__ __forceinline__ float2 terms(__nv_bfloat162 x, __nv_bfloat162 y,
                                        __nv_bfloat162 k) {
  const __nv_bfloat162 one = __float2bfloat162_rn(1.0f);
  const __nv_bfloat162 dxx = __hsub2_rn(x, k);
  const __nv_bfloat162 dyy = __hadd2_rn(y, k);
  const __nv_bfloat162 r2 =
      __hadd2_rn(__hmul2_rn(dxx, dxx), __hmul2_rn(dyy, dyy));
  // r2 > 0.25f: 0.25 is a bf16 value, so the packed compare is the same
  const unsigned m0 = __hgt2_mask(r2, __float2bfloat162_rn(0.25f));
  const unsigned r2s = (bits(r2) & m0) | (bits(one) & ~m0);
  // rsqrt in float32, rounded to bf16
  const float2 r2sf = unpack(r2s);
  const __nv_bfloat162 inv_r =
      __floats2bfloat162_rn(rsqrt_normal(r2sf.x), rsqrt_normal(r2sf.y));
  const __nv_bfloat162 rij = __hmul2_rn(from_bits(r2s), inv_r);
  const __nv_bfloat162 omq =
      __hsub2_rn(one, __hmul2_rn(rij, __float2bfloat162_rn(0.4f)));
  // r2 > 0.1f: for a bf16 r2 it is r2 > 0.099609375, the bf16 value below
  // 0.1f; omq > 0 is exact
  const unsigned m =
      __hgt2_mask(r2, __float2bfloat162_rn(0.099609375f)) &
      __hgt2_mask(omq, __float2bfloat162_rn(0.0f));
  const __nv_bfloat162 w1 = __hmul2_rn(omq, omq);
  const __nv_bfloat162 w2 = __hmul2_rn(w1, rij);
  const __nv_bfloat162 radial =
      __hadd2_rn(__hmul2_rn(w2, dxx), __hmul2_rn(w1, dyy));
  return unpack(bits(radial) & m);
}

// the scalars of two trips from their float32 values a and b, in the form
// the chain takes: float32 as they are; bf16 rounded (one conversion packs
// both) and each broadcast to both halves
__device__ __forceinline__ void scalars(float a, float b, float& ka,
                                        float& kb) {
  ka = a;
  kb = b;
}

__device__ __forceinline__ void scalars(float a, float b, __nv_bfloat162& ka,
                                        __nv_bfloat162& kb) {
  const __nv_bfloat162 k = __floats2bfloat162_rn(a, b);
  ka = __low2bfloat162(k);
  kb = __high2bfloat162(k);
}

// one trip of an element pair: the sum of its two terms, as the twin's row
// sum adds them
template <typename T, typename K>
__device__ __forceinline__ float trip(T x, T y, K k) {
  const float2 t = terms(x, y, k);
  return __fadd_rn(t.x, t.y);
}

// trips [t0, t1) of one element pair: four a pass into two accumulators.
// K is the type of the chain's scalar (float, or __nv_bfloat162)
template <typename T, typename K>
__device__ __forceinline__ float trips(T x, T y, int t0, int t1) {
  float acc0 = 0.0f, acc1 = 0.0f;
  float k = __fadd_rn(1.0f, __fmul_rn((float)t0, 0.0625f));
  K k0, k1, k2, k3;
  int t = t0;
#pragma unroll 1
  for (; t + 4 <= t1; t += 4) {
    scalars(k, __fadd_rn(k, 0.0625f), k0, k1);
    scalars(__fadd_rn(k, 0.125f), __fadd_rn(k, 0.1875f), k2, k3);
    acc0 = __fadd_rn(acc0, trip(x, y, k0));
    acc1 = __fadd_rn(acc1, trip(x, y, k1));
    acc0 = __fadd_rn(acc0, trip(x, y, k2));
    acc1 = __fadd_rn(acc1, trip(x, y, k3));
    k = __fadd_rn(k, 0.25f);
  }
#pragma unroll 1
  for (; t < t1; ++t) {
    scalars(k, k, k0, k1);
    acc0 = __fadd_rn(acc0, trip(x, y, k0));
    k = __fadd_rn(k, 0.0625f);
  }
  return __fadd_rn(acc0, acc1);
}

// the block's sum of v, in thread 0 (blockDim.x a multiple of 32)
__device__ __forceinline__ float block_sum(float v, float* s_warp) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < (blockDim.x >> 5) ? s_warp[threadIdx.x] : 0.0f;
    for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  }
  __syncthreads();  // s_warp is reused by the next row
  return v;
}

__host__ __device__ __forceinline__ long long ceil_div(long long a,
                                                       long long b) {
  return (a + b - 1) / b;
}

}  // namespace

// x, y: [b, pairs] element pairs; out: [b] row sums.  blockDim.x == pairs.
template <typename T, typename K>
__global__ void __launch_bounds__(1024)
    bf16_microbench_kernel(const T* __restrict__ x, const T* __restrict__ y,
                           float* __restrict__ out, int b, int pairs, int reps,
                           int blocks) {
  __shared__ float s_warp[32];
  __shared__ bool s_last;
  const long long units = (long long)b * reps;
  const long long u1 = units * (blockIdx.x + 1) / blocks;
  for (long long u = units * blockIdx.x / blocks; u < u1;) {
    const int row = (int)(u / reps);
    const int t0 = (int)(u - (long long)row * reps);
    const int t1 = (int)min((long long)reps, t0 + (u1 - u));
    const size_t at = (size_t)row * pairs + threadIdx.x;
    const float v = block_sum(trips<T, K>(x[at], y[at], t0, t1), s_warp);
    if (threadIdx.x == 0) g_slots[row + blockIdx.x] = v;
    u += t1 - t0;
  }
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(&g_ticket, 1u) == (unsigned)blocks - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block: each row's block sums in block order.  Row r's blocks
  // are first = the first whose units end past r reps, last = the last whose
  // units begin before (r + 1) reps (the wrapper's plan.row_blocks)
  for (int row = threadIdx.x; row < b; row += blockDim.x) {
    float s = 0.0f;
    if (units > 0) {
      const long long first =
          ceil_div(((long long)row * reps + 1) * blocks, units) - 1;
      const long long last =
          ceil_div((long long)(row + 1) * reps * blocks, units) - 1;
      for (long long j = first; j <= last; ++j)
        s = __fadd_rn(s, __ldcg(&g_slots[row + j]));
    }
    out[row] = s;
  }
  if (threadIdx.x == 0) g_ticket = 0;
}

// each element's term at one trip (for checks: the kernel's chain, element
// by element); out: [n pairs] float2
template <typename T, typename K>
__global__ void bf16_microbench_terms_kernel(const T* __restrict__ x,
                                             const T* __restrict__ y,
                                             float2* __restrict__ out, int n,
                                             int trip) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float kf = __fadd_rn(1.0f, __fmul_rn((float)trip, 0.0625f));
  K k, unused;
  scalars(kf, kf, k, unused);
  if (i < n) out[i] = terms(x[i], y[i], k);
}

// Plain C entry point.  x and y are device [b, w] arrays of float32
// (bf16 == 0) or bf16 (bf16 == 1); out is a device [b] float32 array, the
// rows' sums over trips [0, reps); `blocks` is the plan's block count.  w
// must be even, w / 2 a multiple of 32 and at most 1024; one launch at a
// time on a device (the block sums and the ticket are the module's).
// Returns cudaGetLastError() of the launch (0 = success), or -1 for
// arguments the kernel does not take.
extern "C" int fsi_bf16_microbench(int bf16, const void* x, const void* y,
                                   void* out, int b, int w, int reps,
                                   int blocks, void* stream) {
  if (b <= 0 || w <= 0 || w % 64 != 0 || w / 2 > 1024 || reps < 0 ||
      reps > kMaxReps || blocks <= 0 || (long long)b + blocks - 1 > kMaxSlots ||
      (reps > 0 && blocks > (long long)b * reps) || (reps == 0 && blocks != 1))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const int pairs = w / 2;
  if (bf16)
    bf16_microbench_kernel<__nv_bfloat162, __nv_bfloat162>
        <<<blocks, pairs, 0, s>>>(static_cast<const __nv_bfloat162*>(x),
        static_cast<const __nv_bfloat162*>(y), o, b, pairs, reps, blocks);
  else
    bf16_microbench_kernel<float2, float><<<blocks, pairs, 0, s>>>(
        static_cast<const float2*>(x), static_cast<const float2*>(y), o, b,
        pairs, reps, blocks);
  return static_cast<int>(cudaGetLastError());
}

// Checking entry point: out[2 p], out[2 p + 1] = the terms of elements 2 p
// and 2 p + 1 of x, y (n elements, n even) at trip `trip`, float32.
extern "C" int fsi_bf16_microbench_terms(int bf16, const void* x,
                                         const void* y, void* out, int n,
                                         int trip, void* stream) {
  if (n <= 0 || n % 2 != 0 || trip < 0 || trip >= kMaxReps) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* o = static_cast<float2*>(out);
  const int pairs = n / 2, threads = 256;
  const int grid = (pairs + threads - 1) / threads;
  if (bf16)
    bf16_microbench_terms_kernel<__nv_bfloat162, __nv_bfloat162>
        <<<grid, threads, 0, s>>>(static_cast<const __nv_bfloat162*>(x),
        static_cast<const __nv_bfloat162*>(y), o, pairs, trip);
  else
    bf16_microbench_terms_kernel<float2, float><<<grid, threads, 0, s>>>(
        static_cast<const float2*>(x), static_cast<const float2*>(y), o,
        pairs, trip);
  return static_cast<int>(cudaGetLastError());
}

// One elastic substep of the total-Lagrangian solid in structure-subset
// space, in two launches, templated on the type (float, double) and the
// spatial dimension (2, 3).
//
// Replaces no TPU kernel: the JAX package writes the substep in plain jnp
// (particlemethod_fsi_tpu/ops/solid.py, substep_subset), and the port's
// plain version (ops/solid.py, substep_subset) runs it as ~118 eager
// operations over [S, K0] tensors.  On the card those are ~590 launches of
// a few microseconds a step in the Turek channel, enqueued by the host
// while the device waits; this file does the same arithmetic in two.
//
// Launch A, one thread a subset row i:
//   u    = min_image(pos - pos0), rounded as ops/neighbors.min_image rounds
//          it (every operation explicitly rounded, so none fuses);
//   F    = [sum_k w_ik (xij0_ik + u_j - u_i) (x) xij0_ik] A_i^-1;
//   E    = (F^T F - I) / 2,  S = 2 mu E + lambda tr(E) I;
//   P_i  = F S A_i^-1, to a [sd * sd, S] buffer.
// Launch B, one thread a row:
//   dv   = (dtE / rho_i) sum_k w_ik (P_i + P_j) xij0_ik, zero on padding rows;
//   vel += dv on the first sd components; a clamped row gets vel 0 and its
//   initial position; a free row moves by move_dt vel (move_dt is 2 dtE
//   under the double-position-update quirk Q1, else dtE).
//
// The k loops walk only a row's valid initial neighbours: the wrapper hands
// in the tables of SolidStatic compacted at set-up (valid slots first, in
// slot order, slot-major so that the threads of a warp read neighbouring
// addresses) and each row's count.  The sums are per-thread and in slot
// order, with no atomics, so two launches on the same input are bit-equal.
// No TF32 and no lower precision: every product is a scalar FMA or multiply
// in the state's type.
//
// What bounds it: latency, not bytes.  The compacted tables and the state of
// the 8,000-row Turek flag are ~2.4 MB, under a microsecond at 3.35 TB/s, and
// stay in the 50 MB L2 across substeps; a launch costs its few microseconds
// of launch latency and the dependent neighbour loads of its longest row.
// Launch B may write the state in place (pos_out == pos_in): row i reads
// its own pos and vel before it writes them, and reads no other row's.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float floor(float a) { return floorf(a); }
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ double floor(double a) { return ::floor(a); }
};

template <typename T>
struct SolidArgs {
  const T* pos_in;   // [S, 3]
  const T* vel_in;   // [S, 3]
  T* pos_out;        // [S, 3], may be pos_in
  T* vel_out;        // [S, 3], may be vel_in
  T* p;              // [sd * sd, S] first Piola-Kirchhoff stress
  const T* pos0;     // [S, 3] initial positions
  const T* width;    // [3] domain width
  const int* nbr;    // [kc, S] subset index of each valid neighbour
  const T* xij;      // [kc, sd, S] initial separations
  const T* w;        // [kc, S] weights
  const int* count;  // [S] valid neighbours a row
  const T* nrm;      // [S, sd, sd] A^-1
  const T* inv_rho;  // [S]
  const T* lam;      // [S]
  const T* mu;       // [S]
  const bool* clamp;  // [S]
  const bool* valid;  // [S]
  int s;
  T kick_dt;  // dtE
  T move_dt;  // dtE, or 2 dtE under quirk Q1
};

// (dx + W/2) - W floor((dx + W/2) / W) - W/2, each operation rounded
template <typename T>
__device__ __forceinline__ T min_image(T dx, T w, T half) {
  const T y = Rn<T>::add(dx, half);
  const T q = Rn<T>::floor(Rn<T>::div(y, w));
  return Rn<T>::add(Rn<T>::add(y, -Rn<T>::mul(w, q)), -half);
}

template <typename T, int SD>
__device__ __forceinline__ void displacement(const SolidArgs<T>& a, int r,
                                             const T (&w)[SD],
                                             const T (&half)[SD], T (&u)[SD]) {
#pragma unroll
  for (int d = 0; d < SD; ++d)
    u[d] = min_image(Rn<T>::add(a.pos_in[3 * r + d], -a.pos0[3 * r + d]),
                     w[d], half[d]);
}

template <typename T, int SD>
__global__ void __launch_bounds__(kThreads)
    solid_stress_kernel(const SolidArgs<T> a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.s) return;
  T w[SD], half[SD];
#pragma unroll
  for (int d = 0; d < SD; ++d) {
    w[d] = a.width[d];
    half[d] = T(0.5) * w[d];
  }
  T ui[SD];
  displacement<T, SD>(a, i, w, half, ui);

  T fr[SD][SD];
#pragma unroll
  for (int r = 0; r < SD; ++r)
#pragma unroll
    for (int c = 0; c < SD; ++c) fr[r][c] = T(0);
  const int n = a.count[i];
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const int slot = k * a.s + i;
    const int j = a.nbr[slot];
    const T wk = a.w[slot];
    T x0[SD], uj[SD];
#pragma unroll
    for (int d = 0; d < SD; ++d) x0[d] = a.xij[(k * SD + d) * a.s + i];
    displacement<T, SD>(a, j, w, half, uj);
#pragma unroll
    for (int r = 0; r < SD; ++r) {
      const T wx = wk * (x0[r] + (uj[r] - ui[r]));
#pragma unroll
      for (int c = 0; c < SD; ++c) fr[r][c] += wx * x0[c];
    }
  }

  T nm[SD][SD];
#pragma unroll
  for (int r = 0; r < SD; ++r)
#pragma unroll
    for (int c = 0; c < SD; ++c) nm[r][c] = a.nrm[(i * SD + r) * SD + c];
  T f[SD][SD];  // F = F_raw A^-1
#pragma unroll
  for (int r = 0; r < SD; ++r)
#pragma unroll
    for (int c = 0; c < SD; ++c) {
      T acc = T(0);
#pragma unroll
      for (int m = 0; m < SD; ++m) acc += fr[r][m] * nm[m][c];
      f[r][c] = acc;
    }
  T e[SD][SD];  // E = (F^T F - I) / 2
  T tr = T(0);
#pragma unroll
  for (int r = 0; r < SD; ++r)
#pragma unroll
    for (int c = 0; c < SD; ++c) {
      T acc = T(0);
#pragma unroll
      for (int m = 0; m < SD; ++m) acc += f[m][r] * f[m][c];
      e[r][c] = T(0.5) * (acc - (r == c ? T(1) : T(0)));
    }
#pragma unroll
  for (int d = 0; d < SD; ++d) tr += e[d][d];
  const T two_mu = T(2) * a.mu[i];
  const T lam_tr = a.lam[i] * tr;
  T st[SD][SD];  // S = 2 mu E + lambda tr(E) I
#pragma unroll
  for (int r = 0; r < SD; ++r)
#pragma unroll
    for (int c = 0; c < SD; ++c)
      st[r][c] = two_mu * e[r][c] + (r == c ? lam_tr : T(0));
  T fs[SD][SD];  // F S
#pragma unroll
  for (int r = 0; r < SD; ++r)
#pragma unroll
    for (int c = 0; c < SD; ++c) {
      T acc = T(0);
#pragma unroll
      for (int m = 0; m < SD; ++m) acc += f[r][m] * st[m][c];
      fs[r][c] = acc;
    }
#pragma unroll
  for (int r = 0; r < SD; ++r)
#pragma unroll
    for (int c = 0; c < SD; ++c) {
      T acc = T(0);  // P = F S A^-1
#pragma unroll
      for (int m = 0; m < SD; ++m) acc += fs[r][m] * nm[m][c];
      a.p[(r * SD + c) * a.s + i] = acc;
    }
}

template <typename T, int SD>
__global__ void __launch_bounds__(kThreads)
    solid_kick_kernel(const SolidArgs<T> a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.s) return;
  T pi[SD * SD];
#pragma unroll
  for (int q = 0; q < SD * SD; ++q) pi[q] = a.p[q * a.s + i];
  T kick[SD];
#pragma unroll
  for (int d = 0; d < SD; ++d) kick[d] = T(0);
  const int n = a.count[i];
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const int slot = k * a.s + i;
    const int j = a.nbr[slot];
    const T wk = a.w[slot];
    T x0[SD];
#pragma unroll
    for (int d = 0; d < SD; ++d) x0[d] = a.xij[(k * SD + d) * a.s + i];
#pragma unroll
    for (int r = 0; r < SD; ++r) {
      T acc = T(0);
#pragma unroll
      for (int c = 0; c < SD; ++c)
        acc += (a.p[(r * SD + c) * a.s + j] + pi[r * SD + c]) * x0[c];
      kick[r] += wk * acc;
    }
  }
  const T scale = a.kick_dt * a.inv_rho[i];
  const bool ok = a.valid[i];
  T v[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    v[d] = a.vel_in[3 * i + d];
    if (d < SD) v[d] = v[d] + (ok ? scale * kick[d] : T(0));
  }
  if (a.clamp[i]) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      a.vel_out[3 * i + d] = T(0);
      a.pos_out[3 * i + d] = a.pos0[3 * i + d];
    }
  } else {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      a.pos_out[3 * i + d] = a.pos_in[3 * i + d] + a.move_dt * v[d];
      a.vel_out[3 * i + d] = v[d];
    }
  }
}

template <typename T, int SD>
int launch(const SolidArgs<T>& a, cudaStream_t stream) {
  const int blocks = (a.s + kThreads - 1) / kThreads;
  solid_stress_kernel<T, SD><<<blocks, kThreads, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  solid_kick_kernel<T, SD><<<blocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int sd, const void* pos_in, const void* vel_in, void* pos_out,
             void* vel_out, void* p, const void* pos0,
             const void* width, const void* nbr, const void* xij,
             const void* w, const void* count, const void* nrm,
             const void* inv_rho, const void* lam, const void* mu,
             const void* clamp, const void* valid, int s, double kick_dt,
             double move_dt, cudaStream_t stream) {
  SolidArgs<T> a;
  a.pos_in = static_cast<const T*>(pos_in);
  a.vel_in = static_cast<const T*>(vel_in);
  a.pos_out = static_cast<T*>(pos_out);
  a.vel_out = static_cast<T*>(vel_out);
  a.p = static_cast<T*>(p);
  a.pos0 = static_cast<const T*>(pos0);
  a.width = static_cast<const T*>(width);
  a.nbr = static_cast<const int*>(nbr);
  a.xij = static_cast<const T*>(xij);
  a.w = static_cast<const T*>(w);
  a.count = static_cast<const int*>(count);
  a.nrm = static_cast<const T*>(nrm);
  a.inv_rho = static_cast<const T*>(inv_rho);
  a.lam = static_cast<const T*>(lam);
  a.mu = static_cast<const T*>(mu);
  a.clamp = static_cast<const bool*>(clamp);
  a.valid = static_cast<const bool*>(valid);
  a.s = s;
  a.kick_dt = static_cast<T>(kick_dt);
  a.move_dt = static_cast<T>(move_dt);
  return sd == 2 ? launch<T, 2>(a, stream) : launch<T, 3>(a, stream);
}

}  // namespace

// One substep: launch A then launch B on `stream`.  `kc` is the compacted
// tables' slot count (each row's count is at most kc).
// Returns -1 for arguments outside what the kernels take, else
// cudaGetLastError() after the launches.
extern "C" int fsi_solid_substep(
    int is_double, int sd, const void* pos_in, const void* vel_in,
    void* pos_out, void* vel_out, void* p, const void* pos0,
    const void* width, const void* nbr, const void* xij, const void* w,
    const void* count, const void* nrm, const void* inv_rho, const void* lam,
    const void* mu, const void* clamp, const void* valid, int s, int kc,
    double kick_dt, double move_dt, void* stream) {
  if ((sd != 2 && sd != 3) || s <= 0 || kc <= 0 ||
      static_cast<long long>(kc) * sd * s >= (1LL << 31))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return dispatch<double>(sd, pos_in, vel_in, pos_out, vel_out, p, pos0,
                            width, nbr, xij, w, count, nrm, inv_rho,
                            lam, mu, clamp, valid, s, kick_dt, move_dt, st);
  return dispatch<float>(sd, pos_in, vel_in, pos_out, vel_out, p, pos0,
                         width, nbr, xij, w, count, nrm, inv_rho, lam,
                         mu, clamp, valid, s, kick_dt, move_dt, st);
}

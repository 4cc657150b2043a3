// Virial window sweep: per receiver, the pairwise force families re-derived
// with the RECEIVER's pressure only (P_i, not P_i + P_j), viscosity
// half-weighted, accumulated as sum_j f_a * xij_b into nine components
// (calculateVirialStressAtParticle, src/main.cpp:3077-3318).  Runs once per
// .vtk dump (output-time diagnostics), not in the time step.
//
// One template, two TPU kernels, two C entry points:
// * fsi_virial_sweep (ROWS = false) replaces
//   particlemethod_fsi_tpu/ops/pallas_windows_t.py `_virial_kernel_t`
//   (reached through `virial_pallas_t` -> `_sweep_t`; kernel 3): key ring,
//   mu_h = 2 / (1/mu_i + 1/mu_j) where that inverse sum is finite and
//   positive, else 0;
// * fsi_virial_rows (ROWS = true) replaces
//   particlemethod_fsi_tpu/ops/pallas_pairwise.py `_virial_kernel` (reached
//   through `virial_pallas`; kernel 6): the ring from positions, pad senders
//   and j == i rejected, pairs within the support only (see
//   window_sweep.cuh), and mu_h = 2 mu_i mu_j / (mu_i + mu_j) from mu itself
//   (0 where that sum is not positive); the key finds the ring runs only.
// Every branch of both is here: planar or not, surface tension or not and
// the pair rule as template parameters; per-pair interaction ratios and
// non-uniform radii as launch parameters (uniform branches).  Unlike phase
// 2 there is no
// structure rule: a structure receiver takes every family from every sender.
// The output is the raw sums, [9, N] row-major components (3a + b) in sorted
// order; the division by the particle volume and the trace pressure stay in
// the caller.  A planar instance keeps four accumulators (rows 0, 1, 3, 4)
// and writes zeros to the other five.
//
// Bound on an H100: at the flags of the planar scene without surface tension
// the function needs 44 bytes a particle in float32 (x, y, vx, vy, pressure
// P, 1/mu and the key read once, four components written), some thirteen
// microseconds at 1M particles; the pair math of the true neighbour pairs
// needs less time than that at the float32 rate, so by the roofline the
// kernel is bound by bytes.  As written it moves more (pos and vel are
// [N,3] rows, nine rows written).
//
// What held the first design back: each receiver tested every sender of its
// block's windows (275 at the 1M bench scene, for 20 neighbours), staged in
// tiles of 128 and read one sender a step for the whole block: the
// candidate loop, not memory, set the time (0.519 ms for kernel 3 and 0.573
// for kernel 6 on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md).
//
// This design is phase 2's (phase2_sweep.cu), through the ring-run walk of
// window_sweep.cuh: the frame is sorted by key, so the senders in a
// receiver's ring for one offset are one run of rows.  A block stages the
// windows of all its offsets together, in chunks (FsiChunk), by cp.async,
// one array a field, only what the virial reads of a sender: x, y, vx, vy
// (z, vz in 3-D), mu or 1/mu, and the key -- under the row rule also the
// linear cell of each sender computed from its staged position (INT_MIN for
// a pad, in no ring), as kernels 4 and 5 stage it; the type for the row
// rule's pad test and the interaction ratios.
// The receiver's pressures, gravity centre and surface-tension coefficient
// stay in registers.  Each receiver finds its run in each window's part of
// the chunk by two binary searches and walks only that run, in batches of
// 32: a branch-free pre-test -- phase 2's, the first design's exact mask:
// the ring, rij2 > 0 and the strict rij2 < reach2, and for the row rule
// j != i and rij2 <= support2 -- sets one bit a sender, and the body runs
// over the set bits in ascending order.  Each receiver sums the same terms
// as the first design in the same order (offsets in order, rows ascending,
// a run that two chunks split walked piece by piece), so the float results
// are the first design's bit for bit.  Measured at the 1M bench scene on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md): kernel 3 0.182 ms warm (0.522
// before), kernel 6 0.213 (0.575), the same 86 of 275 senders pre-tested a
// receiver as phases 1 and 2.
#include "window_sweep.cuh"

// the constant table of phase 2 (the two kernels share `_phase2_consts`)
enum {
  VR_RADIUS_P2 = 0, VR_RADIUS_A2, VR_RADIUS_V2, VR_RADIUS_G2,
  VR_INV_RADIUS_P, VR_INV_RADIUS_A, VR_INV_RADIUS_V, VR_INV_RADIUS_G,
  VR_DWP_COEF, VR_NORM_A, VR_RADIUS_A, VR_DWV_COEF, VR_NORM_G, VR_DWG_COEF,
  VR_C_V, VR_VOLUME, VR_SCALE_DI, VR_COF_K2, VR_NCONST
};

template <typename T>
struct VirialParams {
  const T* pos;         // [N,3]
  const T* vel;         // [N,3]
  const int* key;       // [N] sorted: the ring runs (both rules) and the
                        // field-major rule's ring test
  const int* prop;      // [N]
  const T* pp;          // [N] pressure P (receiver side only)
  const T* pa;          // [N] pressure A (receiver side, surface tension only)
  const T* gc;          // [N,3] gravity centre (receiver side, surface tension)
  const T* visc;        // [N] 1/mu, inf where mu == 0 (field-major rule);
                        // mu itself (row-major rule)
  const int* win_start; // [nblocks, n_off]
  const int* win_len;   // [nblocks, n_off]
  T* out;               // [9, N]
  int n;
  int n_off;
  int offs[FSI_MAX_OFFS];
  T c[VR_NCONST];
  T ratio[FSI_TYPE_COUNT * FSI_TYPE_COUNT];
  T cof_a[FSI_TYPE_COUNT];
  int uniform_ratio;
  int uniform_radii;
  T support2;           // row-major rule only
  FsiRows<T> g;         // row-major rule only
};

#ifdef FSI_WALK_COUNT
// the checking build's counts of this kernel (see FsiWalkCount), read and
// cleared by fsi_virial_counts
__device__ unsigned long long fsi_vr_counts[3];
#endif

template <typename T, bool PLANAR, bool ST, bool ROWS>
__global__ void virial_sweep_kernel(const VirialParams<T> p) {
  constexpr int CAP = FsiChunk<T>::value;
  constexpr int CAP_Z = PLANAR ? 1 : CAP;
  // the chunk, one array a field (lanes read different senders)
  __shared__ T s_x[CAP], s_y[CAP], s_z[CAP_Z];
  __shared__ T s_vx[CAP], s_vy[CAP], s_vz[CAP_Z];
  __shared__ T s_visc[CAP];
  __shared__ int s_key[CAP];  // sorted within each window: the run searches
  __shared__ int s_lin[ROWS ? CAP : 1];  // row rule: the linear cell
  __shared__ int s_prop[(ST || ROWS) ? CAP : 1];
  __shared__ T s_ratio[FSI_TYPE_COUNT * FSI_TYPE_COUNT];
  // where each offset's window starts in the concatenation of all windows
  __shared__ int s_cum[FSI_MAX_OFFS + 1];

  const int b = blockIdx.x;
  const int i = b * blockDim.x + threadIdx.x;  // n is a multiple of blockDim.x
  const bool with_ratio = ST && !p.uniform_ratio;
  if (with_ratio) {
    for (int t = threadIdx.x; t < FSI_TYPE_COUNT * FSI_TYPE_COUNT; t += blockDim.x)
      s_ratio[t] = p.ratio[t];
  }
  const int* win_start = p.win_start + b * p.n_off;  // this block's windows
  fsi_window_cum(s_cum, p.win_len + b * p.n_off, p.n_off);

  const T xi = p.pos[3 * i], yi = p.pos[3 * i + 1], zi = p.pos[3 * i + 2];
  const T vxi = p.vel[3 * i], vyi = p.vel[3 * i + 1], vzi = p.vel[3 * i + 2];
  const int key_i = p.key[i];
  const int type_i = fsi_clip_type(p.prop[i]);
  const T pp_i = p.pp[i];
  const T visc_i = p.visc[i];
  int cxi = 0, cyi = 0, czi = 0;
  if (ROWS) {
    cxi = fsi_cell(xi, p.g.dmin[0], p.g.cw[0], p.g.ncell[0]);
    cyi = fsi_cell(yi, p.g.dmin[1], p.g.cw[1], p.g.ncell[1]);
    if (p.g.three_d) czi = fsi_cell(zi, p.g.dmin[2], p.g.cw[2], p.g.ncell[2]);
  }
  T pa_i = 0, gcx_i = 0, gcy_i = 0, gcz_i = 0, a_i = 0;
  if (ST) {
    pa_i = p.pa[i];
    gcx_i = p.gc[3 * i];
    gcy_i = p.gc[3 * i + 1];
    gcz_i = p.gc[3 * i + 2];
    a_i = p.cof_a[type_i] * p.c[VR_COF_K2];
  }

  T reach2 = p.c[VR_RADIUS_P2];
  if (!p.uniform_radii) {
    reach2 = max(reach2, p.c[VR_RADIUS_V2]);
    if (ST) reach2 = max(reach2, max(p.c[VR_RADIUS_A2], p.c[VR_RADIUS_G2]));
  }
  const T volume = p.c[VR_VOLUME];
  const T scale_di = p.c[VR_SCALE_DI];

  __syncthreads();  // s_cum, s_ratio
  const int total = s_cum[p.n_off];

  // s<a><b> = sum_j f_a * xij_b
  T sxx = 0, sxy = 0, syx = 0, syy = 0;
  T sxz = 0, syz = 0, szx = 0, szy = 0, szz = 0;
#ifdef FSI_WALK_COUNT
  FsiWalkCount walk;
#endif

  // The windows of all offsets, concatenated in offset order, in chunks of
  // CAP senders: a chunk is staged with cp.async, then each receiver finds
  // and walks its own ring run within it.
  for (int v0 = 0; v0 < total; v0 += CAP) {
    const int v1 = min(total, v0 + CAP);
    __syncthreads();  // the previous chunk is consumed
    fsi_chunk_rows(s_cum, win_start, p.n_off, v0, v1, [&](int s, int row) {
      const size_t r = static_cast<size_t>(row);
      fsi_async_copy(s_x + s, p.pos + 3 * r);
      fsi_async_copy(s_y + s, p.pos + 3 * r + 1);
      fsi_async_copy(s_vx + s, p.vel + 3 * r);
      fsi_async_copy(s_vy + s, p.vel + 3 * r + 1);
      if (!PLANAR) {
        fsi_async_copy(s_z + s, p.pos + 3 * r + 2);
        fsi_async_copy(s_vz + s, p.vel + 3 * r + 2);
      }
      fsi_async_copy(s_visc + s, p.visc + r);
      fsi_async_copy(s_key + s, p.key + r);
      if (ROWS || with_ratio) fsi_async_copy(s_prop + s, p.prop + r);
    });
    fsi_async_wait();
    if (ROWS)
      fsi_chunk_lin<T, PLANAR>(s_lin, s_x, s_y, s_z, s_prop, p.pos, s_cum,
                               win_start, p.n_off, v0, v1, p.g);
    __syncthreads();

    for (int o = 0; o < p.n_off; ++o) {
      const int a = max(s_cum[o], v0), e = min(s_cum[o + 1], v1);
      if (a >= e) continue;
      // frame row of chunk index 0
      const int row0 = v0 + win_start[o] - s_cum[o];
      // This receiver's ring run within the chunk's part of the window,
      // [j0, j1): the keys of its ring are one interval [vlo, vhi] (key
      // rule: key_i + off +- 1; row rule: the linear cells of fsi_ring),
      // and the window is sorted by key, so two lower bounds find it.  The
      // row rule's search is exact on a frame sorted from these positions,
      // where every valid sender's linear cell is its key: the diagnostics
      // always build such a frame (Simulation._diagnostics, on both
      // backends).
      const int ring_centre = key_i + p.offs[o];
      const FsiRing ring = ROWS ? fsi_ring(cxi, cyi, czi, o, p.g) : FsiRing{};
      const int vlo = ROWS ? ring.lo : ring_centre - 1;
      const int vhi = ROWS ? ring.lo + static_cast<int>(ring.span)
                           : ring_centre + 1;
      const int j0 = fsi_lower_bound(s_key, a - v0, e - v0, vlo);
      const int j1 = fsi_lower_bound(s_key, j0, e - v0, vhi + 1);
      // pre-test, branch-free: phase 2's, the exact mask of a walk of the
      // whole window (the run only leaves out senders it rejects); every
      // family mask is the strict radius^2 - rij2 > 0
      auto test = [&](int j) {
        const T dx = s_x[j] - xi;
        const T dy = s_y[j] - yi;
        T rij2 = dx * dx + dy * dy;
        if (!PLANAR) {
          const T dz = s_z[j] - zi;
          rij2 += dz * dz;
        }
        bool ok = (rij2 > T(0)) & (rij2 < reach2);
        if (ROWS)
          ok = ok & fsi_in_ring(s_lin[j], ring) & (row0 + j != i) &
               !(rij2 > p.support2);
        else  // the key within one of the ring's centre
          ok = ok & (static_cast<unsigned>(s_key[j] - ring_centre + 1) <= 2u);
        return ok;
      };
      // the virial terms of one sender that passed
      auto body = [&](int j) {
        const T dx = s_x[j] - xi;
        const T dy = s_y[j] - yi;
        T rij2 = dx * dx + dy * dy;
        T dz = 0;
        if (!PLANAR) {
          dz = s_z[j] - zi;
          rij2 += dz * dz;
        }
        const T inv_r = fsi_rsqrt(rij2);
        const T rij = rij2 * inv_r;
        const T ex = dx * inv_r, ey = dy * inv_r;
        const T ez = PLANAR ? T(0) : dz * inv_r;

        T ratio_ij = 1;
        if (with_ratio) ratio_ij = fsi_ratio(s_ratio, type_i, s_prop[j]);

        // pressureP family: the receiver's pressure only
        const bool m_p = p.c[VR_RADIUS_P2] - rij2 > T(0);
        const T q_p = rij * p.c[VR_INV_RADIUS_P];
        const T omq_p = T(1) - q_p;
        T coeff = 0;
        if (m_p) coeff = pp_i * (p.c[VR_DWP_COEF] * omq_p) * volume;

        // pressureA family; exactly zero without surface tension
        if (ST) {
          bool m_a = m_p;
          T q_a = q_p, omq_a = omq_p;
          if (!p.uniform_radii) {
            m_a = p.c[VR_RADIUS_A2] - rij2 > T(0);
            q_a = rij * p.c[VR_INV_RADIUS_A];
            omq_a = T(1) - q_a;
          }
          if (m_a) {
            const T dwa = p.c[VR_NORM_A] * omq_a * (T(1) - T(3) * q_a) /
                          p.c[VR_RADIUS_A];
            coeff += pa_i * ratio_ij * dwa * volume;
          }
        }

        // viscosity, half-weighted; field-major, mu_h = 0 unless
        // 1/mu_i + 1/mu_j is finite and positive; row-major, unless
        // mu_i + mu_j > 0
        {
          bool m_v = m_p;
          T omq_v = omq_p;
          if (!p.uniform_radii) {
            m_v = p.c[VR_RADIUS_V2] - rij2 > T(0);
            omq_v = T(1) - rij * p.c[VR_INV_RADIUS_V];
          }
          if (m_v) {
            T udote = (s_vx[j] - vxi) * ex + (s_vy[j] - vyi) * ey;
            if (!PLANAR) udote += (s_vz[j] - vzi) * ez;
            T mu_h;
            if (ROWS) {
              const T den = visc_i + s_visc[j];
              mu_h = den > T(0) ? T(2) * visc_i * s_visc[j] / den : T(0);
            } else {
              const T inv_sum = visc_i + s_visc[j];
              mu_h = (isfinite(inv_sum) && inv_sum > T(0)) ? T(2) / inv_sum
                                                          : T(0);
            }
            const T dwv = p.c[VR_DWV_COEF] * omq_v;
            const T visc = p.c[VR_C_V] * mu_h * udote * (-dwv) * inv_r * volume;
            coeff += T(0.5) * visc;
          }
        }

        // diffuse interface; zero without surface tension
        T w_g1 = 0;
        if (ST) {
          bool m_g = m_p;
          T omq_g = omq_p;
          if (!p.uniform_radii) {
            m_g = p.c[VR_RADIUS_G2] - rij2 > T(0);
            omq_g = T(1) - rij * p.c[VR_INV_RADIUS_G];
          }
          if (m_g) {
            const T wgv = p.c[VR_NORM_G] * (omq_g * omq_g);
            const T dwg = p.c[VR_DWG_COEF] * omq_g;
            T gr = -(gcx_i * dx + gcy_i * dy);
            if (!PLANAR) gr -= gcz_i * dz;
            coeff += -a_i * gr * ratio_ij * dwg * scale_di;
            w_g1 = a_i * ratio_ij * wgv * scale_di;
          }
        }

        T fx = coeff * ex, fy = coeff * ey;
        if (ST) {
          fx += w_g1 * gcx_i;
          fy += w_g1 * gcy_i;
        }
        sxx += fx * dx;
        sxy += fx * dy;
        syx += fy * dx;
        syy += fy * dy;
        if (!PLANAR) {
          T fz = coeff * ez;
          if (ST) fz += w_g1 * gcz_i;
          sxz += fx * dz;
          syz += fy * dz;
          szx += fz * dx;
          szy += fz * dy;
          szz += fz * dz;
        }
      };
#ifdef FSI_WALK_COUNT
      walk.run(j0, j1);
      walk.passed += fsi_walk_run(j0, j1, test, body);
#else
      fsi_walk_run(j0, j1, test, body);
#endif
    }
  }

#ifdef FSI_WALK_COUNT
  walk.add_to(fsi_vr_counts);
#endif
  const size_t n = p.n;
  p.out[i] = sxx;
  p.out[n + i] = sxy;
  p.out[2 * n + i] = sxz;
  p.out[3 * n + i] = syx;
  p.out[4 * n + i] = syy;
  p.out[5 * n + i] = syz;
  p.out[6 * n + i] = szx;
  p.out[7 * n + i] = szy;
  p.out[8 * n + i] = szz;
}

template <typename T, bool ROWS>
static void dispatch_virial(const VirialParams<T>& p, int block, int planar,
                            int surface_tension, cudaStream_t stream) {
  const dim3 grid(p.n / block), threads(block);
  if (planar) {
    if (surface_tension)
      virial_sweep_kernel<T, true, true, ROWS><<<grid, threads, 0, stream>>>(p);
    else
      virial_sweep_kernel<T, true, false, ROWS><<<grid, threads, 0, stream>>>(p);
  } else {
    if (surface_tension)
      virial_sweep_kernel<T, false, true, ROWS><<<grid, threads, 0, stream>>>(p);
    else
      virial_sweep_kernel<T, false, false, ROWS><<<grid, threads, 0, stream>>>(p);
  }
}

// offs_yz == nullptr selects the field-major rule (keys, offs); otherwise
// the row-major rule (offs_yz, geom = dmin[3] + cw[3], ncell[3], support2).
template <typename T>
static int launch_virial(const void* pos, const void* vel, const void* key,
                         const void* prop, const void* pp, const void* pa,
                         const void* gc, const void* visc,
                         const void* win_start, const void* win_len, void* out,
                         int n, int block, int n_off, const int* offs,
                         const int* offs_yz, const double* geom,
                         const int* ncell, double support2,
                         const double* consts, const double* ratio,
                         const double* cof_a, int planar, int surface_tension,
                         int uniform_ratio, int uniform_radii,
                         cudaStream_t stream) {
  VirialParams<T> p;
  p.pos = static_cast<const T*>(pos);
  p.vel = static_cast<const T*>(vel);
  p.key = static_cast<const int*>(key);
  p.prop = static_cast<const int*>(prop);
  p.pp = static_cast<const T*>(pp);
  p.pa = static_cast<const T*>(pa);
  p.gc = static_cast<const T*>(gc);
  p.visc = static_cast<const T*>(visc);
  p.win_start = static_cast<const int*>(win_start);
  p.win_len = static_cast<const int*>(win_len);
  p.out = static_cast<T*>(out);
  p.n = n;
  p.n_off = n_off;
  for (int o = 0; o < n_off; ++o) p.offs[o] = offs ? offs[o] : 0;
  for (int k = 0; k < VR_NCONST; ++k) p.c[k] = static_cast<T>(consts[k]);
  for (int k = 0; k < FSI_TYPE_COUNT * FSI_TYPE_COUNT; ++k)
    p.ratio[k] = static_cast<T>(ratio[k]);
  for (int k = 0; k < FSI_TYPE_COUNT; ++k) p.cof_a[k] = static_cast<T>(cof_a[k]);
  p.uniform_ratio = uniform_ratio;
  p.uniform_radii = uniform_radii;
  p.support2 = static_cast<T>(support2);
  if (offs_yz) {
    fsi_rows_fill(&p.g, n_off, offs_yz, geom, ncell);
    dispatch_virial<T, true>(p, block, planar, surface_tension, stream);
  } else {
    dispatch_virial<T, false>(p, block, planar, surface_tension, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

static bool virial_args_ok(int n, int block, int n_off, int surface_tension,
                           const void* pa, const void* gc) {
#ifdef FSI_WALK_COUNT
  if (block % 32 != 0) return false;  // the counts reduce over whole warps
#endif
  return block > 0 && block <= 1024 && n % block == 0 && n_off > 0 &&
         n_off <= FSI_MAX_OFFS &&
         !(surface_tension && (pa == nullptr || gc == nullptr));
}

// Plain C entry point of kernel 3, with the argument list of
// fsi_phase2_sweep.  is_double selects the instance; all pointers are device
// pointers except offs, consts (VR_NCONST doubles), ratio (36 doubles) and
// cof_a (6 doubles), which are host arrays.  pa and gc may be null without
// surface tension.  Returns cudaGetLastError() of the launch (0 = success),
// or -1 for arguments the kernel does not take.
extern "C" int fsi_virial_sweep(int is_double, const void* pos,
                                const void* vel, const void* key,
                                const void* prop, const void* pp,
                                const void* pa, const void* gc,
                                const void* invmu, const void* win_start,
                                const void* win_len, void* out, int n,
                                int block, int n_off, const int* offs,
                                const double* consts, const double* ratio,
                                const double* cof_a, int planar,
                                int surface_tension, int uniform_ratio,
                                int uniform_radii, void* stream) {
  if (!virial_args_ok(n, block, n_off, surface_tension, pa, gc)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch_virial<double>(pos, vel, key, prop, pp, pa, gc, invmu,
                                 win_start, win_len, out, n, block, n_off,
                                 offs, nullptr, nullptr, nullptr, 0.0, consts,
                                 ratio, cof_a, planar, surface_tension,
                                 uniform_ratio, uniform_radii, s);
  return launch_virial<float>(pos, vel, key, prop, pp, pa, gc, invmu,
                              win_start, win_len, out, n, block, n_off, offs,
                              nullptr, nullptr, nullptr, 0.0, consts, ratio,
                              cof_a, planar, surface_tension, uniform_ratio,
                              uniform_radii, s);
}

// Plain C entry point of kernel 6 (row-major rule), with the argument list
// of fsi_phase2_rows.
extern "C" int fsi_virial_rows(int is_double, const void* pos, const void* vel,
                               const void* key, const void* prop,
                               const void* pp,
                               const void* pa, const void* gc, const void* mu,
                               const void* win_start, const void* win_len,
                               void* out, int n, int block, int n_off,
                               const int* offs_yz, const double* geom,
                               const int* ncell, const double* consts,
                               const double* ratio, const double* cof_a,
                               double support2, int planar,
                               int surface_tension, int uniform_ratio,
                               int uniform_radii, void* stream) {
  if (!virial_args_ok(n, block, n_off, surface_tension, pa, gc)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch_virial<double>(pos, vel, key, prop, pp, pa, gc, mu,
                                 win_start, win_len, out, n, block, n_off,
                                 nullptr, offs_yz, geom, ncell, support2,
                                 consts, ratio, cof_a, planar,
                                 surface_tension, uniform_ratio,
                                 uniform_radii, s);
  return launch_virial<float>(pos, vel, key, prop, pp, pa, gc, mu,
                              win_start, win_len, out, n, block, n_off,
                              nullptr, offs_yz, geom, ncell, support2, consts,
                              ratio, cof_a, planar, surface_tension,
                              uniform_ratio, uniform_radii, s);
}

extern "C" int fsi_virial_nconst() { return VR_NCONST; }

// Resident blocks per SM of one virial instance at `block` threads (the
// occupancy the launch reaches; registers and shared memory decide it), or
// -1 where the query fails.
template <typename T, bool ROWS>
static int virial_occupancy(int planar, int surface_tension, int block) {
  int blocks = -1;
  cudaError_t err;
  if (planar) {
    err = surface_tension
              ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, virial_sweep_kernel<T, true, true, ROWS>, block, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, virial_sweep_kernel<T, true, false, ROWS>, block, 0);
  } else {
    err = surface_tension
              ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, virial_sweep_kernel<T, false, true, ROWS>, block, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, virial_sweep_kernel<T, false, false, ROWS>, block, 0);
  }
  return err == cudaSuccess ? blocks : -1;
}

extern "C" int fsi_virial_occupancy(int is_double, int rows, int planar,
                                    int surface_tension, int block) {
  if (is_double)
    return rows ? virial_occupancy<double, true>(planar, surface_tension, block)
                : virial_occupancy<double, false>(planar, surface_tension, block);
  return rows ? virial_occupancy<float, true>(planar, surface_tension, block)
              : virial_occupancy<float, false>(planar, surface_tension, block);
}

#ifdef FSI_WALK_COUNT
// The checking build's counts of kernels 3 and 6 (see FsiWalkCount) of the
// launches since the last call, into out[3]; then clears them.  Returns a
// cudaError_t (0 = success).
extern "C" int fsi_virial_counts(unsigned long long* out) {
  return fsi_read_counts(fsi_vr_counts, out);
}
#endif

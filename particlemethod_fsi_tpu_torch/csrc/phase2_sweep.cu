// Phase-2 window sweep: the pairwise force on each receiver -- pressure-P
// (P_i + P_j) dwp with the FSI interface rule (structure receivers skip
// structure senders), pressure-A, viscosity with a harmonic-mean mu_h, and
// the diffuse-interface term.
//
// One template, two TPU kernels, two C entry points:
// * fsi_phase2_sweep (ROWS = false) replaces
//   particlemethod_fsi_tpu/ops/pallas_windows_t.py `_phase2_kernel` (reached
//   through `phase2_forces_pallas_t` -> `_sweep_t`; kernel 2): key ring,
//   mu_h = 2 / (1/mu_i + 1/mu_j) from an inverse-viscosity field;
// * fsi_phase2_rows (ROWS = true) replaces
//   particlemethod_fsi_tpu/ops/pallas_pairwise.py `_phase2_kernel` (reached
//   through `phase2_forces_pallas`; kernel 5): the ring from positions, pad
//   senders and j == i rejected, pairs within the support only (see
//   window_sweep.cuh), and mu_h = 2 mu_i mu_j / (mu_i + mu_j) from mu itself
//   (0 where that sum is not positive).
// Every branch of both is here: planar or not, surface tension or not and
// the pair rule as template parameters; per-pair interaction ratios and
// non-uniform radii as launch parameters (uniform branches).
//
// Bound on an H100: at the flags of the planar scene without surface tension
// the function needs 40 bytes a particle in float32 (x, y, vx, vy, pressure
// P, 1/mu, key and type read once, fx and fy written), some ten microseconds
// at 1M particles; the pair math of the true neighbour pairs needs less time
// than that at the float32 rate, so by the roofline the kernel is bound by
// bytes (kernel 5, whose ring costs two cell coordinates a particle, just
// by operations).  As written it moves 52: pos and vel are [N,3] rows and
// the zero fz row is written.
//
// What held the first design back: every receiver of a 64-row block tested
// every sender of the block's windows (275 at the 1M bench scene) against
// its ring, one sender a step for the whole block, and the warp ran the
// force body in almost every step because some lane passed: the candidate
// loop, not memory, set the time (flushing L2 cost 4-9 %).
//
// This design: the frame is sorted by key, so the senders in a receiver's
// ring for one offset are one run of rows -- key rule, the keys
// key_i + off - 1 .. key_i + off + 1; row rule, the linear cells of fsi_ring,
// which on a frame sorted from these positions are the valid senders' keys
// (the tail's pads, key num_cells, lie in no ring; a 3-D frame's plane pads,
// keyed with their plane's last cell, may lie in a run, and the pre-test's
// ring test on their staged linear cell, INT_MIN, rejects them).  A block
// stages the windows of all its offsets together, in chunks of FsiChunk
// senders, by cp.async, one array a field, the key included; each receiver
// then finds its run within each window's part of the chunk by two binary
// searches on the staged keys and walks only that run (a third of the
// window at the bench scene; the
// checking build -DFSI_WALK_COUNT counts it, PERF.md), in batches of 32: a
// branch-free pre-test (the whole-window walk's exact mask: ring, rij2 > 0,
// the radius, and for the row rule j != i and the support) sets one bit a
// sender, and the force body runs over the set bits in ascending order.  A
// warp's pre-test steps are the longest run of its lanes and its body steps
// the largest count of set bits, not the window.  Each receiver still sums
// its own senders offset by offset in ascending row order with no atomics:
// the same terms as the whole-window walk in the same order.  Windows of
// any length give the masked walk's result exactly (a run is the ring
// within the window, and a run that two chunks split is found in each).
// The staging, the run search and the batched walk are the ring-run walk
// of window_sweep.cuh, which phase 1 shares.
// One block a receiver block of 64: measured on the card,
// more receiver blocks a CUDA block, smaller chunks for more resident
// blocks, and searching the key in device memory were each slower (PERF.md).
#include "window_sweep.cuh"

enum {
  P2_RADIUS_P2 = 0, P2_RADIUS_A2, P2_RADIUS_V2, P2_RADIUS_G2,
  P2_INV_RADIUS_P, P2_INV_RADIUS_A, P2_INV_RADIUS_V, P2_INV_RADIUS_G,
  P2_DWP_COEF, P2_NORM_A, P2_RADIUS_A, P2_DWV_COEF, P2_NORM_G, P2_DWG_COEF,
  P2_C_V, P2_VOLUME, P2_SCALE_DI, P2_COF_K2, P2_NCONST
};

template <typename T>
struct Phase2Params {
  const T* pos;         // [N,3]
  const T* vel;         // [N,3]
  const int* key;       // [N] sorted: the ring runs (both rules) and the
                        // field-major rule's ring test
  const int* prop;      // [N]
  const T* pp;          // [N] pressure P
  const T* pa;          // [N] pressure A (read with surface tension only)
  const T* gc;          // [N,3] gravity centre (surface tension only)
  const T* visc;        // [N] 1/mu, inf where mu == 0 (field-major rule);
                        // mu itself (row-major rule)
  const int* win_start; // [nblocks, n_off]
  const int* win_len;   // [nblocks, n_off]
  T* out;               // [3, N]
  int n;
  int n_off;
  int offs[FSI_MAX_OFFS];
  T c[P2_NCONST];
  T ratio[FSI_TYPE_COUNT * FSI_TYPE_COUNT];
  T cof_a[FSI_TYPE_COUNT];
  int uniform_ratio;
  int uniform_radii;
  T support2;           // row-major rule only
  FsiRows<T> g;         // row-major rule only
};

#ifdef FSI_WALK_COUNT
// the checking build's counts of this kernel (see FsiWalkCount), read and
// cleared by fsi_phase2_counts
__device__ unsigned long long fsi_p2_counts[3];
#endif

template <typename T, bool PLANAR, bool ST, bool ROWS>
__global__ void phase2_sweep_kernel(const Phase2Params<T> p) {
  constexpr int CAP = FsiChunk<T>::value;
  constexpr int CAP_Z = PLANAR ? 1 : CAP;
  constexpr int CAP_ST = ST ? CAP : 1;
  constexpr int CAP_ST_Z = (ST && !PLANAR) ? CAP : 1;
  // the chunk, one array a field (lanes read different senders)
  __shared__ T s_x[CAP], s_y[CAP], s_z[CAP_Z];
  __shared__ T s_vx[CAP], s_vy[CAP], s_vz[CAP_Z];
  __shared__ T s_pp[CAP], s_visc[CAP];
  __shared__ T s_pa[CAP_ST], s_gx[CAP_ST], s_gy[CAP_ST], s_gz[CAP_ST_Z];
  __shared__ int s_prop[CAP];
  __shared__ int s_key[CAP];  // sorted within each window: the run searches
  __shared__ int s_lin[ROWS ? CAP : 1];  // row rule: the linear cell
  __shared__ T s_ratio[FSI_TYPE_COUNT * FSI_TYPE_COUNT];
  // where each offset's window starts in the concatenation of all windows
  __shared__ int s_cum[FSI_MAX_OFFS + 1];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int i = b * blockDim.x + tid;  // n is a multiple of blockDim.x
  const bool with_ratio = ST && !p.uniform_ratio;
  if (with_ratio) {
    for (int t = tid; t < FSI_TYPE_COUNT * FSI_TYPE_COUNT; t += blockDim.x)
      s_ratio[t] = p.ratio[t];
  }
  const int* win_start = p.win_start + b * p.n_off;  // this block's windows
  fsi_window_cum(s_cum, p.win_len + b * p.n_off, p.n_off);

  const T xi = p.pos[3 * i], yi = p.pos[3 * i + 1], zi = p.pos[3 * i + 2];
  const T vxi = p.vel[3 * i], vyi = p.vel[3 * i + 1], vzi = p.vel[3 * i + 2];
  const int key_i = p.key[i];
  const int prop_i = p.prop[i];
  const int type_i = fsi_clip_type(prop_i);
  const bool rs = fsi_is_structure(prop_i);
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
    a_i = p.cof_a[type_i] * p.c[P2_COF_K2];
  }

  T reach2 = p.c[P2_RADIUS_P2];
  if (!p.uniform_radii) {
    reach2 = max(reach2, p.c[P2_RADIUS_V2]);
    if (ST) reach2 = max(reach2, max(p.c[P2_RADIUS_A2], p.c[P2_RADIUS_G2]));
  }
  const T volume = p.c[P2_VOLUME];
  const T scale_di = p.c[P2_SCALE_DI];

  __syncthreads();  // s_cum, s_ratio
  const int total = s_cum[p.n_off];

  T fx = 0, fy = 0, fz = 0;
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
      fsi_async_copy(s_pp + s, p.pp + r);
      fsi_async_copy(s_visc + s, p.visc + r);
      fsi_async_copy(s_prop + s, p.prop + r);
      fsi_async_copy(s_key + s, p.key + r);
      if (ST) {
        fsi_async_copy(s_pa + s, p.pa + r);
        fsi_async_copy(s_gx + s, p.gc + 3 * r);
        fsi_async_copy(s_gy + s, p.gc + 3 * r + 1);
        if (!PLANAR) fsi_async_copy(s_gz + s, p.gc + 3 * r + 2);
      }
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
      // rule: key_i + off +- 1; row rule: the linear cells of fsi_ring,
      // which on a frame sorted from these positions are the valid
      // senders' keys; a pad's key, num_cells, lies in no ring), and the
      // window is sorted by key, so two lower bounds find it.
      const int ring_centre = key_i + p.offs[o];
      const FsiRing ring = ROWS ? fsi_ring(cxi, cyi, czi, o, p.g) : FsiRing{};
      const int vlo = ROWS ? ring.lo : ring_centre - 1;
      const int vhi = ROWS ? ring.lo + static_cast<int>(ring.span)
                           : ring_centre + 1;
      const int j0 = fsi_lower_bound(s_key, a - v0, e - v0, vlo);
      const int j1 = fsi_lower_bound(s_key, j0, e - v0, vhi + 1);
      // pre-test, branch-free: the exact mask of a walk of the whole window
      // (the run only leaves out senders it rejects); every family mask is
      // the strict radius^2 - rij2 > 0
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
      // the force body of one sender that passed
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

        const int prop_j = s_prop[j];
        const bool ss = fsi_is_structure(prop_j);
        T ratio_ij = 1, ratio_ji = 1;
        if (with_ratio) {
          ratio_ij = fsi_ratio(s_ratio, type_i, prop_j);
          ratio_ji = (prop_j >= 0 && prop_j < FSI_TYPE_COUNT)
                         ? s_ratio[prop_j * FSI_TYPE_COUNT + type_i]
                         : T(0);
        }

        // pressureP + FSI interface load: fluid/wall receivers take all
        // senders, structure receivers only non-structure senders
        const bool m_p = p.c[P2_RADIUS_P2] - rij2 > T(0);
        const T q_p = rij * p.c[P2_INV_RADIUS_P];
        const T omq_p = T(1) - q_p;
        T radial = 0;
        if (m_p && !(rs && ss)) {
          const T dwp = p.c[P2_DWP_COEF] * omq_p;
          radial = (pp_i + s_pp[j]) * dwp * volume;
        }

        // pressureA; exactly zero without surface tension
        if (ST) {
          bool m_a = m_p;
          T q_a = q_p, omq_a = omq_p;
          if (!p.uniform_radii) {
            m_a = p.c[P2_RADIUS_A2] - rij2 > T(0);
            q_a = rij * p.c[P2_INV_RADIUS_A];
            omq_a = T(1) - q_a;
          }
          if (m_a && !rs) {
            const T dwa = p.c[P2_NORM_A] * omq_a * (T(1) - T(3) * q_a) /
                          p.c[P2_RADIUS_A];
            radial += (pa_i * ratio_ij + s_pa[j] * ratio_ji) * dwa * volume;
          }
        }

        // viscosity: field-major, a zero viscosity makes its inverse
        // infinite and mu_h exactly 0; row-major, mu_h is 0 unless
        // mu_i + mu_j > 0
        {
          bool m_v = m_p;
          T omq_v = omq_p;
          if (!p.uniform_radii) {
            m_v = p.c[P2_RADIUS_V2] - rij2 > T(0);
            omq_v = T(1) - rij * p.c[P2_INV_RADIUS_V];
          }
          if (m_v && !rs) {
            T udote = (s_vx[j] - vxi) * ex + (s_vy[j] - vyi) * ey;
            if (!PLANAR) udote += (s_vz[j] - vzi) * ez;
            T mu_h;
            if (ROWS) {
              const T den = visc_i + s_visc[j];
              mu_h = den > T(0) ? T(2) * visc_i * s_visc[j] / den : T(0);
            } else {
              mu_h = T(2) / (visc_i + s_visc[j]);
            }
            const T dwv = p.c[P2_DWV_COEF] * omq_v;
            radial += p.c[P2_C_V] * mu_h * udote * (-dwv) * inv_r * volume;
          }
        }

        fx += radial * ex;
        fy += radial * ey;
        if (!PLANAR) fz += radial * ez;

        // diffuse interface; zero without surface tension
        if (ST) {
          bool m_g = m_p;
          T omq_g = omq_p;
          if (!p.uniform_radii) {
            m_g = p.c[P2_RADIUS_G2] - rij2 > T(0);
            omq_g = T(1) - rij * p.c[P2_INV_RADIUS_G];
          }
          if (m_g && !rs) {
            const T wgv = p.c[P2_NORM_G] * (omq_g * omq_g);
            const T dwg = p.c[P2_DWG_COEF] * omq_g;
            const T wij = ratio_ij * wgv, wji = ratio_ji * wgv;
            const T dwij = ratio_ij * dwg, dwji = ratio_ji * dwg;
            const T gcx_j = s_gx[j], gcy_j = s_gy[j];
            const T t1x = a_i * (gcx_j * wji - gcx_i * wij) * scale_di;
            const T t1y = a_i * (gcy_j * wji - gcy_i * wij) * scale_di;
            T gr_sum = (gcx_j * dwji - gcx_i * dwij) * dx +
                       (gcy_j * dwji - gcy_i * dwij) * dy;
            T t1z = 0;
            if (!PLANAR) {
              const T gcz_j = s_gz[j];
              t1z = a_i * (gcz_j * wji - gcz_i * wij) * scale_di;
              gr_sum += (gcz_j * dwji - gcz_i * dwij) * dz;
            }
            const T gr = a_i * gr_sum;
            fx -= t1x + gr * ex * scale_di;
            fy -= t1y + gr * ey * scale_di;
            if (!PLANAR) fz -= t1z + gr * ez * scale_di;
          }
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
  walk.add_to(fsi_p2_counts);
#endif
  const size_t n = p.n;
  p.out[i] = fx;
  p.out[n + i] = fy;
  p.out[2 * n + i] = fz;
}

template <typename T, bool ROWS>
static void dispatch_phase2(const Phase2Params<T>& p, int block, int planar,
                            int surface_tension, cudaStream_t stream) {
  const dim3 grid(p.n / block), threads(block);
  if (planar) {
    if (surface_tension)
      phase2_sweep_kernel<T, true, true, ROWS><<<grid, threads, 0, stream>>>(p);
    else
      phase2_sweep_kernel<T, true, false, ROWS><<<grid, threads, 0, stream>>>(p);
  } else {
    if (surface_tension)
      phase2_sweep_kernel<T, false, true, ROWS><<<grid, threads, 0, stream>>>(p);
    else
      phase2_sweep_kernel<T, false, false, ROWS><<<grid, threads, 0, stream>>>(p);
  }
}

// offs_yz == nullptr selects the field-major rule (keys, offs); otherwise
// the row-major rule (offs_yz, geom = dmin[3] + cw[3], ncell[3], support2).
template <typename T>
static int launch_phase2(const void* pos, const void* vel, const void* key,
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
  Phase2Params<T> p;
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
  for (int k = 0; k < P2_NCONST; ++k) p.c[k] = static_cast<T>(consts[k]);
  for (int k = 0; k < FSI_TYPE_COUNT * FSI_TYPE_COUNT; ++k)
    p.ratio[k] = static_cast<T>(ratio[k]);
  for (int k = 0; k < FSI_TYPE_COUNT; ++k) p.cof_a[k] = static_cast<T>(cof_a[k]);
  p.uniform_ratio = uniform_ratio;
  p.uniform_radii = uniform_radii;
  p.support2 = static_cast<T>(support2);
  if (offs_yz) {
    fsi_rows_fill(&p.g, n_off, offs_yz, geom, ncell);
    dispatch_phase2<T, true>(p, block, planar, surface_tension, stream);
  } else {
    dispatch_phase2<T, false>(p, block, planar, surface_tension, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

static bool phase2_args_ok(int n, int block, int n_off, int surface_tension,
                           const void* pa, const void* gc) {
#ifdef FSI_WALK_COUNT
  if (block % 32 != 0) return false;  // the counts reduce over whole warps
#endif
  return block > 0 && block <= 1024 && n % block == 0 && n_off > 0 &&
         n_off <= FSI_MAX_OFFS &&
         !(surface_tension && (pa == nullptr || gc == nullptr));
}

// Plain C entry point of kernel 2 (field-major rule).  is_double selects the
// instance; all pointers are device pointers except offs, consts (P2_NCONST
// doubles), ratio (36 doubles) and cof_a (6 doubles), which are host arrays.
// pa and gc may be null without surface tension.  Returns cudaGetLastError()
// of the launch (0 = success), or -1 for arguments the kernel does not take.
extern "C" int fsi_phase2_sweep(int is_double, const void* pos,
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
  if (!phase2_args_ok(n, block, n_off, surface_tension, pa, gc)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch_phase2<double>(pos, vel, key, prop, pp, pa, gc, invmu,
                                 win_start, win_len, out, n, block, n_off,
                                 offs, nullptr, nullptr, nullptr, 0.0, consts,
                                 ratio, cof_a, planar, surface_tension,
                                 uniform_ratio, uniform_radii, s);
  return launch_phase2<float>(pos, vel, key, prop, pp, pa, gc, invmu,
                              win_start, win_len, out, n, block, n_off, offs,
                              nullptr, nullptr, nullptr, 0.0, consts, ratio,
                              cof_a, planar, surface_tension, uniform_ratio,
                              uniform_radii, s);
}

// Plain C entry point of kernel 5 (row-major rule): mu is the viscosity
// itself; offs_yz (2 n_off ints), geom (domain_min and cell_width, 6
// doubles) and ncell (3 ints) are host arrays, support2 the squared frame
// support.  The key finds the ring runs only, and must be the one the frame
// was sorted by from these positions (packed_engine.sort_frame, then
// pad_frame_planes in 3-D): every valid row's key is then its linear cell.
// Otherwise as fsi_phase2_sweep.
extern "C" int fsi_phase2_rows(int is_double, const void* pos, const void* vel,
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
  if (!phase2_args_ok(n, block, n_off, surface_tension, pa, gc)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch_phase2<double>(pos, vel, key, prop, pp, pa, gc, mu,
                                 win_start, win_len, out, n, block, n_off,
                                 nullptr, offs_yz, geom, ncell, support2,
                                 consts, ratio, cof_a, planar,
                                 surface_tension, uniform_ratio,
                                 uniform_radii, s);
  return launch_phase2<float>(pos, vel, key, prop, pp, pa, gc, mu,
                              win_start, win_len, out, n, block, n_off,
                              nullptr, offs_yz, geom, ncell, support2, consts,
                              ratio, cof_a, planar, surface_tension,
                              uniform_ratio, uniform_radii, s);
}

extern "C" int fsi_phase2_nconst() { return P2_NCONST; }

// Resident blocks per SM of one phase-2 instance at `block` threads (the
// occupancy the launch reaches; registers and shared memory decide it), or
// -1 where the query fails.
template <typename T, bool ROWS>
static int phase2_occupancy(int planar, int surface_tension, int block) {
  int blocks = -1;
  cudaError_t err;
  if (planar) {
    err = surface_tension
              ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, phase2_sweep_kernel<T, true, true, ROWS>, block, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, phase2_sweep_kernel<T, true, false, ROWS>, block, 0);
  } else {
    err = surface_tension
              ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, phase2_sweep_kernel<T, false, true, ROWS>, block, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, phase2_sweep_kernel<T, false, false, ROWS>, block, 0);
  }
  return err == cudaSuccess ? blocks : -1;
}

extern "C" int fsi_phase2_occupancy(int is_double, int rows, int planar,
                                    int surface_tension, int block) {
  if (is_double)
    return rows ? phase2_occupancy<double, true>(planar, surface_tension, block)
                : phase2_occupancy<double, false>(planar, surface_tension, block);
  return rows ? phase2_occupancy<float, true>(planar, surface_tension, block)
              : phase2_occupancy<float, false>(planar, surface_tension, block);
}

#ifdef FSI_WALK_COUNT
// The checking build's counts of kernels 2 and 5 (see FsiWalkCount) of the
// launches since the last call, into out[3]; then clears them.  Returns a
// cudaError_t (0 = success).
extern "C" int fsi_phase2_counts(unsigned long long* out) {
  return fsi_read_counts(fsi_p2_counts, out);
}
#endif

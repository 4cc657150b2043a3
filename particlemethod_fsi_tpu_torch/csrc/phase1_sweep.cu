// Phase-1 window sweep: per receiver, density A (wa), gravity-centre vector
// (wg), the wp number-density sum, the velocity divergence and, on request,
// the candidate-radius neighbour count.
//
// One template, two TPU kernels, two C entry points:
// * fsi_phase1_sweep (ROWS = false) replaces
//   particlemethod_fsi_tpu/ops/pallas_windows_t.py `_phase1_kernel` (reached
//   through `phase1_fields_pallas_t` -> `_sweep_t`; kernel 1);
// * fsi_phase1_rows (ROWS = true) replaces
//   particlemethod_fsi_tpu/ops/pallas_pairwise.py `_phase1_kernel` (reached
//   through `phase1_fields_pallas` -> `_pallas_sweep`; kernel 4): the ring
//   recomputed from positions, pad senders and j == i rejected, every pair
//   within the support, the count always (see window_sweep.cuh); the key
//   finds the ring runs only.
// Every branch of both is here: planar or not, surface tension or not and
// the pair rule as template parameters; per-pair interaction ratios,
// non-uniform radii and the count as launch parameters (uniform branches).
//
// Bound on an H100: at the flags of the planar scene without surface tension
// the function needs 28 bytes a particle in float32 (x, y, vx, vy and the key
// read once, the wp sum and the divergence written), some ten microseconds
// at 1M particles; the pair math of the true neighbour pairs (about 20 a
// receiver in 2-D) needs less time than that at the float32 rate, so by the
// roofline the kernel is bound by bytes.  As written it moves more: pos and
// vel are [N,3] rows, z included, and all 7 output rows are written, the
// zero ones too.
//
// What held the first design back: every receiver of a 64-row
// block tested every sender of the block's windows (275 at the 1M bench
// scene, for 20 neighbours) against its ring, one sender a step for the
// whole block, and the warp ran the pair body in almost every step because
// some lane passed: the candidate loop, not memory, set the time (flushing
// L2 cost 4-9 %; 0.288 ms for kernel 1 and 0.368 for kernel 4 on an NVIDIA
// H100 80GB HBM3 at 700 W, PERF.md).
//
// This design is phase 2's (phase2_sweep.cu), through the ring-run walk of
// window_sweep.cuh: the frame is sorted by key, so the senders in a
// receiver's ring for one offset are one run of rows.  A block stages the
// windows of all its offsets together, in chunks (FsiChunk), by cp.async,
// one array a field: x, y, vx, vy (z, vz in 3-D), and the key -- under the
// row rule also the linear cell of each sender computed from its staged
// position (INT_MIN for a pad, in no ring); the type where interaction
// ratios are on, or for the row rule's pad test.  Each receiver finds its
// run in each window's part of the chunk by two binary searches on the
// staged keys (under the row rule, for the linear cells of fsi_ring: on a
// frame sorted from these positions they are the valid senders' keys, and
// a plane pad's key, the last cell of its plane, keeps the keys sorted
// where a window spans a plane end) and walks only that run (a third of
// the window at the bench scene), in batches of 32: a branch-free pre-test
// -- the first design's exact mask: the ring (key within one of
// key_i + off, or the linear cell in fsi_ring with j != i), rij2 > 0 and
// rij2 <= reach2,
// inclusive as every phase-1 radius test is -- sets one bit a sender, and
// the body runs over the set bits in ascending order.  Each receiver sums
// the same terms as the first design in the same order (offsets in order,
// rows ascending, a run that two chunks split walked piece by piece), so
// the float results are the first design's bit for bit.  Measured at the
// 1M bench scene on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): kernel 1
// 0.137 ms warm (0.290 before), kernel 4 0.174 (0.368), the same 86 of 275
// senders pre-tested a receiver as phase 2.  A body inline over the whole
// run, each term added under the pre-test's mask by a select, measured
// 6-9 % slower there, so the body runs over the set bits only.
#include "window_sweep.cuh"

enum {
  P1_RADIUS_A2 = 0, P1_RADIUS_G2, P1_RADIUS_P2, P1_INV_RADIUS_A,
  P1_INV_RADIUS_G, P1_INV_RADIUS_P, P1_NORM_A, P1_NORM_G, P1_R2G,
  P1_RADIUS_G, P1_NORM_P, P1_DIV_SCALE, P1_SUPPORT2, P1_NCONST
};

template <typename T>
struct Phase1Params {
  const T* pos;         // [N,3]
  const T* vel;         // [N,3]
  const int* key;       // [N] sorted: the ring runs (both rules) and the
                        // field-major rule's ring test
  const int* prop;      // [N]
  const int* win_start; // [nblocks, n_off]
  const int* win_len;   // [nblocks, n_off]
  T* out;               // [7, N]: da gx gy gz wp div count
  int n;
  int n_off;
  int offs[FSI_MAX_OFFS];
  T c[P1_NCONST];
  T ratio[FSI_TYPE_COUNT * FSI_TYPE_COUNT];
  int with_ratio;
  int uniform_radii;
  int count;
  FsiRows<T> g;         // row-major rule only
};

#ifdef FSI_WALK_COUNT
// the checking build's counts of this kernel (see FsiWalkCount), read and
// cleared by fsi_phase1_counts
__device__ unsigned long long fsi_p1_counts[3];
#endif

template <typename T, bool PLANAR, bool ST, bool ROWS>
__global__ void phase1_sweep_kernel(const Phase1Params<T> p) {
  constexpr int CAP = FsiChunk<T>::value;
  constexpr int CAP_Z = PLANAR ? 1 : CAP;
  // the chunk, one array a field (lanes read different senders)
  __shared__ T s_x[CAP], s_y[CAP], s_z[CAP_Z];
  __shared__ T s_vx[CAP], s_vy[CAP], s_vz[CAP_Z];
  __shared__ int s_key[CAP];  // sorted within each window: the run searches
  __shared__ int s_lin[ROWS ? CAP : 1];  // row rule: the linear cell
  __shared__ int s_prop[(ST || ROWS) ? CAP : 1];
  __shared__ T s_ratio[FSI_TYPE_COUNT * FSI_TYPE_COUNT];
  // where each offset's window starts in the concatenation of all windows
  __shared__ int s_cum[FSI_MAX_OFFS + 1];

  const int b = blockIdx.x;
  const int i = b * blockDim.x + threadIdx.x;  // n is a multiple of blockDim.x
  const bool with_ratio = ST && p.with_ratio;
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
  int cxi = 0, cyi = 0, czi = 0;
  if (ROWS) {
    cxi = fsi_cell(xi, p.g.dmin[0], p.g.cw[0], p.g.ncell[0]);
    cyi = fsi_cell(yi, p.g.dmin[1], p.g.cw[1], p.g.ncell[1]);
    if (p.g.three_d) czi = fsi_cell(zi, p.g.dmin[2], p.g.cw[2], p.g.ncell[2]);
  }

  // the largest radius any requested sum tests: pairs beyond it add nothing;
  // under the row-major rule no pair beyond the support counts at all
  T reach2 = p.c[P1_RADIUS_P2];
  if (ST && !p.uniform_radii) {
    reach2 = max(reach2, max(p.c[P1_RADIUS_A2], p.c[P1_RADIUS_G2]));
  }
  if (p.count) reach2 = max(reach2, p.c[P1_SUPPORT2]);
  if (ROWS) reach2 = p.c[P1_SUPPORT2];

  __syncthreads();  // s_cum, s_ratio
  const int total = s_cum[p.n_off];

  T acc_da = 0, acc_gx = 0, acc_gy = 0, acc_gz = 0, acc_wp = 0, acc_div = 0,
    acc_cnt = 0;
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
      // rule: key_i + off +- 1; row rule: the linear cells of fsi_ring,
      // which on a frame sorted from these positions are the valid
      // senders' keys), and the window is sorted by key, so two lower
      // bounds find it.
      const int ring_centre = key_i + p.offs[o];
      const FsiRing ring = ROWS ? fsi_ring(cxi, cyi, czi, o, p.g) : FsiRing{};
      const int vlo = ROWS ? ring.lo : ring_centre - 1;
      const int vhi = ROWS ? ring.lo + static_cast<int>(ring.span)
                           : ring_centre + 1;
      const int j0 = fsi_lower_bound(s_key, a - v0, e - v0, vlo);
      const int j1 = fsi_lower_bound(s_key, j0, e - v0, vhi + 1);
      // pre-test, branch-free: the exact mask of a walk of the whole window
      // (the run only leaves out senders it rejects); every phase-1 radius
      // test is inclusive, rij2 <= radius^2
      auto test = [&](int j) {
        const T dx = s_x[j] - xi;
        const T dy = s_y[j] - yi;
        T rij2 = dx * dx + dy * dy;
        if (!PLANAR) {
          const T dz = s_z[j] - zi;
          rij2 += dz * dz;
        }
        bool ok = (rij2 > T(0)) & !(rij2 > reach2);
        if (ROWS)
          ok = ok & fsi_in_ring(s_lin[j], ring) & (row0 + j != i);
        else  // the key within one of the ring's centre
          ok = ok & (static_cast<unsigned>(s_key[j] - ring_centre + 1) <= 2u);
        return ok;
      };
      // the sums of one sender that passed the pre-test
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

        const bool m_p = p.c[P1_RADIUS_P2] - rij2 >= T(0);
        const T q_p = rij * p.c[P1_INV_RADIUS_P];
        const T omq_p = T(1) - q_p;

        if (ST) {
          const T ratio_ij =
              with_ratio ? fsi_ratio(s_ratio, type_i, s_prop[j]) : T(1);
          bool m_a, m_g;
          T q_a, omq_a2, omq_g2;
          if (p.uniform_radii) {
            m_a = m_g = m_p;
            q_a = q_p;
            omq_a2 = omq_p * omq_p;
            omq_g2 = omq_a2;
          } else {
            m_a = p.c[P1_RADIUS_A2] - rij2 >= T(0);
            m_g = p.c[P1_RADIUS_G2] - rij2 >= T(0);
            q_a = rij * p.c[P1_INV_RADIUS_A];
            omq_a2 = (T(1) - q_a) * (T(1) - q_a);
            const T q_g = rij * p.c[P1_INV_RADIUS_G];
            omq_g2 = (T(1) - q_g) * (T(1) - q_g);
          }
          // densityA (wa kernel)
          if (m_a) acc_da += ratio_ij * (p.c[P1_NORM_A] * q_a * omq_a2);
          // gravity centre (wg kernel)
          if (m_g) {
            const T wg = p.c[P1_NORM_G] * omq_g2;
            const T w_gc = ratio_ij * wg / p.c[P1_R2G] * p.c[P1_RADIUS_G];
            acc_gx += dx * w_gc;
            acc_gy += dy * w_gc;
            if (!PLANAR) acc_gz += dz * w_gc;
          }
        }

        // wp sum + divergence; the constant norms are applied after the loop
        if (m_p) {
          acc_wp += omq_p * omq_p;
          T udotx = (s_vx[j] - vxi) * dx + (s_vy[j] - vyi) * dy;
          if (!PLANAR) udotx += (s_vz[j] - vzi) * dz;
          acc_div += (udotx * inv_r) * omq_p;
        }
        if (p.count && rij2 <= p.c[P1_SUPPORT2]) acc_cnt += T(1);
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
  walk.add_to(fsi_p1_counts);
#endif
  const size_t n = p.n;
  p.out[i] = acc_da;
  p.out[n + i] = acc_gx;
  p.out[2 * n + i] = acc_gy;
  p.out[3 * n + i] = acc_gz;
  p.out[4 * n + i] = acc_wp * p.c[P1_NORM_P];
  p.out[5 * n + i] = acc_div * p.c[P1_DIV_SCALE];
  p.out[6 * n + i] = acc_cnt;
}

template <typename T, bool ROWS>
static void dispatch_phase1(const Phase1Params<T>& p, int block, int planar,
                            int surface_tension, cudaStream_t stream) {
  const dim3 grid(p.n / block), threads(block);
  if (planar) {
    if (surface_tension)
      phase1_sweep_kernel<T, true, true, ROWS><<<grid, threads, 0, stream>>>(p);
    else
      phase1_sweep_kernel<T, true, false, ROWS><<<grid, threads, 0, stream>>>(p);
  } else {
    if (surface_tension)
      phase1_sweep_kernel<T, false, true, ROWS><<<grid, threads, 0, stream>>>(p);
    else
      phase1_sweep_kernel<T, false, false, ROWS><<<grid, threads, 0, stream>>>(p);
  }
}

// offs_yz == nullptr selects the field-major rule (keys, offs); otherwise
// the row-major rule (offs_yz, geom = dmin[3] + cw[3], ncell[3]).
template <typename T>
static int launch_phase1(const void* pos, const void* vel, const void* key,
                         const void* prop, const void* win_start,
                         const void* win_len, void* out, int n, int block,
                         int n_off, const int* offs, const int* offs_yz,
                         const double* geom, const int* ncell,
                         const double* consts, const double* ratio, int planar,
                         int surface_tension, int with_ratio,
                         int uniform_radii, int count, cudaStream_t stream) {
  Phase1Params<T> p;
  p.pos = static_cast<const T*>(pos);
  p.vel = static_cast<const T*>(vel);
  p.key = static_cast<const int*>(key);
  p.prop = static_cast<const int*>(prop);
  p.win_start = static_cast<const int*>(win_start);
  p.win_len = static_cast<const int*>(win_len);
  p.out = static_cast<T*>(out);
  p.n = n;
  p.n_off = n_off;
  for (int o = 0; o < n_off; ++o) p.offs[o] = offs ? offs[o] : 0;
  for (int k = 0; k < P1_NCONST; ++k) p.c[k] = static_cast<T>(consts[k]);
  for (int k = 0; k < FSI_TYPE_COUNT * FSI_TYPE_COUNT; ++k)
    p.ratio[k] = static_cast<T>(ratio[k]);
  p.with_ratio = with_ratio;
  p.uniform_radii = uniform_radii;
  p.count = count;
  if (offs_yz) {
    fsi_rows_fill(&p.g, n_off, offs_yz, geom, ncell);
    dispatch_phase1<T, true>(p, block, planar, surface_tension, stream);
  } else {
    dispatch_phase1<T, false>(p, block, planar, surface_tension, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

static bool phase1_args_ok(int n, int block, int n_off) {
#ifdef FSI_WALK_COUNT
  if (block % 32 != 0) return false;  // the counts reduce over whole warps
#endif
  return block > 0 && block <= 1024 && n % block == 0 && n_off > 0 &&
         n_off <= FSI_MAX_OFFS;
}

// Plain C entry point of kernel 1 (field-major rule).  is_double selects the
// instance; all pointers are device pointers except offs, consts (P1_NCONST
// doubles) and ratio (36 doubles), which are host arrays.  Returns
// cudaGetLastError() of the launch (0 = success), or -1 for arguments the
// kernel does not take.
extern "C" int fsi_phase1_sweep(int is_double, const void* pos,
                                const void* vel, const void* key,
                                const void* prop, const void* win_start,
                                const void* win_len, void* out, int n,
                                int block, int n_off, const int* offs,
                                const double* consts, const double* ratio,
                                int planar, int surface_tension,
                                int with_ratio, int uniform_radii, int count,
                                void* stream) {
  if (!phase1_args_ok(n, block, n_off)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch_phase1<double>(pos, vel, key, prop, win_start, win_len, out,
                                 n, block, n_off, offs, nullptr, nullptr,
                                 nullptr, consts, ratio, planar,
                                 surface_tension, with_ratio, uniform_radii,
                                 count, s);
  return launch_phase1<float>(pos, vel, key, prop, win_start, win_len, out, n,
                              block, n_off, offs, nullptr, nullptr, nullptr,
                              consts, ratio, planar, surface_tension,
                              with_ratio, uniform_radii, count, s);
}

// Plain C entry point of kernel 4 (row-major rule; the count is always
// produced).  offs_yz holds (oy, oz) of each row offset (2 n_off ints), geom
// the grid's domain_min and cell_width (6 doubles), ncell its cell_count (3
// ints); all three are host arrays, like consts and ratio.  The key finds
// the ring runs only, and must be the one the frame was sorted by, from
// these positions (plane pads keyed as pad_frame_planes keys them).
extern "C" int fsi_phase1_rows(int is_double, const void* pos, const void* vel,
                               const void* key, const void* prop,
                               const void* win_start,
                               const void* win_len, void* out, int n,
                               int block, int n_off, const int* offs_yz,
                               const double* geom, const int* ncell,
                               const double* consts, const double* ratio,
                               int planar, int surface_tension, int with_ratio,
                               int uniform_radii, void* stream) {
  if (!phase1_args_ok(n, block, n_off)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch_phase1<double>(pos, vel, key, prop, win_start, win_len,
                                 out, n, block, n_off, nullptr, offs_yz, geom,
                                 ncell, consts, ratio, planar,
                                 surface_tension, with_ratio, uniform_radii, 1,
                                 s);
  return launch_phase1<float>(pos, vel, key, prop, win_start, win_len, out,
                              n, block, n_off, nullptr, offs_yz, geom, ncell,
                              consts, ratio, planar, surface_tension,
                              with_ratio, uniform_radii, 1, s);
}

extern "C" int fsi_phase1_nconst() { return P1_NCONST; }

// Resident blocks per SM of one phase-1 instance at `block` threads (the
// occupancy the launch reaches; registers and shared memory decide it), or
// -1 where the query fails.
template <typename T, bool ROWS>
static int phase1_occupancy(int planar, int surface_tension, int block) {
  int blocks = -1;
  cudaError_t err;
  if (planar) {
    err = surface_tension
              ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, phase1_sweep_kernel<T, true, true, ROWS>, block, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, phase1_sweep_kernel<T, true, false, ROWS>, block, 0);
  } else {
    err = surface_tension
              ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, phase1_sweep_kernel<T, false, true, ROWS>, block, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, phase1_sweep_kernel<T, false, false, ROWS>, block, 0);
  }
  return err == cudaSuccess ? blocks : -1;
}

extern "C" int fsi_phase1_occupancy(int is_double, int rows, int planar,
                                    int surface_tension, int block) {
  if (is_double)
    return rows ? phase1_occupancy<double, true>(planar, surface_tension, block)
                : phase1_occupancy<double, false>(planar, surface_tension, block);
  return rows ? phase1_occupancy<float, true>(planar, surface_tension, block)
              : phase1_occupancy<float, false>(planar, surface_tension, block);
}

#ifdef FSI_WALK_COUNT
// The checking build's counts of kernels 1 and 4 (see FsiWalkCount) of the
// launches since the last call, into out[3]; then clears them.  Returns a
// cudaError_t (0 = success).
extern "C" int fsi_phase1_counts(unsigned long long* out) {
  return fsi_read_counts(fsi_p1_counts, out);
}
#endif

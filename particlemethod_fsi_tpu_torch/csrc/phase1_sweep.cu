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
//   within the support, the count always (see window_sweep.cuh).
// Every branch of both is here: planar or not, surface tension or not and
// the pair rule as template parameters; per-pair interaction ratios,
// non-uniform radii and the count as launch parameters (uniform branches).
//
// Bound on an H100: at the flags of the planar scene without surface tension
// the function needs 28 bytes a particle in float32 (x, y, vx, vy and the key
// read once, the wp sum and the divergence written), some ten microseconds
// at 1M particles; the pair math of the true neighbour pairs (about 20 a
// receiver in 2-D) needs less time than that at the float32 rate, so by the
// roofline the kernel is bound by bytes.  As written it moves about twice
// that: pos and vel are staged as [N,3] rows, z included, and all 7 output
// rows are written, the zero ones too.  This simple design is far from
// that bound: a receiver tests every sender of its block's windows, an order
// of magnitude more candidates than neighbours, and that candidate loop
// (shared-memory reads, the ring test, the squared-radius test) is where the
// time goes.  What the design does about it: sender tiles are staged once
// per block in shared memory and read as broadcasts, the ring and one
// squared-radius pre-test reject a pair before any rsqrt, and the kernel
// norms are hoisted out of the sums.  Cutting the candidates per receiver
// (narrower windows per sub-block, a cell-run skip) is left to later work.
// The row-major rule reads the type where the key rule reads the key (the
// same bytes), and stages one linear cell index a sender, computed from the
// position by one true divide an axis when the tile is staged; its exact
// ring is one range of linear cells a receiver and offset, so a candidate
// costs one shared load and one compare, as with the key (see fsi_ring).
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
  const int* key;       // [N] (field-major rule only)
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

template <typename T, bool PLANAR, bool ST, bool ROWS>
__global__ void phase1_sweep_kernel(const Phase1Params<T> p) {
  __shared__ T s_pos[FSI_TILE * 3];
  __shared__ T s_vel[FSI_TILE * 3];
  __shared__ int s_key[ROWS ? 1 : FSI_TILE];
  __shared__ int s_prop[FSI_TILE];
  __shared__ int s_lin[ROWS ? FSI_TILE : 1];
  __shared__ T s_ratio[FSI_TYPE_COUNT * FSI_TYPE_COUNT];

  const int b = blockIdx.x;
  const int i = b * blockDim.x + threadIdx.x;  // n is a multiple of blockDim.x
  const bool with_ratio = ST && p.with_ratio;
  if (with_ratio) {
    for (int t = threadIdx.x; t < FSI_TYPE_COUNT * FSI_TYPE_COUNT; t += blockDim.x)
      s_ratio[t] = p.ratio[t];
  }

  const T xi = p.pos[3 * i], yi = p.pos[3 * i + 1], zi = p.pos[3 * i + 2];
  const T vxi = p.vel[3 * i], vyi = p.vel[3 * i + 1], vzi = p.vel[3 * i + 2];
  const int key_i = ROWS ? 0 : p.key[i];
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

  T acc_da = 0, acc_gx = 0, acc_gy = 0, acc_gz = 0, acc_wp = 0, acc_div = 0,
    acc_cnt = 0;

  for (int o = 0; o < p.n_off; ++o) {
    const int start = p.win_start[b * p.n_off + o];
    const int len = p.win_len[b * p.n_off + o];
    const int ring_centre = key_i + p.offs[o];
    const FsiRing ring = ROWS ? fsi_ring(cxi, cyi, czi, o, p.g) : FsiRing{};
    for (int t0 = 0; t0 < len; t0 += FSI_TILE) {
      const int cnt = min(FSI_TILE, len - t0);
      const int row0 = start + t0;
      __syncthreads();  // the previous tile is consumed
      fsi_stage(s_pos, p.pos + 3 * (size_t)row0, 3 * cnt);
      fsi_stage(s_vel, p.vel + 3 * (size_t)row0, 3 * cnt);
      if (ROWS) {
        fsi_stage_lin(s_lin, p.pos, p.prop, row0, cnt, p.g);
      } else {
        fsi_stage(s_key, p.key + row0, cnt);
      }
      if (with_ratio) fsi_stage(s_prop, p.prop + row0, cnt);
      __syncthreads();

      for (int j = 0; j < cnt; ++j) {
        if (ROWS) {
          if (!fsi_in_ring(s_lin[j], ring) || row0 + j == i) continue;
        } else {
          const int dk = s_key[j] - ring_centre;
          if (dk < -1 || dk > 1) continue;
        }
        const T dx = s_pos[3 * j] - xi;
        const T dy = s_pos[3 * j + 1] - yi;
        T rij2 = dx * dx + dy * dy;
        T dz = 0;
        if (!PLANAR) {
          dz = s_pos[3 * j + 2] - zi;
          rij2 += dz * dz;
        }
        if (!(rij2 > T(0)) || rij2 > reach2) continue;
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
          T udotx = (s_vel[3 * j] - vxi) * dx + (s_vel[3 * j + 1] - vyi) * dy;
          if (!PLANAR) udotx += (s_vel[3 * j + 2] - vzi) * dz;
          acc_div += (udotx * inv_r) * omq_p;
        }
        if (p.count && rij2 <= p.c[P1_SUPPORT2]) acc_cnt += T(1);
      }
    }
  }

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
// ints); all three are host arrays, like consts and ratio.
extern "C" int fsi_phase1_rows(int is_double, const void* pos, const void* vel,
                               const void* prop, const void* win_start,
                               const void* win_len, void* out, int n,
                               int block, int n_off, const int* offs_yz,
                               const double* geom, const int* ncell,
                               const double* consts, const double* ratio,
                               int planar, int surface_tension, int with_ratio,
                               int uniform_radii, void* stream) {
  if (!phase1_args_ok(n, block, n_off)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch_phase1<double>(pos, vel, nullptr, prop, win_start, win_len,
                                 out, n, block, n_off, nullptr, offs_yz, geom,
                                 ncell, consts, ratio, planar,
                                 surface_tension, with_ratio, uniform_radii, 1,
                                 s);
  return launch_phase1<float>(pos, vel, nullptr, prop, win_start, win_len, out,
                              n, block, n_off, nullptr, offs_yz, geom, ncell,
                              consts, ratio, planar, surface_tension,
                              with_ratio, uniform_radii, 1, s);
}

extern "C" int fsi_phase1_nconst() { return P1_NCONST; }

// Exponential-population pseudo-Gibbs chain: n_rounds x (n0 scale move, g
// random-walk move) in one launch, k_bar held fixed.
//
// Replaces: delphy_tpu/parallel/pop_pallas.py exp_pop_chain_pallas (chain
// body _chain_rows, log prior _lp_rows), the TPU kernel behind
// mcmc/global_moves.py exp_pop_moves (reference core/run.cpp:1237-1319).
//
// What bounds it on the card: latency.  Each of the 2 x n_rounds proposals
// is an O(C + N) log-prior evaluation (C cells of the exp-pop integral with
// the min_pop floor, N inner-node -log N(t) terms) that the next accept
// decision depends on, so the chain is a serial string of small reductions;
// bytes are a few KB and the arithmetic about 2 MFLOP.  A proposal costs the
// latency of its serial f64 chain: its per-cell exp/expm1 and divisions,
// one block-wide reduction, and the scalar logs and divisions of the MH
// step.
//
// Design: one block; every cell and every node belongs to one thread for the
// whole chain (c = tid + k * THREADS), so the per-element state needs no
// barrier, and every thread takes the same accept decision from the same
// reduced sums, so no thread waits on another for the chain state.
// - The n_rounds x 4 uniforms are copied into shared memory once.
// - One reduction per proposal: warp xor-shuffles, then one shared-memory
//   stage read by every thread in the same order (so every thread holds the
//   same total).  The stage is double-buffered, so a reduction costs one
//   barrier.
// - What a proposal does not change is hoisted.  A g proposal computes every
//   cell in full, and for its g leaves in a spare buffer (which becomes the
//   cache when it is accepted): each cell's e_c = exp(g (a_c - t0)) and
//   m_c = expm1(g (b_c - a_c)); H = n0 x the sum of the cells' terms taken
//   as one exp piece each (term_c = 0.5 t_step k2_c / nbar_c with
//   nbar_c = ((n0 / g) e_c) m_c / t_step, so n0 term_c does not depend on
//   n0); R = min_c nbar_c / n0; and over inner nodes X = sum_i g (t_i - t0)
//   and x_min = min_i g (t_i - t0).  An n0 proposal (g fixed) is then
//   -(H / n0 + n_inner log n0 + X), with no per-cell work and no reduction,
//   wherever that fold is the plain formula: the min_pop clamp reaches no
//   cell (tc outside the grid), no nbar is floored at TINY (n0 R > 2 TINY)
//   and the log_min_pop floor binds at no node (log n0 + x_min >=
//   log_min_pop).  Otherwise each cell the clamp does not reach is
//   ((n0 / g) e_c) m_c, the plain formula's own product, the others take
//   the full formula, and one reduction sums them.  Proposals whose g lies
//   outside [g_min, g_max] are rejected without an evaluation, as the plain
//   chain rejects them whatever it computes.
// - The node rows (t, inner: 12 bytes a node) are copied into shared memory
//   where they fit beside the cell rows; beyond ~18k nodes (a tree of ~9k
//   tips) the kernel, built with NODES_GLOBAL, reads them in place from
//   device memory instead (they are read-only, coalesced, one pass per full
//   evaluation), with the same arithmetic.
// Tolerance: the outputs n0 and g are products and sums of accepted
// proposals, so they equal the plain chain's bit for bit whenever every
// accept decision agrees.  The regrouped sums (warp-tree order; the folds
// H / n0 and n_inner log n0 + X, each within a few ulps per cell of the
// direct sum) move a log prior by about C x 1e-16 of its size, so a
// decision can only differ where log_mh lies within ~1e-13 of the log
// uniform it is compared with; the rtol 1e-12 check on n0 and g holds
// otherwise.

// Precision: a template on `real` (real.cuh).  delphy_exp_pop_chain is the
// float64 build and delphy_exp_pop_chain_f32 the float32 one (the TPU
// kernel's precision), with expf/expm1f/logf; shared memory is counted in
// sizeof(real), so the float32 build keeps the node rows in shared memory
// up to about twice the nodes.
#include "real.cuh"

namespace {

using namespace delphy_real;

constexpr int THREADS = 256;  // the fastest of 64-512 at C = 400 (PERF.md)
constexpr int WARPS = THREADS / 32;
constexpr int MAX_VALUES = 5;  // values in one block reduction
constexpr double TINY = 1e-30;
// uniform lane assignment per round (pop_pallas.py _U_*)
constexpr int U_SCALE = 0, U_ACC_N0 = 1, U_DELTA = 2, U_ACC_G = 3,
              N_LANES = 4;
constexpr int SMEM_LIMIT = 227 * 1024;

template <class real>
struct Grid {
  const real* lbs;      // shared, C
  const real* k2;       // shared, C
  const real* t;        // shared, N
  const int* inner;     // shared, N
  int C, N;
  real t_step, t0, min_pop, log_min_pop;
};

// What the last accepted g leaves for the n0 proposals (see the note).
template <class real>
struct GCache {
  real* e;        // C: exp(g (a_c - t0))
  real* m;        // C: expm1(g (b_c - a_c))
  real X;         // sum over inner nodes of g (t_i - t0)
  real x_min;     // min over inner nodes of g (t_i - t0)
  real H;         // sum over cells of n0 x the unclamped cell term
  real R;         // min over cells of the unclamped nbar / n0
};

template <class real>
__device__ __forceinline__ real warp_sum(real v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <class real>
__device__ __forceinline__ real warp_min(real v) {
  for (int o = 16; o > 0; o >>= 1)
    v = r_min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sums of v[0, n_sum) and minima of v[n_sum, n_sum + n_min),
// the same in every thread.  red holds 2 x MAX_VALUES x WARPS values;
// `parity` flips each call, so one barrier suffices: a warp can write a
// buffer again only after every thread has passed the barrier of the
// reduction in between, by which time all reads of it are done.
template <class real>
__device__ void block_reduce(real* v, int n_sum, int n_min, real* red,
                             int& parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  real* r = red + parity * MAX_VALUES * WARPS;
  parity ^= 1;
  const int n = n_sum + n_min;
#pragma unroll
  for (int k = 0; k < MAX_VALUES; ++k) {
    if (k >= n) break;
    real x = k < n_sum ? warp_sum(v[k]) : warp_min(v[k]);
    if (lane == 0) r[k * WARPS + warp] = x;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < MAX_VALUES; ++k) {
    if (k >= n) break;
    real x = r[k * WARPS];
    for (int w = 1; w < WARPS; ++w)
      x = k < n_sum ? x + r[k * WARPS + w] : r_min(x, r[k * WARPS + w]);
    v[k] = x;
  }
}

// the min_pop crossing time of (n0, g) (pop.exp_pop_integral)
template <class real>
__device__ __forceinline__ real crossing(real n0, real g, const Grid<real>& r) {
  const real safe_g = g == real(0) ? real(1) : g;
  real tc = r.t0 + r_log(r_max(r.min_pop, real(TINY)) / n0) / safe_g;
  if (r.min_pop <= real(0) || g == real(0))
    tc = g > real(0) ? -r_inf<real>() : r_inf<real>();
  return tc;
}

// exp-pop integral over cell [a, a + t_step] with the min_pop floor
// (pop.exp_pop_integral, reference pop_model.cpp:43-91)
template <class real>
__device__ real cell_integral(real a, real tc, real n0, real g,
                              const Grid<real>& r) {
  const real safe_g = g == real(0) ? real(1) : g;
  real b = a + r.t_step;
  real lo_c = r_min(r_max(tc, a), b);
  real clamped = g > real(0) ? lo_c - a : b - lo_c;
  real un_a = g > real(0) ? lo_c : a, un_b = g > real(0) ? b : lo_c;
  real unclamped = g == real(0)
      ? r.t_step * n0
      : (n0 / safe_g) * r_exp(safe_g * (un_a - r.t0)) *
            r_expm1(safe_g * (un_b - un_a));
  real integral = clamped * r.min_pop + unclamped;
  if (g == real(0) && r.min_pop > real(0))
    integral = r.t_step * r_max(r.min_pop, n0);
  return integral;
}

// true where the clamp does not reach cell [a, b]: the cell is one exp piece
template <class real>
__device__ __forceinline__ bool unclamped_cell(real a, real tc, real g,
                                               real t_step) {
  real b = a + t_step;
  real lo_c = r_min(r_max(tc, a), b);
  return g > real(0) ? lo_c == a : (g < real(0) && lo_c == b);
}

template <class real>
__device__ __forceinline__ real quad_term(real integral, real k2,
                                          real t_step) {
  real nbar = r_max(integral / t_step, real(TINY));
  return real(0.5) * t_step * k2 / nbar;
}

// Full evaluation at (n0, g); returns -log prior and fills `gc` for g.
template <class real>
__device__ real eval_full(real n0, real g, const Grid<real>& r,
                          GCache<real>& gc, real* red, int& parity) {
  const real tc = crossing(n0, g, r);
  const real ng = n0 / g;
  real s = real(0), Hs = real(0), nb_min = r_inf<real>();
  for (int c = threadIdx.x; c < r.C; c += THREADS) {
    real a = r.lbs[c], b = a + r.t_step;
    real ec = r_exp(g * (a - r.t0)), mc = r_expm1(g * (b - a));
    gc.e[c] = ec;
    gc.m[c] = mc;
    if (g == real(0)) {
      s += quad_term(cell_integral(a, tc, n0, g, r), r.k2[c], r.t_step);
      continue;
    }
    // the cell as one exp piece: its term, and what the fold needs
    real nb = ((ng * ec) * mc) / r.t_step;
    real term_un = real(0.5) * r.t_step * r.k2[c] / r_max(nb, real(TINY));
    s += unclamped_cell(a, tc, g, r.t_step)
        ? term_un
        : quad_term(cell_integral(a, tc, n0, g, r), r.k2[c], r.t_step);
    Hs += term_un;
    nb_min = r_min(nb_min, nb);
  }
  const real ln0 = r_log(n0);
  real X = real(0), x_min = r_inf<real>();
  for (int i = threadIdx.x; i < r.N; i += THREADS) {
    if (!r.inner[i]) continue;
    real x = g * (r.t[i] - r.t0);
    s += r_max(r.log_min_pop, ln0 + x);
    X += x;
    x_min = r_min(x_min, x);
  }
  real v[5] = {s, X, Hs, x_min, nb_min};
  block_reduce(v, 3, 2, red, parity);
  gc.X = v[1];
  gc.x_min = v[3];
  gc.H = n0 * v[2];
  gc.R = v[4] / n0;
  return -v[0];
}

// -log prior at (n0, g) for the g of the cache.  Where the clamp reaches no
// cell, no cell's nbar is floored at TINY and the log_min_pop floor binds at
// no node, it is the fold H / n0 + n_inner log n0 + X: no per-cell work and
// no reduction.  Else the cells the clamp does not reach use the cached
// factors, the others the full formula, and `per_cell` counts the call.
template <class real>
__device__ real eval_n0(real n0, real g, const Grid<real>& r,
                        const GCache<real>& gc, real n_inner, real a_min,
                        real b_max, real* red, int& parity, int& per_cell) {
  const real tc = crossing(n0, g, r);
  const real ln0 = r_log(n0);
  const bool floor_binds = n_inner > real(0) && ln0 + gc.x_min < r.log_min_pop;
  const bool clamp_outside = g > real(0) ? tc <= a_min
                                         : (g < real(0) && tc >= b_max);
  if (clamp_outside && n0 * gc.R > real(2) * real(TINY) && !floor_binds)
    return -(gc.H / n0 + (n_inner * ln0 + gc.X));
  ++per_cell;
  const real ng = n0 / g;
  real s = real(0);
  for (int c = threadIdx.x; c < r.C; c += THREADS) {
    real a = r.lbs[c];
    real integral = g != real(0) && unclamped_cell(a, tc, g, r.t_step)
        ? (ng * gc.e[c]) * gc.m[c]
        : cell_integral(a, tc, n0, g, r);
    s += quad_term(integral, r.k2[c], r.t_step);
  }
  if (floor_binds)
    for (int i = threadIdx.x; i < r.N; i += THREADS)
      if (r.inner[i]) s += r_max(r.log_min_pop, ln0 + g * (r.t[i] - r.t0));
  real v[1] = {s};
  block_reduce(v, 1, 0, red, parity);
  return floor_binds ? -v[0] : -(v[0] + (n_inner * ln0 + gc.X));
}

template <class real, bool NODES_GLOBAL>
__global__ void __launch_bounds__(THREADS)
exp_pop_chain_kernel(const real* __restrict__ u, int u_stride, int n_rounds,
                     const real* __restrict__ lbs,
                     const real* __restrict__ k2, int C,
                     const real* __restrict__ t_row,
                     const int* __restrict__ inner, int N,
                     const real* __restrict__ fsc, real alpha, real beta,
                     real g_min, real g_max, real g_mu, real g_scale,
                     int size_enabled, int growth_enabled, real* out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  real* smem = reinterpret_cast<real*>(smem_raw);
  real* s_lbs = smem;                      // C
  real* s_k2 = s_lbs + C;                  // C
  real* ebuf[2] = {s_k2 + C, s_k2 + 2 * C};      // C each
  real* mbuf[2] = {s_k2 + 3 * C, s_k2 + 4 * C};  // C each
  real* s_u = s_k2 + 5 * C;                // n_rounds x N_LANES
  real* red = s_u + n_rounds * N_LANES;    // 2 x MAX_VALUES x WARPS
  const real* s_t = t_row;                     // N, shared or in place
  const int* s_inner = inner;                  // N
  for (int c = threadIdx.x; c < C; c += THREADS) {
    s_lbs[c] = lbs[c];
    s_k2[c] = k2[c];
  }
  for (int k = threadIdx.x; k < n_rounds * N_LANES; k += THREADS)
    s_u[k] = u[(long)(k / N_LANES) * u_stride + k % N_LANES];
  if constexpr (!NODES_GLOBAL) {
    real* st = red + 2 * MAX_VALUES * WARPS;
    int* si = (int*)(st + N);
    for (int i = threadIdx.x; i < N; i += THREADS) {
      st[i] = t_row[i];
      si[i] = inner[i];
    }
    s_t = st;
    s_inner = si;
  }
  __syncthreads();
  const real min_pop = fsc[2];
  const Grid<real> r{s_lbs, s_k2, s_t, s_inner, C, N, fsc[0], fsc[1],
                     min_pop,
                     min_pop > real(0) ? r_log(r_max(min_pop, real(TINY)))
                                       : -r_inf<real>()};
  int parity = 0;
  // constants of the chain: inner-node count and the grid's time span
  real v[3] = {real(0), r_inf<real>(), r_inf<real>()};
  for (int i = threadIdx.x; i < N; i += THREADS)
    v[0] += r.inner[i] ? real(1) : real(0);
  for (int c = threadIdx.x; c < C; c += THREADS) {
    v[1] = r_min(v[1], r.lbs[c]);
    v[2] = r_min(v[2], -(r.lbs[c] + r.t_step));
  }
  block_reduce(v, 1, 2, red, parity);
  const real n_inner = v[0], a_min = v[1], b_max = -v[2];

  real n0 = fsc[3], g = fsc[4];
  GCache<real> cur{ebuf[0], mbuf[0]}, spare{ebuf[1], mbuf[1]};
  real lp = eval_full(n0, g, r, cur, red, parity);
  // the work done, for a bound counted from it: n0 proposals evaluated per
  // cell (not folded) and g proposals evaluated (inside [g_min, g_max])
  int n0_per_cell = 0, g_evaluated = 0;
  const real sc_w = real(1.0 / 0.75 - 0.75);
  for (int i = 0; i < n_rounds; ++i) {
    const real* ur = s_u + i * N_LANES;
    if (size_enabled) {
      // scale move on n0, Inverse-Gamma(alpha, beta) prior
      real scale = real(0.75) + ur[U_SCALE] * sc_w;
      real new_n0 = n0 * scale;
      real lpr = -(alpha + real(1)) * r_log(scale) -
                 beta * (real(1) / new_n0 - real(1) / n0);
      real new_lp = eval_n0(new_n0, g, r, cur, n_inner, a_min, b_max, red,
                            parity, n0_per_cell);
      real log_mh = (new_lp - lp) + lpr - r_log(scale);
      if (log_mh > real(0) ||
          r_log(r_max(ur[U_ACC_N0], real(TINY))) < log_mh) {
        n0 = new_n0;
        lp = new_lp;
      }
    }
    if (growth_enabled) {
      // random-walk move on g, truncated Laplace prior
      real delta = (real(2) * ur[U_DELTA] - real(1)) * real(1.0 / 365.0);
      real new_g = g + delta;
      if (new_g >= g_min && new_g <= g_max) {
        real lpr = (r_abs(g - g_mu) - r_abs(new_g - g_mu)) / g_scale;
        real new_lp = eval_full(n0, new_g, r, spare, red, parity);
        ++g_evaluated;
        real log_mh = (new_lp - lp) + lpr;
        if (log_mh > real(0) ||
            r_log(r_max(ur[U_ACC_G], real(TINY))) < log_mh) {
          g = new_g;
          lp = new_lp;
          GCache<real> t = cur;
          cur = spare;
          spare = t;
        }
      }
    }
  }
  if (threadIdx.x == 0) {
    out[0] = n0;
    out[1] = g;
    out[2] = (real)n0_per_cell;
    out[3] = (real)g_evaluated;
  }
}

// N: the nodes whose rows are in shared memory (0 for NODES_GLOBAL)
template <class real>
size_t smem_bytes(int C, int n_rounds, int N) {
  return (size_t)(6 * C + N_LANES * n_rounds + 2 * MAX_VALUES * WARPS + N) *
             sizeof(real) +
         (size_t)N * sizeof(int);
}

template <class real, bool NODES_GLOBAL>
int launch(const real* u, int u_stride, int n_rounds, const real* lbs,
           const real* k2, int C, const real* t_row, const int* inner,
           int N, const real* fsc, double alpha, double beta, double g_min,
           double g_max, double g_mu, double g_scale, int size_enabled,
           int growth_enabled, real* out, void* stream) {
  size_t smem = smem_bytes<real>(C, n_rounds, NODES_GLOBAL ? 0 : N);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        exp_pop_chain_kernel<real, NODES_GLOBAL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  exp_pop_chain_kernel<real, NODES_GLOBAL>
      <<<1, THREADS, smem, (cudaStream_t)stream>>>(
          u, u_stride, n_rounds, lbs, k2, C, t_row, inner, N, fsc,
          (real)alpha, (real)beta, (real)g_min, (real)g_max, (real)g_mu,
          (real)g_scale, size_enabled, growth_enabled, out);
  return (int)cudaGetLastError();
}

template <class real>
int entry(const real* u, int u_stride, int n_rounds, const real* lbs,
          const real* k2, int C, const real* t_row, const int* inner, int N,
          const real* fsc, double alpha, double beta, double g_min,
          double g_max, double g_mu, double g_scale, int size_enabled,
          int growth_enabled, real* out, void* stream) {
  auto go = smem_bytes<real>(C, n_rounds, N) <= (size_t)SMEM_LIMIT
                ? launch<real, false>
                : launch<real, true>;
  return go(u, u_stride, n_rounds, lbs, k2, C, t_row, inner, N, fsc, alpha,
            beta, g_min, g_max, g_mu, g_scale, size_enabled, growth_enabled,
            out, stream);
}

}  // namespace

extern "C" int delphy_exp_pop_chain(
    const double* u, int u_stride, int n_rounds, const double* lbs,
    const double* k2, int C, const double* t_row, const int* inner, int N,
    const double* fsc, double alpha, double beta, double g_min, double g_max,
    double g_mu, double g_scale, int size_enabled, int growth_enabled,
    double* out, void* stream) {
  return entry(u, u_stride, n_rounds, lbs, k2, C, t_row, inner, N, fsc,
               alpha, beta, g_min, g_max, g_mu, g_scale, size_enabled,
               growth_enabled, out, stream);
}

// the float32 build: every row float, the prior's constants rounded to
// float
extern "C" int delphy_exp_pop_chain_f32(
    const float* u, int u_stride, int n_rounds, const float* lbs,
    const float* k2, int C, const float* t_row, const int* inner, int N,
    const float* fsc, double alpha, double beta, double g_min, double g_max,
    double g_mu, double g_scale, int size_enabled, int growth_enabled,
    float* out, void* stream) {
  return entry(u, u_stride, n_rounds, lbs, k2, C, t_row, inner, N, fsc,
               alpha, beta, g_min, g_max, g_mu, g_scale, size_enabled,
               growth_enabled, out, stream);
}

// whether the node rows of N nodes live in shared memory (1) or are read
// in place (0) at C cells and n_rounds rounds
extern "C" int delphy_exp_pop_chain_nodes_shared(int C, int n_rounds, int N) {
  return smem_bytes<double>(C, n_rounds, N) <= (size_t)SMEM_LIMIT ? 1 : 0;
}

extern "C" int delphy_exp_pop_chain_nodes_shared_f32(int C, int n_rounds,
                                                     int N) {
  return smem_bytes<float>(C, n_rounds, N) <= (size_t)SMEM_LIMIT ? 1 : 0;
}

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

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // the fastest of 64-512 at C = 400 (PERF.md)
constexpr int WARPS = THREADS / 32;
constexpr int MAX_VALUES = 5;  // values in one block reduction
constexpr double TINY = 1e-30;
// uniform lane assignment per round (pop_pallas.py _U_*)
constexpr int U_SCALE = 0, U_ACC_N0 = 1, U_DELTA = 2, U_ACC_G = 3,
              N_LANES = 4;

struct Grid {
  const double* lbs;    // shared, C
  const double* k2;     // shared, C
  const double* t;      // shared, N
  const int* inner;     // shared, N
  int C, N;
  double t_step, t0, min_pop, log_min_pop;
};

// What the last accepted g leaves for the n0 proposals (see the note).
struct GCache {
  double* e;      // C: exp(g (a_c - t0))
  double* m;      // C: expm1(g (b_c - a_c))
  double X;       // sum over inner nodes of g (t_i - t0)
  double x_min;   // min over inner nodes of g (t_i - t0)
  double H;       // sum over cells of n0 x the unclamped cell term
  double R;       // min over cells of the unclamped nbar / n0
};

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_min(double v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmin(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sums of v[0, n_sum) and minima of v[n_sum, n_sum + n_min),
// the same in every thread.  red holds 2 x MAX_VALUES x WARPS doubles;
// `parity` flips each call, so one barrier suffices: a warp can write a
// buffer again only after every thread has passed the barrier of the
// reduction in between, by which time all reads of it are done.
__device__ void block_reduce(double* v, int n_sum, int n_min, double* red,
                             int& parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double* r = red + parity * MAX_VALUES * WARPS;
  parity ^= 1;
  const int n = n_sum + n_min;
#pragma unroll
  for (int k = 0; k < MAX_VALUES; ++k) {
    if (k >= n) break;
    double x = k < n_sum ? warp_sum(v[k]) : warp_min(v[k]);
    if (lane == 0) r[k * WARPS + warp] = x;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < MAX_VALUES; ++k) {
    if (k >= n) break;
    double x = r[k * WARPS];
    for (int w = 1; w < WARPS; ++w)
      x = k < n_sum ? x + r[k * WARPS + w] : fmin(x, r[k * WARPS + w]);
    v[k] = x;
  }
}

// the min_pop crossing time of (n0, g) (pop.exp_pop_integral)
__device__ __forceinline__ double crossing(double n0, double g,
                                           const Grid& r) {
  const double safe_g = g == 0.0 ? 1.0 : g;
  double tc = r.t0 + log(fmax(r.min_pop, TINY) / n0) / safe_g;
  if (r.min_pop <= 0.0 || g == 0.0) tc = g > 0.0 ? -INFINITY : INFINITY;
  return tc;
}

// exp-pop integral over cell [a, a + t_step] with the min_pop floor
// (pop.exp_pop_integral, reference pop_model.cpp:43-91)
__device__ double cell_integral(double a, double tc, double n0, double g,
                                const Grid& r) {
  const double safe_g = g == 0.0 ? 1.0 : g;
  double b = a + r.t_step;
  double lo_c = fmin(fmax(tc, a), b);
  double clamped = g > 0.0 ? lo_c - a : b - lo_c;
  double un_a = g > 0.0 ? lo_c : a, un_b = g > 0.0 ? b : lo_c;
  double unclamped = g == 0.0
      ? r.t_step * n0
      : (n0 / safe_g) * exp(safe_g * (un_a - r.t0)) *
            expm1(safe_g * (un_b - un_a));
  double integral = clamped * r.min_pop + unclamped;
  if (g == 0.0 && r.min_pop > 0.0) integral = r.t_step * fmax(r.min_pop, n0);
  return integral;
}

// true where the clamp does not reach cell [a, b]: the cell is one exp piece
__device__ __forceinline__ bool unclamped_cell(double a, double tc, double g,
                                               double t_step) {
  double b = a + t_step;
  double lo_c = fmin(fmax(tc, a), b);
  return g > 0.0 ? lo_c == a : (g < 0.0 && lo_c == b);
}

__device__ __forceinline__ double quad_term(double integral, double k2,
                                            double t_step) {
  double nbar = fmax(integral / t_step, TINY);
  return 0.5 * t_step * k2 / nbar;
}

// Full evaluation at (n0, g); returns -log prior and fills `gc` for g.
__device__ double eval_full(double n0, double g, const Grid& r, GCache& gc,
                            double* red, int& parity) {
  const double tc = crossing(n0, g, r);
  const double ng = n0 / g;
  double s = 0.0, Hs = 0.0, nb_min = INFINITY;
  for (int c = threadIdx.x; c < r.C; c += THREADS) {
    double a = r.lbs[c], b = a + r.t_step;
    double ec = exp(g * (a - r.t0)), mc = expm1(g * (b - a));
    gc.e[c] = ec;
    gc.m[c] = mc;
    if (g == 0.0) {
      s += quad_term(cell_integral(a, tc, n0, g, r), r.k2[c], r.t_step);
      continue;
    }
    // the cell as one exp piece: its term, and what the fold needs
    double nb = ((ng * ec) * mc) / r.t_step;
    double term_un = 0.5 * r.t_step * r.k2[c] / fmax(nb, TINY);
    s += unclamped_cell(a, tc, g, r.t_step)
        ? term_un
        : quad_term(cell_integral(a, tc, n0, g, r), r.k2[c], r.t_step);
    Hs += term_un;
    nb_min = fmin(nb_min, nb);
  }
  const double ln0 = log(n0);
  double X = 0.0, x_min = INFINITY;
  for (int i = threadIdx.x; i < r.N; i += THREADS) {
    if (!r.inner[i]) continue;
    double x = g * (r.t[i] - r.t0);
    s += fmax(r.log_min_pop, ln0 + x);
    X += x;
    x_min = fmin(x_min, x);
  }
  double v[5] = {s, X, Hs, x_min, nb_min};
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
__device__ double eval_n0(double n0, double g, const Grid& r,
                          const GCache& gc, double n_inner, double a_min,
                          double b_max, double* red, int& parity,
                          int& per_cell) {
  const double tc = crossing(n0, g, r);
  const double ln0 = log(n0);
  const bool floor_binds = n_inner > 0.0 && ln0 + gc.x_min < r.log_min_pop;
  const bool clamp_outside = g > 0.0 ? tc <= a_min : (g < 0.0 && tc >= b_max);
  if (clamp_outside && n0 * gc.R > 2.0 * TINY && !floor_binds)
    return -(gc.H / n0 + (n_inner * ln0 + gc.X));
  ++per_cell;
  const double ng = n0 / g;
  double s = 0.0;
  for (int c = threadIdx.x; c < r.C; c += THREADS) {
    double a = r.lbs[c];
    double integral = g != 0.0 && unclamped_cell(a, tc, g, r.t_step)
        ? (ng * gc.e[c]) * gc.m[c]
        : cell_integral(a, tc, n0, g, r);
    s += quad_term(integral, r.k2[c], r.t_step);
  }
  if (floor_binds)
    for (int i = threadIdx.x; i < r.N; i += THREADS)
      if (r.inner[i]) s += fmax(r.log_min_pop, ln0 + g * (r.t[i] - r.t0));
  double v[1] = {s};
  block_reduce(v, 1, 0, red, parity);
  return floor_binds ? -v[0] : -(v[0] + (n_inner * ln0 + gc.X));
}

template <bool NODES_GLOBAL>
__global__ void __launch_bounds__(THREADS)
exp_pop_chain_kernel(const double* __restrict__ u, int u_stride, int n_rounds,
                     const double* __restrict__ lbs,
                     const double* __restrict__ k2, int C,
                     const double* __restrict__ t_row,
                     const int* __restrict__ inner, int N,
                     const double* __restrict__ fsc, double alpha,
                     double beta, double g_min, double g_max, double g_mu,
                     double g_scale, int size_enabled, int growth_enabled,
                     double* out) {
  extern __shared__ double smem[];
  double* s_lbs = smem;                    // C
  double* s_k2 = s_lbs + C;                // C
  double* ebuf[2] = {s_k2 + C, s_k2 + 2 * C};      // C each
  double* mbuf[2] = {s_k2 + 3 * C, s_k2 + 4 * C};  // C each
  double* s_u = s_k2 + 5 * C;              // n_rounds x N_LANES
  double* red = s_u + n_rounds * N_LANES;  // 2 x MAX_VALUES x WARPS
  const double* s_t = t_row;                   // N, shared or in place
  const int* s_inner = inner;                  // N
  for (int c = threadIdx.x; c < C; c += THREADS) {
    s_lbs[c] = lbs[c];
    s_k2[c] = k2[c];
  }
  for (int k = threadIdx.x; k < n_rounds * N_LANES; k += THREADS)
    s_u[k] = u[(long)(k / N_LANES) * u_stride + k % N_LANES];
  if constexpr (!NODES_GLOBAL) {
    double* st = red + 2 * MAX_VALUES * WARPS;
    int* si = (int*)(st + N);
    for (int i = threadIdx.x; i < N; i += THREADS) {
      st[i] = t_row[i];
      si[i] = inner[i];
    }
    s_t = st;
    s_inner = si;
  }
  __syncthreads();
  const double min_pop = fsc[2];
  const Grid r{s_lbs, s_k2, s_t, s_inner, C, N, fsc[0], fsc[1], min_pop,
               min_pop > 0.0 ? log(fmax(min_pop, TINY)) : -INFINITY};
  int parity = 0;
  // constants of the chain: inner-node count and the grid's time span
  double v[3] = {0.0, INFINITY, INFINITY};
  for (int i = threadIdx.x; i < N; i += THREADS) v[0] += r.inner[i] ? 1 : 0;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    v[1] = fmin(v[1], r.lbs[c]);
    v[2] = fmin(v[2], -(r.lbs[c] + r.t_step));
  }
  block_reduce(v, 1, 2, red, parity);
  const double n_inner = v[0], a_min = v[1], b_max = -v[2];

  double n0 = fsc[3], g = fsc[4];
  GCache cur{ebuf[0], mbuf[0]}, spare{ebuf[1], mbuf[1]};
  double lp = eval_full(n0, g, r, cur, red, parity);
  // the work done, for a bound counted from it: n0 proposals evaluated per
  // cell (not folded) and g proposals evaluated (inside [g_min, g_max])
  int n0_per_cell = 0, g_evaluated = 0;
  for (int i = 0; i < n_rounds; ++i) {
    const double* ur = s_u + i * N_LANES;
    if (size_enabled) {
      // scale move on n0, Inverse-Gamma(alpha, beta) prior
      double scale = 0.75 + ur[U_SCALE] * (1.0 / 0.75 - 0.75);
      double new_n0 = n0 * scale;
      double lpr = -(alpha + 1.0) * log(scale) - beta * (1.0 / new_n0 - 1.0 / n0);
      double new_lp = eval_n0(new_n0, g, r, cur, n_inner, a_min, b_max, red,
                              parity, n0_per_cell);
      double log_mh = (new_lp - lp) + lpr - log(scale);
      if (log_mh > 0.0 || log(fmax(ur[U_ACC_N0], TINY)) < log_mh) {
        n0 = new_n0;
        lp = new_lp;
      }
    }
    if (growth_enabled) {
      // random-walk move on g, truncated Laplace prior
      double delta = (2.0 * ur[U_DELTA] - 1.0) * (1.0 / 365.0);
      double new_g = g + delta;
      if (new_g >= g_min && new_g <= g_max) {
        double lpr = (fabs(g - g_mu) - fabs(new_g - g_mu)) / g_scale;
        double new_lp = eval_full(n0, new_g, r, spare, red, parity);
        ++g_evaluated;
        double log_mh = (new_lp - lp) + lpr;
        if (log_mh > 0.0 || log(fmax(ur[U_ACC_G], TINY)) < log_mh) {
          g = new_g;
          lp = new_lp;
          GCache t = cur;
          cur = spare;
          spare = t;
        }
      }
    }
  }
  if (threadIdx.x == 0) {
    out[0] = n0;
    out[1] = g;
    out[2] = n0_per_cell;
    out[3] = g_evaluated;
  }
}

// N: the nodes whose rows are in shared memory (0 for NODES_GLOBAL)
size_t smem_bytes(int C, int n_rounds, int N) {
  return (size_t)(6 * C + N_LANES * n_rounds + 2 * MAX_VALUES * WARPS + N) *
             sizeof(double) +
         (size_t)N * sizeof(int);
}

template <bool NODES_GLOBAL>
int launch(const double* u, int u_stride, int n_rounds, const double* lbs,
           const double* k2, int C, const double* t_row, const int* inner,
           int N, const double* fsc, double alpha, double beta, double g_min,
           double g_max, double g_mu, double g_scale, int size_enabled,
           int growth_enabled, double* out, void* stream) {
  size_t smem = smem_bytes(C, n_rounds, NODES_GLOBAL ? 0 : N);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        exp_pop_chain_kernel<NODES_GLOBAL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  exp_pop_chain_kernel<NODES_GLOBAL>
      <<<1, THREADS, smem, (cudaStream_t)stream>>>(
          u, u_stride, n_rounds, lbs, k2, C, t_row, inner, N, fsc, alpha,
          beta, g_min, g_max, g_mu, g_scale, size_enabled, growth_enabled,
          out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int delphy_exp_pop_chain(
    const double* u, int u_stride, int n_rounds, const double* lbs,
    const double* k2, int C, const double* t_row, const int* inner, int N,
    const double* fsc, double alpha, double beta, double g_min, double g_max,
    double g_mu, double g_scale, int size_enabled, int growth_enabled,
    double* out, void* stream) {
  auto go = smem_bytes(C, n_rounds, N) <= 227 * 1024 ? launch<false>
                                                     : launch<true>;
  return go(u, u_stride, n_rounds, lbs, k2, C, t_row, inner, N, fsc, alpha,
            beta, g_min, g_max, g_mu, g_scale, size_enabled, growth_enabled,
            out, stream);
}

// whether the node rows of N nodes live in shared memory (1) or are read
// in place (0) at C cells and n_rounds rounds
extern "C" int delphy_exp_pop_chain_nodes_shared(int C, int n_rounds, int N) {
  return smem_bytes(C, n_rounds, N) <= 227 * 1024 ? 1 : 0;
}

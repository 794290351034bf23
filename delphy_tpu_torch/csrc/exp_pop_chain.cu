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
// bytes are a few KB.
// Design: one block of 256 threads keeps the cell and node rows in shared
// memory, evaluates each proposal as one block-wide tree reduction, and
// every thread then takes the same accept decision on the broadcast sums, so
// no thread waits on another for the chain state.  The start state and grid
// scalars are read from device memory, so the host never synchronises.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr double TINY = 1e-30;
// uniform lane assignment per round (pop_pallas.py _U_*)
constexpr int U_SCALE = 0, U_ACC_N0 = 1, U_DELTA = 2, U_ACC_G = 3;

struct Rows {
  const double* lbs;
  const double* k2;
  const double* t;
  const int* inner;
  int C, N;
  double t_step, t0, min_pop;
};

// Coalescent log prior for fixed k_bar: sum over cells of the exp-pop
// integral with the min_pop floor (pop.exp_pop_integral, reference
// pop_model.cpp:43-91) plus the -log N(t) point terms of inner nodes.
// Every thread returns the block total.
__device__ double block_lp(const Rows& r, double n0, double g, double* red) {
  const double log_min_pop =
      r.min_pop > 0.0 ? log(fmax(r.min_pop, TINY)) : -INFINITY;
  const double safe_g = g == 0.0 ? 1.0 : g;
  double tc = r.t0 + log(fmax(r.min_pop, TINY) / n0) / safe_g;
  if (r.min_pop <= 0.0 || g == 0.0) tc = g > 0.0 ? -INFINITY : INFINITY;
  double quad = 0.0, logn = 0.0;
  for (int c = threadIdx.x; c < r.C; c += blockDim.x) {
    double a = r.lbs[c], b = a + r.t_step;
    double lo_c = fmin(fmax(tc, a), b);
    double clamped = g > 0.0 ? lo_c - a : b - lo_c;
    double un_a = g > 0.0 ? lo_c : a, un_b = g > 0.0 ? b : lo_c;
    double unclamped = g == 0.0
        ? r.t_step * n0
        : (n0 / safe_g) * exp(safe_g * (un_a - r.t0)) *
              expm1(safe_g * (un_b - un_a));
    double integral = clamped * r.min_pop + unclamped;
    if (g == 0.0 && r.min_pop > 0.0) integral = r.t_step * fmax(r.min_pop, n0);
    double nbar = fmax(integral / r.t_step, TINY);
    quad += 0.5 * r.t_step * r.k2[c] / nbar;
  }
  for (int i = threadIdx.x; i < r.N; i += blockDim.x)
    if (r.inner[i]) logn += fmax(log_min_pop, log(n0) + g * (r.t[i] - r.t0));
  red[threadIdx.x] = quad;
  red[blockDim.x + threadIdx.x] = logn;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      red[threadIdx.x] += red[threadIdx.x + s];
      red[blockDim.x + threadIdx.x] += red[blockDim.x + threadIdx.x + s];
    }
    __syncthreads();
  }
  double total = -red[0] - red[blockDim.x];
  __syncthreads();  // red is reused by the next call
  return total;
}

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
  double* s_lbs = smem;
  double* s_k2 = s_lbs + C;
  double* s_t = s_k2 + C;
  double* red = s_t + N;                       // 2 * blockDim.x
  int* s_inner = (int*)(red + 2 * blockDim.x);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    s_lbs[c] = lbs[c];
    s_k2[c] = k2[c];
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    s_t[i] = t_row[i];
    s_inner[i] = inner[i];
  }
  __syncthreads();
  Rows r{s_lbs, s_k2, s_t, s_inner, C, N, fsc[0], fsc[1], fsc[2]};
  double n0 = fsc[3], g = fsc[4];
  double lp = block_lp(r, n0, g, red);
  for (int i = 0; i < n_rounds; ++i) {
    const double* ur = u + (long)i * u_stride;
    if (size_enabled) {
      // scale move on n0, Inverse-Gamma(alpha, beta) prior
      double scale = 0.75 + ur[U_SCALE] * (1.0 / 0.75 - 0.75);
      double new_n0 = n0 * scale;
      double lpr = -(alpha + 1.0) * log(scale) - beta * (1.0 / new_n0 - 1.0 / n0);
      double new_lp = block_lp(r, new_n0, g, red);
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
      bool ok = new_g >= g_min && new_g <= g_max;
      double lpr = (fabs(g - g_mu) - fabs(new_g - g_mu)) / g_scale;
      double new_lp = block_lp(r, n0, new_g, red);
      double log_mh = (new_lp - lp) + lpr;
      if (ok && (log_mh > 0.0 || log(fmax(ur[U_ACC_G], TINY)) < log_mh)) {
        g = new_g;
        lp = new_lp;
      }
    }
  }
  if (threadIdx.x == 0) {
    out[0] = n0;
    out[1] = g;
  }
}

}  // namespace

extern "C" int delphy_exp_pop_chain(
    const double* u, int u_stride, int n_rounds, const double* lbs,
    const double* k2, int C, const double* t_row, const int* inner, int N,
    const double* fsc, double alpha, double beta, double g_min, double g_max,
    double g_mu, double g_scale, int size_enabled, int growth_enabled,
    double* out, void* stream) {
  size_t smem = (size_t)(2 * C + N + 2 * THREADS) * sizeof(double) +
                (size_t)N * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        exp_pop_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  exp_pop_chain_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      u, u_stride, n_rounds, lbs, k2, C, t_row, inner, N, fsc, alpha, beta,
      g_min, g_max, g_mu, g_scale, size_enabled, growth_enabled, out);
  return (int)cudaGetLastError();
}

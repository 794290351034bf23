// HKY pseudo-Gibbs chain: n_rounds x (frequency delta-exchange, kappa scale
// move) in one launch.
//
// Replaces: delphy_tpu/parallel/hky_pallas.py hky_chain_pallas (chain body
// _chain_rows), the TPU kernel behind mcmc/kernel.py's 10-round HKY moves
// (reference core/run.cpp:714-719, 953-1103).
//
// What bounds it on the card: nothing but launch latency.  The state is a
// 4-vector and two 4x4 matrices and each of the 20 MH steps depends on the
// previous one, so there is no parallelism to spread over threads.
// Design: one block of one thread runs the serial chain in f64 registers;
// the only memory traffic is the (n_rounds, stride) uniforms and a few
// hundred bytes of statistics.  mu and kappa0 are read from device memory,
// so the host never synchronises to launch it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// uniform lane assignment per round (hky_pallas.py _U_*)
constexpr int U_D = 0, U_IA = 1, U_IB = 2, U_ACC_F = 3, U_SCALE = 4,
              U_ACC_K = 5;
constexpr double TINY = 1e-30;

// HKY85 rate matrix normalised as in evo.hky_q (core/evo_hky.cpp:7-50)
__device__ void hky_q(double kappa, const double* pi, double* q) {
  double r[16];
  for (int a = 0; a < 4; ++a)
    for (int b = 0; b < 4; ++b) {
      bool transition = (a != b) && (a % 2 == b % 2);
      bool transversion = (a % 2) != (b % 2);
      r[a * 4 + b] = (transition ? kappa : 0.0) + (transversion ? 1.0 : 0.0);
    }
  double R = 0.0;
  for (int a = 0; a < 4; ++a)
    for (int b = 0; b < 4; ++b) R += pi[a] * r[a * 4 + b] * pi[b];
  for (int a = 0; a < 4; ++a) {
    double rowsum = 0.0;
    for (int b = 0; b < 4; ++b) {
      q[a * 4 + b] = r[a * 4 + b] * pi[b] / R;
      rowsum += q[a * 4 + b];
    }
    q[a * 4 + a] -= rowsum;
  }
}

// -mu sum_a (new_qa - old_qa) Ttwiddle_a + sum_{a!=b, M>0} M log(new_q/old_q)
__device__ double delta_of(const double* new_q, const double* old_q,
                           double mu, const double* tt, const double* M) {
  double d = 0.0;
  for (int a = 0; a < 4; ++a)
    d += (-new_q[a * 5] + old_q[a * 5]) * tt[a];
  d = -mu * d;
  double s = 0.0;
  for (int a = 0; a < 4; ++a)
    for (int b = 0; b < 4; ++b) {
      int k = a * 4 + b;
      if (a == b || !(M[k] > 0.0)) continue;
      double ratio = old_q[k] > 0.0 ? new_q[k] / old_q[k] : 1.0;
      s += M[k] * log(ratio);
    }
  return d + s;
}

__global__ void hky_chain_kernel(const double* __restrict__ u, int u_stride,
                                 int n_rounds, const double* __restrict__ fsc,
                                 const double* __restrict__ pi0,
                                 const double* __restrict__ tt,
                                 const double* __restrict__ M,
                                 const double* __restrict__ rf,
                                 double kappa_m, double kappa_s,
                                 double* kappa_out, double* pi_out,
                                 double* q_out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const double mu = fsc[0];
  double kappa = fsc[1];
  double pi[4], q[16], new_pi[4], safe_pi[4], new_q[16];
  for (int a = 0; a < 4; ++a) pi[a] = pi0[a];
  hky_q(kappa, pi, q);
  for (int i = 0; i < n_rounds; ++i) {
    const double* ur = u + (long)i * u_stride;
    {  // frequency delta-exchange
      double d = ur[U_D] * 0.01;
      int ia = (int)floor(ur[U_IA] * 4.0);
      int ib = (ia + 1 + (int)floor(ur[U_IB] * 3.0)) % 4;
      double pia = 0.0, pib = 0.0;
      for (int a = 0; a < 4; ++a) {
        new_pi[a] = pi[a] + (a == ia ? d : 0.0) - (a == ib ? d : 0.0);
        if (a == ia) pia = new_pi[a];
        if (a == ib) pib = new_pi[a];
        safe_pi[a] = new_pi[a] > 0.0 ? new_pi[a] : 1.0;
      }
      bool ok = pia > 0.0 && pia < 1.0 && pib > 0.0 && pib < 1.0;
      hky_q(kappa, safe_pi, new_q);
      double delta = delta_of(new_q, q, mu, tt, M);
      double rsum = 0.0;
      for (int a = 0; a < 4; ++a)
        if (rf[a] > 0.0) rsum += rf[a] * log(safe_pi[a] / pi[a]);
      delta += rsum;
      bool acc = ok && (delta > 0.0 || log(fmax(ur[U_ACC_F], TINY)) < delta);
      if (acc) {
        for (int a = 0; a < 4; ++a) pi[a] = new_pi[a];
        for (int k = 0; k < 16; ++k) q[k] = new_q[k];
      }
    }
    {  // kappa scale move, log-normal prior
      double scale = 0.75 + ur[U_SCALE] * (1.0 / 0.75 - 0.75);
      double new_kappa = kappa * scale;
      hky_q(new_kappa, pi, new_q);
      double lk_new = log(new_kappa) - kappa_m, lk_old = log(kappa) - kappa_m;
      double lpr = (-lk_new * lk_new + lk_old * lk_old) /
                       (2.0 * kappa_s * kappa_s) + log(kappa / new_kappa);
      double log_mh = delta_of(new_q, q, mu, tt, M) + lpr +
                      log(kappa / new_kappa);
      bool acc = log_mh > 0.0 || log(fmax(ur[U_ACC_K], TINY)) < log_mh;
      if (acc) {
        kappa = new_kappa;
        for (int k = 0; k < 16; ++k) q[k] = new_q[k];
      }
    }
  }
  kappa_out[0] = kappa;
  for (int a = 0; a < 4; ++a) pi_out[a] = pi[a];
  for (int k = 0; k < 16; ++k) q_out[k] = q[k];
}

}  // namespace

extern "C" int delphy_hky_chain(const double* u, int u_stride, int n_rounds,
                                const double* fsc, const double* pi0,
                                const double* tt, const double* M,
                                const double* rf, double kappa_m,
                                double kappa_s, double* kappa_out,
                                double* pi_out, double* q_out,
                                void* stream) {
  hky_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      u, u_stride, n_rounds, fsc, pi0, tt, M, rf, kappa_m, kappa_s, kappa_out,
      pi_out, q_out);
  return (int)cudaGetLastError();
}

extern "C" const char* delphy_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

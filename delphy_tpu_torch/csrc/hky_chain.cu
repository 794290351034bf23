// HKY pseudo-Gibbs chain: n_rounds x (frequency delta-exchange, kappa scale
// move) in one launch of one warp.
//
// Replaces: delphy_tpu/parallel/hky_pallas.py hky_chain_pallas (chain body
// _chain_rows), the TPU kernel behind mcmc/kernel.py's 10-round HKY moves
// (reference core/run.cpp:714-719, 953-1103).
//
// What bounds it on the card: neither bytes (a few hundred) nor operations
// (a few thousand), but the dependent f64 latency of its 2 n_rounds MH
// steps, each of which waits on the previous accept decision, plus the
// launch.  On the H100 an f64 log takes ~410 cycles of latency, a log1p
// ~300 and a division ~400, and one thread's transcendentals barely overlap
// (their branches keep them apart), so the design spreads them over lanes.
//
// The folded chain.  For HKY an off-diagonal rate is q_ab = r_ab pi_b / R,
// r_ab = kappa for a transition (A<->G, C<->T) and 1 for a transversion,
// R = 2 kappa (pi_A pi_G + pi_C pi_T) + 2 (pi_A + pi_G)(pi_C + pi_T).  The
// log-likelihood ratio over the entries with M_ab > 0 then folds to a few
// logs:
//   frequency move (only pi_ia, pi_ib change):
//     sum M_ab log(q'_ab/q_ab) + sum_{rf_b > 0} rf_b log(pi'_b/pi_b)
//       = W_ia log(pi'_ia/pi_ia) + W_ib log(pi'_ib/pi_ib) - M_tot log(R'/R),
//     W_b = sum_{a != b, M_ab > 0} M_ab + max(rf_b, 0),
//     M_tot = sum_{a != b, M_ab > 0} M_ab;
//   kappa move (pi fixed):
//     sum M_ab log(q'_ab/q_ab) = M_ts log(kappa'/kappa) - M_tot log(R'/R),
//     M_ts the part of M_tot on transitions, log(kappa'/kappa) = log(scale).
// The diagonal term -mu sum_a (q'_a - q_a) Ttwiddle_a (q_a = -q_aa) is
// -mu (D'/R' - D/R), D = sum_a Ttwiddle_a sum_{b != a} r_ab pi_b = kappa Tk +
// Dz, with Tk and Dz functions of pi.  So the chain's state is (kappa,
// log kappa, pi); R and D follow from it, and q is built once at the end.
// The fold is exact algebra only where every q_ab > 0, i.e. kappa > 0 and
// every pi_b > 0; an accepted frequency move keeps pi_ia, pi_ib in (0, 1),
// so a chain that starts there stays there.  Where kappa0 or an entry of
// pi0 is not positive and finite, lane 0 runs the per-entry formula of the
// plain version (4x4 rate matrices, one log per rate ratio) step by step
// instead: hky_cuda.kernel_path names the path for given inputs.
//
// Design, against what the single-thread version spent its time on:
// - One warp.  The lanes load the statistics once (one value a lane) and
//   reduce W, M_tot and M_ts with shuffles.  Then, 32 rounds at a time,
//   everything that does not depend on the chain state is computed across
//   the lanes into shared memory: ia, ib, d, W_ia, W_ib and scale one lane a
//   round, and log(scale) and log(max(u, TINY)) of both accept tests one
//   lane a log.  No device-memory read and no accept-test log remains
//   inside the chain.
// - No 4x4 rate matrix per proposal (two per round, 16 divisions each) and
//   no per-entry ratio logs (up to 12 per ratio, 4 more for the root
//   frequencies): a frequency step needs three logs (log1p of +-d / pi_i
//   and of R'/R - 1), a kappa step one (R'/R - 1); the kappa prior uses the
//   carried log kappa instead of log(kappa'), log(kappa) and
//   log(kappa/kappa') twice.
// - Speculation over two rounds at a time (four MH steps F, K, F, K): the
//   state before a step is a cheap function of the earlier steps' accept
//   bits (an accepted frequency move adds +-d to two entries, a kappa move
//   multiplies kappa by scale), so lanes 0-14 each take one node of the
//   decision tree (level j = the step, the j bits = the decisions before
//   it) and evaluate that step's proposal from that state; lanes 15-24
//   compute the two log1p(+-d / pi) of the five frequency nodes.  Every
//   lane runs the same instructions (one reciprocal, by the hardware's
//   approximation and two Newton steps, and one log1p), so the four steps
//   cost about one step's latency; a ballot then gives every lane all 15
//   decisions, each walks the tree to the ones actually taken, and the
//   state comes by shuffle from the node of the last step taken.
//   Measured (clock64, NVIDIA H100 80GB HBM3, 700.00 W): ~1,850 cycles a
//   batch against ~5,200 for four steps on one lane.
// - The signs, the double Hastings term of the kappa move (lpr holds
//   log(kappa/kappa') and log_mh adds it again, as in hky_pallas.py) and
//   the `ok` guard of the frequency move are the plain version's.
// pi and kappa are updated with the plain version's arithmetic, in the same
// order, and q is built by 16 lanes with hky_q's arithmetic, so where the
// accept decisions agree the outputs are bit-equal to the per-entry chain's.

// Precision: a template on `real` (real.cuh).  delphy_hky_chain is the
// float64 build; delphy_hky_chain_f32 the float32 one, the TPU kernel's own
// precision, with logf/log1pf and a correctly rounded float reciprocal.
#include "real.cuh"

namespace {

using namespace delphy_real;

// uniform lane assignment per round (hky_pallas.py _U_*)
constexpr int U_D = 0, U_IA = 1, U_IB = 2, U_ACC_F = 3, U_SCALE = 4,
              U_ACC_K = 5;
constexpr double TINY = 1e-30;
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
// speculation: a batch is two rounds, four MH steps (F, K, F, K), a tree of
// 15 nodes; the frequency nodes are 0 and 3-6, their log1p(d / pi_ia)
// lanes 15-19 and their log1p(-d / pi_ib) lanes 20-24
constexpr int LEVELS = 4, NODES = 15, F_NODES = 5;
constexpr int HELP_A = NODES, HELP_B = NODES + F_NODES;

// What a round needs that does not depend on the chain state.
template <class real>
struct Round {
  real d, w_ia, w_ib, scale, lsc, lacc_f, lacc_k;
  int ia, ib;
};

template <class real>
struct Stats {
  real mu, tt[4], M[16], rf[4];
  real w[4], m_tot, m_ts;  // the folded weights
  real kappa_m, kappa_s, inv_2s2;  // inv_2s2 = 1 / (2 kappa_s^2)
};

template <class real>
__device__ real pick(const real* v, int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : i == 3 ? v[3]
                                                                : real(0);
}

// HKY85 rate matrix normalised as in evo.hky_q (core/evo_hky.cpp:7-50)
template <class real>
__device__ real hky_r(real kappa, int a, int b) {
  bool transition = (a != b) && (a % 2 == b % 2);
  bool transversion = (a % 2) != (b % 2);
  return (transition ? kappa : real(0)) + (transversion ? real(1) : real(0));
}

template <class real>
__device__ real hky_R(real kappa, const real* pi) {
  real R = real(0);
  for (int a = 0; a < 4; ++a)
    for (int b = 0; b < 4; ++b) R += pi[a] * hky_r(kappa, a, b) * pi[b];
  return R;
}

template <class real>
__device__ void hky_q(real kappa, const real* pi, real* q) {
  const real R = hky_R(kappa, pi);
  for (int a = 0; a < 4; ++a) {
    real rowsum = real(0);
    for (int b = 0; b < 4; ++b) {
      q[a * 4 + b] = hky_r(kappa, a, b) * pi[b] / R;
      rowsum += q[a * 4 + b];
    }
    q[a * 4 + a] -= rowsum;
  }
}

// hky_q's entry (a, b) = (lane / 4, lane % 4) of lanes 0-15, in the same
// arithmetic; every lane of the warp must call it.
template <class real>
__device__ real hky_q_entry(real kappa, const real* pi, int lane) {
  const int a = (lane >> 2) & 3, b = lane & 3;
  const real q = hky_r(kappa, a, b) * pick(pi, b) / hky_R(kappa, pi);
  real rowsum = real(0);
  for (int c = 0; c < 4; ++c)
    rowsum += __shfl_sync(FULL, q, (lane & ~3) + c);
  return a == b ? q - rowsum : q;
}

// 1 / x to within an ulp or two, without the division's slow-path branch:
// the hardware's approximate reciprocal and two Newton steps (float64); the
// correctly rounded reciprocal (float32).
__device__ double rcp(double x) {
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  y = fma(y, fma(-x, y, 1.0), y);
  return fma(y, fma(-x, y, 1.0), y);
}

__device__ float rcp(float x) { return __frcp_rn(x); }

// The frequency proposal's new pi, in the plain version's arithmetic.
template <class real>
__device__ void propose_pi(const real* p, const Round<real>& o, real* np) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
    np[a] = p[a] + (a == o.ia ? o.d : real(0)) - (a == o.ib ? o.d : real(0));
}

// ---------------------------------------------------------------------------
// The folded chain (every q_ab > 0), speculated over the lanes
// ---------------------------------------------------------------------------

template <class real>
struct Chain {
  real kappa, logk, p[4];
};

// R and D of (kappa, p)
template <class real>
__device__ void r_and_d(real kappa, const real* p, const real* tt, real& R,
                        real& D) {
  const real y = p[0] + p[2], z = p[1] + p[3];
  R = real(2) * (kappa * (p[0] * p[2] + p[1] * p[3]) + y * z);
  D = kappa * (tt[0] * p[2] + tt[2] * p[0] + tt[1] * p[3] + tt[3] * p[1]) +
      (tt[0] + tt[2]) * z + (tt[1] + tt[3]) * y;
}

// The state after the first `steps` steps of the batch from rounds[r0],
// step i taken where bit i of `bits` is set.  No branch: every lane runs
// the same instructions.
template <class real>
__device__ Chain<real> advance(Chain<real> c, const Round<real>* rounds,
                               int r0, int steps, int bits) {
#pragma unroll
  for (int i = 0; i < LEVELS; ++i) {
    const Round<real>& o = rounds[r0 + i / 2];
    const bool take = i < steps && ((bits >> i) & 1);
    if (i % 2 == 0) {
      real np[4];
      propose_pi(c.p, o, np);
#pragma unroll
      for (int a = 0; a < 4; ++a) c.p[a] = take ? np[a] : c.p[a];
    } else {
      c.kappa = take ? c.kappa * o.scale : c.kappa;
      c.logk = take ? c.logk + o.lsc : c.logk;
    }
  }
  return c;
}

// One batch of `levels` (2 or 4) steps from rounds[r0]: every lane ends
// with the state after the steps taken.
template <class real>
__device__ void folded_batch(Chain<real>& c, const Round<real>* rounds,
                             int r0, int levels, const Stats<real>& s) {
  const int lane = threadIdx.x;
  const int nodes = (1 << levels) - 1;
  // this lane's node: its own for lanes 0-14, the frequency node whose
  // log1p it computes for lanes 15-24 (lanes 25-31 compute for nothing)
  const int fi = lane >= HELP_B ? lane - HELP_B : lane - HELP_A;
  const int node = lane < NODES ? lane : (fi == 0 ? 0 : fi + 2);
  const int level = 31 - __clz(node + 1);
  const int bits = node + 1 - (1 << level);
  const Chain<real> at = advance(c, rounds, r0, level, bits);
  const Round<real>& o = rounds[r0 + level / 2];
  const bool freq = level % 2 == 0;

  real np[4];
  propose_pi(at.p, o, np);
  const real pia = pick(np, o.ia), pib = pick(np, o.ib);
  const bool ok = pia > real(0) && pia < real(1) && pib > real(0) &&
                  pib < real(1);
  const real kappa = freq ? at.kappa : at.kappa * o.scale;
  real R, D, R1, D1;
  r_and_d(at.kappa, at.p, s.tt, R, D);
  r_and_d(kappa, freq ? np : at.p, s.tt, R1, D1);
  // one division and one log1p a lane: (R' - R) / R on the node lanes,
  // +-d / pi_ia, pi_ib on the helper lanes
  real num = (R1 - R) * R1, den = R * R1;
  if (lane >= HELP_A) {
    num = lane < HELP_B ? o.d : -o.d;
    den = lane < HELP_B ? pick(at.p, o.ia) : pick(at.p, o.ib);
  }
  const real inv = rcp(den);
  const real lg = r_log1p(num * inv);
  const real diag = (D1 * R - D * R1) * inv;     // D'/R' - D/R
  const int src = node == 0 ? 0 : min(max(node - 2, 0), F_NODES - 1);
  const real la = __shfl_sync(FULL, lg, HELP_A + src);
  const real lb = __shfl_sync(FULL, lg, HELP_B + src);

  const real delta = o.w_ia * la + o.w_ib * lb - s.m_tot * lg - s.mu * diag;
  const real lk_new = at.logk + o.lsc - s.kappa_m;
  const real lk_old = at.logk - s.kappa_m;
  const real lpr = (-lk_new * lk_new + lk_old * lk_old) * s.inv_2s2 - o.lsc;
  const real log_mh = s.m_ts * o.lsc - s.m_tot * lg - s.mu * diag + lpr -
                      o.lsc;
  const bool acc_f = ok && (delta > real(0) || o.lacc_f < delta);
  const bool acc_k = log_mh > real(0) || o.lacc_k < log_mh;
  const unsigned acc = __ballot_sync(FULL, lane < nodes && (freq ? acc_f
                                                                 : acc_k));
  // walk the tree: the decision of step i is that of node 2^i - 1 + bits
  int taken = 0;
  for (int i = 0; i < levels; ++i)
    taken |= ((acc >> ((1 << i) - 1 + taken)) & 1) << i;
  // the state after the batch: that of the last step's node, with that
  // (kappa) step applied where it was taken
  const int half = 1 << (levels - 1);
  const int last = half - 1 + (taken & (half - 1));
  const Round<real>& ol = rounds[r0 + (levels - 1) / 2];
  const bool take = (taken >> (levels - 1)) & 1;
  const real kappa_l = __shfl_sync(FULL, at.kappa, last);
  const real logk_l = __shfl_sync(FULL, at.logk, last);
  c.kappa = take ? kappa_l * ol.scale : kappa_l;
  c.logk = take ? logk_l + ol.lsc : logk_l;
#pragma unroll
  for (int a = 0; a < 4; ++a) c.p[a] = __shfl_sync(FULL, at.p[a], last);
}

// ---------------------------------------------------------------------------
// The per-entry chain (kappa0 or an entry of pi0 not positive and finite)
// ---------------------------------------------------------------------------

template <class real>
struct PerEntry {
  real kappa, pi[4], q[16];
};

// -mu sum_a (new_qa - old_qa) Ttwiddle_a + sum_{a!=b, M>0} M log(new_q/old_q)
template <class real>
__device__ real delta_of(const real* new_q, const real* old_q,
                         const Stats<real>& s) {
  real d = real(0);
  for (int a = 0; a < 4; ++a)
    d += (-new_q[a * 5] + old_q[a * 5]) * s.tt[a];
  d = -s.mu * d;
  real sum = real(0);
  for (int a = 0; a < 4; ++a)
    for (int b = 0; b < 4; ++b) {
      int k = a * 4 + b;
      if (a == b || !(s.M[k] > real(0))) continue;
      real ratio = old_q[k] > real(0) ? new_q[k] / old_q[k] : real(1);
      sum += s.M[k] * r_log(ratio);
    }
  return d + sum;
}

template <class real>
__device__ void per_entry_round(PerEntry<real>& e, const Round<real>& o,
                                const Stats<real>& s) {
  real new_pi[4], safe_pi[4], new_q[16];
  {  // frequency delta-exchange
    propose_pi(e.pi, o, new_pi);
    const real pia = pick(new_pi, o.ia), pib = pick(new_pi, o.ib);
    for (int a = 0; a < 4; ++a)
      safe_pi[a] = new_pi[a] > real(0) ? new_pi[a] : real(1);
    bool ok = pia > real(0) && pia < real(1) && pib > real(0) &&
              pib < real(1);
    hky_q(e.kappa, safe_pi, new_q);
    real delta = delta_of(new_q, e.q, s);
    real rsum = real(0);
    for (int a = 0; a < 4; ++a)
      if (s.rf[a] > real(0)) rsum += s.rf[a] * r_log(safe_pi[a] / e.pi[a]);
    delta += rsum;
    if (ok && (delta > real(0) || o.lacc_f < delta)) {
      for (int a = 0; a < 4; ++a) e.pi[a] = new_pi[a];
      for (int k = 0; k < 16; ++k) e.q[k] = new_q[k];
    }
  }
  {  // kappa scale move, log-normal prior
    real new_kappa = e.kappa * o.scale;
    hky_q(new_kappa, e.pi, new_q);
    real lk_new = r_log(new_kappa) - s.kappa_m;
    real lk_old = r_log(e.kappa) - s.kappa_m;
    real lpr = (-lk_new * lk_new + lk_old * lk_old) /
                   (real(2) * s.kappa_s * s.kappa_s) +
               r_log(e.kappa / new_kappa);
    real log_mh = delta_of(new_q, e.q, s) + lpr + r_log(e.kappa / new_kappa);
    if (log_mh > real(0) || o.lacc_k < log_mh) {
      e.kappa = new_kappa;
      for (int k = 0; k < 16; ++k) e.q[k] = new_q[k];
    }
  }
}

// ---------------------------------------------------------------------------

// Lane r < n loads the uniforms of round base + r, n <= 32.
template <class real>
__device__ void load_rows(const real* __restrict__ u, int u_stride, int base,
                          int n, real* row) {
  const int lane = threadIdx.x;
  for (int k = 0; k < 6; ++k)
    row[k] = lane < n ? u[(long)(base + lane) * u_stride + k] : real(0.5);
}

// The state-free values of the n rounds in `row` into `rounds`: lane r < n
// its round's proposal, then the 3 n logs one lane a log.
template <class real>
__device__ void prepare_rounds(const real* row, int n, const Stats<real>& s,
                               Round<real>* rounds) {
  const int lane = threadIdx.x;
  const real sc_w = real(1.0 / 0.75 - 0.75);
  if (lane < n) {
    Round<real>& o = rounds[lane];
    o.d = row[U_D] * real(0.01);
    o.ia = (int)r_floor(row[U_IA] * real(4));
    o.ib = (o.ia + 1 + (int)r_floor(row[U_IB] * real(3))) % 4;
    o.w_ia = pick(s.w, o.ia);
    o.w_ib = pick(s.w, o.ib);
    o.scale = real(0.75) + row[U_SCALE] * sc_w;
  }
  for (int t = lane; t - lane < 3 * n; t += WARP) {
    const int kind = t / n, r = t % n;
    const real acc_f = __shfl_sync(FULL, row[U_ACC_F], r);
    const real acc_k = __shfl_sync(FULL, row[U_ACC_K], r);
    const real x = __shfl_sync(FULL, row[U_SCALE], r);
    if (t < 3 * n) {
      const real l = r_log(kind == 0 ? r_max(acc_f, real(TINY))
                           : kind == 1 ? r_max(acc_k, real(TINY))
                                       : real(0.75) + x * sc_w);
      if (kind == 0) rounds[r].lacc_f = l;
      else if (kind == 1) rounds[r].lacc_k = l;
      else rounds[r].lsc = l;
    }
  }
  __syncwarp();
}

template <class real>
__global__ void __launch_bounds__(WARP)
hky_chain_kernel(const real* __restrict__ u, int u_stride, int n_rounds,
                 const real* __restrict__ fsc, const real* __restrict__ pi0,
                 const real* __restrict__ tt, const real* __restrict__ M,
                 const real* __restrict__ rf, real kappa_m, real kappa_s,
                 real* kappa_out, real* pi_out, real* q_out) {
  __shared__ Round<real> rounds[WARP];
  const int lane = threadIdx.x;
  real row[6];
  load_rows(u, u_stride, 0, min(WARP, n_rounds), row);

  // The statistics, one value a lane: M (lanes 0-15), pi0 (16-19), tt
  // (20-23), rf (24-27), mu and kappa0 (28, 29).
  real v = real(0);
  if (lane < 16) v = M[lane];
  else if (lane < 20) v = pi0[lane - 16];
  else if (lane < 24) v = tt[lane - 20];
  else if (lane < 28) v = rf[lane - 24];
  else if (lane < 30) v = fsc[lane - 28];
  Stats<real> s;
  real pi[4];
  for (int k = 0; k < 16; ++k) s.M[k] = __shfl_sync(FULL, v, k);
  for (int a = 0; a < 4; ++a) {
    pi[a] = __shfl_sync(FULL, v, 16 + a);
    s.tt[a] = __shfl_sync(FULL, v, 20 + a);
    s.rf[a] = __shfl_sync(FULL, v, 24 + a);
  }
  s.mu = __shfl_sync(FULL, v, 28);
  const real kappa0 = __shfl_sync(FULL, v, 29);
  s.kappa_m = kappa_m;
  s.kappa_s = kappa_s;
  s.inv_2s2 = real(1) / (real(2) * kappa_s * kappa_s);

  // The folded weights: lane 4a + b < 16 holds M_ab where it counts.
  const int a = (lane >> 2) & 3, b = lane & 3;
  const real m = (lane < 16 && a != b && v > real(0)) ? v : real(0);
  real col = m, ts = (a % 2 == b % 2) ? m : real(0);
  for (int off = 4; off < 16; off <<= 1)
    col += __shfl_xor_sync(FULL, col, off);   // lane b: column sum of b
  real tot = col;
  for (int off = 1; off < 4; off <<= 1)
    tot += __shfl_xor_sync(FULL, tot, off);
  for (int off = 1; off < 16; off <<= 1)
    ts += __shfl_xor_sync(FULL, ts, off);
  for (int c = 0; c < 4; ++c)
    s.w[c] = __shfl_sync(FULL, col, c) +
             (s.rf[c] > real(0) ? s.rf[c] : real(0));
  s.m_tot = __shfl_sync(FULL, tot, 0);
  s.m_ts = __shfl_sync(FULL, ts, 0);

  bool fold = r_isfinite(kappa0) && kappa0 > real(0);
  for (int c = 0; c < 4; ++c)
    fold = fold && r_isfinite(pi[c]) && pi[c] > real(0);

  if (fold) {
    Chain<real> c{kappa0, r_log(kappa0), {pi[0], pi[1], pi[2], pi[3]}};
    for (int base = 0; base < n_rounds; base += WARP) {
      const int n = min(WARP, n_rounds - base);
      if (base > 0) load_rows(u, u_stride, base, n, row);
      prepare_rounds(row, n, s, rounds);
      for (int r0 = 0; r0 < n; r0 += 2)
        folded_batch(c, rounds, r0, min(n - r0, 2) * 2, s);
      __syncwarp();
    }
    const real q = hky_q_entry(c.kappa, c.p, lane);
    if (lane < 16) q_out[lane] = q;
    if (lane == 0) {
      kappa_out[0] = c.kappa;
      for (int k = 0; k < 4; ++k) pi_out[k] = c.p[k];
    }
  } else {
    PerEntry<real> e;
    e.kappa = kappa0;
    for (int c = 0; c < 4; ++c) e.pi[c] = pi[c];
    hky_q(kappa0, pi, e.q);
    for (int base = 0; base < n_rounds; base += WARP) {
      const int n = min(WARP, n_rounds - base);
      if (base > 0) load_rows(u, u_stride, base, n, row);
      prepare_rounds(row, n, s, rounds);
      if (lane == 0)
        for (int j = 0; j < n; ++j) per_entry_round(e, rounds[j], s);
      __syncwarp();
    }
    if (lane == 0) {
      kappa_out[0] = e.kappa;
      for (int k = 0; k < 4; ++k) pi_out[k] = e.pi[k];
      for (int k = 0; k < 16; ++k) q_out[k] = e.q[k];
    }
  }
}

template <class real>
int launch(const real* u, int u_stride, int n_rounds, const real* fsc,
           const real* pi0, const real* tt, const real* M, const real* rf,
           double kappa_m, double kappa_s, real* kappa_out, real* pi_out,
           real* q_out, void* stream) {
  hky_chain_kernel<real><<<1, WARP, 0, (cudaStream_t)stream>>>(
      u, u_stride, n_rounds, fsc, pi0, tt, M, rf, (real)kappa_m,
      (real)kappa_s, kappa_out, pi_out, q_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int delphy_hky_chain(const double* u, int u_stride, int n_rounds,
                                const double* fsc, const double* pi0,
                                const double* tt, const double* M,
                                const double* rf, double kappa_m,
                                double kappa_s, double* kappa_out,
                                double* pi_out, double* q_out,
                                void* stream) {
  return launch(u, u_stride, n_rounds, fsc, pi0, tt, M, rf, kappa_m, kappa_s,
                kappa_out, pi_out, q_out, stream);
}

// the float32 build: every pointer float, kappa_m and kappa_s rounded to
// float
extern "C" int delphy_hky_chain_f32(const float* u, int u_stride,
                                    int n_rounds, const float* fsc,
                                    const float* pi0, const float* tt,
                                    const float* M, const float* rf,
                                    double kappa_m, double kappa_s,
                                    float* kappa_out, float* pi_out,
                                    float* q_out, void* stream) {
  return launch(u, u_stride, n_rounds, fsc, pi0, tt, M, rf, kappa_m, kappa_s,
                kappa_out, pi_out, q_out, stream);
}

extern "C" const char* delphy_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

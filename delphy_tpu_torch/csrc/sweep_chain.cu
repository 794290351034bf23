// Fused sweep-block chain: per part, n_blocks x (single node displacement,
// cell-block-coloured batched displacement, batched branch reform).
//
// Replaces: delphy_tpu/parallel/block_pallas.py sweep_chain_pallas (body
// sweep_chain_part), the TPU kernel of the partitioned local sweep
// (parallel/sweep.py; reference core/subrun.cpp:98-320).
//
// What bounds it on the card: latency of the dependent chain.  Every move
// reads the times the previous move wrote, so a part is a serial string of
// 3 x n_blocks small steps over O(n_cap + m_cap + C) data (about 25 KB at
// Ebola size); parts are independent.  Bytes (each input read once, the
// uniforms included) are well under a microsecond of device memory time and
// the arithmetic a few thousand flops per step.  With the barriers cut to
// five per step, what is left is the latency of each phase's serial f64
// chain in its slowest node: a proposal's expm1/log1p/log and divisions,
// then its loop over cells or slots.
//
// Design: one thread block per part, all of the part's rows resident in
// shared memory for the whole chain, threads over nodes, slots and cells;
// in the batched move, the k_p scatter and the reform a group of GROUP = 4
// lanes takes each node, computes its scalars alike in every lane and
// splits the node's cells or slots over the lanes (4-lane shuffles), so
// a node's loops cost a quarter of their length (4 NC threads, 64 to 512).
// The TPU kernel's dense one-hot masks ((NC,NC), (NC,MC), (NC,C)) become
// index gathers through per-node slot lists, built once per launch (the pool
// is static within a sweep).  A block step has five barriers:
//   single move | B1 | colour-block windows | B2 | batched proposals |
//   B3 | k_p scatter, own block | B4 | k_p margins + reform | B5
// - The single node move runs in warp 0 alone: its bounds come from the
//   per-node own_max / child_min rows, and dq is summed over the cells from
//   cell_of(min(old, new)) - MARGIN to cell_of(max(old, new)) + MARGIN (dk is
//   exactly 0 outside, as in the batched move), with a warp xor-shuffle
//   reduction that leaves the same total in every lane, so all lanes take
//   the same accept decision.  B1 publishes an accepted t / k_p change.
// - The uniforms of block step i + 1 (pri, prop, acc, ref_acc, ref_u, the
//   single-move scalars: 4 NC + MC + 7 doubles per part) are copied into
//   shared memory with cp.async by the warps other than warp 0 while step i
//   runs (double buffer), so no serial section waits on device memory.  Where two stages do not fit in
//   227 KB the kernel keeps one stage and loads it at the start of the step.
// - The segment maximum of the colour-block priorities is one pass over the
//   nodes: a shared-memory atomicMax on the uniform's bit pattern (for
//   doubles >= 0 the unsigned bit order is the numeric order).  A max does
//   not depend on the order of the updates, so the result is deterministic,
//   and ties are selected as in the plain version (pri == best).  The parent
//   veto re-derives the parent's selection from the same rows, so it needs
//   no barrier of its own.
// - k_p is updated by a scatter from each accepted node over its own cells.
//   Race-free because: a node is selected only in the colour segment that
//   holds its current cell, its new time lies inside the segment's window,
//   so its dk can be nonzero only within the segment's cells [F, L] plus
//   MARGIN + 1 cells on either side (cell_of of a time at the window's edge
//   can round one cell out).  With at most one accepted node per segment,
//   the in-segment parts of the writes (B3..B4) are disjoint; the out-of-
//   segment parts (B4..B5) of two segments are disjoint when
//   cpb >= 2 MARGIN + 2, because segment b's upper margin ends at
//   L_b + 1 + MARGIN and segment b + 2's lower margin starts at
//   F_{b+2} - 1 - MARGIN = L_b + cpb - MARGIN.  (The last segment, into
//   which the block index of cells past n_seg cpb is clamped, owns every
//   cell up to C_real - 1.)  Writes skip cells where dk is exactly 0.  A tie
//   (two accepted nodes in one segment, detected with an integer shared
//   atomic) or a smaller cpb takes a per-cell sum over all accepted nodes
//   instead.  No float atomics, so results are deterministic.
// - The reform is one pass over nodes: each node's group proposes for its
//   own slots, decides, writes them, and refreshes the node's own_max /
//   child_min for the next step.
// - dG, dC and the move count are summed per thread across the whole chain
//   and reduced once at the end (warp shuffles, then one shared stage), so
//   no reduction sits inside the chain.
// Summation order differs from the plain version (warp-tree dq, per-thread
// partial sums of dG and dC); accept decisions match.  f64 throughout, with
// expm1/log1p and +-inf.
//
// Rows beyond shared memory (the global build): where even one uniform stage
// does not fit in the 227 KB a block can use (a part of ~1,000 nodes or
// several thousand mutation slots: a P = 1 run, or a large diverse tree),
// the same kernel, built with GLOBAL = true, carves the same layout from its
// part's slice of a workspace in device memory that the wrapper allocates
// (P x delphy_sweep_chain_workspace_bytes).  Only the warp-reduction scratch,
// the segment maxima and the tie and batch counters stay in shared memory
// (their atomics stay shared atomics).  The uniforms are read in place from
// their global arrays (cp.async needs a shared destination), and the kernel
// asks for the smallest shared-memory carve-out, so L1 caches the rows.
// __syncthreads() orders global-memory accesses within a block as it does
// shared ones, so the barriers are the shared build's.  Which build runs is
// a rule on the shapes (stages_for: two stages in shared memory where they
// fit, one where only that fits, the global build beyond), exported as
// delphy_sweep_chain_stages.  The global build is the shared build's
// arithmetic line for line and is not tuned: its time at NC = 1152 is in
// PERF.md.
//
// Population models: the kernel is a template on the model of the -log N(t)
// point terms of inner-node moves.  POP_EXP is the exponential model with
// the min_pop floor (entry delphy_sweep_chain); POP_STAIRCASE and
// POP_LOG_LINEAR are the skygrid's two types (entry
// delphy_sweep_chain_skygrid), whose K = M + 1 knots x_k and log-population
// values gamma_k are loaded into shared memory once per block: log N(t) is
// then a binary search, k = the number of knots below t (numpy's
// searchsorted, side "left"), followed by the staircase's gamma_k or the
// log-linear interpolation between knots k - 1 and k, gamma_0 before x_0
// and gamma_M after x_M (pop_model.cpp:181-200).  The JAX package sweeps a
// skygrid run with its XLA part_sweep instead (the Pallas chain hard-codes
// the exponential model); both routes make the same moves.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MARGIN = 2;  // cells beyond a node's old/new cells where dk == 0

constexpr int SMEM_LIMIT = 227 * 1024;

// sc lane assignments (block_pallas.py _SC_*)
constexpr int SC_SEL = 0, SC_NODE_I = 1, SC_NODE_T = 2, SC_PROP = 3,
              SC_ACC = 4, SC_OFF = 5, SC_LANES = 6;

struct Shared {
  double t_lo, t_step, t_max_tip, log_n0, g, t0, log_min_pop;
};

struct Uniforms {
  const double *pri, *prop, *acc, *ref_acc, *ref_u, *sc, *norm;
  int S, Z;
};

__device__ __forceinline__ double clip(double x, double lo, double hi) {
  return fmin(fmax(x, lo), hi);
}

constexpr int POP_EXP = 0, POP_STAIRCASE = 1, POP_LOG_LINEAR = 2;

// skygrid knots in shared memory (M + 1 of each; unused by POP_EXP)
struct Knots {
  const double* x;
  const double* g;
  int M;
};

template <int POP>
__device__ __forceinline__ double log_pop(double t, const Shared& s,
                                          const Knots& kn) {
  if constexpr (POP == POP_EXP) {
    return fmax(s.log_min_pop, s.log_n0 + s.g * (t - s.t0));
  } else {
    // k = the number of knots below t
    int lo = 0, hi = kn.M + 1;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (kn.x[mid] < t)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo == 0) return kn.g[0];
    if (lo > kn.M) return kn.g[kn.M];
    if constexpr (POP == POP_STAIRCASE) {
      return kn.g[lo];
    } else {
      double c = (t - kn.x[lo - 1]) / (kn.x[lo] - kn.x[lo - 1]);
      return (1 - c) * kn.g[lo - 1] + c * kn.g[lo];
    }
  }
}

// x ~ exp(lam x) on [a, b] from uniform u (distributions.h:38-68, inverse
// CDF; asymptotic branches beyond |lam (b - a)| = 80)
__device__ double bounded_exp_u(double u, double lam, double a, double b) {
  u = fmax(u, 1e-30);
  double ltr = lam * (b - a);
  double safe_lam = lam == 0.0 ? 1.0 : lam;
  double ltr_c = clip(ltr, -80.0, 80.0);
  double x;
  if (lam == 0.0)
    x = a + u * (b - a);
  else if (lam > 0.0 && ltr > 80.0)
    x = b + log(u) / safe_lam;
  else if (lam < 0.0 && ltr < -80.0)
    x = a + log(u) / safe_lam;
  else
    x = a + log1p(u * expm1(ltr_c)) / safe_lam;
  return clip(x, a, b);
}

// frac of cell c covered below t: clip((t - lb) / t_step, 0, 1), with the
// division only inside the cell.  Exact: for x = t - lb, the rounded x / t_step
// is >= 1 iff x >= t_step and > 0 iff x > 0 (and NaN clips to 0).
__device__ __forceinline__ double frac(double t, double lb, double t_step) {
  double x = t - lb;
  return x >= t_step ? 1.0 : (x > 0.0 ? x / t_step : 0.0);
}

__device__ __forceinline__ int cell_of(double t, const Shared& s, int C) {
  double c = floor((t - s.t_lo) / s.t_step);
  return (int)clip(c, -MARGIN - 1.0, (double)(C + MARGIN + 1));
}

// k_p change of one displacement from ot to nt in cell c
__device__ __forceinline__ double dk_at(int c, double ot, double nt,
                                        double sign, const Shared& s) {
  double lb = s.t_lo + s.t_step * (double)c;
  return sign * (frac(nt, lb, s.t_step) - frac(ot, lb, s.t_step));
}

// quadratic-prior change of adding dk to cell c
__device__ __forceinline__ double dq_at(double dkc, double k, double inv,
                                        double A, double b) {
  return inv * (0.5 * ((k + dkc) * (k + dkc) - k * k) * A - b * dkc);
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// GROUP lanes of one warp work on one node in the batched move, the k_p
// scatter and the reform (cells and slots split over the group's lanes);
// the group's lanes compute the node's scalars alike and take the same
// branches, so a shuffle over the group's own mask is always complete.
constexpr int GROUP = 4;

__device__ __forceinline__ unsigned group_mask() {
  return ((1u << GROUP) - 1) << ((threadIdx.x & 31) & ~(GROUP - 1));
}

__device__ __forceinline__ double group_sum(double v) {
  for (int o = 1; o < GROUP; o <<= 1)
    v += __shfl_xor_sync(group_mask(), v, o);
  return v;
}

__device__ __forceinline__ double group_max(double v) {
  for (int o = 1; o < GROUP; o <<= 1)
    v = fmax(v, __shfl_xor_sync(group_mask(), v, o));
  return v;
}

__device__ __forceinline__ double group_min(double v) {
  for (int o = 1; o < GROUP; o <<= 1)
    v = fmin(v, __shfl_xor_sync(group_mask(), v, o));
  return v;
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// doubles of one block step's uniforms in shared memory:
// pri, prop, acc, ref_acc (NC each), ref_u (MC), sc lanes, norm lane 0
__host__ __device__ __forceinline__ int stage_doubles(int NC, int MC) {
  return 4 * NC + MC + SC_LANES + 1;
}

// start copying block step ub's uniforms of this part into buf, with the
// threads from `first` on
__device__ void fetch_uniforms(double* buf, const Uniforms& u, long ub,
                               int NC, int MC, int first) {
  const int i = threadIdx.x - first, nt = blockDim.x - first;
  if (i < 0) return;
  for (int k = i; k < NC; k += nt) {
    cp_async8(buf + k, u.pri + ub * NC + k);
    cp_async8(buf + NC + k, u.prop + ub * NC + k);
    cp_async8(buf + 2 * NC + k, u.acc + ub * NC + k);
    cp_async8(buf + 3 * NC + k, u.ref_acc + ub * NC + k);
  }
  for (int k = i; k < MC; k += nt)
    cp_async8(buf + 4 * NC + k, u.ref_u + ub * MC + k);
  for (int k = i; k <= SC_LANES; k += nt)
    cp_async8(buf + 4 * NC + MC + k,
              k < SC_LANES ? u.sc + ub * u.S + k : u.norm + ub * u.Z);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// K: skygrid knots (0 for the exponential model)
__host__ __device__ size_t smem_bytes(int NC, int MC, int C_real, int cpb,
                                      int stages, int K) {
  int n_seg = C_real / cpb + 1;
  size_t doubles = 11 * (size_t)NC + 2 * (size_t)MC + 4 * (size_t)C_real +
                   (size_t)stages * stage_doubles(NC, MC) + 3 * 32 +
                   2 * (size_t)K;
  size_t u64s = n_seg;
  size_t ints = 9 * (size_t)NC + 1 + 3 * (size_t)MC + n_seg + 2;
  return doubles * sizeof(double) + u64s * 8 + ints * sizeof(int);
}

// uniform stages in shared memory: 2 or 1, or 0 for the global build
int stages_for(int NC, int MC, int C_real, int cpb, int K) {
  if (smem_bytes(NC, MC, C_real, cpb, 2, K) <= (size_t)SMEM_LIMIT) return 2;
  if (smem_bytes(NC, MC, C_real, cpb, 1, K) <= (size_t)SMEM_LIMIT) return 1;
  return 0;
}

// the global build: shared bytes (reduction scratch, segment maxima, the
// per-segment and scalar counters) and the bytes of one part's workspace
// slice (the whole layout with no stage, rounded to 128)
__host__ __device__ size_t global_smem_bytes(int C_real, int cpb) {
  int n_seg = C_real / cpb + 1;
  return 3 * 32 * sizeof(double) + (size_t)n_seg * 8 +
         ((size_t)n_seg + 2) * sizeof(int);
}

__host__ __device__ size_t workspace_stride(int NC, int MC, int C_real,
                                            int cpb, int K) {
  return (smem_bytes(NC, MC, C_real, cpb, 0, K) + 127) / 128 * 128;
}

template <int POP, bool GLOBAL>
__global__ void __launch_bounds__(MAX_THREADS) sweep_chain_kernel(
    int NC, int MC, int C, int C_real, int cpb, int n_blocks, int stages,
    const double* __restrict__ t_in,
    const double* __restrict__ mut_in, const double* __restrict__ kp_in,
    const int* __restrict__ par_g, const int* __restrict__ c0_g,
    const int* __restrict__ c1_g, const double* __restrict__ tmin_g,
    const double* __restrict__ tmax_g, const double* __restrict__ lam_g,
    const double* __restrict__ dlam_g, const int* __restrict__ mnode_g,
    const int* __restrict__ mvalid_g, const int* __restrict__ msingle_g,
    const double* __restrict__ slope_g, const double* __restrict__ b_g,
    const double* __restrict__ A_g, const double* __restrict__ nbar_g,
    const int* __restrict__ isc, const double* __restrict__ fsc, int NB,
    Uniforms un, double* t_out, double* mut_out, double* kp_out,
    double* acc_out, int K, const double* __restrict__ kx_g,
    const double* __restrict__ kg_g, double* ws) {
  const int p = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  // node groups: group g (lanes r = 0..GROUP-1) takes nodes g, g + NG, ...
  const int grp = tid / GROUP, r = tid % GROUP, NG = T / GROUP;
  const int part_root = isc[p * 4 + 0];
  const int is_run_root = isc[p * 4 + 1];
  const int n_leaves = isc[p * 4 + 2];
  const int n_nodes = isc[p * 4 + 3];
  const Shared sh{fsc[0], fsc[1], fsc[2], fsc[3], fsc[4], fsc[5], fsc[6]};
  const int n_seg = C_real / cpb + 1;
  const int UB = stage_doubles(NC, MC);

  // ---- shared memory carve-up (doubles, then u64, then ints); the global
  // build carves its part's workspace slice instead ----
  extern __shared__ double smem[];
  double* rows = smem;
  if constexpr (GLOBAL)
    rows = ws + (long)p * (workspace_stride(NC, MC, C_real, cpb, K) / 8);
  double* t = rows;                 // NC
  double* t_min = t + NC;           // NC
  double* t_max = t_min + NC;       // NC
  double* lam = t_max + NC;         // NC
  double* dlam = lam + NC;          // NC
  double* own_max = dlam + NC;      // NC: latest mutation time on the branch
  double* child_min = own_max + NC; // NC: earliest mutation time on it
  double* win_lo = child_min + NC;  // NC
  double* win_hi = win_lo + NC;     // NC
  double* new_t = win_hi + NC;      // NC
  double* t_old = new_t + NC;       // NC
  double* mut_t = t_old + NC;       // MC
  double* slope = mut_t + MC;       // MC
  double* kp = slope + MC;          // C_real
  double* bc = kp + C_real;         // C_real
  double* Ac = bc + C_real;         // C_real
  double* inv = Ac + C_real;        // C_real: t_step / nbar
  double* ubuf = inv + C_real;      // stages x UB
  double* red = ubuf + stages * UB; // 3 x 32
  double* kx = red + 3 * 32;        // K: skygrid knot times
  double* kg = kx + K;              // K: skygrid log N at the knots
  unsigned long long* best = (unsigned long long*)(kg + K);  // n_seg
  int* par = (int*)(best + n_seg);  // NC
  int* c0 = par + NC;               // NC
  int* c1 = c0 + NC;                // NC
  int* blk = c1 + NC;               // NC
  int* fits = blk + NC;             // NC
  int* accn = fits + NC;            // NC: accepted in the batched move
  int* c_lo = accn + NC;            // NC
  int* c_hi = c_lo + NC;            // NC
  int* slot_start = c_hi + NC;      // NC + 1
  int* slot_list = slot_start + NC + 1;  // MC
  int* mnode = slot_list + MC;      // MC
  int* sflag = mnode + MC;          // MC: bit0 valid, bit1 single
  int* seg_acc = sflag + MC;        // n_seg: accepted nodes per segment
  int* iscal = seg_acc + n_seg;     // [0] tie flag, [1] reform batch size
  if constexpr (GLOBAL) {           // these four stay in shared memory
    red = smem;
    best = (unsigned long long*)(red + 3 * 32);
    seg_acc = (int*)(best + n_seg);
    iscal = seg_acc + n_seg;
  }

  // ---- load the part's rows and the first step's uniforms ----
  if constexpr (!GLOBAL)
    if (n_blocks > 0) fetch_uniforms(ubuf, un, (long)p * NB, NC, MC, 0);
  for (int n = tid; n < NC; n += T) {
    long g = (long)p * NC + n;
    t[n] = t_in[g];
    t_min[n] = tmin_g[g];
    t_max[n] = tmax_g[g];
    lam[n] = lam_g[g];
    dlam[n] = dlam_g[g];
    par[n] = par_g[g];
    c0[n] = c0_g[g];
    c1[n] = c1_g[g];
  }
  for (int j = tid; j < MC; j += T) {
    long g = (long)p * MC + j;
    mut_t[j] = mut_in[g];
    slope[j] = slope_g[g];
    int m = mnode_g[g];
    mnode[j] = m;
    bool valid = mvalid_g[g] != 0 && m >= 0 && m < NC;
    sflag[j] = (valid ? 1 : 0) | (msingle_g[g] != 0 ? 2 : 0);
  }
  for (int c = tid; c < C_real; c += T) {
    kp[c] = kp_in[(long)p * C + c];
    bc[c] = b_g[(long)p * C + c];
    Ac[c] = A_g[c];
    inv[c] = sh.t_step / nbar_g[c];
  }
  for (int k = tid; k < K; k += T) {
    kx[k] = kx_g[k];
    kg[k] = kg_g[k];
  }
  for (int s = tid; s < n_seg; s += T) {
    best[s] = 0ull;
    seg_acc[s] = 0;
  }
  if (tid == 0) iscal[0] = 0;
  __syncthreads();
  const Knots kn{kx, kg, K - 1};

  // ---- per-node slot lists (the pool is static within a sweep) ----
  for (int n = tid; n < NC; n += T) {
    int cnt = 0;
    for (int j = 0; j < MC; ++j)
      if ((sflag[j] & 1) && mnode[j] == n) ++cnt;
    slot_start[n + 1] = cnt;
  }
  __syncthreads();
  if (tid == 0) {
    slot_start[0] = 0;
    for (int n = 0; n < NC; ++n) slot_start[n + 1] += slot_start[n];
    int nb = 0;
    for (int n = 0; n < NC; ++n)
      if (n < n_nodes && n != part_root) ++nb;
    iscal[1] = nb;  // nodes in the reform batch
  }
  __syncthreads();
  for (int n = tid; n < NC; n += T) {
    int k = slot_start[n];
    double mx = -INFINITY, mn = INFINITY;
    for (int j = 0; j < MC; ++j)
      if ((sflag[j] & 1) && mnode[j] == n) {
        slot_list[k++] = j;
        mx = fmax(mx, mut_t[j]);
        mn = fmin(mn, mut_t[j]);
      }
    own_max[n] = mx;
    child_min[n] = mn;
  }
  if constexpr (!GLOBAL) cp_async_wait_all();
  __syncthreads();

  const double grid_lo = sh.t_lo + sh.t_step;
  const int nb_reform = iscal[1];
  const bool scatter_ok = cpb >= 2 * MARGIN + 2;
  // this thread's share of the part's dG, dC and move count
  double dG = 0.0, dC = 0.0, cntm = 0.0;

  for (int blk_i = 0; blk_i < n_blocks; ++blk_i) {
    const long ub = (long)p * NB + blk_i;
    const double *upri, *uprop, *uacc, *urefacc, *uref, *usc;
    double unorm0;
    if constexpr (GLOBAL) {  // in place in the uniforms' global arrays
      upri = un.pri + ub * NC;
      uprop = un.prop + ub * NC;
      uacc = un.acc + ub * NC;
      urefacc = un.ref_acc + ub * NC;
      uref = un.ref_u + ub * MC;
      usc = un.sc + ub * un.S;
      unorm0 = un.norm[ub * un.Z];
    } else {
      double* U = ubuf + (stages == 2 ? (blk_i & 1) * UB : 0);
      if (stages == 1 && blk_i > 0) {
        fetch_uniforms(ubuf, un, ub, NC, MC, 0);
        cp_async_wait_all();
        __syncthreads();
      } else if (stages == 2 && blk_i + 1 < n_blocks) {
        // warps other than warp 0, which runs the single move meanwhile
        fetch_uniforms(ubuf + ((blk_i + 1) & 1) * UB, un, ub + 1, NC, MC,
                       T > 32 ? 32 : 0);
      }
      upri = U;
      uprop = U + NC;
      uacc = U + 2 * NC;
      urefacc = U + 3 * NC;
      uref = U + 4 * NC;
      usc = U + 4 * NC + MC;
      unorm0 = usc[SC_LANES];
    }
    const int offset = (int)floor(usc[SC_OFF] * (double)cpb);

    // =========== single node / tip displacement (warp 0) ===========
    if (warp == 0) {
      bool inner = usc[SC_SEL] < 0.5;
      int n_inner = n_nodes - n_leaves;
      int node_i = n_leaves +
          (int)floor(usc[SC_NODE_I] * (double)max(n_inner, 1));
      int node_t = (int)floor(usc[SC_NODE_T] * (double)max(n_leaves, 1));
      int node = inner ? node_i : node_t;
      bool ok = node >= 0 && node < NC;
      int nd = ok ? node : 0;
      bool is_root_move = inner && node == part_root;
      double tmin_n = ok ? t_min[nd] : 0.0, tmax_n = ok ? t_max[nd] : 0.0;
      bool valid = inner ? (!is_root_move || is_run_root != 0)
                         : (tmin_n < tmax_n);
      double own = ok ? own_max[nd] : -INFINITY;
      int par_n = ok ? par[nd] : 0;
      int safe_par = max(par_n, 0);
      double t_par = is_root_move ? grid_lo : t[safe_par];
      double t_lo_b = fmax(t_par, own);
      if (!inner) t_lo_b = fmax(t_lo_b, tmin_n);
      int c0n = ok ? c0[nd] : 0, c1n = ok ? c1[nd] : 0;
      double cb0 = c0n < 0 ? INFINITY : fmin(t[c0n], child_min[c0n]);
      double cb1 = c1n < 0 ? INFINITY : fmin(t[c1n], child_min[c1n]);
      double t_hi = inner ? fmin(cb0, cb1) : tmax_n;
      double lam_n = ok ? lam[nd] : 0.0;
      double lam_b0 = c0n >= 0 ? lam_n + dlam[max(c0n, 0)] : 0.0;
      double lam_b1 = c1n >= 0 ? lam_n + dlam[max(c1n, 0)] : 0.0;
      double d = inner ? ((is_root_move ? 0.0 : -lam_n) + lam_b0 + lam_b1)
                       : -lam_n;
      double old_t = ok ? t[nd] : 0.0;
      double tree_span = fmax(sh.t_max_tip - t_hi, 0.0);
      double delta_scale = fmin(0.5 / fmax(lam_n, 1e-30), tree_span);
      double root_t = old_t + delta_scale * unorm0;
      double a = t_lo_b > -INFINITY ? t_lo_b : old_t - 1.0;
      double bnd = t_hi < INFINITY ? t_hi : old_t + 1.0;
      double nt = is_root_move
          ? root_t
          : bounded_exp_u(usc[SC_PROP], d, fmin(a, bnd), bnd);
      bool in_bounds = valid && nt > t_lo_b && nt < t_hi && t_lo_b < t_hi;
      double dlg = d * (nt - old_t);
      double log_alpha = is_root_move ? 0.0 : dlg;
      double dlogn = inner ? -(log_pop<POP>(nt, sh, kn) -
                               log_pop<POP>(old_t, sh, kn))
                           : 0.0;
      double sign = inner ? -1.0 : 1.0;
      int lo = max(cell_of(fmin(old_t, nt), sh, C_real) - MARGIN, 0);
      int hi = min(cell_of(fmax(old_t, nt), sh, C_real) + MARGIN, C_real - 1);
      double dq = 0.0;
      for (int c = lo + lane; c <= hi; c += 32) {
        double dkc = dk_at(c, old_t, nt, sign, sh);
        if (dkc != 0.0) dq += dq_at(dkc, kp[c], inv[c], Ac[c], bc[c]);
      }
      dq = warp_sum(dq);  // the same total in every lane
      double dcoal = -dq + dlogn;
      double log_mh = dlg + dcoal - log_alpha;
      bool accept = in_bounds &&
                    (log_mh >= 0.0 || log(fmax(usc[SC_ACC], 1e-30)) < log_mh);
      if (accept) {
        for (int c = lo + lane; c <= hi; c += 32) {
          double dkc = dk_at(c, old_t, nt, sign, sh);
          if (dkc != 0.0) kp[c] += dkc;
        }
        if (lane == 0) {
          if (ok) t[node] = nt;
          dG += dlg;
          dC += dcoal;
        }
      }
      if (lane == 0 && n_nodes > 1) cntm += 1.0;
    }
    __syncthreads();  // B1

    // =========== batched cell-block-coloured displacement ===========
    // windows, and the segment maximum of the priorities
    for (int n = tid; n < NC; n += T) {
      bool is_leaf = c0[n] < 0;
      double t_par = par[n] >= 0 ? t[par[n]] : 0.0;
      double cb0 = c0[n] >= 0 ? fmin(t[c0[n]], child_min[c0[n]]) : INFINITY;
      double cb1 = c1[n] >= 0 ? fmin(t[c1[n]], child_min[c1[n]]) : INFINITY;
      double tl = fmax(t_par, own_max[n]);
      if (is_leaf) tl = fmax(tl, t_min[n]);
      double th = is_leaf ? t_max[n] : fmin(cb0, cb1);
      bool movable = n < n_nodes && n != part_root && tl < th;
      double cf = floor((t[n] - sh.t_lo) / sh.t_step);
      bool in_grid = cf >= 0.0 && cf < (double)C_real;
      int cell = (int)clip(cf, -1.0, (double)C_real);
      int q = cell + offset;
      int b = (q >= 0 ? q / cpb : -((-q + cpb - 1) / cpb));
      b = min(max(b, 0), n_seg - 1);
      double blo = sh.t_lo + (double)(b * cpb - offset) * sh.t_step;
      double bhi = blo + (double)cpb * sh.t_step;
      double wl = fmax(tl, blo), wh = fmin(th, bhi);
      bool f = movable && in_grid && wl < wh;
      blk[n] = b;
      win_lo[n] = wl;
      win_hi[n] = wh;
      fits[n] = f ? 1 : 0;
      if (f && upri[n] >= 0.0)
        atomicMax(&best[b], (unsigned long long)__double_as_longlong(upri[n]));
    }
    __syncthreads();  // B2

    // proposals: selection, parent veto, dq over the node's cells (split over
    // the node's group), accept
    for (int n = grp; n < NC; n += NG) {
      int acc_n = 0;
      bool sel0 = fits[n] && upri[n] >= 0.0 &&
                  upri[n] == __longlong_as_double((long long)best[blk[n]]);
      int pn = par[n];
      bool psel0 = pn >= 0 && fits[pn] && upri[pn] >= 0.0 &&
                   upri[pn] == __longlong_as_double((long long)best[blk[pn]]);
      if (sel0 && !psel0) {
        if (r == 0) cntm += 1.0;
        bool is_leaf = c0[n] < 0;
        double lb0 = c0[n] >= 0 ? lam[n] + dlam[c0[n]] : 0.0;
        double lb1 = c1[n] >= 0 ? lam[n] + dlam[c1[n]] : 0.0;
        double d = -lam[n] + (lb0 + lb1);
        double wl = win_lo[n], wh = win_hi[n];
        double nt = bounded_exp_u(uprop[n], d, wl, wh > wl ? wh : wl + 1.0);
        nt = clip(nt, wl, wh);
        if (nt > wl && nt < wh) {
          double ot = t[n];
          double sign = is_leaf ? 1.0 : -1.0;
          int lo = max(cell_of(fmin(ot, nt), sh, C_real) - MARGIN, 0);
          int hi = min(cell_of(fmax(ot, nt), sh, C_real) + MARGIN,
                       C_real - 1);
          double dq = 0.0;
          for (int c = lo + r; c <= hi; c += GROUP) {
            double dkc = dk_at(c, ot, nt, sign, sh);
            if (dkc != 0.0) dq += dq_at(dkc, kp[c], inv[c], Ac[c], bc[c]);
          }
          dq = group_sum(dq);  // the same total in the group's lanes
          double dcoal = -dq + (is_leaf ? 0.0
                                        : -(log_pop<POP>(nt, sh, kn) -
                                            log_pop<POP>(ot, sh, kn)));
          if (dcoal >= 0.0 || log(fmax(uacc[n], 1e-30)) < dcoal) {
            acc_n = 1;
            if (r == 0) {
              new_t[n] = nt;
              t_old[n] = ot;
              c_lo[n] = lo;
              c_hi[n] = hi;
              dG += d * (nt - ot);
              dC += dcoal;
              if (atomicAdd(&seg_acc[blk[n]], 1) > 0) iscal[0] = 1;  // a tie
            }
          }
        }
      }
      if (r == 0) accn[n] = acc_n;
    }
    __syncthreads();  // B3: every dq has read the old k_p

    // k_p scatter over each accepted node's own segment, and the new times
    const bool serial = iscal[0] != 0 || !scatter_ok;
    if (serial) {
      // per-cell sum over all accepted nodes (ties, or cpb too small)
      for (int c = tid; c < C_real; c += T) {
        double add = 0.0;
        for (int n = 0; n < NC; ++n) {
          if (!accn[n] || c < c_lo[n] || c > c_hi[n]) continue;
          add += dk_at(c, t_old[n], new_t[n], c0[n] < 0 ? 1.0 : -1.0, sh);
        }
        kp[c] += add;
      }
    }
    for (int n = grp; n < NC; n += NG) {
      if (!accn[n]) continue;
      if (!serial) {
        int first = blk[n] * cpb - offset;
        int last = blk[n] == n_seg - 1 ? C_real - 1 : first + cpb - 1;
        double sign = c0[n] < 0 ? 1.0 : -1.0;
        for (int c = max(c_lo[n], first) + r; c <= min(c_hi[n], last);
             c += GROUP) {
          double dkc = dk_at(c, t_old[n], new_t[n], sign, sh);
          if (dkc != 0.0) kp[c] += dkc;
        }
      }
      if (r == 0) t[n] = new_t[n];
    }
    __syncthreads();  // B4

    // k_p margins outside the segments, then the batched branch reform
    for (int n = grp; n < NC; n += NG) {
      if (!serial && accn[n]) {
        int first = blk[n] * cpb - offset;
        int last = blk[n] == n_seg - 1 ? C_real - 1 : first + cpb - 1;
        double sign = c0[n] < 0 ? 1.0 : -1.0;
        for (int c = c_lo[n] + r; c <= min(c_hi[n], first - 1); c += GROUP) {
          double dkc = dk_at(c, t_old[n], new_t[n], sign, sh);
          if (dkc != 0.0) kp[c] += dkc;
        }
        for (int c = max(c_lo[n], last + 1) + r; c <= c_hi[n]; c += GROUP) {
          double dkc = dk_at(c, t_old[n], new_t[n], sign, sh);
          if (dkc != 0.0) kp[c] += dkc;
        }
      }
      // reform: node n's group proposes for its own slots and decides
      bool in_batch = n < n_nodes && n != part_root;
      const int k0 = slot_start[n], k1 = slot_start[n + 1];
      double tX = t[n];
      double tP = par[n] >= 0 ? t[par[n]] : 0.0;
      double delta = 0.0;
      if (in_batch)
        for (int k = k0 + r; k < k1; k += GROUP) {
          int j = slot_list[k];
          if (!(sflag[j] & 2)) continue;
          double nm = tP + fmax(uref[j], 1e-16) * (tX - tP);
          delta += -slope[j] * (nm - mut_t[j]);
        }
      delta = group_sum(delta);  // the same total in the group's lanes
      bool acc = in_batch &&
                 (delta >= 0.0 || log(fmax(urefacc[n], 1e-30)) < delta);
      if (acc && r == 0) dG += delta;
      double mx = -INFINITY, mn = INFINITY;
      for (int k = k0 + r; k < k1; k += GROUP) {
        int j = slot_list[k];
        double v = mut_t[j];
        if (acc && (sflag[j] & 2)) {
          v = tP + fmax(uref[j], 1e-16) * (tX - tP);
          mut_t[j] = v;
        }
        mx = fmax(mx, v);
        mn = fmin(mn, v);
      }
      mx = group_max(mx);
      mn = group_min(mn);
      if (r == 0) {
        own_max[n] = mx;
        child_min[n] = mn;
      }
    }
    for (int s = tid; s < n_seg; s += T) {
      best[s] = 0ull;
      seg_acc[s] = 0;
    }
    if (tid == 0) {
      iscal[0] = 0;
      cntm += (double)nb_reform;
    }
    if constexpr (!GLOBAL)
      if (stages == 2) cp_async_wait_all();
    __syncthreads();  // B5
  }

  // ---- reduce the per-thread sums once, and write back ----
  dG = warp_sum(dG);
  dC = warp_sum(dC);
  cntm = warp_sum(cntm);
  if (lane == 0) {
    red[warp * 3 + 0] = dG;
    red[warp * 3 + 1] = dC;
    red[warp * 3 + 2] = cntm;
  }
  __syncthreads();
  if (tid == 0) {
    double s0 = 0.0, s1 = 0.0, s2 = 0.0;
    for (int w = 0; w < T / 32; ++w) {
      s0 += red[w * 3 + 0];
      s1 += red[w * 3 + 1];
      s2 += red[w * 3 + 2];
    }
    acc_out[p * 3 + 0] = s0;
    acc_out[p * 3 + 1] = s1;
    acc_out[p * 3 + 2] = s2;
  }
  for (int n = tid; n < NC; n += T) t_out[(long)p * NC + n] = t[n];
  for (int j = tid; j < MC; j += T) mut_out[(long)p * MC + j] = mut_t[j];
  for (int c = tid; c < C; c += T)
    kp_out[(long)p * C + c] = c < C_real ? kp[c] : kp_in[(long)p * C + c];
}

// threads per block: GROUP per node, in whole warps, 64 to MAX_THREADS
// (at NC = 64, 256 threads beat fixed 64, 128 and 512 on an H100: PERF.md)
int threads_for(int NC) {
  int t = (GROUP * NC + 31) / 32 * 32;
  return t < 64 ? 64 : (t > MAX_THREADS ? MAX_THREADS : t);
}


template <int POP>
int launch(int P, int NC, int MC, int C, int C_real, int cpb, int n_blocks,
           const double* t_in, const double* mut_in, const double* kp_in,
           const int* par, const int* c0, const int* c1, const double* t_min,
           const double* t_max, const double* lam, const double* dlam,
           const int* mnode, const int* mvalid, const int* msingle,
           const double* slope, const double* b, const double* A,
           const double* nbar, const int* isc, const double* fsc, int NB,
           const Uniforms& un, double* t_out, double* mut_out, double* kp_out,
           double* acc_out, int K, const double* kx, const double* kg,
           double* ws, void* stream) {
  int stages = stages_for(NC, MC, C_real, cpb, K);
  if ((stages == 0) != (ws != nullptr)) return (int)cudaErrorInvalidValue;
  if (stages == 0) {
    auto kern = sweep_chain_kernel<POP, true>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
    if (e != cudaSuccess) return (int)e;
    kern<<<P, threads_for(NC), global_smem_bytes(C_real, cpb),
           (cudaStream_t)stream>>>(
        NC, MC, C, C_real, cpb, n_blocks, 0, t_in, mut_in, kp_in, par, c0,
        c1, t_min, t_max, lam, dlam, mnode, mvalid, msingle, slope, b, A,
        nbar, isc, fsc, NB, un, t_out, mut_out, kp_out, acc_out, K, kx, kg,
        ws);
    return (int)cudaGetLastError();
  }
  size_t smem = smem_bytes(NC, MC, C_real, cpb, stages, K);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sweep_chain_kernel<POP, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sweep_chain_kernel<POP, false>
      <<<P, threads_for(NC), smem, (cudaStream_t)stream>>>(
          NC, MC, C, C_real, cpb, n_blocks, stages, t_in, mut_in, kp_in, par,
          c0, c1, t_min, t_max, lam, dlam, mnode, mvalid, msingle, slope, b,
          A, nbar, isc, fsc, NB, un, t_out, mut_out, kp_out, acc_out, K, kx,
          kg, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

// the exponential population model; fsc = (t_lo, t_step, t_max_tip, log n0,
// g, t0, log min_pop).  The shared-memory builds: a shape that needs the
// global build is refused (cudaErrorInvalidValue).
extern "C" int delphy_sweep_chain(
    int P, int NC, int MC, int C, int C_real, int cpb, int n_blocks,
    const double* t_in, const double* mut_in,
    const double* kp_in, const int* par, const int* c0, const int* c1,
    const double* t_min, const double* t_max, const double* lam,
    const double* dlam, const int* mnode, const int* mvalid,
    const int* msingle, const double* slope, const double* b,
    const double* A, const double* nbar, const int* isc, const double* fsc,
    int NB, const double* u_pri, const double* u_prop, const double* u_acc,
    const double* u_refu, const double* u_refacc, const double* u_sc,
    const double* u_norm, int S, int Z, double* t_out, double* mut_out,
    double* kp_out, double* acc_out, void* stream) {
  Uniforms un{u_pri, u_prop, u_acc, u_refacc, u_refu, u_sc, u_norm, S, Z};
  return launch<POP_EXP>(P, NC, MC, C, C_real, cpb, n_blocks, t_in, mut_in,
                         kp_in, par, c0, c1, t_min, t_max, lam, dlam, mnode,
                         mvalid, msingle, slope, b, A, nbar, isc, fsc, NB, un,
                         t_out, mut_out, kp_out, acc_out, 0, nullptr, nullptr,
                         nullptr, stream);
}

// the skygrid of `type` (1 staircase, 2 log-linear) with K knots x and
// log-population values gamma; fsc as above, its last four entries unused
extern "C" int delphy_sweep_chain_skygrid(
    int P, int NC, int MC, int C, int C_real, int cpb, int n_blocks,
    const double* t_in, const double* mut_in,
    const double* kp_in, const int* par, const int* c0, const int* c1,
    const double* t_min, const double* t_max, const double* lam,
    const double* dlam, const int* mnode, const int* mvalid,
    const int* msingle, const double* slope, const double* b,
    const double* A, const double* nbar, const int* isc, const double* fsc,
    int NB, const double* u_pri, const double* u_prop, const double* u_acc,
    const double* u_refu, const double* u_refacc, const double* u_sc,
    const double* u_norm, int S, int Z, double* t_out, double* mut_out,
    double* kp_out, double* acc_out, int type, int K, const double* x,
    const double* gamma, void* stream) {
  if (K < 2 || (type != POP_STAIRCASE && type != POP_LOG_LINEAR))
    return (int)cudaErrorInvalidValue;
  Uniforms un{u_pri, u_prop, u_acc, u_refacc, u_refu, u_sc, u_norm, S, Z};
  auto go = type == POP_STAIRCASE ? launch<POP_STAIRCASE>
                                  : launch<POP_LOG_LINEAR>;
  return go(P, NC, MC, C, C_real, cpb, n_blocks, t_in, mut_in, kp_in, par, c0,
            c1, t_min, t_max, lam, dlam, mnode, mvalid, msingle, slope, b, A,
            nbar, isc, fsc, NB, un, t_out, mut_out, kp_out, acc_out, K, x,
            gamma, nullptr, stream);
}

// the global builds of the two entries above: the same arguments and a
// workspace of P x delphy_sweep_chain_workspace_bytes bytes (ws); a shape
// that fits a shared-memory build is refused (cudaErrorInvalidValue)
extern "C" int delphy_sweep_chain_global(
    int P, int NC, int MC, int C, int C_real, int cpb, int n_blocks,
    const double* t_in, const double* mut_in,
    const double* kp_in, const int* par, const int* c0, const int* c1,
    const double* t_min, const double* t_max, const double* lam,
    const double* dlam, const int* mnode, const int* mvalid,
    const int* msingle, const double* slope, const double* b,
    const double* A, const double* nbar, const int* isc, const double* fsc,
    int NB, const double* u_pri, const double* u_prop, const double* u_acc,
    const double* u_refu, const double* u_refacc, const double* u_sc,
    const double* u_norm, int S, int Z, double* t_out, double* mut_out,
    double* kp_out, double* acc_out, double* ws, void* stream) {
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  Uniforms un{u_pri, u_prop, u_acc, u_refacc, u_refu, u_sc, u_norm, S, Z};
  return launch<POP_EXP>(P, NC, MC, C, C_real, cpb, n_blocks, t_in, mut_in,
                         kp_in, par, c0, c1, t_min, t_max, lam, dlam, mnode,
                         mvalid, msingle, slope, b, A, nbar, isc, fsc, NB, un,
                         t_out, mut_out, kp_out, acc_out, 0, nullptr, nullptr,
                         ws, stream);
}

extern "C" int delphy_sweep_chain_skygrid_global(
    int P, int NC, int MC, int C, int C_real, int cpb, int n_blocks,
    const double* t_in, const double* mut_in,
    const double* kp_in, const int* par, const int* c0, const int* c1,
    const double* t_min, const double* t_max, const double* lam,
    const double* dlam, const int* mnode, const int* mvalid,
    const int* msingle, const double* slope, const double* b,
    const double* A, const double* nbar, const int* isc, const double* fsc,
    int NB, const double* u_pri, const double* u_prop, const double* u_acc,
    const double* u_refu, const double* u_refacc, const double* u_sc,
    const double* u_norm, int S, int Z, double* t_out, double* mut_out,
    double* kp_out, double* acc_out, int type, int K, const double* x,
    const double* gamma, double* ws, void* stream) {
  if (K < 2 || (type != POP_STAIRCASE && type != POP_LOG_LINEAR) ||
      ws == nullptr)
    return (int)cudaErrorInvalidValue;
  Uniforms un{u_pri, u_prop, u_acc, u_refacc, u_refu, u_sc, u_norm, S, Z};
  auto go = type == POP_STAIRCASE ? launch<POP_STAIRCASE>
                                  : launch<POP_LOG_LINEAR>;
  return go(P, NC, MC, C, C_real, cpb, n_blocks, t_in, mut_in, kp_in, par, c0,
            c1, t_min, t_max, lam, dlam, mnode, mvalid, msingle, slope, b, A,
            nbar, isc, fsc, NB, un, t_out, mut_out, kp_out, acc_out, K, x,
            gamma, ws, stream);
}

// the build for these shapes (K: skygrid knots, 0 for the exponential
// model): 2 or 1 uniform stages in shared memory, 0 for the global build
extern "C" int delphy_sweep_chain_stages(int NC, int MC, int C_real, int cpb,
                                         int K) {
  return stages_for(NC, MC, C_real, cpb, K);
}

// bytes of one part's workspace slice of the global build
extern "C" unsigned long long delphy_sweep_chain_workspace_bytes(
    int NC, int MC, int C_real, int cpb, int K) {
  return (unsigned long long)workspace_stride(NC, MC, C_real, cpb, K);
}

static unsigned long long smem_of(int NC, int MC, int C_real, int cpb, int K) {
  int stages = stages_for(NC, MC, C_real, cpb, K);
  return (unsigned long long)(stages == 0
                                  ? global_smem_bytes(C_real, cpb)
                                  : smem_bytes(NC, MC, C_real, cpb, stages, K));
}

// shared-memory bytes per part of the build that runs these shapes
extern "C" unsigned long long delphy_sweep_chain_smem_bytes(int NC, int MC,
                                                            int C_real,
                                                            int cpb) {
  return smem_of(NC, MC, C_real, cpb, 0);
}

extern "C" unsigned long long delphy_sweep_chain_skygrid_smem_bytes(
    int NC, int MC, int C_real, int cpb, int K) {
  return smem_of(NC, MC, C_real, cpb, K);
}

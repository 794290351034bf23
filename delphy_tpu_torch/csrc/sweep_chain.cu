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
// Ebola size); parts are independent.  The work per step is a few thousand
// flops, far below what an SM can do, so the cost is the number of
// block-wide barriers per step and the latency of each.
// Design: one thread block per part, all of the part's rows resident in
// shared memory for the whole chain, threads over nodes, slots and cells.
// The TPU kernel's dense one-hot masks ((NC,NC), (NC,MC), (NC,C)) become
// index gathers: t_par = t[par[n]], child bounds through c0/c1, per-node
// slot lists (built once: the pool is static within a sweep) for own_max,
// child_min and the reform's per-branch sums, and the parent veto
// "a node drops out when its parent is selected" as a gather.  The batched
// displacement loops each node over the few cells between its old and new
// time (plus a 2-cell margin) instead of the dense (NC, C) dk: terms with
// dk = 0 are exactly 0, so only the summation order differs.  Colour-block
// selection keeps the accepted nodes' cells disjoint, and the k_p update
// runs with one thread per cell, so it needs no atomics and is
// deterministic.  f64 throughout, with expm1/log1p and +-inf.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int MARGIN = 2;  // cells beyond a node's old/new cells where dk == 0

// sc lane assignments (block_pallas.py _SC_*)
constexpr int SC_SEL = 0, SC_NODE_I = 1, SC_NODE_T = 2, SC_PROP = 3,
              SC_ACC = 4, SC_OFF = 5;

struct Shared {
  double t_lo, t_step, t_max_tip, log_n0, g, t0, log_min_pop;
};

__device__ __forceinline__ double clip(double x, double lo, double hi) {
  return fmin(fmax(x, lo), hi);
}

__device__ __forceinline__ double log_pop(double t, const Shared& s) {
  return fmax(s.log_min_pop, s.log_n0 + s.g * (t - s.t0));
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

// frac of cell c covered below t, clipped to [0, 1]
__device__ __forceinline__ double frac(double t, double lb, double t_step) {
  return clip((t - lb) / t_step, 0.0, 1.0);
}

__device__ __forceinline__ int cell_of(double t, const Shared& s, int C) {
  double c = floor((t - s.t_lo) / s.t_step);
  return (int)clip(c, -MARGIN - 1.0, (double)(C + MARGIN + 1));
}

// block-wide sum of up to 3 values; every thread gets the totals
__device__ void block_sum3(double& a, double& b, double& c, double* red) {
  const int T = blockDim.x, i = threadIdx.x;
  red[i] = a;
  red[T + i] = b;
  red[2 * T + i] = c;
  __syncthreads();
  for (int s = T / 2; s > 0; s >>= 1) {
    if (i < s) {
      red[i] += red[i + s];
      red[T + i] += red[T + i + s];
      red[2 * T + i] += red[2 * T + i + s];
    }
    __syncthreads();
  }
  a = red[0];
  b = red[T];
  c = red[2 * T];
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) sweep_chain_kernel(
    int NC, int MC, int C, int C_real, int cpb, int n_blocks,
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
    const double* __restrict__ u_pri, const double* __restrict__ u_prop,
    const double* __restrict__ u_acc, const double* __restrict__ u_refu,
    const double* __restrict__ u_refacc, const double* __restrict__ u_sc,
    const double* __restrict__ u_norm, int S, int Z, double* t_out,
    double* mut_out, double* kp_out, double* acc_out) {
  const int p = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int part_root = isc[p * 4 + 0];
  const int is_run_root = isc[p * 4 + 1];
  const int n_leaves = isc[p * 4 + 2];
  const int n_nodes = isc[p * 4 + 3];
  const Shared sh{fsc[0], fsc[1], fsc[2], fsc[3], fsc[4], fsc[5], fsc[6]};
  const int n_seg = C_real / cpb + 1;

  // ---- shared memory carve-up (doubles first, then ints) ----
  extern __shared__ double smem[];
  double* t = smem;                 // NC
  double* t_min = t + NC;           // NC
  double* t_max = t_min + NC;       // NC
  double* lam = t_max + NC;         // NC
  double* dlam = lam + NC;          // NC
  double* own_max = dlam + NC;      // NC
  double* child_min = own_max + NC; // NC
  double* win_lo = child_min + NC;  // NC
  double* win_hi = win_lo + NC;     // NC
  double* pri = win_hi + NC;        // NC
  double* new_t = pri + NC;         // NC
  double* mut_t = new_t + NC;       // MC
  double* slope = mut_t + MC;       // MC
  double* new_mut = slope + MC;     // MC
  double* per_slot = new_mut + MC;  // MC
  double* kp = per_slot + MC;       // C_real
  double* bc = kp + C_real;         // C_real
  double* Ac = bc + C_real;         // C_real
  double* inv = Ac + C_real;        // C_real: t_step / nbar
  double* dk = inv + C_real;        // C_real: single-move dk
  double* best = dk + C_real;       // n_seg
  double* red = best + n_seg;       // 3 * T
  double* scal = red + 3 * T;       // 8 broadcast scalars
  int* par = (int*)(scal + 8);      // NC
  int* c0 = par + NC;               // NC
  int* c1 = c0 + NC;                // NC
  int* blk = c1 + NC;               // NC
  int* flag = blk + NC;             // NC: bit0 fits, bit1 sel0, bit2 sel,
                                    //     bit3 in_bounds, bit4 accept
  int* c_lo = flag + NC;            // NC
  int* c_hi = c_lo + NC;            // NC
  int* slot_start = c_hi + NC;      // NC + 1
  int* slot_list = slot_start + NC + 1;  // MC
  int* mnode = slot_list + MC;      // MC
  int* sflag = mnode + MC;          // MC: bit0 valid, bit1 single, bit2 mut_in
  int* iscal = sflag + MC;          // 4 broadcast ints

  // ---- load the part's rows ----
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
  __syncthreads();

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
    iscal[0] = nb;  // nodes in the reform batch
  }
  __syncthreads();
  for (int n = tid; n < NC; n += T) {
    int k = slot_start[n];
    for (int j = 0; j < MC; ++j)
      if ((sflag[j] & 1) && mnode[j] == n) slot_list[k++] = j;
  }
  __syncthreads();

  const double grid_lo = sh.t_lo + sh.t_step;
  double dG = 0.0, dC = 0.0, cntm = 0.0;  // meaningful in thread 0

  for (int blk_i = 0; blk_i < n_blocks; ++blk_i) {
    const long ub = (long)p * NB + blk_i;
    const double* usc = u_sc + ub * S;
    const double* unorm = u_norm + ub * Z;

    // =========== single node / tip displacement ===========
    {
      if (tid == 0) {
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
        double own = -INFINITY;
        if (ok)
          for (int k = slot_start[nd]; k < slot_start[nd + 1]; ++k)
            own = fmax(own, mut_t[slot_list[k]]);
        int par_n = ok ? par[nd] : 0;
        int safe_par = max(par_n, 0);
        double t_par = is_root_move ? grid_lo : t[safe_par];
        double t_lo_b = fmax(t_par, own);
        if (!inner) t_lo_b = fmax(t_lo_b, tmin_n);
        int c0n = ok ? c0[nd] : 0, c1n = ok ? c1[nd] : 0;
        double cb[2];
        int cn2[2] = {c0n, c1n};
        for (int q = 0; q < 2; ++q) {
          int cn = cn2[q];
          if (cn < 0) {
            cb[q] = INFINITY;
            continue;
          }
          double mm = INFINITY;
          for (int k = slot_start[cn]; k < slot_start[cn + 1]; ++k)
            mm = fmin(mm, mut_t[slot_list[k]]);
          cb[q] = fmin(t[cn], mm);
        }
        double t_hi = inner ? fmin(cb[0], cb[1]) : tmax_n;
        double lam_n = ok ? lam[nd] : 0.0;
        double lam_b0 = c0n >= 0 ? lam_n + dlam[max(c0n, 0)] : 0.0;
        double lam_b1 = c1n >= 0 ? lam_n + dlam[max(c1n, 0)] : 0.0;
        double d = inner ? ((is_root_move ? 0.0 : -lam_n) + lam_b0 + lam_b1)
                         : -lam_n;
        double old_t = ok ? t[nd] : 0.0;
        double tree_span = fmax(sh.t_max_tip - t_hi, 0.0);
        double delta_scale = fmin(0.5 / fmax(lam_n, 1e-30), tree_span);
        double root_t = old_t + delta_scale * unorm[0];
        double a = t_lo_b > -INFINITY ? t_lo_b : old_t - 1.0;
        double bnd = t_hi < INFINITY ? t_hi : old_t + 1.0;
        double nt = is_root_move
            ? root_t
            : bounded_exp_u(usc[SC_PROP], d, fmin(a, bnd), bnd);
        bool in_bounds = valid && nt > t_lo_b && nt < t_hi && t_lo_b < t_hi;
        double dlg = d * (nt - old_t);
        double log_alpha = is_root_move ? 0.0 : dlg;
        double dlogn = inner ? -(log_pop(nt, sh) - log_pop(old_t, sh)) : 0.0;
        scal[0] = old_t;
        scal[1] = nt;
        scal[2] = inner ? -1.0 : 1.0;
        scal[3] = dlg;
        scal[4] = dlogn;
        scal[5] = log_alpha;
        iscal[1] = ok ? node : -1;
        iscal[2] = in_bounds ? 1 : 0;
      }
      __syncthreads();
      const double old_t = scal[0], nt = scal[1], sign = scal[2];
      double dq = 0.0, z1 = 0.0, z2 = 0.0;
      for (int c = tid; c < C_real; c += T) {
        double lb = sh.t_lo + sh.t_step * (double)c;
        double dkc = sign * (frac(nt, lb, sh.t_step) - frac(old_t, lb, sh.t_step));
        dk[c] = dkc;
        double k = kp[c];
        dq += inv[c] * (0.5 * ((k + dkc) * (k + dkc) - k * k) * Ac[c] -
                        bc[c] * dkc);
      }
      block_sum3(dq, z1, z2, red);
      bool accept = false;
      if (tid == 0) {
        double dcoal = -dq + scal[4];
        double dlg = scal[3];
        double log_mh = dlg + dcoal - scal[5];
        accept = iscal[2] != 0 &&
                 (log_mh >= 0.0 || log(fmax(usc[SC_ACC], 1e-30)) < log_mh);
        if (accept) {
          // iscal[1] >= 0 whenever in_bounds (valid needs a real node)
          if (iscal[1] >= 0) t[iscal[1]] = nt;
          dG += dlg;
          dC += dcoal;
        }
        cntm += n_nodes > 1 ? 1.0 : 0.0;
        iscal[3] = accept ? 1 : 0;
      }
      __syncthreads();
      if (iscal[3])
        for (int c = tid; c < C_real; c += T) kp[c] += dk[c];
      __syncthreads();
    }

    // =========== batched cell-block-coloured displacement ===========
    {
      const int offset = (int)floor(usc[SC_OFF] * (double)cpb);
      const double* upri = u_pri + ub * NC;
      const double* uprop = u_prop + ub * NC;
      const double* uacc = u_acc + ub * NC;
      // own_max / child_min per node from the slot lists
      for (int n = tid; n < NC; n += T) {
        double mx = -INFINITY, mn = INFINITY;
        for (int k = slot_start[n]; k < slot_start[n + 1]; ++k) {
          double v = mut_t[slot_list[k]];
          mx = fmax(mx, v);
          mn = fmin(mn, v);
        }
        own_max[n] = mx;
        child_min[n] = mn;
      }
      __syncthreads();
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
        bool fits = movable && in_grid && wl < wh;
        blk[n] = b;
        win_lo[n] = wl;
        win_hi[n] = wh;
        pri[n] = fits ? upri[n] : -1.0;
        flag[n] = fits ? 1 : 0;
      }
      __syncthreads();
      for (int s = tid; s < n_seg; s += T) {
        double m = -1.0;
        for (int n = 0; n < NC; ++n)
          if (blk[n] == s) m = fmax(m, pri[n]);
        best[s] = m;
      }
      __syncthreads();
      for (int n = tid; n < NC; n += T)
        if ((flag[n] & 1) && pri[n] >= 0.0 && pri[n] == best[blk[n]])
          flag[n] |= 2;
      __syncthreads();
      // parent veto: a node drops out when its parent is selected
      for (int n = tid; n < NC; n += T) {
        bool sel = (flag[n] & 2) && !(par[n] >= 0 && (flag[par[n]] & 2));
        if (sel) flag[n] |= 4;
      }
      __syncthreads();
      double sum_g = 0.0, sum_c = 0.0, n_sel = 0.0;
      for (int n = tid; n < NC; n += T) {
        if (!(flag[n] & 4)) continue;
        n_sel += 1.0;
        bool is_leaf = c0[n] < 0;
        double lb0 = c0[n] >= 0 ? lam[n] + dlam[c0[n]] : 0.0;
        double lb1 = c1[n] >= 0 ? lam[n] + dlam[c1[n]] : 0.0;
        double d = -lam[n] + (lb0 + lb1);
        double wl = win_lo[n], wh = win_hi[n];
        double nt = bounded_exp_u(uprop[n], d, wl, wh > wl ? wh : wl + 1.0);
        nt = clip(nt, wl, wh);
        if (!(nt > wl && nt < wh)) continue;
        flag[n] |= 8;
        double ot = t[n];
        double sign = is_leaf ? 1.0 : -1.0;
        int lo = max(cell_of(fmin(ot, nt), sh, C_real) - MARGIN, 0);
        int hi = min(cell_of(fmax(ot, nt), sh, C_real) + MARGIN, C_real - 1);
        double dq = 0.0;
        for (int c = lo; c <= hi; ++c) {
          double lb = sh.t_lo + sh.t_step * (double)c;
          double dkc = sign * (frac(nt, lb, sh.t_step) - frac(ot, lb, sh.t_step));
          double k = kp[c];
          dq += inv[c] * (0.5 * ((k + dkc) * (k + dkc) - k * k) * Ac[c] -
                          bc[c] * dkc);
        }
        double dcoal = -dq + (is_leaf ? 0.0
                                      : -(log_pop(nt, sh) - log_pop(ot, sh)));
        double lu = log(fmax(uacc[n], 1e-30));
        if (dcoal >= 0.0 || lu < dcoal) {
          flag[n] |= 16;
          new_t[n] = nt;
          c_lo[n] = lo;
          c_hi[n] = hi;
          sum_g += d * (nt - ot);
          sum_c += dcoal;
        }
      }
      block_sum3(sum_g, sum_c, n_sel, red);
      if (tid == 0) {
        dG += sum_g;
        dC += sum_c;
        cntm += n_sel;
      }
      // k_p update, one thread per cell over the accepted nodes (their
      // cells are disjoint, but summing per cell needs no such promise)
      for (int c = tid; c < C_real; c += T) {
        double lb = sh.t_lo + sh.t_step * (double)c;
        double add = 0.0;
        for (int n = 0; n < NC; ++n) {
          if (!(flag[n] & 16) || c < c_lo[n] || c > c_hi[n]) continue;
          double sign = c0[n] < 0 ? 1.0 : -1.0;
          add += sign * (frac(new_t[n], lb, sh.t_step) -
                         frac(t[n], lb, sh.t_step));
        }
        kp[c] += add;
      }
      __syncthreads();
      for (int n = tid; n < NC; n += T)
        if (flag[n] & 16) t[n] = new_t[n];
      __syncthreads();
    }

    // =========== batched branch reform ===========
    {
      const double* uref = u_refu + ub * MC;
      const double* urefacc = u_refacc + ub * NC;
      for (int j = tid; j < MC; j += T) {
        int f = sflag[j] & 3;
        double nm = mut_t[j], ps = 0.0;
        if ((f & 1) && (f & 2)) {
          int n = mnode[j];
          if (n < n_nodes && n != part_root) {
            double tX = t[n];
            double tP = par[n] >= 0 ? t[par[n]] : 0.0;
            double u = fmax(uref[j], 1e-16);
            nm = tP + u * (tX - tP);
            ps = -slope[j] * (nm - mut_t[j]);
            f |= 4;
          }
        }
        sflag[j] = f;
        new_mut[j] = nm;
        per_slot[j] = ps;
      }
      __syncthreads();
      double sum_g = 0.0, z1 = 0.0, z2 = 0.0;
      for (int n = tid; n < NC; n += T) {
        double delta = 0.0;
        for (int k = slot_start[n]; k < slot_start[n + 1]; ++k)
          delta += per_slot[slot_list[k]];
        bool in_batch = n < n_nodes && n != part_root;
        bool acc = in_batch &&
                   (delta >= 0.0 || log(fmax(urefacc[n], 1e-30)) < delta);
        flag[n] = acc ? 32 : 0;
        if (acc) sum_g += delta;
      }
      __syncthreads();
      for (int j = tid; j < MC; j += T)
        if ((sflag[j] & 4) && (flag[mnode[j]] & 32)) mut_t[j] = new_mut[j];
      block_sum3(sum_g, z1, z2, red);
      if (tid == 0) {
        dG += sum_g;
        cntm += (double)iscal[0];
      }
    }
  }

  // ---- write back ----
  for (int n = tid; n < NC; n += T) t_out[(long)p * NC + n] = t[n];
  for (int j = tid; j < MC; j += T) mut_out[(long)p * MC + j] = mut_t[j];
  for (int c = tid; c < C; c += T)
    kp_out[(long)p * C + c] = c < C_real ? kp[c] : kp_in[(long)p * C + c];
  if (tid == 0) {
    acc_out[p * 3 + 0] = dG;
    acc_out[p * 3 + 1] = dC;
    acc_out[p * 3 + 2] = cntm;
  }
}

size_t smem_bytes(int NC, int MC, int C_real, int cpb) {
  int n_seg = C_real / cpb + 1;
  size_t doubles = 11 * (size_t)NC + 4 * (size_t)MC + 5 * (size_t)C_real +
                   n_seg + 3 * THREADS + 8;
  size_t ints = 8 * (size_t)NC + 1 + 3 * (size_t)MC + 4;
  return doubles * sizeof(double) + ints * sizeof(int);
}

}  // namespace

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
  size_t smem = smem_bytes(NC, MC, C_real, cpb);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sweep_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sweep_chain_kernel<<<P, THREADS, smem, (cudaStream_t)stream>>>(
      NC, MC, C, C_real, cpb, n_blocks, t_in, mut_in, kp_in, par, c0, c1, t_min, t_max, lam, dlam, mnode, mvalid, msingle,
      slope, b, A, nbar, isc, fsc, NB, u_pri, u_prop, u_acc, u_refu,
      u_refacc, u_sc, u_norm, S, Z, t_out, mut_out, kp_out, acc_out);
  return (int)cudaGetLastError();
}

extern "C" unsigned long long delphy_sweep_chain_smem_bytes(int NC, int MC,
                                                            int C_real,
                                                            int cpb) {
  return (unsigned long long)smem_bytes(NC, MC, C_real, cpb);
}

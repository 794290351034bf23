// Native topology-burst kernel.
//
// C++ implementation of the host-side SPR/subtree-slide machinery, a direct
// port of THIS repo's validated Python modules (delphy_tpu/topo/{site_deltas,
// history,graft,study,mixer,vsc}.py — which are themselves TPU-era re-designs
// of the reference's core/spr_move.cpp, core/spr_study.cpp, core/subrun.cpp,
// core/very_scalable_coalescent.cpp).  One extern-"C" call runs a whole burst
// of topology moves on a CSR-serialized tree; the GIL is released for the
// duration, so bursts on different tree partitions run on a plain thread pool
// (the reference's ctpl architecture, run.cpp:682-693).
//
// Build: g++ -O2 -std=c++17 -shared -fPIC topo_native.cpp -o _topo_native.so

#include <algorithm>
#include <cassert>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <stdexcept>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

// ---- env-gated phase profiler (DELPHY_TPU_TOPO_PROF=1) ---------------------
struct TopoProf {
  bool on = std::getenv("DELPHY_TPU_TOPO_PROF") != nullptr;
  double acc[8] = {};
  int64_t n = 0;
  static const char* name(int i) {
    static const char* k[8] = {"analyze_peel", "pre_study", "move",
                               "propose",      "post_study", "coal",
                               "apply",        "other"};
    return k[i];
  }
  double now() const {
    return std::chrono::duration<double>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  }
  void dump() const {
    if (!on || n == 0) return;
    std::fprintf(stderr, "[topo_prof] n=%lld", (long long)n);
    for (int i = 0; i < 8; i++)
      std::fprintf(stderr, " %s=%.2fus", name(i), acc[i] / (double)n * 1e6);
    std::fprintf(stderr, "\n");
  }
};
thread_local TopoProf g_prof;
struct ProfPhase {
  int idx;
  double t0;
  explicit ProfPhase(int i) : idx(i), t0(g_prof.on ? g_prof.now() : 0.0) {}
  ~ProfPhase() {
    if (g_prof.on) g_prof.acc[idx] += g_prof.now() - t0;
  }
};

constexpr int32_t NO_NODE = -1;
constexpr double ROOT_DELTA_T = -1.0e30;
constexpr double NEG_BIG = -1.7976931348623157e308;

struct Mut {
  int32_t site;
  int8_t from, to;
  double t;
};

static inline bool mut_less(const Mut& a, const Mut& b) {
  if (a.t != b.t) return a.t < b.t;
  return a.site < b.site;
}

// ---- interval-run site-set helpers -----------------------------------------
// Missations come in long consecutive runs (structured missingness at
// sequence ends / primer dropouts), so site sets are kept as sorted disjoint
// non-adjacent half-open runs [b, e) — the reference's Interval_set
// (core/interval_set.h:14-29) — making all set algebra O(#runs) instead of
// O(#sites).  Invariant: b < e, runs sorted by b, gaps > 0 between runs.

struct SiteRun {
  int32_t b, e;
  friend bool operator==(const SiteRun& x, const SiteRun& y) {
    return x.b == y.b && x.e == y.e;
  }
};

using Sites = std::vector<SiteRun>;

static inline bool sites_contains(const Sites& s, int32_t l) {
  auto it = std::upper_bound(
      s.begin(), s.end(), l,
      [](int32_t v, const SiteRun& r) { return v < r.b; });
  return it != s.begin() && l < (it - 1)->e;
}

static inline int64_t sites_size(const Sites& s) {
  int64_t n = 0;
  for (const SiteRun& r : s) n += r.e - r.b;
  return n;
}

// append [b, e) known to start at or after every existing run's start;
// coalesces with the trailing run when overlapping or adjacent
static inline void sites_append(Sites& s, int32_t b, int32_t e) {
  if (b >= e) return;
  if (!s.empty() && b <= s.back().e) {
    if (e > s.back().e) s.back().e = e;
  } else {
    s.push_back(SiteRun{b, e});
  }
}

static inline Sites sites_union(const Sites& a, const Sites& b) {
  Sites out;
  out.reserve(a.size() + b.size());
  size_t i = 0, j = 0;
  while (i < a.size() || j < b.size()) {
    const SiteRun& r = (j >= b.size() || (i < a.size() && a[i].b <= b[j].b))
                           ? a[i++]
                           : b[j++];
    sites_append(out, r.b, r.e);
  }
  return out;
}

static inline Sites sites_minus(const Sites& a, const Sites& b) {
  Sites out;
  out.reserve(a.size() + b.size());
  size_t j = 0;
  for (const SiteRun& r : a) {
    int32_t lo = r.b;
    while (j < b.size() && b[j].e <= lo) j++;
    size_t jj = j;
    while (lo < r.e) {
      if (jj >= b.size() || b[jj].b >= r.e) {
        out.push_back(SiteRun{lo, r.e});
        break;
      }
      if (b[jj].b > lo) out.push_back(SiteRun{lo, b[jj].b});
      lo = b[jj].e;
      jj++;
    }
  }
  return out;
}

static inline Sites sites_intersect(const Sites& a, const Sites& b) {
  Sites out;
  size_t i = 0, j = 0;
  while (i < a.size() && j < b.size()) {
    int32_t lo = std::max(a[i].b, b[j].b);
    int32_t hi = std::min(a[i].e, b[j].e);
    if (lo < hi) out.push_back(SiteRun{lo, hi});
    if (a[i].e <= b[j].e)
      i++;
    else
      j++;
  }
  return out;
}

// Warm/hot site sets: either a concrete set or "all L sites except excluded"
// (Python: ComplementSites).
struct SiteSet {
  bool complement = false;
  Sites s;

  int64_t size(int32_t L) const {
    return complement ? (int64_t)L - sites_size(s) : sites_size(s);
  }
  bool contains(int32_t l) const {
    bool in = sites_contains(s, l);
    return complement ? !in : in;
  }
  SiteSet minus(const Sites& other) const {
    SiteSet out;
    if (complement) {
      out.complement = true;
      out.s = sites_union(s, other);
    } else {
      out.complement = false;
      out.s = sites_minus(s, other);
    }
    return out;
  }
};

// ---- flat small map ---------------------------------------------------------
// Per-branch delta / from-state maps hold a handful of entries (rarely >30),
// so an unsorted vector with linear probing beats std::unordered_map's
// node-per-entry allocation by a wide margin (profiled: the hash maps +
// malloc/free were ~25% of the whole topology kernel's CPU).  Interface is
// the unordered_map subset this file uses; erase is swap-with-last, and the
// iterator-returning erase supports the erase-while-iterating pattern as
// long as end() is re-read each iteration (it is).

template <typename V>
struct FlatMap {
  using value_type = std::pair<int32_t, V>;
  using vec_t = std::vector<value_type>;
  using iterator = typename vec_t::iterator;
  using const_iterator = typename vec_t::const_iterator;
  vec_t v;

  iterator begin() { return v.begin(); }
  iterator end() { return v.end(); }
  const_iterator begin() const { return v.begin(); }
  const_iterator end() const { return v.end(); }
  size_t size() const { return v.size(); }
  bool empty() const { return v.empty(); }
  void clear() { v.clear(); }

  iterator find(int32_t k) {
    auto it = v.begin();
    for (; it != v.end(); ++it)
      if (it->first == k) break;
    return it;
  }
  const_iterator find(int32_t k) const {
    auto it = v.begin();
    for (; it != v.end(); ++it)
      if (it->first == k) break;
    return it;
  }
  size_t count(int32_t k) const { return find(k) != v.end() ? 1 : 0; }

  std::pair<iterator, bool> emplace(int32_t k, V val) {
    auto it = find(k);
    if (it != v.end()) return {it, false};
    v.emplace_back(k, val);
    return {v.end() - 1, true};
  }
  V& operator[](int32_t k) {
    auto it = find(k);
    if (it != v.end()) return it->second;
    v.emplace_back(k, V{});
    return v.back().second;
  }
  iterator erase(iterator it) {
    *it = v.back();
    v.pop_back();
    return it;
  }
  size_t erase(int32_t k) {
    auto it = find(k);
    if (it == v.end()) return 0;
    erase(it);
    return 1;
  }
};

// ---- tree -----------------------------------------------------------------

struct Node {
  int32_t parent = NO_NODE;
  int32_t c0 = NO_NODE, c1 = NO_NODE;
  double t = 0.0, t_min = 0.0, t_max = 0.0;
  std::vector<Mut> muts;                     // time-ordered (t, site)
  Sites miss;                                // missing sites on this branch
  FlatMap<int8_t> fs;                        // missation from_states != ref
};

struct Tree {
  std::vector<Node> nodes;
  int32_t root = NO_NODE;
  int32_t num_tips = 0;
  int32_t L = 0;
  const uint8_t* ref_seq = nullptr;

  bool is_tip(int32_t n) const { return nodes[n].c0 == NO_NODE; }
  int32_t sibling(int32_t parent, int32_t child) const {
    const Node& p = nodes[parent];
    return p.c0 == child ? p.c1 : p.c0;
  }
};

static inline int8_t get_from_state(const Tree& t, int32_t node, int32_t site) {
  auto it = t.nodes[node].fs.find(site);
  return it != t.nodes[node].fs.end() ? it->second
                                      : (int8_t)t.ref_seq[site];
}

static inline void set_from_state(Tree& t, int32_t node, int32_t site, int8_t s) {
  if (s == (int8_t)t.ref_seq[site])
    t.nodes[node].fs.erase(site);
  else
    t.nodes[node].fs[site] = s;
}

// ---- site-delta algebra (site_deltas.py) ----------------------------------

struct FT { int8_t from, to; };
using Deltas = FlatMap<FT>;

struct DeltaChainBroken : std::runtime_error {
  DeltaChainBroken() : std::runtime_error("delta chain broken") {}
};

static inline void push_back_d(Deltas& d, int32_t site, int8_t frm, int8_t to) {
  auto it = d.find(site);
  if (it != d.end()) {
    if (it->second.to != frm) throw DeltaChainBroken();
    if (it->second.from == to)
      d.erase(it);
    else
      it->second.to = to;
  } else if (frm != to) {
    d.v.emplace_back(site, FT{frm, to});  // find above proved absence
  }
}

static inline void push_front_d(Deltas& d, int32_t site, int8_t frm, int8_t to) {
  auto it = d.find(site);
  if (it != d.end()) {
    if (it->second.from != to) throw DeltaChainBroken();
    if (frm == it->second.to)
      d.erase(it);
    else
      it->second.from = frm;
  } else if (frm != to) {
    d.v.emplace_back(site, FT{frm, to});  // find above proved absence
  }
}

static inline void pop_front_d(Deltas& d, const Mut& m) {
  // drop a leading from->to delta at m's site (the path previously started
  // just above m, now just below); exact inverse of push_front_d for the
  // same mutation (site_deltas.h:100-128 semantics)
  auto it = d.find(m.site);
  if (it != d.end()) {
    if (it->second.from != m.from) throw DeltaChainBroken();
    if (m.to == it->second.to)
      d.erase(it);
    else
      it->second.from = m.to;
  } else {
    d.v.emplace_back(m.site, FT{m.to, m.from});
  }
}

static void compose_d(const Deltas& d1, const Deltas& d2, Deltas& out) {
  out = d1;
  for (const auto& kv : d2) push_back_d(out, kv.first, kv.second.from, kv.second.to);
}

// State of `site` at point (branch, t): first mutation at/above wins.
static int8_t state_at(const Tree& tr, int32_t branch, double t, int32_t site) {
  int32_t cur = branch;
  bool first = true;
  while (cur != NO_NODE) {
    const auto& muts = tr.nodes[cur].muts;
    for (auto it = muts.rbegin(); it != muts.rend(); ++it) {
      if (first && it->t > t) continue;
      if (it->site == site) return it->to;
    }
    first = false;
    cur = tr.nodes[cur].parent;
  }
  return (int8_t)tr.ref_seq[site];
}

// Site deltas between two tree points, composed through the root.
static void deltas_between(const Tree& tr, int32_t ba, double ta,
                           int32_t bb, double tb, Deltas& out) {
  out.clear();
  int32_t cur = ba;
  bool first = true;
  while (cur != NO_NODE) {
    const auto& muts = tr.nodes[cur].muts;
    for (auto it = muts.rbegin(); it != muts.rend(); ++it) {
      if (first && it->t > ta) continue;
      push_back_d(out, it->site, it->to, it->from);
    }
    first = false;
    cur = tr.nodes[cur].parent;
  }
  static thread_local std::vector<int32_t> path;  // not reentrant; per-thread
  path.clear();
  cur = bb;
  while (cur != NO_NODE) {
    path.push_back(cur);
    cur = tr.nodes[cur].parent;
  }
  for (size_t i = path.size(); i-- > 0;) {
    int32_t node = path[i];
    bool last = (i == 0);
    for (const Mut& m : tr.nodes[node].muts) {
      if (last && m.t > tb) break;
      push_back_d(out, m.site, m.from, m.to);
    }
  }
}

// ---- incomplete gamma (study needs Q(a,x) and its inverse) ----------------

// Regularized upper incomplete gamma Q(a, x), series + continued fraction.
static double gamma_Q(double a, double x) {
  if (x < 0.0 || a <= 0.0) return 1.0;
  if (x == 0.0) return 1.0;
  if (x < a + 1.0) {
    // P(a,x) by series, Q = 1 - P
    double ap = a, sum = 1.0 / a, del = sum;
    for (int i = 0; i < 500; i++) {
      ap += 1.0;
      del *= x / ap;
      sum += del;
      if (std::fabs(del) < std::fabs(sum) * 1e-15) break;
    }
    double P = sum * std::exp(-x + a * std::log(x) - std::lgamma(a));
    return std::max(0.0, 1.0 - P);
  }
  // Q by Lentz continued fraction
  double b = x + 1.0 - a, c = 1e300, d = 1.0 / b, h = d;
  for (int i = 1; i < 500; i++) {
    double an = -1.0 * i * (i - a);
    b += 2.0;
    d = an * d + b;
    if (std::fabs(d) < 1e-300) d = 1e-300;
    c = b + an / c;
    if (std::fabs(c) < 1e-300) c = 1e-300;
    d = 1.0 / d;
    double del = d * c;
    h *= del;
    if (std::fabs(del - 1.0) < 1e-15) break;
  }
  return std::exp(-x + a * std::log(x) - std::lgamma(a)) * h;
}

// Inverse of Q(a, .): find x with Q(a, x) = q (bisection; rare path).
static double gamma_Qinv(double a, double q) {
  if (q >= 1.0) return 0.0;
  if (q <= 0.0) return a + 100.0 * std::sqrt(a) + 100.0;
  double lo = 0.0, hi = std::max(a, 1.0);
  while (gamma_Q(a, hi) > q) {
    hi *= 2.0;
    if (hi > 1e12) break;
  }
  for (int i = 0; i < 200; i++) {
    double mid = 0.5 * (lo + hi);
    if (gamma_Q(a, mid) > q)
      lo = mid;
    else
      hi = mid;
    if (hi - lo < 1e-12 * (1.0 + hi)) break;
  }
  return 0.5 * (lo + hi);
}

// log(Q(a, x_min) - Q(a, x_max))  (safe_gamma_math.h:82-90)
static double safe_log_gamma_integral(double a, double x_min, double x_max) {
  double diff = std::max(gamma_Q(a, x_min) - gamma_Q(a, x_max), 0.0);
  return diff > 0.0 ? std::log(diff) : -INFINITY;
}

// ---- RNG ------------------------------------------------------------------

struct Rng {
  std::mt19937_64 g;
  explicit Rng(uint64_t seed) : g(seed) {}
  double uniform() { return std::uniform_real_distribution<double>(0.0, 1.0)(g); }
  double uniform(double a, double b) {
    return std::uniform_real_distribution<double>(a, b)(g);
  }
  int64_t integers(int64_t lo, int64_t hi) {  // [lo, hi)
    return std::uniform_int_distribution<int64_t>(lo, hi - 1)(g);
  }
  double normal(double m, double s) {
    return std::normal_distribution<double>(m, s)(g);
  }
  double exponential(double scale) {
    return std::exponential_distribution<double>(1.0 / scale)(g);
  }
  int64_t poisson(double lam) {
    return std::poisson_distribution<int64_t>(lam)(g);
  }
};

// ---- population models (host mirrors of pop.py / mixer.py adapters) -------

struct PopModel {
  // kind 0: exp (t0, n0, g, min_pop); kind 1: skygrid (type, K knots x, gamma)
  int32_t kind = 0;
  double t0 = 0, n0 = 0, gr = 0, min_pop = 0;
  int32_t sg_type = 1;  // 1 = staircase, 0 = log-linear
  std::vector<double> x, gamma;

  double log_N(double t) const {  // skygrid only
    int32_t M = (int32_t)x.size() - 1;
    int32_t k = (int32_t)(std::lower_bound(x.begin(), x.end(), t) - x.begin());
    if (k == 0) return gamma[0];
    if (k > M) return gamma[M];
    if (sg_type == 1) return gamma[k];
    double c = (t - x[k - 1]) / (x[k] - x[k - 1]);
    return (1 - c) * gamma[k - 1] + c * gamma[k];
  }

  double pop_at(double t) const {
    if (kind == 0)
      return std::max(min_pop, n0 * std::exp((t - t0) * gr));
    return std::exp(log_N(t));
  }

  double pop_integral(double a, double b) const {
    if (kind == 0) {
      double g = gr, mp = min_pop;
      if (mp == 0.0) {
        if (g == 0.0) return (b - a) * n0;
        return n0 / g * std::exp(g * (a - t0)) * std::expm1(g * (b - a));
      }
      if (g == 0.0) return (b - a) * std::max(mp, n0);
      double t_c = t0 + std::log(mp / n0) / g;
      double lo_c = std::min(std::max(t_c, a), b);
      if (g > 0.0) {
        double unc = n0 / g * std::exp(g * (lo_c - t0)) * std::expm1(g * (b - lo_c));
        return (lo_c - a) * mp + unc;
      }
      double unc = n0 / g * std::exp(g * (a - t0)) * std::expm1(g * (lo_c - a));
      return unc + (b - lo_c) * mp;
    }
    // skygrid: piecewise over knot intervals intersecting [a, b]
    int32_t M = (int32_t)x.size() - 1;
    double total = 0.0;
    for (int32_t k = 0; k < M + 2; k++) {
      double lo = std::max(a, k == 0 ? -1e308 : x[k - 1]);
      double hi = std::min(b, k == M + 1 ? 1e308 : x[k]);
      if (hi <= lo) continue;
      if (k == 0)
        total += std::exp(gamma[0]) * (hi - lo);
      else if (k == M + 1)
        total += std::exp(gamma[M]) * (hi - lo);
      else if (sg_type == 1)
        total += std::exp(gamma[k]) * (hi - lo);
      else {
        double c_lo = (lo - x[k - 1]) / (x[k] - x[k - 1]);
        double c_hi = (hi - x[k - 1]) / (x[k] - x[k - 1]);
        double G_lo = (1 - c_lo) * gamma[k - 1] + c_lo * gamma[k];
        double G_hi = (1 - c_hi) * gamma[k - 1] + c_hi * gamma[k];
        double D = G_hi - G_lo;
        if (D == 0.0)
          total += std::exp(G_lo) * (hi - lo);
        else
          total += std::exp(G_lo) * (hi - lo) * std::expm1(D) / D;
      }
    }
    return total;
  }
};

// ---- coalescent adapters --------------------------------------------------

// Host cell grid over [t_lo, t_lo + C*t_step) (mixer.py HostCoalGrid).
struct CoalGrid {
  const PopModel* pop;
  double t_lo = 0, t_step = 0;
  int32_t C = 0;
  std::vector<double> k_bar, popsize_bar;
  std::pair<double, double> pending{0, 0};  // (old_t, new_t) of a proposal

  void build(const Tree& tr, const PopModel* p, int32_t num_cells,
             double t_max_tip) {
    pop = p;
    double t_root = tr.nodes[tr.root].t;
    double span = std::max(t_max_tip - t_root, 1.0);
    t_lo = t_root - 0.35 * span - 1.0;
    t_step = (t_max_tip - t_lo) / num_cells;
    C = num_cells;
    k_bar.assign(C, 0.0);
    for (size_t n = 0; n < tr.nodes.size(); n++) {
      double sign = tr.is_tip((int32_t)n) ? 1.0 : -1.0;
      double rel = (tr.nodes[n].t - t_lo) / t_step;
      // cell i gains sign * clip(rel - i, 0, 1)
      if (rel <= 0.0) continue;
      int32_t full = std::min((int32_t)std::floor(rel), C);
      for (int32_t i = 0; i < full; i++) k_bar[i] += sign;
      if (full < C && rel > full) k_bar[full] += sign * (rel - full);
    }
    popsize_bar.resize(C);
    for (int32_t i = 0; i < C; i++) {
      double lb = t_lo + t_step * i;
      popsize_bar[i] = std::max(pop->pop_integral(lb, lb + t_step) / t_step,
                                1e-100);
    }
  }

  // delta log-prior of moving an inner node old_t -> new_t (no commit)
  double displace_delta(double old_t, double new_t) {
    double delta = 0.0;
    for (int32_t i = 0; i < C; i++) {
      double lb = t_lo + t_step * i;
      double fo = std::min(std::max((old_t - lb) / t_step, 0.0), 1.0);
      double fn = std::min(std::max((new_t - lb) / t_step, 0.0), 1.0);
      double dk = -(fn - fo);  // inner node: sign = -1
      if (dk == 0.0) continue;
      double k = k_bar[i];
      double kn = k + dk;
      delta -= t_step * (kn * (kn - 1.0) - k * (k - 1.0)) / (2.0 * popsize_bar[i]);
    }
    delta -= std::log(pop->pop_at(new_t)) - std::log(pop->pop_at(old_t));
    pending = {old_t, new_t};
    return delta;
  }

  void commit() {
    double old_t = pending.first, new_t = pending.second;
    for (int32_t i = 0; i < C; i++) {
      double lb = t_lo + t_step * i;
      double fo = std::min(std::max((old_t - lb) / t_step, 0.0), 1.0);
      double fn = std::min(std::max((new_t - lb) / t_step, 0.0), 1.0);
      k_bar[i] += -(fn - fo);
    }
  }
};

// Very-scalable partition-decoupled partial prior (vsc.py VscPart).
// Cells grow INTO THE PAST from t_ref: cell_for(t) = floor((t_ref - t)/dt).
struct VscPart {
  const PopModel* pop;
  bool includes_tree_root = false;
  double t_ref = 0, t_step = 0;
  std::vector<double> k_bar_p, k_twiddle_bar_p, k_twiddle_bar, popsize_bar;
  std::vector<double> num_active;
  Rng* rng = nullptr;
  std::pair<double, double> pending{0, 0};

  int32_t cell_for(double t) const {
    return (int32_t)std::floor((t_ref - t) / t_step);
  }

  void ensure_space(double t) {
    if (!includes_tree_root) return;
    int32_t max_cell = cell_for(t);
    for (int32_t i = (int32_t)popsize_bar.size(); i <= max_cell; i++) {
      double lb = t_ref - t_step * (i + 1);
      double ub = t_ref - t_step * i;
      popsize_bar.push_back(std::max(pop->pop_integral(lb, ub) / t_step, 1e-100));
      num_active.push_back(1.0);
    }
    for (int32_t i = (int32_t)k_bar_p.size(); i <= max_cell; i++) {
      double sigma = std::sqrt(popsize_bar[i] / t_step);
      double kt = rng->normal(0.0, sigma);
      k_bar_p.push_back(1.0);
      k_twiddle_bar_p.push_back(kt);
      k_twiddle_bar.push_back(kt);
    }
  }

  void add_interval(double t_start, double t_end, double delta_k) {
    if (t_start < t_end) std::swap(t_start, t_end);
    int32_t cs = cell_for(t_start);
    int32_t ce = (int32_t)k_bar_p.size() - 1;
    double lb_last = t_ref - t_step * (ce + 1);
    if (t_end != lb_last) ce = cell_for(t_end);
    if (cs == ce) {
      k_bar_p[cs] += delta_k * (t_start - t_end) / t_step;
      return;
    }
    double lb_cs = t_ref - t_step * (cs + 1);
    k_bar_p[cs] += delta_k * (t_start - lb_cs) / t_step;
    double ub_ce = t_ref - t_step * ce;
    k_bar_p[ce] += delta_k * (ub_ce - t_end) / t_step;
    for (int32_t c = cs + 1; c < ce; c++) k_bar_p[c] += delta_k;
  }

  double cell_term(int32_t i, double dk) const {
    double old = k_bar_p[i], nw = old + dk;
    return -(t_step / popsize_bar[i]) *
           (0.5 * (nw * nw - old * old) * num_active[i] -
            (k_twiddle_bar_p[i] * num_active[i] - k_twiddle_bar[i] + 0.5) *
                (nw - old));
  }

  double delta_on_add_interval(double min_t, double max_t, double delta_k) {
    ensure_space(min_t);
    if (min_t == max_t) return 0.0;
    int32_t cs = cell_for(max_t), ce = cell_for(min_t);
    if (cs == ce) return cell_term(cs, delta_k * (max_t - min_t) / t_step);
    double out = 0.0;
    double lb_cs = t_ref - t_step * (cs + 1);
    out += cell_term(cs, delta_k * (max_t - lb_cs) / t_step);
    double ub_ce = t_ref - t_step * ce;
    out += cell_term(ce, delta_k * (ub_ce - min_t) / t_step);
    for (int32_t c = cs + 1; c < ce; c++) out += cell_term(c, delta_k);
    return out;
  }

  double displace_delta(double old_t, double new_t) {
    double d = (old_t <= new_t) ? delta_on_add_interval(old_t, new_t, -1.0)
                                : delta_on_add_interval(new_t, old_t, +1.0);
    d -= std::log(pop->pop_at(new_t) / pop->pop_at(old_t));
    pending = {old_t, new_t};
    return d;
  }

  void commit() {
    double old_t = pending.first, new_t = pending.second;
    ensure_space(new_t);
    double sign = (old_t <= new_t) ? -1.0 : +1.0;
    add_interval(old_t, new_t, sign);
  }
};

// Uniform interface used by the mixer.
struct Coal {
  CoalGrid* grid = nullptr;
  VscPart* vsc = nullptr;
  double displace_delta(double old_t, double new_t) {
    return grid ? grid->displace_delta(old_t, new_t)
                : vsc->displace_delta(old_t, new_t);
  }
  void commit() { grid ? grid->commit() : vsc->commit(); }
};

// ---- JC mutational-history samplers (history.py) --------------------------

// k ~ Poisson(lam) conditioned on k >= min_k (distributions.h:77-175).
static int64_t sample_k_truncated_poisson(Rng& rng, double lam, int64_t min_k) {
  if (min_k <= lam) {
    for (;;) {
      int64_t k = rng.poisson(lam);
      if (k >= min_k) return k;
    }
  }
  double max_k = std::max(10.0 * (double)min_k, 10.0 * lam);
  double last_term = 1.0;
  double normalization = std::expm1(lam);
  for (int64_t k = 1; k < min_k; k++) {
    last_term *= lam / (double)k;
    normalization -= last_term;
  }
  double term_before_min_k = last_term;
  if (normalization <= 0.0 ||
      std::fabs(normalization) < 1e-10 * std::expm1(lam)) {
    normalization = 0.0;
    double t = term_before_min_k;
    int64_t k = min_k;
    while ((double)k < max_k) {
      t *= lam / (double)k;
      normalization += t;
      k++;
    }
  }
  double u = rng.uniform(0.0, normalization);
  double cum = 0.0;
  int64_t k = min_k;
  double term_k = term_before_min_k;
  while ((double)k < max_k) {
    term_k *= lam / (double)k;
    cum += term_k;
    if (cum > u) break;
    k++;
  }
  return k;
}

static inline int8_t choose_different_state(Rng& rng, int8_t s) {
  return (int8_t)((s + rng.integers(1, 4)) % 4);
}

// JC trajectory over L sites on [-T, 0] with endpoint constraints `deltas`;
// unconstrained sites start AND end at A (rotated later).
static std::vector<Mut> sample_mutational_history(Rng& rng, int32_t L, double T,
                                                  double mu,
                                                  const Deltas& deltas) {
  std::vector<Mut> result;
  std::vector<int8_t> to_states;
  std::vector<double> times;

  for (const auto& kv : deltas) {
    int32_t l = kv.first;
    int8_t frm = kv.second.from, to = kv.second.to;
    int64_t n;
    for (;;) {
      n = sample_k_truncated_poisson(rng, mu * T, 1);
      int8_t s = frm;
      to_states.clear();
      for (int64_t i = 0; i < n; i++) {
        s = choose_different_state(rng, s);
        to_states.push_back(s);
      }
      if (s == to) break;
    }
    times.clear();
    for (int64_t i = 0; i < n; i++) times.push_back(rng.uniform(-T, 0.0));
    std::sort(times.begin(), times.end());
    int8_t prev = frm;
    for (int64_t i = 0; i < n; i++) {
      result.push_back(Mut{l, prev, to_states[i], times[i]});
      prev = to_states[i];
    }
  }

  double muT = mu * T;
  double p1 = muT * std::exp(-muT);
  double log_one_minus_p_tricky =
      (muT < 1e-4) ? -0.5 * muT * muT : -muT - std::log1p(-p1);
  int64_t l = 0;
  if ((double)L * muT * muT < 2e-6) l = L;
  while (l < L) {
    double rate = -log_one_minus_p_tricky;
    double u = rate > 0 ? rng.exponential(1.0 / rate) : INFINITY;
    if (!(u >= 0 && u < (double)L)) break;
    l += (int64_t)std::floor(u);
    if (l >= L) break;
    if (deltas.count((int32_t)l)) {
      l++;
      continue;
    }
    int64_t n = sample_k_truncated_poisson(rng, muT, 2);
    int8_t s = 0;
    to_states.clear();
    for (int64_t i = 0; i < n; i++) {
      s = choose_different_state(rng, s);
      to_states.push_back(s);
    }
    if (s == 0) {
      times.clear();
      for (int64_t i = 0; i < n; i++) times.push_back(rng.uniform(-T, 0.0));
      std::sort(times.begin(), times.end());
      int8_t prev = 0;
      for (int64_t i = 0; i < n; i++) {
        result.push_back(Mut{(int32_t)l, prev, to_states[i], times[i]});
        prev = to_states[i];
      }
      l++;
    }
    // else: reject, retry same site
  }
  std::sort(result.begin(), result.end(), mut_less);
  return result;
}

// Gillespie backwards from t=0 with per-site end state A.
static std::vector<Mut> sample_unconstrained_mutational_history(Rng& rng,
                                                                int32_t L,
                                                                double T,
                                                                double mu) {
  FlatMap<int8_t> cur_state;
  std::vector<Mut> trajectory;
  double t = 0.0;
  for (;;) {
    t -= rng.exponential(1.0 / (mu * (double)L));
    if (t <= -T) break;
    int32_t l = (int32_t)rng.integers(0, L);
    auto it = cur_state.find(l);
    int8_t s = it != cur_state.end() ? it->second : (int8_t)0;
    int8_t next_s = choose_different_state(rng, s);
    trajectory.push_back(Mut{l, next_s, s, t});
    cur_state[l] = next_s;
  }
  std::reverse(trajectory.begin(), trajectory.end());
  return trajectory;
}

// Shift times to absolute (ending at end_loc) and rotate non-delta sites so
// the trajectory ends at the true state at end_loc.
static void adjust_mutational_history(std::vector<Mut>& history,
                                      const Deltas& site_deltas,
                                      const Tree& tree, int32_t end_branch,
                                      double end_t) {
  FlatMap<int8_t> end_states;
  for (auto it = history.rbegin(); it != history.rend(); ++it) {
    Mut& m = *it;
    m.t += end_t;
    if (!site_deltas.count(m.site)) {
      int8_t end_state;
      auto es = end_states.find(m.site);
      if (es != end_states.end()) {
        end_state = es->second;
      } else {
        end_state = state_at(tree, end_branch, end_t, m.site);
        end_states[m.site] = end_state;
      }
      m.from = (int8_t)((m.from + end_state) % 4);
      m.to = (int8_t)((m.to + end_state) % 4);
    }
  }
}

// ---- graft machinery (graft.py / SprContext) ------------------------------

struct BranchInfo {
  int32_t A = NO_NODE, B = NO_NODE;
  bool is_open = false;
  double T_to_X = 0.0;
  double partial_lambda_at_A = 0.0, partial_lambda_at_X = 0.0;
  SiteSet warm_sites, hot_sites;
  std::vector<Mut> hot_muts_to_X;
  Deltas hot_deltas_to_X;

  void reset() {  // restore defaults, keep inner-vector capacity
    A = B = NO_NODE;
    is_open = false;
    T_to_X = partial_lambda_at_A = partial_lambda_at_X = 0.0;
    warm_sites.complement = hot_sites.complement = false;
    warm_sites.s.clear();
    hot_sites.s.clear();
    hot_muts_to_X.clear();
    hot_deltas_to_X.clear();
  }
};

struct Graft {
  int32_t X = NO_NODE, S = NO_NODE;
  double t_P = 0.0;
  bool rooty = false;
  std::vector<BranchInfo> branch_infos;
  double delta_log_G = 0.0, log_alpha_mut = 0.0;
  // recycled BranchInfo slots: soft_clear() parks used slots here instead of
  // destroying them, so their inner vectors keep capacity across moves
  std::vector<BranchInfo> spare_;

  void soft_clear() {
    X = S = NO_NODE;
    t_P = 0.0;
    rooty = false;
    delta_log_G = log_alpha_mut = 0.0;
    while (!branch_infos.empty()) {
      spare_.push_back(std::move(branch_infos.back()));
      branch_infos.pop_back();
    }
  }
  BranchInfo& emplace_bi() {
    if (!spare_.empty()) {
      branch_infos.push_back(std::move(spare_.back()));
      spare_.pop_back();
      branch_infos.back().reset();
    } else {
      branch_infos.emplace_back();
    }
    return branch_infos.back();
  }
};

static void clamp_times(std::vector<Mut>& muts, double t_lo, double t_hi) {
  double span = t_hi - t_lo;
  double eps = 1e-12 * std::max({std::fabs(t_lo), std::fabs(t_hi), 1.0});
  double lo = t_lo + std::min(eps, 0.5 * span);
  for (Mut& m : muts) {
    if (m.t <= t_lo)
      m.t = lo;
    else if (m.t > t_hi)
      m.t = t_hi;
  }
}

struct SprContext {
  Tree& tree;
  double mu;
  const double* nu;     // [L]
  const int32_t* part;  // [L] per-site partitions (mpox hack; all 0 normally)
  std::vector<double> qtab;   // [P*16] per-partition rate matrices
  std::vector<double> qatab;  // [P*4] per-partition escape rates
  const double* pi;     // [4]
  bool can_change_root;
  std::vector<double> ref_cum_Q;  // [L+1]
  double lambda_ref;
  double mu_proposal = -1.0;
  // per-context scratch reused across moves (capacity persists; move() is
  // not reentrant, and each context is owned by one burst thread)
  Deltas mv_deltas_nexus_to_X;
  Deltas mv_d_new_to_old;
  Deltas mv_new_deltas;
  std::vector<Mut> mv_merged;
  std::vector<int32_t> mv_path_up;

  double qa(int32_t l, int a) const { return qatab[part[l] * 4 + a]; }
  double qrate(int32_t l, int a, int b) const {
    return qtab[part[l] * 16 + a * 4 + b];
  }

  SprContext(Tree& t, double mu_, const double* nu_, const double* q_,
             int32_t P, const int32_t* part_, const double* pi_, bool ccr)
      : tree(t), mu(mu_), nu(nu_), part(part_), pi(pi_),
        can_change_root(ccr) {
    qtab.assign(q_, q_ + P * 16);
    qatab.resize(P * 4);
    for (int p = 0; p < P; p++)
      for (int a = 0; a < 4; a++) qatab[p * 4 + a] = -q_[p * 16 + a * 4 + a];
    ref_cum_Q.resize(t.L + 1);
    ref_cum_Q[0] = 0.0;
    for (int32_t l = 0; l < t.L; l++)
      ref_cum_Q[l + 1] = ref_cum_Q[l] + mu * nu[l] * qa(l, t.ref_seq[l]);
    lambda_ref = ref_cum_Q[t.L];
  }

  void begin_move() { mu_proposal = mu_jc(); }

  double delta_lambda_across_branch(int32_t node) const {
    const Node& nd = tree.nodes[node];
    double out = 0.0;
    for (const Mut& m : nd.muts)
      out += mu * nu[m.site] * (qa(m.site, m.to) - qa(m.site, m.from));
    // missations: stored as interval runs; subtract the telescoped ref
    // rate per run, then correct for non-ref from_states
    for (const SiteRun& r : nd.miss) out -= ref_cum_Q[r.e] - ref_cum_Q[r.b];
    for (const auto& kv : nd.fs)
      out -= mu * nu[kv.first] *
             (qa(kv.first, kv.second) - qa(kv.first, tree.ref_seq[kv.first]));
    return out;
  }

  double lambda_at(int32_t node) const {
    double out = lambda_ref;
    int32_t cur = node;
    while (cur != NO_NODE) {
      out += delta_lambda_across_branch(cur);
      cur = tree.nodes[cur].parent;
    }
    return out;
  }

  // lambda contribution of a sliding missation set just above its position
  double lam_over_miss(const Sites& sites,
                       const FlatMap<int8_t>& from) const {
    // ref-state part telescopes over each run via the ref_cum_Q prefix
    // sums — O(#runs); the few from-state exceptions are corrected from
    // the (small) fs map afterwards
    double out = 0.0;
    for (const SiteRun& r : sites) out += ref_cum_Q[r.e] - ref_cum_Q[r.b];
    for (const auto& kv : from) {
      int32_t l = kv.first;
      if (!sites_contains(sites, l)) continue;
      out += mu * nu[l] * (qa(l, kv.second) - qa(l, (int8_t)tree.ref_seq[l]));
    }
    return out;
  }

  int64_t num_missing_at(int32_t node) const {
    int64_t out = 0;
    int32_t cur = node;
    while (cur != NO_NODE) {
      out += sites_size(tree.nodes[cur].miss);
      cur = tree.nodes[cur].parent;
    }
    return out;
  }

  double mu_jc() const {
    return lambda_at(tree.root) /
           (double)((int64_t)tree.L - num_missing_at(tree.root));
  }

  double branch_log_G(double t_P, double t_X, double lam_X,
                      const std::vector<Mut>& muts) const {
    double r = -lam_X * (t_X - t_P);
    for (const Mut& m : muts) {
      r -= mu * nu[m.site] * (qa(m.site, m.from) - qa(m.site, m.to)) * (m.t - t_P);
      r += std::log(mu * nu[m.site] * qrate(m.site, m.from, m.to));
    }
    return r;
  }

  bool is_site_missing_at(int32_t node, int32_t site) const {
    int32_t cur = node;
    while (cur != NO_NODE) {
      if (sites_contains(tree.nodes[cur].miss, site)) return true;
      cur = tree.nodes[cur].parent;
    }
    return false;
  }

  void miss_at_or_above(int32_t node, Sites& out) const {
    // single run gather + sort + coalesce instead of repeated set_unions up
    // the root path (ancestor miss sets are disjoint after canonical
    // factoring, but the coalescing merge keeps this robust to transient
    // non-canonical states); fills a caller-owned scratch so the hot path
    // never allocates
    out.clear();
    int32_t cur = node;
    while (cur != NO_NODE) {
      const Sites& m = tree.nodes[cur].miss;
      out.insert(out.end(), m.begin(), m.end());
      cur = tree.nodes[cur].parent;
    }
    std::sort(out.begin(), out.end(),
              [](const SiteRun& x, const SiteRun& y) { return x.b < y.b; });
    size_t w = 0;
    for (size_t i = 0; i < out.size(); i++) {
      if (w > 0 && out[i].b <= out[w - 1].e) {
        if (out[i].e > out[w - 1].e) out[w - 1].e = out[i].e;
      } else {
        out[w++] = out[i];
      }
    }
    out.resize(w);
  }

  // -- analysis -------------------------------------------------------------

  void analyze_graft(int32_t X, Graft& g) {
    start_graft_analysis(X, g);
    finish_graft_analysis(g);
  }

  void propose_new_graft(int32_t X, Rng& rng, Graft& g) {
    {
      ProfPhase pp(7);
      start_graft_analysis(X, g);
    }
    propose_new_graft_mutations(g, rng);
    finish_graft_analysis(g);
  }

  void start_graft_analysis(int32_t X, Graft& g) {
    if (tree.nodes[X].parent == tree.root)
      start_rooty(X, g);
    else
      start_inner(X, g);
  }

  // X is a child of the root (graft.py _start_rooty)
  void start_rooty(int32_t X, Graft& g) {
    Tree& t = tree;
    int32_t P = t.nodes[X].parent;
    int32_t S = t.sibling(P, X);
    double t_X = t.nodes[X].t, t_P = t.nodes[P].t, t_S = t.nodes[S].t;
    const Sites& miss_P = t.nodes[P].miss;
    const Sites& miss_X = t.nodes[X].miss;
    const Sites& miss_S = t.nodes[S].miss;

    g.soft_clear();
    g.X = X; g.S = S; g.t_P = t_P; g.rooty = true;
    g.emplace_bi(); g.emplace_bi(); g.emplace_bi();

    BranchInfo& px = g.branch_infos[0];
    px.A = P; px.B = X; px.is_open = true; px.T_to_X = t_X - t_P;
    px.warm_sites.s = miss_S;
    px.hot_sites = px.warm_sites;
    px.partial_lambda_at_A = lam_over_miss(miss_S, t.nodes[S].fs);
    px.partial_lambda_at_X = px.partial_lambda_at_A;
    for (const Mut& m : t.nodes[X].muts) {
      if (px.hot_sites.contains(m.site)) {
        px.hot_muts_to_X.push_back(m);
        px.partial_lambda_at_X +=
            mu * nu[m.site] * (qa(m.site, m.to) - qa(m.site, m.from));
      }
    }

    BranchInfo& ps = g.branch_infos[1];
    ps.A = P; ps.B = S; ps.is_open = true; ps.T_to_X = t_S - t_P;
    ps.warm_sites.s = miss_X;
    ps.hot_sites = ps.warm_sites;
    ps.partial_lambda_at_A = lam_over_miss(miss_X, t.nodes[X].fs);
    ps.partial_lambda_at_X = ps.partial_lambda_at_A;
    for (const Mut& m : t.nodes[S].muts) {
      if (ps.hot_sites.contains(m.site)) {
        ps.hot_muts_to_X.push_back(m);
        ps.partial_lambda_at_X +=
            mu * nu[m.site] * (qa(m.site, m.to) - qa(m.site, m.from));
      }
    }

    BranchInfo& spx = g.branch_infos[2];
    spx.A = S; spx.B = P; spx.is_open = false;
    spx.T_to_X = (t_S - t_P) + (t_X - t_P);
    spx.warm_sites.complement = true;
    spx.warm_sites.s = sites_union(sites_union(miss_P, miss_X), miss_S);
    spx.hot_sites = spx.warm_sites;
    spx.partial_lambda_at_X = lambda_at(X) - px.partial_lambda_at_X;
    spx.partial_lambda_at_A = lambda_at(S) - ps.partial_lambda_at_X;
    const auto& smuts = t.nodes[S].muts;
    for (auto it = smuts.rbegin(); it != smuts.rend(); ++it) {
      if (spx.hot_sites.contains(it->site)) {
        Mut rm{it->site, it->to, it->from, t_P - (it->t - t_P)};
        spx.hot_muts_to_X.push_back(rm);
        push_back_d(spx.hot_deltas_to_X, rm.site, rm.from, rm.to);
      }
    }
    for (const Mut& m : t.nodes[X].muts) {
      if (spx.hot_sites.contains(m.site)) {
        spx.hot_muts_to_X.push_back(m);
        push_back_d(spx.hot_deltas_to_X, m.site, m.from, m.to);
      }
    }
  }

  // inner graft analysis (graft.py _start_inner)
  void start_inner(int32_t X, Graft& g) {
    Tree& t = tree;
    int32_t P = t.nodes[X].parent;
    int32_t S = t.sibling(P, X);
    double t_X = t.nodes[X].t, t_P = t.nodes[P].t;

    g.soft_clear();
    g.X = X; g.S = S; g.t_P = t_P; g.rooty = false;

    {
      BranchInfo& px = g.emplace_bi();
      px.A = P; px.B = X; px.is_open = false; px.T_to_X = t_X - t_P;
      px.warm_sites.complement = true;  // all sites
      const Sites& miss_S0 = t.nodes[S].miss;
      px.hot_sites = px.warm_sites.minus(miss_S0);

      px.partial_lambda_at_A = lambda_at(X);
      const auto& xmuts = t.nodes[X].muts;
      for (auto it = xmuts.rbegin(); it != xmuts.rend(); ++it)
        px.partial_lambda_at_A +=
            mu * nu[it->site] * (qa(it->site, it->from) - qa(it->site, it->to));
    }
    const Sites& miss_S = t.nodes[S].miss;
    Sites sliding_sites = miss_S;
    FlatMap<int8_t> sliding_from = t.nodes[S].fs;
    double next_plB = lam_over_miss(sliding_sites, sliding_from);
    g.branch_infos[0].partial_lambda_at_A -= next_plB;

    int32_t cur = P;
    int32_t parent = t.nodes[cur].parent;
    double partial_lambda = next_plB;
    while (!sliding_sites.empty()) {
      int32_t sib = t.sibling(parent, cur);
      BranchInfo& bi = g.emplace_bi();
      bi.A = parent; bi.B = cur; bi.is_open = false;
      bi.T_to_X = t_X - t.nodes[parent].t;
      bi.warm_sites.s = sliding_sites;

      const auto& cmuts = t.nodes[cur].muts;
      for (auto it = cmuts.rbegin(); it != cmuts.rend(); ++it) {
        if (sites_contains(sliding_sites, it->site)) {
          partial_lambda +=
              mu * nu[it->site] * (qa(it->site, it->from) - qa(it->site, it->to));
          if (it->from == (int8_t)t.ref_seq[it->site])
            sliding_from.erase(it->site);
          else
            sliding_from[it->site] = it->from;
        }
      }

      bi.hot_sites.s = sites_minus(bi.warm_sites.s, t.nodes[sib].miss);
      sliding_sites = sites_minus(bi.warm_sites.s, bi.hot_sites.s);
      for (auto it = sliding_from.begin(); it != sliding_from.end();) {
        if (!sites_contains(sliding_sites, it->first))
          it = sliding_from.erase(it);
        else
          ++it;
      }

      next_plB = lam_over_miss(sliding_sites, sliding_from);
      bi.partial_lambda_at_A = partial_lambda - next_plB;
      partial_lambda = next_plB;

      if (parent != t.root) {
        cur = parent;
        parent = t.nodes[cur].parent;
      } else {
        if (!can_change_root) {
          // NB: `bi` stays valid here — no emplace since it was created
          bi.hot_sites = bi.warm_sites;
          bi.partial_lambda_at_A += partial_lambda;
        } else if (!sliding_sites.empty()) {
          BranchInfo& fo = g.emplace_bi();  // may invalidate `bi`
          fo.A = NO_NODE; fo.B = t.root; fo.is_open = true;
          fo.T_to_X = t_X - t.nodes[parent].t;
          fo.warm_sites.s = sliding_sites;
          fo.hot_sites = fo.warm_sites;
          fo.partial_lambda_at_A = partial_lambda;
        }
        sliding_sites.clear();
        sliding_from.clear();
      }
    }

    // distribute hot mutations along the hot path
    size_t nbi = g.branch_infos.size();
    for (size_t i = 0; i < nbi; i++) {
      BranchInfo& bi = g.branch_infos[i];
      if (bi.B == t.root) continue;
      const auto& bmuts = t.nodes[bi.B].muts;
      for (auto it = bmuts.rbegin(); it != bmuts.rend(); ++it) {
        if (bi.warm_sites.contains(it->site)) {
          for (size_t j = i; j < nbi; j++) {
            if (g.branch_infos[j].hot_sites.contains(it->site))
              g.branch_infos[j].hot_muts_to_X.push_back(*it);
          }
        }
      }
    }

    for (BranchInfo& bi : g.branch_infos) {
      std::reverse(bi.hot_muts_to_X.begin(), bi.hot_muts_to_X.end());
      bi.partial_lambda_at_X = bi.partial_lambda_at_A;
      for (const Mut& m : bi.hot_muts_to_X) {
        if (!bi.is_open)
          push_back_d(bi.hot_deltas_to_X, m.site, m.from, m.to);
        bi.partial_lambda_at_X +=
            mu * nu[m.site] * (qa(m.site, m.to) - qa(m.site, m.from));
      }
    }
  }

  // -- proposal of new graft mutations (graft.py _propose_new_graft_mutations)
  void propose_new_graft_mutations(Graft& g, Rng& rng) {
    Tree& t = tree;
    int32_t X = g.X;
    double mu_prop = mu_proposal >= 0.0 ? mu_proposal : mu_jc();
    int32_t L = t.L;
    for (size_t idx = 0; idx < g.branch_infos.size(); idx++) {
      BranchInfo& bi = g.branch_infos[idx];
      if (bi.hot_sites.size(L) == 0) {
        bi.hot_muts_to_X.clear();
        continue;
      }
      std::vector<Mut> new_muts;
      if (bi.is_open)
        new_muts = sample_unconstrained_mutational_history(rng, L, bi.T_to_X,
                                                           mu_prop);
      else
        new_muts = sample_mutational_history(rng, L, bi.T_to_X, mu_prop,
                                             bi.hot_deltas_to_X);
      if (!new_muts.empty()) {
        std::vector<Mut> kept;
        kept.reserve(new_muts.size());
        for (const Mut& m : new_muts) {
          if (!bi.hot_sites.contains(m.site)) continue;
          if (!g.rooty && bi.B == X) {
            // hot sites at the P->X level may include sites actually missing
            // at X via far-upstream missations
            if (!bi.hot_deltas_to_X.count(m.site) &&
                is_site_missing_at(X, m.site))
              continue;
          }
          kept.push_back(m);
        }
        new_muts = std::move(kept);
        int32_t end_branch;
        double end_t;
        if (g.rooty && idx == 1 /*K_BRANCH_INFO_P_S*/) {
          end_branch = g.S;
          end_t = t.nodes[g.S].t;
        } else {
          end_branch = X;
          end_t = t.nodes[X].t;
        }
        adjust_mutational_history(new_muts, bi.hot_deltas_to_X, t, end_branch,
                                  end_t);
      }
      bi.hot_muts_to_X = std::move(new_muts);
      if (bi.is_open) {
        bi.partial_lambda_at_A = bi.partial_lambda_at_X;
        for (auto it = bi.hot_muts_to_X.rbegin(); it != bi.hot_muts_to_X.rend();
             ++it)
          bi.partial_lambda_at_A +=
              mu * nu[it->site] * (qa(it->site, it->from) - qa(it->site, it->to));
      }
    }
  }

  // -- finish: delta_log_G + log_alpha_mut (graft.py _finish_graft_analysis)
  void finish_graft_analysis(Graft& g) {
    Tree& t = tree;
    int32_t X = g.X;
    double t_X = t.nodes[X].t;
    double mu_prop = mu_proposal >= 0.0 ? mu_proposal : mu_jc();
    g.delta_log_G = 0.0;
    if (g.rooty) {
      int32_t P = t.nodes[X].parent;
      int32_t S = t.sibling(P, X);
      double t_P = t.nodes[P].t, t_S = t.nodes[S].t;
      BranchInfo& px = g.branch_infos[0];
      BranchInfo& ps = g.branch_infos[1];
      BranchInfo& spx = g.branch_infos[2];
      g.delta_log_G +=
          branch_log_G(t_P, t_X, px.partial_lambda_at_X, px.hot_muts_to_X);
      g.delta_log_G +=
          branch_log_G(t_P, t_S, ps.partial_lambda_at_X, ps.hot_muts_to_X);
      std::vector<Mut> spx_ps, spx_px;
      for (auto it = spx.hot_muts_to_X.rbegin(); it != spx.hot_muts_to_X.rend();
           ++it)
        if (it->t < t_P)
          spx_ps.push_back(Mut{it->site, it->to, it->from, t_P + (t_P - it->t)});
      for (const Mut& m : spx.hot_muts_to_X)
        if (m.t >= t_P) spx_px.push_back(m);
      g.delta_log_G +=
          branch_log_G(t_P, t_X, spx.partial_lambda_at_X, spx_px);
      g.delta_log_G +=
          branch_log_G(t_P, t_S, spx.partial_lambda_at_A, spx_ps);
      for (const Mut& m : px.hot_muts_to_X)
        g.delta_log_G += std::log(pi[m.from] / pi[m.to]);
      for (const Mut& m : ps.hot_muts_to_X)
        g.delta_log_G += std::log(pi[m.from] / pi[m.to]);
      for (const Mut& m : spx_ps)
        g.delta_log_G += std::log(pi[m.from] / pi[m.to]);
    } else {
      for (BranchInfo& bi : g.branch_infos)
        g.delta_log_G += branch_log_G(t_X - bi.T_to_X, t_X,
                                      bi.partial_lambda_at_X, bi.hot_muts_to_X);
      if (g.branch_infos.back().is_open)
        for (const Mut& m : g.branch_infos.back().hot_muts_to_X)
          g.delta_log_G += std::log(pi[m.from] / pi[m.to]);
    }

    g.log_alpha_mut = 0.0;
    for (BranchInfo& bi : g.branch_infos) {
      int64_t Lh = bi.hot_sites.size(t.L);
      if (!g.rooty && bi.B == X)
        Lh = ((int64_t)t.L - num_missing_at(X)) -
             (bi.warm_sites.size(t.L) - bi.hot_sites.size(t.L));
      double T = bi.T_to_X;
      int64_t M = (int64_t)bi.hot_muts_to_X.size();
      g.log_alpha_mut +=
          -mu_prop * (double)Lh * T + (double)M * std::log(mu_prop / 3.0);
      if (!bi.is_open) {
        int64_t d = (int64_t)bi.hot_deltas_to_X.size();
        double P_AC = -0.25 * std::expm1(-4.0 / 3.0 * mu_prop * T);
        g.log_alpha_mut -= ((double)(Lh - d) * std::log1p(-3.0 * P_AC) +
                            (double)d * std::log(P_AC));
      }
    }
  }

  // ---- peel / apply (graft.py) -------------------------------------------

  Deltas root_deltas() const {
    Deltas out;
    for (const Mut& m : tree.nodes[tree.root].muts)
      push_back_d(out, m.site, m.from, m.to);
    return out;
  }

  void set_root_deltas(const Deltas& deltas) {
    std::vector<Mut>& rm = tree.nodes[tree.root].muts;
    rm.clear();
    for (const auto& kv : deltas)
      rm.push_back(Mut{kv.first, kv.second.from, kv.second.to, ROOT_DELTA_T});
    std::sort(rm.begin(), rm.end(),
              [](const Mut& a, const Mut& b) { return a.site < b.site; });
  }

  void peel_graft(Graft& g) { g.rooty ? peel_rooty(g) : peel_inner(g); }
  void apply_graft(Graft& g) { g.rooty ? apply_rooty(g) : apply_inner(g); }

  void peel_rooty(Graft& g) {
    Tree& t = tree;
    int32_t X = g.X;
    int32_t P = t.nodes[X].parent;
    int32_t S = t.sibling(P, X);
    double t_X = t.nodes[X].t, t_P = t.nodes[P].t;
    BranchInfo& px = g.branch_infos[0];
    BranchInfo& ps = g.branch_infos[1];
    BranchInfo& spx = g.branch_infos[2];

    Deltas ref_to_root = root_deltas();

    for (const Mut& m : t.nodes[X].muts) {
      if (px.hot_sites.contains(m.site)) {
        push_back_d(ref_to_root, m.site, m.from, m.to);
        set_from_state(t, S, m.site, m.to);
      }
    }
    for (const Mut& m : t.nodes[S].muts) {
      if (ps.hot_sites.contains(m.site)) {
        push_back_d(ref_to_root, m.site, m.from, m.to);
        set_from_state(t, X, m.site, m.to);
      }
    }
    for (const Mut& m : t.nodes[S].muts) {
      if (spx.hot_sites.contains(m.site))
        push_back_d(ref_to_root, m.site, m.from, m.to);
    }
    t.nodes[X].muts.clear();
    t.nodes[S].muts.clear();

    double t_mid = 0.5 * (t_P + t_X);
    std::vector<std::pair<int32_t, FT>> sorted_deltas(
        spx.hot_deltas_to_X.begin(), spx.hot_deltas_to_X.end());
    std::sort(sorted_deltas.begin(), sorted_deltas.end(),
              [](const auto& a, const auto& b) { return a.first < b.first; });
    for (const auto& kv : sorted_deltas)
      t.nodes[X].muts.push_back(
          Mut{kv.first, kv.second.from, kv.second.to, t_mid});
    set_root_deltas(ref_to_root);
  }

  void apply_rooty(Graft& g) {
    Tree& t = tree;
    int32_t X = g.X;
    int32_t P = t.nodes[X].parent;
    int32_t S = t.sibling(P, X);
    double t_X = t.nodes[X].t, t_P = t.nodes[P].t, t_S = t.nodes[S].t;
    BranchInfo& px = g.branch_infos[0];
    BranchInfo& ps = g.branch_infos[1];
    BranchInfo& spx = g.branch_infos[2];

    t.nodes[X].muts.clear();
    Deltas ref_to_root = root_deltas();

    for (auto it = px.hot_muts_to_X.rbegin(); it != px.hot_muts_to_X.rend();
         ++it) {
      t.nodes[X].muts.push_back(*it);
      push_back_d(ref_to_root, it->site, it->to, it->from);
      set_from_state(t, S, it->site, it->from);
    }
    for (auto it = ps.hot_muts_to_X.rbegin(); it != ps.hot_muts_to_X.rend();
         ++it) {
      t.nodes[S].muts.push_back(*it);
      push_back_d(ref_to_root, it->site, it->to, it->from);
      set_from_state(t, X, it->site, it->from);
    }
    for (const Mut& m : spx.hot_muts_to_X) {
      if (m.t > t_P) {
        t.nodes[X].muts.push_back(m);
      } else {
        t.nodes[S].muts.push_back(Mut{m.site, m.to, m.from, t_P + (t_P - m.t)});
        push_back_d(ref_to_root, m.site, m.from, m.to);
      }
    }

    std::sort(t.nodes[X].muts.begin(), t.nodes[X].muts.end(), mut_less);
    std::sort(t.nodes[S].muts.begin(), t.nodes[S].muts.end(), mut_less);
    clamp_times(t.nodes[X].muts, t_P, t_X);
    clamp_times(t.nodes[S].muts, t_P, t_S);
    set_root_deltas(ref_to_root);
  }

  void peel_inner(Graft& g) {
    Tree& t = tree;
    int32_t X = g.X;
    int32_t P = t.nodes[X].parent;
    double t_X = t.nodes[X].t, t_P = t.nodes[P].t;
    BranchInfo& final_bi = g.branch_infos.back();

    Deltas ref_to_root = final_bi.is_open ? root_deltas() : Deltas{};

    for (BranchInfo& bi : g.branch_infos) {
      if (bi.B == t.root) continue;
      if (bi.B == X && !final_bi.is_open) {
        t.nodes[X].muts.clear();
        continue;
      }
      std::vector<Mut> keep;
      auto& bmuts = t.nodes[bi.B].muts;
      for (auto it = bmuts.rbegin(); it != bmuts.rend(); ++it) {
        const Mut& m = *it;
        if (bi.warm_sites.contains(m.site) &&
            !(final_bi.is_open && final_bi.hot_sites.contains(m.site))) {
          // slide downstream to the P-X branch, adjusting the from_state of
          // every sibling missation along the way
          int32_t cur = X;
          while (cur != bi.B) {
            int32_t parent = t.nodes[cur].parent;
            int32_t sib = t.sibling(parent, cur);
            set_from_state(t, sib, m.site, m.from);
            cur = parent;
          }
        } else {
          keep.push_back(m);
        }
      }
      std::reverse(keep.begin(), keep.end());
      bmuts = std::move(keep);
    }

    if (final_bi.is_open) {
      for (auto bit = g.branch_infos.rbegin(); bit != g.branch_infos.rend();
           ++bit) {
        BranchInfo& bi = *bit;
        if (bi.B == t.root) continue;
        std::vector<Mut> keep;
        for (const Mut& m : t.nodes[bi.B].muts) {
          if (final_bi.hot_sites.contains(m.site)) {
            // slide upstream past the root
            int32_t cur = bi.B;
            while (cur != t.root) {
              int32_t parent = t.nodes[cur].parent;
              int32_t sib = t.sibling(parent, cur);
              set_from_state(t, sib, m.site, m.to);
              cur = parent;
            }
            push_back_d(ref_to_root, m.site, m.from, m.to);
          } else {
            keep.push_back(m);
          }
        }
        t.nodes[bi.B].muts = std::move(keep);
      }
    }

    double t_mid = 0.5 * (t_P + t_X);
    for (BranchInfo& bi : g.branch_infos) {
      if (bi.B == t.root) continue;
      std::vector<std::pair<int32_t, FT>> sd(bi.hot_deltas_to_X.begin(),
                                             bi.hot_deltas_to_X.end());
      std::sort(sd.begin(), sd.end(),
                [](const auto& a, const auto& b) { return a.first < b.first; });
      for (const auto& kv : sd)
        t.nodes[X].muts.push_back(
            Mut{kv.first, kv.second.from, kv.second.to, t_mid});
    }
    std::sort(t.nodes[X].muts.begin(), t.nodes[X].muts.end(), mut_less);

    if (final_bi.is_open) set_root_deltas(ref_to_root);
  }

  void apply_inner(Graft& g) {
    Tree& t = tree;
    int32_t X = g.X;
    BranchInfo& final_bi = g.branch_infos.back();
    t.nodes[X].muts.clear();

    Deltas ref_to_root = final_bi.is_open ? root_deltas() : Deltas{};

    for (BranchInfo& bi : g.branch_infos) {
      if (bi.B == X) {
        t.nodes[X].muts = bi.hot_muts_to_X;
      } else if (!bi.is_open) {
        for (const Mut& m : bi.hot_muts_to_X) {
          int32_t cur = X;
          while (cur != bi.A) {
            int32_t parent = t.nodes[cur].parent;
            if (t.nodes[parent].t <= m.t && m.t < t.nodes[cur].t) {
              t.nodes[cur].muts.push_back(m);
              break;
            }
            int32_t sib = t.sibling(parent, cur);
            set_from_state(t, sib, m.site, m.to);
            cur = parent;
          }
        }
      } else {
        for (auto it = bi.hot_muts_to_X.rbegin(); it != bi.hot_muts_to_X.rend();
             ++it) {
          const Mut& m = *it;
          int32_t cur = X;
          while (cur != t.root) {
            int32_t parent = t.nodes[cur].parent;
            if (t.nodes[parent].t <= m.t && m.t < t.nodes[cur].t)
              t.nodes[cur].muts.push_back(m);
            if (t.nodes[parent].t <= m.t) {
              int32_t sib = t.sibling(parent, cur);
              set_from_state(t, sib, m.site, m.from);
            }
            cur = parent;
          }
          push_back_d(ref_to_root, m.site, m.to, m.from);
        }
      }
    }

    for (BranchInfo& bi : g.branch_infos) {
      if (!bi.is_open && bi.B != t.root) {
        double t_A = t.nodes[bi.A].t, t_B = t.nodes[bi.B].t;
        std::sort(t.nodes[bi.B].muts.begin(), t.nodes[bi.B].muts.end(),
                  mut_less);
        clamp_times(t.nodes[bi.B].muts, t_A, t_B);
      }
    }

    if (final_bi.is_open) set_root_deltas(ref_to_root);
  }

  // ---- the prune-regraft move (graft.py SprContext.move) ------------------

  void move(int32_t X, int32_t SS, double new_t_P) {
    Tree& t = tree;
    int32_t P = t.nodes[X].parent;
    int32_t S = t.sibling(P, X);
    if (SS == P) SS = S;

    // 1. strip X's branch mutations into the running nexus->X deltas
    Deltas& deltas_nexus_to_X = mv_deltas_nexus_to_X;
    deltas_nexus_to_X.clear();
    for (const Mut& m : t.nodes[X].muts)
      push_back_d(deltas_nexus_to_X, m.site, m.from, m.to);
    t.nodes[X].muts.clear();
    double old_t_P = t.nodes[P].t;

    // 2. detach: X inherits every missation at or above its old position.
    // Run union accumulated bottom-up (deepest ancestor wins on transient
    // duplicates); from-states move via the small fs maps — only non-ref
    // from-states have entries, and emplace preserves X's own / deeper
    // entries, so no per-site work is ever done
    Sites miss_X = t.nodes[X].miss;
    {
      int32_t cur = P;
      while (cur != NO_NODE) {
        const Node& nd = t.nodes[cur];
        if (!nd.miss.empty()) {
          for (const auto& kv : nd.fs)
            if (sites_contains(nd.miss, kv.first) &&
                !sites_contains(miss_X, kv.first))
              t.nodes[X].fs.emplace(kv.first, kv.second);
          miss_X = sites_union(miss_X, nd.miss);
        }
        cur = t.nodes[cur].parent;
      }
    }
    t.nodes[X].miss = miss_X;

    int32_t G = t.nodes[P].parent;
    if (G != NO_NODE) {
      if (t.nodes[G].c0 == P)
        t.nodes[G].c0 = S;
      else
        t.nodes[G].c1 = S;
      t.nodes[S].parent = G;
      // prepend P's mutations to S's (via reusable scratch)
      std::vector<Mut>& merged = mv_merged;
      merged.clear();
      merged.insert(merged.end(), t.nodes[P].muts.begin(),
                    t.nodes[P].muts.end());
      merged.insert(merged.end(), t.nodes[S].muts.begin(),
                    t.nodes[S].muts.end());
      std::swap(t.nodes[S].muts, merged);
      t.nodes[P].muts.clear();
    } else {
      // P was the root: S becomes the root, carrying the root deltas
      t.nodes[S].parent = NO_NODE;
      std::vector<Mut>& merged = mv_merged;
      merged.clear();
      merged.insert(merged.end(), t.nodes[P].muts.begin(),
                    t.nodes[P].muts.end());
      merged.insert(merged.end(), t.nodes[S].muts.begin(),
                    t.nodes[S].muts.end());
      std::swap(t.nodes[S].muts, merged);
      t.nodes[P].muts.clear();
      t.root = S;
    }
    // merge missations onto the merged branch (disjoint site sets)
    t.nodes[S].miss = sites_union(t.nodes[P].miss, t.nodes[S].miss);
    for (const auto& kv : t.nodes[P].fs) t.nodes[S].fs[kv.first] = kv.second;
    t.nodes[P].miss.clear();
    t.nodes[P].fs.clear();
    t.nodes[P].parent = NO_NODE;
    t.nodes[P].c0 = NO_NODE;
    t.nodes[P].c1 = NO_NODE;

    // normalization cascade: factor missations common to both children up
    // through the old junction's ancestors
    {
      int32_t cur = G;
      while (cur != NO_NODE) {
        int32_t c0 = t.nodes[cur].c0, c1 = t.nodes[cur].c1;
        Sites common = sites_intersect(t.nodes[c0].miss, t.nodes[c1].miss);
        if (common.empty()) break;
        // from-states: only non-ref ones have fs entries; move c0's entries
        // in `common` up to cur (cur had no entry — the site was not in its
        // miss), drop both children's
        for (auto it = t.nodes[c0].fs.begin(); it != t.nodes[c0].fs.end();) {
          if (sites_contains(common, it->first)) {
            t.nodes[cur].fs[it->first] = it->second;
            it = t.nodes[c0].fs.erase(it);
          } else {
            ++it;
          }
        }
        for (auto it = t.nodes[c1].fs.begin(); it != t.nodes[c1].fs.end();) {
          if (sites_contains(common, it->first))
            it = t.nodes[c1].fs.erase(it);
          else
            ++it;
        }
        t.nodes[c0].miss = sites_minus(t.nodes[c0].miss, common);
        t.nodes[c1].miss = sites_minus(t.nodes[c1].miss, common);
        t.nodes[cur].miss = sites_union(t.nodes[cur].miss, common);
        cur = t.nodes[cur].parent;
      }
    }

    // 3. recompose the nexus deltas through the pruned tree
    Deltas& d_new_to_old = mv_d_new_to_old;
    deltas_between(t, SS, new_t_P, S, old_t_P, d_new_to_old);
    miss_X = t.nodes[X].miss;
    for (auto it = d_new_to_old.begin(); it != d_new_to_old.end();) {
      if (sites_contains(miss_X, it->first)) {
        // crossings at sites missing at X update miss(X)'s from_states
        set_from_state(t, X, it->first, it->second.from);
        it = d_new_to_old.erase(it);
      } else {
        ++it;
      }
    }
    Deltas& new_deltas = mv_new_deltas;
    compose_d(d_new_to_old, deltas_nexus_to_X, new_deltas);

    // 4. attach: split branch GG->SS at new_t_P
    int32_t GG = t.nodes[SS].parent;

    miss_X = t.nodes[X].miss;

    // Un-factor missations above the attach point that X's data invalidates
    std::vector<int32_t>& path_up = mv_path_up;
    path_up.clear();
    path_up.push_back(SS);
    {
      int32_t cur = GG;
      while (cur != NO_NODE) {
        path_up.push_back(cur);
        cur = t.nodes[cur].parent;
      }
    }
    for (size_t wi = 1; wi < path_up.size(); wi++) {
      int32_t W = path_up[wi];
      Sites need = sites_minus(t.nodes[W].miss, miss_X);
      if (need.empty()) continue;
      // non-ref from-states propagate from W's small fs map to every
      // off-path sibling and SS (they gain these sites, so they had no
      // entries); miss updates are whole-run unions per node
      for (auto it = t.nodes[W].fs.begin(); it != t.nodes[W].fs.end();) {
        if (sites_contains(need, it->first)) {
          for (size_t di = wi; di > 0; di--) {
            int32_t other = t.sibling(path_up[di], path_up[di - 1]);
            t.nodes[other].fs[it->first] = it->second;
          }
          t.nodes[SS].fs[it->first] = it->second;
          it = t.nodes[W].fs.erase(it);
        } else {
          ++it;
        }
      }
      for (size_t di = wi; di > 0; di--) {
        int32_t other = t.sibling(path_up[di], path_up[di - 1]);
        t.nodes[other].miss = sites_union(t.nodes[other].miss, need);
      }
      t.nodes[SS].miss = sites_union(t.nodes[SS].miss, need);
      t.nodes[W].miss = sites_minus(t.nodes[W].miss, need);
    }

    // drop miss(X) entries already covered by missations above the new
    // position (nested missations are forbidden)
    {
      Sites covered;
      int32_t cur = GG;
      while (cur != NO_NODE) {
        covered = sites_union(covered, t.nodes[cur].miss);
        cur = t.nodes[cur].parent;
      }
      Sites overlap = sites_intersect(covered, miss_X);
      if (!overlap.empty()) {
        for (auto it = t.nodes[X].fs.begin(); it != t.nodes[X].fs.end();) {
          if (sites_contains(overlap, it->first))
            it = t.nodes[X].fs.erase(it);
          else
            ++it;
        }
        t.nodes[X].miss = sites_minus(miss_X, overlap);
        miss_X = t.nodes[X].miss;
      }
    }

    t.nodes[P].c0 = std::min(X, SS);
    t.nodes[P].c1 = std::max(X, SS);
    t.nodes[X].parent = P;
    t.nodes[SS].parent = P;
    t.nodes[P].t = new_t_P;
    if (GG != NO_NODE) {
      if (t.nodes[GG].c0 == SS)
        t.nodes[GG].c0 = P;
      else
        t.nodes[GG].c1 = P;
      t.nodes[P].parent = GG;
      std::vector<Mut> upper, lower;
      for (const Mut& m : t.nodes[SS].muts)
        (m.t <= new_t_P ? upper : lower).push_back(m);
      t.nodes[P].muts = std::move(upper);
      t.nodes[SS].muts = std::move(lower);
    } else {
      // attaching above the old root: P becomes the new root
      t.nodes[P].parent = NO_NODE;
      t.nodes[P].muts = std::move(t.nodes[SS].muts);
      t.nodes[SS].muts.clear();
      t.root = P;
    }

    // factor missations common to the new siblings up onto P's branch
    {
      Sites miss_SS = t.nodes[SS].miss;
      Sites common = sites_intersect(miss_X, miss_SS);
      if (!common.empty()) {
        // X's non-ref from-states in `common` move up to P (which had no
        // entries for them); SS's entries in `common` are dropped
        for (auto it = t.nodes[X].fs.begin(); it != t.nodes[X].fs.end();) {
          if (sites_contains(common, it->first)) {
            t.nodes[P].fs[it->first] = it->second;
            it = t.nodes[X].fs.erase(it);
          } else {
            ++it;
          }
        }
        for (auto it = t.nodes[SS].fs.begin(); it != t.nodes[SS].fs.end();) {
          if (sites_contains(common, it->first))
            it = t.nodes[SS].fs.erase(it);
          else
            ++it;
        }
        t.nodes[X].miss = sites_minus(miss_X, common);
        t.nodes[SS].miss = sites_minus(miss_SS, common);
        t.nodes[P].miss = sites_union(t.nodes[P].miss, common);
      }
    }

    // 5. synthesize mid-branch mutations
    double t_X = t.nodes[X].t;
    double t_mid = 0.5 * (new_t_P + t_X);
    std::vector<std::pair<int32_t, FT>> nd(new_deltas.begin(),
                                           new_deltas.end());
    std::sort(nd.begin(), nd.end(),
              [](const auto& a, const auto& b) { return a.first < b.first; });
    t.nodes[X].muts.clear();
    for (const auto& kv : nd)
      t.nodes[X].muts.push_back(
          Mut{kv.first, kv.second.from, kv.second.to, t_mid});
  }
};

// ---- SPR study (study.py) -------------------------------------------------

struct CandidateRegion {
  int32_t branch;
  int32_t mut_idx;
  double t_min, t_max;
  int32_t min_muts;
  double log_W_over_Wmax = 0.0;
  double W_over_Wmax = 0.0;
  bool is_above_root() const { return t_min == NEG_BIG; }
};

struct SprStudyBuilder {
  // Candidate-region flood: DFS-with-undo over the inter-mutation segment
  // graph (one vertex per stretch of a branch between consecutive
  // mutations / node ends; edges cross a mutation within a branch or a
  // node between branches).  Each frame carries the inverse of its entry
  // crossing, applied when the frame pops — this repo's own decomposition
  // (round 5); spr_study.cpp:26-120 is the spec for WHAT to enumerate
  // (region set, min-mut counts, bound semantics), and the exploration
  // order (high child, low child / down-mutation first, then up) is pinned
  // by the move-for-move tests.  Resettable: one instance per Mixer reuses
  // the frame / region / delta-map capacity across moves.
  const Tree* tree_p = nullptr;
  int32_t X = NO_NODE;
  double t_X = 0.0;
  const Sites* missing_at_X_p = nullptr;
  int64_t max_muts_from_start = 0;
  Deltas cur_to_X_deltas;  // running map during the flood (reused)
  struct Frame {
    int32_t b, i;            // this segment
    int32_t came_b, came_i;  // segment we entered from (excluded)
    int8_t cursor;           // 0 first-down, 1 low child, 2 up, 3 done
    int8_t undo_kind;        // 0 none, 1 re-push, 2 re-pop
    Mut undo_mut;
  };
  std::vector<Frame> frames;
  std::vector<CandidateRegion> result;

  SprStudyBuilder() = default;
  SprStudyBuilder(const Tree& t, int32_t X_, double t_X_, const Sites& miss,
                  int64_t limit) {
    reset(t, X_, t_X_, miss, limit);
  }

  void reset(const Tree& t, int32_t X_, double t_X_, const Sites& miss,
             int64_t limit) {
    tree_p = &t;
    X = X_;
    t_X = t_X_;
    missing_at_X_p = &miss;
    max_muts_from_start = limit;
    cur_to_X_deltas.clear();
    frames.clear();
    result.clear();
  }

  double region_t_min(int32_t branch, int32_t mut_idx) const {
    const Tree& tree = *tree_p;
    if (branch == tree.root) return NEG_BIG;
    const auto& muts = tree.nodes[branch].muts;
    if (mut_idx == 0) return tree.nodes[tree.nodes[branch].parent].t;
    return muts[mut_idx - 1].t;
  }

  void record(int32_t b, int32_t i) {
    const Tree& tree = *tree_p;
    const auto& muts = tree.nodes[b].muts;
    double t_min, t_max;
    if (b == tree.root) {
      t_min = NEG_BIG;
      t_max = tree.nodes[b].t;
    } else {
      t_min = (i == 0) ? tree.nodes[tree.nodes[b].parent].t : muts[i - 1].t;
      t_max = (i == (int32_t)muts.size()) ? tree.nodes[b].t : muts[i].t;
    }
    result.push_back(CandidateRegion{b, i, t_min, t_max,
                                     (int32_t)cur_to_X_deltas.size()});
  }

  void seed_fill_from(int32_t init_branch, int32_t init_mut_idx,
                      const Deltas& init_to_X_deltas, bool can_change_root) {
    const Tree& tree = *tree_p;
    const Sites& missing_at_X = *missing_at_X_p;
    cur_to_X_deltas = init_to_X_deltas;
    int64_t count = 0;  // path mutations from the seed (the bound)

    if (init_branch != X && count <= max_muts_from_start) {
      record(init_branch, init_mut_idx);
      frames.push_back(Frame{init_branch, init_mut_idx, -2, -2, 0, 0, Mut{}});
      while (!frames.empty()) {
        Frame& fr = frames.back();
        int32_t b = fr.b, i = fr.i;
        const auto& muts = tree.nodes[b].muts;
        int32_t nb_b = NO_NODE, nb_i = -1;
        const Mut* m = nullptr;
        bool up = false;
        switch (fr.cursor) {
          case 0:
            fr.cursor = 1;
            if (i == (int32_t)muts.size()) {
              if (tree.nodes[b].c1 != NO_NODE) {
                nb_b = tree.nodes[b].c1;
                nb_i = 0;
              }
            } else {
              nb_b = b;
              nb_i = i + 1;
              m = &muts[i];
            }
            break;
          case 1:
            fr.cursor = 2;
            if (i == (int32_t)muts.size() && tree.nodes[b].c0 != NO_NODE) {
              nb_b = tree.nodes[b].c0;
              nb_i = 0;
            }
            break;
          case 2:
            fr.cursor = 3;
            if (b != tree.root) {
              if (i > 0) {
                nb_b = b;
                nb_i = i - 1;
                m = &muts[i - 1];
                up = true;
              } else {
                nb_b = tree.nodes[b].parent;
                nb_i = (int32_t)tree.nodes[nb_b].muts.size();
              }
            }
            break;
          default:  // exhausted: undo the entry crossing, pop the frame
            if (fr.undo_kind == 1) {
              push_front_d(cur_to_X_deltas, fr.undo_mut.site,
                           fr.undo_mut.from, fr.undo_mut.to);
              count--;
            } else if (fr.undo_kind == 2) {
              pop_front_d(cur_to_X_deltas, fr.undo_mut);
              count--;
            }
            frames.pop_back();
            continue;
        }
        if (nb_b == NO_NODE || (nb_b == fr.came_b && nb_i == fr.came_i))
          continue;  // no neighbor there / came from there
        int8_t undo = 0;
        Mut undo_m{};
        if (m != nullptr && !sites_contains(missing_at_X, m->site)) {
          if (up) {
            push_front_d(cur_to_X_deltas, m->site, m->from, m->to);
            undo = 2;
          } else {
            pop_front_d(cur_to_X_deltas, *m);
            undo = 1;
          }
          undo_m = *m;
          count++;
        }
        if (nb_b != X && count <= max_muts_from_start) {
          record(nb_b, nb_i);
          frames.push_back(Frame{nb_b, nb_i, b, i, 0, undo, undo_m});
        } else if (undo == 1) {  // out of scope: revert immediately
          push_front_d(cur_to_X_deltas, undo_m.site, undo_m.from, undo_m.to);
          count--;
        } else if (undo == 2) {
          pop_front_d(cur_to_X_deltas, undo_m);
          count--;
        }
      }
    }
    account_for_Xs_detachment(can_change_root);
    remove_regions_in_Xs_future();
  }

  void account_for_Xs_detachment(bool can_change_root) {
    const Tree& t = *tree_p;
    if (X == NO_NODE) {
      if (!can_change_root) {
        result.erase(std::remove_if(result.begin(), result.end(),
                                    [&](const CandidateRegion& r) {
                                      return r.branch == t.root;
                                    }),
                     result.end());
      }
      return;
    }
    int32_t P = t.nodes[X].parent;
    int32_t S = t.sibling(P, X);
    int32_t num_muts_G_to_P = (int32_t)t.nodes[P].muts.size();

    for (CandidateRegion& region : result) {
      if (!can_change_root && region.branch == t.root) {
        region.branch = -1;
        continue;
      }
      if (region.branch != S && region.branch != P) continue;
      if (P != t.root) {
        if (region.branch == S) {
          if (region.mut_idx == 0)
            region.t_min = region_t_min(P, num_muts_G_to_P);
          region.mut_idx += num_muts_G_to_P;
        } else {  // region.branch == P
          if (region.mut_idx == num_muts_G_to_P)
            region.branch = -1;
          else
            region.branch = S;
        }
      } else {
        if (!can_change_root) {
          if (region.branch == P) region.branch = -1;
        } else {
          if (region.branch == S &&
              region.mut_idx == (int32_t)t.nodes[S].muts.size()) {
            region.mut_idx += num_muts_G_to_P;
            region.t_min = NEG_BIG;
          } else {
            region.branch = -1;
          }
        }
      }
    }
    result.erase(std::remove_if(
                     result.begin(), result.end(),
                     [](const CandidateRegion& r) { return r.branch == -1; }),
                 result.end());
  }

  void remove_regions_in_Xs_future() {
    size_t w = 0;  // in-place compaction: no per-move allocation
    for (size_t i = 0; i < result.size(); i++) {
      CandidateRegion r = result[i];
      if (r.t_min >= t_X) continue;
      if (r.t_max > t_X) r.t_max = t_X;
      result[w++] = r;
    }
    result.resize(w);
  }
};

struct SprStudy {
  const Tree& tree;
  double lambda_X, f, t_X, t_max_tip, mu;
  // view into the (reusable) builder's region list; the builder must outlive
  // this study and not be reset while the study is queried
  std::vector<CandidateRegion>& regions;
  double log_Wmax = 0.0, sum_W = 0.0;

  SprStudy(SprStudyBuilder& builder, double lambda_X_, double annealing_factor,
           double t_X_, double t_max_tip_)
      : tree(*builder.tree_p), lambda_X(lambda_X_), f(annealing_factor),
        t_X(t_X_), t_max_tip(t_max_tip_), regions(builder.result) {
    mu = lambda_X /
         (double)((int64_t)tree.L - sites_size(*builder.missing_at_X_p));
    if (regions.empty()) throw std::runtime_error("SPR study empty");

    for (CandidateRegion& r : regions) {
      int32_t m = r.min_muts;
      if (!r.is_above_root()) {
        double t_prime = 0.5 * (r.t_min + r.t_max);
        double arg1 = f * lambda_X * (r.t_max - r.t_min);
        double arg2 = mu * (t_X - t_prime) / 3.0;
        if (arg1 <= 0.0 || (m > 0 && arg2 <= 0.0))
          r.log_W_over_Wmax = -INFINITY;
        else
          r.log_W_over_Wmax =
              std::log(arg1) +
              f * (-lambda_X * (t_X - t_prime) + m * std::log(arg2));
      } else {
        double t_S = tree.nodes[r.branch].t;
        double s_min = std::fabs(t_X - t_S);
        double t_early = std::min(t_X, t_S);
        double s_max = s_min + 20.0 * std::max(t_max_tip - t_early, 0.0);
        double x_min = lambda_X * f * s_min;
        double x_max = lambda_X * f * s_max;
        if (x_max < 0.01) {
          double alpha = f * m + 1;
          r.log_W_over_Wmax =
              -std::log(2.0) + std::log(f * lambda_X) +
              f * m * std::log(mu / 3.0) + alpha * std::log(s_max) +
              std::log1p(-std::pow(s_min / s_max, alpha)) - std::log(alpha);
        } else {
          r.log_W_over_Wmax =
              -std::log(2.0) + f * m * std::log(mu / (3.0 * lambda_X * f)) +
              std::lgamma(f * m + 1) +
              safe_log_gamma_integral(f * m + 1, x_min, x_max);
        }
      }
    }

    log_Wmax = -INFINITY;
    for (const CandidateRegion& r : regions)
      log_Wmax = std::max(log_Wmax, r.log_W_over_Wmax);
    if (!std::isfinite(log_Wmax)) log_Wmax = 0.0;
    sum_W = 0.0;
    for (CandidateRegion& r : regions) {
      r.log_W_over_Wmax -= log_Wmax;
      r.W_over_Wmax = std::exp(r.log_W_over_Wmax);
      sum_W += r.W_over_Wmax;
    }
  }

  int32_t pick_nexus_region(Rng& rng) const {
    double u = rng.uniform(0.0, sum_W);
    for (size_t i = 0; i < regions.size(); i++) {
      if (regions[i].W_over_Wmax >= u) return (int32_t)i;
      u -= regions[i].W_over_Wmax;
    }
    return 0;
  }

  void root_s_bounds(const CandidateRegion& r, double& t_S, double& s_min,
                     double& s_max) const {
    t_S = tree.nodes[r.branch].t;
    s_min = std::fabs(t_X - t_S);
    s_max = s_min + 20.0 * std::max(t_max_tip - std::min(t_X, t_S), 0.0);
  }

  double pick_time_in_region(int32_t idx, Rng& rng) const {
    const CandidateRegion& r = regions[idx];
    if (!r.is_above_root()) {
      double u = rng.uniform(0.0, 1.0);
      return r.t_max - u * (r.t_max - r.t_min);  // in (t_min, t_max]
    }
    int32_t m = r.min_muts;
    double t_S, s_min, s_max;
    root_s_bounds(r, t_S, s_min, s_max);
    double x_max = lambda_X * f * s_max;
    double s;
    if (x_max < 0.01) {
      double alpha = f * m + 1;
      double U = rng.uniform(1e-16, 1.0);
      s = std::pow(std::pow(s_min, alpha) +
                       U * (std::pow(s_max, alpha) - std::pow(s_min, alpha)),
                   1.0 / alpha);
    } else {
      double alpha = f * m + 1;
      double Q_hi = gamma_Q(alpha, lambda_X * f * s_min);
      double Q_lo = gamma_Q(alpha, lambda_X * f * s_max);
      double Q = Q_lo + rng.uniform(1e-16, 1.0) * (Q_hi - Q_lo);
      double y = gamma_Qinv(alpha, Q);
      s = std::min(std::max(y / (lambda_X * f), s_min), s_max);
    }
    double t = 0.5 * (t_X + t_S - s);
    return std::min(std::max(t, r.t_min), r.t_max);
  }

  int32_t find_region(int32_t branch, double t) const {
    for (size_t i = 0; i < regions.size(); i++) {
      const CandidateRegion& r = regions[i];
      if (r.branch == branch && r.t_min < t && t <= r.t_max) return (int32_t)i;
    }
    return -1;
  }

  double log_alpha_in_region(int32_t idx, double t) const {
    const CandidateRegion& r = regions[idx];
    double log_p_region = r.log_W_over_Wmax - std::log(sum_W);
    if (!r.is_above_root())
      return log_p_region - std::log(r.t_max - r.t_min);
    int32_t m = r.min_muts;
    double t_S, s_min, s_max;
    root_s_bounds(r, t_S, s_min, s_max);
    double x_min = lambda_X * f * s_min, x_max = lambda_X * f * s_max;
    double s = (t_X - t) + (t_S - t);
    if (s > s_max + 1e-6) return -INFINITY;
    if (x_max < 0.01) {
      double alpha = f * m + 1;
      return log_p_region + std::log(2.0) + std::log(alpha) +
             (alpha - 1) * std::log(s) - alpha * std::log(s_max) -
             std::log1p(-std::pow(s_min / s_max, alpha));
    }
    return log_p_region + std::log(2.0) + std::log(lambda_X * f) +
           f * m * std::log(lambda_X * f * s) - lambda_X * f * s -
           std::lgamma(f * m + 1) -
           safe_log_gamma_integral(f * m + 1, x_min, x_max);
  }
};

// ---- mixer (mixer.py TopologyMixer) ---------------------------------------

struct Mixer {
  Tree& tree;
  Rng& rng;
  SprContext& ctx;
  Coal& coal;
  bool can_change_root;
  double t_max_tip;
  int64_t n_accepted = 0, n_proposed = 0;
  double delta_log_G = 0.0, delta_log_coal = 0.0;
  // per-mixer scratch, reused across moves (capacity persists)
  SprStudyBuilder study_builder;
  Sites scratch_missing_at_X;
  Deltas scratch_deltas_P_to_X;
  std::vector<int32_t> scratch_branches;
  Graft g_old, g_new;  // reused graft slots (BranchInfo pools persist)

  Mixer(Tree& t, Rng& r, SprContext& c, Coal& co, bool ccr, double tmt)
      : tree(t), rng(r), ctx(c), coal(co), can_change_root(ccr),
        t_max_tip(tmt) {}

  void enumerate_straddling(int32_t P, double t, int32_t X,
                            std::vector<int32_t>& out) {
    if (P == X) return;
    if (t <= tree.nodes[P].t)
      out.push_back(P);
    else if (tree.nodes[P].c0 != NO_NODE) {
      enumerate_straddling(tree.nodes[P].c0, t, X, out);
      enumerate_straddling(tree.nodes[P].c1, t, X, out);
    }
  }

  void spr_move_core(int32_t X, int32_t SS, double new_t_P,
                     double alpha_ratio) {
    Tree& t = tree;
    if (X == t.root) return;
    double t_X = t.nodes[X].t;
    int32_t P = t.nodes[X].parent;
    if (!can_change_root && (P == t.root || SS == t.root)) return;
    double old_t_P = t.nodes[P].t;
    int32_t old_S = t.sibling(P, X);
    int32_t G = t.nodes[P].parent;
    if (new_t_P == t_X || new_t_P == t.nodes[SS].t ||
        (P != t.root && new_t_P == t.nodes[G].t))
      return;

    ctx.begin_move();
    Graft& old_graft = g_old;
    ctx.analyze_graft(X, old_graft);
    ctx.peel_graft(old_graft);
    ctx.move(X, SS, new_t_P);
    Graft& new_graft = g_new;
    ctx.propose_new_graft(X, rng, new_graft);

    double delta_coal = coal.displace_delta(old_t_P, new_t_P);
    double log_mh = (new_graft.delta_log_G - new_graft.log_alpha_mut) -
                    (old_graft.delta_log_G - old_graft.log_alpha_mut) +
                    std::log(alpha_ratio) + delta_coal;
    if (log_mh >= 0.0 || rng.uniform() < std::exp(std::min(log_mh, 0.0))) {
      ctx.apply_graft(new_graft);
      coal.commit();
      n_accepted++;
      delta_log_G += new_graft.delta_log_G - old_graft.delta_log_G;
      delta_log_coal += delta_coal;
    } else {
      ctx.move(X, old_S, old_t_P);
      ctx.apply_graft(old_graft);
    }
  }

  void subtree_slide() {
    Tree& t = tree;
    int32_t N = (int32_t)t.nodes.size();
    int32_t X = (int32_t)rng.integers(0, N);
    if (X == t.root) return;
    int32_t P = t.nodes[X].parent;
    int32_t S = t.sibling(P, X);

    double t_early = (P == t.root)
                         ? std::min(t.nodes[X].t, t.nodes[S].t)
                         : t.nodes[t.root].t;
    double tree_span = std::max(t_max_tip - t_early, 0.0);
    double lam_X = ctx.lambda_at(X);
    if (lam_X <= 0.0) return;
    double delta_scale = std::min(0.5 / lam_X, tree_span);
    double delta_t = rng.normal(0.0, delta_scale);
    double old_P_t = t.nodes[P].t;
    double new_P_t = old_P_t + delta_t;

    if (delta_t < 0.0) {
      if (P != t.root && new_P_t < t.nodes[t.nodes[P].parent].t) {
        int32_t GG = t.nodes[P].parent;
        int32_t SS = P;
        while (GG != NO_NODE && new_P_t < t.nodes[GG].t) {
          SS = GG;
          GG = t.nodes[GG].parent;
        }
        std::vector<int32_t>& branches = scratch_branches;
        branches.clear();
        enumerate_straddling(SS, old_P_t, X, branches);
        double alpha_ratio = (1.0 / (double)branches.size()) / 1.0;
        spr_move_core(X, SS, new_P_t, alpha_ratio);
      } else {
        spr_move_core(X, S, new_P_t, 1.0);
      }
    } else {
      if (new_P_t > t.nodes[X].t) return;
      if (new_P_t > t.nodes[S].t) {
        std::vector<int32_t>& branches = scratch_branches;
        branches.clear();
        enumerate_straddling(P, new_P_t, X, branches);
        if (branches.empty()) return;
        int32_t SS = branches[rng.integers(0, (int64_t)branches.size())];
        double alpha_ratio = 1.0 / (1.0 / (double)branches.size());
        spr_move_core(X, SS, new_P_t, alpha_ratio);
      } else {
        spr_move_core(X, S, new_P_t, 1.0);
      }
    }
  }

  void spr1() {
    Tree& t = tree;
    int32_t N = (int32_t)t.nodes.size();
    int64_t limit = rng.uniform() < 0.01 ? (int64_t)1 << 31 : 1;
    double annealing_factor = 0.8;

    int32_t X = (int32_t)rng.integers(0, N);
    if (X == t.root) return;
    if (t.nodes[X].parent == t.root && !can_change_root) return;
    double lam_X = ctx.lambda_at(X);
    if (lam_X == 0.0) return;
    double t_X = t.nodes[X].t;
    int32_t P = t.nodes[X].parent;
    double old_t_P = t.nodes[P].t;
    int32_t old_S = t.sibling(P, X);

    ctx.begin_move();
    Graft& old_graft = g_old;
    {
      ProfPhase pp(0);
      ctx.analyze_graft(X, old_graft);
      ctx.peel_graft(old_graft);
    }

    ProfPhase* ps = g_prof.on ? new ProfPhase(1) : nullptr;
    summarize_closed(old_graft, scratch_deltas_P_to_X);
    ctx.miss_at_or_above(X, scratch_missing_at_X);
    Sites& missing_at_X = scratch_missing_at_X;

    study_builder.reset(t, X, t_X, missing_at_X, limit);
    study_builder.seed_fill_from(old_S, 0, scratch_deltas_P_to_X,
                                 can_change_root);
    SprStudy pre_study(study_builder, lam_X, annealing_factor, t_X,
                       t_max_tip);
    delete ps;

    // extract everything the pre-study provides BEFORE the builder is reset
    // for the post-study (the study views the builder's region list)
    int32_t new_region = pre_study.pick_nexus_region(rng);
    int32_t new_S = pre_study.regions[new_region].branch;
    double new_t_P = pre_study.pick_time_in_region(new_region, rng);
    double log_alpha_old_to_new =
        pre_study.log_alpha_in_region(new_region, new_t_P);

    double t_new_S = t.nodes[new_S].t;
    int32_t new_G = new_S != t.root ? t.nodes[new_S].parent : NO_NODE;
    if (new_G == P) new_G = t.nodes[P].parent;
    double t_new_G = new_G != NO_NODE ? t.nodes[new_G].t : -1e308;
    if (new_t_P == t_X || new_t_P == t_new_S || new_t_P == t_new_G) {
      ctx.apply_graft(old_graft);
      return;
    }

    {
      ProfPhase pp(2);
      ctx.move(X, new_S, new_t_P);
    }
    Graft& new_graft = g_new;
    {
      ProfPhase pp(3);
      ctx.propose_new_graft(X, rng, new_graft);
    }

    ProfPhase* ps2 = g_prof.on ? new ProfPhase(4) : nullptr;
    summarize_closed(new_graft, scratch_deltas_P_to_X);
    study_builder.reset(t, X, t_X, missing_at_X, limit);
    study_builder.seed_fill_from(new_S, 0, scratch_deltas_P_to_X,
                                 can_change_root);
    SprStudy post_study(study_builder, lam_X, annealing_factor, t_X,
                        t_max_tip);
    int32_t old_region = post_study.find_region(old_S, old_t_P);
    delete ps2;
    if (old_region == -1) {
      // reverse proposal can't produce the old state -> reject
      ctx.move(X, old_S, old_t_P);
      ctx.apply_graft(old_graft);
      return;
    }
    double log_alpha_new_to_old =
        post_study.log_alpha_in_region(old_region, old_t_P);

    double delta_coal;
    {
      ProfPhase pp(5);
      delta_coal = coal.displace_delta(old_t_P, new_t_P);
    }
    double log_mh = (new_graft.delta_log_G - new_graft.log_alpha_mut) -
                    (old_graft.delta_log_G - old_graft.log_alpha_mut) +
                    log_alpha_new_to_old - log_alpha_old_to_new + delta_coal;
    ProfPhase pp(6);
    if (log_mh >= 0.0 || rng.uniform() < std::exp(std::min(log_mh, 0.0))) {
      ctx.apply_graft(new_graft);
      coal.commit();
      n_accepted++;
      delta_log_G += new_graft.delta_log_G - old_graft.delta_log_G;
      delta_log_coal += delta_coal;
    } else {
      ctx.move(X, old_S, old_t_P);
      ctx.apply_graft(old_graft);
    }
  }

  static void summarize_closed(const Graft& graft, Deltas& out) {
    out.clear();
    for (const BranchInfo& bi : graft.branch_infos)
      if (!bi.is_open)
        for (const auto& kv : bi.hot_deltas_to_X)
          out[kv.first] = kv.second;  // update semantics (dict.update)
  }

  void run_burst(int64_t n_moves) {
    for (int64_t i = 0; i < n_moves; i++) {
      n_proposed++;
      if (rng.uniform() < 0.5)
        subtree_slide();
      else
        spr1();
    }
    g_prof.n += n_moves;
    g_prof.dump();
  }
};

}  // namespace

// ---- C ABI ----------------------------------------------------------------
//
// One call = one topology burst.  The tree comes in/goes out as CSR arrays
// (the layout of state.py / core/api.fbs); missations travel as intervals
// and expand to site lists internally.  Returns 0 on success, -2 if an
// output capacity is too small, -1 on any internal error (caller falls back
// to the Python mixer; input arrays are never modified).

// Direct test exports for the incomplete-gamma kernels (the reference
// unit-tests its safe_gamma_math the same way, tests/safe_gamma_math_tests.cpp)
extern "C" double delphy_gamma_q(double a, double x) {
  return gamma_Q(a, x);
}
extern "C" double delphy_gamma_q_inv(double a, double q) {
  return gamma_Qinv(a, q);
}

// Randomized greedy equal-size partition stencil — the native twin of
// topo/partition.py:42-77 (reference tree_partitioning.h:139-194), with the
// best-of-K selection loop (partmaps.py's stencil cache, reference
// run.cpp:87-108 keeps 10) hoisted inside so K tries cost one call.
// children: N x 2 int32, -1 = absent (tips).  Writes the winning cut list to
// out_cuts (capacity num_parts), its per-part sizes (cut parts in cut order,
// then the residual root part) to out_sizes (capacity num_parts), and the
// cut count to out_num_cuts.  Returns 0 on success, -1 on bad arguments.
extern "C" int32_t delphy_best_stencil(
    int32_t N, int32_t root, const int32_t* children,
    int32_t num_parts, int32_t tries, uint64_t seed,
    int32_t* out_cuts, int64_t* out_sizes, int32_t* out_num_cuts) {
  if (N <= 0 || root < 0 || root >= N || num_parts <= 1 || tries <= 0)
    return -1;
  Rng rng(seed);
  std::vector<int32_t> order(N);
  std::vector<int64_t> desc(N);
  std::vector<int32_t> stack;
  std::vector<uint8_t> visited(N);
  std::vector<int32_t> cand, best_cuts;
  std::vector<int64_t> sizes, best_sizes;
  int64_t best_mx = -1;
  for (int32_t t_i = 0; t_i < tries; ++t_i) {
    // randomized post-order (children visited in coin-flipped order)
    std::fill(visited.begin(), visited.end(), 0);
    stack.clear();
    stack.push_back(root);
    int32_t k = 0;
    while (!stack.empty()) {
      int32_t n = stack.back();
      stack.pop_back();
      int32_t c0 = children[2 * (size_t)n], c1 = children[2 * (size_t)n + 1];
      bool tip = (c0 < 0 && c1 < 0);
      if (tip || visited[n]) {
        order[k++] = n;
        continue;
      }
      visited[n] = 1;
      stack.push_back(n);
      if (rng.uniform() < 0.5) std::swap(c0, c1);
      if (c0 >= 0) stack.push_back(c0);
      if (c1 >= 0) stack.push_back(c1);
    }
    // greedy cuts over the post-order
    std::fill(desc.begin(), desc.end(), 0);
    cand.clear();
    sizes.clear();
    int64_t branches_left = N;
    int32_t parts_left = num_parts;
    for (int32_t idx = 0; idx < k; ++idx) {
      int32_t n = order[idx];
      if (n == root || (int32_t)cand.size() == num_parts - 1) break;
      desc[n] = 1;
      int32_t c0 = children[2 * (size_t)n], c1 = children[2 * (size_t)n + 1];
      if (c0 >= 0) desc[n] += desc[c0];
      if (c1 >= 0) desc[n] += desc[c1];
      int64_t min_size =
          std::max<int64_t>(10, branches_left / (int64_t)(parts_left + 1));
      if (desc[n] >= min_size) {
        if (branches_left - (desc[n] - 1) < min_size) continue;
        if (rng.uniform() < 0.5) continue;
        cand.push_back(n);
        sizes.push_back(desc[n]);
        branches_left -= desc[n] - 1;
        desc[n] = 1;
        parts_left -= 1;
      }
    }
    sizes.push_back(branches_left);  // residual root part
    int64_t mx = 0;
    for (int64_t s : sizes) mx = std::max(mx, s);
    if (best_mx < 0 || mx < best_mx) {
      best_mx = mx;
      best_cuts = cand;
      best_sizes = sizes;
    }
  }
  for (size_t i = 0; i < best_cuts.size(); ++i) out_cuts[i] = best_cuts[i];
  for (size_t i = 0; i < best_sizes.size(); ++i) out_sizes[i] = best_sizes[i];
  *out_num_cuts = (int32_t)best_cuts.size();
  return 0;
}

extern "C" int32_t delphy_run_topo_burst(
    // tree in
    int32_t N, int32_t num_tips, int32_t L, int32_t root,
    const int32_t* parent, const int32_t* children,  // children: N x 2
    const double* t, const double* t_min, const double* t_max,
    const uint8_t* ref_seq,
    const int64_t* mut_off, const int32_t* mut_site, const int8_t* mut_from,
    const int8_t* mut_to, const double* mut_t,
    const int64_t* miss_off, const int32_t* miss_s, const int32_t* miss_e,
    const int64_t* fs_off, const int32_t* fs_site, const int8_t* fs_state,
    // evo: q is [P*16] per-partition rate matrices, part is [L] site
    // partition indices (the mpox hack's 2-partition APOBEC model; all-zero
    // and P == 1 otherwise)
    double mu, const double* nu, int32_t P, const double* q,
    const int32_t* part, const double* pi,
    // pop model: kind 0 = exp [t0,n0,g,min_pop]; kind 1 = skygrid
    // [type, K, x[K], gamma[K]]
    int32_t pop_kind, const double* pop_par,
    // coal: mode 0 = internal grid (num_cells, t_max_tip); mode 1 = vsc part
    int32_t coal_mode, int32_t num_cells, double t_max_tip,
    double vsc_t_ref, double vsc_t_step, int32_t vsc_C, int32_t vsc_kp_C,
    const double* vsc_k_bar_p, const double* vsc_k_twiddle_bar_p,
    const double* vsc_k_twiddle_bar, const double* vsc_popsize_bar,
    const int32_t* vsc_num_active,
    // burst
    int32_t can_change_root, int64_t n_moves, uint64_t seed,
    // tree out
    int32_t* out_parent, int32_t* out_children, double* out_t,
    int32_t* out_root,
    int64_t* out_mut_off, int32_t* out_mut_site, int8_t* out_mut_from,
    int8_t* out_mut_to, double* out_mut_t, int64_t mut_cap,
    int64_t* out_miss_off, int32_t* out_miss_s, int32_t* out_miss_e,
    int64_t miss_cap,
    int64_t* out_fs_off, int32_t* out_fs_site, int8_t* out_fs_state,
    int64_t fs_cap,
    // stats out: [delta_log_G, delta_log_coal, n_accepted, n_proposed]
    double* out_stats) {
  try {
    // -- deserialize --------------------------------------------------------
    Tree tr;
    tr.root = root;
    tr.num_tips = num_tips;
    tr.L = L;
    tr.ref_seq = ref_seq;
    tr.nodes.resize(N);
    for (int32_t n = 0; n < N; n++) {
      Node& nd = tr.nodes[n];
      nd.parent = parent[n];
      nd.c0 = children[2 * n];
      nd.c1 = children[2 * n + 1];
      nd.t = t[n];
      nd.t_min = t_min[n];
      nd.t_max = t_max[n];
      nd.muts.reserve(mut_off[n + 1] - mut_off[n]);
      for (int64_t i = mut_off[n]; i < mut_off[n + 1]; i++)
        nd.muts.push_back(Mut{mut_site[i], mut_from[i], mut_to[i], mut_t[i]});
      for (int64_t i = miss_off[n]; i < miss_off[n + 1]; i++)
        sites_append(nd.miss, miss_s[i], miss_e[i]);
      for (int64_t i = fs_off[n]; i < fs_off[n + 1]; i++)
        nd.fs[fs_site[i]] = fs_state[i];
    }

    PopModel pop;
    pop.kind = pop_kind;
    if (pop_kind == 0) {
      pop.t0 = pop_par[0];
      pop.n0 = pop_par[1];
      pop.gr = pop_par[2];
      pop.min_pop = pop_par[3];
    } else {
      pop.sg_type = (int32_t)pop_par[0];
      int32_t K = (int32_t)pop_par[1];
      pop.x.assign(pop_par + 2, pop_par + 2 + K);
      pop.gamma.assign(pop_par + 2 + K, pop_par + 2 + 2 * K);
    }

    Rng rng(seed);

    CoalGrid grid;
    VscPart vsc;
    Coal coal;
    if (coal_mode == 0) {
      grid.build(tr, &pop, num_cells, t_max_tip);
      coal.grid = &grid;
    } else {
      vsc.pop = &pop;
      vsc.includes_tree_root = can_change_root != 0;
      vsc.t_ref = vsc_t_ref;
      vsc.t_step = vsc_t_step;
      // k_bar_p / k_twiddle_bar_p may be shorter than the global cell
      // arrays (non-root parts span fewer cells; vsc.py make_vsc_parts)
      vsc.k_bar_p.assign(vsc_k_bar_p, vsc_k_bar_p + vsc_kp_C);
      vsc.k_twiddle_bar_p.assign(vsc_k_twiddle_bar_p,
                                 vsc_k_twiddle_bar_p + vsc_kp_C);
      vsc.k_twiddle_bar.assign(vsc_k_twiddle_bar, vsc_k_twiddle_bar + vsc_C);
      vsc.popsize_bar.assign(vsc_popsize_bar, vsc_popsize_bar + vsc_C);
      vsc.num_active.resize(vsc_C);
      for (int32_t i = 0; i < vsc_C; i++)
        vsc.num_active[i] = (double)vsc_num_active[i];
      vsc.rng = &rng;
      coal.vsc = &vsc;
    }

    SprContext ctx(tr, mu, nu, q, P, part, pi, can_change_root != 0);
    Mixer mixer(tr, rng, ctx, coal, can_change_root != 0, t_max_tip);
    mixer.run_burst(n_moves);

    // -- serialize ----------------------------------------------------------
    int64_t mut_total = 0, miss_total = 0, fs_total = 0;
    for (int32_t n = 0; n < N; n++) {
      mut_total += (int64_t)tr.nodes[n].muts.size();
      miss_total += (int64_t)tr.nodes[n].miss.size();
      fs_total += (int64_t)tr.nodes[n].fs.size();
    }
    if (mut_total > mut_cap || miss_total > miss_cap || fs_total > fs_cap)
      return -2;

    int64_t mo = 0, io = 0, fo = 0;
    for (int32_t n = 0; n < N; n++) {
      Node& nd = tr.nodes[n];
      out_parent[n] = nd.parent;
      out_children[2 * n] = nd.c0;
      out_children[2 * n + 1] = nd.c1;
      out_t[n] = nd.t;
      out_mut_off[n] = mo;
      for (const Mut& m : nd.muts) {
        out_mut_site[mo] = m.site;
        out_mut_from[mo] = m.from;
        out_mut_to[mo] = m.to;
        out_mut_t[mo] = m.t;
        mo++;
      }
      out_miss_off[n] = io;
      for (const SiteRun& r : nd.miss) {
        out_miss_s[io] = r.b;
        out_miss_e[io] = r.e;
        io++;
      }
      out_fs_off[n] = fo;
      std::vector<std::pair<int32_t, int8_t>> fss(nd.fs.begin(), nd.fs.end());
      std::sort(fss.begin(), fss.end());
      for (const auto& kv : fss) {
        out_fs_site[fo] = kv.first;
        out_fs_state[fo] = kv.second;
        fo++;
      }
    }
    out_mut_off[N] = mo;
    out_miss_off[N] = io;
    out_fs_off[N] = fo;
    *out_root = tr.root;
    out_stats[0] = mixer.delta_log_G;
    out_stats[1] = mixer.delta_log_coal;
    out_stats[2] = (double)mixer.n_accepted;
    out_stats[3] = (double)mixer.n_proposed;
    return 0;
  } catch (...) {
    return -1;
  }
}

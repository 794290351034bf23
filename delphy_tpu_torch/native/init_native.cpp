// Native initial-tree pipeline ("mp-plus-timing" at scale).
//
// C++ implementation of the guide-tree / refinement / rooting stages of this
// repo's init pipeline (delphy_tpu/init_tree.py), designed for 10k-100k-tip
// inputs where the Python greedy guide's O(T^2) pairwise pass is the known
// blocker.  Functional counterpart of the reference's utree pipeline
// (core/utree.h:235-317: build_guide_tree, build_refined_tree, spr_refine,
// ols_regression_root_utree) with a different data model:
//
//  - the working tree is an UNROOTED adjacency of edges carrying sparse
//    per-site state pairs (site, state_a, state_b) — no arc pairs, no Fitch
//    ambiguity sets: this engine's tip model is already (real deltas +
//    missing intervals), so placement works on exact states;
//  - a FOCUS node caches its full diff-vs-reference; candidate insertion
//    edges are scored as (mismatches - savings) exactly as the reference's
//    eval_focal_arc (utree.cpp:705-720), and the search is the same
//    best-first expansion with the adaptive JC-blip pruning threshold
//    (utree.cpp:262-271);
//  - nearest-first re-insertion order comes from a multi-source Dijkstra
//    over the guide tree's delta metric (equivalent to the reference's
//    3-pass arc annotation + heap walk, utree.cpp:761-895);
//  - spr_refine detaches random tips and re-places them with the same
//    searcher, seeding the pruning bound with the rollback (old-position)
//    cost as the reference does (utree.cpp:986-996); the reference
//    additionally refines internal subtrees and tracks Fitch sets;
//  - rooting scans every edge midpoint maximizing root-to-tip regression
//    R^2 via an O(N) rerooting DP over (count, sum_d, sum_d^2, sum_t,
//    sum_dt) sufficient statistics (the reference's bottom-up + top-down
//    passes, utree.cpp Rooting_substage).
//
// One extern-"C" call builds the whole rooted mutation-annotated topology;
// the GIL is released for the duration.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC init_native.cpp -o _init_native.so

#include <algorithm>
#include <array>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <random>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

constexpr int32_t NO_NODE = -1;
constexpr int32_t NO_EDGE = -1;

struct Delta {
  int32_t site;
  int8_t sa, sb;  // state on the a-side / b-side of the edge
};

struct UEdge {
  int32_t a = NO_NODE, b = NO_NODE;
  std::vector<Delta> d;   // sorted by site
  bool alive = false;
  int32_t other(int32_t n) const { return n == a ? b : a; }
  int8_t state_at(int32_t n, const Delta& dl) const {
    return n == a ? dl.sa : dl.sb;
  }
};

struct TipView {
  const int32_t* d_site;
  const int8_t* d_state;
  int32_t n_d;
  const int32_t* m_start;
  const int32_t* m_end;
  int32_t n_m;

  bool missing(int32_t s) const {
    // first interval with end > s
    int lo = 0, hi = n_m;
    while (lo < hi) {
      int mid = (lo + hi) / 2;
      if (m_end[mid] <= s) lo = mid + 1; else hi = mid;
    }
    return lo < n_m && m_start[lo] <= s;
  }
  // state vs ref: returns -1 if not a delta site
  int8_t delta_state(int32_t s) const {
    int lo = 0, hi = n_d;
    while (lo < hi) {
      int mid = (lo + hi) / 2;
      if (d_site[mid] < s) lo = mid + 1; else hi = mid;
    }
    if (lo < n_d && d_site[lo] == s) return d_state[lo];
    return -1;
  }
};

struct Builder {
  int32_t T, L;
  const int8_t* ref;
  std::vector<TipView> tips;
  std::mt19937_64 rng;

  int32_t NN;                       // unrooted node capacity = 2T-2
  std::vector<UEdge> edges;
  std::vector<std::array<int32_t, 3>> node_edges;
  std::vector<int32_t> toward_focus;  // edge id routing each node to focus
  int32_t next_inner;
  int32_t focus = NO_NODE;
  std::unordered_map<int32_t, int8_t> fdiff;  // ref->focus diff

  // placement state for the node X being placed
  const TipView* xt = nullptr;                     // tip placement
  std::unordered_map<int32_t, int8_t> xdiff;       // subtree placement
  bool x_is_tip = true;
  int mm = 0;                       // mismatches x-vs-focus (non-missing)
  double sqrt_6L;

  Builder(int32_t T_, int32_t L_, const int8_t* ref_, uint64_t seed)
      : T(T_), L(L_), ref(ref_), rng(seed) {
    NN = 2 * T - 2;
    if (NN < T) NN = T;
    edges.reserve(2 * T);
    node_edges.assign(NN, {NO_EDGE, NO_EDGE, NO_EDGE});
    toward_focus.assign(NN, NO_EDGE);
    next_inner = T;
    sqrt_6L = std::sqrt(6.0 * L);
  }

  int degree(int32_t n) const {
    int d = 0;
    for (int k = 0; k < 3; k++) d += node_edges[n][k] != NO_EDGE;
    return d;
  }
  void add_node_edge(int32_t n, int32_t e) {
    for (int k = 0; k < 3; k++)
      if (node_edges[n][k] == NO_EDGE) { node_edges[n][k] = e; return; }
    // a full list here means an earlier unlink was missed; silently
    // dropping the edge corrupts the multigraph invariants much later
    std::fprintf(stderr,
                 "[init_native] add_node_edge OVERFLOW: node %d edge %d "
                 "(list %d,%d,%d)\n",
                 n, e, node_edges[n][0], node_edges[n][1], node_edges[n][2]);
    std::abort();
  }
  void del_node_edge(int32_t n, int32_t e) {
    for (int k = 0; k < 3; k++)
      if (node_edges[n][k] == e) { node_edges[n][k] = NO_EDGE; return; }
  }
  int32_t new_edge(int32_t a, int32_t b) {
    int32_t e = (int32_t)edges.size();
    edges.push_back({a, b, {}, true});
    add_node_edge(a, e);
    add_node_edge(b, e);
    return e;
  }

  int8_t x_state(int32_t s) const {
    if (x_is_tip) {
      int8_t d = xt->delta_state(s);
      return d >= 0 ? d : ref[s];
    }
    auto it = xdiff.find(s);
    return it != xdiff.end() ? it->second : ref[s];
  }
  bool x_missing(int32_t s) const { return x_is_tip && xt->missing(s); }
  int8_t f_state(int32_t s) const {
    auto it = fdiff.find(s);
    return it != fdiff.end() ? it->second : ref[s];
  }

  // ---- focus motion -------------------------------------------------------

  void apply_edge_to_fdiff(const UEdge& e, int32_t from_node) {
    // focus crosses e from from_node to the other side
    int32_t to_node = e.other(from_node);
    for (const auto& dl : e.d) {
      int8_t ns = e.state_at(to_node, dl);
      int8_t olds = e.state_at(from_node, dl);
      if (track_mm && !x_missing(dl.site)) {
        int8_t x = x_state(dl.site);
        mm += (x != ns) - (x != olds);
      }
      if (ns == ref[dl.site]) fdiff.erase(dl.site);
      else fdiff[dl.site] = ns;
    }
  }

  bool track_mm = false;
  const char* g_where = "?";

  // Move focus to target, updating fdiff (and mm when track_mm).
  void move_focus_to(int32_t target) {
    if (target == focus) return;
    // collect path target -> focus via toward_focus pointers
    static thread_local std::vector<int32_t> path_nodes, path_edges;
    path_nodes.clear(); path_edges.clear();
    int32_t cur = target;
    while (cur != focus) {
      int32_t e = toward_focus[cur];
      if (e == NO_EDGE || !edges[e].alive) {
        std::fprintf(stderr,
                     "[init_native] move_focus_to BROKEN at %s: cur=%d target=%d "
                     "focus=%d e=%d deg(cur)=%d\n",
                     g_where, cur, target, focus, e, degree(cur));
        std::abort();
      }
      path_nodes.push_back(cur);
      path_edges.push_back(e);
      cur = edges[e].other(cur);
    }
    // walk focus -> target (reverse order), flipping pointers
    for (int i = (int)path_nodes.size() - 1; i >= 0; i--) {
      int32_t e = path_edges[i];
      int32_t nxt = path_nodes[i];
      apply_edge_to_fdiff(edges[e], focus);
      toward_focus[focus] = e;
      toward_focus[nxt] = NO_EDGE;
      focus = nxt;
    }
  }

  // ---- debug invariant (env DELPHY_TPU_INIT_CHECK) -------------------------

  void check_routing(const char* where, int32_t detached_sink = NO_NODE) {
    // structural symmetry: alive edges appear exactly once in both endpoint
    // lists; node-list entries reference alive edges with that endpoint
    for (int32_t e = 0; e < (int32_t)edges.size(); e++) {
      if (!edges[e].alive) continue;
      for (int32_t n : {edges[e].a, edges[e].b}) {
        int cnt = 0;
        for (int k = 0; k < 3; k++) cnt += node_edges[n][k] == e;
        if (cnt != 1) {
          std::fprintf(stderr,
                       "[init_native] EDGE/NODE BROKEN at %s: edge %d "
                       "(%d-%d) in node %d list %d times\n",
                       where, e, edges[e].a, edges[e].b, n, cnt);
          std::abort();
        }
      }
    }
    for (int32_t n = 0; n < next_inner; n++) {
      for (int k = 0; k < 3; k++) {
        int32_t e = node_edges[n][k];
        if (e == NO_EDGE) continue;
        if (!edges[e].alive ||
            (edges[e].a != n && edges[e].b != n)) {
          std::fprintf(stderr,
                       "[init_native] NODE/EDGE BROKEN at %s: node %d "
                       "lists edge %d (alive=%d, %d-%d)\n",
                       where, n, e, (int)edges[e].alive, edges[e].a,
                       edges[e].b);
          std::abort();
        }
      }
    }
    // every connected node's toward_focus chain must reach focus without
    // dead edges or cycles (nodes in a detached subtree component may
    // instead terminate at that component's root)
    for (int32_t n = 0; n < next_inner; n++) {
      if (degree(n) == 0 || n == focus) continue;
      int32_t cur = n;
      int steps = 0;
      while (cur != focus) {
        if (cur == detached_sink && toward_focus[cur] == NO_EDGE) break;
        int32_t e = toward_focus[cur];
        if (e == NO_EDGE || !edges[e].alive ||
            (edges[e].a != cur && edges[e].b != cur) ||
            ++steps > next_inner) {
          std::fprintf(stderr,
                       "[init_native] ROUTING BROKEN at %s: node %d "
                       "(start %d, focus %d, edge %d)\n",
                       where, cur, n, focus, e);
          std::abort();
        }
        cur = edges[e].other(cur);
      }
    }
  }

  // ---- placement search ---------------------------------------------------

  void init_x_tip(int32_t X) {
    x_is_tip = true;
    xt = &tips[X];
    recompute_mm();
  }

  // Snapshot the resolved state at internal node X (vs ref) as the
  // placement state for a subtree SPR: with explicit per-edge states, the
  // state at X is exactly the focus diff when the focus sits at X.
  void init_x_subtree(int32_t X) {
    g_where = "subtree_snapshot";
    move_focus_to(X);
    xdiff = fdiff;
    x_is_tip = false;
    xt = nullptr;
  }

  // Follow toward_focus routing from n to its local sink (== focus when n
  // is in the focus's component; == the detached subtree root otherwise).
  int32_t local_sink(int32_t n) const {
    while (true) {
      int32_t e = toward_focus[n];
      if (e == NO_EDGE || !edges[e].alive) return n;
      n = edges[e].other(n);
    }
  }

  void recompute_mm() {
    // mm over union of x-delta sites and fdiff sites
    mm = 0;
    if (x_is_tip) {
      for (int32_t k = 0; k < xt->n_d; k++) {
        int32_t s = xt->d_site[k];
        if (xt->missing(s)) continue;
        if (xt->d_state[k] != f_state(s)) mm++;
      }
      for (const auto& [s, fs] : fdiff) {
        if (xt->delta_state(s) >= 0) continue;  // counted above
        if (xt->missing(s)) continue;
        if (ref[s] != fs) mm++;
      }
    } else {
      for (const auto& [s, xs] : xdiff) {
        if (xs != f_state(s)) mm++;
      }
      for (const auto& [s, fs] : fdiff) {
        if (xdiff.count(s)) continue;
        if (ref[s] != fs) mm++;
      }
    }
  }

  int eval_focal_edge(const UEdge& e) const {
    // cost of attaching X mid-edge e (origin side = focus):
    // savings at delta sites where focus mismatches x but far side matches
    int savings = 0;
    for (const auto& dl : e.d) {
      if (x_missing(dl.site)) continue;
      int8_t x = x_state(dl.site);
      int8_t nearv = e.state_at(focus, dl);
      int8_t farv = e.state_at(e.other(focus), dl);
      if (x != nearv && x == farv) savings++;
    }
    return mm - savings;
  }

  int pruning_threshold(int cost) const {
    // adaptive JC same-site-blip bound (utree.cpp:262-271)
    double sigma = cost / sqrt_6L;
    int thr = (int)std::ceil(10.0 * sigma * (sigma + 5));
    if (thr < 2) thr = 2;
    if (thr > L) thr = L;
    return thr;
  }

  // Best-first search for the cheapest insertion edge, starting from the
  // current focus (utree.cpp:421-482).  Returns (edge, cost); NO_EDGE if the
  // tree has no edges yet.
  int64_t fbe_pops = 0, fbe_calls = 0;  // search-size telemetry (PROF)

  // seed_edge/seed_cost: a known attachment candidate (the rollback
  // position, as in the reference's spr_refine: utree.cpp:986-996) that
  // tightens the pruning radius from the first expansion
  std::pair<int32_t, int> find_best_edge(int32_t seed_edge = NO_EDGE,
                                         int seed_cost = INT32_MAX,
                                         int64_t max_pops = INT64_MAX) {
    fbe_calls++;
    track_mm = true;
    int best_cost = mm;
    static thread_local std::vector<int32_t> best_edges;
    best_edges.clear();
    if (seed_edge != NO_EDGE && seed_cost <= best_cost) {
      best_cost = seed_cost;
      best_edges.push_back(seed_edge);
    }
    using QE = std::pair<int, int32_t>;
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;

    auto record = [&](int cost, int32_t e) {
      if (cost < best_cost) { best_cost = cost; best_edges.clear(); }
      if (cost == best_cost) best_edges.push_back(e);
    };

    for (int k = 0; k < 3; k++) {
      int32_t e = node_edges[focus][k];
      if (e == NO_EDGE) continue;
      int c = eval_focal_edge(edges[e]);
      record(c, e);
      pq.push({c, e});
    }
    int64_t pops = 0;
    while (!pq.empty()) {
      auto [prio, e_in] = pq.top();
      pq.pop();
      fbe_pops++;
      if (prio > best_cost + pruning_threshold(best_cost)) break;
      if (++pops > max_pops) break;
      // the popped edge may no longer be focal; route focus to its far end
      int32_t far = edges[e_in].other(
          toward_focus_side(e_in));
      g_where = "find_best_edge";
      move_focus_to(far);
      for (int k = 0; k < 3; k++) {
        int32_t e = node_edges[focus][k];
        if (e == NO_EDGE || e == e_in) continue;
        int c = eval_focal_edge(edges[e]);
        record(c, e);
        pq.push({c, e});
      }
    }
    track_mm = false;
    if (best_edges.empty()) return {NO_EDGE, best_cost};
    int32_t pick = best_edges[rng() % best_edges.size()];
    return {pick, best_cost};
  }

  // which endpoint of e currently routes toward the focus
  int32_t toward_focus_side(int32_t e) {
    int32_t a = edges[e].a, b = edges[e].b;
    // the endpoint nearer the focus is the one whose toward_focus != e
    if (a == focus || toward_focus[b] == e) return a;
    return b;
  }

  // ---- attachment ---------------------------------------------------------

  // Split edge e, inserting M; distribute e's deltas so M's state prefers
  // x's state where possible (avoids M-X mutations; utree.cpp:586-600).
  // Pre: focus is an endpoint of e.  Post: focus unchanged; M adjacent.
  void split_edge_inserting(int32_t e, int32_t M) {
    UEdge& old_ = edges[e];
    int32_t U = focus;
    int32_t V = old_.other(U);
    // new edge M-V inherits the far-side connection
    del_node_edge(V, e);
    int32_t e_mv = new_edge(M, V);
    // rewire e to U-M, keep id (U keeps its slot)
    std::vector<Delta> old_d = std::move(edges[e].d);
    int32_t olda = edges[e].a;
    edges[e].a = U; edges[e].b = M;
    edges[e].d.clear();
    dcount -= (int64_t)old_d.size();
    add_node_edge(M, e);
    for (const auto& dl : old_d) {
      int8_t su = (olda == U) ? dl.sa : dl.sb;
      int8_t sv = (olda == U) ? dl.sb : dl.sa;
      int8_t x = x_state(dl.site);
      bool xm = x_missing(dl.site);
      int8_t m = (!xm && (x == su || x == sv)) ? x : su;
      if (su != m) { edges[e].d.push_back({dl.site, su, m}); dcount++; }
      if (m != sv) { edges[e_mv].d.push_back({dl.site, m, sv}); dcount++; }
    }
    toward_focus[M] = e;       // M routes to U (= focus)
    toward_focus[V] = e_mv;    // V now routes via M
  }

  // Compute the M-X edge deltas after split (x vs m; m differs from focus
  // state only at the split edge's redistributed sites, which are already on
  // the U-M edge).  m_state(s) = f_state(s) adjusted by U-M edge deltas.
  void wire_x(int32_t M, int32_t X, int32_t e_um) {
    int32_t e_mx = new_edge(M, X);
    auto m_state = [&](int32_t s) -> int8_t {
      for (const auto& dl : edges[e_um].d)
        if (dl.site == s) return edges[e_um].state_at(M, dl);
      return f_state(s);
    };
    // union of x-delta sites, fdiff sites, and U-M edge sites
    static thread_local std::vector<int32_t> sites;
    sites.clear();
    if (x_is_tip) {
      for (int32_t k = 0; k < xt->n_d; k++) sites.push_back(xt->d_site[k]);
    } else {
      for (const auto& [s, _] : xdiff) sites.push_back(s);
    }
    for (const auto& [s, _] : fdiff) sites.push_back(s);
    for (const auto& dl : edges[e_um].d) sites.push_back(dl.site);
    std::sort(sites.begin(), sites.end());
    sites.erase(std::unique(sites.begin(), sites.end()), sites.end());
    for (int32_t s : sites) {
      if (x_missing(s)) continue;
      int8_t m = m_state(s);
      int8_t x = x_state(s);
      if (m != x) { edges[e_mx].d.push_back({s, m, x}); dcount++; }
    }
    toward_focus[X] = e_mx;    // X routes via M (M routes to focus)
  }

  void attach_x_at(int32_t e_best, int32_t M, int32_t X) {
    g_where = "attach_x_at";
    move_focus_to(toward_focus_side(e_best));
    split_edge_inserting(e_best, M);
    wire_x(M, X, e_best);
  }

  // ---- guide-tree build ---------------------------------------------------

  void add_first_two(int32_t X0, int32_t X1) {
    focus = X0;
    fdiff.clear();
    const TipView& t0 = tips[X0];
    for (int32_t k = 0; k < t0.n_d; k++)
      if (t0.d_state[k] != ref[t0.d_site[k]])
        fdiff[t0.d_site[k]] = t0.d_state[k];
    // direct edge X0-X1 (deltas where x1 differs from x0, non-missing at x1)
    init_x_tip(X1);
    int32_t e = new_edge(X0, X1);
    static thread_local std::vector<int32_t> sites;
    sites.clear();
    const TipView& t1 = tips[X1];
    for (int32_t k = 0; k < t1.n_d; k++) sites.push_back(t1.d_site[k]);
    for (const auto& [s, _] : fdiff) sites.push_back(s);
    std::sort(sites.begin(), sites.end());
    sites.erase(std::unique(sites.begin(), sites.end()), sites.end());
    for (int32_t s : sites) {
      if (t1.missing(s)) continue;
      int8_t f = f_state(s), x = x_state(s);
      if (f != x) { edges[e].d.push_back({s, f, x}); dcount++; }
    }
    toward_focus[X1] = e;
  }

  void add_tip(int32_t X) {
    init_x_tip(X);
    auto [e_best, cost] = find_best_edge();
    (void)cost;
    if (e_best == NO_EDGE) return;   // degenerate
    int32_t M = next_inner++;
    attach_x_at(e_best, M, X);
  }

  // ---- nearest-first order (multi-source Dijkstra over delta metric) ------

  std::vector<std::pair<int32_t, int32_t>> nearest_first_order() {
    // returns (tip, closest_prev_tip) in visit order
    std::vector<std::pair<int32_t, int32_t>> out;
    out.reserve(T);
    int32_t n_all = next_inner;
    std::vector<int64_t> dist(n_all, INT64_MAX);
    std::vector<int32_t> src(n_all, NO_NODE);
    using QE = std::pair<int64_t, int32_t>;
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
    std::vector<char> emitted(T, 0);

    int32_t start = (int32_t)(rng() % T);
    out.push_back({start, NO_NODE});
    emitted[start] = 1;
    dist[start] = 0; src[start] = start;
    pq.push({0, start});
    while (!pq.empty()) {
      auto [d, n] = pq.top(); pq.pop();
      if (d > dist[n]) continue;
      if (n < T && !emitted[n]) {
        out.push_back({n, src[n]});
        emitted[n] = 1;
        // make this tip a new source
        dist[n] = 0; src[n] = n;
        pq.push({0, n});
        continue;
      }
      for (int k = 0; k < 3; k++) {
        int32_t e = node_edges[n][k];
        if (e == NO_EDGE || !edges[e].alive) continue;
        int32_t m = edges[e].other(n);
        int64_t nd = dist[n] + (int64_t)edges[e].d.size();
        if (nd < dist[m]) { dist[m] = nd; src[m] = src[n]; pq.push({nd, m}); }
      }
    }
    // any unreached tips (disconnected — shouldn't happen) appended
    for (int32_t i = 0; i < T; i++)
      if (!emitted[i]) out.push_back({i, NO_NODE});
    return out;
  }

  // ---- spr refine ---------------------------------------------------------

  int64_t count_deltas() const {
    int64_t c = 0;
    for (const auto& e : edges) if (e.alive) c += (int64_t)e.d.size();
    return c;
  }

  // Detach tip X (degree 1): remove M (its neighbor, degree 3), merge M's
  // other two edges into one.  Returns the merged edge id.
  int32_t detach_tip(int32_t X) {
    int32_t e_mx = node_edges[X][0];
    for (int k = 1; k < 3; k++)
      if (node_edges[X][k] != NO_EDGE) e_mx = node_edges[X][k];
    return detach_via(X, e_mx);
  }

  // Detach X's side of edge e_mx (X a tip or an internal subtree root):
  // remove M = the far endpoint, merging M's other two edges into one.
  // Pre: the focus is NOT in X's component (for internal X, the caller must
  // move it to the M side first).  Returns the freed inner node M.
  int32_t detach_via(int32_t X, int32_t e_mx) {
    int32_t M = edges[e_mx].other(X);
    // move focus off the doomed region
    int32_t e1 = NO_EDGE, e2 = NO_EDGE;
    for (int k = 0; k < 3; k++) {
      int32_t e = node_edges[M][k];
      if (e == NO_EDGE || e == e_mx) continue;
      if (e1 == NO_EDGE) e1 = e; else e2 = e;
    }
    int32_t P = edges[e1].other(M);
    int32_t Q = edges[e2].other(M);
    if (focus == X || focus == M) { g_where = "detach_escape"; move_focus_to(P); }
    // compose P-M and M-Q into P-Q on edge id e1
    std::unordered_map<int32_t, std::pair<int8_t, int8_t>> comp;
    for (const auto& dl : edges[e1].d)
      comp[dl.site] = {edges[e1].state_at(P, dl), edges[e1].state_at(M, dl)};
    for (const auto& dl : edges[e2].d) {
      int8_t sm = edges[e2].state_at(M, dl);
      int8_t sq = edges[e2].state_at(Q, dl);
      auto it = comp.find(dl.site);
      if (it == comp.end()) comp[dl.site] = {sm, sq};
      else it->second.second = sq;
    }
    edges[e1].a = P; edges[e1].b = Q;
    dcount -= (int64_t)edges[e1].d.size() + (int64_t)edges[e2].d.size()
              + (int64_t)edges[e_mx].d.size();  // e2/e_mx die below
    edges[e1].d.clear();
    for (const auto& [s, pq_] : comp)
      if (pq_.first != pq_.second) {
        edges[e1].d.push_back({s, pq_.first, pq_.second});
        dcount++;
      }
    std::sort(edges[e1].d.begin(), edges[e1].d.end(),
              [](const Delta& x, const Delta& y) { return x.site < y.site; });
    // tip-adjacency invariant: strip deltas at sites missing at tip P or Q
    auto strip = [&](int32_t n) {
      if (n >= T) return;
      auto& dv = edges[e1].d;
      auto old_n = (int64_t)dv.size();
      dv.erase(std::remove_if(dv.begin(), dv.end(), [&](const Delta& dl) {
        if (!tips[n].missing(dl.site)) return false;
        if (n == focus) {
          // the stripped mutation slides onto the focus: state changes
          int8_t ns = edges[e1].state_at(edges[e1].other(n), dl);
          if (ns == ref[dl.site]) fdiff.erase(dl.site);
          else fdiff[dl.site] = ns;
        }
        return true;
      }), dv.end());
      dcount -= old_n - (int64_t)dv.size();
    };
    strip(P); strip(Q);
    // unlink M and X and the dead edges (e2 dies: remove it from BOTH
    // endpoint lists, else Q's full list silently drops the merged e1)
    del_node_edge(M, e_mx); del_node_edge(M, e1); del_node_edge(M, e2);
    del_node_edge(Q, e2);
    del_node_edge(X, e_mx);
    edges[e_mx].alive = false;
    edges[e2].alive = false;
    // re-add e1 to node lists (endpoints changed)
    del_node_edge(P, e1); del_node_edge(Q, e1);
    add_node_edge(P, e1); add_node_edge(Q, e1);
    // fix routing: anything that routed through M/e2 must re-route via e1
    if (toward_focus[P] == e2 || toward_focus[P] == e_mx) toward_focus[P] = e1;
    if (toward_focus[Q] == e2 || toward_focus[Q] == e_mx) toward_focus[Q] = e1;
    toward_focus[M] = NO_EDGE;
    toward_focus[X] = NO_EDGE;
    last_merged_edge = e1;
    return M;  // the freed inner node, reused on reattach
  }
  int32_t last_merged_edge = NO_EDGE;

  bool debug_check = false;
  // incrementally-maintained Sum |edges[e].d| over ALIVE edges: the
  // spr_refine improvement test needs it every attempt and the full
  // count_deltas() scan was 58% of the whole init at 10k tips
  int64_t dcount = 0;

  void spr_refine(int max_attempts, int patience) {
    if (T <= 3) return;
    debug_check = std::getenv("DELPHY_TPU_INIT_CHECK") != nullptr;
    const bool prof = std::getenv("DELPHY_TPU_INIT_PROF") != nullptr;
    // cap on the refine search's best-first expansion: the search radius
    // grows with the mutation-free neighborhood (measured pops/search 145
    // at 20k tips -> 285 at 50k -> 483 at 100k), so huge trees spend most
    // of refine flooding.  Capping at 128 cut refine 157s -> 50s at 100k
    // for +0.4% mutations (18095 vs 18016) — noise for an MCMC starting
    // point — so it is the default at >=50k tips; unbounded below, where
    // the flood is cheap.  DELPHY_TPU_INIT_MAX_POPS overrides (-1 =
    // unbounded).
    int64_t max_pops = T >= 50000 ? 128 : INT64_MAX;
    if (const char* mp = std::getenv("DELPHY_TPU_INIT_MAX_POPS"))
      if (int64_t v = std::atoll(mp); v != 0)
        max_pops = v > 0 ? v : INT64_MAX;
    double t_detach = 0, t_restart = 0, t_search = 0, t_attach = 0,
           t_count = 0;
    int64_t n_att = 0;
    auto now_s = [] {
      return std::chrono::duration<double>(
                 std::chrono::steady_clock::now().time_since_epoch())
          .count();
    };
    int non_improve = 0;
    int64_t cur = count_deltas();
    dcount = cur;
    for (int att = 0; att < max_attempts && non_improve < patience; att++) {
      // reference pick (utree.cpp:935-943): random degree-3 node M, random
      // incident edge -> X, which is a tip (tip SPR) or internal (subtree
      // SPR)
      int32_t M = (int32_t)(rng() % next_inner);
      if (degree(M) != 3) continue;
      int32_t e_mx = node_edges[M][rng() % 3];
      if (e_mx == NO_EDGE) continue;
      int32_t X = edges[e_mx].other(M);
      bool tip_case = X < T;
      if (!tip_case && degree(X) != 3) continue;
      n_att++;
      double t0 = prof ? now_s() : 0;
      if (tip_case) {
        // leave placement init to after the detach (tip data is static)
      } else {
        init_x_subtree(X);       // snapshot state at X (focus moves to X)
        move_focus_to(M);        // escape X's component before the cut
      }
      int64_t dc_before = dcount;
      int32_t Mfree = detach_via(X, e_mx);
      // deltas freed by the detach: the reference's old_cost
      // (utree.cpp:985, 1056)
      int rb_old_cost = (int)(dc_before - dcount);
      if (debug_check) check_routing("after detach", tip_case ? NO_NODE : X);
      if (tip_case) init_x_tip(X);  // recomputes mm against the new X
      else recompute_mm();          // fdiff changed across the detach
      // from here to the attach, every focus move updates mm
      // incrementally (apply_edge_to_fdiff's track_mm branch) — the two
      // full recompute_mm rescans this replaces were 66% of spr_refine
      // at 20k tips (restart 6.1s of 9.2s, DELPHY_TPU_INIT_PROF)
      track_mm = true;
      if (prof) { double t1 = now_s(); t_detach += t1 - t0; t0 = t1; }
      // rollback seed: evaluate re-attaching at the merged P-Q edge (the
      // old position) first; it bounds the search radius from the start
      // (utree.cpp:986-996)
      int32_t e_rb = last_merged_edge;
      g_where = "rollback_eval";
      move_focus_to(edges[e_rb].a);
      if (debug_check) {
        int inc_mm = mm;
        recompute_mm();
        if (inc_mm != mm) {
          std::fprintf(stderr, "[init_native] mm DRIFT: inc %d != %d\n",
                       inc_mm, mm);
          std::abort();
        }
      }
      int rb_cost = eval_focal_edge(edges[e_rb]);
      int32_t e_best = e_rb;
      int cost = rb_cost;
      // the reference searches only when the rollback is not already an
      // improvement (utree.cpp:1063-1068)
      if (rb_cost >= rb_old_cost) {
        // Search from the rollback edge (the detach neighborhood).  The
        // reference restarts at a uniformly random node (utree.cpp
        // spr_refine) to spread the search, but with the rollback-seeded
        // pruning bound a far restart almost always terminates without
        // finding anything within the bound (measured pops/search 27
        // uniform vs 145 local at 20k tips) while paying an O(diameter)
        // focus walk per attempt; the local search is both faster
        // (restart 7.1s -> 0.7s of a 10.8s refine at 20k) and lands a
        // more parsimonious tree (muts 8056 -> 8001 seed 7, 8328 -> 8266
        // seed 11).  DELPHY_TPU_INIT_UNIFORM_RESTART=1 restores the
        // reference's behavior; for a subtree SPR the restart must land
        // in the focus's component (bounded rejection sampling).
        int32_t S = focus;
        if (std::getenv("DELPHY_TPU_INIT_UNIFORM_RESTART"))
          for (int tries = 0; tries < 32; tries++) {
            int32_t c = (int32_t)(rng() % next_inner);
            if (c != X && degree(c) != 0 && local_sink(c) == focus) {
              S = c;
              break;
            }
          }
        g_where = "refine_restart";
        move_focus_to(S);
        if (prof) { double t1 = now_s(); t_restart += t1 - t0; t0 = t1; }
        auto found = find_best_edge(e_rb, rb_cost, max_pops);
        e_best = found.first;
        cost = found.second;
      } else if (prof) {
        double t1 = now_s(); t_restart += t1 - t0; t0 = t1;
      }
      (void)cost;
      if (debug_check) check_routing("after search", tip_case ? NO_NODE : X);
      if (prof) { double t1 = now_s(); t_search += t1 - t0; t0 = t1; }
      track_mm = false;  // attach mutates edges/fdiff outside the walk
      attach_x_at(e_best, Mfree, X);
      if (debug_check) check_routing("after attach");
      if (prof) { double t1 = now_s(); t_attach += t1 - t0; t0 = t1; }
      int64_t now = dcount;
      if (debug_check && now != count_deltas()) {
        std::fprintf(stderr, "[init_native] dcount DRIFT: %lld != %lld\n",
                     (long long)now, (long long)count_deltas());
        std::abort();
      }
      if (prof) { double t1 = now_s(); t_count += t1 - t0; t0 = t1; }
      if (now < cur) { cur = now; non_improve = 0; }
      else non_improve++;
    }
    if (prof)
      std::fprintf(stderr,
                   "[init_native] spr_refine prof: att=%lld detach=%.1fs "
                   "restart=%.1fs search=%.1fs attach=%.1fs count=%.1fs "
                   "pops/search=%.0f\n",
                   (long long)n_att, t_detach, t_restart, t_search, t_attach,
                   t_count,
                   fbe_calls ? (double)fbe_pops / (double)fbe_calls : 0.0);
  }
};

// ---- rooting + emission ----------------------------------------------------

struct RootStats {
  double cnt = 0, sd = 0, sdd = 0, st = 0, sdt = 0;
  void add_tip(double t) { cnt += 1; st += t; }
  void absorb_child(const RootStats& c, double w) {
    // child stats seen across an edge of weight w
    cnt += c.cnt;
    sd += c.sd + w * c.cnt;
    sdd += c.sdd + 2 * w * c.sd + w * w * c.cnt;
    st += c.st;
    sdt += c.sdt + w * c.st;
  }
};

}  // namespace

extern "C" int64_t delphy_build_initial_topology(
    int32_t T, int32_t L, const int8_t* ref,
    const int64_t* d_off, const int32_t* d_site, const int8_t* d_state,
    const int64_t* m_off, const int32_t* m_start, const int32_t* m_end,
    const double* tip_date_mid,       // [T] midpoint dates for regression
    uint64_t seed, int32_t refine_passes,
    // outputs: rooted topology over N = 2T-1 nodes (root = node 2T-2)
    int32_t* parent, int32_t* children /*N*2*/,
    // branch "mutation" sites CSR (per non-root node): site, from, to
    int64_t mut_cap, int64_t* mut_off /*N+1*/,
    int32_t* mut_site, int8_t* mut_from, int8_t* mut_to,
    // root diff vs ref
    int64_t rd_cap, int64_t* rd_n, int32_t* rd_site, int8_t* rd_state,
    double* out_mu_per_day, double* out_t_mrca, double* out_r2) {
  if (T < 3) return -1;
  const bool verbose = std::getenv("DELPHY_TPU_INIT_VERBOSE") != nullptr;
  auto t_last = std::chrono::steady_clock::now();
  auto stage = [&](const char* name) {
    if (!verbose) return;
    auto now = std::chrono::steady_clock::now();
    std::fprintf(stderr, "[init_native] %s: %.1fs\n", name,
                 std::chrono::duration<double>(now - t_last).count());
    t_last = now;
  };
  Builder B(T, L, ref, seed);
  B.tips.resize(T);
  for (int32_t i = 0; i < T; i++) {
    B.tips[i] = TipView{d_site + d_off[i], d_state + d_off[i],
                        (int32_t)(d_off[i + 1] - d_off[i]),
                        m_start + m_off[i], m_end + m_off[i],
                        (int32_t)(m_off[i + 1] - m_off[i])};
  }

  // ---- phase 1: guide tree ------------------------------------------------
  // Insertion in delta-lexicographic order instead of input order: similar
  // tips arrive consecutively, so each placement search starts (via the
  // focus left at the previous attach) near its destination — the same
  // locality that makes the phase-2 nearest-first rebuild cheap.  The guide
  // only feeds the phase-2 Dijkstra metric, so the order is free to choose.
  // DELPHY_TPU_INIT_INPUT_ORDER=1 restores input order.
  {
    std::vector<int32_t> gorder(T);
    for (int32_t i = 0; i < T; i++) gorder[i] = i;
    if (!std::getenv("DELPHY_TPU_INIT_INPUT_ORDER"))
      std::sort(gorder.begin(), gorder.end(), [&](int32_t a, int32_t b) {
        const TipView &ta = B.tips[a], &tb = B.tips[b];
        int32_t n = std::min(ta.n_d, tb.n_d);
        for (int32_t k = 0; k < n; k++) {
          if (ta.d_site[k] != tb.d_site[k]) return ta.d_site[k] < tb.d_site[k];
          if (ta.d_state[k] != tb.d_state[k]) return ta.d_state[k] < tb.d_state[k];
        }
        if (ta.n_d != tb.n_d) return ta.n_d < tb.n_d;
        return a < b;
      });
    B.add_first_two(gorder[0], gorder[1]);
    for (int32_t i = 2; i < T; i++) B.add_tip(gorder[i]);
  }

  stage("guide");
  // ---- phase 2: nearest-first rebuild -------------------------------------
  {
    auto order = B.nearest_first_order();
    Builder B2(T, L, ref, seed ^ 0x9E3779B97F4A7C15ull);
    B2.tips = B.tips;
    B2.add_first_two(order[0].first, order[1].first);
    for (size_t k = 2; k < order.size(); k++) {
      auto [tip, prev] = order[k];
      if (prev != NO_NODE && B2.degree(prev) > 0) { B2.g_where = "rebuild"; B2.move_focus_to(prev); }
      B2.add_tip(tip);
    }
    B = std::move(B2);
  }

  stage("nearest-first rebuild");
  // ---- phase 3: spr refinement -------------------------------------------
  if (refine_passes > 0)
    B.spr_refine(refine_passes * T, /*patience=*/5 * T);
  stage("spr_refine");

  // ---- phase 4: OLS rooting over edge midpoints ---------------------------
  // (stage timing printed at emission below)
  // orient unrooted tree at node 0 for the DP
  int32_t n_all = B.next_inner;
  std::vector<int32_t> up_edge(n_all, NO_EDGE), order_;
  {
    std::vector<char> seen(n_all, 0);
    std::vector<int32_t> stack = {0};
    seen[0] = 1;
    while (!stack.empty()) {
      int32_t n = stack.back(); stack.pop_back();
      order_.push_back(n);
      for (int k = 0; k < 3; k++) {
        int32_t e = B.node_edges[n][k];
        if (e == NO_EDGE || !B.edges[e].alive) continue;
        int32_t m = B.edges[e].other(n);
        if (!seen[m]) { seen[m] = 1; up_edge[m] = e; stack.push_back(m); }
      }
    }
  }
  std::vector<RootStats> down(n_all);   // stats of tips in own subtree
  for (int i = (int)order_.size() - 1; i >= 0; i--) {
    int32_t n = order_[i];
    if (n < T) down[n].add_tip(tip_date_mid[n]);
    for (int k = 0; k < 3; k++) {
      int32_t e = B.node_edges[n][k];
      if (e == NO_EDGE || !B.edges[e].alive || e == up_edge[n]) continue;
      int32_t c = B.edges[e].other(n);
      down[n].absorb_child(down[c], (double)B.edges[e].d.size());
    }
  }
  std::vector<RootStats> up(n_all);     // stats of tips OUTSIDE own subtree
  for (int32_t idx = 0; idx < (int32_t)order_.size(); idx++) {
    int32_t n = order_[idx];
    for (int k = 0; k < 3; k++) {
      int32_t e = B.node_edges[n][k];
      if (e == NO_EDGE || !B.edges[e].alive || e == up_edge[n]) continue;
      int32_t c = B.edges[e].other(n);
      // stats at n excluding subtree(c): up[n] + own tip + other children
      RootStats excl = up[n];
      if (n < T) excl.add_tip(tip_date_mid[n]);
      for (int k2 = 0; k2 < 3; k2++) {
        int32_t e2 = B.node_edges[n][k2];
        if (e2 == NO_EDGE || !B.edges[e2].alive || e2 == up_edge[n] || e2 == e)
          continue;
        int32_t c2 = B.edges[e2].other(n);
        excl.absorb_child(down[c2], (double)B.edges[e2].d.size());
      }
      up[c].absorb_child(excl, (double)B.edges[e].d.size());
    }
  }

  double best_r2 = -1e300, best_slope = 0, best_icept = 0;
  int32_t best_edge = NO_EDGE;
  double vt, mt_all;
  {
    double st2 = 0, st1 = 0;
    for (int32_t i = 0; i < T; i++) {
      st1 += tip_date_mid[i];
      st2 += tip_date_mid[i] * tip_date_mid[i];
    }
    mt_all = st1 / T;
    vt = st2 / T - mt_all * mt_all;
  }
  for (int32_t e = 0; e < (int32_t)B.edges.size(); e++) {
    if (!B.edges[e].alive) continue;
    int32_t a = B.edges[e].a, b = B.edges[e].b;
    // stats at midpoint: child side = the deeper endpoint's subtree
    int32_t child = (up_edge[a] == e) ? a : b;
    int32_t par = B.edges[e].other(child);
    double w = (double)B.edges[e].d.size();
    RootStats s;  // all tips, distances from the midpoint
    s.absorb_child(down[child], 0.5 * w);
    RootStats other = up[child];  // at `par`, excluding subtree(child)... no:
    // up[child] is stats at child of tips outside subtree(child), distances
    // measured THROUGH the full edge.  Rebuild from par side instead:
    RootStats par_side = up[child];
    // par_side distances are from `child` (they crossed edge e fully);
    // shift back to midpoint: subtract 0.5*w from each distance
    double hw = 0.5 * w;
    RootStats shifted;
    shifted.cnt = par_side.cnt;
    shifted.sd = par_side.sd - hw * par_side.cnt;
    shifted.sdd = par_side.sdd - 2 * hw * par_side.sd + hw * hw * par_side.cnt;
    shifted.st = par_side.st;
    shifted.sdt = par_side.sdt - hw * par_side.st;
    s.cnt += shifted.cnt; s.sd += shifted.sd; s.sdd += shifted.sdd;
    s.st += shifted.st; s.sdt += shifted.sdt;
    (void)par;
    double n = s.cnt;
    if (n < 2) continue;
    double md = s.sd / n, mt = s.st / n;
    double cov = s.sdt / n - md * mt;
    double vd = s.sdd / n - md * md;
    double r2, slope;
    if (vd <= 0 || vt <= 0) { r2 = -1; slope = 0; }
    else {
      slope = cov / vt;
      r2 = cov * cov / (vd * vt);
      if (slope <= 0) r2 = -r2;
    }
    if (r2 > best_r2) {
      best_r2 = r2;
      best_slope = slope;
      best_icept = md - slope * mt;
      best_edge = e;
    }
  }
  if (best_edge == NO_EDGE) return -2;
  double slope = best_slope > (1.0 / 26.0) ? best_slope : (1.0 / 26.0);
  double t_mrca = -best_icept / slope;
  *out_mu_per_day = slope;
  *out_t_mrca = t_mrca;
  *out_r2 = best_r2;

  // ---- phase 5: orient at best edge, emit rooted arrays -------------------
  int32_t N = 2 * T - 1;
  int32_t R = N - 1;                 // root node id
  for (int32_t i = 0; i < N; i++) {
    parent[i] = NO_NODE;
    children[2 * i] = NO_NODE;
    children[2 * i + 1] = NO_NODE;
  }
  int32_t ra = B.edges[best_edge].a, rb = B.edges[best_edge].b;
  parent[ra] = parent[rb] = R;
  children[2 * R] = std::min(ra, rb);
  children[2 * R + 1] = std::max(ra, rb);

  // root state: ra's full diff vs ref, with root-edge deltas split randomly
  B.move_focus_to(ra);
  std::unordered_map<int32_t, int8_t> rdiff = B.fdiff;  // ref -> ra
  // per-branch mutation lists
  std::vector<std::vector<Delta>> bmuts(N);
  for (const auto& dl : B.edges[best_edge].d) {
    int8_t s_ra = B.edges[best_edge].state_at(ra, dl);
    int8_t s_rb = B.edges[best_edge].state_at(rb, dl);
    if (B.rng() & 1) {
      // mutation on root->ra branch: root carries rb's state
      if (s_rb == ref[dl.site]) rdiff.erase(dl.site);
      else rdiff[dl.site] = s_rb;
      bmuts[ra].push_back({dl.site, s_rb, s_ra});
    } else {
      // mutation on root->rb branch: root carries ra's state (already)
      bmuts[rb].push_back({dl.site, s_ra, s_rb});
    }
  }
  // BFS orient the rest
  {
    std::vector<int32_t> stack = {ra, rb};
    std::vector<char> seen(n_all, 0);
    seen[ra] = seen[rb] = 1;
    while (!stack.empty()) {
      int32_t u = stack.back(); stack.pop_back();
      for (int k = 0; k < 3; k++) {
        int32_t e = B.node_edges[u][k];
        if (e == NO_EDGE || !B.edges[e].alive || e == best_edge) continue;
        int32_t v = B.edges[e].other(u);
        if (seen[v]) continue;
        seen[v] = 1;
        parent[v] = u;
        if (children[2 * u] == NO_NODE) children[2 * u] = v;
        else if (children[2 * u] > v) {
          children[2 * u + 1] = children[2 * u];
          children[2 * u] = v;
        } else children[2 * u + 1] = v;
        for (const auto& dl : B.edges[e].d)
          bmuts[v].push_back({dl.site,
                              B.edges[e].state_at(u, dl),
                              B.edges[e].state_at(v, dl)});
        stack.push_back(v);
      }
    }
  }

  // CSR emission
  int64_t total = 0;
  for (int32_t n = 0; n < N; n++) total += (int64_t)bmuts[n].size();
  if (total > mut_cap) return -(1000 + total);
  int64_t pos = 0;
  for (int32_t n = 0; n < N; n++) {
    mut_off[n] = pos;
    for (const auto& dl : bmuts[n]) {
      mut_site[pos] = dl.site;
      mut_from[pos] = dl.sa;
      mut_to[pos] = dl.sb;
      pos++;
    }
  }
  mut_off[N] = pos;

  int64_t nrd = 0;
  for (const auto& [s, st] : rdiff) {
    if (nrd >= rd_cap) return -3;
    rd_site[nrd] = s;
    rd_state[nrd] = st;
    nrd++;
  }
  *rd_n = nrd;
  return total;
}

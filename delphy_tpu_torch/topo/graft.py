"""SPR graft machinery on the host FlatTree.

Re-implements the reference's Spr_move (core/spr_move.{h,cpp}): analysis of the
"warm/hot" sites on the X -> root path whose pruned-tree path would vanish if X
were pruned, peeling/applying their mutational histories, and the prune-regraft
`move` itself.  Where the reference performs `move` through a chain of
slide/hop/flip edit-session primitives (core/tree_editing.cpp), this
implementation detaches and reattaches directly and recomposes the
nexus-to-X site deltas through the pruned tree (same invariants: the session
strips X's branch mutations into a running delta and re-synthesizes mid-branch
mutations at the end, tree_editing.cpp:22-29 + end()).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..phylo import FlatTree, Mutation, NO_NODE
from . import site_deltas as sd
from .history import (sample_mutational_history,
                      sample_unconstrained_mutational_history,
                      adjust_mutational_history)

K_BRANCH_INFO_P_X = 0
K_BRANCH_INFO_P_S = 1
K_BRANCH_INFO_S_P_X = 2

ROOT_DELTA_T = -1.0e30  # time sentinel for root-sequence deltas


@dataclass
class BranchInfo:
    A: int
    B: int
    is_open: bool
    T_to_X: float
    partial_lambda_at_A: float = 0.0
    partial_lambda_at_X: float = 0.0
    warm_sites: set = field(default_factory=set)
    hot_sites: set = field(default_factory=set)
    hot_muts_to_X: list = field(default_factory=list)
    hot_deltas_to_X: dict = field(default_factory=dict)


@dataclass
class Graft:
    X: int
    S: int
    t_P: float
    rooty: bool
    branch_infos: list = field(default_factory=list)
    delta_log_G: float = 0.0
    log_alpha_mut: float = 0.0


class ComplementSites:
    """Lazy 'all L sites except `excluded`' — avoids materializing L-element
    sets on the hot P->X graft level (only membership and size are needed)."""

    __slots__ = ("L", "excluded")

    def __init__(self, L: int, excluded=frozenset()):
        self.L = L
        self.excluded = excluded

    def __contains__(self, site) -> bool:
        return 0 <= site < self.L and site not in self.excluded

    def __len__(self) -> int:
        return self.L - len(self.excluded)

    def __bool__(self) -> bool:
        return len(self) > 0

    def __sub__(self, other):
        return ComplementSites(self.L, frozenset(self.excluded | set(other)))


def _miss_sites(tree: FlatTree, node: int) -> set:
    out = set()
    for (s, e) in tree.miss_intervals[node]:
        out.update(range(s, e))
    return out


def _get_from_state(tree: FlatTree, node: int, site: int) -> int:
    return tree.miss_from_states[node].get(site, int(tree.ref_seq[site]))


def _set_from_state(tree: FlatTree, node: int, site: int, s: int):
    if s == int(tree.ref_seq[site]):
        tree.miss_from_states[node].pop(site, None)
    else:
        tree.miss_from_states[node][site] = s


def _sibling(tree: FlatTree, parent: int, child: int) -> int:
    a, b = tree.children[parent]
    return int(b) if int(a) == child else int(a)


def _sites_to_intervals(sites: set) -> list:
    if not sites:
        return []
    arr = sorted(sites)
    out = []
    start = prev = arr[0]
    for x in arr[1:]:
        if x == prev + 1:
            prev = x
        else:
            out.append((start, prev + 1))
            start = prev = x
    out.append((start, prev + 1))
    return out


class SprContext:
    """Holds the host tree plus evo parameters and provides the graft ops.

    evo parameters are host scalars/arrays: mu, nu[L], q[4,4], pi[4]."""

    def __init__(self, tree: FlatTree, mu: float, nu: np.ndarray, q: np.ndarray,
                 pi: np.ndarray, can_change_root: bool = True,
                 part=None, q_tab=None):
        self.tree = tree
        self.mu = float(mu)
        self.nu = np.asarray(nu, dtype=np.float64)
        self.q = np.asarray(q, dtype=np.float64)
        self.pi = np.asarray(pi, dtype=np.float64)
        self.can_change_root = can_change_root
        L = tree.num_sites
        # per-site partitions (all zero except under the mpox hack's
        # 2-partition APOBEC model; evo.py apobec_context_partition)
        if q_tab is None:
            q_tab = self.q[None]
        self.q_tab = np.asarray(q_tab, dtype=np.float64)
        self.qa_tab = -np.diagonal(self.q_tab, axis1=1, axis2=2)
        self.part = (np.zeros(L, dtype=np.int32) if part is None
                     else np.asarray(part, dtype=np.int32))
        qa_ref = self.qa_tab[self.part, tree.ref_seq]
        self.ref_cum_Q = np.concatenate(
            [[0.0], np.cumsum(self.mu * self.nu * qa_ref)])
        self.lambda_ref = float(self.ref_cum_Q[-1])

    def _qa(self, site: int, state: int) -> float:
        return self.qa_tab[self.part[site], state]

    def _qrate(self, site: int, frm: int, to: int) -> float:
        return self.q_tab[self.part[site], frm, to]

        # JC proposal rate: fixed ONCE per move (the Hastings ratio needs the
        # same proposal parameter for both grafts; subrun.cpp:502 computes it
        # before any tree modification).  Set via begin_move().
        self.mu_proposal = None

    def begin_move(self):
        self.mu_proposal = self.mu_jc()

    # ---- lambda helpers ----------------------------------------------------

    def delta_lambda_across_branch(self, node: int) -> float:
        """calc_delta_lambda_across_branch (phylo_tree_calc.h:140-155)."""
        t = self.tree
        out = 0.0
        for m in t.mutations[node]:
            out += self.mu * self.nu[m.site] * (self._qa(m.site, m.to)
                                                - self._qa(m.site, m.from_))
        for (s, e) in t.miss_intervals[node]:
            out -= self.ref_cum_Q[e] - self.ref_cum_Q[s]
        for site, frm in t.miss_from_states[node].items():
            out -= self.mu * self.nu[site] * (self._qa(site, frm)
                                              - self._qa(site, t.ref_seq[site]))
        return out

    def lambda_at(self, node: int) -> float:
        out = self.lambda_ref
        cur = node
        while cur != NO_NODE:
            out += self.delta_lambda_across_branch(cur)
            cur = int(self.tree.parent[cur])
        return out

    def _lam_over_miss(self, sites: set, from_states: dict) -> float:
        """-delta_lambda_across_missations for a sliding missation set: the
        lambda contribution of those sites just above the set's position."""
        out = 0.0
        t = self.tree
        for l in sites:
            s = from_states.get(l, int(t.ref_seq[l]))
            out += self.mu * self.nu[l] * self._qa(l, s)
        return out

    def num_missing_at(self, node: int) -> int:
        out = 0
        cur = node
        while cur != NO_NODE:
            for (s, e) in self.tree.miss_intervals[cur]:
                out += e - s
            cur = int(self.tree.parent[cur])
        return out

    def mu_jc(self) -> float:
        """Effective JC proposal rate (subrun.cpp:502)."""
        root = self.tree.root
        return self.lambda_at(root) / (self.tree.num_sites - self.num_missing_at(root))

    def branch_log_G(self, t_P: float, t_X: float, lam_X: float, muts: list) -> float:
        """calc_branch_log_G (phylo_tree_calc.h:185-206)."""
        r = -lam_X * (t_X - t_P)
        for m in muts:
            r -= (self.mu * self.nu[m.site] *
                  (self._qa(m.site, m.from_) - self._qa(m.site, m.to)) * (m.t - t_P))
            r += math.log(self.mu * self.nu[m.site] * self._qrate(m.site, m.from_, m.to))
        return r

    # ---- graft analysis ----------------------------------------------------

    def analyze_graft(self, X: int) -> Graft:
        g = self._start_graft_analysis(X)
        self._finish_graft_analysis(g)
        return g

    def propose_new_graft(self, X: int, rng: np.random.Generator) -> Graft:
        g = self._start_graft_analysis(X)
        self._propose_new_graft_mutations(g, rng)
        self._finish_graft_analysis(g)
        return g

    def _start_graft_analysis(self, X: int) -> Graft:
        if int(self.tree.parent[X]) == self.tree.root:
            return self._start_rooty(X)
        return self._start_inner(X)

    # -- rooty (X is a child of the root; spr_move.cpp:91-205) --

    def _start_rooty(self, X: int) -> Graft:
        t = self.tree
        assert self.can_change_root
        P = int(t.parent[X])
        S = _sibling(t, P, X)
        t_X, t_P, t_S = float(t.t[X]), float(t.t[P]), float(t.t[S])

        miss_P = _miss_sites(t, P)
        miss_X = _miss_sites(t, X)
        miss_S = _miss_sites(t, S)

        g = Graft(X=X, S=S, t_P=t_P, rooty=True)

        px = BranchInfo(A=P, B=X, is_open=True, T_to_X=t_X - t_P)
        px.warm_sites = set(miss_S)
        px.hot_sites = px.warm_sites
        px.partial_lambda_at_A = self._lam_over_miss(
            miss_S, t.miss_from_states[S])
        px.partial_lambda_at_X = px.partial_lambda_at_A
        for m in t.mutations[X]:
            if m.site in px.hot_sites:
                px.hot_muts_to_X.append(m)
                px.partial_lambda_at_X += (self.mu * self.nu[m.site] *
                                           (self._qa(m.site, m.to)
                                            - self._qa(m.site, m.from_)))

        ps = BranchInfo(A=P, B=S, is_open=True, T_to_X=t_S - t_P)
        ps.warm_sites = set(miss_X)
        ps.hot_sites = ps.warm_sites
        ps.partial_lambda_at_A = self._lam_over_miss(
            miss_X, t.miss_from_states[X])
        ps.partial_lambda_at_X = ps.partial_lambda_at_A
        for m in t.mutations[S]:
            if m.site in ps.hot_sites:
                ps.hot_muts_to_X.append(m)
                ps.partial_lambda_at_X += (self.mu * self.nu[m.site] *
                                           (self._qa(m.site, m.to)
                                            - self._qa(m.site, m.from_)))

        spx = BranchInfo(A=S, B=P, is_open=False,
                         T_to_X=(t_S - t_P) + (t_X - t_P))
        spx.warm_sites = ComplementSites(t.num_sites) - miss_P - miss_X - miss_S
        spx.hot_sites = spx.warm_sites
        spx.partial_lambda_at_X = self.lambda_at(X) - px.partial_lambda_at_X
        spx.partial_lambda_at_A = self.lambda_at(S) - ps.partial_lambda_at_X
        for m in reversed(t.mutations[S]):
            if m.site in spx.hot_sites:
                rm = Mutation(site=m.site, from_=m.to, to=m.from_, t=t_P - (m.t - t_P))
                spx.hot_muts_to_X.append(rm)
                sd.push_back(spx.hot_deltas_to_X, rm.site, rm.from_, rm.to)
        for m in t.mutations[X]:
            if m.site in spx.hot_sites:
                spx.hot_muts_to_X.append(m)
                sd.push_back(spx.hot_deltas_to_X, m.site, m.from_, m.to)

        g.branch_infos = [px, ps, spx]
        return g

    # -- inner (spr_move.cpp:582-740) --

    def _start_inner(self, X: int) -> Graft:
        t = self.tree
        P = int(t.parent[X])
        assert P != t.root
        S = _sibling(t, P, X)
        t_X, t_P = float(t.t[X]), float(t.t[P])

        g = Graft(X=X, S=S, t_P=t_P, rooty=False)

        px = BranchInfo(A=P, B=X, is_open=False, T_to_X=t_X - t_P)
        px.warm_sites = ComplementSites(t.num_sites)
        miss_S = _miss_sites(t, S)
        px.hot_sites = px.warm_sites - miss_S

        sliding_sites = set(miss_S)
        sliding_from = dict(t.miss_from_states[S])
        px.partial_lambda_at_A = self.lambda_at(X)
        for m in reversed(t.mutations[X]):
            px.partial_lambda_at_A += (self.mu * self.nu[m.site] *
                                       (self._qa(m.site, m.from_)
                                        - self._qa(m.site, m.to)))
        next_plB = self._lam_over_miss(sliding_sites, sliding_from)
        px.partial_lambda_at_A -= next_plB
        g.branch_infos.append(px)

        cur = P
        parent = int(t.parent[cur])
        partial_lambda = next_plB
        while sliding_sites:
            sib = _sibling(t, parent, cur)
            bi = BranchInfo(A=parent, B=cur, is_open=False,
                            T_to_X=t_X - float(t.t[parent]))
            bi.warm_sites = set(sliding_sites)

            for m in reversed(t.mutations[cur]):
                if m.site in sliding_sites:
                    partial_lambda += (self.mu * self.nu[m.site] *
                                       (self._qa(m.site, m.from_)
                                        - self._qa(m.site, m.to)))
                    if m.from_ == int(t.ref_seq[m.site]):
                        sliding_from.pop(m.site, None)
                    else:
                        sliding_from[m.site] = m.from_

            bi.hot_sites = bi.warm_sites - _miss_sites(t, sib)
            sliding_sites = bi.warm_sites - bi.hot_sites
            for l in list(sliding_from):
                if l not in sliding_sites:
                    del sliding_from[l]

            next_plB = self._lam_over_miss(sliding_sites, sliding_from)
            bi.partial_lambda_at_A = partial_lambda - next_plB
            partial_lambda = next_plB
            g.branch_infos.append(bi)

            if parent != t.root:
                cur = parent
                parent = int(t.parent[cur])
            else:
                if not self.can_change_root:
                    bi.hot_sites = set(bi.warm_sites)
                    bi.partial_lambda_at_A += partial_lambda
                else:
                    if sliding_sites:
                        fo = BranchInfo(A=NO_NODE, B=t.root, is_open=True,
                                        T_to_X=t_X - float(t.t[parent]))
                        fo.warm_sites = set(sliding_sites)
                        fo.hot_sites = fo.warm_sites
                        fo.partial_lambda_at_A = partial_lambda
                        g.branch_infos.append(fo)
                sliding_sites = set()
                sliding_from = {}

        # distribute hot mutations along the hot path
        nbi = len(g.branch_infos)
        for i in range(nbi):
            bi = g.branch_infos[i]
            if bi.B == t.root:
                continue
            for m in reversed(t.mutations[bi.B]):
                if m.site in bi.warm_sites:
                    found = False
                    for j in range(i, nbi):
                        if m.site in g.branch_infos[j].hot_sites:
                            g.branch_infos[j].hot_muts_to_X.append(m)
                            found = True
                    assert found, f"warm mutation at site {m.site} has no hot home"

        for bi in g.branch_infos:
            bi.hot_muts_to_X.reverse()
            bi.partial_lambda_at_X = bi.partial_lambda_at_A
            for m in bi.hot_muts_to_X:
                if not bi.is_open:
                    sd.push_back(bi.hot_deltas_to_X, m.site, m.from_, m.to)
                bi.partial_lambda_at_X += (self.mu * self.nu[m.site] *
                                           (self._qa(m.site, m.to)
                                            - self._qa(m.site, m.from_)))
        return g

    # -- proposal of new graft mutations (spr_move.cpp:207-245, 742-797) --

    def _propose_new_graft_mutations(self, g: Graft, rng: np.random.Generator):
        t = self.tree
        X = g.X
        mu_prop = self.mu_proposal if self.mu_proposal is not None else self.mu_jc()
        L = t.num_sites
        for idx, bi in enumerate(g.branch_infos):
            assert not bi.is_open or not bi.hot_deltas_to_X
            if not bi.hot_sites:
                bi.hot_muts_to_X = []
                continue
            if bi.is_open:
                new_muts = sample_unconstrained_mutational_history(
                    rng, L, bi.T_to_X, mu_prop)
            else:
                new_muts = sample_mutational_history(
                    rng, L, bi.T_to_X, mu_prop, bi.hot_deltas_to_X)
            if new_muts:
                new_muts = [m for m in new_muts if m.site in bi.hot_sites]
                if not g.rooty and bi.B == X:
                    # hot sites at the P->X level may include sites actually
                    # missing at X via far-upstream missations (spr_move.cpp:760)
                    new_muts = [m for m in new_muts
                                if m.site in bi.hot_deltas_to_X
                                or not self._is_site_missing_at(X, m.site)]
                if g.rooty and idx == K_BRANCH_INFO_P_S:
                    end_loc = (g.S, float(t.t[g.S]))
                else:
                    end_loc = (X, float(t.t[X]))
                adjust_mutational_history(new_muts, bi.hot_deltas_to_X, t, end_loc)
            bi.hot_muts_to_X = new_muts
            if bi.is_open:
                bi.partial_lambda_at_A = bi.partial_lambda_at_X
                for m in reversed(bi.hot_muts_to_X):
                    bi.partial_lambda_at_A += (self.mu * self.nu[m.site] *
                                               (self._qa(m.site, m.from_)
                                                - self._qa(m.site, m.to)))

    def _is_site_missing_at(self, node: int, site: int) -> bool:
        cur = node
        t = self.tree
        while cur != NO_NODE:
            for (s, e) in t.miss_intervals[cur]:
                if s <= site < e:
                    return True
            cur = int(t.parent[cur])
        return False

    # -- finish: delta_log_G + log_alpha_mut (spr_move.cpp:246-316, 799-866) --

    def _finish_graft_analysis(self, g: Graft):
        t = self.tree
        X = g.X
        t_X = float(t.t[X])
        mu_prop = self.mu_proposal if self.mu_proposal is not None else self.mu_jc()
        g.delta_log_G = 0.0
        if g.rooty:
            P = int(t.parent[X])
            S = _sibling(t, P, X)
            t_P, t_S = float(t.t[P]), float(t.t[S])
            px, ps, spx = g.branch_infos
            g.delta_log_G += self.branch_log_G(t_P, t_X, px.partial_lambda_at_X,
                                               px.hot_muts_to_X)
            g.delta_log_G += self.branch_log_G(t_P, t_S, ps.partial_lambda_at_X,
                                               ps.hot_muts_to_X)
            spx_ps = []
            for m in reversed(spx.hot_muts_to_X):
                if m.t < t_P:
                    spx_ps.append(Mutation(site=m.site, from_=m.to, to=m.from_,
                                           t=t_P + (t_P - m.t)))
            spx_px = [m for m in spx.hot_muts_to_X if m.t >= t_P]
            g.delta_log_G += self.branch_log_G(t_P, t_X, spx.partial_lambda_at_X, spx_px)
            g.delta_log_G += self.branch_log_G(t_P, t_S, spx.partial_lambda_at_A, spx_ps)
            for m in px.hot_muts_to_X:
                g.delta_log_G += math.log(self.pi[m.from_] / self.pi[m.to])
            for m in ps.hot_muts_to_X:
                g.delta_log_G += math.log(self.pi[m.from_] / self.pi[m.to])
            for m in spx_ps:
                g.delta_log_G += math.log(self.pi[m.from_] / self.pi[m.to])
        else:
            for bi in g.branch_infos:
                g.delta_log_G += self.branch_log_G(
                    t_X - bi.T_to_X, t_X, bi.partial_lambda_at_X, bi.hot_muts_to_X)
            if g.branch_infos[-1].is_open:
                for m in g.branch_infos[-1].hot_muts_to_X:
                    g.delta_log_G += math.log(self.pi[m.from_] / self.pi[m.to])

        g.log_alpha_mut = 0.0
        for bi in g.branch_infos:
            Lh = len(bi.hot_sites)
            if not g.rooty and bi.B == X:
                Lh = ((t.num_sites - self.num_missing_at(X))
                      - (len(bi.warm_sites) - len(bi.hot_sites)))
            T = bi.T_to_X
            M = len(bi.hot_muts_to_X)
            g.log_alpha_mut += -mu_prop * Lh * T + M * math.log(mu_prop / 3.0)
            if not bi.is_open:
                d = len(bi.hot_deltas_to_X)
                P_AC = -0.25 * math.expm1(-4.0 / 3.0 * mu_prop * T)
                g.log_alpha_mut -= ((Lh - d) * math.log1p(-3.0 * P_AC)
                                    + d * math.log(P_AC))

    # ---- peel / apply ------------------------------------------------------

    def peel_graft(self, g: Graft):
        if g.rooty:
            self._peel_rooty(g)
        else:
            self._peel_inner(g)

    def apply_graft(self, g: Graft):
        if g.rooty:
            self._apply_rooty(g)
        else:
            self._apply_inner(g)

    def _root_deltas(self) -> dict:
        out = {}
        for m in self.tree.mutations[self.tree.root]:
            sd.push_back(out, m.site, m.from_, m.to)
        return out

    def _set_root_deltas(self, deltas: dict):
        t = self.tree
        t.mutations[t.root] = [
            Mutation(site=l, from_=f, to=to, t=ROOT_DELTA_T)
            for l, (f, to) in sorted(deltas.items())]

    def _peel_rooty(self, g: Graft):
        """spr_move.cpp:317-434."""
        t = self.tree
        X = g.X
        P = int(t.parent[X])
        S = _sibling(t, P, X)
        t_X, t_P = float(t.t[X]), float(t.t[P])
        px, ps, spx = g.branch_infos

        ref_to_root = self._root_deltas()

        for m in t.mutations[X]:
            if m.site in px.hot_sites:
                sd.push_back(ref_to_root, m.site, m.from_, m.to)
                _set_from_state(t, S, m.site, m.to)
        for m in t.mutations[S]:
            if m.site in ps.hot_sites:
                sd.push_back(ref_to_root, m.site, m.from_, m.to)
                _set_from_state(t, X, m.site, m.to)
        for m in t.mutations[S]:
            if m.site in spx.hot_sites:
                sd.push_back(ref_to_root, m.site, m.from_, m.to)
        t.mutations[X] = []
        t.mutations[S] = []

        t_mid = 0.5 * (t_P + t_X)
        for l, (f, to) in sorted(spx.hot_deltas_to_X.items()):
            t.mutations[X].append(Mutation(site=l, from_=f, to=to, t=t_mid))
        self._set_root_deltas(ref_to_root)

    def _apply_rooty(self, g: Graft):
        """spr_move.cpp:436-521."""
        t = self.tree
        X = g.X
        P = int(t.parent[X])
        S = _sibling(t, P, X)
        t_X, t_P, t_S = float(t.t[X]), float(t.t[P]), float(t.t[S])
        px, ps, spx = g.branch_infos

        assert not t.mutations[S]
        t.mutations[X] = []
        ref_to_root = self._root_deltas()

        for m in reversed(px.hot_muts_to_X):
            t.mutations[X].append(m)
            sd.push_back(ref_to_root, m.site, m.to, m.from_)
            _set_from_state(t, S, m.site, m.from_)
        for m in reversed(ps.hot_muts_to_X):
            t.mutations[S].append(m)
            sd.push_back(ref_to_root, m.site, m.to, m.from_)
            _set_from_state(t, X, m.site, m.from_)
        for m in spx.hot_muts_to_X:
            if m.t > t_P:
                t.mutations[X].append(m)
            else:
                t.mutations[S].append(Mutation(site=m.site, from_=m.to, to=m.from_,
                                               t=t_P + (t_P - m.t)))
                sd.push_back(ref_to_root, m.site, m.from_, m.to)

        t.mutations[X].sort(key=lambda m: (m.t, m.site))
        t.mutations[S].sort(key=lambda m: (m.t, m.site))
        _clamp_times(t.mutations[X], t_P, t_X)
        _clamp_times(t.mutations[S], t_P, t_S)
        self._set_root_deltas(ref_to_root)

    def _peel_inner(self, g: Graft):
        """spr_move.cpp:868-975."""
        t = self.tree
        X = g.X
        P = int(t.parent[X])
        t_X, t_P = float(t.t[X]), float(t.t[P])
        final = g.branch_infos[-1]

        ref_to_root = self._root_deltas() if final.is_open else {}

        for bi in g.branch_infos:
            if bi.B == t.root:
                continue
            if bi.B == X and not final.is_open:
                t.mutations[X] = []
                continue
            keep = []
            for m in reversed(t.mutations[bi.B]):
                if (m.site in bi.warm_sites
                        and not (final.is_open and m.site in final.hot_sites)):
                    # slide downstream to the P-X branch, adjusting the
                    # from_state of every sibling missation along the way
                    cur = X
                    while cur != bi.B:
                        parent = int(t.parent[cur])
                        sib = _sibling(t, parent, cur)
                        _set_from_state(t, sib, m.site, m.from_)
                        cur = parent
                else:
                    keep.append(m)
            keep.reverse()
            t.mutations[bi.B] = keep

        if final.is_open:
            for bi in reversed(g.branch_infos):
                if bi.B == t.root:
                    continue
                keep = []
                for m in t.mutations[bi.B]:
                    if m.site in final.hot_sites:
                        # slide upstream past the root
                        cur = bi.B
                        while cur != t.root:
                            parent = int(t.parent[cur])
                            sib = _sibling(t, parent, cur)
                            _set_from_state(t, sib, m.site, m.to)
                            cur = parent
                        sd.push_back(ref_to_root, m.site, m.from_, m.to)
                    else:
                        keep.append(m)
                t.mutations[bi.B] = keep

        t_mid = 0.5 * (t_P + t_X)
        for bi in g.branch_infos:
            if bi.B == t.root:
                continue
            for l, (f, to) in sorted(bi.hot_deltas_to_X.items()):
                t.mutations[X].append(Mutation(site=l, from_=f, to=to, t=t_mid))
        t.mutations[X].sort(key=lambda m: (m.t, m.site))

        if final.is_open:
            self._set_root_deltas(ref_to_root)

    def _apply_inner(self, g: Graft):
        """spr_move.cpp:977-1070."""
        t = self.tree
        X = g.X
        final = g.branch_infos[-1]
        t.mutations[X] = []

        ref_to_root = self._root_deltas() if final.is_open else {}

        for bi in g.branch_infos:
            if bi.B == X:
                t.mutations[X] = list(bi.hot_muts_to_X)
            elif not bi.is_open:
                for m in bi.hot_muts_to_X:
                    cur = X
                    while cur != bi.A:
                        parent = int(t.parent[cur])
                        if float(t.t[parent]) <= m.t < float(t.t[cur]):
                            t.mutations[cur].append(m)
                            break
                        sib = _sibling(t, parent, cur)
                        _set_from_state(t, sib, m.site, m.to)
                        cur = parent
            else:
                for m in reversed(bi.hot_muts_to_X):
                    cur = X
                    while cur != t.root:
                        parent = int(t.parent[cur])
                        if float(t.t[parent]) <= m.t < float(t.t[cur]):
                            t.mutations[cur].append(m)
                        if float(t.t[parent]) <= m.t:
                            sib = _sibling(t, parent, cur)
                            _set_from_state(t, sib, m.site, m.from_)
                        cur = parent
                    sd.push_back(ref_to_root, m.site, m.to, m.from_)

        for bi in g.branch_infos:
            if not bi.is_open and bi.B != t.root:
                t_A, t_B = float(t.t[bi.A]), float(t.t[bi.B])
                t.mutations[bi.B].sort(key=lambda m: (m.t, m.site))
                _clamp_times(t.mutations[bi.B], t_A, t_B)

        if final.is_open:
            self._set_root_deltas(ref_to_root)

    # ---- the prune-regraft move (direct re-implementation of
    #      Spr_move::move, spr_move.cpp:1101-1160 + tree_editing.cpp) --------

    def move(self, X: int, SS: int, new_t_P: float):
        t = self.tree
        assert X != t.root
        P = int(t.parent[X])
        S = _sibling(t, P, X)
        if SS == P:
            SS = S

        # 1. strip X's branch mutations into the running nexus->X deltas
        #    (Tree_editing_session ctor, tree_editing.cpp:22-29)
        deltas_nexus_to_X: dict = {}
        for m in t.mutations[X]:
            sd.push_back(deltas_nexus_to_X, m.site, m.from_, m.to)
        t.mutations[X] = []
        old_t_P = float(t.t[P])

        # 2. detach: merge branches G->P and P->S into G->S.
        #
        # Missation bookkeeping (the edit-session equivalent is hop_up's
        # push-down + factoring, tree_editing.cpp:180-190): the floating X
        # inherits every missation at or above its old position (those sites
        # are missing below every ancestor, hence below X), with unchanged
        # from_states (the path is mutation-free at such sites after peeling).
        miss_X = _miss_sites(t, X)
        cur = P
        while cur != NO_NODE:
            for l in _miss_sites(t, cur):
                if l not in miss_X:
                    miss_X.add(l)
                    _set_from_state(t, X, l, _get_from_state(t, cur, l))
            cur = int(t.parent[cur])
        t.miss_intervals[X] = _sites_to_intervals(miss_X)

        G = int(t.parent[P])
        if G != NO_NODE:
            gc = list(t.children[G])
            gc[gc.index(P)] = S
            t.children[G] = gc
            t.parent[S] = G
            t.mutations[S] = t.mutations[P] + t.mutations[S]
            t.mutations[P] = []
        else:
            # P was the root: S becomes the root, carrying the root deltas
            t.parent[S] = NO_NODE
            t.mutations[S] = t.mutations[P] + t.mutations[S]
            t.mutations[P] = []
            t.root = S
        # merge missations onto the merged branch (disjoint site sets)
        t.miss_intervals[S] = _sites_to_intervals(
            _miss_sites(t, P) | _miss_sites(t, S))
        t.miss_from_states[S].update(t.miss_from_states[P])
        t.miss_intervals[P] = []
        t.miss_from_states[P] = {}
        t.parent[P] = NO_NODE
        t.children[P] = (NO_NODE, NO_NODE)  # temporarily detached

        # normalization cascade: factor missations common to both children up
        # through the old junction's ancestors (cf. hop_up step 3,
        # tree_editing.cpp:194-198; the affected sites were warm, so the
        # branches are mutation-free there after peeling)
        cur = G if G != NO_NODE else NO_NODE
        while cur != NO_NODE:
            c0, c1 = int(t.children[cur][0]), int(t.children[cur][1])
            m0, m1 = _miss_sites(t, c0), _miss_sites(t, c1)
            common = m0 & m1
            if not common:
                break
            for l in common:
                fs = _get_from_state(t, c0, l)
                _set_from_state(t, cur, l, fs)
                t.miss_from_states[c0].pop(l, None)
                t.miss_from_states[c1].pop(l, None)
            t.miss_intervals[c0] = _sites_to_intervals(m0 - common)
            t.miss_intervals[c1] = _sites_to_intervals(m1 - common)
            t.miss_intervals[cur] = _sites_to_intervals(
                _miss_sites(t, cur) | common)
            cur = int(t.parent[cur])

        # 3. on the PRUNED tree, recompose the nexus deltas:
        #    D(new_nexus -> X) = D(new_nexus -> old_nexus) o D(old_nexus -> X).
        #    Crossings at sites missing at X go into miss(X)'s from_states
        #    instead (cf. slide_P_along_branch's missation bookkeeping,
        #    tree_editing.cpp:72-77, 99-104).
        old_loc = (S, old_t_P)
        new_loc = (SS, new_t_P)
        d_new_to_old = sd.deltas_between(t, new_loc, old_loc)
        miss_X = _miss_sites(t, X)
        for l in list(d_new_to_old):
            if l in miss_X:
                f_new, f_old = d_new_to_old.pop(l)
                assert _get_from_state(t, X, l) == f_old, \
                    f"missation from-state chain broken at site {l}"
                _set_from_state(t, X, l, f_new)
        new_deltas = sd.compose(d_new_to_old, deltas_nexus_to_X)

        # 4. attach: split branch GG->SS at new_t_P
        GG = int(t.parent[SS])

        miss_X = _miss_sites(t, X)

        # Un-factor missations above the attach point that X's data
        # invalidates: a site l missing below ancestor W but present at X can
        # no longer be recorded at W once X hangs below it — it descends to
        # every off-path sibling along W..GG plus SS (inverse of the
        # normalization cascade; from_states transfer unchanged because
        # branches below W are mutation-free at l).
        path_up = [SS]  # SS, GG, ..., root
        cur = GG
        while cur != NO_NODE:
            path_up.append(cur)
            cur = int(t.parent[cur])
        for wi in range(1, len(path_up)):
            W = path_up[wi]
            mw = _miss_sites(t, W)
            need = mw - miss_X
            if not need:
                continue
            for l in need:
                fs = _get_from_state(t, W, l)
                t.miss_from_states[W].pop(l, None)
                # the off-path sibling at each junction from W down to GG
                # gains the missation, and so does SS itself
                for di in range(wi, 0, -1):
                    d = path_up[di]
                    on_path = path_up[di - 1]
                    other = _sibling(t, d, on_path)
                    t.miss_intervals[other] = _sites_to_intervals(
                        _miss_sites(t, other) | {l})
                    _set_from_state(t, other, l, fs)
                t.miss_intervals[SS] = _sites_to_intervals(
                    _miss_sites(t, SS) | {l})
                _set_from_state(t, SS, l, fs)
            t.miss_intervals[W] = _sites_to_intervals(mw - need)

        # drop miss(X) entries already covered by missations above the new
        # position (nested missations are forbidden; the covering entry
        # already accounts for X's subtree)
        covered = set()
        cur = GG
        while cur != NO_NODE:
            covered |= _miss_sites(t, cur)
            cur = int(t.parent[cur])
        if covered & miss_X:
            for l in covered & miss_X:
                t.miss_from_states[X].pop(l, None)
            t.miss_intervals[X] = _sites_to_intervals(miss_X - covered)
            miss_X -= covered

        t.children[P] = (min(X, SS), max(X, SS))
        t.parent[X] = P
        t.parent[SS] = P
        t.t[P] = new_t_P
        if GG != NO_NODE:
            gc = list(t.children[GG])
            gc[gc.index(SS)] = P
            t.children[GG] = gc
            t.parent[P] = GG
            upper = [m for m in t.mutations[SS] if m.t <= new_t_P]
            lower = [m for m in t.mutations[SS] if m.t > new_t_P]
            t.mutations[P] = upper
            t.mutations[SS] = lower
        else:
            # attaching above the old root: P becomes the new root
            t.parent[P] = NO_NODE
            t.mutations[P] = t.mutations[SS]  # root deltas (t = -inf sentinel)
            t.mutations[SS] = []
            t.root = P

        # factor missations common to the new siblings up onto P's branch
        # (the split branch cannot carry mutations at these sites, so
        # from_states transfer unchanged)
        miss_SS = _miss_sites(t, SS)
        common = miss_X & miss_SS
        if common:
            for l in common:
                fs = _get_from_state(t, X, l)
                _set_from_state(t, P, l, fs)
                t.miss_from_states[X].pop(l, None)
                t.miss_from_states[SS].pop(l, None)
            t.miss_intervals[X] = _sites_to_intervals(miss_X - common)
            t.miss_intervals[SS] = _sites_to_intervals(miss_SS - common)
            t.miss_intervals[P] = _sites_to_intervals(
                _miss_sites(t, P) | common)

        # 5. synthesize mid-branch mutations (Tree_editing_session::end())
        t_X = float(t.t[X])
        t_mid = 0.5 * (new_t_P + t_X)
        t.mutations[X] = [Mutation(site=l, from_=f, to=to, t=t_mid)
                          for l, (f, to) in sorted(new_deltas.items())]


def _clamp_times(muts: list, t_lo: float, t_hi: float):
    """Clamp mutation times into (t_lo, t_hi] against roundoff
    (cf. clamp_mutation_times, mutations.h:55-60)."""
    span = t_hi - t_lo
    eps = 1e-12 * max(abs(t_lo), abs(t_hi), 1.0)
    lo = t_lo + min(eps, 0.5 * span)
    for m in muts:
        if m.t <= t_lo:
            m.t = lo
        elif m.t > t_hi:
            m.t = t_hi

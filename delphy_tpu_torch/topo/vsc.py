"""Very-scalable (partition-decoupled) coalescent prior — host version.

Reference: core/very_scalable_coalescent.{h,cpp}.  The quadratic coupling
k_bar(k_bar-1) across partitions is broken by auxiliary Gaussian per-part
fields k_twiddle_bar_p (mean k_bar_p - k_bar/A, variance N_bar/(A*dt)),
sampled at repartition time; each part's partial log prior then depends only
on its own k_bar_p plus the frozen k_twiddle totals, so parts' node-time
displacements are independent (cpp:85-232, 356-465).

Cells are indexed GROWING INTO THE PAST from t_ref = latest time
(cell_for(t) = floor((t_ref - t)/dt), cpp:14-24)."""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..phylo import FlatTree, NO_NODE


def cell_for(t, t_ref, t_step):
    return int(math.floor((t_ref - t) / t_step))


def add_interval(t_start, t_end, delta_k, k: list, t_ref, t_step):
    """Accumulate delta_k over [t_start, t_end] into the (past-growing)
    staircase (cpp:37-84)."""
    if t_start < t_end:
        t_start, t_end = t_end, t_start
    # now t_start >= t_end; cell indices grow as time decreases
    cs = cell_for(t_start, t_ref, t_step)
    ce = len(k) - 1
    lb_last = t_ref - t_step * (ce + 1)
    if t_end != lb_last:
        ce = cell_for(t_end, t_ref, t_step)
    if cs == ce:
        k[cs] += delta_k * (t_start - t_end) / t_step
        return
    # partial first cell (closest to present)
    lb_cs = t_ref - t_step * (cs + 1)
    k[cs] += delta_k * (t_start - lb_cs) / t_step
    ub_ce = t_ref - t_step * ce
    k[ce] += delta_k * (ub_ce - t_end) / t_step
    for c in range(cs + 1, ce):
        k[c] += delta_k


@dataclass
class VscPart:
    """One partition's augmented coalescent prior part."""
    pop: object                  # host pop adapter (pop_at / pop_integral)
    includes_tree_root: bool
    t_ref: float
    t_step: float
    k_bar_p: list
    k_twiddle_bar_p: list
    k_twiddle_bar: list
    popsize_bar: list
    num_active_parts: list
    rng: np.random.Generator = field(default_factory=np.random.default_rng)

    def _ensure_space(self, t):
        if not self.includes_tree_root:
            return
        max_cell = cell_for(t, self.t_ref, self.t_step)
        for i in range(len(self.popsize_bar), max_cell + 1):
            lb = self.t_ref - self.t_step * (i + 1)
            ub = self.t_ref - self.t_step * i
            self.popsize_bar.append(
                max(self.pop.pop_integral(lb, ub) / self.t_step, 1e-100))
            self.num_active_parts.append(1)
        for i in range(len(self.k_bar_p), max_cell + 1):
            sigma = math.sqrt(self.popsize_bar[i] / self.t_step)
            kt = self.rng.normal(0.0, sigma)
            self.k_bar_p.append(1.0)
            self.k_twiddle_bar_p.append(kt)
            self.k_twiddle_bar.append(kt)

    def coalescence_displaced(self, old_t, new_t):
        self._ensure_space(new_t)
        sign = -1.0 if old_t <= new_t else +1.0
        add_interval(old_t, new_t, sign, self.k_bar_p, self.t_ref, self.t_step)

    def calc_delta_partial_log_prior_after_displace_coalescence(self, old_t, new_t):
        if old_t <= new_t:
            d = self._delta_on_add_interval(old_t, new_t, -1.0)
        else:
            d = self._delta_on_add_interval(new_t, old_t, +1.0)
        d -= math.log(self.pop.pop_at(new_t) / self.pop.pop_at(old_t))
        return d

    def calc_partial_log_prior(self, subtree: FlatTree) -> float:
        """cpp:356-390 (with the subtree's inner-node logN terms)."""
        out = 0.0
        for i in range(len(self.k_bar_p)):
            out -= self.t_step / self.popsize_bar[i] * (
                0.5 * self.k_bar_p[i] ** 2 * self.num_active_parts[i]
                - (self.k_twiddle_bar_p[i] * self.num_active_parts[i]
                   - self.k_twiddle_bar[i] + 0.5) * self.k_bar_p[i])
        for n in range(subtree.num_nodes):
            if not subtree.is_tip(n):
                out -= math.log(self.pop.pop_at(float(subtree.t[n])))
        return out

    def _delta_on_add_interval(self, min_t, max_t, delta_k):
        self._ensure_space(min_t)
        if min_t == max_t:
            return 0.0
        cs = cell_for(max_t, self.t_ref, self.t_step)
        ce = cell_for(min_t, self.t_ref, self.t_step)
        out = 0.0

        def cell_term(i, dk):
            old = self.k_bar_p[i]
            new = old + dk
            return -(self.t_step / self.popsize_bar[i]) * (
                0.5 * (new * new - old * old) * self.num_active_parts[i]
                - (self.k_twiddle_bar_p[i] * self.num_active_parts[i]
                   - self.k_twiddle_bar[i] + 0.5) * (new - old))

        if cs == ce:
            return cell_term(cs, delta_k * (max_t - min_t) / self.t_step)
        lb_cs = self.t_ref - self.t_step * (cs + 1)
        out += cell_term(cs, delta_k * (max_t - lb_cs) / self.t_step)
        ub_ce = self.t_ref - self.t_step * ce
        out += cell_term(ce, delta_k * (ub_ce - min_t) / self.t_step)
        for c in range(cs + 1, ce):
            out += cell_term(c, delta_k)
        return out

    # -- adapter API used by the topology mixer -----------------------------

    def displace_delta(self, old_t, new_t, is_tip=False):
        assert not is_tip  # topology moves only displace inner nodes
        d = self.calc_delta_partial_log_prior_after_displace_coalescence(old_t, new_t)
        return d, (old_t, new_t)

    def commit(self, token):
        old_t, new_t = token
        self.coalescence_displaced(old_t, new_t)


def make_vsc_parts(parts, pop, rngs, t_step, k_twiddle_at_mean=False):
    """Build per-part augmented priors (cpp:85-232).

    parts: list of PartitionPart; rngs: per-part Generators;
    k_twiddle_at_mean: deterministic auxiliaries (test mode — with one part
    this reproduces the plain scalable prior exactly)."""
    infos = []
    for p in parts:
        st = p.tree
        tmins, tmaxs = [], []
        for n in range(st.num_nodes):
            if st.is_tip(n):
                tmins.append(float(st.t_min[n]))
                tmaxs.append(float(st.t_max[n]))
            else:
                tmins.append(float(st.t[n]))
                tmaxs.append(float(st.t[n]))
        infos.append({"part": p, "t_min": min(tmins), "t_max": max(tmaxs)})

    root_info = next(i for i in infos if i["part"].includes_root)
    all_t_min = min(i["t_min"] for i in infos)
    all_t_max = max(i["t_max"] for i in infos)
    root_info["t_min"] = all_t_min
    t_ref = all_t_max
    num_cells = cell_for(all_t_min, t_ref, t_step) + 1

    num_active = [0] * num_cells
    for info in infos:
        fc = cell_for(info["t_max"], t_ref, t_step)
        lc = cell_for(info["t_min"], t_ref, t_step)
        for c in range(fc, lc + 1):
            num_active[c] += 1
        info["first_cell"], info["last_cell"] = fc, lc
        info["k_bar_p"] = [0.0] * (lc + 1)

    for info in infos:
        st = info["part"].tree
        for n in range(st.num_nodes):
            if n != st.root:
                add_interval(float(st.t[int(st.parent[n])]), float(st.t[n]),
                             +1.0, info["k_bar_p"], t_ref, t_step)
    # root lineage extends to the earliest tracked time
    rp = root_info["part"].tree
    add_interval(t_ref - t_step * num_cells, float(rp.t[rp.root]), +1.0,
                 root_info["k_bar_p"], t_ref, t_step)

    k_bar = [0.0] * num_cells
    for info in infos:
        for i, v in enumerate(info["k_bar_p"]):
            k_bar[i] += v

    popsize_bar = []
    for i in range(num_cells):
        lb = t_ref - t_step * (i + 1)
        ub = t_ref - t_step * i
        popsize_bar.append(max(pop.pop_integral(lb, ub) / t_step, 1e-100))

    for pi, info in enumerate(infos):
        ktp = [0.0] * len(info["k_bar_p"])
        for i in range(len(ktp)):
            if info["first_cell"] <= i <= info["last_cell"]:
                A = num_active[i]
                mu = info["k_bar_p"][i] - k_bar[i] / A
                sigma = math.sqrt(popsize_bar[i] / (A * t_step))
                ktp[i] = mu if k_twiddle_at_mean else float(
                    rngs[pi].normal(mu, sigma))
        info["k_twiddle_bar_p"] = ktp

    k_twiddle_bar = [0.0] * num_cells
    for info in infos:
        for i, v in enumerate(info["k_twiddle_bar_p"]):
            k_twiddle_bar[i] += v

    out = []
    for pi, info in enumerate(infos):
        out.append(VscPart(
            pop=pop, includes_tree_root=info["part"].includes_root,
            t_ref=t_ref, t_step=t_step,
            k_bar_p=info["k_bar_p"],
            k_twiddle_bar_p=info["k_twiddle_bar_p"],
            k_twiddle_bar=list(k_twiddle_bar),
            popsize_bar=list(popsize_bar),
            num_active_parts=list(num_active),
            rng=rngs[pi]))
    return out

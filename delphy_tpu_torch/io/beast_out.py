"""BEAST-compatible .log (TSV) and .trees (NEXUS/Newick) writers.

Reference semantics: core/beasty_output.{h,cpp} (BEAST2 2.6.2 column set,
beasty_output.cpp:73-220): time measured backwards from the latest tip in
linear years, clock rate in substitutions/site/year, coalescent prior shifted
by num_inner*log(365) for the day->year unit change."""

from __future__ import annotations

import math

import numpy as np

from ..phylo import FlatTree
from ..dates import to_linear_year


def delta_linear_years(t: float, t0: float) -> float:
    return to_linear_year(t0) - to_linear_year(t)


def growth_rate(pop, t: float) -> float:
    """The growthRate column [1/day]: g of the exponential model; for a
    skygrid, the slope of log N at ``t`` (0 on a staircase; the reference
    package's writer reads a ``g`` that a skygrid does not have)."""
    if not hasattr(pop, "gamma"):
        return float(pop.g)
    x, g = np.asarray(pop.x), np.asarray(pop.gamma)
    k = int(np.searchsorted(x, t, side="left"))
    if int(pop.type) == 1 or k == 0 or k >= len(x):
        return 0.0
    return float((g[k] - g[k - 1]) / (x[k] - x[k - 1]))


class BeastLogOutput:
    """BEAST2-style .log TSV (beasty_output.cpp:73-220)."""

    def __init__(self, fh, mu_move_enabled=True, alpha_move_enabled=False,
                 pop_size_move_enabled=True, pop_growth_rate_move_enabled=True):
        self.fh = fh
        self.mu_move_enabled = mu_move_enabled
        self.alpha_move_enabled = alpha_move_enabled
        self.pop_size_move_enabled = pop_size_move_enabled
        self.pop_growth_rate_move_enabled = pop_growth_rate_move_enabled

    def write_headers(self, tree: FlatTree):
        cols = ["Sample", "posterior", "likelihood_really_logG", "prior_for_Delphy",
                "treeLikelihood_really_logG", "TreeHeight"]
        if self.mu_move_enabled:
            cols.append("clockRate")
        if self.alpha_move_enabled:
            cols.append("gammaShape")
        cols.append("kappa")
        cols.append("Coalescent")
        if self.pop_size_move_enabled:
            cols.append("ePopSize")
        if self.pop_growth_rate_move_enabled:
            cols.append("growthRate")
        cols += ["freqParameter.1", "freqParameter.2", "freqParameter.3",
                 "freqParameter.4"]
        self.fh.write("\t".join(cols) + "\n")

    def write_line(self, run):
        """`run` is a delphy_tpu_torch.run.Run, read through its host
        view."""
        hv = run.host_view()
        tree_t = hv.t
        T = run.ts.num_tips
        beast_t0 = float(tree_t[:T].max())
        led = hv.ledger
        num_inner = run.ts.num_nodes - T
        log_prior = float(led.log_coal) + float(led.log_other)
        vals = [run.step,
                float(led.log_posterior),
                float(led.log_G),
                log_prior,
                float(led.log_G),
                delta_linear_years(float(tree_t[hv.root]), beast_t0)]
        if self.mu_move_enabled:
            vals.append(float(hv.evo.mu) * 365.0)
        if self.alpha_move_enabled:
            vals.append(float(hv.evo.alpha))
        vals.append(float(hv.evo.kappa))
        vals.append(float(led.log_coal) + num_inner * math.log(365.0))
        if self.pop_size_move_enabled:
            from .. import pop as popm
            vals.append(float(popm.host_eval(popm.pop_at_time, hv.pop,
                                             beast_t0)) / 365.0)
        if self.pop_growth_rate_move_enabled:
            vals.append(growth_rate(hv.pop, beast_t0) * 365.0)
        pi = hv.evo.pi
        vals += [float(p) for p in pi]
        self.fh.write("\t".join(_fmt(v) for v in vals) + "\n")
        self.fh.flush()


def _fmt(v):
    if isinstance(v, int):
        return str(v)
    return f"{v:.6g}"


def newick_string(tree: FlatTree, include_mutation_counts=False) -> str:
    """Newick with branch lengths in days (iterative, stack-based)."""
    out = []
    # post-order assembly without recursion
    stack = [(int(tree.root), False)]
    frag = {}
    while stack:
        n, done = stack.pop()
        if not done:
            stack.append((n, True))
            if not tree.is_tip(n):
                stack.append((int(tree.children[n, 1]), False))
                stack.append((int(tree.children[n, 0]), False))
        else:
            if tree.is_tip(n):
                label = str(n + 1)
            else:
                l, r = int(tree.children[n, 0]), int(tree.children[n, 1])
                label = f"({frag.pop(l)},{frag.pop(r)})"
            if n == tree.root:
                frag[n] = label
            else:
                blen = tree.t[n] - tree.t[int(tree.parent[n])]
                frag[n] = f"{label}:{blen:.8g}"
    out.append(frag[int(tree.root)])
    return "".join(out) + ";"


class BeastTreesOutput:
    """NEXUS .trees writer (beasty_output.cpp trees sections)."""

    def __init__(self, fh):
        self.fh = fh

    def write_preamble(self, tree: FlatTree):
        self.fh.write("#NEXUS\n\nBegin taxa;\n")
        T = tree.num_tips
        self.fh.write(f"\tDimensions ntax={T};\n\t\tTaxlabels\n")
        for i in range(T):
            self.fh.write(f"\t\t\t{_nexus_name(tree.name[i])}\n")
        self.fh.write("\t\t\t;\nEnd;\nBegin trees;\n\tTranslate\n")
        for i in range(T):
            sep = "," if i < T - 1 else ""
            self.fh.write(f"\t\t\t{i + 1} {_nexus_name(tree.name[i])}{sep}\n")
        self.fh.write(";\n")

    def write_tree(self, tree: FlatTree, step: int):
        self.fh.write(f"tree STATE_{step} = {newick_string(tree)}\n")
        self.fh.flush()

    def write_epilog(self):
        self.fh.write("End;\n")
        self.fh.flush()


def _nexus_name(name: str) -> str:
    if any(c in name for c in " ()[]{}/\\,;:=*'\"`<>"):
        return "'" + name.replace("'", "''") + "'"
    return name

"""Newick / NEXUS .trees parsing.

Reference: core/newick.{h,cpp} (hand-written lexer + recursive-descent parser
with NEXUS-style [&...] attribute maps) and core/beasty_input.cpp
read_beasty_trees.  Here: an iterative tokenizer/parser producing FlatTree
topologies (binary trees required for the engine; attributes preserved)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..phylo import FlatTree, NO_NODE


@dataclass
class NewickNode:
    name: str = ""
    length: float = 0.0
    attributes: dict = field(default_factory=dict)
    children: list = field(default_factory=list)


def _tokenize(s: str):
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c.isspace():
            i += 1
        elif c in "(),:;":
            yield c, c
            i += 1
        elif c == "[":
            j = s.index("]", i)
            yield "comment", s[i + 1:j]
            i = j + 1
        elif c == "'":
            j = i + 1
            out = []
            while j < n:
                if s[j] == "'":
                    if j + 1 < n and s[j + 1] == "'":
                        out.append("'")
                        j += 2
                        continue
                    break
                out.append(s[j])
                j += 1
            yield "label", "".join(out)
            i = j + 1
        else:
            j = i
            while j < n and s[j] not in "(),:;[] \t\n\r":
                j += 1
            yield "label", s[i:j]
            i = j


def _parse_attrs(comment: str) -> dict:
    """Parse a NEXUS [&key=value,...] annotation (newick.h attribute maps)."""
    out = {}
    if not comment.startswith("&"):
        return out
    body = comment[1:]
    depth = 0
    cur = []
    parts = []
    for ch in body:
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            if ch in "{[":
                depth += 1
            elif ch in "}]":
                depth -= 1
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    for p in parts:
        if "=" in p:
            k, v = p.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def parse_newick(s: str) -> NewickNode:
    toks = list(_tokenize(s))
    pos = 0

    def peek():
        return toks[pos] if pos < len(toks) else (None, None)

    def parse_node():
        nonlocal pos
        node = NewickNode()
        kind, val = peek()
        if kind == "(":
            pos += 1
            node.children.append(parse_node())
            while peek()[0] == ",":
                pos += 1
                node.children.append(parse_node())
            assert peek()[0] == ")", "expected ')'"
            pos += 1
        while True:
            kind, val = peek()
            if kind == "label":
                node.name = val
                pos += 1
            elif kind == "comment":
                node.attributes.update(_parse_attrs(val))
                pos += 1
            elif kind == ":":
                pos += 1
                while peek()[0] == "comment":
                    node.attributes.update(_parse_attrs(peek()[1]))
                    pos += 1
                k2, v2 = peek()
                assert k2 == "label", "expected branch length"
                node.length = float(v2)
                pos += 1
            else:
                break
        return node

    root = parse_node()
    assert peek()[0] == ";", "expected ';'"
    return root


def newick_to_flat_tree(root: NewickNode, ref_seq: np.ndarray,
                        t_root: float = 0.0, name_map=None) -> FlatTree:
    """Binary Newick -> FlatTree with times from cumulative branch lengths.
    Tip names resolve through name_map (e.g. a NEXUS Translate table)."""
    tips, inners = [], []

    def count(n):
        if not n.children:
            tips.append(n)
        else:
            assert len(n.children) == 2, "engine trees are binary"
            inners.append(n)
            for c in n.children:
                count(c)
    count(root)
    T = len(tips)
    N = 2 * T - 1
    parent = np.full(N, NO_NODE, dtype=np.int32)
    children = np.full((N, 2), NO_NODE, dtype=np.int32)
    t = np.zeros(N)
    names = [""] * T

    tip_i = iter(range(T))
    inner_i = iter(range(T, N))
    idx_of = {}

    def assign(n):
        if not n.children:
            i = next(tip_i)
        else:
            i = next(inner_i)
        idx_of[id(n)] = i
        for c in n.children:
            assign(c)
    assign(root)

    def wire(n, t_parent):
        i = idx_of[id(n)]
        t[i] = t_parent + n.length
        if not n.children:
            names[i] = (name_map.get(n.name, n.name) if name_map else n.name)
        else:
            a, b = (idx_of[id(c)] for c in n.children)
            children[i] = (min(a, b), max(a, b))
            for c in n.children:
                parent[idx_of[id(c)]] = i
                wire(c, t[i])
    root_idx = idx_of[id(root)]
    t[root_idx] = t_root
    wire(root, t_root - root.length)
    t[root_idx] = t_root

    return FlatTree(
        parent=parent, children=children, t=t,
        t_min=np.where(np.arange(N) < T, t, -np.inf),
        t_max=np.where(np.arange(N) < T, t, np.inf),
        root=root_idx, ref_seq=np.asarray(ref_seq, dtype=np.int8),
        mutations=[[] for _ in range(N)],
        miss_intervals=[[] for _ in range(N)],
        miss_from_states=[{} for _ in range(N)],
        name=names)


def read_beast_trees(path, ref_seq: np.ndarray, warn=lambda m: None):
    """NEXUS .trees -> list of (state_label, FlatTree) (cf. read_beasty_trees,
    core/beasty_input.cpp)."""
    name_map = {}
    out = []
    in_translate = False
    with open(path) as f:
        for line in f:
            ls = line.strip()
            low = ls.lower()
            if low.startswith("translate"):
                in_translate = True
                continue
            if in_translate:
                if ls.startswith(";"):
                    in_translate = False
                    continue
                body = ls.rstrip(",").rstrip(";")
                if body:
                    parts = body.split(None, 1)
                    if len(parts) == 2:
                        name_map[parts[0]] = parts[1].strip().strip("'")
                if ls.endswith(";"):
                    in_translate = False
                continue
            if low.startswith("tree "):
                eq = ls.index("=")
                label = ls[5:eq].strip()
                nwk = ls[eq + 1:].strip()
                # strip rooting annotations like [&R]
                while nwk.startswith("["):
                    nwk = nwk[nwk.index("]") + 1:].lstrip()
                try:
                    root = parse_newick(nwk)
                    out.append((label, newick_to_flat_tree(root, ref_seq,
                                                           name_map=name_map)))
                except (AssertionError, ValueError) as e:
                    warn(f"tree {label!r}: parse failed ({e}); skipped")
    return out

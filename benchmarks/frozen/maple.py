"""MAPLE reader and tip-date parser, frozen for the benchmark.

A NumPy rewrite of the semantics of ``delphy_tpu_torch/io/maple.py`` with
the helpers of its ``seq.py`` and ``dates.py``, so that the benchmark reads
its inputs with code that later changes to the program cannot move.  Line 1
is ``>`` and the reference id, the reference sequence follows; then per tip
``>id`` (dates from the id's suffix) and entries, either ``<ambiguous char>
<1-based start> [len]`` (a missing interval) or ``<base> <1-based site>`` (a
difference from the reference).  Ambiguous reference letters become A and
their sites are blacklisted; any malformed entry drops its tip, as does a
tip without a date.  Deltas inside a tip's missing intervals are dropped.
"""

from __future__ import annotations

import datetime
import re
from dataclasses import dataclass

import numpy as np

_EPOCH = datetime.date(2020, 1, 1)
_RE_DATE = re.compile(r"^\d{4}-\d{2}-\d{2}$")
_RE_MONTH = re.compile(r"^\d{4}-\d{2}$")
_RE_YEAR = re.compile(r"^\d{4}$")

_AMBIG_CHARS = set("nrykswmbdhv-?.")
_REAL_CHARS = {"a": 0, "c": 1, "g": 2, "t": 3, "u": 3}

# uint8 char code -> A, C, G, T as 0-3; -1 for an ambiguous or unknown letter
_CODE_TO_REAL = np.full(256, -1, dtype=np.int8)
for _ch, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)):
    _CODE_TO_REAL[ord(_ch)] = _v
    _CODE_TO_REAL[ord(_ch.lower())] = _v


@dataclass
class Dataset:
    """Tips as the benchmark hands them to the program and the reference."""
    ref_seq: np.ndarray    # int8[L], A C G T as 0-3
    names: list            # tip ids
    dates: list            # per tip (t_min, t_max), days since 2020-01-01
    deltas: list           # per tip [(site, state)], differences from ref_seq
    miss: list             # per tip [(start, end)], sorted and disjoint

    @property
    def num_tips(self) -> int:
        return len(self.names)

    @property
    def num_sites(self) -> int:
        return len(self.ref_seq)


def _days(s: str) -> float:
    return float((datetime.date.fromisoformat(s) - _EPOCH).days)


def date_range(seq_id: str):
    """(t_min, t_max) from the id's suffix after '|' or '-': a range
    ``YYYY-MM-DD/YYYY-MM-DD``, a day, a month or a year; None without one."""
    n = len(seq_id)

    def sep_ok(i):
        return i == 0 or seq_id[i - 1] in "|-"

    if n >= 21 and sep_ok(n - 21):
        c = seq_id[n - 21:]
        if c[10] == "/" and _RE_DATE.match(c[:10]) and _RE_DATE.match(c[11:]):
            try:
                lo, hi = _days(c[:10]), _days(c[11:])
                if lo <= hi:
                    return lo, hi
            except ValueError:
                pass
    if n >= 10 and sep_ok(n - 10) and _RE_DATE.match(seq_id[n - 10:]):
        try:
            t = _days(seq_id[n - 10:])
            return t, t
        except ValueError:
            pass
    if n >= 7 and sep_ok(n - 7) and _RE_MONTH.match(seq_id[n - 7:]):
        y, m = int(seq_id[n - 7:n - 3]), int(seq_id[n - 2:])
        try:
            lo = datetime.date(y, m, 1)
            hi = datetime.date(y + (m == 12), m % 12 + 1, 1)
            return float((lo - _EPOCH).days), float((hi - _EPOCH).days)
        except ValueError:
            pass
    if n >= 4 and sep_ok(n - 4) and _RE_YEAR.match(seq_id[n - 4:]):
        y = int(seq_id[n - 4:])
        return (float((datetime.date(y, 1, 1) - _EPOCH).days),
                float((datetime.date(y + 1, 1, 1) - _EPOCH).days))
    return None


def _tip(tip_id, entries, L, ref_seq, blacklist):
    """(deltas, merged intervals) of one tip, or None if it is dropped."""
    deltas, ivs = [], []
    for e in entries:
        parts = e.split()
        ch = parts[0].lower()
        if len(ch) != 1 or len(parts) < 2:
            return None
        try:
            start = int(parts[1]) - 1
        except ValueError:
            return None
        if ch in _AMBIG_CHARS:
            length = 1
            if len(parts) >= 3:
                try:
                    length = int(parts[2])
                except ValueError:
                    return None
            if start < 0 or start + length > L or length < 1:
                return None
            ivs.append((start, start + length))
        elif ch in _REAL_CHARS:
            if len(parts) != 2 or start < 0 or start >= L or start in blacklist:
                return None
            to = _REAL_CHARS[ch]
            if to != ref_seq[start]:
                deltas.append((start, to))
        else:
            return None
    ivs.sort()
    merged = []
    for s, e in ivs:
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    missing = np.zeros(L, dtype=bool)
    for s, e in merged:
        missing[s:e] = True
    return [(l, to) for l, to in deltas if not missing[l]], merged


def read_maple(path) -> Dataset:
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    i = 0
    while i < len(lines) and not lines[i].startswith(">"):
        i += 1
    if i >= len(lines):
        raise ValueError("MAPLE file has no reference entry")
    i += 1
    chunks = []
    while i < len(lines) and not lines[i].startswith(">"):
        chunks.append(lines[i].strip())
        i += 1
    codes = np.frombuffer("".join(chunks).encode("ascii", "replace"),
                          dtype=np.uint8)
    real = _CODE_TO_REAL[codes]
    if len(real) == 0:
        raise ValueError("MAPLE reference sequence is empty")
    blacklist = set(np.nonzero(real < 0)[0].tolist())
    ref_seq = np.where(real < 0, 0, real).astype(np.int8)
    L = len(ref_seq)
    ds = Dataset(ref_seq=ref_seq, names=[], dates=[], deltas=[], miss=[])
    while i < len(lines):
        tip_id = lines[i][1:].strip()
        i += 1
        entries = []
        while i < len(lines) and not lines[i].startswith(">"):
            if lines[i].strip():
                entries.append(lines[i].strip())
            i += 1
        dr = date_range(tip_id)
        tip = None if dr is None else _tip(tip_id, entries, L, ref_seq,
                                           blacklist)
        if tip is None:
            continue
        ds.names.append(tip_id)
        ds.dates.append(dr)
        ds.deltas.append(tip[0])
        ds.miss.append(tip[1])
    return ds

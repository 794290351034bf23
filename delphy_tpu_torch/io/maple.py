"""MAPLE diff-format reader/writer (the preferred large-N input).

Reference semantics: core/io.cpp read_maple (lines 99-260; see SURVEY.md §A.1):
line 1 is '>' + reference id; reference sequence follows until the next '>'.
Ambiguous reference letters silently become 'A' and those sites are
blacklisted — a tip delta at a blacklisted site invalidates that tip.  Then per
tip: '>'+id (dates parsed from the id suffix), followed by entry lines, each
either `<ambig-char> <1-based-start> [len]` (a missing interval, len default 1)
or `<base> <1-based-site>` (a delta vs reference; spurious t->u/t->t dropped).
Any parse warning drops the whole tip.  Tips without dates are dropped.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import seq as seqm
from ..dates import extract_date_range_from_id
from .fasta import TipData, _open


@dataclass
class MapleFile:
    ref_id: str
    ref_seq: np.ndarray        # i8[L] real letters (ambiguous -> A)
    tips: list                 # list[TipData]


_AMBIG_CHARS = set("nrykswmbdhv-?.")
_REAL_CHARS = {"a": 0, "c": 1, "g": 2, "t": 3, "u": 3}


def read_maple(path, warn=lambda msg: None) -> MapleFile:
    with _open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]

    i = 0
    while i < len(lines) and not lines[i].startswith(">"):
        i += 1
    if i >= len(lines):
        raise ValueError("MAPLE file has no reference entry")
    ref_id = lines[i][1:].strip()
    i += 1
    chunks = []
    while i < len(lines) and not lines[i].startswith(">"):
        chunks.append(lines[i].strip())
        i += 1
    bits = seqm.str_to_bits("".join(chunks))
    if len(bits) == 0:
        raise ValueError("MAPLE reference sequence is empty")
    real = seqm.bits_to_real(bits)
    blacklist = set(np.nonzero(real < 0)[0].tolist())
    if blacklist:
        warn(f"reference has {len(blacklist)} ambiguous sites; treated as A and blacklisted")
    ref_seq = np.where(real < 0, 0, real).astype(np.int8)
    L = len(ref_seq)

    tips = []
    while i < len(lines):
        assert lines[i].startswith(">")
        tip_id = lines[i][1:].strip()
        i += 1
        entries = []
        while i < len(lines) and not lines[i].startswith(">"):
            if lines[i].strip():
                entries.append(lines[i].strip())
            i += 1

        dr = extract_date_range_from_id(tip_id)
        if dr is None:
            warn(f"tip {tip_id!r}: no parseable date; dropped")
            continue

        deltas, intervals = [], []
        ok = True
        for e in entries:
            parts = e.split()
            ch = parts[0].lower()
            if len(ch) != 1 or len(parts) < 2:
                warn(f"tip {tip_id!r}: bad entry {e!r}; tip dropped")
                ok = False
                break
            try:
                start = int(parts[1]) - 1
            except ValueError:
                warn(f"tip {tip_id!r}: bad position in {e!r}; tip dropped")
                ok = False
                break
            if ch in _AMBIG_CHARS:
                length = 1
                if len(parts) >= 3:
                    try:
                        length = int(parts[2])
                    except ValueError:
                        warn(f"tip {tip_id!r}: bad length in {e!r}; tip dropped")
                        ok = False
                        break
                if start < 0 or start + length > L or length < 1:
                    warn(f"tip {tip_id!r}: interval out of range in {e!r}; tip dropped")
                    ok = False
                    break
                intervals.append((start, start + length))
            elif ch in _REAL_CHARS:
                if len(parts) != 2 or start < 0 or start >= L:
                    warn(f"tip {tip_id!r}: bad delta {e!r}; tip dropped")
                    ok = False
                    break
                if start in blacklist:
                    warn(f"tip {tip_id!r}: delta at blacklisted site {start + 1}; tip dropped")
                    ok = False
                    break
                to = _REAL_CHARS[ch]
                if to == ref_seq[start]:
                    continue  # spurious "mutation" dropped
                deltas.append((start, to))
            else:
                warn(f"tip {tip_id!r}: unrecognized entry {e!r}; tip dropped")
                ok = False
                break
        if not ok:
            continue

        intervals.sort()
        merged = []
        for (s, e_) in intervals:
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e_))
            else:
                merged.append((s, e_))
        missing = set()
        for (s, e_) in merged:
            missing.update(range(s, e_))
        deltas = [(l, to) for (l, to) in deltas if l not in missing]

        tips.append(TipData(name=tip_id, t_min=dr[0], t_max=dr[1],
                            deltas=deltas, miss_intervals=merged))
    return MapleFile(ref_id=ref_id, ref_seq=ref_seq, tips=tips)


def write_maple(path, ref_id: str, ref_seq: np.ndarray, tips: list):
    with open(path, "w") as f:
        f.write(f">{ref_id}\n")
        f.write(seqm.real_to_str(ref_seq) + "\n")
        for tip in tips:
            f.write(f">{tip.name}\n")
            events = ([(s, "iv", e) for (s, e) in tip.miss_intervals] +
                      [(l, "d", to) for (l, to) in tip.deltas])
            for (pos, kind, x) in sorted(events):
                if kind == "iv":
                    f.write(f"n\t{pos + 1}\t{x - pos}\n")
                else:
                    f.write(f"{'acgt'[x]}\t{pos + 1}\n")

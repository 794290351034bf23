"""Time axis: fractional days since 2020-01-01.

Mirrors the reference's dates module (core/dates.{h,cpp}): day 0 is 2020-01-01;
ISO dates/months/years parse to day counts or [min,max) ranges; tip dates are
extracted from the end of FASTA/MAPLE sequence ids, separated by '|' or '-'
(core/sequence_utils.cpp:98-160).
"""

from __future__ import annotations

import datetime
import re

_EPOCH = datetime.date(2020, 1, 1)

_RE_DATE = re.compile(r"^\d{4}-\d{2}-\d{2}$")
_RE_MONTH = re.compile(r"^\d{4}-\d{2}$")
_RE_YEAR = re.compile(r"^\d{4}$")


def parse_iso_date(s: str) -> float:
    d = datetime.date.fromisoformat(s)
    return float((d - _EPOCH).days)


def to_iso_date(t: float) -> str:
    import math
    return (_EPOCH + datetime.timedelta(days=math.floor(t))).isoformat()


def parse_iso_month(s: str) -> tuple[float, float]:
    if not _RE_MONTH.match(s):
        raise ValueError(f"Badly formatted ISO month: {s}")
    y, m = int(s[:4]), int(s[5:7])
    start = datetime.date(y, m, 1)
    end = datetime.date(y + (m == 12), m % 12 + 1, 1)
    return float((start - _EPOCH).days), float((end - _EPOCH).days)


def parse_iso_year(s: str) -> tuple[float, float]:
    if not _RE_YEAR.match(s):
        raise ValueError(f"Badly formatted ISO year: {s}")
    y = int(s)
    return (float((datetime.date(y, 1, 1) - _EPOCH).days),
            float((datetime.date(y + 1, 1, 1) - _EPOCH).days))


def to_linear_year(t: float) -> float:
    """Days-since-2020 -> BEAST linear year (reference: core/dates.cpp:53-62)."""
    import math
    d = _EPOCH + datetime.timedelta(days=math.floor(t))
    y_start = datetime.date(d.year, 1, 1)
    y_end = datetime.date(d.year + 1, 1, 1)
    return d.year + (d - y_start).days / (y_end - y_start).days


def extract_date_range_from_id(seq_id: str) -> tuple[float, float] | None:
    """Parse the trailing date (or date range) of a sequence id.

    Accepted suffixes, preceded by '|' or '-' (reference:
    core/sequence_utils.cpp:98-160):
      YYYY-MM-DD              exact day        -> (t, t)
      YYYY-MM                 whole month      -> (t_first, t_after_last)
      YYYY                    whole year       -> (t_first, t_after_last)
      YYYY-MM-DD/YYYY-MM-DD   arbitrary range  -> (t_lo, t_hi)
    Returns None if no date found.
    """
    n = len(seq_id)
    len_range, len_date, len_month, len_year = 21, 10, 7, 4

    def sep_ok(i: int) -> bool:
        return i == 0 or seq_id[i - 1] in "|-"

    # Arbitrary range first
    if n >= len_range and sep_ok(n - len_range):
        cand = seq_id[n - len_range:]
        if cand[len_date] == "/" and _RE_DATE.match(cand[:len_date]) and _RE_DATE.match(cand[len_date + 1:]):
            try:
                lo = parse_iso_date(cand[:len_date])
                hi = parse_iso_date(cand[len_date + 1:])
                if lo <= hi:
                    return (lo, hi)
            except ValueError:
                pass
    if n >= len_date and sep_ok(n - len_date):
        cand = seq_id[n - len_date:]
        if _RE_DATE.match(cand):
            try:
                t = parse_iso_date(cand)
                return (t, t)
            except ValueError:
                pass
    if n >= len_month and sep_ok(n - len_month):
        cand = seq_id[n - len_month:]
        if _RE_MONTH.match(cand):
            try:
                return parse_iso_month(cand)
            except ValueError:
                pass
    if n >= len_year and sep_ok(n - len_year):
        cand = seq_id[n - len_year:]
        if _RE_YEAR.match(cand):
            try:
                return parse_iso_year(cand)
            except ValueError:
                pass
    return None

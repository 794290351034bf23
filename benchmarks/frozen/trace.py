"""Reading a ``torch.profiler`` trace: device intervals, busy time and idle
gaps.

The busy arithmetic is that of the port's smoke script (``chip_smoke.py``
``busy_share``): the union of the intervals of every kernel, memcpy and
memset on the device, over the traced wall.  Events come from the
profiler's Chrome trace, whose device and host events share one clock (us).
"""

from __future__ import annotations

import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def merged(spans) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_gaps(busy: list, lo: float, hi: float) -> list:
    """(start, end) of the gaps in ``lo``..``hi`` not covered by the merged
    ``busy`` intervals."""
    gaps, cur = [], lo
    for s, e in busy:
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(s, e) for s, e in gaps if e > s]


def read_chrome_trace(prof, path: str) -> dict:
    """Export ``prof`` to ``path``, read it back and delete it: the device
    events (name, start, duration in us) and the host annotations
    (``record_function`` ranges: name, start, end in us)."""
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    dev = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
           if e.get("cat") in DEVICE_CATS and "dur" in e]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events
             if e.get("cat") == "user_annotation" and "dur" in e]
    return {"device": dev, "spans": spans}

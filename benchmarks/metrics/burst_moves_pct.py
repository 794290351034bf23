"""burst_moves_pct: the host's time inside the program's
``delphy.burst.moves`` spans (a topology burst's moves and its coalescent
refresh) over the traced slice's wall."""


def read(rec):
    lo, hi = rec["slice"]
    inside = sum(min(e, hi) - max(s, lo) for n, s, e in rec["spans"]
                 if n == "delphy.burst.moves" and e > lo and s < hi)
    if hi <= lo or inside <= 0.0:
        return None
    return 100.0 * inside / (hi - lo)

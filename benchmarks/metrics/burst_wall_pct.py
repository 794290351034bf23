"""burst_wall_pct: the host's time inside ``Run._topology_burst`` (the
benchmark's span around it: fetch, burst, adopt) over the traced slice's
wall."""


def read(rec):
    lo, hi = rec["slice"]
    inside = sum(min(e, hi) - max(s, lo) for n, s, e in rec["spans"]
                 if n == "bench.topology_burst" and e > lo and s < hi)
    if hi <= lo or not rec["device"]:
        return None
    return 100.0 * inside / (hi - lo)

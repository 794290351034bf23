"""dispatch_enqueue_pct: the host's time inside the program's
``delphy.dispatch`` spans (the blocking driver's enqueue of a dispatch:
copy-in, captures, replays, hand-off) over the traced slice's wall.

Its layer is the device's, not the driver's: once the card's launch
queue is full each graph launch waits for room, so the enqueue lasts
about as long as the device's work, and under the profiler it also
carries CUPTI's cost per graph launch, which an untraced run does not
pay (the skygrid cells' large graphs).  It says how much of the wall
the host is held by the card, not what the driver's own code costs."""


def read(rec):
    lo, hi = rec["slice"]
    inside = sum(min(e, hi) - max(s, lo) for n, s, e in rec["spans"]
                 if n == "delphy.dispatch" and e > lo and s < hi)
    if hi <= lo or inside <= 0.0:
        return None
    return 100.0 * inside / (hi - lo)

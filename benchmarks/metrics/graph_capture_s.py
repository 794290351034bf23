"""graph_capture_s: the seconds the dispatch graphs took to capture during
set-up (``Run._graphs.captures``, the ms of each)."""


def read(rec):
    if not rec["capture_ms"]:
        return None
    return sum(rec["capture_ms"]) * 1e-3

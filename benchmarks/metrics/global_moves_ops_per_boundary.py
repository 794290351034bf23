"""global_moves_ops_per_boundary: the device operations a boundary in the
global moves' sections (``ops.global.*``, counted by the program at the
boundary graph's capture), over the traced slice's boundaries."""


def read(rec):
    ops = boundaries = 0
    for d in rec["dispatches"]:
        ops += sum(n for e, n in d["launches"].items()
                   if e.startswith("ops.global."))
        boundaries += d["boundaries"]
    if ops <= 0 or boundaries <= 0:
        return None
    return ops / boundaries

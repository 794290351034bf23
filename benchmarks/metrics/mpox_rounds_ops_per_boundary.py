"""mpox_rounds_ops_per_boundary: the device operations a boundary of the
mpox model's draws and (mu, rho) rounds (``ops.mpox.rounds``, counted by
the program at the boundary graph's capture), over the traced slice's
boundaries; None where the program counts none."""


def read(rec):
    ops = boundaries = 0
    for d in rec["dispatches"]:
        ops += d["launches"].get("ops.mpox.rounds", 0)
        boundaries += d["boundaries"]
    if ops <= 0 or boundaries <= 0:
        return None
    return ops / boundaries

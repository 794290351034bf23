"""device_ops_per_boundary: device events (kernels, memcpys, memsets) in
the traced slice over its boundaries, counted as the sweep entry's
launches (``_cuda.launch_counts``)."""


def read(rec):
    boundaries = sum(n for d in rec["dispatches"]
                     for e, n in d["launches"].items()
                     if e.startswith("sweep_chain"))
    if boundaries <= 0 or not rec["device"]:
        return None
    return len(rec["device"]) / boundaries

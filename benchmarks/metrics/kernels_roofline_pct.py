"""kernels_roofline_pct: the sum over every launch of the sweep, exp_pop
and hky kernels in the traced slice of its bound (``frozen/roofline.py``,
from the dispatch's shapes), over the sum of their device times."""

from benchmarks.frozen import roofline

KERNELS = {"sweep": "sweep_chain_kernel", "exp_pop": "exp_pop_chain_kernel",
           "hky": "hky_chain_kernel"}


def kind(entry):
    """The kernel of a C entry's launch count (any build, any precision)."""
    for k, name in KERNELS.items():
        if entry.startswith(name[:-len("_kernel")]):
            return k
    return None


def read(rec):
    bound = 0.0
    for d in rec["dispatches"]:
        for entry, n in d["launches"].items():
            k = kind(entry)
            if k is not None:
                bound += n * roofline.launch_bound_s(k, d["shapes"])
    dev = sum(dur for name, _s, dur in rec["device"]
              if any(k in name for k in KERNELS.values())) * 1e-6
    if dev <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound / dev

"""Readings of a cell's compared numbers on the card at the cell's own
size, in one process: sound runs, the control (the program in float32)
and faults of ``faults.py`` planted under the timed path.  The limits in
``limits/<cell>.json`` are set from such readings.

    python3 -m benchmarks.tests.chip_faults --workload CELL --seconds S \\
        [--sound SEED ...] [--control SEED ...] [--fault NAME ...] \\
        [--fault-seed SEED ...] [--out FILE]

Each run prints one JSON line: what ran, on which seed, ``correct``, the
compared numbers and the steps per second of its window.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from benchmarks import run as br
from benchmarks.tests.faults import FAULTS, planted


def one(spec: dict, seed: int, seconds: float, what: str) -> dict:
    ctx = (planted(what) if what in FAULTS else contextlib.nullcontext())
    with ctx:
        res = br.run_cell(spec, seed, seconds, False,
                          control=(what == "control"))
    w = res["_window"]
    return {"what": what, "seed": seed, "correct": res["correct"],
            "checks": {k: c["value"] for k, c in res["checks"].items()},
            "steps_per_s": w["steps"] / w["wall_s"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sound", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fault", nargs="*", default=[], choices=sorted(FAULTS))
    ap.add_argument("--fault-seed", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    br.isolate_environment()
    spec = br.load_spec(br.ROOT, args.workload)
    plan = ([("sound", s) for s in args.sound]
            + [("control", s) for s in args.control]
            + [(f, s) for f in args.fault for s in args.fault_seed])
    out = open(args.out, "a") if args.out else None
    for what, seed in plan:
        line = json.dumps(dict(one(spec, seed, args.seconds, what),
                               cell=args.workload))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

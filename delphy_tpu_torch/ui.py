"""Live terminal dashboard — the delphy_ui role for a headless engine (port
of ``delphy_tpu/ui.py``).

The reference ships an SDL live view of a running chain (tree rendering +
parameter traces, tools/delphy_ui.cpp:1-1241).  An engine on a GPU server
runs in a datacenter, so the equivalent surface here is a TERMINAL dashboard
over the JSON-RPC engine server (delphy_tpu_torch/server.py): it polls
`get_state`, renders the stats the SDL view draws (step counter, posterior
ledger, clock rate, kappa, pi, population curve params, root time, topology
acceptance), keeps a rolling log-posterior trace with a sparkline + online
ESS estimate, and can periodically dump the latest Newick string.

Usage:
  python -m delphy_tpu_torch.ui --connect HOST:PORT --run-id N  # watch a run
  python -m delphy_tpu_torch.ui --maple data.maple --steps 5e6  # self-hosted:
      spawns an in-process engine on --device (default cuda), creates the
      run, steps it, watches it.

Renders with plain ANSI escapes (no curses) so it works over any ssh tty;
`--no-ansi` produces append-only lines for logs/pipes.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import DEFAULT_DEVICE

SPARK = "▁▂▃▄▅▆▇█"


def sparkline(xs, width: int = 48) -> str:
    """Render the last `width` values as a unicode sparkline."""
    xs = [x for x in xs if x is not None and np.isfinite(x)]
    if len(xs) < 2:
        return ""
    xs = xs[-width:]
    lo, hi = min(xs), max(xs)
    if hi - lo <= 0:
        return SPARK[0] * len(xs)
    return "".join(SPARK[min(len(SPARK) - 1,
                             int((x - lo) / (hi - lo) * (len(SPARK) - 1)))]
                   for x in xs)


def _fmt_days(t: float) -> str:
    """Engine times are days; show as date-ish offset (the axis is linear
    days with tip dates near 0; absolute calendars live in the I/O layer)."""
    return f"{t:9.2f} d"


def render(state: dict, trace: list, t_start: float, moves0: int,
           width: int = 72) -> str:
    """Pure renderer: engine state dict (server get_state result) -> text
    block.  Kept side-effect free for testing."""
    from .ess import ess as ess_fn

    lines = []
    now = time.time()
    dt = max(now - t_start, 1e-9)
    moves = state.get("local_moves_attempted", 0) - moves0
    rate = moves / dt
    prop = max(1, state.get("topology_proposed", 0))
    acc = state.get("topology_accepted", 0)
    lines.append(f"delphy_tpu live  —  step {state.get('step', 0):,}  "
                 f"({rate:,.0f} moves/s over {dt:,.0f}s)")
    lines.append("─" * width)
    lp = state.get("log_posterior")
    lines.append(f"log posterior {lp:18.4f}   log_G {state.get('log_G', 0.0):16.4f}"
                 if lp is not None else "log posterior        (warming up)")
    if lp is not None:
        lines.append(f"log coal      {state.get('log_coal', 0.0):18.4f}   "
                     f"log priors {state.get('log_other_priors', 0.0):11.4f}")
    pi = state.get("pi", [0.25] * 4)
    lines.append(f"mu {state.get('mu', 0.0) * 365.0:12.4e} /yr     "
                 f"kappa {state.get('kappa', 0.0):7.3f}     "
                 f"pi [{pi[0]:.2f} {pi[1]:.2f} {pi[2]:.2f} {pi[3]:.2f}]")
    pop = state.get("pop", {})
    if pop.get("model") == "skygrid":
        g = np.asarray(pop.get("gamma", [0.0]))
        lines.append(f"pop skygrid   N̄ {float(np.exp(g.mean())):10.2f} d     "
                     f"tau {pop.get('tau', 0.0):9.3f}     M {len(g) - 1}")
    elif pop:
        lines.append(f"pop exp       n0 {pop.get('n0', 0.0):9.2f} d     "
                     f"g {pop.get('g', 0.0) * 365.0:9.3f} /yr")
    lines.append(f"t_root  {_fmt_days(state.get('t_root', 0.0))}          "
                 f"topology {acc:,}/{prop:,} accepted "
                 f"({100.0 * acc / prop:.1f}%)")
    vals = [x for _, x in trace]
    if len(vals) >= 4:
        e = ess_fn(np.asarray(vals, dtype=np.float64))
        eh = e / (dt / 3600.0)
        lines.append("─" * width)
        lines.append(f"log_post trace  {sparkline(vals)}")
        lines.append(f"ESS {e:8.1f}  ({eh:,.1f}/hour, {len(vals)} samples)")
    return "\n".join(lines)


def watch(client, run_id: int, interval: float = 2.0, newick_every: int = 0,
          out=None, ansi: bool = True, max_ticks: int = 0,
          stop_when=None):
    """Poll get_state and redraw until interrupted (or max_ticks > 0 runs
    out, or stop_when(state) returns True)."""
    out = out or sys.stdout
    trace: list = []
    t_start = time.time()
    st0 = client.call("get_state", run_id=run_id)
    moves0 = st0.get("local_moves_attempted", 0)
    ticks = 0
    last_step = -1
    prev_h = 0
    try:
        while True:
            state = client.call("get_state", run_id=run_id)
            if state.get("log_posterior") is not None \
                    and state.get("step") != last_step:
                trace.append((state["step"], state["log_posterior"]))
                last_step = state.get("step")
                if len(trace) > 4096:
                    trace.pop(0)
            block = render(state, trace, t_start, moves0)
            if ansi:
                # move up over the previous frame and redraw in place
                if prev_h:
                    out.write(f"\x1b[{prev_h}F\x1b[0J")
                out.write(block + "\n")
                prev_h = block.count("\n") + 1
            else:
                out.write(block + "\n\n")
            out.flush()
            if newick_every and ticks and ticks % newick_every == 0:
                nwk = client.call("get_tree_newick", run_id=run_id)["newick"]
                out.write(f"[newick] {nwk[:200]}...\n" if len(nwk) > 200
                          else f"[newick] {nwk}\n")
                prev_h = 0
            ticks += 1
            if max_ticks and ticks >= max_ticks:
                return state
            if stop_when is not None and stop_when(state):
                return state
            time.sleep(interval)
    except KeyboardInterrupt:
        out.write("\n")
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--connect", metavar="HOST:PORT",
                    help="attach to a running engine server")
    ap.add_argument("--run-id", type=int, default=0,
                    help="run to watch (default: first listed)")
    ap.add_argument("--maple", help="self-hosted mode: MAPLE file to run")
    ap.add_argument("--fasta", help="self-hosted mode: FASTA file to run")
    ap.add_argument("--steps", type=float, default=1e7,
                    help="self-hosted mode: local moves to run (default 1e7)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh seconds (default 2)")
    ap.add_argument("--newick-every", type=int, default=0,
                    help="dump the live tree every N refreshes")
    ap.add_argument("--no-ansi", action="store_true",
                    help="append-only output (for logs/pipes)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="self-hosted mode: torch device of the engine "
                         "('cuda', the default, or 'cpu')")
    args = ap.parse_args(argv)

    from .server import Client, serve_in_thread

    if args.connect:
        host, port = args.connect.rsplit(":", 1)
        client = Client(host, int(port))
        rid = args.run_id
        if not rid:
            runs = client.call("list_runs")["runs"]
            if not runs:
                print("no runs on the server", file=sys.stderr)
                return 1
            rid = runs[0]["run_id"]
        watch(client, rid, interval=args.interval,
              newick_every=args.newick_every, ansi=not args.no_ansi)
        return 0

    if not (args.maple or args.fasta):
        ap.error("need --connect or --maple/--fasta")
    srv, _engine, _th = serve_in_thread(device=args.device)
    client = Client(*srv.server_address)
    kind = "maple" if args.maple else "fasta"
    print(f"parsing {kind} + building the initial tree…", flush=True)
    job = client.call("create_run", seed=args.seed,
                      **{kind: args.maple or args.fasta})
    res = client.wait_job(job["job_id"], timeout=24 * 3600)
    rid = res["run_id"]
    print(f"run {rid}: {res['num_tips']} tips x {res['num_sites']} sites",
          flush=True)
    job = client.call("run_steps", run_id=rid, n=int(args.steps))
    jid = job["job_id"]

    def stop_when(_state):
        return client.call("job_status", job_id=jid)["done"]

    watch(client, rid, interval=args.interval,
          newick_every=args.newick_every, ansi=not args.no_ansi,
          stop_when=stop_when)
    return 0


if __name__ == "__main__":
    sys.exit(main())

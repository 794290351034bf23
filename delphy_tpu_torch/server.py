"""Long-running engine server — the delphy-web surface without a browser ABI
(port of ``delphy_tpu/server.py``).

The reference exposes its engine to delphy-web through 177 `extern "C"` WASM
exports (tools/delphy_wasm.cpp:69-1934): async input parsing, run
construction + parameter setters, async stepping, state pulls (tree and
params flatbuffers, probers, MCC), and .dphy save/load.  This module is the
functional equivalent (doc/API.md is the mapping contract): a
newline-delimited JSON-RPC server over TCP, one engine process serving any
number of runs on one torch device, long operations as pollable jobs (the
`*_async` + JS-callback pattern of delphy_wasm.cpp:185,315,875-894 becomes
submit + poll).

Every run and every loaded snapshot lives on the server's device (CUDA unless
the server was started with another).  Step jobs run on worker threads:
``torch.cuda.current_stream()`` is per thread, and a worker thread that has
made no stream current launches on its device's default stream, the one the
run's tensors were made on, so a run's work stays ordered whichever thread
steps it.  State is read through ``Run.host_view()``, one device-to-host copy
per request.

Protocol: one JSON object per line.
  request : {"id": any, "method": str, "params": {...}}
  response: {"id": any, "result": ...} | {"id": any, "error": str}
Binary payloads (flatbuffers, .dphy bytes) travel base64-encoded.

Run `python -m delphy_tpu_torch.server [--host H] [--port P] [--device D]`;
port 0 prints the chosen ephemeral port on stdout as
`LISTENING <host> <port>`.
"""

from __future__ import annotations

import base64
import io
import json
import os
import socket
import socketserver
import threading
import traceback

import numpy as np
import torch

from . import DEFAULT_DEVICE, resolve_device


class Job:
    def __init__(self, jid: int):
        self.id = jid
        self.done = False
        self.error = None
        self.result = None
        self.progress = ""


class RunHandle:
    """One MCMC run + its worker thread.  All engine access is serialized by
    `lock`; step jobs take it in per-boundary-window chunks so getters
    interleave (the reference's async-steps + getter pattern)."""

    def __init__(self, rid: int, run, sample_trees: bool = True,
                 max_sampled: int = 64):
        self.id = rid
        self.run = run
        self.lock = threading.RLock()
        self.sample_trees = sample_trees
        self.max_sampled = max_sampled
        self.sampled = []          # (step, FlatTree) posterior samples

    def step_chunks(self, n: int):
        run = self.run
        chunk = max(1, run.local_moves_per_global_move
                    * run.topology_burst_chunks)
        done = 0
        while done < n:
            c = min(chunk, n - done)
            with self.lock:
                run.do_mcmc_steps(c)
            done += c
        if self.sample_trees:
            with self.lock:
                self.sampled.append((run.step, run.tree()))
                if len(self.sampled) > self.max_sampled:
                    self.sampled.pop(0)


class EngineServer:
    def __init__(self, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._runs: dict[int, RunHandle] = {}
        self._jobs: dict[int, Job] = {}
        self._next = 1

    # -- plumbing ------------------------------------------------------------

    def _new_id(self) -> int:
        with self._lock:
            i = self._next
            self._next += 1
            return i

    def _run(self, rid) -> RunHandle:
        h = self._runs.get(int(rid))
        if h is None:
            raise ValueError(f"unknown run_id {rid}")
        return h

    def _submit(self, fn, *args) -> dict:
        job = Job(self._new_id())
        self._jobs[job.id] = job

        def work():
            try:
                if self.device.index is not None:
                    # the kernels launch on the thread's current device
                    torch.cuda.set_device(self.device)
                job.result = fn(*args)
            except Exception as e:  # surfaced via poll
                job.error = f"{type(e).__name__}: {e}"
            finally:
                job.done = True

        threading.Thread(target=work, daemon=True).start()
        return {"job_id": job.id}

    # -- methods (the delphy_wasm capability groups) --------------------------

    def rpc_create_run(self, params: dict) -> dict:
        """Group 1+2: parse inputs, build the initial tree, construct a Run
        (delphy_parse_*_into_initial_tree_async + delphy_run_create).  Long:
        returns a job whose result is {"run_id": ...}."""
        def work():
            from .io.maple import read_maple
            from .io.fasta import read_fasta, deduce_consensus, fasta_to_tips
            from .init_tree import build_initial_tree
            from .run import Run

            if "maple_text" in params:
                import tempfile
                with tempfile.NamedTemporaryFile(
                        "w", suffix=".maple", delete=False) as tf:
                    tf.write(params["maple_text"])
                try:
                    mf = read_maple(tf.name)
                finally:
                    os.unlink(tf.name)
                ref, tips = mf.ref_seq, mf.tips
            elif "maple" in params:
                mf = read_maple(params["maple"])
                ref, tips = mf.ref_seq, mf.tips
            elif "fasta" in params:
                records = read_fasta(params["fasta"])
                ref = deduce_consensus(records,
                                       max(len(r.bits) for r in records))
                tips = fasta_to_tips(records, ref)
            else:
                raise ValueError("create_run needs maple|maple_text|fasta")
            seed = int(params.get("seed", 0))
            tree = build_initial_tree(
                ref, [t.deltas for t in tips],
                [t.miss_intervals for t in tips],
                [(t.t_min, t.t_max) for t in tips],
                names=[t.name for t in tips],
                rng=np.random.default_rng(seed))
            kw = {}
            for k in ("num_cells", "pop_model", "skygrid_num_parameters",
                      "local_moves_per_global_move", "mpox_hack",
                      "device_partitions"):
                if k in params:
                    kw[k] = params[k]
            run = Run(tree, seed=seed, device=self.device, **kw)
            rid = self._new_id()
            self._runs[rid] = RunHandle(rid, run,
                                        sample_trees=params.get(
                                            "sample_trees", True))
            return {"run_id": rid, "num_tips": tree.num_tips,
                    "num_sites": tree.num_sites}

        return self._submit(work)

    def rpc_run_steps(self, params: dict) -> dict:
        """delphy_run_steps_async: advance n local moves on a worker thread;
        poll the returned job."""
        h = self._run(params["run_id"])
        n = int(params["n"])

        def work():
            h.step_chunks(n)
            with h.lock:
                return {"step": h.run.step,
                        "log_posterior": h.run.log_posterior}

        return self._submit(work)

    def rpc_job_status(self, params: dict) -> dict:
        job = self._jobs.get(int(params["job_id"]))
        if job is None:
            raise ValueError("unknown job_id")
        out = {"done": job.done}
        if job.done:
            if job.error is not None:
                out["error"] = job.error
            else:
                out["result"] = job.result
        return out

    def rpc_get_state(self, params: dict) -> dict:
        """The delphy_run_get_* getter block: posteriors, params, cadences."""
        h = self._run(params["run_id"])
        with h.lock:
            run = h.run
            hv = run.host_view()
            led = hv.ledger
            from . import pop as popm
            if isinstance(run.pop, popm.SkygridPopParams):
                pop = {"model": "skygrid",
                       "x": np.asarray(hv.pop.x).tolist(),
                       "gamma": np.asarray(hv.pop.gamma).tolist(),
                       "tau": float(hv.pop.tau), "type": int(run.pop.type)}
            else:
                pop = {"model": "exp", "t0": float(hv.pop.t0),
                       "n0": float(hv.pop.n0), "g": float(hv.pop.g)}
            return {
                "step": run.step,
                "stats_line": run.stats_line(hv) if led is not None else "",
                "log_posterior": float(led.log_posterior) if led else None,
                "log_G": float(led.log_G) if led else None,
                "log_coal": float(led.log_coal) if led else None,
                "log_other_priors": float(led.log_other) if led else None,
                "mu": float(hv.evo.mu), "kappa": float(hv.evo.kappa),
                "alpha": float(hv.evo.alpha),
                "pi": hv.evo.pi.tolist(),
                "pop": pop,
                "t_root": float(hv.t[hv.root]),
                "num_nodes": run.ts.num_nodes,
                "local_moves_attempted": int(run.local_moves_attempted),
                "topology_accepted": int(run.topology_accepted),
                "topology_proposed": int(run.topology_proposed),
            }

    def rpc_set_params(self, params: dict) -> dict:
        """The delphy_run_set_* setter block (subset: continuous params;
        move toggles/prior hyperparams are PriorConfig at construction)."""
        h = self._run(params["run_id"])
        with h.lock:
            run = h.run
            if "mu" in params:
                run.set_mu(float(params["mu"]))
            if "alpha" in params:
                run.set_alpha(float(params["alpha"]))
            pop_kw = {k: params[k] for k in ("n0", "g", "min_pop")
                      if k in params}
            if pop_kw:
                run.set_pop(**pop_kw)
            return {"ok": True}

    def rpc_get_tree_newick(self, params: dict) -> dict:
        h = self._run(params["run_id"])
        from .io.beast_out import newick_string
        with h.lock:
            return {"newick": newick_string(h.run.tree())}

    def rpc_get_tree_fb(self, params: dict) -> dict:
        """Tree + TreeInfo flatbuffers (delphy_run_export_tree /
        api.fbs:42-93), base64."""
        h = self._run(params["run_id"])
        from .io.dphy import build_tree_fb, build_tree_info_fb
        with h.lock:
            tree = h.run.tree()
        return {"tree_fb": base64.b64encode(build_tree_fb(tree)).decode(),
                "tree_info_fb": base64.b64encode(
                    build_tree_info_fb(tree)).decode()}

    def rpc_get_params_fb(self, params: dict) -> dict:
        h = self._run(params["run_id"])
        from .io.dphy import build_params_fb
        with h.lock:
            return {"params_fb": base64.b64encode(
                build_params_fb(h.run)).decode()}

    def rpc_probe_ancestors(self, params: dict) -> dict:
        """api.h:25-44 ancestry prober."""
        h = self._run(params["run_id"])
        from .probers import probe_ancestors_on_tree
        with h.lock:
            p = probe_ancestors_on_tree(
                h.run.tree(), h.run.host_view().pop,
                [int(x) for x in params["marked_ancestors"]],
                float(params["t_start"]), float(params["t_end"]),
                int(params["num_t_cells"]))
        return {"p": np.asarray(p).tolist()}

    def rpc_probe_site_states(self, params: dict) -> dict:
        h = self._run(params["run_id"])
        from .probers import probe_site_states_on_tree
        with h.lock:
            p = probe_site_states_on_tree(
                h.run.tree(), h.run.host_view().pop, int(params["site"]),
                float(params["t_start"]), float(params["t_end"]),
                int(params["num_t_cells"]))
        return {"p": np.asarray(p).tolist()}

    def rpc_get_mcc_nexus(self, params: dict) -> dict:
        """MCC over the run's sampled trees (delphy_derive_mcc_tree +
        NEXUS export, api.h:54)."""
        h = self._run(params["run_id"])
        from .mcc import derive_mcc_tree, mcc_to_nexus
        with h.lock:
            trees = [t for _, t in h.sampled]
            if not trees:
                trees = [h.run.tree()]
            mcc = derive_mcc_tree(trees, seed=int(params.get("seed", 0)))
            sio = io.StringIO()
            mcc_to_nexus(mcc, sio)
        return {"nexus": sio.getvalue(), "num_base_trees": len(trees)}

    def rpc_save_snapshot(self, params: dict) -> dict:
        """Bit-identical engine snapshot (resume continues the trajectory)."""
        h = self._run(params["run_id"])
        from .io.snapshot import save_run
        with h.lock:
            save_run(h.run, params["path"])
        return {"ok": True}

    def rpc_load_snapshot(self, params: dict) -> dict:
        from .io.snapshot import load_run
        run = load_run(params["path"], device=self.device)
        rid = self._new_id()
        self._runs[rid] = RunHandle(rid, run)
        return {"run_id": rid, "step": run.step}

    def rpc_export_dphy(self, params: dict) -> dict:
        """.dphy v3 stream for delphy/delphy-web interchange
        (delphy_output.h:11-40)."""
        h = self._run(params["run_id"])
        from .io.dphy import DphyOutput
        with h.lock:
            with open(params["path"], "wb") as f:
                out = DphyOutput(f)
                out.output_preamble(
                    h.run, steps_per_sample=int(
                        params.get("steps_per_sample", 1000)))
                out.output_state(h.run)
                out.output_epilog()
        return {"ok": True, "bytes": os.path.getsize(params["path"])}

    def rpc_list_runs(self, params: dict) -> dict:
        return {"runs": [{"run_id": rid, "step": h.run.step}
                         for rid, h in self._runs.items()]}

    def rpc_close_run(self, params: dict) -> dict:
        self._runs.pop(int(params["run_id"]), None)
        return {"ok": True}

    # -- dispatch --------------------------------------------------------------

    def handle(self, req: dict):
        method = req.get("method", "")
        fn = getattr(self, f"rpc_{method}", None)
        if fn is None:
            raise ValueError(f"unknown method {method!r}")
        return fn(req.get("params", {}) or {})


def serve(host: str = "127.0.0.1", port: int = 0, announce=print,
          device=DEFAULT_DEVICE):
    """The TCP server (not yet serving) and its engine on ``device``."""
    engine = EngineServer(device)

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for line in self.rfile:
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                    result = engine.handle(req)
                    resp = {"id": req.get("id"), "result": result}
                except Exception as e:
                    traceback.print_exc()
                    resp = {"id": None, "error": f"{type(e).__name__}: {e}"}
                    if isinstance(line, bytes):
                        try:
                            resp["id"] = json.loads(line).get("id")
                        except Exception:
                            pass
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    srv = Server((host, port), Handler)
    announce(f"LISTENING {srv.server_address[0]} {srv.server_address[1]}",
             flush=True)
    return srv, engine


def serve_in_thread(host="127.0.0.1", port=0, device=DEFAULT_DEVICE):
    srv, engine = serve(host, port, announce=lambda *a, **k: None,
                        device=device)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, engine, th


class Client:
    """Tiny blocking JSON-RPC client (tests + scripting)."""

    def __init__(self, host: str, port: int):
        self.sock = socket.create_connection((host, port))
        self.fh = self.sock.makefile("rwb")
        self._id = 0

    def call(self, method: str, **params):
        self._id += 1
        req = {"id": self._id, "method": method, "params": params}
        self.fh.write((json.dumps(req) + "\n").encode())
        self.fh.flush()
        resp = json.loads(self.fh.readline())
        if "error" in resp:
            raise RuntimeError(resp["error"])
        return resp["result"]

    def wait_job(self, job_id: int, timeout: float = 600.0,
                 poll_s: float = 0.1):
        import time
        t0 = time.time()
        while time.time() - t0 < timeout:
            st = self.call("job_status", job_id=job_id)
            if st["done"]:
                if "error" in st:
                    raise RuntimeError(st["error"])
                return st["result"]
            time.sleep(poll_s)
        raise TimeoutError(f"job {job_id}")

    def close(self):
        self.sock.close()


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device of every run: 'cuda' (default), "
                         "'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)
    srv, _ = serve(args.host, args.port, device=args.device)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()

"""The port's JSON-RPC engine server (delphy_tpu_torch/server.py) and terminal
dashboard (delphy_tpu_torch/ui.py) on the CPU: the whole surface that
tests/test_server.py and tests/test_ui.py demand of the JAX package (async
create + stepping, getters and setters, flatbuffers pulls, probers, MCC,
snapshot save/load with exact resume, .dphy export, errors as RPC errors, the
pure renderer and a live watch), with the port's flatbuffers and .dphy read
back by the JAX package's parsers.  Tolerances: 1e-12 on parameters that
travel as JSON floats; resume is compared with ``==``."""

import base64
import io
import time

import numpy as np
import pytest

from delphy_tpu.io.dphy import parse_params_fb, parse_tree_fb, read_dphy

from delphy_tpu_torch.dates import to_iso_date
from delphy_tpu_torch.io.fasta import TipData
from delphy_tpu_torch.io.maple import write_maple
from delphy_tpu_torch.server import Client, serve_in_thread
from delphy_tpu_torch.sim import simulate_dataset
from delphy_tpu_torch.ui import render, sparkline, watch


@pytest.fixture(scope="module")
def server():
    srv, engine, th = serve_in_thread(device="cpu")
    yield srv.server_address
    srv.shutdown()
    srv.server_close()


def _write_maple(path, n_tips, n_sites, seed):
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        n_tips, n_sites, mu=2e-3, missing_fraction=0.02, seed=seed)
    tips = [TipData(name=f"s{i}|{to_iso_date(dates[i][0])}",
                    t_min=dates[i][0], t_max=dates[i][1],
                    deltas=deltas[i], miss_intervals=miss[i])
            for i in range(n_tips)]
    write_maple(str(path), "ref", ref, tips)
    return str(path)


def test_server_full_surface(server, tmp_path):
    maple_path = _write_maple(tmp_path / "in.maple", 24, 300, seed=13)
    c = Client(*server)
    try:
        # group 1+2: async create (parse + init tree + Run construction)
        job = c.call("create_run", maple=maple_path, seed=5, num_cells=64,
                     local_moves_per_global_move=200)
        res = c.wait_job(job["job_id"])
        rid = res["run_id"]
        assert res["num_tips"] == 24 and res["num_sites"] == 300

        # async stepping + poll
        job = c.call("run_steps", run_id=rid, n=2000)
        res = c.wait_job(job["job_id"])
        assert res["step"] >= 2000
        assert np.isfinite(res["log_posterior"])

        # getters interleave with a running step job
        job = c.call("run_steps", run_id=rid, n=2000)
        st = c.call("get_state", run_id=rid)
        assert st["num_nodes"] == 47
        assert "mu" in st and st["kappa"] > 0
        c.wait_job(job["job_id"])

        # setters
        c.call("set_params", run_id=rid, mu=2.5e-3 / 365.0)
        st = c.call("get_state", run_id=rid)
        assert abs(st["mu"] - 2.5e-3 / 365.0) < 1e-12
        assert "log_post" in st["stats_line"]

        # state out: newick, flatbuffers, probers, MCC
        nwk = c.call("get_tree_newick", run_id=rid)["newick"]
        assert nwk.count("(") == 23 and nwk.endswith(";")

        fb = c.call("get_tree_fb", run_id=rid)
        t2 = parse_tree_fb(base64.b64decode(fb["tree_fb"]))
        assert t2.num_tips == 24
        pfb = c.call("get_params_fb", run_id=rid)
        pd = parse_params_fb(base64.b64decode(pfb["params_fb"]))
        assert abs(pd["mu"] - st["mu"]) < 1e-12

        t_lo, t_hi = st["t_root"], st["t_root"] + 300.0
        pa = np.asarray(c.call("probe_ancestors", run_id=rid,
                               marked_ancestors=[24], t_start=t_lo,
                               t_end=t_hi, num_t_cells=16)["p"])
        assert pa.shape == (2, 16)
        assert np.all(pa >= -1e-9) and np.all(pa <= 1 + 1e-9)
        ps = np.asarray(c.call("probe_site_states", run_id=rid, site=3,
                               t_start=t_lo, t_end=t_hi,
                               num_t_cells=8)["p"])
        assert ps.shape == (4, 8)

        mcc = c.call("get_mcc_nexus", run_id=rid)
        assert "begin trees;" in mcc["nexus"].lower()
        assert mcc["num_base_trees"] >= 1

        # save/load: snapshot resume continues exactly, both runs stepped
        # at once on their worker threads
        snap = str(tmp_path / "run.npz")
        c.call("save_snapshot", run_id=rid, path=snap)
        rid2 = c.call("load_snapshot", path=snap)["run_id"]
        j1 = c.call("run_steps", run_id=rid, n=1000)
        j2 = c.call("run_steps", run_id=rid2, n=1000)
        r1, r2 = c.wait_job(j1["job_id"]), c.wait_job(j2["job_id"])
        assert r1["log_posterior"] == r2["log_posterior"]

        dphy = str(tmp_path / "run.dphy")
        out = c.call("export_dphy", run_id=rid, path=dphy)
        assert out["bytes"] > 100
        df = read_dphy(dphy)
        assert len(df.samples) >= 1

        runs = c.call("list_runs")["runs"]
        assert {r["run_id"] for r in runs} >= {rid, rid2}
        c.call("close_run", run_id=rid2)

        # errors surface as RPC errors, not dead connections
        with pytest.raises(RuntimeError):
            c.call("get_state", run_id=99999)
        assert c.call("list_runs") is not None
    finally:
        c.close()


@pytest.mark.parametrize("params", [{"pop_model": "skygrid"},
                                    {"mpox_hack": True}])
def test_create_run_unported_models_fail_through_the_job(server, tmp_path,
                                                         params):
    maple_path = _write_maple(tmp_path / "in.maple", 8, 100, seed=3)
    c = Client(*server)
    try:
        job = c.call("create_run", maple=maple_path, seed=1, **params)
        with pytest.raises(RuntimeError, match="not ported"):
            c.wait_job(job["job_id"])
    finally:
        c.close()


def test_server_defaults_to_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_in_thread()


def test_sparkline_shapes():
    assert sparkline([]) == ""
    assert sparkline([1.0]) == ""
    s = sparkline([0, 1, 2, 3, 4, 5, 6, 7])
    assert len(s) == 8 and s[0] == "▁" and s[-1] == "█"
    assert sparkline([2.0, 2.0, 2.0]) == "▁▁▁"
    assert len(sparkline(list(range(500)), width=48)) == 48


def test_render_pure():
    state = {
        "step": 123456, "log_posterior": -1234.5678, "log_G": -1000.0,
        "log_coal": -200.0, "log_other_priors": -34.5678,
        "mu": 1e-3 / 365.0, "kappa": 2.5, "pi": [0.3, 0.2, 0.2, 0.3],
        "pop": {"model": "exp", "n0": 1000.0, "g": 0.0},
        "t_root": -700.25, "local_moves_attempted": 200000,
        "topology_accepted": 40, "topology_proposed": 100,
    }
    trace = [(1000 * i, -1234.0 - np.sin(i)) for i in range(20)]
    out = render(state, trace, t_start=time.time() - 10.0, moves0=0)
    assert "step 123,456" in out
    assert "-1234.5678" in out
    assert "kappa   2.500" in out
    assert "40/100 accepted (40.0%)" in out
    assert "ESS" in out and "log_post trace" in out
    # skygrid variant
    state["pop"] = {"model": "skygrid", "gamma": [6.0, 6.5, 7.0],
                    "tau": 2.0, "type": 0}
    out2 = render(state, [], t_start=time.time() - 1.0, moves0=0)
    assert "skygrid" in out2 and "M 2" in out2
    # warming-up state (no ledger yet)
    out3 = render({"step": 0, "log_posterior": None, "pop": {}}, [],
                  t_start=time.time(), moves0=0)
    assert "warming up" in out3


def test_watch_live_run(server, tmp_path):
    """e2e: create a run through the server, start an async step job, and
    let the dashboard watch it for a few ticks (append-only mode)."""
    p = _write_maple(tmp_path / "ui.maple", 16, 200, seed=31)

    c = Client(*server)
    try:
        job = c.call("create_run", maple=str(p), seed=3,
                     num_cells=64, local_moves_per_global_move=150)
        rid = c.wait_job(job["job_id"], timeout=300)["run_id"]
        c.call("run_steps", run_id=rid, n=3000)
        buf = io.StringIO()
        state = watch(c, rid, interval=0.3, ansi=False, out=buf,
                      max_ticks=4, newick_every=2)
        text = buf.getvalue()
        assert "delphy_tpu live" in text
        assert "[newick]" in text
        assert state is not None and state["step"] >= 0
    finally:
        c.close()

"""The port's part mesh (delphy_tpu_torch/parallel/distributed.py: one
process per device over torch.distributed) on the CPU, with gloo ranks in
subprocesses that import no jax: the counterparts of tests/test_mesh.py,
tests/test_distributed.py and
tests/test_overlap.py::test_overlap_mesh_matches_single_device.

One group of two ranks, started under the env contract, runs every check
that needs one (blocking and overlapped runs against the single-process
runs, the overlapped run again through the static buffers of the dispatch
graphs, the reassembly on a JAX partition map, the replica check); a group
of four runs the blocking run again; the CLI starts its own ranks."""

import inspect
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec

from delphy_tpu.parallel import sweep as jsweep
from delphy_tpu.phylo import build_random_tree as j_build_random_tree
from delphy_tpu.run import Run as JRun
from delphy_tpu.sim import simulate_dataset as j_simulate_dataset

from delphy_tpu_torch.parallel.distributed import PartMesh
from delphy_tpu_torch.run import Run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240


def _drive(mesh, overlap: bool, P: int, out: str, buffers: bool = False):
    """A 48-tip run with topology moves through three dispatch calls (a
    burst and its repartition after the second), on the CPU, under ``mesh`` (None: one process):
    its ledger is checked at 1e-6, t and mut_t go to ``out`` (.npz) and its
    counters are returned.  ``buffers``: every dispatch goes through the
    static buffers of the Run's graph cache (``sweep.graph_dispatch``), as
    on CUDA with the all-reduce on the card; its captures are returned."""
    import os

    import numpy as np

    from delphy_tpu_torch import run as run_mod
    from delphy_tpu_torch.parallel import sweep
    from delphy_tpu_torch.phylo import build_random_tree
    from delphy_tpu_torch.run import Run
    from delphy_tpu_torch.sim import simulate_dataset

    ref, deltas, miss, dates, names, _ = simulate_dataset(
        48, 400, mu=2e-3, missing_fraction=0.02, seed=21)
    tree = build_random_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(21))
    run = Run(tree, seed=23, num_cells=64, local_moves_per_global_move=200,
              device_partitions=P, topology_moves_enabled=True,
              device="cpu", mesh=mesh)
    run.topology_burst_chunks = 2
    reparts = []
    repartition = run._repartition

    def counting(sync_times=False):
        reparts.append(sync_times)
        repartition(sync_times=sync_times)
    run._repartition = counting
    prev = os.environ.get("DELPHY_TPU_OVERLAP")
    os.environ["DELPHY_TPU_OVERLAP"] = "1" if overlap else "0"
    orig = run_mod.parts_multi_super_step
    if buffers:
        run_mod.parts_multi_super_step = (
            lambda *a, graphs, **kw: sweep.graph_dispatch(graphs, *a, **kw))
    try:
        for _ in range(3):
            run.do_mcmc_steps(400)
    finally:
        run_mod.parts_multi_super_step = orig
        if prev is None:
            del os.environ["DELPHY_TPU_OVERLAP"]
        else:
            os.environ["DELPHY_TPU_OVERLAP"] = prev
    assert (run.last_cycle is not None) == overlap
    run.check_derived_quantities(1e-6)
    run.tree().check_integrity()
    np.savez(out, t=run.ts.t.numpy(), mut_t=run.ts.mut_t.numpy())
    return {"log_G": float(run.ledger.log_G),
            "topology_proposed": run.topology_proposed,
            "bursts": run.burst_count, "repartitions": len(reparts),
            "moves": run.local_moves_attempted,
            "parts": int(run.pm.node_map.shape[0]),
            "width": run.last_cycle["selection_width"] if overlap else None,
            **({"captures": [c["blocks"] for c in run._graphs.captures],
                "replays": run._graphs.replays} if buffers else {})}


def _reassemble(mesh, src: str, out: str):
    """The port's reassembly of the per-part deltas in ``src`` (a JAX
    partition map and deltas made from a numpy seed): this rank's rows
    scattered, then mesh_reassemble; the totals go to ``out``."""
    import numpy as np
    import torch

    from delphy_tpu_torch.convert import from_dict
    from delphy_tpu_torch.parallel.partmaps import PartMaps
    from delphy_tpu_torch.parallel.sweep import (mesh_reassemble,
                                                 scatter_deltas, select_parts)

    with np.load(src) as z:
        d = {k: z[k] for k in z.files}
    pm = from_dict(PartMaps, {k[3:]: v for k, v in d.items()
                              if k.startswith("pm_")}, "cpu")
    P = pm.node_map.shape[0]
    shard = mesh.shard_rows(P)
    dt_p, dmut_p = (torch.from_numpy(d[k][shard]) for k in ("dt_p", "dmut_p"))
    dt, dmut = scatter_deltas(select_parts(pm, shard), int(d["N"]),
                              int(d["M"]), dt_p, dmut_p)
    dt, dmut, dG_p, dC_p, cnt_p = mesh_reassemble(
        mesh, shard, P, dt, dmut,
        *(torch.from_numpy(d[k][shard]) for k in ("dG_p", "dC_p", "cnt_p")))
    np.savez(out, dt=dt.numpy(), dmut=dmut.numpy(),
             dG=float(torch.sum(dG_p)), dC=float(torch.sum(dC_p)),
             cnt=float(torch.sum(cnt_p)))


RANK_MAIN = """
import json, os, sys
sys.modules["jax"] = None            # the ranks import no jax
import torch
from delphy_tpu_torch.parallel import distributed
assert distributed.initialize_from_env()
mesh = distributed.global_part_mesh(device="cpu")
out = os.environ["MESH_TEST_OUT"]
res = {"rank": mesh.rank, "size": mesh.size}
try:                                 # a mesh never leaves ranks idle
    distributed.global_part_mesh(max_devices=mesh.size - 1, device="cpu")
    res["smaller_mesh"] = None
except ValueError as e:
    res["smaller_mesh"] = str(e)
tag = f"D{mesh.size}_r{mesh.rank}"
res["blocking"] = _drive(mesh, False, 8, f"{out}/blocking_{tag}.npz")
if mesh.size == 2:
    res["overlap"] = _drive(mesh, True, 16, f"{out}/overlap_{tag}.npz")
    res["overlap_buffers"] = _drive(mesh, True, 16,
                                    f"{out}/overlap_buffers_{tag}.npz", True)
    # P = 10: half the part axis (5) does not divide over the ranks
    res["overlap_odd"] = _drive(mesh, True, 10, f"{out}/overlap_odd_{tag}.npz")
    _reassemble(mesh, f"{out}/deltas.npz", f"{out}/reassembled_{tag}.npz")
    # a rank that diverges: the replica check must say so on every rank
    from delphy_tpu_torch.phylo import build_random_tree
    from delphy_tpu_torch.run import Run
    from delphy_tpu_torch.sim import simulate_dataset
    import numpy as np
    ref, deltas, miss, dates, names, _ = simulate_dataset(24, 200, mu=2e-3,
                                                          seed=5)
    run = Run(build_random_tree(ref, deltas, miss, dates, names=names,
                                rng=np.random.default_rng(5)),
              seed=9, num_cells=64, local_moves_per_global_move=200,
              device_partitions=4, device="cpu", mesh=mesh)
    run.do_mcmc_steps(400)
    run.check_derived_quantities(1e-6)
    # rank 0 saves; every rank resumes from the file and steps on beside
    # the run that never stopped
    from delphy_tpu_torch.io.snapshot import load_run, save_run
    snap = f"{out}/snap.npz"
    if mesh.rank == 0:
        save_run(run, snap)
    mesh.disagreeing({"barrier": 0.0})
    twin = load_run(snap, mesh=mesh)
    for r in (run, twin):
        r.do_mcmc_steps(400)
    res["resumed"] = (twin.log_posterior == run.log_posterior
                      and bool(torch.equal(twin.ts.t, run.ts.t)))
    if mesh.rank == 1:
        run.ts = run.ts._replace(t=run.ts.t + 1e-9)
    try:
        run.check_derived_quantities(1e-6)
        res["replica_check"] = None
    except AssertionError as e:
        res["replica_check"] = str(e)
print("RESULT " + json.dumps(res), flush=True)
distributed.shutdown()
"""


def _rank_source() -> str:
    return "\n".join([textwrap.dedent(inspect.getsource(f))
                      for f in (_drive, _reassemble)] + [RANK_MAIN])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_group(D: int, out, launcher: bool = False) -> list:
    """Start D ranks of the rank script under the env contract
    (``launcher``: DELPHY_TPU_DISTRIBUTED=1 with torchrun's variables
    instead of the coordinator's); returns their processes."""
    port = _free_port()
    src = _rank_source()
    procs = []
    for r in range(D):
        env = dict(os.environ, PYTHONPATH=REPO, MESH_TEST_OUT=str(out),
                   OMP_NUM_THREADS="1")
        if launcher:
            env.update(DELPHY_TPU_DISTRIBUTED="1", RANK=str(r),
                       WORLD_SIZE=str(D), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
        else:
            env.update(DELPHY_TPU_COORDINATOR=f"127.0.0.1:{port}",
                       DELPHY_TPU_NUM_PROCESSES=str(D),
                       DELPHY_TPU_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", src], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def _results(procs) -> list:
    """The RESULT dicts of a group's ranks, in rank order."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            p.kill()
    res = []
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{so[-2000:]}\n{se[-4000:]}"
        line = [ln for ln in so.splitlines() if ln.startswith("RESULT ")]
        res.append(json.loads(line[0][len("RESULT "):]))
    return res


def _jax_deltas(out):
    """A JAX Run's partition map (48 tips, 8 parts) and per-part deltas
    from a numpy seed, written for the ranks; returns both."""
    ref, deltas, miss, dates, names, _ = j_simulate_dataset(
        48, 400, mu=2e-3, missing_fraction=0.02, seed=31)
    tree = j_build_random_tree(ref, deltas, miss, dates, names=names,
                               rng=np.random.default_rng(31))
    jrun = JRun(tree, seed=33, num_cells=64, device_partitions=8,
                topology_moves_enabled=False)
    pm = {k: np.asarray(v) for k, v in jrun.pm._asdict().items()}
    P, n_cap = pm["node_map"].shape
    m_cap = pm["mut_map"].shape[1]
    rng = np.random.default_rng(12345)
    d = {"dt_p": rng.normal(size=(P, n_cap)),
         "dmut_p": rng.normal(size=(P, m_cap)),
         "dG_p": rng.normal(size=P) * 100.0, "dC_p": rng.normal(size=P),
         "cnt_p": rng.integers(0, 500, size=P).astype(np.float64),
         "N": jrun.ts.num_nodes, "M": int(jrun.ts.mut_t.shape[0])}
    np.savez(out / "deltas.npz", **d, **{f"pm_{k}": v for k, v in pm.items()})
    return jrun.pm, d


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh")


@pytest.fixture(scope="module")
def jax_deltas(out):
    return _jax_deltas(out)


@pytest.fixture(scope="module")
def groups(out, jax_deltas):
    """Both groups (two ranks under the coordinator's contract, four under
    the launcher's) run at once while this process makes the single-process
    runs; returns (the runs, {D: the ranks' results})."""
    procs = {2: _start_group(2, out), 4: _start_group(4, out, launcher=True)}
    try:
        single = {
            "blocking": _drive(None, False, 8, str(out / "blocking_1.npz")),
            "overlap": _drive(None, True, 16, str(out / "overlap_1.npz"))}
    finally:
        ranks = {D: _results(p) for D, p in procs.items()}
    return single, ranks


@pytest.fixture(scope="module")
def group2(groups):
    return groups[1][2]


@pytest.fixture(scope="module")
def single(groups):
    return groups[0]


def _assert_bit_equal(out, kind, res, ref, tag):
    a = np.load(out / f"{kind}_{tag}.npz")
    b = np.load(out / f"{kind}_1.npz")
    assert np.array_equal(a["t"], b["t"]), tag
    assert np.array_equal(a["mut_t"], b["mut_t"]), tag
    assert res["log_G"] == ref["log_G"], (tag, res, ref)
    assert res["topology_proposed"] == ref["topology_proposed"], tag
    assert res == ref, (tag, res, ref)


@pytest.mark.parametrize("D", [2, 4])
def test_mesh_run_matches_single_process_run(D, out, single, groups):
    """The blocking driver over D gloo ranks, P=8 (each rank sweeps 8/D
    parts), with bursts and repartitions: on every rank, t, mut_t, log_G
    and topology_proposed equal the single-process run's (==).  The four
    ranks join through DELPHY_TPU_DISTRIBUTED=1 and torchrun's variables."""
    ref = single["blocking"]
    assert ref["bursts"] >= 1 and ref["repartitions"] >= 1
    ranks = groups[1][D]
    assert [r["rank"] for r in ranks] == list(range(D))
    for r in ranks:
        _assert_bit_equal(out, "blocking", r["blocking"], ref,
                          f"D{D}_r{r['rank']}")


def test_mesh_overlap_matches_single_process(out, single, group2):
    """Overlapped cycles (DELPHY_TPU_OVERLAP=1, P=16, D=2: each rank sweeps
    half of each L-dispatch's selection) equal the single-process cycles."""
    ref = single["overlap"]
    assert ref["bursts"] == 3 and ref["parts"] == 16
    for r in group2:
        _assert_bit_equal(out, "overlap", r["overlap"], ref,
                          f"D2_r{r['rank']}")


def test_mesh_through_buffers_matches_single_process(out, single, group2):
    """The overlapped cycles of test_mesh_overlap_matches_single_process
    again, every G, L and blocking dispatch of each rank through the
    static buffers of its graph cache (the mesh's size and rank in the
    key, the selection an input, the reassembly all-reduce warmed up once
    before each graph with a sweep): on each rank equal to the
    single-process eager cycles bit for bit, G's graph and L's captured
    and replayed."""
    ref = single["overlap"]
    for r in group2:
        got = dict(r["overlap_buffers"])
        captures, replays = got.pop("captures"), got.pop("replays")
        assert 0 in captures and any(nb > 0 for nb in captures)
        assert replays > len(captures)
        ta = np.load(out / f"overlap_buffers_D2_r{r['rank']}.npz")
        tb = np.load(out / "overlap_1.npz")
        assert np.array_equal(ta["t"], tb["t"])
        assert np.array_equal(ta["mut_t"], tb["mut_t"])
        assert got == ref, (got, ref)
    assert group2[0]["overlap_buffers"] == group2[1]["overlap_buffers"]


def test_mesh_overlap_rounds_selection_width(out, group2):
    """An overlapped run on P=10 parts over 2 ranks: half the part axis, 5
    rows, does not shard, so the selection is 4 rows wide, the JAX mesh
    run's rounding (delphy_tpu/run.py:485-487); the run steps, its ledger is
    green at 1e-6 on both ranks, and the ranks agree bit for bit."""
    a, b = (r["overlap_odd"] for r in group2)
    assert a["parts"] == 10 and a["width"] == 4 and a["bursts"] == 3
    assert a == b
    za, zb = (np.load(out / f"overlap_odd_D2_r{r}.npz") for r in (0, 1))
    assert np.array_equal(za["t"], zb["t"])
    assert np.array_equal(za["mut_t"], zb["mut_t"])


def test_mesh_reassembly_matches_jax_psum(out, jax_deltas, group2):
    """The port's one all-reduce against the JAX package's scatter_deltas
    under shard_map with psum on the 8-device CPU mesh: dt and dmut equal,
    the dG and dC totals within 1e-12 (JAX sums per shard first)."""
    jpm, d = jax_deltas
    mesh8 = Mesh(np.array(jax.devices()[:8]), axis_names=("part",))
    N, M = d["N"], d["M"]

    def body(pm_s, dt_p, dmut_p, dG_p, dC_p):
        dt, dmut = jsweep.scatter_deltas(pm_s, N, M, dt_p, dmut_p)
        return tuple(jax.lax.psum(x, "part") for x in
                     (dt, dmut, jnp.sum(dG_p), jnp.sum(dC_p)))

    spec = PartitionSpec("part")
    want = shard_map(
        body, mesh=mesh8,
        in_specs=(jax.tree.map(lambda _: spec, jpm), spec, spec, spec, spec),
        out_specs=(PartitionSpec(),) * 4)(
        jpm, *(jnp.asarray(d[k]) for k in
               ("dt_p", "dmut_p", "dG_p", "dC_p")))
    want = [np.asarray(x) for x in want]
    for r in range(2):
        got = np.load(out / f"reassembled_D2_r{r}.npz")
        assert np.max(np.abs(got["dt"] - want[0])) == 0.0
        assert np.max(np.abs(got["dmut"] - want[1])) == 0.0
        assert abs(float(got["dG"]) - float(want[2])) <= 1e-12
        assert abs(float(got["dC"]) - float(want[3])) <= 1e-12
        assert float(got["cnt"]) == float(d["cnt_p"].sum())
    assert np.count_nonzero(want[0]) > 0


@pytest.mark.parametrize("D", [2, 3])
def test_mesh_partition_padding_matches_jax(D, monkeypatch):
    """The part count and the padded part axis of a run on a mesh of D
    equal the JAX Run's under Mesh(devs[:D]), with a part cap that makes
    the oversized-part splitter raise the part count (no process group:
    Run reads only the mesh's size and device while it is built)."""
    monkeypatch.setenv("DELPHY_TPU_PART_CAP", "32")
    ref, deltas, miss, dates, names, _ = j_simulate_dataset(
        96, 300, mu=2e-3, seed=41)
    tree = j_build_random_tree(ref, deltas, miss, dates, names=names,
                               rng=np.random.default_rng(41))
    kw = dict(seed=43, num_cells=64, device_partitions=5,
              topology_moves_enabled=False)
    jrun = JRun(tree, mesh=Mesh(np.array(jax.devices()[:D]),
                                axis_names=("part",)), **kw)
    run = Run(tree, device="cpu", mesh=PartMesh(
        size=D, rank=0, group=None, device=torch.device("cpu")), **kw)
    assert run.device_partitions == jrun.device_partitions
    assert run.pm.node_map.shape[0] == jrun.pm.node_map.shape[0]
    assert run.pm.node_map.shape[0] > run.device_partitions   # splitter
    assert run.pm.node_map.shape[0] % D == 0


def _write_maple(path):
    from delphy_tpu_torch.dates import to_iso_date
    from delphy_tpu_torch.io.fasta import TipData
    from delphy_tpu_torch.io.maple import write_maple
    from delphy_tpu_torch.sim import simulate_dataset
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        24, 150, mu=2e-3, missing_fraction=0.02, seed=11)
    write_maple(path, "ref", ref, [
        TipData(name=f"s{i}|{to_iso_date(dates[i][0])}", t_min=dates[i][0],
                t_max=dates[i][1], deltas=deltas[i], miss_intervals=miss[i])
        for i in range(24)])


def test_cli_mesh_end_to_end(tmp_path, capsys):
    """``--device cpu --mesh-devices 2`` starts two ranks; rank 0 alone
    writes and prints, and its .log and .trees are byte-equal to
    ``--mesh-devices 1``'s (run in this process).  24 tips give two device
    parts by default, so both runs sweep the same parts (a mesh pads the
    part count to a multiple of its ranks)."""
    from delphy_tpu_torch import cli
    mp = tmp_path / "in.maple"
    _write_maple(mp)
    files, stderr = {}, {}
    for n in (1, 2):
        d = tmp_path / f"m{n}"
        d.mkdir()
        argv = ["--device", "cpu", "--mesh-devices", str(n),
                "--v0-in-maple", str(mp), "--v0-steps", "2000",
                "--v0-log-every", "500", "--v0-tree-every", "1000",
                "--v0-delphy-snapshot-every", "500", "--v0-seed", "13",
                "--v0-paranoid", "--v0-out-log-file", str(d / "out.log"),
                "--v0-out-trees-file", str(d / "out.trees")]
        if n == 1:
            assert cli.main(argv) == 0
            stderr[n] = capsys.readouterr().err
        else:
            r = subprocess.run(
                [sys.executable, "-m", "delphy_tpu_torch.cli", *argv],
                capture_output=True, text=True, timeout=TIMEOUT,
                env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
                cwd=str(tmp_path))
            assert r.returncode == 0, r.stderr[-4000:]
            stderr[n] = r.stderr
        assert sorted(os.listdir(d)) == ["out.log", "out.trees"]
        files[n] = [(d / f).read_bytes() for f in ("out.log", "out.trees")]
        assert stderr[n].count("Read 24 tips") == 1     # rank 0 alone prints
    assert "Sharding partitioned sweeps over 2 ranks" in stderr[2]
    assert files[2] == files[1]
    assert stderr[2].count(" log_post ") == stderr[1].count(" log_post ") == 4
    assert len(files[1][0].splitlines()) == 5        # header + 4 rows


def test_env_contract_two_processes(group2):
    """Two processes under DELPHY_TPU_COORDINATOR/_NUM_PROCESSES/
    _PROCESS_ID form one mesh (and refuse a smaller one); each run's ledger
    was green at 1e-6 on both ranks (the rank script checks it), and the
    ranks agree."""
    assert [(r["rank"], r["size"]) for r in group2] == [(0, 2), (1, 2)]
    assert all("2 ranks were started for a mesh of at most 1"
               == r["smaller_mesh"] for r in group2)
    for kind in ("blocking", "overlap"):
        assert group2[0][kind] == group2[1][kind]
        assert group2[0][kind]["topology_proposed"] > 0


def test_mesh_snapshot_resumes_on_every_rank(group2):
    """A snapshot that rank 0 wrote under the mesh resumes on both ranks
    (``load_run(path, mesh=...)``) bit-equal to the run that never
    stopped."""
    assert [r["resumed"] for r in group2] == [True, True]


def test_replica_check_catches_divergence(group2):
    """A rank whose t was perturbed: check_derived_quantities raises on
    every rank and names the sum of t."""
    for r in group2:
        msg = r["replica_check"]
        assert msg is not None, f"rank {r['rank']} did not raise"
        assert "disagree on sum of t" in msg, msg

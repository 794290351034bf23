"""The port imports no jax and nothing of the JAX package: a static scan of
its sources (function-level imports included), a CPU boundary plus a native
topology burst in a process where jax cannot be imported, the entry points
run as ``python -m`` with jax (and ``flatbuffers``) blocked, and a check that
importing every module of the port loads no ``delphy_tpu`` module even where
jax is importable."""

import ast
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "delphy_tpu_torch")


def _py_files():
    for dirpath, dirs, files in os.walk(PKG):
        # _build/ holds generated build output, not the port's sources
        dirs[:] = [d for d in dirs if d != "_build"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _foreign(name: str) -> bool:
    return any(name == p or name.startswith(p + ".")
               for p in ("jax", "delphy_tpu"))


def _foreign_imports(source: str, path: str = "<src>") -> list:
    """Absolute imports of jax or the JAX package anywhere in ``source``:
    ``ast.walk`` visits function and class bodies too."""
    found = []
    for node in ast.walk(ast.parse(source, path)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif (isinstance(node, ast.ImportFrom) and node.module
              and node.level == 0):
            names = [node.module]
        found += [n for n in names if _foreign(n)]
    return found


def test_no_jax_import_in_port_sources():
    # the scan sees an import inside a function, as cli.py and server.py
    # make theirs
    assert _foreign_imports(textwrap.dedent("""
        def main():
            if True:
                from delphy_tpu import pop as popm
                import jax.numpy as jnp
            from .pop import x
    """)) == ["delphy_tpu", "jax.numpy"]
    offenders = []
    # chip_smoke.py and the port's scripts it runs on the card
    files = list(_py_files()) + [
        os.path.join(REPO, "chip_smoke.py"),
        os.path.join(REPO, "scripts", "torch_f32_study.py"),
        os.path.join(REPO, "scripts", "torch_topo_dev_bench.py"),
        os.path.join(REPO, "scripts", "torch_validate_recovery.py"),
        os.path.join(REPO, "scripts", "torch_ess_at_scale.py")]
    rel = {os.path.relpath(f, PKG) for f in files}
    assert {"cli.py", "server.py", "ui.py", "tools.py", "probers.py",
            "sim.py", "mcc.py", "ess.py", "version.py",
            os.path.join("io", "snapshot.py"), os.path.join("io", "dphy.py"),
            os.path.join("io", "newick.py"),
            os.path.join("io", "beast_out.py"),
            os.path.join("io", "beast_xml.py"),
            os.path.join("parallel", "distributed.py"),
            os.path.join("ops", "spr_miss.py")} <= rel
    for path in files:
        for n in _foreign_imports(open(path).read(), path):
            offenders.append((os.path.relpath(path, REPO), n))
    assert not offenders, offenders


def _run(code: str):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


_LOADED = """
        def foreign_modules():
            return [m for m, v in sys.modules.items() if v is not None and any(
                m == p or m.startswith(p + ".") for p in ("jax", "delphy_tpu"))]
"""


def test_boundary_runs_with_jax_blocked():
    res = _run(_LOADED + """
        import sys
        sys.modules["jax"] = None          # as on a host without jax
        import numpy as np, torch
        from delphy_tpu_torch.io.maple import read_maple
        from delphy_tpu_torch.init_tree import build_initial_tree
        from delphy_tpu_torch.run import Run
        from delphy_tpu_torch.parallel.sweep import parts_multi_super_step
        mf = read_maple("data/ebola2014_like_81x18959.maple")
        tips = mf.tips[:30]
        tree = build_initial_tree(
            mf.ref_seq, [t.deltas for t in tips],
            [t.miss_intervals for t in tips],
            [(t.t_min, t.t_max) for t in tips],
            names=[t.name for t in tips], rng=np.random.default_rng(42))
        run = Run(tree, seed=1, num_cells=128, device="cpu")
        out = parts_multi_super_step(
            run.ts, run.evo, run.pop, run.gen, run.tin, run.tout, run.pm, 4,
            run.t_max_tip, run.hyp, run.num_cells, 1)
        run.ts, run.evo, run.pop, run.ledger = out[:4]
        run._fused_bundle = out[5]
        run.check_derived_quantities(1e-6)
        run._topology_burst(200)           # one native topology burst
        assert run.burst_count == 1 and run.topology_proposed > 0
        run.check_derived_quantities(1e-6)
        run.tree().check_integrity()
        assert int(out[4]["local_moves_attempted"]) > 0
        assert not foreign_modules(), foreign_modules()
        print("OK")
    """)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("OK")


def _run_module(module: str, argv: list, blocked=("jax",)):
    """``python -m module argv`` in a process where ``blocked`` cannot be
    imported; the process also fails if it loaded a foreign module."""
    return _run(_LOADED + f"""
        import runpy, sys
        for name in {tuple(blocked)!r}:
            sys.modules[name] = None
        sys.argv = [{module!r}] + {list(argv)!r}
        try:
            runpy.run_module({module!r}, run_name="__main__")
        except SystemExit as e:
            assert not e.code, e.code
        assert not foreign_modules(), foreign_modules()
        print("OK")
    """)


def test_cli_runs_as_a_module_with_jax_blocked(tmp_path):
    log = tmp_path / "o.log"
    res = _run_module("delphy_tpu_torch.cli", [
        "--v0-in-maple", "data/ebola2014_like_81x18959.maple", "--device",
        "cpu", "--v0-seed", "1", "--v0-steps", "24150", "--v0-log-every",
        "8050", "--v0-tree-every", "8050", "--v0-delphy-snapshot-every",
        "8050", "--v0-out-log-file", str(log), "--v0-paranoid"])
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("OK")
    assert "Read 81 tips, 18959 sites" in res.stderr
    lines = log.read_text().splitlines()     # 3 boundaries of 8,050 moves
    assert [ln.split("\t")[0] for ln in lines] \
        == ["Sample", "8050", "16100", "24150"]


def test_entry_points_start_without_jax_and_flatbuffers():
    res = _run_module("delphy_tpu_torch.cli", ["--version"],
                      blocked=("jax", "flatbuffers"))
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split() == ["delphy-tpu-torch", "0.1.0", "OK"]
    res = _run_module("delphy_tpu_torch.server", ["--help"],
                      blocked=("jax", "flatbuffers"))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "--device" in res.stdout and res.stdout.strip().endswith("OK")


def test_port_loads_no_delphy_tpu_module():
    res = _run(_LOADED + """
        import importlib, os, pkgutil, sys
        import delphy_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            delphy_tpu_torch.__path__, "delphy_tpu_torch.")]
        assert len(names) > 20, names
        for name in names:
            importlib.import_module(name)
        assert not foreign_modules(), foreign_modules()
        print("OK")
    """)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("OK")

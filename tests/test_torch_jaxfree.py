"""The port imports no jax and nothing of the JAX package: a static scan of
its sources, a CPU boundary plus a native topology burst in a process where
jax cannot be imported, and a check that importing every module of the port
loads no ``delphy_tpu`` module even where jax is importable."""

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


def test_no_jax_import_in_port_sources():
    offenders = []
    files = list(_py_files()) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 10
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif (isinstance(node, ast.ImportFrom) and node.module
                  and node.level == 0):
                names = [node.module]
            for n in names:
                if _foreign(n):
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

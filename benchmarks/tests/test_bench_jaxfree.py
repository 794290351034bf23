"""Nothing the benchmark runs imports JAX or the JAX package: a scan of
every module under ``benchmarks/``, top-level module names compared whole
(the port's name begins with the JAX package's), and ``sys.modules`` after
a CPU dry run of the harness in a process of its own."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmarks import run as br

JAX = {"jax", "jaxlib", "flax", "delphy_tpu"}
PORT = "delphy_tpu_torch"
# the reference and the frozen yardstick take nothing from the program
NO_PORT = ("reference", "frozen", "metrics")


def imported(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def modules():
    for d, _, files in os.walk(br.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    bad = {p: sorted(imported(p) & JAX) for p in modules()}
    assert not {p: v for p, v in bad.items() if v}
    assert len(bad) >= 20


def test_the_yardstick_imports_nothing_of_the_port():
    for p in modules():
        rel = os.path.relpath(p, br.HERE).split(os.sep)
        if rel[0] in NO_PORT:
            assert PORT not in imported(p), p


def test_the_scan_sees_a_whole_top_level_name(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import delphy_tpu_torch.run\nfrom delphy_tpu.run import Run"
                 "\nimport jax.numpy as jnp\n")
    assert imported(str(p)) & JAX == {"delphy_tpu", "jax"}


DRY_RUN = """
import json, sys
from benchmarks import run as br
from benchmarks.tests.tiny import tiny_run
res = tiny_run("ebola81-exp", seconds=0.2)
print(json.dumps({"correct": res["correct"],
                  "forbidden": br.loaded_forbidden(),
                  "port": "delphy_tpu_torch" in sys.modules}))
"""


def test_a_dry_run_loads_no_jax():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    out = subprocess.run([sys.executable, "-c", DRY_RUN], cwd=br.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "forbidden": [], "port": True}

"""The port's command line (delphy_tpu_torch/cli.py) against the JAX
package's (delphy_tpu/cli.py), in-process on the CPU.

Both parsers must have the same flags and defaults (``--mesh-devices`` there,
``--device`` here, apart); the same flag sets must give the same
``PriorConfig`` and the same initial mu, n0, g and min_pop (compared with
``==``: the arithmetic is the same Python); every ``_CliError`` of the flag
checks must carry the same message; the skygrid, alpha and mpox flags run
and write the .log header the JAX CLI writes for them; and the main loop
writes a .log with the reference's header, a .trees file that reads back,
an MCC tree and a snapshot that resumes exactly.
"""

import dataclasses
import io
import math

import numpy as np
import pytest

from delphy_tpu import cli as jcli
from delphy_tpu import run as jrun_mod
from delphy_tpu.io import beast_out as jbeast_out

from delphy_tpu_torch import cli, version
from delphy_tpu_torch import run as run_mod
from delphy_tpu_torch.dates import to_iso_date
from delphy_tpu_torch.io.fasta import TipData
from delphy_tpu_torch.io.maple import write_maple
from delphy_tpu_torch.io.newick import read_beast_trees
from delphy_tpu_torch.io.snapshot import load_run
from delphy_tpu_torch.sim import simulate_dataset


@pytest.fixture(scope="module")
def maple(tmp_path_factory):
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        12, 150, mu=2e-3, missing_fraction=0.02, seed=11)
    tips = [TipData(name=f"s{i}|{to_iso_date(dates[i][0])}",
                    t_min=dates[i][0], t_max=dates[i][1], deltas=deltas[i],
                    miss_intervals=miss[i]) for i in range(12)]
    path = tmp_path_factory.mktemp("cli") / "in.maple"
    write_maple(str(path), "ref", ref, tips)
    return str(path)


def _actions(parser):
    return {a.option_strings[0]: (type(a).__name__, a.default, a.type,
                                  tuple(a.choices) if a.choices else None,
                                  a.nargs, a.metavar)
            for a in parser._actions if a.option_strings}


def test_parsers_have_the_same_flags_and_defaults():
    got, want = _actions(cli.build_parser()), _actions(jcli.build_parser())
    assert got.pop("--device")[1] == "cuda"
    assert want.pop("--mesh-devices")
    assert got.keys() == want.keys()
    for flag in want:
        assert got[flag] == want[flag], flag
    assert len(want) > 60


def _spy(monkeypatch, module):
    """Make ``module.Run`` record the run each CLI builds."""
    seen = []

    class Spy(module.Run):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self)
    monkeypatch.setattr(module, "Run", Spy)
    return seen


FLAG_SETS = [
    [],
    ["--v0-init-mutation-rate", "1.2e-3", "--v0-fix-mutation-rate",
     "--v0-init-final-pop-size", "2.5", "--v0-init-pop-growth-rate", "0.7",
     "--v0-pop-min-pop", "0.01", "--v0-threads", "3"],
    ["--v0-mu-prior-mean", "1e-3", "--v0-mu-prior-stddev", "2e-4",
     "--v0-pop-n0-prior-mean", "3.0", "--v0-pop-n0-prior-stddev", "1.5"],
    ["--v0-mu-prior-alpha", "2.0", "--v0-mu-prior-beta", "1000.0",
     "--v0-pop-inv-n0-prior-alpha", "3.0", "--v0-pop-inv-n0-prior-beta",
     "4.0", "--v0-fix-final-pop-size"],
    ["--v0-pop-g-prior-exponential-with-mean", "2.0"],
    ["--v0-pop-g-prior-exponential-with-mean", "-0.5",
     "--v0-fix-pop-growth-rate"],
    ["--v0-pop-g-prior-mu", "1.0", "--v0-pop-g-prior-scale", "3.0",
     "--v0-pop-growth-rate-min", "-2.0", "--v0-pop-growth-rate-max", "5.0"],
    ["--v0-pop-growth-rate-min", "0.00099", "--v0-pop-growth-rate-max",
     "0.00101", "--v0-init", "random", "--v0-target-coal-prior-cells", "10"],
]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=range(len(FLAG_SETS)))
def test_same_flags_give_the_same_priors_and_initial_state(
        maple, tmp_path, monkeypatch, flags):
    """Both CLIs run up to the BEAST XML export (before any step); the runs
    they built must hold the same hyperparameters and initial parameters,
    and write the same XML."""
    seen, jseen = _spy(monkeypatch, run_mod), _spy(monkeypatch, jrun_mod)
    base = ["--v0-in-maple", maple, "--v0-seed", "3"] + flags
    assert cli.main(base + ["--device", "cpu", "--v0-out-beast-xml",
                            str(tmp_path / "a.xml")]) == 0
    assert jcli.main(base + ["--mesh-devices", "1", "--v0-out-beast-xml",
                             str(tmp_path / "b.xml")]) == 0
    (run,), (jrun,) = seen, jseen
    assert dataclasses.asdict(run.hyp) == dataclasses.asdict(jrun.hyp)
    for obj, jobj, fields in ((run.evo, jrun.evo, ("mu", "kappa", "alpha")),
                              (run.pop, jrun.pop,
                               ("t0", "n0", "g", "min_pop"))):
        for f in fields:
            assert float(getattr(obj, f)) == float(getattr(jobj, f)), f
    assert run.num_cells == jrun.num_cells
    assert run.topology_partitions == jrun.topology_partitions
    assert run.device.type == "cpu"
    np.testing.assert_array_equal(run.ts.parent.numpy(),
                                  np.asarray(jrun.ts.parent))
    assert (tmp_path / "a.xml").read_text() == (tmp_path / "b.xml").read_text()


CLI_ERRORS = [
    ["--v0-init", "random", "--v0-init-random"],
    ["--v0-init-heuristic", "--v0-init-random"],
    ["--v0-pop-model", "skygrid", "--v0-init-final-pop-size", "1.0"],
    ["--v0-pop-model", "skygrid", "--v0-pop-growth-rate-max", "1.0"],
    ["--v0-pop-inv-n0-prior-alpha", "2.0", "--v0-pop-n0-prior-mean", "1.0"],
    ["--v0-pop-n0-prior-mean", "1.0"],
    ["--v0-pop-n0-prior-stddev", "1.0"],
    ["--v0-pop-n0-prior-mean", "-1.0", "--v0-pop-n0-prior-stddev", "1.0"],
    ["--v0-pop-n0-prior-mean", "1.0", "--v0-pop-n0-prior-stddev", "0.0"],
    ["--v0-pop-inv-n0-prior-alpha", "-1.0"],
    ["--v0-pop-inv-n0-prior-beta", "-1.0"],
    ["--v0-pop-g-prior-exponential-with-mean", "1.0",
     "--v0-pop-g-prior-mu", "0.0"],
    ["--v0-pop-g-prior-exponential-with-mean", "1.0",
     "--v0-pop-growth-rate-min", "0.0"],
    ["--v0-pop-g-prior-exponential-with-mean", "0.0"],
    ["--v0-pop-growth-rate-min", "2.0", "--v0-pop-growth-rate-max", "1.0"],
]


@pytest.mark.parametrize("flags", CLI_ERRORS, ids=range(len(CLI_ERRORS)))
def test_flag_errors_carry_the_same_message(maple, flags):
    argv = ["--v0-in-maple", maple] + flags
    with pytest.raises(cli._CliError) as got:
        cli._main(cli.build_parser().parse_args(argv + ["--device", "cpu"]))
    with pytest.raises(jcli._CliError) as want:
        jcli._main(jcli.build_parser().parse_args(argv))
    assert str(got.value) == str(want.value) and len(str(got.value)) > 20


@pytest.mark.parametrize("flags", [
    ["--v0-pop-model", "skygrid"],
    ["--v0-pop-model", "skygrid", "--v0-skygrid-num-parameters", "10",
     "--v0-skygrid-tau", "2.0"],
    ["--v0-site-rate-heterogeneity"],
    ["--v0-mpox-hack"]], ids=range(4))
def test_unported_models_end_in_the_not_ported_error(maple, tmp_path,
                                                     monkeypatch, flags):
    """These model flags once ended in a "not ported" error; now each set
    runs on the CPU with --v0-paranoid and writes a .log whose header is the
    one the JAX CLI writes for the same flags (its BeastLogOutput, built as
    its _main builds it), with finite rows, and the run holds the model."""
    seen = _spy(monkeypatch, run_mod)
    log = tmp_path / "o.log"
    assert cli.main(["--v0-in-maple", maple, "--device", "cpu",
                     "--v0-steps", "900", "--v0-log-every", "300",
                     "--v0-tree-every", "300",
                     "--v0-delphy-snapshot-every", "900", "--v0-paranoid",
                     "--v0-out-log-file", str(log)] + flags) == 0
    (run,) = seen
    args = jcli.build_parser().parse_args(["--v0-in-maple", maple] + flags)
    want = io.StringIO()
    jbeast_out.BeastLogOutput(
        want, mu_move_enabled=not args.v0_fix_mutation_rate,
        alpha_move_enabled=args.v0_site_rate_heterogeneity).write_headers(
        run.tree())
    rows = log.read_text().splitlines()
    assert rows[0] == want.getvalue().rstrip("\n")
    assert len(rows) == 4
    assert all(math.isfinite(float(v)) for r in rows[1:]
               for v in r.split("\t"))
    assert run.step == 900
    run.check_derived_quantities(1e-6)
    if "skygrid" in flags:
        assert run.pop.gamma.shape[0] == int(
            flags[flags.index("--v0-skygrid-num-parameters") + 1]
            if "--v0-skygrid-num-parameters" in flags else 50)
    assert run.hyp.alpha_move_enabled == ("--v0-site-rate-heterogeneity"
                                          in flags)
    assert run.mpox_hack == ("--v0-mpox-hack" in flags)


def test_input_errors_and_version(maple, tmp_path, capsys):
    assert cli.main(["--version"]) == 0
    assert capsys.readouterr().out.strip() \
        == f"delphy-tpu-torch {version.__version__}"
    assert cli.main(["--device", "cpu"]) == 1
    assert "provide --v0-in-fasta or --v0-in-maple" in capsys.readouterr().err
    empty = tmp_path / "empty.fasta"
    empty.write_text("")
    assert cli.main(["--v0-in-fasta", str(empty), "--device", "cpu"]) == 1
    assert "empty FASTA" in capsys.readouterr().err


def test_cli_defaults_to_cuda(maple):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--v0-in-maple", maple, "--v0-steps", "100"])


def test_truncated_laplace_mean_equal():
    for args in [(0.0, 1.0, -math.inf, math.inf), (0.1, 2.0, -math.inf, 3.0),
                 (0.1, 2.0, -1.0, math.inf), (0.5, 1.0, 0.49999, 0.50001),
                 (0.2, 0.7, -1.0, 4.0)]:
        assert cli.truncated_laplace_mean(*args) \
            == jcli.truncated_laplace_mean(*args)


@pytest.fixture(scope="module")
def cli_run(maple, tmp_path_factory):
    """One in-process run of the main loop with every output on."""
    out = tmp_path_factory.mktemp("out")
    argv = ["--v0-in-maple", maple, "--device", "cpu", "--v0-seed", "7",
            "--v0-steps", "6000", "--v0-log-every", "1000",
            "--v0-tree-every", "1000", "--v0-delphy-snapshot-every", "3000",
            "--v0-target-coal-prior-cells", "64", "--v0-paranoid",
            "--v0-out-log-file", str(out / "o.log"),
            "--v0-out-trees-file", str(out / "o.trees"),
            "--v0-out-mcc-file", str(out / "o.mcc"),
            "--v0-out-delphy-file", str(out / "o.npz")]
    with pytest.MonkeyPatch.context() as mp:
        seen = _spy(mp, run_mod)
        assert cli.main(argv) == 0
    return out, seen[0]


def test_main_loop_writes_log_trees_and_mcc(cli_run, maple):
    out, _ = cli_run
    lines = (out / "o.log").read_text().splitlines()
    assert lines[0].split("\t") == [
        "Sample", "posterior", "likelihood_really_logG", "prior_for_Delphy",
        "treeLikelihood_really_logG", "TreeHeight", "clockRate", "kappa",
        "Coalescent", "ePopSize", "growthRate", "freqParameter.1",
        "freqParameter.2", "freqParameter.3", "freqParameter.4"]
    assert [ln.split("\t")[0] for ln in lines[1:]] \
        == [str(1000 * i) for i in range(1, 7)]
    vals = np.array([[float(v) for v in ln.split("\t")] for ln in lines[1:]])
    assert np.all(np.isfinite(vals))
    trees = read_beast_trees(out / "o.trees", np.zeros(150, np.int8))
    assert len(trees) == 6 and all(t.num_tips == 12 for _, t in trees)
    assert "tree MCC =" in (out / "o.mcc").read_text()


def test_snapshot_from_the_cli_resumes_exactly(cli_run):
    """The snapshot the CLI wrote at its last step, loaded, and the CLI's own
    run that never stopped reach the same state after the same further
    steps (``==``)."""
    out, run = cli_run
    loaded = load_run(out / "o.npz", device="cpu")
    assert loaded.step == run.step == 6000
    run.do_mcmc_steps(1500)
    loaded.do_mcmc_steps(1500)
    assert run.log_posterior == loaded.log_posterior
    loaded.check_derived_quantities(1e-6)


def test_cli_writes_a_dphy_stream(maple, tmp_path):
    from delphy_tpu.io.dphy import read_dphy
    meta = tmp_path / "meta.json"
    meta.write_text('{"burnin": 3}')
    path = tmp_path / "o.dphy"
    assert cli.main(["--v0-in-maple", maple, "--device", "cpu",
                     "--v0-steps", "2000", "--v0-delphy-snapshot-every",
                     "1000", "--v0-target-coal-prior-cells", "64",
                     "--v0-out-delphy-file", str(path),
                     "--v0-out-delphy-metadata-file", str(meta)]) == 0
    df = read_dphy(path)
    assert len(df.samples) == 2 and df.preamble["steps_per_sample"] == 1000
    assert df.preamble["metadata_json"] == {"burnin": 3}
    assert [p["step"] for _, p in df.samples] == [1000, 2000]


def test_cli_without_flatbuffers_fails_only_for_dphy(maple, tmp_path,
                                                     monkeypatch, capsys):
    import sys
    monkeypatch.setitem(sys.modules, "flatbuffers", None)
    path = tmp_path / "o.dphy"
    assert cli.main(["--v0-in-maple", maple, "--device", "cpu",
                     "--v0-steps", "400", "--v0-out-delphy-file",
                     str(path)]) == 1
    assert "flatbuffers" in capsys.readouterr().err and not path.exists()
    assert cli.main(["--v0-in-maple", maple, "--device", "cpu",
                     "--v0-steps", "400", "--v0-target-coal-prior-cells",
                     "64", "--v0-out-delphy-file",
                     str(tmp_path / "o.npz")]) == 0

"""The port's last nine benchmarks (`repro_torch.benchmarks.fig4_timeline`,
`fig5_costs`, `multicloud`, `preemption_realism`, `preemption_sweep`,
`accounting_bench`, `scaling`, `roofline_report`, `run`) and its
preemption example against the JAX package's, on the CPU: rendered
output byte for byte, dollars to 1e-9, the same flags, and the JAX
package's committed output (`tests/torch_expected/benchmarks/`) that the
card's machine, which has no JAX, holds the port to. Nothing here writes
the root `BENCH_scaling.json`."""
import contextlib
import importlib
import io
import json
import re
import runpy
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from benchmarks import fig4_timeline as ref_fig4
from benchmarks import fig5_costs as ref_fig5
from benchmarks import multicloud as ref_multicloud
from benchmarks import preemption_realism as ref_realism
from benchmarks import preemption_sweep as ref_sweep
from benchmarks import roofline_report as ref_roofline
from benchmarks import run as ref_run
from benchmarks import scaling as ref_scaling

from repro_torch.benchmarks import (accounting_bench, expected, fig4_timeline,
                                    fig5_costs, multicloud,
                                    preemption_realism, preemption_sweep,
                                    roofline_report, run, scaling)
from repro_torch.examples import preemption_and_budgets

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import torch_expected  # noqa: E402

GOLDEN_TRACES = sorted((REPO / "tests" / "golden").glob("*.events.jsonl"))
PRICES = REPO / "tests" / "fixtures" / "prices"
REWRITE = "PYTHONPATH=src python3 tools/torch_expected.py"

assert len(GOLDEN_TRACES) == 6


def _stdout(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


def _exit_message(fn, *args):
    with pytest.raises(SystemExit) as e:
        _stdout(fn, *args)
    return e.value.code


# ---------------------------------------------------------------- fig4, fig5
RENDERS = {"fig4": (fig4_timeline, ref_fig4), "fig5": (fig5_costs, ref_fig5)}


@pytest.mark.parametrize("trace", GOLDEN_TRACES,
                         ids=[p.name.split(".")[0] for p in GOLDEN_TRACES])
@pytest.mark.parametrize("fig", sorted(RENDERS))
def test_replay_renders_byte_for_byte(fig, trace):
    port, ref = RENDERS[fig]
    argv = ["--replay", str(trace.relative_to(REPO))]
    got = _stdout(port.main, argv)
    assert got == _stdout(ref.main, argv)
    assert got.startswith("# ")


@pytest.mark.parametrize("fig", sorted(RENDERS))
def test_fresh_run_renders_byte_for_byte(fig):
    port, ref = RENDERS[fig]
    assert _stdout(port.main, []) == _stdout(ref.main, [])


def test_fig5_on_the_trace_market_renders_byte_for_byte():
    argv = ["--price-trace", str(PRICES), "--providers", "aws,gcp"]
    got = _stdout(fig5_costs.main, argv)
    assert got == _stdout(ref_fig5.main, argv)
    assert "(trace market: aws,gcp)" in got


@pytest.mark.parametrize("fig", sorted(RENDERS))
def test_truncated_log_is_the_same_one_line_error(fig, tmp_path):
    lines = GOLDEN_TRACES[0].read_text().splitlines(keepends=True)
    log = tmp_path / "cut.events.jsonl"
    half = len(lines) // 2
    log.write_text("".join(lines[:half]) + lines[half][:17])
    port, ref = RENDERS[fig]
    got = _exit_message(port.main, ["--replay", str(log)])
    assert isinstance(got, str) and got.startswith("error: ")
    assert "\n" not in got
    assert got == _exit_message(ref.main, ["--replay", str(log)])


# ---------------------------------------------------------------- multicloud
@pytest.mark.parametrize("argv", [[], ["--policy", "fedcostaware"],
                                  ["--policy", "spot", "--epochs", "2"]])
def test_multicloud_byte_for_byte(argv):
    got = _stdout(multicloud.main, argv)
    assert got == _stdout(ref_multicloud.main, argv)
    assert multicloud.DEFAULT_TRACE_DIR == PRICES


# ------------------------------------------------------- preemption realism
@pytest.mark.parametrize("kwargs", [{}, {"sensitivity": 0.0}])
def test_interruption_price_lift_is_equal(kwargs):
    got = preemption_realism.interruption_price_lift(**kwargs)
    assert got == ref_realism.interruption_price_lift(**kwargs)
    assert got["n_interruptions"] > 0


@pytest.mark.parametrize("model", ref_realism.MODELS)
def test_compare_modes_is_equal(model):
    got = preemption_realism.compare_modes(model=model)
    assert got == ref_realism.compare_modes(model=model)
    assert set(got) == set(ref_realism.MODES)


def test_preemption_realism_main_byte_for_byte():
    got = _stdout(preemption_realism.main, [])
    assert got == _stdout(ref_realism.main, [])
    assert preemption_realism.DEFAULT_TRACE_DIR == PRICES


def test_preemption_sweep_main_byte_for_byte():
    got = _stdout(preemption_sweep.main)
    assert got == _stdout(ref_sweep.main)
    assert got.count(",True\n") == 8


# --------------------------------------------------------- accounting bench
def test_accounting_bench_asserts_pass_and_its_lines_equal():
    """Its own asserts (the accountant equals the scan and beats it)
    pass; every line but the timings equals the JAX package's."""
    got = _stdout(accounting_bench.main)
    assert expected.deterministic(got) == torch_expected.reference_output(
        "accounting_bench")
    assert "<s>" in expected.deterministic(got)


# ------------------------------------------------------------------ scaling
@pytest.mark.parametrize("n,cohort", [(100, None), (1_000, None),
                                      (10_000, None), (100_000, 10_000)])
def test_run_fleet_costs_are_equal(n, cohort):
    got = scaling.run_fleet(n, cohort_size=cohort)
    want = ref_scaling.run_fleet(n, cohort_size=cohort)
    assert got["cost"] == pytest.approx(want["cost"], abs=1e-9)
    for key in ("n_clients", "cohort_size", "path"):
        assert got[key] == want[key]


def test_run_per_object_cost_is_equal():
    got = scaling.run_per_object(100)
    want = ref_scaling.run_per_object(100)
    assert got["cost"] == pytest.approx(want["cost"], abs=1e-9)
    assert (got["path"], got["n_clients"]) == ("per_object", 100)


def test_savings_report_byte_for_byte():
    got = _stdout(scaling.savings_report)
    assert got == _stdout(ref_scaling.savings_report)


def _rows(report):
    """The report's rows and per-object row without wall and RSS."""
    drop = ("wall_s", "peak_rss_mb")
    rows = [{k: v for k, v in r.items() if k not in drop}
            for r in report["rows"] + [report["per_object"]]]
    meta = {k: v for k, v in report["meta"].items()
            if k not in ("python", "numpy", "speedup_at_per_object_n")}
    return rows, meta


def test_scaling_main_writes_the_reference_rows(tmp_path):
    argv = ["--sizes", "100,1000", "--per-object-at", "100", "--out"]
    assert scaling.main(argv + [str(tmp_path / "port.json")]) == 0
    with contextlib.redirect_stdout(io.StringIO()):
        assert ref_scaling.main(argv + [str(tmp_path / "ref.json")]) == 0
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "ref.json").read_text())
    (got_rows, got_meta), (want_rows, want_meta) = _rows(got), _rows(want)
    assert got_meta == want_meta
    assert len(got_rows) == len(want_rows) == 3
    for g, w in zip(got_rows, want_rows):
        assert g.pop("cost") == pytest.approx(w.pop("cost"), abs=1e-9)
        assert g == w


def test_scaling_default_out_is_under_build():
    out = scaling.DEFAULT_OUT
    assert out == REPO / "build" / "BENCH_scaling_torch.json"
    assert out != REPO / "BENCH_scaling.json"
    assert ref_scaling.DEFAULT_OUT == REPO / "BENCH_scaling.json"


@pytest.mark.slow
class TestScaling:
    """The fleet core's wall clock at cross-device scale, as the JAX
    package's `tests/test_fleet.py::TestScaling` holds its own."""

    def test_fleet_is_20x_faster_at_1e4(self):
        fleet = scaling.run_fleet(10_000, n_epochs=2, seed=0)
        obj = scaling.run_per_object(10_000, n_epochs=2, seed=0)
        assert obj["cost"] == pytest.approx(fleet["cost"], rel=0.05)
        assert obj["wall_s"] / fleet["wall_s"] >= 20.0

    def test_growth_is_near_linear_above_1e3(self):
        wall = {}
        for n in (1_000, 10_000):
            wall[n] = min(scaling.run_fleet(n, n_epochs=3, seed=0)["wall_s"]
                          for _ in range(2))
        assert wall[10_000] / wall[1_000] <= 15.0

    def test_100k_cohort_completes(self):
        row = scaling.run_fleet(100_000, n_epochs=2, seed=0,
                                cohort_size=10_000)
        assert row["cost"] > 0.0
        assert row["wall_s"] < 60.0


# ----------------------------------------------------------------- roofline
@pytest.fixture(scope="module")
def dry_records():
    """One record of each kind the port's dry run writes: a cell
    (`run_cell`), an FL round and an FL barrier (`_fl_record`), at a
    caller's peaks."""
    from repro_torch.launch import dryrun, mesh as M
    peaks = dict(peak_flops=989e12, hbm_bw=3.35e12)
    single = M.make_production_mesh(multi_pod=False)
    multi = M.make_production_mesh(multi_pod=True)
    cell = dryrun.run_cell("mamba2-1.3b", "decode_32k", single, "single",
                           verbose=False, **peaks)
    fl = dryrun.run_fl_round(single, "single", local_steps=1, verbose=False,
                             **peaks)
    agg = dryrun.run_fl_agg(multi, "multi", compressed=True, link_bw=100e9,
                            verbose=False, **peaks)
    return json.loads(json.dumps([cell, fl, agg]))


def test_roofline_report_prints_the_reference_rows(dry_records, tmp_path,
                                                   monkeypatch):
    cell, fl, agg = dry_records
    for suffix, recs in (("", [cell]), ("_fl", [fl]), ("_fl_comp", [agg])):
        (tmp_path / f"dryrun{suffix}.json").write_text(json.dumps(recs))
        (tmp_path / f"dryrun_torch{suffix}.json").write_text(json.dumps(recs))
    monkeypatch.setattr(ref_roofline, "RESULTS", str(tmp_path))
    monkeypatch.setattr(roofline_report, "RESULTS", str(tmp_path))
    got = _stdout(roofline_report.main).splitlines()
    want = _stdout(ref_roofline.main).splitlines()
    assert got[0] == roofline_report.NOTE and got[0].startswith("# ")
    assert got[1:] == want
    assert len(want) == 4


def test_roofline_report_note_and_paths(tmp_path, monkeypatch):
    assert Path(roofline_report.RESULTS) == REPO / "build"
    monkeypatch.setattr(roofline_report, "RESULTS", str(tmp_path))
    seen = []
    monkeypatch.setattr(roofline_report, "load",
                        lambda fname="dryrun_torch.json": seen.append(fname)
                        or [])
    text = _stdout(roofline_report.main)
    assert seen == ["dryrun_torch.json", "dryrun_torch_fl.json",
                    "dryrun_torch_fl_comp.json"]
    assert "python -m repro_torch.launch.dryrun" in text
    assert "--peak-flops" in text and "--device cuda" in text
    for words in ("WorkCounter", "one device", "bytes_accessed",
                  "model_flops", "compile_s", "meta count"):
        assert words in roofline_report.NOTE


# ------------------------------------------------------------- section driver
def _ref_run(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["run", *argv])
    return _stdout(ref_run.main)


@pytest.mark.parametrize("sections", [["fig4", "fig5", "preemption"],
                                      ["table1"]])
def test_run_sections_byte_for_byte(sections, monkeypatch):
    got = _stdout(run.main, sections)
    assert got == _ref_run(monkeypatch, sections)
    assert got.count("\n== ") == len(sections)


# ------------------------------------------------------------------ example
def test_example_prints_the_reference_script_s_output():
    got = _stdout(preemption_and_budgets.main)
    want = _stdout(runpy.run_path, str(REPO / "examples" /
                                       "preemption_and_budgets.py"))
    assert got == want
    assert got.startswith("rounds completed : 10/10\n")


# ------------------------------------------------------------- CLI parity
_FLAG = re.compile(r"(--[a-z][a-z0-9-]*)")
# every argparse script; run.py, roofline_report, preemption_sweep and
# accounting_bench take no flags in either package
ARGPARSE = ["fig4_timeline", "fig5_costs", "multicloud",
            "preemption_realism", "scaling"]


def _flags(module):
    mod = importlib.import_module(module)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        mod.main(["--help"])
    return set(_FLAG.findall(buf.getvalue()))


@pytest.mark.parametrize("script", ARGPARSE)
def test_help_advertises_the_same_flags(script):
    got = _flags(f"repro_torch.benchmarks.{script}")
    assert got == _flags(f"benchmarks.{script}")
    assert "--help" in got and len(got) > 1


# ------------------------------------------- committed outputs for the card
@pytest.mark.parametrize("stem", expected.STEMS)
def test_committed_output_is_the_reference_s(stem):
    """Each committed file is the JAX package's output of its run today;
    if the JAX package's output changed, rewrite the files with
    `PYTHONPATH=src python3 tools/torch_expected.py`."""
    assert torch_expected.reference_output(stem) == expected.expected(stem), \
        f"tests/torch_expected/benchmarks/{stem}.txt is stale: {REWRITE}"


@pytest.mark.parametrize("stem", expected.STEMS)
def test_port_output_equals_the_committed_file(stem, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    got = expected.deterministic(expected.capture(stem))
    assert got == expected.expected(stem)
    if stem == "scaling":
        assert (tmp_path / expected.SCALING_OUT).exists()

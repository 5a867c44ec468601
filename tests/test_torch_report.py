"""The port's cost report (`python -m repro_torch.cloud.report`) against
the JAX package's, on the CPU: every golden log's summary JSON byte for
byte, reconciliation with equal figures, tampered logs failing at the
same event, trends, budget screening at explicit peaks, the same error
for a corrupt log, and Table I's `--report` and `--price-trace` output.
The port's `validate` holds no hardware constant: roofline counts
without both peaks are a usage error."""
import contextlib
import dataclasses
import io
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from benchmarks import table1 as ref_table1
from repro.cloud import report as ref_report
from repro.common import config as ref_config
from repro.fl.runner import FLCloudRunner as RefRunner

from repro_torch.benchmarks import table1
from repro_torch.cloud import report
from repro_torch.common import config as port_config
from repro_torch.fl.runner import FLCloudRunner

GOLDEN_DIR = Path(__file__).parent / "golden"
GOLDEN_TRACES = sorted(GOLDEN_DIR.glob("*.events.jsonl"))
GOLDEN_IDS = [p.stem.replace(".events", "") for p in GOLDEN_TRACES]
FIXTURE_PRICES = Path(__file__).parent / "fixtures" / "prices"

assert len(GOLDEN_TRACES) == 6


def _cli(mod, argv):
    """Run a report CLI in-process: (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(argv)
    return rc, out.getvalue(), err.getvalue()


def _both(argv):
    got, want = _cli(report, argv), _cli(ref_report, argv)
    assert got == want
    return got


def _dumps(obj):
    return json.dumps(obj, sort_keys=True, indent=2)


@pytest.mark.parametrize("trace", GOLDEN_TRACES, ids=GOLDEN_IDS)
def test_summary_is_byte_identical(trace):
    got, want = report.summarize_path(trace), ref_report.summarize_path(
        trace)
    assert _dumps(got) == _dumps(want)
    assert report.render_summary(got) == ref_report.render_summary(want)
    rows = report.per_round_rows(trace)
    assert _dumps(rows) == _dumps(ref_report.per_round_rows(trace))
    assert report.render_per_round(trace.name, rows) == \
        ref_report.render_per_round(trace.name, rows)


@pytest.mark.parametrize("trace", GOLDEN_TRACES, ids=GOLDEN_IDS)
def test_reconcile_matches(trace):
    got, want = report.reconcile_path(trace), ref_report.reconcile_path(
        trace)
    assert got.ok and got.first_divergence is None
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert report.render_reconciliation(got, report.RECONCILE_TOL) == \
        ref_report.render_reconciliation(want, ref_report.RECONCILE_TOL)


@pytest.mark.parametrize("argv", [
    ["summary"] + [str(p) for p in GOLDEN_TRACES],
    ["summary", "--json"] + [str(p) for p in GOLDEN_TRACES],
    ["summary", "--per-round"] + [str(p) for p in GOLDEN_TRACES],
    ["trends", str(GOLDEN_DIR)],
    ["trends", "--json", str(GOLDEN_DIR)],
    ["reconcile"] + [str(p) for p in GOLDEN_TRACES],
], ids=["summary", "summary-json", "per-round", "trends", "trends-json",
        "reconcile"])
def test_cli_output_is_the_jax_packages(argv):
    rc, out, _ = _both(argv)
    assert rc == 0 and out.strip()


def test_trend_rows_match():
    got, want = report.trend_rows(GOLDEN_DIR), ref_report.trend_rows(
        GOLDEN_DIR)
    assert got == want and len(got) == len(GOLDEN_TRACES)
    assert report.render_trends(got) == ref_report.render_trends(want)


def _tamper(trace, path, ev_type, mutate):
    lines = Path(trace).read_text().splitlines()
    for i, ln in enumerate(lines[1:], start=1):
        rec = json.loads(ln)
        if rec.get("type") == ev_type and mutate(rec):
            lines[i] = json.dumps(rec)
            break
    path.write_text("\n".join(lines) + "\n")
    return path


def _bump_total(delta):
    def mutate(rec):
        rec["total_cost"] += delta
        return True
    return mutate


def _skim_fleet(rec):
    if not rec["client_cost_delta"]:
        return False
    rec["client_cost_delta"][sorted(rec["client_cost_delta"])[0]] += 0.25
    return True


@pytest.mark.parametrize("golden,ev_type,mutate,tol", [
    ("golden__spot", "RunCompleted", _bump_total(0.5), None),
    ("golden__fleet", "FleetStepSummary", _skim_fleet, None),
    ("golden__spot", "RunCompleted", _bump_total(1e-6), None),
    ("golden__spot", "RunCompleted", _bump_total(1e-6), "1e-3"),
], ids=["run-total", "fleet-attribution", "tiny", "tiny-at-wide-tol"])
def test_tampered_log_names_the_same_event(tmp_path, golden, ev_type,
                                           mutate, tol):
    bad = _tamper(GOLDEN_DIR / f"{golden}.events.jsonl",
                  tmp_path / f"{golden}.events.jsonl", ev_type, mutate)
    kw = {} if tol is None else {"tol": float(tol)}
    got, want = report.reconcile_path(bad, **kw), ref_report.reconcile_path(
        bad, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.ok == (tol is not None)
    if not got.ok:
        assert ev_type in got.first_divergence
    argv = ["reconcile", str(bad)] + ([] if tol is None else ["--tol", tol])
    assert _both(argv)[0] == (0 if tol else 1)


# explicit peaks: an H100 SXM's published dense bf16 rate and HBM3
# bandwidth, the same numbers in both packages
PEAKS = ["--peak-flops", "989e12", "--hbm-bw", "3.35e12"]


@pytest.mark.parametrize("argv", [
    ["--budget", "5.00", "--epoch-s", "1200", "--epochs", "20",
     "--on-demand"],
    ["--budget", "10.00", "--epoch-s", "1200", "--epochs", "20"],
    ["--budget", "4.00", "--epoch-s", "718,523,390,246,195,133",
     "--epochs", "20", "--on-demand"],
    ["--budget", "1.00", "--epoch-s", "600,400", "--price-trace",
     str(FIXTURE_PRICES), "--providers", "aws,gcp", "--cross-provider"],
    ["--budget", "1000", "--roofline-flops", "1e15", "--roofline-bytes",
     "1e12", "--clients", "2"] + PEAKS,
    ["--budget", "1000", "--roofline-flops", "1e15", "--roofline-bytes",
     "1e12", "--clients", "2", "--steps-per-epoch", "200"] + PEAKS,
    ["--budget", "0.01", "--roofline-flops", "9.842555e12",
     "--roofline-bytes", "4e11", "--time-scale", "1000",
     "--steps-per-epoch", "2"] + PEAKS,
], ids=["refused-on-demand", "within", "six-clients", "trace-market",
        "roofline", "roofline-200-steps", "roofline-refused"])
def test_validate_matches_at_explicit_peaks(argv):
    rc, out, err = _both(["validate"] + argv)
    assert rc in (0, 1) and out and not err


@pytest.mark.parametrize("drop", [("--peak-flops",), ("--hbm-bw",),
                                  ("--peak-flops", "--hbm-bw")])
def test_validate_without_peaks_is_a_usage_error(drop):
    """The JAX package falls back to TPU constants here; the port holds
    no hardware constant, so it refuses with one line and exit 2."""
    argv = ["validate", "--budget", "1000", "--roofline-flops", "1e15",
            "--roofline-bytes", "1e12"]
    for flag, value in zip(PEAKS[::2], PEAKS[1::2]):
        if flag not in drop:
            argv += [flag, value]
    rc, out, err = _cli(report, argv)
    assert rc == 2 and not out
    assert err.startswith("error:") and len(err.strip().splitlines()) == 1
    assert "--peak-flops and --hbm-bw" in err


def test_report_holds_no_tpu_constant():
    src = Path(report.__file__).read_text()
    assert "TPU" not in src and "launch.mesh" not in src


@pytest.mark.parametrize("argv", [
    ["validate", "--budget", "5"],
    ["validate", "--budget", "5", "--epoch-s", "100", "--roofline-flops",
     "1e12"],
    ["validate", "--budget", "5", "--roofline-flops", "1e12"],
], ids=["neither", "both", "flops-without-bytes"])
def test_validate_usage_errors_match(argv):
    assert _both(argv)[0] == 2


@pytest.fixture
def corrupt(tmp_path):
    good = (GOLDEN_DIR / "golden__spot.events.jsonl").read_text()

    def make(kind):
        path = tmp_path / f"{kind}.events.jsonl"
        lines = good.splitlines()
        if kind == "truncated":
            lines[-1] = lines[-1][: len(lines[-1]) // 2]
            path.write_text("\n".join(lines))
        elif kind == "bad_header":
            path.write_text("{not json\n" + "\n".join(lines[1:]))
        elif kind == "schema_v99":
            header = json.loads(lines[0])
            header["schema"] = 99
            path.write_text("\n".join([json.dumps(header)] + lines[1:]))
        elif kind == "no_summary":
            path.write_text("\n".join(
                ln for ln in lines if '"type": "RunCompleted"' not in ln))
        elif kind == "empty":
            path.write_text("")
        elif kind == "missing":
            pass
        return path

    return make


@pytest.mark.parametrize("kind", ["truncated", "bad_header", "schema_v99",
                                  "no_summary", "empty", "missing"])
@pytest.mark.parametrize("cmd", ["summary", "reconcile"])
def test_corrupt_log_gives_the_same_error(corrupt, kind, cmd):
    rc, out, err = _both([cmd, str(corrupt(kind))])
    assert rc in (1, 2) and "Traceback" not in out + err


def _comm_run(runner_cls, C):
    market = C.MarketConfig(providers=(C.ProviderConfig(
        name="aws", on_demand_rate=1.0, spot_rate_mean=0.4,
        spot_rate_sigma=0.0, n_zones=2, update_egress_usd_per_mb=0.001,
        uplink_mbps=100.0),))
    cfg = C.FLRunConfig(
        dataset="report_comm",
        clients=(C.ClientProfile("slow", mean_epoch_s=900, jitter=0.0,
                                 n_samples=2),
                 C.ClientProfile("fast", mean_epoch_s=150, jitter=0.0,
                                 n_samples=1)),
        n_epochs=3, policy="fedcostaware", seed=0, update_payload_mb=8.0)
    return runner_cls(cfg, cloud_cfg=C.CloudConfig(spot_rate_sigma=0.0,
                                                   market=market),
                      record=True)


def _ckpt_run(runner_cls, C):
    market = C.MarketConfig(providers=(C.ProviderConfig(
        name="aws", price_trace=str(FIXTURE_PRICES / "aws.csv"),
        interruption_trace=str(FIXTURE_PRICES / "aws.interruptions.csv"),
        preemption_notice_s=120.0, storage_put_usd=0.000005,
        storage_egress_usd_per_mb=0.00009),))
    cfg = C.FLRunConfig(
        dataset="report_ckpt",
        clients=(C.ClientProfile("a", mean_epoch_s=600.0, jitter=0.0,
                                 n_samples=1, zone="us-east-1a"),
                 C.ClientProfile("b", mean_epoch_s=400.0, jitter=0.0,
                                 n_samples=1, zone="us-east-1b")),
        n_epochs=3, policy="spot", seed=0, on_warning="checkpoint")
    return runner_cls(
        cfg, cloud_cfg=C.CloudConfig(spot_rate_sigma=0.0, spin_up_sigma=0.0,
                                     preemption_model="replay",
                                     market=market),
        sched_cfg=C.SchedulerConfig(checkpoint_every_s=600.0,
                                    warning_ckpt_write_s=10.0,
                                    warning_ckpt_size_mb=100.0),
        record=True)


@pytest.mark.parametrize("make", [_comm_run, _ckpt_run],
                         ids=["egress", "checkpoint"])
def test_billed_log_summarizes_as_in_the_jax_package(tmp_path, make):
    """Runs that bill egress or checkpoint storage (the goldens bill
    neither): the port records the same log, and its report sums each
    category to the run's dollars as the JAX package's does."""
    port, ref = make(FLCloudRunner, port_config), make(RefRunner, ref_config)
    res = port.run()
    ref.run()
    path = port.recorder.dump(tmp_path / "port.events.jsonl")
    assert path.read_text() == ref.recorder.dumps()
    got = report.summarize_path(path)
    assert _dumps(got) == _dumps(ref_report.summarize_path(path))
    assert res.comm_cost > 0 or res.checkpoint_cost > 0
    assert got["totals"]["total"] == pytest.approx(res.total_cost, abs=1e-9)
    assert got["totals"]["egress"] == pytest.approx(res.comm_cost, abs=1e-9)
    assert got["totals"]["checkpoint"] == pytest.approx(res.checkpoint_cost,
                                                        abs=1e-9)
    assert report.reconcile_path(path).ok


def test_table1_report_needs_record_dir():
    with pytest.raises(SystemExit) as exc:
        table1.main(["--report"])
    assert exc.value.code == 2


@pytest.mark.parametrize("argv", [
    ["--row", "MNIST", "--report"],
    ["--row", "MNIST", "--price-trace", str(FIXTURE_PRICES)],
    ["--row", "CIFAR-10", "--price-trace", str(FIXTURE_PRICES),
     "--providers", "aws,gcp", "--report"],
], ids=["report", "price-trace", "two-providers-report"])
def test_table1_prints_the_jax_packages_text(tmp_path, capsys, argv):
    """Table I with `--record-dir D --report` and `--price-trace`: the
    same text, and the same recorded logs, as the JAX package's."""
    table1.main(argv + ["--record-dir", str(tmp_path / "port")])
    got = capsys.readouterr().out
    ref_table1.main(argv + ["--record-dir", str(tmp_path / "ref")])
    assert got == capsys.readouterr().out
    logs = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert logs and logs == sorted(p.name for p in (tmp_path / "ref")
                                   .iterdir())
    for name in logs:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()
    if "--report" in argv:
        assert got.count("client,compute_usd") == len(logs)

"""The port's forecast package (`repro_torch.forecast`) and its two
benchmarks (`repro_torch.benchmarks.forecast_quality`,
`forecast_prewarm`) against the JAX package's, on the CPU. Both
packages' forecasters, calibration tracker and decision rule are pure
`math` over the same inputs, so they are held bit for bit; the
benchmarks' dollars to 1e-9 and each policy's recorded event log byte
for byte, its `ForecastUpdated` records included. The inputs are drawn
from a seeded numpy generator."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from benchmarks import forecast_prewarm as ref_fp
from benchmarks import forecast_quality as ref_fq
from repro import forecast as ref_forecast
from repro.common import config as ref_config
from repro.fl.runner import FLCloudRunner as RefRunner

from repro_torch import forecast
from repro_torch.benchmarks import forecast_prewarm as fp
from repro_torch.benchmarks import forecast_quality as fq
from repro_torch.common import config as port_config
from repro_torch.core.events import EVENT_TYPES, ForecastUpdated
from repro_torch.core.policies import POLICIES
from repro_torch.fl.runner import FLCloudRunner

REPO = Path(__file__).resolve().parent.parent
ZONES = (("aws", "us-east-1a"), ("aws", "us-east-1b"), ("gcp", "z1"))


def _stream(seed, n_ticks=400):
    """A tenant's observations: every zone's price each 30 s tick, calm
    near 0.30 with bursts near 0.45, and reclaims that land mostly
    inside the bursts. [(kind, provider, zone, t, price)]."""
    rng = np.random.RandomState(seed)
    events = []
    for i in range(n_ticks):
        t = 30.0 * i + float(rng.uniform(0.0, 5.0))
        burst = (i // 40) % 3 == 2
        for p, z in ZONES:
            level = 0.45 if burst and rng.uniform() < 0.8 else 0.30
            price = float(level + rng.normal(0.0, 0.01))
            events.append(("price", p, z, t, price))
            if rng.uniform() < (0.08 if burst else 0.004):
                events.append(("reclaim", p, z, t + 1.0, None))
    return events


def _forecaster_trace(pkg, kind, kwargs, events):
    """Every answer a forecaster gives after each observation."""
    f = pkg.make_forecaster(kind, **kwargs)
    out = []
    for ev, p, z, t, price in events:
        if ev == "price":
            f.observe_price(p, z, t, price)
        else:
            f.observe_reclaim(p, z, t)
        out.append((f.hazard_per_hr(p, z, t),
                    f.interruption_probability(p, z, t, 600.0),
                    f.price_quantiles(p, z)))
    return out


@pytest.mark.parametrize("kind,kwargs,seed", [
    ("ewma", {}, 0),
    ("ewma", {"alpha": 0.7, "base_rate_per_hr": 1.3}, 1),
    ("quantile", {}, 0),
    ("quantile", {"lr": 0.01, "base_rate_per_hr": 1.0}, 2),
    ("quantile", {"lr": 0.01, "miscalibrate": True}, 3),
    ("quantile", {"taus": (0.05, 0.25, 0.5, 0.75, 0.95), "spike_margin": 0.1,
                  "prior_weight": 4.0}, 4),
])
def test_forecasters_are_bit_equal(kind, kwargs, seed):
    events = _stream(seed)
    got = _forecaster_trace(forecast, kind, kwargs, events)
    want = _forecaster_trace(ref_forecast, kind, kwargs, events)
    assert sum(ev == "reclaim" for ev, *_ in events) > 5
    assert got == want


def _calibration_trace(pkg, horizon_s, events, seed):
    """The tracker scoring a forecaster's answers online, as the learned
    strategy drives it: a band and a prediction at every price sample,
    time advanced at each observation."""
    rng = np.random.RandomState(seed)
    f = pkg.make_forecaster("quantile", lr=0.02)
    c = pkg.CalibrationTracker(horizon_s=horizon_s)
    out = []
    for ev, p, z, t, price in events:
        c.advance(t)
        if ev == "price":
            c.observe_price(p, z, t, price)
            f.observe_price(p, z, t, price)
            q = f.price_quantiles(p, z)
            c.note_band(p, z, q[0.1], q[0.9])
            c.note_prediction(p, z, t, float(rng.uniform()) * 0.1
                              + f.interruption_probability(p, z, t,
                                                           horizon_s))
        else:
            c.observe_reclaim(p, z, t)
            f.observe_reclaim(p, z, t)
        out.append((c.brier(), c.coverage(), c.n_resolved()))
    return out


@pytest.mark.parametrize("horizon_s,seed", [(600.0, 0), (120.0, 5),
                                            (1800.0, 6)])
def test_calibration_tracker_is_bit_equal(horizon_s, seed):
    events = _stream(seed)
    got = _calibration_trace(forecast, horizon_s, events, seed)
    want = _calibration_trace(ref_forecast, horizon_s, events, seed)
    assert got[-1][2] > 0 and 0.0 <= got[-1][1] <= 1.0
    assert got == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decide_is_bit_equal(seed):
    rng = np.random.RandomState(seed)
    for _ in range(500):
        kw = dict(p=float(rng.uniform(-0.2, 1.2)),
                  spot_rate_hr=float(rng.uniform(0.1, 5.0)),
                  spin_up_s=float(rng.uniform(0.0, 900.0)),
                  lost_work_s=float(rng.uniform(0.0, 3600.0)),
                  unsnapshotted_s=float(rng.choice([0.0, rng.uniform(
                      0.0, 3600.0)])),
                  ckpt_usd=float(rng.uniform(0.0, 0.05)),
                  standby_active=bool(rng.uniform() < 0.5),
                  have_fresh_snapshot=bool(rng.uniform() < 0.5))
        cfg = dict(horizon_s=float(rng.uniform(60.0, 1800.0)),
                   stall_weight=float(rng.uniform(1.0, 5.0)),
                   prewarm_hysteresis=float(rng.uniform(0.1, 0.9)),
                   drain_threshold=float(rng.uniform(0.5, 1.0)))
        got = forecast.decide(**kw, cfg=forecast.DecisionConfig(**cfg))
        want = ref_forecast.decide(**kw,
                                   cfg=ref_forecast.DecisionConfig(**cfg))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.action == want.action


def test_the_names_the_port_documents_resolve():
    """`core/policies.py` and `core/strategy.py` of the port name
    `repro_torch.forecast.register_learned_policy` and
    `LearnedForecastStrategy`; they exist, export what the JAX package
    exports, and register as its policy does."""
    assert sorted(forecast.__all__) == sorted(ref_forecast.__all__)
    assert EVENT_TYPES["ForecastUpdated"] is ForecastUpdated
    pol = forecast.register_learned_policy("tmp_learned", poll_s=12.0)
    try:
        assert POLICIES["tmp_learned"] is pol
        spec = pol.strategies[0]
        assert isinstance(spec, forecast.LearnedForecastSpec)
        assert pol.on_warning == "checkpoint"
        assert isinstance(spec.build(pol), forecast.LearnedForecastStrategy)
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            ref_forecast.LearnedForecastSpec(poll_s=12.0))
    finally:
        POLICIES.pop("tmp_learned", None)


@pytest.mark.parametrize("first", ["repro_torch.fl.runner",
                                   "repro_torch.forecast.feed",
                                   "repro_torch.forecast"])
def test_cold_import_has_no_cycle(first):
    """`fl/runner.py` imports `forecast.feed`, whose package `__init__`
    imports the strategy, which imports `core.policies`: each entry
    point imports cleanly in a fresh interpreter."""
    code = (f"import {first}\n"
            "import repro_torch.fl.runner, repro_torch.forecast as F\n"
            "assert F.register_learned_policy and F.LearnedForecastStrategy")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env)


@pytest.fixture(scope="module")
def quality():
    return fq.compare(), ref_fq.compare()


@pytest.fixture(scope="module")
def prewarm():
    return fp.compare(), ref_fp.compare()


def _assert_same_results(got, want):
    assert list(got) == list(want)
    for name in want:
        assert set(got[name]) == set(want[name])
        for k, v in want[name].items():
            if k in ("total_cost", "brier", "coverage"):
                assert got[name][k] == pytest.approx(v, abs=1e-9), (name, k)
            else:
                assert got[name][k] == v, (name, k)


def test_forecast_quality_matches_the_jax_package(quality):
    got, want = quality
    _assert_same_results(got, want)
    assert got["learned_forecast"]["n_forecasts"] > 0


def test_forecast_prewarm_matches_the_jax_package(prewarm):
    got, want = prewarm
    _assert_same_results(got, want)


@pytest.mark.parametrize("bench", ["forecast_quality", "forecast_prewarm"])
def test_benchmark_main_asserts_pass_in_both(bench, capsys):
    port, ref = {"forecast_quality": (fq, ref_fq),
                 "forecast_prewarm": (fp, ref_fp)}[bench]
    got = port.main([])
    got_out = capsys.readouterr().out
    want = ref.main([])
    assert got_out == capsys.readouterr().out
    _assert_same_results(got, want)


def _record(runner_cls, cfgmod, bench, policy):
    """The benchmark's own run of `policy` (its `run_policy`), recorded:
    the RunResult and the event log's text."""
    cloud = cfgmod.CloudConfig(spot_rate_sigma=0.0, spin_up_sigma=0.0,
                               spin_up_mean_s=450.0,
                               preemption_model="replay",
                               preemption_rate_per_hr=1.0,
                               market=bench.spiky_market(
                                   bench.DEFAULT_TRACE_DIR))
    cfg = cfgmod.FLRunConfig(dataset=bench.__name__.rsplit(".", 1)[-1],
                             clients=bench.CLIENTS, n_epochs=8,
                             policy=policy, seed=0)
    r = runner_cls(cfg, cloud_cfg=cloud, sched_cfg=bench.SCHED, record=True)
    return r.run(), r.recorder.dumps()


@pytest.mark.parametrize("bench,policy", [
    *(("forecast_quality", p) for p in ref_fq.POLICY_NAMES),
    ("forecast_prewarm", "reactive_ckpt"),
    ("forecast_prewarm", "forecast_prewarm")])
def test_event_log_is_byte_identical(bench, policy, quality, prewarm):
    """Each policy's recorded log, byte for byte, and its dollars equal
    the benchmark's; the learned policies' logs carry their
    `ForecastUpdated` records."""
    port, ref, results = {"forecast_quality": (fq, ref_fq, quality),
                          "forecast_prewarm": (fp, ref_fp, prewarm)}[bench]
    port.register_policies()
    ref.register_policies()
    res, log = _record(FLCloudRunner, port_config, port, policy)
    want_res, want_log = _record(RefRunner, ref_config, ref, policy)
    assert log == want_log
    assert res.total_cost == pytest.approx(want_res.total_cost, abs=1e-9)
    assert res.total_cost == pytest.approx(
        results[0][policy]["total_cost"], abs=1e-9)
    n = log.count('"type": "ForecastUpdated"')
    assert (n > 0) == policy.endswith("_forecast")


def test_learned_row_on_the_cpu_reconciles(tmp_path):
    """The real-training Table I row under the learned policy at SMOKE
    size on the CPU (the card runs it at a main path in
    `chip_smoke.py`): it polls during training, and the port's report
    reconciles its log and sums it to the run's dollars."""
    from repro_torch.benchmarks import table1 as T1
    from repro_torch.cloud.report import (RECONCILE_TOL, reconcile_path,
                                          summarize_path)
    pol = forecast.register_learned_policy()
    row = next(r for r in T1.ROWS if r.dataset == "MNIST")
    log = tmp_path / "learned.events.jsonl"
    res, hooks, cal = T1.run_real(row, policy=pol.name, rounds=2,
                                  n_clients=2, quantize=True, record_to=log,
                                  smoke=True, device="cpu")
    rec = reconcile_path(log)
    assert rec.ok and abs(rec.delta) <= RECONCILE_TOL, rec.first_divergence
    assert abs(summarize_path(log)["totals"]["total"] - res.total_cost) \
        <= 1e-9
    assert res.rounds_completed == 2 and res.comm_cost > 0
    assert log.read_text().count('"type": "ForecastUpdated"') > 0

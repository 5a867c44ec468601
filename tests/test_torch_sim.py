"""The port's own simulator stack (`repro_torch.cloud`, `core`, `fl`
runner and engines) against the JAX package's pinned numbers, on the
CPU: every fresh-run golden event log byte for byte, the pinned replay
totals, the sync engine's pre-refactor totals, and the MNIST row of
Table I against the JAX package's `benchmarks/table1.py`. The configs
are those of the JAX package's own tests, built here from the port's
config classes; the pinned numbers are imported from those tests."""
import dataclasses
from pathlib import Path

import pytest

pytest.importorskip("torch")

from test_engines import GOLDEN_MAKESPAN, GOLDEN_SYNC
from test_golden_traces import GOLDEN_TOTALS

from repro_torch.benchmarks.table1 import POLICIES, ROWS, run_row
from repro_torch.common.config import (CloudConfig, ClientProfile,
                                       FLRunConfig, MarketConfig,
                                       ProviderConfig)
from repro_torch.core.eventlog import EventReplayer
from repro_torch.fl.runner import FLCloudRunner
from repro_torch.fl.telemetry import replay_result, state_totals

GOLDEN_DIR = Path(__file__).parent / "golden"
FIXTURE_PRICES = Path(__file__).parent / "fixtures" / "prices"

# tests/test_golden_traces.py's 2 x 3 configs
CLOUD = CloudConfig(spot_rate_sigma=0.0)
CLIENTS = (
    ClientProfile("slow", mean_epoch_s=900, jitter=0.0, n_samples=2),
    ClientProfile("fast", mean_epoch_s=150, jitter=0.0, n_samples=1),
)
FLEET_CLIENTS = tuple(
    ClientProfile(f"c{i}", mean_epoch_s=300.0 + 120.0 * i, jitter=0.0,
                  n_samples=1)
    for i in range(6))
# tests/test_engines.py's 3-client config
ENGINE_CLIENTS = (
    ClientProfile("slow", mean_epoch_s=900, jitter=0.0, n_samples=3),
    ClientProfile("mid", mean_epoch_s=450, jitter=0.0, n_samples=2),
    ClientProfile("fast", mean_epoch_s=150, jitter=0.0, n_samples=1),
)


def _policy_runner(policy):
    cfg = FLRunConfig(dataset="golden", clients=CLIENTS, n_epochs=3,
                      policy=policy, seed=0)
    return FLCloudRunner(cfg, cloud_cfg=CLOUD, record=True)


def _multicloud_runner():
    market = MarketConfig(providers=(
        ProviderConfig(name="aws",
                       price_trace=str(FIXTURE_PRICES / "aws.csv")),
        ProviderConfig(name="gcp", on_demand_rate=0.95,
                       min_billing_s=30.0,
                       price_trace=str(FIXTURE_PRICES / "gcp.csv")),
    ))
    cfg = FLRunConfig(dataset="multicloud", clients=CLIENTS, n_epochs=3,
                      policy="fedcostaware", seed=0, cross_provider=True)
    return FLCloudRunner(cfg, cloud_cfg=CloudConfig(
        spot_rate_sigma=0.0, market=market), record=True)


def _fleet_runner():
    cfg = FLRunConfig(dataset="golden_fleet", clients=FLEET_CLIENTS,
                      n_epochs=3, policy="fedcostaware", seed=0,
                      fleet=True)
    return FLCloudRunner(cfg, cloud_cfg=CLOUD, record=True)


def _fed_isic_runner():
    """`make_fed_isic_runner` of tests/test_golden_traces.py over the
    port's own Table I row."""
    row = ROWS[0]
    clients = tuple(
        ClientProfile(f"client_{i}", mean_epoch_s=t, cold_multiplier=1.12,
                      jitter=0.0, n_samples=int(t))
        for i, t in enumerate(row.epoch_s))
    cloud = CloudConfig(on_demand_rate=row.od_rate,
                        spot_rate_mean=row.spot_rate / 0.98,
                        spot_rate_sigma=0.0, spin_up_mean_s=row.spin_up_s,
                        spin_up_sigma=0.0)
    cfg = FLRunConfig(dataset=row.dataset, clients=clients,
                      n_epochs=row.n_epochs, policy="fedcostaware", seed=0)
    return FLCloudRunner(cfg, cloud_cfg=cloud, record=True)


RUNNERS = {
    "golden__fedcostaware": lambda: _policy_runner("fedcostaware"),
    "golden__spot": lambda: _policy_runner("spot"),
    "golden__fedcostaware_async": lambda: _policy_runner(
        "fedcostaware_async"),
    "golden__multicloud": _multicloud_runner,
    "golden__fleet": _fleet_runner,
    "fed_isic2019__fedcostaware": _fed_isic_runner,
}
# the per-object traces: the fleet path records no per-instance events
PER_OBJECT = [t for t in RUNNERS if t not in ("golden__fleet",
                                               "fed_isic2019__fedcostaware")]


def _golden(name):
    return GOLDEN_DIR / f"{name}.events.jsonl"


@pytest.mark.parametrize("trace", list(RUNNERS))
def test_fresh_run_reproduces_golden_log_byte_for_byte(trace):
    r = RUNNERS[trace]()
    r.run()
    assert r.recorder.dumps() == _golden(trace).read_text()


@pytest.mark.parametrize("trace", list(GOLDEN_TOTALS))
def test_replayed_golden_totals_match_pinned(trace):
    rep = replay_result(_golden(trace))
    want = GOLDEN_TOTALS[trace]
    assert rep.total_cost == pytest.approx(want["total"], abs=1e-9)
    assert set(rep.per_client_cost) == set(want["per_client"])
    for c, v in want["per_client"].items():
        assert rep.per_client_cost[c] == pytest.approx(v, abs=1e-9)
    assert rep.rounds_completed == 3


@pytest.mark.parametrize("trace", PER_OBJECT)
def test_replay_matches_live_run(trace):
    r = RUNNERS[trace]()
    live = r.run()
    rep = replay_result(EventReplayer.loads(r.recorder.dumps()))
    assert rep.total_cost == pytest.approx(live.total_cost, abs=1e-9)
    lt, rt = state_totals(live.timeline), state_totals(rep.timeline)
    assert set(lt) == set(rt)
    for k in lt:
        assert rt[k] == pytest.approx(lt[k], abs=1e-9), k
    assert rep.makespan_s == pytest.approx(live.makespan_s, abs=1e-9)
    assert [list(p) for p in rep.per_round_participants] == \
        live.per_round_participants


@pytest.mark.parametrize("policy", list(GOLDEN_SYNC))
def test_sync_engine_meets_the_pre_refactor_totals(policy):
    cfg = FLRunConfig(dataset="t", clients=ENGINE_CLIENTS, n_epochs=8,
                      policy=policy, seed=0)
    res = FLCloudRunner(cfg, cloud_cfg=CLOUD).run()
    assert res.total_cost == pytest.approx(GOLDEN_SYNC[policy], abs=1e-6)
    assert res.makespan_s == pytest.approx(GOLDEN_MAKESPAN, abs=1e-6)


# tests/test_engines.py::TestSyncGolden::test_table1_mnist_row_preserved,
# held to the JAX package's own row and run_row, every policy
@pytest.mark.parametrize("policy", POLICIES)
def test_table1_mnist_row_through_the_port(policy):
    from benchmarks import table1 as jax_table1
    row = next(r for r in ROWS if r.dataset == "MNIST")
    jax_row = next(r for r in jax_table1.ROWS if r.dataset == "MNIST")
    assert dataclasses.astuple(row) == dataclasses.astuple(jax_row)
    got, want = run_row(row, policy), jax_table1.run_row(jax_row, policy)
    for field in ("total_cost", "checkpoint_cost", "comm_cost",
                  "makespan_s"):
        assert getattr(got, field) == pytest.approx(getattr(want, field),
                                                    abs=1e-9), field

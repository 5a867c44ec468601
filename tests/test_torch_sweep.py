"""The port's Monte-Carlo sweep (`repro_torch.sweep` and
`repro_torch.benchmarks.sweep`) against the JAX package's, on the CPU:
the same grid, bit-equal seeded statistics, equal cell metrics, the
same serialized report byte for byte, and the CLI's crunch-win gate and
dollar audit passing in both. The port's pool starts its workers with
"spawn"; its parallel results equal its serial ones."""
import dataclasses
import multiprocessing

import numpy as np
import pytest

pytest.importorskip("torch")

from benchmarks import sweep as ref_cli
from repro import sweep as ref_sweep
from repro.sweep import report as ref_report

from repro_torch import sweep
from repro_torch.benchmarks import sweep as cli
from repro_torch.sweep import report, runner

SMALL_GRID = dict(policies=("spot", "fedcostaware"),
                  markets=("baseline", "capacity_crunch"),
                  seeds=range(2))
GRIDS = {
    "small": SMALL_GRID,
    "models": dict(models=("constant", "price_coupled"), **SMALL_GRID),
    "engines": dict(engines=("sync", "async_buffered"), **SMALL_GRID),
    "every-market": dict(policies=("on_demand", "spot", "fedcostaware"),
                         markets=tuple(sorted(ref_sweep.MARKETS)),
                         seeds=range(3), n_clients=3, n_epochs=2),
}


def _tuples(specs):
    return [dataclasses.astuple(s) for s in specs]


@pytest.mark.parametrize("grid", list(GRIDS))
def test_build_grid_matches(grid):
    got, want = sweep.build_grid(**GRIDS[grid]), ref_sweep.build_grid(
        **GRIDS[grid])
    assert _tuples(got) == _tuples(want)
    assert [report.cell_key(s) for s in got] == [
        ref_report.cell_key(s) for s in want]
    assert [s.cell_slug() for s in got] == [s.cell_slug() for s in want]


@pytest.mark.parametrize("market", sorted(ref_sweep.MARKETS))
@pytest.mark.parametrize("seed", [0, 3])
def test_market_config_matches(market, seed):
    assert dataclasses.asdict(sweep.market_config(market, seed)) == \
        dataclasses.asdict(ref_sweep.market_config(market, seed))


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (5, 2), (20, 3),
                                    (64, 4)])
def test_bootstrap_ci_and_summarize_are_bit_equal(n, seed):
    x = np.random.RandomState(seed).normal(10.0, 3.0, size=n)
    for s in (0, seed, 12345):
        assert sweep.bootstrap_ci(x, seed=s) == ref_sweep.bootstrap_ci(
            x, seed=s)
        assert sweep.summarize(list(x), seed=s) == ref_sweep.summarize(
            list(x), seed=s)


@pytest.mark.parametrize("key", ["a", "spot|baseline|price_coupled",
                                 "fedcostaware|capacity_crunch|correlated|"
                                 "async_buffered"])
def test_hash_seed_matches(key):
    assert report.hash_seed(key) == ref_report.hash_seed(key)


@pytest.fixture(scope="module")
def small():
    specs = sweep.build_grid(**SMALL_GRID)
    ref_specs = ref_sweep.build_grid(**SMALL_GRID)
    return (specs, sweep.run_sweep(specs, parallel=False),
            ref_specs, ref_sweep.run_sweep(ref_specs, parallel=False))


@pytest.mark.parametrize("i", range(8))
def test_run_cell_metrics_match(small, i):
    specs, results, ref_specs, ref_results = small
    assert results[i] == ref_results[i]
    assert sweep.run_cell(specs[i]) == results[i]
    assert set(results[i]) == set(runner.METRICS)


@pytest.mark.parametrize("engine", ["sync", "async_buffered"])
def test_engine_cells_match(engine):
    kw = dict(policies=("fedcostaware",), markets=("baseline",),
              seeds=range(2), n_epochs=3, engines=(engine,))
    assert sweep.run_sweep(sweep.build_grid(**kw), parallel=False) == \
        ref_sweep.run_sweep(ref_sweep.build_grid(**kw), parallel=False)


def test_report_is_byte_identical(small):
    specs, results, ref_specs, ref_results = small
    got = report.dumps(report.build_report(specs, results))
    assert got == ref_report.dumps(ref_report.build_report(ref_specs,
                                                          ref_results))
    for metric in runner.METRICS:
        assert report.ranking_table(report.build_report(specs, results),
                                    metric=metric) == \
            ref_report.ranking_table(ref_report.build_report(
                ref_specs, ref_results), metric=metric)


def test_parallel_equals_serial_under_spawn(small, monkeypatch):
    """The pool fans the cells over spawned workers (never forked: the
    parent has torch loaded), and returns the serial list."""
    specs, serial, _, _ = small
    methods = []
    get_context = multiprocessing.get_context

    def recording(method=None):
        methods.append(method)
        return get_context(method)

    monkeypatch.setattr(runner.multiprocessing, "get_context", recording)
    assert sweep.run_sweep(specs, parallel=True, processes=2) == serial
    assert methods == ["spawn"]


def _cli_argv(out, audit_dir):
    return ["--policies", "spot", "fedcostaware",
            "--markets", "baseline", "capacity_crunch",
            "--seeds", "3", "--serial", "--out", str(out),
            "--assert-crunch-win", "--audit", "--audit-dir", str(audit_dir)]


def test_smoke_grid_and_crunch_gate(tmp_path, capsys):
    """The JAX package's CI smoke grid through both CLIs: the same report
    bytes, the crunch-win gate and the dollar audit passing in both, and
    every cell's recorded log byte-identical."""
    got = cli.main(_cli_argv(tmp_path / "port.json", tmp_path / "port"))
    port_out = capsys.readouterr().out
    want = ref_cli.main(_cli_argv(tmp_path / "ref.json", tmp_path / "ref"))
    ref_out = capsys.readouterr().out
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    assert got == want and len(got["cells"]) == 4
    for out in (port_out, ref_out):
        assert "# audit: 12/12 cells reconciled dollar-exact" in out
        assert "# crunch win: fedcostaware" in out
    assert port_out.replace("port.json", "ref.json") == ref_out
    logs = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(logs) == 12
    assert logs == sorted(p.name for p in (tmp_path / "ref").iterdir())
    for name in logs:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()


def test_report_flag_names_the_ports_tools(tmp_path, capsys):
    cli.main(["--policies", "spot", "--markets", "baseline", "--seeds", "2",
              "--clients", "2", "--epochs", "2", "--serial", "--report",
              "--out", str(tmp_path / "r.json")])
    out = capsys.readouterr().out
    assert "python -m repro_torch.benchmarks.table1 --record-dir" in out
    assert "python -m repro_torch.cloud.report" in out
    assert out.count("baseline:") == len(runner.METRICS)

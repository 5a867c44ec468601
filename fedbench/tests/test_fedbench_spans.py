"""The per-layer metrics read from the program's spans, on the CPU: a
traced tiny cell of each family reports its layers' shares, omits the
backward it never ran, reads the window's rounds alone, and reads
nothing from a port that records no spans."""
import sys

import pytest
from torch.profiler import ProfilerActivity, profile

import fedbench_tiny as tiny

from fedbench.harness import spec as S
from repro_torch.common import trace

SHARED = ("data_wait_share", "sgd_share", "fold_share")
SPAN_METRICS = SHARED + ("attn_bwd_share", "ssd_bwd_share")


@pytest.fixture(autouse=True)
def _empty_store():
    trace.clear()
    yield
    trace.clear()


@pytest.mark.parametrize("kind, has, lacks", [
    ("attn", "attn_bwd_share", "ssd_bwd_share"),
    ("mamba2", "ssd_bwd_share", "attn_bwd_share")])
def test_a_traced_cell_reports_its_layers(tmp_path, kind, has, lacks):
    root = tiny.lay_out(tmp_path, kind)
    rc, line, _ = tiny.run_cell(root, trace=True)
    assert rc == 0 and line["correct"] is True
    got = line["metrics"]
    for name in SHARED + (has,):
        assert got[name]["unit"] == "%"
        assert 0 < got[name]["value"] <= 100, (name, got[name])
    assert lacks not in got
    # the window's two rounds, then the labelled one
    assert len(trace.roots("fl.round")) == 3


def _store(walls):
    """Completed `fl.round` roots, each with one `fl.data_draw`."""
    with profile(activities=[ProfilerActivity.CPU]):
        for r, _ in enumerate(walls):
            with trace.span("fl.round", round=r):
                with trace.span("fl.data_draw"):
                    pass
    rounds = trace.roots("fl.round")
    for r, w in zip(rounds, walls):
        r.children[0].device_s = w
    return rounds


def test_a_reader_takes_the_window_rounds_alone():
    _store([0.1, 0.2, 0.4])
    read = S.reader("data_wait_share")
    assert read({"rounds": 2, "window_s": 1.0}) == pytest.approx(30.0)
    assert S.reader("sgd_share")({"rounds": 2, "window_s": 1.0}) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_no_reading_from_a_port_without_spans(name, monkeypatch):
    _store([0.1, 0.2])
    ctx = {"rounds": 2, "window_s": 1.0}
    # as in a checkout of the port from before the spans
    monkeypatch.delattr(sys.modules["repro_torch.common"], "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.common.trace", None)
    assert S.reader(name)(ctx) is None

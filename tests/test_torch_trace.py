"""The port's round spans (`repro_torch.common.trace`) on the CPU: off
without a profiler (no `record_function`, no record, no CUDA event),
and under one a tree at each layer boundary of `TorchTrainerHooks`'
round, a span for every draw, step, update and fold, whose records keep
no object that the garbage collector tracks."""
import dataclasses
import gc
import json
import threading

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.common import trace
from repro_torch.common.bridge import flatten_with_paths
from repro_torch.fl.training import TorchTrainerHooks
from repro_torch.models import lm

CLIENTS = ("c0", "c1")
STEPS, BATCH, SEQ = 2, 2, 8
ROUND_CHILDREN = ["fl.data_draw", "fl.local_train", "fl.fold",
                  "fl.local_train", "fl.fold", "fl.apply"]
STEP_CHILDREN = ["lm.forward", "lm.backward", "fl.sgd"]
BACKWARD = {"phi3-mini-3.8b": "attn.bwd", "mamba2-1.3b": "ssd.bwd"}
SPAN_NAMES = {"fl.round", "fl.data_draw", "fl.local_train", "lm.step",
              "lm.forward", "lm.backward", "fl.sgd", "fl.loss_readback",
              "fl.fold", "fl.apply"}


def _hooks(model, quantize):
    return TorchTrainerHooks(CLIENTS, model=model, local_steps=STEPS,
                             batch=BATCH, seq=SEQ, quantize=quantize,
                             device="cpu")


def _round(hooks, r):
    for c in CLIENTS:
        hooks.run_local(c, r)
    hooks.aggregate(list(CLIENTS), r)


@pytest.fixture(autouse=True)
def _empty_store():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module", params=[
    ("phi3-mini-3.8b", True), ("phi3-mini-3.8b", False),
    ("mamba2-1.3b", True), ("mamba2-1.3b", False)],
    ids=["attn-int8", "attn-fp32", "mamba2-int8", "mamba2-fp32"])
def traced(request, tmp_path_factory):
    """One round traced under a CPU profiler after one untraced round:
    the hooks, the round's root span and the exported trace's events."""
    model, quantize = request.param
    hooks = _hooks(model, quantize)
    trace.clear()
    _round(hooks, 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _round(hooks, 1)
    path = tmp_path_factory.mktemp("trace") / "round.json"
    prof.export_chrome_trace(str(path))
    roots = trace.roots()
    trace.clear()
    events = json.loads(path.read_text())["traceEvents"]
    return dict(model=model, quantize=quantize, hooks=hooks, roots=roots,
                events=events)


def _count_calls(monkeypatch):
    """Count `record_function` contexts and CUDA events made from here
    on."""
    calls = {"record_function": 0, "event": 0}
    real_rf, real_event = torch.profiler.record_function, torch.cuda.Event

    def counting_rf(*a, **k):
        calls["record_function"] += 1
        return real_rf(*a, **k)

    def counting_event(*a, **k):
        calls["event"] += 1
        return real_event(*a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting_rf)
    monkeypatch.setattr(torch.cuda, "Event", counting_event)
    return calls


@pytest.mark.parametrize("model", ["phi3-mini-3.8b", "mamba2-1.3b"])
def test_off_without_a_profiler(model, monkeypatch):
    calls = {"record_function": 0, "event": 0}
    real_rf, real_event = torch.profiler.record_function, torch.cuda.Event

    def counting_rf(*a, **k):
        calls["record_function"] += 1
        return real_rf(*a, **k)

    def counting_event(*a, **k):
        calls["event"] += 1
        return real_event(*a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting_rf)
    monkeypatch.setattr(torch.cuda, "Event", counting_event)
    hooks = _hooks(model, True)
    _round(hooks, 0)
    assert trace.roots() == []
    assert calls == {"record_function": 0, "event": 0}
    assert trace.span("fl.round", round=0) is trace.span("lm.step")


@pytest.mark.parametrize("model", ["phi3-mini-3.8b", "mamba2-1.3b",
                                   "granite-4.0-h-micro"])
def test_an_untraced_step_records_nothing(model, monkeypatch):
    """A step's forward and backward under remat, the layer spans of
    `models/lm.py` and their recompute included, makes no CUDA event and
    no record without a profiler."""
    cfg = configs.get_config(model, smoke=True)
    # one block of granite's period: every layer kind once
    cfg = dataclasses.replace(cfg, remat=True,
                              num_layers=max(len(cfg.pattern), 2))
    params = lm.init_params(cfg, seed=0, device="cpu")
    leaves = [t.requires_grad_(True) for _, t in flatten_with_paths(params)]
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                           generator=torch.Generator().manual_seed(0))
    calls = _count_calls(monkeypatch)
    loss = lm.loss_fn(params, cfg, {"tokens": tokens, "labels": tokens})
    torch.autograd.grad(loss, leaves)
    assert calls == {"record_function": 0, "event": 0}
    assert trace.roots() == []


def test_layer_spans_run_again_in_the_recompute():
    """Under remat the layer spans of `models/lm.py` run in the forward
    and again in the backward's recompute: one a mixer or MLP each
    time."""
    cfg = dataclasses.replace(
        configs.get_config("granite-4.0-h-micro", smoke=True), remat=True,
        num_layers=10)
    params = lm.init_params(cfg, seed=0, device="cpu")
    leaves = [t.requires_grad_(True) for _, t in flatten_with_paths(params)]
    tokens = torch.zeros((BATCH, SEQ), dtype=torch.long)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("lm.forward"):
            loss = lm.loss_fn(params, cfg, {"tokens": tokens,
                                            "labels": tokens})
        with trace.span("lm.backward"):
            torch.autograd.grad(loss, leaves)
    n_attn = cfg.n_super * cfg.pattern.count("attn")
    want = {"lm.mix.mamba2": cfg.num_layers - n_attn, "lm.mix.attn": n_attn,
            "lm.mlp": cfg.num_layers}
    for root in trace.roots():
        names = [s.name for s in root.children]
        assert {n: names.count(n) for n in want} == want, root.name


def test_round_tree(traced):
    (root,) = traced["roots"]
    assert root.name == "fl.round" and root.round == 1
    assert [c.name for c in root.children] == ROUND_CHILDREN
    for lt in (c for c in root.children if c.name == "fl.local_train"):
        assert [c.name for c in lt.children] == (
            ["lm.step"] * STEPS + ["fl.loss_readback"])
        for step in lt.children[:STEPS]:
            assert [c.name for c in step.children] == STEP_CHILDREN
    assert {s.round for s in root.walk()} == {1}
    for s in root.walk():
        # on the CPU the device wall is the host duration
        assert s.device_s == s.host_s > 0
        assert sum(c.host_s for c in s.children) <= s.host_s


def test_counts_cover_the_round(traced):
    """One span a unit of each layer's work: a draw a round, a step and
    an update a batch, a readback and a fold a participant."""
    (root,) = traced["roots"]
    spans = [s.name for s in root.walk()]
    steps = len(CLIENTS) * STEPS
    assert {n: spans.count(n) for n in SPAN_NAMES} == {
        "fl.round": 1, "fl.data_draw": 1, "fl.local_train": len(CLIENTS),
        "lm.step": steps, "lm.forward": steps, "lm.backward": steps,
        "fl.sgd": steps, "fl.loss_readback": len(CLIENTS),
        "fl.fold": len(CLIENTS), "fl.apply": 1}
    draw = next(s for s in root.children if s.name == "fl.data_draw")
    assert draw.host_s > 0


def test_kernel_backwards_nest_under_lm_backward(traced):
    (root,) = traced["roots"]
    cfg = traced["hooks"].cfg
    name = BACKWARD[traced["model"]]
    for s in root.walk():
        if s.name == "lm.backward":
            assert [c.name for c in s.children] == [name] * cfg.num_layers
    assert sum(s.name == name for s in root.walk()) == (
        len(CLIENTS) * STEPS * cfg.num_layers)
    other = set(BACKWARD.values()) - {name}
    assert not any(s.name in other for s in root.walk())


def test_chrome_trace_holds_every_span(traced):
    names = {e["name"] for e in traced["events"]
             if e.get("cat") == "user_annotation"}
    assert SPAN_NAMES | {BACKWARD[traced["model"]]} <= names


def test_the_open_stack_spans_threads():
    """A span opened on another thread while this one waits (as autograd
    runs a Function's backward) nests under this thread's open span."""
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("lm.backward"):
            t = threading.Thread(target=lambda: trace.span("attn.bwd")
                                 .__enter__().__exit__(None, None, None))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    (root,) = trace.roots()
    assert [c.name for c in root.children] == ["attn.bwd"]


def test_roots_by_name_and_clear():
    with profile(activities=[ProfilerActivity.CPU]):
        for r in range(3):
            with trace.span("fl.round", round=r):
                with trace.span("fl.apply"):
                    pass
        with trace.span("fl.data_draw"):
            pass
    assert [s.round for s in trace.roots("fl.round")] == [0, 1, 2]
    assert [s.children[0].round for s in trace.roots("fl.round")] == [
        0, 1, 2]
    assert [s.name for s in trace.roots()] == ["fl.round"] * 3 + [
        "fl.data_draw"]
    trace.clear()
    assert trace.roots() == []


def test_records_keep_no_tracked_object():
    """A span under the profiler leaves nothing behind that the garbage
    collector tracks, so it does not add to the collector's work."""
    def spans(n):
        for r in range(n):
            with trace.span("fl.round", round=r):
                with trace.span("lm.step"):
                    pass

    with profile(activities=[ProfilerActivity.CPU]):
        spans(10)
        gc.collect()
        before = len(gc.get_objects())
        spans(1000)
        gc.collect()
        grown = len(gc.get_objects()) - before
    assert grown < 20, grown
    assert len(trace.roots("fl.round")) == 1010


def test_layer_spans_keep_no_tracked_object(monkeypatch):
    """The spans of `models/lm.py` (`lm.mix.mamba2`, `lm.mix.attn`,
    `lm.mlp`) at their own sites: 2,000 of them leave under 20 objects
    that the garbage collector tracks. The layers inside them pass their
    input through, so the spans are all that runs."""
    for mod, name in ((lm.S, "mamba2_mix"), (lm.L, "attention"),
                      (lm.L, "mlp")):
        monkeypatch.setattr(mod, name, lambda p, h, cfg, **kw: h)
    cfg = configs.get_config("granite-4.0-h-micro", smoke=True)
    blk = lm._layer_slice(lm.init_params(cfg, seed=0, device="cpu")
                          ["blocks"], 0)
    x = torch.randn(1, SEQ, cfg.d_model)
    sublayers = [(k, blk[f"{i:02d}_{k}"]) for i, k in enumerate(cfg.pattern)
                 if i in (0, cfg.pattern.index("attn"))]

    def spans(n):
        with torch.no_grad():
            for _ in range(n):
                for kind, p in sublayers:
                    lm._apply_sublayer(kind, p, x, cfg, None)

    with profile(activities=[ProfilerActivity.CPU]):
        spans(5)
        gc.collect()
        before = len(gc.get_objects())
        spans(500)
        gc.collect()
        grown = len(gc.get_objects()) - before
    assert grown < 20, grown
    names = [s.name for s in trace.roots()]
    assert {n: names.count(n) for n in set(names)} == {
        "lm.mix.mamba2": 505, "lm.mix.attn": 505, "lm.mlp": 1010}


def test_out_of_order_close_and_open_reads():
    """A span closed under another still open raises; `roots` while a
    span is open returns the completed ones, and `clear` refuses."""
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("fl.round", round=0):
            pass
        outer = trace.span("fl.round", round=1).__enter__()
        inner = trace.span("lm.step").__enter__()
        with pytest.raises(RuntimeError, match="closed while 'lm.step'"):
            outer.__exit__(None, None, None)
        assert [r.round for r in trace.roots()] == [0]
        with pytest.raises(RuntimeError, match="span is open"):
            trace.clear()
        inner.__exit__(None, None, None)
        outer.__exit__(None, None, None)
    (_, r1) = trace.roots()
    assert r1.round == 1 and [c.name for c in r1.children] == ["lm.step"]

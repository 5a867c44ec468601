"""The port's calibration and work counting on the CPU: `StepCalibration`
and `calibrated_profiles` against the JAX package's, `WorkCounter`
against hand counts, `calibrate` on the CPU, and the real-training
Table I row of `python -m repro_torch.benchmarks.table1` at SMOKE size.

The JAX package also bounds its measured/roofline ratio to [1/3, 3]
(tests/test_training.py, marked slow). The port's ratio on the CPU is
not held to it: eager PyTorch pays a host dispatch for every op of a
SMOKE step, which no FLOP or byte count sees, and its CPU ratio lands
at several times the estimate and varies from run to run."""
import dataclasses
import math
import os
import subprocess
import sys
import weakref
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.common.config import ClientProfile as JaxProfile
from repro.fl import training as jax_training
from repro_torch import configs
from repro_torch.benchmarks import table1 as T1
from repro_torch.common.config import ClientProfile
from repro_torch.fl import training as T
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.grad_quant import ops as gq
from repro_torch.kernels.rglru import ops as rg
from repro_torch.kernels.ssd import ops as sd
from repro_torch.launch import roofline as R

REPO = Path(__file__).resolve().parents[1]

# (measured_round_s, roofline_round_s, flops, bytes, peak FLOP/s, bytes/s)
CALIBRATIONS = [
    (0.0177, 0.00283, 1.468e8, 7.79e7, 3.447e11, 3.237e10),
    (0.2232, 0.0101, 9.1e12, 4.2e11, 7.1e14, 2.9e12),
    (1.0 / 3.0, 1.0 / 7.0, 1.0, 1.0, 1.0, 1.0),
]
EPOCHS = [(818.0, 511.0, 348.0), (600.0,), (1.0, 2.0, 3.0, 4.0)]


@pytest.mark.parametrize("fields", CALIBRATIONS)
@pytest.mark.parametrize("time_scale", [1.0, 1000.0, 0.37])
def test_calibration_math_is_the_jax_package_s(fields, time_scale):
    want = jax_training.StepCalibration(*fields)
    got = T.StepCalibration(*fields)
    assert got.ratio == pytest.approx(want.ratio, rel=1e-12, abs=0)
    assert got.mean_epoch_s(time_scale) == pytest.approx(
        want.mean_epoch_s(time_scale), rel=1e-12, abs=0)


@pytest.mark.parametrize("epochs", EPOCHS)
@pytest.mark.parametrize("time_scale", [1.0, 1000.0])
def test_calibrated_profiles_are_the_jax_package_s(epochs, time_scale):
    fields = CALIBRATIONS[0]
    want = jax_training.calibrated_profiles(
        [JaxProfile(f"c{i}", mean_epoch_s=t, cold_multiplier=1.12)
         for i, t in enumerate(epochs)],
        jax_training.StepCalibration(*fields), time_scale=time_scale)
    got = T.calibrated_profiles(
        [ClientProfile(f"c{i}", mean_epoch_s=t, cold_multiplier=1.12)
         for i, t in enumerate(epochs)],
        T.StepCalibration(*fields), time_scale=time_scale)
    assert [p.name for p in got] == [p.name for p in want]
    for g, w in zip(got, want):
        assert g.mean_epoch_s == pytest.approx(w.mean_epoch_s, rel=1e-12,
                                               abs=0)
        assert g.cold_multiplier == w.cold_multiplier


def test_estimate_step_time_needs_measured_peaks():
    with pytest.raises(TypeError):
        R.estimate_step_time(1e9, 1e9)
    with pytest.raises(ValueError, match="peaks"):
        R.estimate_step_time(1e9, 1e9, peak_flops=0.0, hbm_bw=1e9)
    assert R.estimate_step_time(4.0, 6.0, peak_flops=2.0, hbm_bw=3.0,
                                combine="sum") == 4.0
    assert R.estimate_step_time(4.0, 9.0, peak_flops=2.0, hbm_bw=3.0) == 3.0


def _one_layer_phi3_step():
    """One local step of a one-layer phi3 SMOKE on the CPU, counted, and
    the sizes of its matrix products: (M, K, N) of the projections, the
    MLP and the head, and of the plain attention's two products per
    (batch, head)."""
    B, S = 2, 8
    cfg = dataclasses.replace(configs.get_config("phi3-mini-3.8b",
                                                 smoke=True), num_layers=1)
    hooks = T.TorchTrainerHooks(("c0",), cfg=cfg, local_steps=1, batch=B,
                                seq=S, device="cpu")
    batches = hooks._next_batches()[0]
    with R.WorkCounter() as wc:
        hooks._local_train(hooks.params, hooks.mu[0], batches)
    d, NH, f, V, t = (cfg.d_model, cfg.num_heads * cfg.resolved_head_dim,
                      cfg.d_ff, cfg.vocab_size, B * S)
    dense = [(t, d, NH)] * 3 + [(t, NH, d), (t, d, f), (t, d, f), (t, f, d),
                                (t, d, V)]
    attn = [(S, cfg.resolved_head_dim, S)] * 2 * B * cfg.num_heads
    return wc, dense, attn


def test_counter_matches_a_hand_count_of_a_phi3_smoke_step():
    """Every product of the step is counted: a dense product once
    forward and twice backward (both operands take a gradient); the
    attention's plain version on the CPU forward, once more in the
    backward's recompute and twice in its gradient. Bytes of the
    products: each operand read and the result written, fp32."""
    wc, dense, attn = _one_layer_phi3_step()

    def flops(mats):
        return sum(2 * m * k * n for m, k, n in mats)

    def nbytes(mats):
        return sum(4 * (m * k + k * n + m * n) for m, k, n in mats)

    assert wc.aten_flops == 3 * flops(dense) + 4 * flops(attn)
    assert (wc.bytes_by_op.get("mm", 0) + wc.bytes_by_op.get("bmm", 0)
            + wc.bytes_by_op.get("addmm", 0)) == \
        3 * nbytes(dense) + 4 * nbytes(attn)
    # on the CPU the wrappers run their plain versions, which the modes
    # count themselves; no kernel adds anything
    assert wc.kernels == {}
    assert wc.flops == wc.aten_flops
    assert wc.bytes_accessed == wc.aten_bytes == sum(wc.bytes_by_op.values())


def test_byte_counter_counts_reads_and_writes_not_views():
    a, b = torch.ones(4, 8), torch.ones(4, 8)
    with R.WorkCounter() as wc:
        a.t(), a.view(32), a[1:]     # views: nothing moves
        a.t().reshape(32)            # a copy: one read, one write
        torch.empty(1000)            # an allocation: nothing moves
        a + b                        # two reads, one write
        a.add_(b)                    # a and b read, a written
        a.copy_(b)                   # b read, a written
    assert wc.bytes_by_op == {"clone": 256, "add": 3 * 128,
                              "add_": 3 * 128, "copy_": 256}
    assert wc.aten_flops == 0


def test_kernel_work_goes_to_every_active_counter_once():
    with R.WorkCounter() as outer:
        R.add_kernel_work("k", lambda: (3.0, 5))
        with R.WorkCounter() as inner:
            R.add_kernel_work("k", lambda: (3.0, 5))
            R.add_kernel_work("j", lambda: (1.0, 2))
    assert inner.kernels == {"k": [1, 3.0, 5.0], "j": [1, 1.0, 2.0]}
    assert outer.kernels == {"k": [2, 6.0, 10.0], "j": [1, 1.0, 2.0]}
    assert (outer.kernel_flops, outer.kernel_bytes) == (7.0, 12.0)
    calls = []
    R.add_kernel_work("k", lambda: calls.append(1) or (1.0, 1))
    assert calls == []               # no counter, no work computed


def test_kernel_formulas_by_hand():
    # causal S=4: 1+2+3+4 pairs; window 2: 1+2+2+2
    assert R.attention_work(1, 4, 4, 1, 8, 4)[0] == 4.0 * 8 * 10
    assert R.attention_work(2, 4, 4, 3, 8, 2, window=2) == (
        4.0 * 8 * 7 * 2 * 3, 4 * 2 * 4 * 3 * 8 * 2)
    # the pairs of causal self attention are min(i + 1, window) a query,
    # at main-path lengths too
    for S, w in [(1024, None), (4096, 2048), (77, 16)]:
        assert R.attention_work(1, S, S, 1, 1, 2, window=w)[0] == 4.0 * sum(
            min(i + 1, w or i + 1) for i in range(S))
    # non-causal: every pair; cross lengths: queries read and written,
    # keys and values read
    assert R.attention_work(1, 3, 5, 1, 8, 4, causal=False) == (
        4.0 * 8 * 15, (2 * 3 + 2 * 5) * 8 * 4)
    # one chunk of 4 rows: 10 causal pairs x (n + p) x 2, 4 q n p
    assert R.ssd_flops(1, 4, 1, 2, 3, 4) == 2.0 * 10 * 5 + 4.0 * 4 * 3 * 2
    assert R.ssd_flops(1, 6, 1, 2, 3, 4) == (
        R.ssd_flops(1, 4, 1, 2, 3, 4) + R.ssd_flops(1, 2, 1, 2, 3, 2))
    assert R.ssd_work(2, 4, 3, 2, 1, 16, 4, 2)[1] == (
        2 * 2 * 4 * 3 * 2 * 2 + 2 * 4 * 3 * 4 + 2 * 2 * 4 * 1 * 16 * 2)
    assert R.rglru_work(10) == (20.0, 120)
    assert R.rglru_work(10, backward=True) == (40.0, 200)
    assert R.codec_work(3000, 2, 2048) == (15002.0, 12000 + 4096 + 8)
    assert R.codec_work(3000, 2, 2048, dequantize=True)[0] == 3000.0


@pytest.mark.parametrize("wrapper,module", [
    ("flash_attention_fwd", fa), ("quantize", gq), ("dequantize", gq),
    ("ssd_fwd", sd), ("rglru_scan_fwd", rg), ("rglru_scan_reverse", rg),
    ("rglru_scan_bwd", rg)])
def test_each_wrapper_adds_its_work_where_it_counts_its_launch(wrapper,
                                                               module):
    """The card tests hold each launch to one addition of its formula;
    here, the one addition sits right after the launch count, under the
    wrapper's own name, and nowhere else in the wrapper."""
    import inspect
    lines = [ln.strip() for ln in
             inspect.getsource(getattr(module, wrapper)).splitlines()]
    bump = lines.index(f"{wrapper}.launches += 1")
    adds = [i for i, ln in enumerate(lines) if "add_kernel_work(" in ln]
    assert len(adds) == 1 and f'"{wrapper}"' in lines[adds[0]]
    assert 0 < adds[0] - bump <= 2


def test_calibrate_on_the_cpu_gives_finite_positive_fields():
    hooks = T.TorchTrainerHooks(("c0", "c1"), local_steps=2, batch=4,
                                seq=16, device="cpu")
    cal = T.calibrate(hooks)
    for f in dataclasses.fields(cal):
        v = getattr(cal, f.name)
        assert math.isfinite(v) and v > 0, (f.name, v)
    assert math.isfinite(cal.ratio) and cal.ratio > 0
    # the counts are those of one whole round, every slot's steps
    wc = hooks.count_round_work()
    assert (cal.flops, cal.bytes_accessed) == (wc.flops, wc.bytes_accessed)
    with R.WorkCounter() as one_slot:
        hooks._local_train(hooks.params, hooks.mu[0],
                           hooks._next_batches()[0])
    assert cal.flops == 2 * one_slot.flops
    assert cal.mean_epoch_s(1000.0) == cal.measured_round_s * 1000.0


def test_table1_real_training_cli_at_smoke_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.table1",
         "--real-training", "--assert-comm-win", "--device", "cpu",
         "--smoke"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("dataset,algorithm,total_cost")
    assert lines[1].startswith("MNIST,fedcostaware[fp32],")
    assert lines[2].startswith("MNIST,fedcostaware[int8],")
    assert lines[-1].startswith("# comm win:")


def test_measure_round_s_is_the_median_of_its_timed_rounds(monkeypatch):
    hooks = T.TorchTrainerHooks(("c0",), local_steps=1, batch=2, seq=8,
                                device="cpu")
    # each round reads the clock at its start and end: a warm-up of 7 s,
    # then timed rounds of 1, 9 and 2 s
    ticks = iter([0.0, 7.0, 10.0, 11.0, 20.0, 29.0, 30.0, 32.0])
    monkeypatch.setattr(T.time, "perf_counter", lambda: next(ticks))
    assert hooks.measure_round_s(warmup=1, iters=3) == 2.0


@pytest.mark.parametrize("model", sorted(T1.MAIN_PATHS))
def test_real_training_runs_at_the_main_path(model, monkeypatch):
    seen = {}

    class Stop(Exception):
        pass

    def hooks(names, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(T, "TorchTrainerHooks", hooks)
    row = next(r for r in T1.ROWS if r.dataset == "MNIST")
    depth, batch, seq = T1.MAIN_PATHS[model]
    full = configs.get_config(model)
    for kw, want_cfg, want_size in [
            ({}, dataclasses.replace(full, num_layers=depth), (batch, seq)),
            ({"layers": 1}, dataclasses.replace(full, num_layers=1),
             (batch, seq)),
            ({"smoke": True}, configs.get_config(model, smoke=True),
             (T1.SMOKE_BATCH, T1.SMOKE_SEQ))]:
        with pytest.raises(Stop):
            T1.run_real(row, model=model, device="cpu", **kw)
        assert seen["cfg"] == want_cfg
        assert (seen["batch"], seen["seq"]) == want_size
        assert seen["local_steps"] == T1.LOCAL_STEPS
        assert T1.main_path(model, **kw) == (want_cfg, *want_size)


def test_real_rows_free_each_arm_s_hooks(monkeypatch):
    made = []
    real = T.TorchTrainerHooks

    def hooks(*a, **kw):
        h = real(*a, **kw)
        made.append(weakref.ref(h))
        if len(made) == 2:       # the int8 arm: the fp32 arm's are gone
            assert made[0]() is None
        return h

    monkeypatch.setattr(T, "TorchTrainerHooks", hooks)
    row = next(r for r in T1.ROWS if r.dataset == "MNIST")
    recs = T1.run_real_rows(row, rounds=1, n_clients=2, quantize=False,
                            both=True, smoke=True, device="cpu")
    assert [r["algorithm"] for r in recs] == ["fedcostaware[fp32]",
                                             "fedcostaware[int8]"]
    assert len(made) == 2 and all(ref() is None for ref in made)

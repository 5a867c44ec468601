"""The Granite 4.0-H family (`fedbench/families/granite_hybrid.py`) and
the port's granite-4.0-h-micro, on the CPU.

The port's loss and gradients at the port's SMOKE size in fp32 against
the family's plain reference on the same weights; each of the model's
options (no positions, the scale, the three multipliers) against the
reference computed in float64, with a test that the port without the
option misses it; the family's sizes where the kernel readers find
them, its parameter list as the port's tree, its model FLOPs; the new
span readers; and a whole tiny cell through the harness on both arms.
"""
import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fedbench_tiny as tiny

from fedbench.harness import spec as S, weights, work
from fedbench.reference import model as M
from repro_torch import configs
from repro_torch.common import trace
from repro_torch.common.bridge import unflatten
from repro_torch.models import lm

CELL = "granite-h-micro-d20.int8.b1x4096"
# the bars of the port against a plain fp32 computation on the same
# weights (tests/test_torch_families.py): the loss within 1e-6 of
# itself, each leaf's gradient within 1e-4 of the leaf's largest entry
# (TestLM's bar, room for two fp32 computations of one function in
# another order; on the CPU the two read alike here, at all three seeds)
LOSS_TOL, GRAD_TOL = 1e-6, 1e-4
# the port in fp32 against the reference in float64: the loss within
# 1e-6 of itself, each leaf's gradient within 2e-4 of its largest entry.
# The port's plain scan and attention compute in fp32: over the cases
# below at weight seeds 2**31 + 21 to 23 (one period, 16 tokens) the
# loss lies up to 1.0e-7 from float64 and the worst leaf up to 3.9e-5.
# A model without the option misses by far: the worst leaf by 0.24 or
# more (the loss alone may not: without the residual multiplier it moves
# 6.4e-6 at one seed)
LOSS64_TOL, GRAD64_TOL = 1e-6, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These cases are many small ops at SMOKE widths: one intra-op
    thread runs them fastest, and spares the other test workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _published():
    spec = S.benchmark()
    return S.config(spec, S.cell(spec, CELL)["config"])


def smoke_config(layers: int = 20, **options) -> dict:
    """The configuration file at the port's SMOKE sizes, float32: `layers`
    of the published layer_types, the given options changed."""
    cfg = _published()
    cfg.update(hidden_size=64, intermediate_size=96,
               shared_intermediate_size=96, num_attention_heads=4,
               num_key_value_heads=2, vocab_size=128, mamba_n_heads=8,
               mamba_d_head=16, mamba_d_state=16, mamba_chunk_size=8,
               attention_multiplier=1.0 / 16, num_hidden_layers=layers,
               torch_dtype="float32", remat=False)
    cfg["layer_types"] = cfg["published"]["layer_types"][:layers]
    cfg.update(options)
    return cfg


def _family(cfg):
    return S.family(cfg)


def _batch(seed, vocab=128, B=2, S=24):
    g = torch.Generator().manual_seed(seed)
    t = torch.randint(0, vocab, (B, S + 1), generator=g)
    return t[:, :-1], t[:, 1:]


def _port(fam, cfg, stored, tokens, labels):
    """The port's loss and gradients (flat key -> tensor)."""
    pcfg = fam.port_config(cfg)
    leaves = {k: v.clone().requires_grad_(True) for k, v in stored.items()}
    loss = lm.loss_fn(unflatten(leaves), pcfg,
                      {"tokens": tokens, "labels": labels})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _reference(fam, cfg, stored, tokens, labels, dtype=torch.float32):
    leaves = {k: v.to(dtype).requires_grad_(True) for k, v in stored.items()}
    loss = fam.loss(leaves, cfg, tokens, labels, M.Precision())
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _worst_leaf(got, want):
    """The largest gap of a leaf's gradient over the leaf's largest
    entry."""
    return max(float((got[k].double() - want[k].double()).abs().max())
               / max(float(want[k].double().abs().max()), 1e-30)
               for k in want)


# ---------------------------------------------------------------------------
# The port against the reference.
# ---------------------------------------------------------------------------
def test_the_smoke_file_is_the_port_s_smoke_config():
    cfg = smoke_config()
    got = _family(cfg).port_config(cfg)
    want = configs.get_config("granite-4.0-h-micro", smoke=True)
    assert type(got) is type(want)
    assert dataclasses.replace(got, name=want.name) == want


@pytest.mark.parametrize("seed, remat", [
    (2 ** 31 + 11, False), (2 ** 31 + 12, True), (2 ** 31 + 13, False)])
def test_port_matches_the_reference_at_smoke(seed, remat):
    cfg = smoke_config(remat=remat)
    fam = _family(cfg)
    stored = weights.make(fam, cfg, seed, "cpu")
    tokens, labels = _batch(seed % 1000, S=16)
    loss, grads = _port(fam, cfg, stored, tokens, labels)
    rloss, rgrads = _reference(fam, cfg, stored, tokens, labels)
    assert set(grads) == set(rgrads)
    assert float(loss) == pytest.approx(float(rloss), rel=LOSS_TOL)
    assert _worst_leaf(grads, rgrads) <= GRAD_TOL


OPTIONS = {"nope": {}, "rope": {"position_embedding_type": "rope"},
           "scale": {"attention_multiplier": 0.3},
           "embedding": {"embedding_multiplier": 5.0},
           "residual": {"residual_multiplier": 0.5},
           "logits": {"logits_scaling": 3.0}}
# each option's value in a model without it
WITHOUT = {"scale": {"attention_multiplier": 0.25},
           "embedding": {"embedding_multiplier": 1.0},
           "residual": {"residual_multiplier": 1.0},
           "logits": {"logits_scaling": 1.0}}


@pytest.mark.parametrize("option", [o for o in OPTIONS if o != "rope"])
def test_each_option_against_float64(option):
    """The port in fp32 against the reference in float64, each option in
    turn: the published values with one of them changed. The model
    without the option (scale 1/sqrt(h), a multiplier 1) misses the
    bars. One period of layers holds each option."""
    base = dict(embedding_multiplier=1.0, residual_multiplier=1.0,
                logits_scaling=1.0, attention_multiplier=0.25)
    cfg = smoke_config(10, **(base if option == "nope" else
                              dict(base, **OPTIONS[option])))
    fam = _family(cfg)
    stored = weights.make(fam, cfg, 2 ** 31 + 21, "cpu")
    tokens, labels = _batch(21, S=16)
    rloss, rgrads = _reference(fam, cfg, stored, tokens, labels,
                               torch.float64)
    loss, grads = _port(fam, cfg, stored, tokens, labels)
    assert float(loss) == pytest.approx(float(rloss), rel=LOSS64_TOL)
    assert _worst_leaf(grads, rgrads) <= GRAD64_TOL
    if option == "nope":
        # the same weights with RoPE compute another function
        other = smoke_config(10, **dict(base, **OPTIONS["rope"]))
    else:
        other = smoke_config(10, **dict(base, **WITHOUT[option]))
    oloss, ograds = _port(fam, other, stored, tokens, labels)
    assert abs(float(oloss) - float(rloss)) > 10 * LOSS64_TOL * float(rloss) \
        or _worst_leaf(ograds, rgrads) > 10 * GRAD64_TOL


def test_the_reference_refuses_rope():
    cfg = smoke_config(position_embedding_type="rope")
    fam = _family(cfg)
    stored = weights.make(fam, cfg, 5, "cpu")
    with pytest.raises(ValueError, match="RoPE"):
        fam.loss(stored, cfg, *_batch(5))


# ---------------------------------------------------------------------------
# The published configuration.
# ---------------------------------------------------------------------------
def test_the_published_file_is_the_port_s_model_at_20_layers():
    cfg = _published()
    fam = _family(cfg)
    pcfg = fam.port_config(cfg)
    full = configs.get_config("granite-4.0-h-micro")
    assert dataclasses.replace(pcfg, num_layers=40) == dataclasses.replace(
        full, rope_theta=pcfg.rope_theta)
    assert pcfg.num_layers == 20 and pcfg.n_super == 2
    assert sorted((k, tuple(shape), dt) for k, (shape, dt) in
                  lm.param_shapes(pcfg)) == \
        sorted((k, shape, dt) for k, shape, dt, *_ in fam.schema(cfg))
    assert lm.param_count(pcfg) == 1_698_459_520


def test_the_kernel_readers_find_the_layer_sizes():
    z = _family(_published()).dims(_published())
    za, zm = work.layer_dims(z, "attn"), work.layer_dims(z, "mamba2")
    assert (za["n"], za["k"], za["h"], za["scale"]) == (32, 8, 64, 0.015625)
    assert (zm["nh"], zm["p"], zm["n"], zm["g"], zm["chunk"]) == (
        64, 64, 128, 1, 256)
    assert z["pattern"].count("mamba2") == 9 and z["repeats"] == 2


def test_model_flops_by_hand():
    cfg = _published()
    spec = S.benchmark()
    mix = S.traffic(S.cell(spec, CELL)["traffic"])
    d, f, v = 2048, 8192, 100352
    mlp = 3 * d * f
    mamba = d * 4096 * 2 + d * 128 * 2 + d * 64 + 4096 * d + mlp
    attn = d * 32 * 64 * 2 + d * 8 * 64 * 2 + mlp
    params = 2 * (9 * mamba + attn) + d * v
    tokens = 2 * 2 * 1 * 4096
    ssd = work.ssd_flops(1, 4096, 64, 64, 128, 128)
    pairs = 4096 * 4097 // 2
    flops = 6.0 * params * tokens + 3.0 * 2 * 4 * (9 * ssd
                                                     + 4.0 * 64 * pairs * 32)
    got = _family(cfg).model_flops(cfg, mix)
    assert got == pytest.approx(flops, rel=1e-12)
    assert 1.6e14 < got < 1.8e14


def test_the_mix_and_the_limits_are_there():
    spec = S.benchmark()
    w = S.cell(spec, CELL)
    mix = S.traffic(w["traffic"])
    assert (mix["clients"], mix["local_steps"], mix["batch"], mix["seq"],
            mix["arm"]) == (2, 2, 1, 4096, "int8")
    assert set(S.limits(CELL)) >= {"loss", "grad", "grad_median", "update"}
    assert {m["name"] for m in S.per_layer(spec, CELL)} >= {
        "mamba2_mix_share", "attn_mix_share", "mlp_share",
        "flash_fwd_roofline", "ssd_fwd_roofline", "ssd_bwd_roofline"}


@pytest.mark.parametrize("metric, name", [
    ("mamba2_mix_share", "lm.mix.mamba2"), ("attn_mix_share", "lm.mix.attn"),
    ("mlp_share", "lm.mlp")])
def test_the_span_readers(metric, name):
    """A reader sums its spans' device walls in the window's rounds, under
    any span of the round, over the window; without its span it reads
    nothing."""
    trace.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for r in range(3):
                with trace.span("fl.round", round=r):
                    with trace.span("lm.forward"):
                        for _ in range(2):
                            with trace.span(name):
                                pass
        walls = iter([0.05, 0.05, 0.1, 0.1, 0.2, 0.2])
        for s in (s for r in trace.roots("fl.round") for s in r.walk()):
            if s.name == name:
                s.device_s = next(walls)
        read = S.reader(metric)
        assert read({"rounds": 2, "window_s": 1.0}) == pytest.approx(30.0)
        others = {"mamba2_mix_share", "attn_mix_share", "mlp_share"} - {
            metric}
        assert all(S.reader(m)({"rounds": 2, "window_s": 1.0}) is None
                   for m in others)
    finally:
        trace.clear()


# ---------------------------------------------------------------------------
# A whole tiny cell.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arm", ["int8", "fp32"])
def test_a_tiny_cell_is_correct(tmp_path, arm):
    """One period of the family at SMOKE widths through the harness: the
    first round agrees with the reference at float32."""
    cfg = smoke_config(layers=10, remat=True)
    root = tiny.lay_out(tmp_path, None, arm=arm, config=cfg)
    rc, line, err = tiny.run_cell(root)
    assert rc == 0, err
    gaps = {k: v["value"] for k, v in line["compared"].items()}
    assert line["correct"] is True, gaps
    assert json.loads((root / "fedbench" / "configs" / "c.json")
                      .read_text())["family"] == "granite_hybrid"

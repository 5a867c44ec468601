"""The benchmark's work arithmetic, pinned at the shapes of the port's
kernel table (PERF.md) and the published peaks, and each cell's model
FLOPs against a count made by hand."""
import importlib.util
import json

import pytest

import fedbench_tiny as tiny

from fedbench.harness import spec as S, work

PEAKS = S.peaks("NVIDIA H100 80GB HBM3")


def _reader_module(name):
    path = tiny.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"m_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ms(flops, nbytes, flops_peak):
    return 1e3 * work.bound_s(flops, nbytes, flops_peak,
                              PEAKS["hbm_bytes_s"])


def test_flash_bound_at_phi3s_shape():
    flops, nbytes = work.attention_work(4, 1024, 1024, 32, 96, 2)
    assert nbytes == 2 * 2048 * 4 * 32 * 96 * 2
    assert flops == 4.0 * 96 * (1024 * 1025 // 2) * 4 * 32
    assert round(_ms(flops, nbytes, PEAKS["bf16_flops"]), 4) == 0.0300


def test_codec_bound_over_one_phi3_delta():
    codec = _reader_module("codec_roofline")
    n = 423_508_992
    assert round(1e3 * codec.codec_bytes(n) / PEAKS["hbm_bytes_s"], 4) \
        == 0.6324


def test_ssd_bound_at_mamba2s_shape():
    ssd = _reader_module("ssd_fwd_roofline")
    nbytes = ssd.ssd_bytes(2, 2048, 64, 64, 1, 128, 2)
    flops = work.ssd_flops(2, 2048, 64, 64, 128, 128)
    assert round(_ms(flops, nbytes, PEAKS["bf16_flops"]), 4) == 0.0210


# by hand: phi3-d16 has 16 layers of 4 x 3072^2 attention and 3 x 3072 x
# 8192 MLP weights, and a 3072 x 32064 head: 1,910,439,936 parameters in
# products; a round trains 2 clients x 2 steps of batch x seq tokens;
# the causal attention forward is 4 x 96 x S(S+1)/2 x batch x 32 a layer
# and step. mamba2: 48 layers of 3 x 2048 x 4096 + 2 x 2048 x 128 +
# 2048 x 64 weights and the tied 2048 x 50280 head, 1,342,390,272; the
# scan at 128-row pieces is (2 x 8256 x 192 + 4 x 128 x 128 x 64) x 16
# pieces x 2 x 64 a layer and step; at 16 x 256 tokens a step, the same
# 32 pieces of 128 rows (2 a sequence). Beside them, pinned, the values
# `model_flops` gave before the families had files of their own.
PHI3_P = 16 * (4 * 3072 ** 2 + 3 * 3072 * 8192) + 3072 * 32064
MAMBA2_P = 48 * (3 * 2048 * 4096 + 2 * 2048 * 128 + 2048 * 64) \
    + 2048 * 50280
HAND = {
    "phi3-d16.int8.b4x1024": 6.0 * PHI3_P * 16384
    + 3 * 4.0 * 96 * (1024 * 1025 // 2) * 4 * 32 * 16 * 4,
    "mamba2.int8.b2x2048": 6.0 * MAMBA2_P * 16384
    + 3 * (2 * 8256 * 192 + 4 * 128 * 128 * 64) * 16 * 2 * 64 * 48 * 4,
    "mamba2.fp32.b16x256": 6.0 * MAMBA2_P * 16384
    + 3 * (2 * 8256 * 192 + 4 * 128 * 128 * 64) * 2 * 16 * 64 * 48 * 4,
}
BEFORE = {"phi3-d16.int8.b4x1024": 192756521631744.0,
          "mamba2.int8.b2x2048": 140649978396672.0,
          "mamba2.fp32.b16x256": 140649978396672.0}


@pytest.mark.parametrize("cell", sorted(HAND))
def test_model_flops_by_hand(cell):
    spec = S.benchmark()
    w = S.cell(spec, cell)
    cfg, mix = S.config(spec, w["config"]), S.traffic(w["traffic"])
    assert PHI3_P == 1_910_439_936 and MAMBA2_P == 1_342_390_272
    flops = S.family(cfg).model_flops(cfg, mix)
    assert flops == pytest.approx(HAND[cell], rel=1e-12)
    assert flops == BEFORE[cell]


def _ctx(**kw):
    cfg = tiny.tiny_config("attn", "bfloat16")
    fam = S.family(cfg)
    ctx = {"cfg": cfg, "mix": tiny.tiny_mix("int8", 4, 1024), "family": fam,
           "dims": fam.dims(cfg), "device": [], "window_s": 2.0, "busy_s": 1.5,
           "rounds": 2, "peaks": PEAKS, "leaf_sizes": [1000, 3000]}
    ctx.update(kw)
    return ctx


def test_readers_find_nothing_without_their_kernels():
    for name in ("flash_fwd_roofline", "ssd_fwd_roofline",
                 "codec_roofline"):
        assert S.reader(name)(_ctx()) is None
        assert S.reader(name)(_ctx(peaks=None)) is None


@pytest.mark.parametrize("name, kind, kernel", [
    ("flash_fwd_roofline", "attn",
     "void flash_fwd_sm90_kernel<16>(CUtensorMap)"),
    ("ssd_fwd_roofline", "mamba2", "void ssd_fwd_sm90_kernel<128, 16>()"),
    ("ssd_bwd_roofline", "mamba2", "void ssd_bwd_sm90_kernel<128>()")])
def test_a_kernel_reader_finds_its_kind_in_a_family_of_several(name, kind,
                                                               kernel):
    """The tests' two-kind family gives each kind's sizes under the kind's
    name; a reader reads them as it reads a family of that one kind."""
    data = tiny.BENCH / "tests" / "data"
    cfg = json.loads((data / "hybrid-tiny.json").read_text())
    z = S._module(data / "families" / "hybrid.py", "hybrid").dims(cfg)
    dev = [(kernel, 0.0, 100.0)] * 2
    got = S.reader(name)(_ctx(cfg=cfg, dims=z, device=dev))
    assert got is not None
    assert got == S.reader(name)(_ctx(cfg=cfg, dims=z[kind], device=dev))


def test_flash_reader_by_hand():
    ctx = _ctx(device=[("void flash_fwd_sm90_kernel<16>(CUtensorMap)", 0.0,
                        100.0)] * 3 + [("other", 0.0, 50.0)])
    flops, nbytes = work.attention_work(4, 1024, 1024, 4, 16, 2)
    least = work.bound_s(flops, nbytes, PEAKS["bf16_flops"],
                         PEAKS["hbm_bytes_s"])
    assert S.reader("flash_fwd_roofline")(ctx) == pytest.approx(
        100.0 * 3 * least / 300e-6)


def test_codec_reader_by_hand():
    codec = _reader_module("codec_roofline")
    dev = [("quantize_kernel(float const*)", 0.0, 10.0),
           ("dequantize_kernel(signed char const*)", 0.0, 10.0)] * 2
    got = S.reader("codec_roofline")(_ctx(device=dev))
    per = (codec.codec_bytes(1000) + codec.codec_bytes(3000)) / 2
    assert got == pytest.approx(100.0 * 4 * per / PEAKS["hbm_bytes_s"]
                                / 40e-6)


def test_mfu_and_idle_share():
    ctx = _ctx()
    flops = ctx["family"].model_flops(ctx["cfg"], ctx["mix"]) * 2
    assert S.reader("mfu")(ctx) == pytest.approx(
        100.0 * flops / (2.0 * PEAKS["bf16_flops"]))
    assert S.reader("idle_share")(ctx) == pytest.approx(25.0)
    assert S.reader("idle_share")(_ctx(busy_s=0.0)) is None

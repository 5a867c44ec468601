"""The plain reference against the port on the CPU: its pieces (the token
stream, the codec, the SSD scan, the parameter list), and the whole first
round at a tiny width of each family; and the control (the reference's
products in fp8) failing the comparison that sound rounds pass."""
import numpy as np
import pytest
import torch

import fedbench_tiny as tiny

from fedbench.harness import compare, session, weights
from fedbench.harness.program import Program
from fedbench.harness import spec as S
from fedbench.reference import fl_round, model as M


def test_token_stream_is_the_ports():
    from repro_torch.data.synthetic import token_stream
    for seed in (0, 2 ** 31 + 5):
        a = token_stream(1000, 3, 40, seed)
        b = fl_round.token_stream(1000, 3, 40, seed)
        for _ in range(3):
            x, y = next(a), next(b)
            assert np.array_equal(x["tokens"], y["tokens"])
            assert np.array_equal(x["labels"], y["labels"])


@pytest.mark.parametrize("n", [1, 2047, 2048, 5000])
def test_codec_is_the_ports(n):
    from repro_torch.kernels.grad_quant import ops as gq
    x = torch.randn(n, generator=torch.Generator().manual_seed(n)) * 1e-3
    q, s = gq.quantize(x)
    want = gq.dequantize(q, s, x.shape, torch.float32)
    assert torch.equal(fl_round.codec_roundtrip(x), want)


def test_ssd_is_the_ports():
    from repro_torch.kernels.ssd.ref import ssd_reference
    g = torch.Generator().manual_seed(3)
    b, s, h, p, n = 2, 40, 3, 4, 8
    x = torch.randn(b, s, h, p, generator=g)
    la = -torch.rand(b, s, h, generator=g)
    Bm = torch.randn(b, s, h, n, generator=g)
    Cm = torch.randn(b, s, h, n, generator=g)
    want, _ = ssd_reference(x, la, Bm, Cm, 16)
    assert torch.allclose(M.ssd(x, la, Bm, Cm, 16), want, rtol=1e-5,
                          atol=1e-5)


def test_schema_is_the_ports_at_full_size():
    from repro_torch.models import lm
    spec = S.benchmark()
    for c in spec["configs"]:
        cfg = S.config(spec, c["name"])
        fam = S.family(cfg)
        mine = {k: (tuple(s), d) for k, s, d, *_ in fam.schema(cfg)}
        port = {k: (tuple(s), d)
                for k, (s, d) in lm.param_shapes(fam.port_config(cfg))}
        assert mine == port, c["name"]


@pytest.mark.parametrize("kind", ["attn", "mamba2"])
@pytest.mark.parametrize("arm", ["int8", "fp32"])
def test_round_agrees_with_the_port(kind, arm):
    """fp32 at a tiny width: the port's first round and the reference's
    agree to float32 rounding."""
    cfg, mix = tiny.tiny_config(kind), tiny.tiny_mix(arm)
    fam = S.family(cfg)
    seed = 2 ** 31 + 11
    w0 = weights.make(fam, cfg, seed, "cpu")
    prog = Program(fam, cfg, mix, seed, w0, device="cpu")
    prog.run_round()
    got = session.program_readings(prog, w0)
    ref = session.reference_readings(fam, cfg, mix, seed,
                                     torch.device("cpu"))
    gap = compare.gaps(got, ref)
    assert compare.judge(gap, tiny.TIGHT), gap
    assert gap["loss"] < 1e-6 and gap["grad"] < 1e-4, gap


@pytest.mark.parametrize("kind", ["attn", "mamba2"])
def test_the_control_fails(kind):
    """The reference with its products in fp8 put in the program's place
    fails the limits that a sound round passes, by `grad` or `update`."""
    cfg, mix = tiny.tiny_config(kind), tiny.tiny_mix("int8")
    fam = S.family(cfg)
    seed = 2 ** 31 + 13
    dev = torch.device("cpu")
    ref = session.reference_readings(fam, cfg, mix, seed, dev)
    ctl = session.reference_readings(fam, cfg, mix, seed, dev,
                                     prec=M.Fp8Products())
    gap = compare.gaps(ctl, ref)
    assert not compare.judge(gap, tiny.TIGHT), gap


def test_limits_of_every_cell_separate_their_readings():
    """Each committed limit lies above the program's largest reading and
    below the least reading of the control or a fault that it was set
    from (`fedbench/limits/<cell>.json`)."""
    spec = S.benchmark()
    for w in spec["workloads"]:
        lim = S.limits(w["name"])
        assert any(lim[k] is not None for k in compare.NUMBERS)
        for k in compare.NUMBERS:
            r = lim["readings"][k]
            if lim[k] is None:
                # not compared: nothing separates it from sound runs
                assert r["upper"] is None, (w["name"], k)
                continue
            assert r["lower"] < lim[k] < r["upper"], (w["name"], k)

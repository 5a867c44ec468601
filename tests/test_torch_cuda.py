"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA Hopper card and `nvcc`; without a card they
skip. On the machine with the card run them with
`PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py`.
They import no JAX, so they run where only the port is installed."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.grad_quant import ops as gq
from repro_torch.kernels.rglru import ops as rg
from repro_torch.kernels.ssd import ops as sd

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # fp32 references run in full fp32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


# (B, S, N, H, dtype, window, softcap, tolerance): every head dim, ragged
# lengths, window and softcap; 2e-5 in fp32 and 2e-2 in bf16, the bars of
# the JAX package's own kernel tests. A bf16 case with tolerance None is
# held to the plain version in fp32 on the same bf16 inputs at one bf16
# rounding (`_assert_rounds_once`): every head dim of the tensor-core
# kernel, S of 77, 200, 333 and 600 (no multiple of its 128-row and
# 64-key tiles), windows and softcaps
FLASH_CASES = [
    (2, 256, 2, 64, torch.float32, None, None, 2e-5),
    (1, 512, 2, 32, torch.float32, 128, None, 2e-5),
    (2, 200, 2, 96, torch.float32, None, 30.0, 2e-5),
    (1, 300, 1, 256, torch.float32, None, None, 2e-5),
    (1, 600, 2, 256, torch.float32, 128, None, 2e-5),
    (2, 77, 4, 16, torch.float32, None, None, 2e-5),
    (1, 130, 2, 128, torch.float32, 64, 10.0, 2e-5),
    (2, 1024, 4, 96, torch.bfloat16, None, None, 2e-2),
    (1, 333, 2, 128, torch.bfloat16, 100, None, 2e-2),
    (2, 77, 2, 16, torch.bfloat16, None, None, None),
    (1, 600, 2, 16, torch.bfloat16, 128, 10.0, None),
    (1, 200, 2, 32, torch.bfloat16, 64, None, None),
    (2, 333, 1, 32, torch.bfloat16, None, 30.0, None),
    (2, 333, 2, 64, torch.bfloat16, None, 30.0, None),
    (1, 77, 3, 64, torch.bfloat16, 16, None, None),
    (1, 600, 2, 96, torch.bfloat16, 128, None, None),
    (2, 200, 2, 96, torch.bfloat16, None, 50.0, None),
    (2, 200, 3, 128, torch.bfloat16, None, 10.0, None),
    (1, 600, 1, 128, torch.bfloat16, 256, None, None),
    (1, 333, 2, 256, torch.bfloat16, 100, 20.0, None),
    (1, 600, 1, 256, torch.bfloat16, None, None, None),
    # head dim 8 (fp32 only): the SMOKE configs with d_model 64 over 8
    # heads, ragged lengths, window and softcap
    (2, 77, 8, 8, torch.float32, None, None, 2e-5),
    (1, 300, 8, 8, torch.float32, 64, 10.0, 2e-5),
    (2, 16, 8, 8, torch.float32, None, None, 2e-5),
]


def _assert_rounds_once(out, q, k, v, **opts):
    """bf16 `out` within one bf16 rounding of the plain version in fp32 on
    the same inputs: the kernel computes in fp32 and rounds each output
    to bf16 once, so it lies within half a bf16 ulp (at most 2^-8 of
    itself) of the fp32 result, plus fp32 rounding."""
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(), **opts)
    err = (out.float() - want).abs()
    bar = 2.0 ** -8 * want.abs() + 1e-5 * want.abs().max()
    assert bool((err <= bar).all()), (err / bar).max().item()


@pytest.mark.parametrize("B,S,N,H,dtype,window,softcap,tol", FLASH_CASES)
def test_flash_kernel_matches_plain(gen, B, S, N, H, dtype, window,
                                    softcap, tol):
    q, k, v = (_randn(gen, B, S, N, H, dtype=dtype) for _ in range(3))
    before = fa.flash_attention_fwd.launches
    out = fa.flash_attention_fwd(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    if tol is None:
        _assert_rounds_once(out, q, k, v, window=window, softcap=softcap)
        return
    want = fa.flash_attention_plain(q, k, v, window=window, softcap=softcap)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


def test_flash_bf16_rounds_once_at_recurrentgemma_head_dim(gen):
    # H=256 with a window, as recurrentgemma's local attention runs it
    q, k, v = (_randn(gen, 1, 1024, 2, 256, dtype=torch.bfloat16)
               for _ in range(3))
    out = fa.flash_attention_fwd(q, k, v, window=512)
    _assert_rounds_once(out, q, k, v, window=512)


@pytest.mark.parametrize("H", [64, 96])
def test_flash_bf16_reads_packed_qkv(gen, H):
    """bf16 q, k, v as views of one packed (B, S, N, 3H) tensor: the
    tensor maps read them through their strides."""
    qkv = _randn(gen, 2, 200, 3, 3 * H, dtype=torch.bfloat16)
    q, k, v = qkv[..., :H], qkv[..., H:2 * H], qkv[..., 2 * H:]
    assert all(fa.tma_ready(x) for x in (q, k, v))
    out = fa.flash_attention_fwd(q, k, v, window=64)
    _assert_rounds_once(out, q, k, v, window=64)


def test_flash_bf16_copies_a_misaligned_input(gen):
    """A bf16 q whose base address is 2 bytes off 16: TMA cannot read it
    as it lies, so the wrapper copies it, and the result is right."""
    B, S, N, H = 1, 130, 2, 64
    buf = _randn(gen, B * S * N * H + 1, dtype=torch.bfloat16)
    q = buf[1:].view(B, S, N, H)
    k, v = (_randn(gen, B, S, N, H, dtype=torch.bfloat16) for _ in range(2))
    assert q.is_contiguous() and not fa.tma_ready(q)
    before = fa.flash_attention_fwd.launches
    out = fa.flash_attention_fwd(q, k, v)
    assert fa.flash_attention_fwd.launches == before + 1
    _assert_rounds_once(out, q, k, v)


def test_flash_kernel_reads_strided_inputs(gen):
    """q, k, v as views of one packed (B, S, N, 3H) tensor."""
    qkv = _randn(gen, 2, 128, 2, 3 * 64)
    q, k, v = qkv[..., :64], qkv[..., 64:128], qkv[..., 128:]
    out = fa.flash_attention_fwd(q, k, v)
    want = fa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                    v.contiguous())
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)


def test_flash_gradients_flow_through_the_recompute(gen):
    q, k, v = (_randn(gen, 1, 128, 2, 64).requires_grad_() for _ in range(3))
    g = _randn(gen, 1, 128, 2, 64)
    got = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v), g)
    want = torch.autograd.grad(fa.flash_attention_plain(q, k, v), (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=3e-4, rtol=3e-4)


# granite-4.0-h-micro's attention: head dim 64, 32 query heads over 8 kv
# heads (expanded, as the attention layer passes them), no RoPE, the
# scores times 1/64 (its attention_multiplier, where every other config
# takes 1/sqrt(64)); bf16 within one bf16 rounding of the plain version
# in fp32 at that scale, fp32 at the reference's 2e-5
GRANITE_SCALE = 1.0 / 64


def _granite_qkv(gen, S, dtype):
    q = _randn(gen, 1, S, 32, 64, dtype=dtype)
    k, v = (_randn(gen, 1, S, 8, 64, dtype=dtype).repeat_interleave(4, dim=2)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("S", [1024, 333])
def test_flash_bf16_at_granites_scale(gen, S):
    q, k, v = _granite_qkv(gen, S, torch.bfloat16)
    before = fa.flash_attention_fwd.launches
    out = fa.flash_attention_fwd(q, k, v, scale=GRANITE_SCALE)
    assert fa.flash_attention_fwd.launches == before + 1
    _assert_rounds_once(out, q, k, v, scale=GRANITE_SCALE)
    # the scale reaches the kernel: at 1/sqrt(64) it computes otherwise
    other = fa.flash_attention_fwd(q, k, v)
    assert (other.float() - out.float()).abs().max().item() > 1e-2


def test_flash_fp32_at_granites_scale(gen):
    q, k, v = _granite_qkv(gen, 333, torch.float32)
    out = fa.flash_attention_fwd(q, k, v, scale=GRANITE_SCALE)
    want = fa.flash_attention_plain(q, k, v, scale=GRANITE_SCALE)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)


def test_flash_gradients_at_a_set_scale(gen):
    q, k, v = (_randn(gen, 1, 128, 2, 64).requires_grad_() for _ in range(3))
    g = _randn(gen, 1, 128, 2, 64)
    got = torch.autograd.grad(
        fa.flash_attention(q, k, v, scale=GRANITE_SCALE), (q, k, v), g)
    want = torch.autograd.grad(
        fa.flash_attention_plain(q, k, v, scale=GRANITE_SCALE), (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=3e-4, rtol=3e-4)


def test_flash_rejects_an_unsupported_head_dim(gen):
    q = _randn(gen, 1, 64, 1, 48)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q, q, q)


def test_flash_bf16_rejects_head_dim_8(gen):
    q = _randn(gen, 1, 64, 2, 8, dtype=torch.bfloat16)
    before = fa.flash_attention_fwd.launches
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q, q, q)
    assert fa.flash_attention_fwd.launches == before


@pytest.mark.parametrize("shape,scale", [
    ((100,), 0.01), ((17, 65, 5), 0.01), ((2, 3072, 64), 1e-3),
    ((4096 * 3 + 7,), 30.0), ((2048,), 1.0)])
def test_codec_kernels_are_bit_equal_to_plain(gen, shape, scale):
    x = _randn(gen, *shape, scale=scale)
    q, s = gq.quantize(x)
    qp, sp = gq.quantize_plain(x)
    assert torch.equal(q, qp) and torch.equal(s, sp)
    back = gq.dequantize(q, s, shape)
    assert torch.equal(back, gq.dequantize_plain(q, s, shape))


def test_codec_rounds_half_to_even(gen):
    x = torch.zeros(gq.BLOCK, device="cuda")
    x[:7] = torch.tensor([127.0, 2.5, 3.5, -2.5, -3.5, 0.5, -0.5])
    q, s = gq.quantize(x)
    assert s.item() == 1.0
    assert q[0, :7].tolist() == [127, 2, 4, -2, -4, 0, 0]


def _rel_err(got, want):
    """max |got - want| over max |want|, in fp32."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _ssd_inputs(gen, b, s, h, p, g, n, dtype=torch.float32):
    x = _randn(gen, b, s, h, p, dtype=dtype, scale=0.5)
    la = -_randn(gen, b, s, h).abs() * 0.1
    B = _randn(gen, b, s, g, n, dtype=dtype, scale=0.3)
    C = _randn(gen, b, s, g, n, dtype=dtype, scale=0.3)
    return x, la, B, C


# (b, s, h, p, g, n, chunk): fp32 on the CUDA-core kernel; ragged S,
# chunks of 8, 64 and 256, one and two groups, every state dim, a head
# dim that is not a multiple of the block's 32 columns; 1e-5 relative,
# the JAX package's own ssd bar
SSD_CASES = [
    (2, 64, 3, 16, 3, 16, 16),
    (1, 100, 4, 32, 2, 64, 8),
    (2, 300, 4, 64, 1, 128, 64),
    (1, 520, 2, 24, 1, 32, 256),
    (1, 256, 8, 64, 2, 128, 256),
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES)
def test_ssd_kernel_matches_plain(gen, b, s, h, p, g, n, chunk):
    x, la, B, C = _ssd_inputs(gen, b, s, h, p, g, n)
    before = (sd.ssd_fwd.launches, sd.ssd_fwd.sm90_launches)
    y = sd.ssd_fwd(x, la, B, C, chunk=chunk)
    torch.cuda.synchronize()
    # fp32 runs on the CUDA-core kernel
    assert (sd.ssd_fwd.launches, sd.ssd_fwd.sm90_launches) == (
        before[0] + 1, before[1])
    want, _ = sd.ssd_plain(x, la, B, C, chunk=chunk)
    assert y.dtype == x.dtype and y.shape == want.shape
    assert _rel_err(y, want) < 1e-5


def _ssd_bf16_inputs(gen, b, s, h, p, g, n, la_scale=0.1):
    x, la, B, C = _ssd_inputs(gen, b, s, h, p, g, n, torch.bfloat16)
    return x, la * (la_scale / 0.1), B, C


def _assert_ssd_rounds_once(y, x, la, B, C, chunk=256):
    """bf16 `y` within one bf16 rounding of the plain version in fp32 on
    the same bf16 inputs: the kernels compute in fp32 (the tensor-core
    one carries its three fp32 operands as bf16 hi + lo) and round each
    output to bf16 once, so it lies within half a bf16 ulp (at most 2^-8
    of itself) of the fp32 result, plus fp32 rounding."""
    want, _ = sd.ssd_plain(x.float(), la, B.float(), C.float(), chunk=chunk)
    err = (y.float() - want).abs()
    bar = 2.0 ** -8 * want.abs() + 1e-5 * want.abs().max()
    assert bool((err <= bar).all()), (err / bar).max().item()


def test_ssd_kernel_bf16_at_the_main_shape(gen):
    """mamba2-1.3b's layer: b=2, s=2048, 64 heads x 64, one group of 128;
    bf16 inputs and output on the tensor-core kernel, 2e-2 of the largest
    output against the plain version in bf16, and one bf16 rounding
    against it in fp32."""
    x, la, B, C = _ssd_inputs(gen, 2, 2048, 64, 64, 1, 128, torch.bfloat16)
    before = sd.ssd_fwd.sm90_launches
    y = sd.ssd_fwd(x, la, B, C, chunk=256)
    torch.cuda.synchronize()
    assert sd.ssd_fwd.sm90_launches == before + 1
    want, _ = sd.ssd_plain(x, la, B, C, chunk=256)
    assert y.dtype == torch.bfloat16
    assert _rel_err(y, want) < 2e-2
    _assert_ssd_rounds_once(y, x, la, B, C)


def test_ssd_bf16_rounds_once_at_strong_decays(gen):
    """The main shape at mamba2-like decays, log a = -|z|: cs falls by
    about a hundred over a piece of 128 rows."""
    x, la, B, C = _ssd_bf16_inputs(gen, 2, 2048, 64, 64, 1, 128, 1.0)
    y = sd.ssd_fwd(x, la, B, C, chunk=256)
    _assert_ssd_rounds_once(y, x, la, B, C)


# (b, s, h, p, g, n, chunk, log-decay scale): bf16 on the tensor-core
# kernel at every state dim, p of 24, 32, 40, 64, 96 and 128 (padded to
# 64 or 128 by TMA's zero fill), one, two and three groups, S of 77 to
# 1000 (no multiple of its 128-row pieces), decays of 0.1 to 1; each held
# to one bf16 rounding of the fp32 plain version
SSD_BF16_CASES = [
    (2, 300, 4, 64, 1, 128, 256, 0.1),
    (1, 520, 2, 32, 1, 16, 64, 1.0),
    (2, 200, 4, 128, 2, 32, 256, 0.1),
    (1, 77, 3, 64, 3, 64, 16, 1.0),
    (1, 1000, 4, 128, 1, 128, 256, 1.0),
    (2, 129, 2, 96, 2, 64, 128, 0.1),
    (1, 333, 2, 24, 1, 128, 8, 0.1),
    (1, 256, 8, 64, 2, 16, 256, 0.5),
    (1, 64, 2, 40, 1, 32, 32, 1.0),
    (2, 450, 2, 128, 1, 64, 256, 0.5),
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,la_scale", SSD_BF16_CASES)
def test_ssd_bf16_kernel_rounds_once(gen, b, s, h, p, g, n, chunk, la_scale):
    x, la, B, C = _ssd_bf16_inputs(gen, b, s, h, p, g, n, la_scale)
    before = sd.ssd_fwd.sm90_launches
    y = sd.ssd_fwd(x, la, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert sd.ssd_fwd.sm90_launches == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    _assert_ssd_rounds_once(y, x, la, B, C, chunk)


def test_ssd_bf16_head_dim_off_the_tensor_maps_runs_on_cuda_cores(gen):
    """bf16 with p = 20, no multiple of 8, goes to the CUDA-core kernel,
    which also rounds its fp32 result once."""
    x, la, B, C = _ssd_bf16_inputs(gen, 1, 200, 2, 20, 1, 64)
    before = (sd.ssd_fwd.launches, sd.ssd_fwd.sm90_launches)
    y = sd.ssd_fwd(x, la, B, C, chunk=64)
    torch.cuda.synchronize()
    assert (sd.ssd_fwd.launches, sd.ssd_fwd.sm90_launches) == (
        before[0] + 1, before[1])
    _assert_ssd_rounds_once(y, x, la, B, C, 64)


def test_ssd_bf16_reads_packed_views(gen):
    """x, B and C as views of one packed bf16 tensor, as `mamba2_mix`
    slices B and C out of the convolution's output: the tensor maps read
    them through their strides, with no copy."""
    b, s, h, p, n = 2, 300, 4, 64, 128
    packed = _randn(gen, b, s, h * p + 2 * n, dtype=torch.bfloat16,
                    scale=0.4)
    x = packed[..., :h * p].reshape(b, s, h, p)
    B = packed[..., h * p:h * p + n].reshape(b, s, 1, n)
    C = packed[..., h * p + n:].reshape(b, s, 1, n)
    assert all(sd.tma_ready(t) for t in (x, B, C))
    la = -_randn(gen, b, s, h).abs() * 0.5
    y = sd.ssd_fwd(x, la, B, C, chunk=256)
    _assert_ssd_rounds_once(y, x, la, B, C)


def test_ssd_bf16_copies_a_misaligned_input(gen):
    """A bf16 x whose base address is 2 bytes off 16: TMA cannot read it
    as it lies, so the wrapper copies it, and the result is right."""
    b, s, h, p, n = 1, 200, 2, 64, 64
    buf = _randn(gen, b * s * h * p + 1, dtype=torch.bfloat16, scale=0.5)
    x = buf[1:].view(b, s, h, p)
    _, la, B, C = _ssd_bf16_inputs(gen, b, s, h, p, 1, n)
    assert x.is_contiguous() and not sd.tma_ready(x)
    before = sd.ssd_fwd.sm90_launches
    y = sd.ssd_fwd(x, la, B, C, chunk=64)
    assert sd.ssd_fwd.sm90_launches == before + 1
    _assert_ssd_rounds_once(y, x, la, B, C, 64)


def test_ssd_bf16_copies_an_expanded_group(gen):
    """B and C expanded from one group to two (a stride of 0): the
    wrapper copies them for the tensor maps."""
    b, s, h, p, n = 2, 150, 4, 32, 32
    x, la, B, C = _ssd_bf16_inputs(gen, b, s, h, p, 1, n)
    B2, C2 = B.expand(b, s, 2, n), C.expand(b, s, 2, n)
    assert not sd.tma_ready(B2)
    y = sd.ssd_fwd(x, la, B2, C2, chunk=32)
    _assert_ssd_rounds_once(y, x, la, B2.contiguous(), C2.contiguous(), 32)


def _assert_ssd_bwd_rounds_once(got, x, la, B, C, gy, chunk=256):
    """The bf16 backward's four gradients: each of x's, B's and C's dtype
    and shape (dlog_a fp32), within one bf16 rounding of the plain
    recompute in fp32 on the same bf16 inputs."""
    want = sd.ssd_bwd_plain(x.float(), la, B.float(), C.float(), gy.float(),
                            chunk=chunk)
    for o, w, ref in zip(got, want, (x, la, B, C)):
        assert o.dtype == ref.dtype and o.shape == ref.shape
        err = (o.float() - w).abs()
        bar = 2.0 ** -8 * w.abs() + 1e-5 * w.abs().max()
        assert bool((err <= bar).all()), (err / bar).max().item()


# (b, s, h, p, g, n, log-decay scale): the bf16 backward at mamba2-1.3b's
# layer, every state dim, p of 32, 64 and 128 (one and two blocks of 64
# columns), one and two groups, S of 77 to 1000 (no multiple of its
# 128-row pieces), decays of 0.1 to 1
SSD_BWD_CASES = [
    (2, 2048, 64, 64, 1, 128, 0.1),
    (2, 2048, 64, 64, 1, 128, 1.0),
    (2, 1000, 8, 64, 1, 128, 1.0),
    (1, 520, 8, 64, 2, 128, 1.0),
    (2, 300, 4, 64, 1, 16, 0.5),
    (2, 333, 4, 32, 1, 32, 1.0),
    (1, 77, 3, 128, 3, 64, 0.1),
    (1, 520, 4, 128, 2, 128, 1.0),
]


@pytest.mark.parametrize("b,s,h,p,g,n,la_scale", SSD_BWD_CASES)
def test_ssd_bwd_kernel_rounds_once(gen, b, s, h, p, g, n, la_scale):
    x, la, B, C = _ssd_bf16_inputs(gen, b, s, h, p, g, n, la_scale)
    gy = _randn(gen, b, s, h, p, dtype=torch.bfloat16)
    before = (sd.ssd_bwd.launches, sd.ssd_bwd.sm90_launches)
    got = sd.ssd_bwd(x, la, B, C, gy, chunk=256)
    torch.cuda.synchronize()
    assert (sd.ssd_bwd.launches, sd.ssd_bwd.sm90_launches) == (
        before[0] + 1, before[1] + 1)
    _assert_ssd_bwd_rounds_once(got, x, la, B, C, gy)


def test_ssd_bwd_through_autograd_on_packed_views(gen):
    """The op's backward on the views `mamba2_mix` hands it (x, B and C
    out of one packed tensor), through autograd."""
    b, s, h, p, n = 2, 300, 4, 64, 128
    packed = _randn(gen, b, s, h * p + 2 * n, dtype=torch.bfloat16,
                    scale=0.4)
    x = packed[..., :h * p].reshape(b, s, h, p)
    B = packed[..., h * p:h * p + n].reshape(b, s, 1, n)
    C = packed[..., h * p + n:].reshape(b, s, 1, n)
    la = -_randn(gen, b, s, h).abs() * 0.5
    gy = _randn(gen, b, s, h, p, dtype=torch.bfloat16)
    ins = [t.detach().requires_grad_() for t in (x, la, B, C)]
    before = sd.ssd_bwd.sm90_launches
    y, _ = sd.ssd(*ins, chunk=256)
    got = torch.autograd.grad(y, ins, gy)
    assert sd.ssd_bwd.sm90_launches == before + 1
    _assert_ssd_bwd_rounds_once(got, x, la, B, C, gy)


def test_ssd_bwd_fp32_keeps_the_plain_recompute(gen):
    """fp32 on the card: no backward kernel, the plain recompute."""
    x, la, B, C = _ssd_inputs(gen, 1, 200, 2, 64, 1, 64)
    gy = _randn(gen, 1, 200, 2, 64)
    before = (sd.ssd_bwd.launches, sd.ssd_bwd.sm90_launches)
    got = sd.ssd_bwd(x, la, B, C, gy, chunk=64)
    assert (sd.ssd_bwd.launches, sd.ssd_bwd.sm90_launches) == before
    for a, w in zip(got, sd.ssd_bwd_plain(x, la, B, C, gy, chunk=64)):
        assert torch.equal(a, w)


def test_ssd_kernel_reads_strided_and_expanded_inputs(gen):
    """x, B and C as views of one packed tensor, as `mamba2_mix` slices
    them out of the convolution's output, and B as an expanded view."""
    b, s, h, p, n = 2, 96, 4, 16, 16
    packed = _randn(gen, b, s, h * p + 2 * n, scale=0.4)
    x = packed[..., :h * p].reshape(b, s, h, p)
    B = packed[..., h * p:h * p + n].reshape(b, s, 1, n)
    C = packed[..., h * p + n:].reshape(b, s, 1, n)
    la = -_randn(gen, b, s, h).abs() * 0.1
    y = sd.ssd_fwd(x, la, B, C, chunk=32)
    want, _ = sd.ssd_plain(x.contiguous(), la, B.contiguous(),
                           C.contiguous(), chunk=32)
    assert _rel_err(y, want) < 1e-5
    B2 = _randn(gen, b, s, 1, n).expand(b, s, 2, n)
    y2 = sd.ssd_fwd(x, la, B2, C.expand(b, s, 2, n), chunk=32)
    want2, _ = sd.ssd_plain(x, la, B2.contiguous(),
                            C.expand(b, s, 2, n).contiguous(), chunk=32)
    assert _rel_err(y2, want2) < 1e-5


def test_ssd_gradients_flow_through_the_recompute(gen):
    ins = [t.requires_grad_() for t in _ssd_inputs(gen, 1, 64, 4, 16, 2, 16)]
    gy = _randn(gen, 1, 64, 4, 16)
    y, _ = sd.ssd(*ins, chunk=16)
    got = torch.autograd.grad(y, ins, gy)
    want = torch.autograd.grad(sd.ssd_plain(*ins, chunk=16)[0], ins, gy)
    for a, b in zip(got, want):
        assert _rel_err(a, b) < 1e-5


def test_ssd_rejects_an_unsupported_state_dim(gen):
    x, la, B, C = _ssd_inputs(gen, 1, 16, 2, 16, 1, 48)
    with pytest.raises(ValueError, match="state dim"):
        sd.ssd_fwd(x, la, B, C, chunk=8)


def _rglru_inputs(gen, B, S, W):
    # recurrentgemma's decays: log a = -8 r softplus(lam), down to about -55
    la = -torch.rand(B, S, W, generator=gen, device="cuda") * 8.0
    return la, _randn(gen, B, S, W, scale=0.5)


# (B, S, W): recurrentgemma's layer at full width, ragged S and W, S
# shorter than one segment of the kernel's chunks; 1e-5 relative
RGLRU_CASES = [(1, 4096, 2560), (2, 100, 24), (3, 37, 130), (1, 1000, 16)]


@pytest.mark.parametrize("B,S,W", RGLRU_CASES)
def test_rglru_kernel_matches_plain_both_ways(gen, B, S, W):
    la, u = _rglru_inputs(gen, B, S, W)
    f0, r0 = rg.rglru_scan_fwd.launches, rg.rglru_scan_reverse.launches
    h = rg.rglru_scan_fwd(la, u)
    g = rg.rglru_scan_reverse(la, u)
    torch.cuda.synchronize()
    assert (rg.rglru_scan_fwd.launches, rg.rglru_scan_reverse.launches) \
        == (f0 + 1, r0 + 1)
    assert _rel_err(h, rg.rglru_scan_ref(la, u)) < 1e-5
    assert _rel_err(g, rg.rglru_scan_reverse_ref(la, u)) < 1e-5


def test_rglru_kernel_reads_strided_inputs(gen):
    packed = _randn(gen, 2, 300, 2 * 48)
    la, u = -packed[..., :48].abs(), packed[..., 48:]
    torch.testing.assert_close(
        rg.rglru_scan_fwd(la, u),
        rg.rglru_scan_ref(la.contiguous(), u.contiguous()),
        atol=1e-5, rtol=1e-5)
    lat = -_randn(gen, 2, 48, 300).abs().transpose(1, 2)
    assert _rel_err(rg.rglru_scan_reverse(lat, u),
                    rg.rglru_scan_reverse_ref(lat.contiguous(), u)) < 1e-5


def test_rglru_backward_runs_the_reverse_kernel(gen):
    """The autograd backward is one launch of the fused backward, the
    kernel's reverse mode writing db and dlog_a, and nothing else."""
    la, u = _rglru_inputs(gen, 2, 200, 40)
    la.requires_grad_()
    u.requires_grad_()
    gh = _randn(gen, 2, 200, 40)
    h = rg.rglru_scan(la, u)
    b0, r0 = rg.rglru_scan_bwd.launches, rg.rglru_scan_reverse.launches
    got = torch.autograd.grad(h, (la, u), gh)
    assert (rg.rglru_scan_bwd.launches, rg.rglru_scan_reverse.launches) \
        == (b0 + 1, r0)
    want = torch.autograd.grad(rg.rglru_scan_ref(la, u), (la, u), gh)
    for a, b in zip(got, want):
        assert _rel_err(a, b) < 1e-5


def _assert_rglru_bwd(la, u, gh, got):
    """The fused backward's (dlog_a, db) for h = the scan of (la, u)
    within 1e-5 of the largest entry of the autograd gradient of the
    plain forward."""
    la, u = (x.detach().clone().requires_grad_() for x in (la, u))
    want = torch.autograd.grad(rg.rglru_scan_ref(la, u), (la, u), gh)
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert (a - w).abs().max() <= 1e-5 * w.abs().max()


# the card cases, S = 1 (dlog_a is 0) and S = 16384 at a narrow width,
# several rounds of a cluster of 8
RGLRU_BWD_CASES = RGLRU_CASES + [(2, 1, 40), (1, 16384, 24)]


@pytest.mark.parametrize("B,S,W", RGLRU_BWD_CASES)
def test_rglru_fused_backward_matches_plain(gen, B, S, W):
    la, u = _rglru_inputs(gen, B, S, W)
    gh = _randn(gen, B, S, W)
    b0 = rg.rglru_scan_bwd.launches
    got = rg.rglru_scan_bwd(la, rg.rglru_scan_ref(la, u), gh)
    torch.cuda.synchronize()
    assert rg.rglru_scan_bwd.launches == b0 + 1
    _assert_rglru_bwd(la, u, gh, got)


def test_rglru_fused_backward_reads_strided_inputs(gen):
    lat = -_randn(gen, 2, 48, 300).abs().transpose(1, 2)
    packed = _randn(gen, 2, 300, 3 * 48)
    u, gh, h = packed[..., :48], packed[..., 48:96], packed[..., 96:]
    h.copy_(rg.rglru_scan_ref(lat, u))
    got = rg.rglru_scan_bwd(lat, h, gh)
    want = rg.rglru_scan_bwd_ref(lat.contiguous(), h.contiguous(),
                                 gh.contiguous())
    for a, w in zip(got, want):
        assert _rel_err(a, w) < 1e-5
    _assert_rglru_bwd(lat, u, gh, got)


def test_rglru_kernel_takes_64_bit_offsets(gen):
    """Views whose time stride times S passes 2^31 elements go to the
    kernel's 64-bit instances: four (1, 40, 20) views 2^26 elements a
    step apart in one 10.7 GB buffer."""
    B, S, W, ss = 1, 40, 20, 1 << 26
    buf = torch.empty(S * ss + 4 * W, device="cuda")
    la, u, gh, h = (buf.as_strided((B, S, W), (0, ss, 1), k * W)
                    for k in range(4))
    la.copy_(-torch.rand(B, S, W, generator=gen, device="cuda") * 8.0)
    u.copy_(_randn(gen, B, S, W))
    gh.copy_(_randn(gen, B, S, W))
    h.copy_(rg.rglru_scan_ref(la, u))
    assert _rel_err(rg.rglru_scan_fwd(la, u), h) < 1e-5
    assert _rel_err(rg.rglru_scan_reverse(la, u),
                    rg.rglru_scan_reverse_ref(la, u)) < 1e-5
    _assert_rglru_bwd(la, u, gh, rg.rglru_scan_bwd(la, h, gh))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_smoke_model_gradients_match_the_plain_versions(gen, arch,
                                                        monkeypatch):
    """A SMOKE model's loss and gradients on the card through the kernels
    against the same on the card with every kernel's plain version
    swapped in: what the kernels change on the training path, apart from
    the card's other sums. recurrentgemma's fp32 gradients lie about
    2e-3 of a leaf's largest entry from float64 on either device, so
    this, not card against CPU, is where the kernels are held to 1e-4."""
    from repro_torch import configs
    from repro_torch.common.bridge import flatten_with_paths, unflatten
    from repro_torch.models import lm

    cfg = configs.get_config(arch, smoke=True)
    params = dict(flatten_with_paths(lm.init_params(cfg, 0, "cuda")))
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def loss_and_grads():
        leaves = {k: v.detach().clone().requires_grad_() for k, v in
                  params.items()}
        loss = lm.loss_fn(unflatten(leaves), cfg, batch)
        return loss.item(), torch.autograd.grad(loss, list(leaves.values()))

    before = (sd.ssd_fwd.launches, rg.rglru_scan_fwd.launches)
    loss, grads = loss_and_grads()
    assert (sd.ssd_fwd.launches, rg.rglru_scan_fwd.launches) != before
    monkeypatch.setattr(sd, "ssd_fwd", lambda x, la, B, C, *, chunk:
                        sd.ssd_plain(x, la, B, C, chunk=chunk)[0])
    monkeypatch.setattr(rg, "rglru_scan_fwd", rg.rglru_scan_ref)
    monkeypatch.setattr(rg, "rglru_scan_reverse", rg.rglru_scan_reverse_ref)
    monkeypatch.setattr(rg, "rglru_scan_bwd", rg.rglru_scan_bwd_ref)
    monkeypatch.setattr(fa, "flash_attention_fwd", fa.flash_attention_plain)
    plain_loss, plain_grads = loss_and_grads()
    assert loss == pytest.approx(plain_loss, rel=1e-6)
    for k, a, b in zip(params, grads, plain_grads):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max(), k


def test_each_kernel_adds_its_work_once_a_launch(gen):
    """Under a `WorkCounter` every launch adds its own formula's FLOPs and
    bytes once, under its wrapper's name, and the modes see no product
    of the kernels' own."""
    from repro_torch.launch import roofline as R

    q, k, v = (_randn(gen, 2, 256, 2, 64, dtype=torch.bfloat16)
               for _ in range(3))
    x = _randn(gen, 5000)
    xs, la_s, Bm, Cm = _ssd_bf16_inputs(gen, 1, 300, 2, 64, 1, 64)
    la, u = _rglru_inputs(gen, 2, 100, 24)
    n_blocks = -(-5000 // gq.BLOCK)
    cases = [
        ("flash_attention_fwd",
         lambda: fa.flash_attention_fwd(q, k, v, window=100),
         R.attention_work(2, 256, 256, 2, 64, 2, window=100)),
        ("quantize", lambda: gq.quantize(x),
         R.codec_work(5000, n_blocks, gq.BLOCK)),
        ("dequantize", lambda: gq.dequantize(*gq.quantize(x), x.shape),
         R.codec_work(5000, n_blocks, gq.BLOCK, dequantize=True)),
        # the tensor-core kernel runs 128-row pieces whatever the chunk
        ("ssd_fwd", lambda: sd.ssd_fwd(xs, la_s, Bm, Cm, chunk=256),
         R.ssd_work(1, 300, 2, 64, 1, 64, sd.SM90_PIECE, 2)),
        ("rglru_scan_fwd", lambda: rg.rglru_scan_fwd(la, u),
         R.rglru_work(la.numel())),
        ("rglru_scan_reverse", lambda: rg.rglru_scan_reverse(la, u),
         R.rglru_work(la.numel())),
        ("rglru_scan_bwd", lambda: rg.rglru_scan_bwd(la, u, u),
         R.rglru_work(la.numel(), backward=True)),
    ]
    for name, fn, (flops, nbytes) in cases:
        with R.WorkCounter() as wc:
            fn()
        torch.cuda.synchronize()
        assert wc.kernels[name] == [1, float(flops), float(nbytes)], name
        assert wc.aten_flops == 0, name


def _runner_run(device, quantize):
    """The port's runner driving phi3 SMOKE hooks on `device` for two
    rounds, on a market that prices egress: its result and trace."""
    from repro_torch.common.config import (CloudConfig, ClientProfile,
                                           FLRunConfig, MarketConfig,
                                           ProviderConfig)
    from repro_torch.fl.runner import FLCloudRunner
    from repro_torch.fl.training import TorchTrainerHooks

    names = ("client_0", "client_1")
    hooks = TorchTrainerHooks(names, local_steps=2, batch=2, seq=64,
                              quantize=quantize, device=device)
    market = MarketConfig(providers=(ProviderConfig(
        name="aws", on_demand_rate=1.0, spot_rate_mean=0.4,
        spot_rate_sigma=0.0, update_egress_usd_per_mb=0.001,
        uplink_mbps=100.0),))
    cfg = FLRunConfig(
        dataset="t", n_epochs=2, policy="fedcostaware", seed=0,
        quantize_updates=quantize,
        clients=tuple(ClientProfile(n, mean_epoch_s=60.0 + 30.0 * i,
                                    jitter=0.0)
                      for i, n in enumerate(names)))
    runner = FLCloudRunner(cfg, cloud_cfg=CloudConfig(spot_rate_sigma=0.0,
                                                      market=market),
                           hooks=hooks, record=True)
    res = runner.run()
    assert len(hooks.losses) == 2
    return res, runner.recorder.dumps()


@pytest.mark.parametrize("quantize", [False, True])
def test_runner_on_the_card_bills_as_on_the_cpu(gen, quantize):
    """The dollars depend only on the profiles and the payload bytes, so
    the card's run must reproduce the CPU's exactly."""
    got, got_trace = _runner_run("cuda", quantize)
    want, want_trace = _runner_run("cpu", quantize)
    assert got.comm_cost > 0.0
    assert got.total_cost == pytest.approx(want.total_cost, abs=1e-9)
    assert got.comm_cost == pytest.approx(want.comm_cost, abs=1e-9)
    assert got.per_round_participants == want.per_round_participants
    assert got_trace == want_trace


def test_measured_peaks_on_the_card(gen):
    from repro_torch.fl.training import _measure_peaks
    flops_s, bw = _measure_peaks("cuda")
    assert flops_s > 100e12 and bw > 1e12, (flops_s, bw)


def _cnn_epoch(model, dataset, device, dtype, n):
    """One local epoch over `n` images (batches of 32) of `model` at
    `dataset`'s size and full width, its forward and backward in
    `dtype`: the initial and final parameters on the CPU, and the
    epoch's loss."""
    import numpy as np
    from repro_torch.common.bridge import flatten_with_paths, tree_map
    from repro_torch.data.synthetic import (DATASET_SPECS, make_dataset,
                                            minibatches)
    from repro_torch.fl.client import FLClient
    from repro_torch.models import cnn
    from repro_torch.optim.optimizers import adamw

    img, ch, nc = DATASET_SPECS[dataset]
    ds = make_dataset(dataset, n, seed=0)
    params, fn, _ = cnn.build(model, torch.Generator().manual_seed(0), nc,
                              ch, img, device=device)
    params = tree_map(lambda t: t.to(dtype), params)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32

    def data_fn(r):
        for x, y in minibatches(ds, np.arange(n), 32, seed=r):
            yield x.astype(np_dtype), y
    out, m = FLClient("c", fn, adamw(lr=1e-3), data_fn, n,
                      device=device).train_epoch(params, 0)
    return ({k: v.cpu().double() for k, v in flatten_with_paths(params)},
            {k: v.cpu().double() for k, v in flatten_with_paths(out)},
            m.loss)


# small_cnn's fp32 epoch is well conditioned. resnet18's is not: a ReLU
# whose input lies within rounding of 0 passes or stops its gradient at
# random, and adamw turns a small gradient's noise into a full step. Its
# forward and backward run in float64, over one step: even in float64
# the card's epoch parts from the CPU's, seeded in adamw's fp32 path
# (`tools/cnn_fp32_spread.py` measures both)
@pytest.mark.parametrize("model,dataset,dtype,n", [
    ("small_cnn", "mnist", torch.float32, 96),
    ("resnet18", "cifar10", torch.float64, 32)])
def test_cnn_local_epoch_on_the_card_matches_the_cpu(gen, model, dataset,
                                                     dtype, n):
    """Every parameter within 2% of its leaf's largest update plus 2 fp32
    ulps of its largest entry, and the same epoch loss to 1e-5."""
    init, got, got_loss = _cnn_epoch(model, dataset, "cuda", dtype, n)
    _, want, want_loss = _cnn_epoch(model, dataset, "cpu", dtype, n)
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    for k, w in want.items():
        update = (w - init[k]).abs().max().item()
        ulp = torch.finfo(torch.float32).eps * w.abs().max().item()
        assert update <= ulp or not torch.equal(got[k], init[k]), k
        assert (got[k] - w).abs().max().item() <= 2e-2 * update + 2 * ulp, k


@pytest.mark.parametrize("quantize", [False, True])
def test_granite_smoke_round_on_the_card_matches_the_cpu(gen, quantize):
    """One FL round of granite-moe SMOKE (MoE, GQA, fp32 flash on the
    card) on the card against the same round on the CPU: losses within
    2e-4, each parameter within 2% of its update on the CPU plus 2 ulps,
    and every leaf the CPU moves by more than an ulp moves on the card.
    At lr 2e-4, as chip_smoke.py's SMOKE_LR says why."""
    from repro_torch.common.bridge import flatten_with_paths
    from repro_torch.fl.training import TorchTrainerHooks

    runs = []
    for device in ("cuda", "cpu"):
        hooks = TorchTrainerHooks(("client_0", "client_1"),
                                  model="granite-moe-3b-a800m", smoke=True,
                                  local_steps=2, batch=2, seq=64, lr=2e-4,
                                  quantize=quantize, device=device)
        init = {k: v.cpu() for k, v in flatten_with_paths(hooks.params)}
        before = fa.flash_attention_fwd.launches
        for c in hooks.clients:
            hooks.run_local(c, 0)
        hooks.aggregate(list(hooks.clients), 0)
        if device == "cuda":
            # 2 attention layers x 2 clients x 2 steps
            assert fa.flash_attention_fwd.launches == before + 8
        runs.append(({k: v.cpu() for k, v in flatten_with_paths(hooks.params)},
                     hooks.losses[-1]["mean_loss"]))
    (gpu, gpu_loss), (cpu, cpu_loss) = runs
    assert gpu_loss == pytest.approx(cpu_loss, abs=2e-4)
    for k in cpu:
        update = (cpu[k] - init[k]).abs().max().item()
        ulp = torch.finfo(cpu[k].dtype).eps * cpu[k].abs().max().item()
        assert update <= ulp or not torch.equal(gpu[k], init[k]), k
        assert (gpu[k] - cpu[k]).abs().max().item() <= 2e-2 * update + 2 * ulp, k


def test_learned_forecast_row_on_the_card_reconciles(gen, tmp_path):
    """The real-training Table I row under the learned forecast policy,
    int8 arm, at phi3 SMOKE size on the card (`chip_smoke.py` runs it at
    the main path): the kernels launch exactly as its rounds train, it
    polls during training (`ForecastUpdated` records), and the port's
    report reconciles its log and sums it to the run's dollars."""
    from repro_torch.benchmarks import table1 as T1
    from repro_torch.cloud.report import (RECONCILE_TOL, reconcile_path,
                                          summarize_path)
    from repro_torch.forecast import register_learned_policy
    from repro_torch.models import lm

    pol = register_learned_policy()
    row = next(r for r in T1.ROWS if r.dataset == "MNIST")
    cfg = T1.main_path("phi3-mini-3.8b", smoke=True)[0]
    log = tmp_path / "learned.events.jsonl"
    before = (fa.flash_attention_fwd.launches, gq.quantize.launches,
              gq.dequantize.launches)
    res, hooks, cal = T1.run_real(row, policy=pol.name, rounds=2,
                                  n_clients=2, quantize=True, record_to=log,
                                  smoke=True, device="cuda")
    torch.cuda.synchronize()
    # calibration: warm-up and timed rounds, one counted; then the run's
    # 2 rounds; each round trains 2 clients x LOCAL_STEPS steps through
    # every attention layer, and codes each participant delta's leaves
    rounds = T1.CAL_WARMUP + T1.CAL_ITERS + 1 + 2
    steps = rounds * 2 * T1.LOCAL_STEPS
    codec = 2 * 2 * len(lm.param_shapes(cfg))
    assert [sorted(p) for p in res.per_round_participants] == \
        [["client_0", "client_1"]] * 2
    assert (fa.flash_attention_fwd.launches - before[0],
            gq.quantize.launches - before[1],
            gq.dequantize.launches - before[2]) == \
        (steps * cfg.num_layers, codec, codec)
    rec = reconcile_path(log)
    assert rec.ok and abs(rec.delta) <= RECONCILE_TOL, rec.first_divergence
    assert abs(summarize_path(log)["totals"]["total"] - res.total_cost) <= 1e-9
    assert log.read_text().count('"type": "ForecastUpdated"') > 0


def _renders(log_dir):
    """The port's fig4 and fig5 over `log_dir`'s row.events.jsonl, run
    from that directory so both name the log alike."""
    import contextlib
    import io
    import os
    from repro_torch.benchmarks import fig4_timeline, fig5_costs

    out, cwd = io.StringIO(), os.getcwd()
    os.chdir(log_dir)
    try:
        with contextlib.redirect_stdout(out):
            fig4_timeline.main(["--replay", "row.events.jsonl"])
            fig5_costs.main(["--replay", "row.events.jsonl"])
    finally:
        os.chdir(cwd)
    return out.getvalue()


def test_real_row_renders_as_on_the_cpu(gen, tmp_path, monkeypatch):
    """The real-training Table I row, int8 arm, at phi3 SMOKE size
    recorded on the card, rendered by the port's fig4 and fig5, renders
    byte for byte as the same row recorded on the CPU. A round's
    measured time is its device's own, so the CPU's row takes the card's
    calibration; the rest of the log is the runner's."""
    from repro_torch.benchmarks import table1 as T1
    from repro_torch.fl import training as T

    row = next(r for r in T1.ROWS if r.dataset == "MNIST")
    runs = {}
    for device in ("cuda", "cpu"):
        (tmp_path / device).mkdir()
        runs[device] = T1.run_real(
            row, rounds=2, n_clients=2, quantize=True, smoke=True,
            record_to=tmp_path / device / "row.events.jsonl", device=device)
        monkeypatch.setattr(T, "calibrate",
                            lambda hooks, cal=runs["cuda"][2], **kw: cal)
    (got, _, _), (want, _, _) = runs["cuda"], runs["cpu"]
    assert got.total_cost == pytest.approx(want.total_cost, abs=1e-9)
    assert got.comm_cost > 0
    text = _renders(tmp_path / "cuda")
    assert text == _renders(tmp_path / "cpu")
    assert text.startswith("# MNIST, 2 clients x 2 epochs, fedcostaware")
    assert f"# total = ${got.total_cost:.4f}" in text

"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA Hopper card and `nvcc`; without a card they
skip. On the machine with the card run them with
`PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py`.
They import no JAX, so they run where only the port is installed."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.grad_quant import ops as gq

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
# the JAX package's own kernel tests
FLASH_CASES = [
    (2, 256, 2, 64, torch.float32, None, None, 2e-5),
    (1, 512, 2, 32, torch.float32, 128, None, 2e-5),
    (2, 200, 2, 96, torch.float32, None, 30.0, 2e-5),
    (1, 300, 1, 256, torch.float32, None, None, 2e-5),
    (2, 77, 4, 16, torch.float32, None, None, 2e-5),
    (1, 130, 2, 128, torch.float32, 64, 10.0, 2e-5),
    (2, 1024, 4, 96, torch.bfloat16, None, None, 2e-2),
    (1, 333, 2, 128, torch.bfloat16, 100, None, 2e-2),
]


@pytest.mark.parametrize("B,S,N,H,dtype,window,softcap,tol", FLASH_CASES)
def test_flash_kernel_matches_plain(gen, B, S, N, H, dtype, window,
                                    softcap, tol):
    q, k, v = (_randn(gen, B, S, N, H, dtype=dtype) for _ in range(3))
    before = fa.flash_attention_fwd.launches
    out = fa.flash_attention_fwd(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, window=window, softcap=softcap)
    assert out.dtype == dtype and out.shape == want.shape
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


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


def test_flash_rejects_an_unsupported_head_dim(gen):
    q = _randn(gen, 1, 64, 1, 48)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q, q, q)


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

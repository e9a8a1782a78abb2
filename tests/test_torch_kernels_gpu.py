"""The port's CUDA kernels (K1 attention forward, K2 attention backward, K3
and K4 the int8 quantizers) against their plain versions, on the card.

JAX-free, so that it runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Without a CUDA device every test skips (decided inside the fixture).
"""

import pytest
import torch

from msclip_torch.models.layers import build_causal_mask
from msclip_torch.ops import attention as A
from msclip_torch.ops import quant as Q

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
BWD_TOL = {torch.float32: (2e-4, 1e-4), torch.bfloat16: (1e-2, 2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,causal", [(256, 50, False), (64, 77, True),
                                        (8, 197, False), (5, 77, True)])
def test_attention_kernel_matches_plain(cuda, dtype, B, L, causal):
    gen = torch.Generator(device=cuda).manual_seed(L)
    qkv = torch.randn(B, L, 3 * 768, device=cuda, generator=gen).to(dtype)
    mask = build_causal_mask(L, device=cuda) if causal else None
    before = A.fused_attention_qkv.launches
    got = A.fused_attention_qkv(qkv, 12, mask)
    torch.cuda.synchronize()
    assert A.fused_attention_qkv.launches == before + 1
    want = A.attention_qkv_plain(qkv, 12, mask)
    assert got.dtype == dtype and got.shape == (B, L, 768)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,H", [(768, 12), (256, 4)])
@pytest.mark.parametrize("L", [1, 17, 64, 65, 129, 256])
def test_attention_kernel_edge_lengths(cuda, dtype, E, H, L):
    """Lengths at and around the kernels' padding buckets, causal."""
    gen = torch.Generator(device=cuda).manual_seed(L)
    qkv = torch.randn(3, L, 3 * E, device=cuda, generator=gen).to(dtype)
    mask = build_causal_mask(L, device=cuda)
    got = A.fused_attention_qkv(qkv, H, mask)
    torch.cuda.synchronize()
    want = A.attention_qkv_plain(qkv, H, mask)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


def test_attention_kernel_refuses_a_bad_mask(cuda):
    qkv = torch.zeros(2, 77, 3 * 768, device=cuda)
    with pytest.raises(ValueError):
        A.fused_attention_qkv(qkv, 12, build_causal_mask(77))  # CPU mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("E,H", [(768, 12), (256, 4)])
@pytest.mark.parametrize("L", [1, 17, 64, 65, 129, 256])
def test_attention_bwd_kernel_edge_lengths(cuda, dtype, causal, E, H, L):
    """K2 against its plain version at and around the padding buckets,
    elementwise. fp32 is held to the JAX package's grad-test tolerance
    (atol 2e-4, rtol 1e-4); bf16 to atol 1e-2, rtol 2e-2, room for one
    bf16 ulp of the output (2^-7 relative at most) where the kernel and
    the plain version, summing in another order, round to neighbours."""
    gen = torch.Generator(device=cuda).manual_seed(L)
    qkv = torch.randn(3, L, 3 * E, device=cuda, generator=gen).to(dtype)
    g = torch.randn(3, L, E, device=cuda, generator=gen).to(dtype)
    mask = build_causal_mask(L, device=cuda) if causal else None
    before = A.fused_attention_qkv_bwd.launches
    got = A.fused_attention_qkv_bwd(qkv, g, H, mask)
    torch.cuda.synchronize()
    assert A.fused_attention_qkv_bwd.launches == before + 1
    want = A.attention_qkv_bwd_plain(qkv, g, H, mask)
    assert got.dtype == dtype and got.shape == qkv.shape
    assert torch.isfinite(got.float()).all()
    atol, rtol = BWD_TOL[dtype]
    diff = (got.float() - want.float()).abs()
    assert (diff <= atol + rtol * want.float().abs()).all(), \
        diff.max().item()


def test_attention_autograd_round_trip_on_the_card(cuda):
    """Gradients through FusedAttentionQKV on the card (K1 forward, K2
    backward) against torch autograd of the plain forward."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    B, L, E, H = 4, 77, 768, 12
    x = torch.randn(B, L, 3 * E, device=cuda, generator=gen)
    g = torch.randn(B, L, E, device=cuda, generator=gen)
    mask = build_causal_mask(L, device=cuda)
    grads, launches = [], []
    for fn in (A.fused_attention_qkv, A.attention_qkv_plain):
        qkv = x.clone().requires_grad_(True)
        before = (A.fused_attention_qkv.launches,
                  A.fused_attention_qkv_bwd.launches)
        (fn(qkv, H, mask) * g).sum().backward()
        torch.cuda.synchronize()
        grads.append(qkv.grad)
        launches.append((A.fused_attention_qkv.launches - before[0],
                         A.fused_attention_qkv_bwd.launches - before[1]))
    assert launches == [(1, 1), (0, 0)]
    diff = (grads[0] - grads[1]).abs()
    assert (diff <= 2e-4 + 1e-4 * grads[1].abs()).all(), diff.max().item()


# K3/K4: q within 1 of the plain version's where the LayerNorm sums in
# another order; per row |s - s_plain| <= 1e-6 s_plain in fp32 and one bf16
# ulp of the row's largest |h| (2^-7 relative) in bf16; q * s within one
# quantization step of the plain dequant: the step of the larger scale
# (each rounds h to its own grid, half a step either way), plus what the
# two scales' difference moves the largest value, 127 |s - s_plain|
S_RTOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}
TIES = (127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5)


def _assert_quant_close(got, want, dtype):
    (q, s), (qp, sp) = got, want
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == qp.shape and s.shape == sp.shape
    assert (q.int() - qp.int()).abs().max().item() <= 1
    assert ((s - sp).abs() <= S_RTOL[dtype] * sp).all()
    # in fp64, where q s is exact: one step reads exactly one step
    q, s, qp, sp = q.double(), s.double(), qp.double(), sp.double()
    deq = (q * s[..., None] - qp * sp[..., None]).abs()
    step = torch.maximum(s, sp) + 127 * (s - sp).abs()
    assert (deq <= step[..., None]).all()


def _ln_inputs(B, L, E, dtype, gen, cuda):
    x = torch.randn(B, L, E, device=cuda, generator=gen).to(dtype)
    w = 1 + 0.1 * torch.randn(E, device=cuda, generator=gen)
    b = 0.1 * torch.randn(E, device=cuda, generator=gen)
    return x, w.to(dtype), b.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E", [64, 768, 3072])
@pytest.mark.parametrize("L", [1, 17, 96, 197, 256])
def test_quant_kernels_match_plain(cuda, dtype, E, L):
    gen = torch.Generator(device=cuda).manual_seed(L + E)
    x, w, b = _ln_inputs(3, L, E, dtype, gen, cuda)
    before = (Q.ln_quant.launches, Q.gelu_quant.launches)
    got_ln, got_gelu = Q.ln_quant(x, w, b), Q.gelu_quant(x)
    torch.cuda.synchronize()
    assert (Q.ln_quant.launches, Q.gelu_quant.launches) == \
        (before[0] + 1, before[1] + 1)
    _assert_quant_close(got_ln, Q.ln_quant_plain(x, w, b), dtype)
    _assert_quant_close(got_gelu, Q.gelu_quant_plain(x), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E", [64, 768, 3072])
def test_quant_kernels_edge_rows(cuda, dtype, E):
    """Constant rows give h = bias exactly: with the ties as bias, s = 1
    and q rounds half to even; zero rows with a zero bias (K3) or zero
    input (K4) give s = 1e-8 and q = 0."""
    ties = torch.tensor(TIES, device=cuda).repeat(E // len(TIES) + 1)[:E]
    x = torch.tensor([0.0, 1.0, -3.0, 0.5, 1024.0], device=cuda)[:, None]
    x = x.expand(5, E).contiguous().to(dtype)
    w = torch.linspace(-2, 2, E, device=cuda).to(dtype)
    q, s = Q.ln_quant(x, w, ties.to(dtype))
    want = torch.round(ties).to(torch.int8)
    assert (q == want).all() and (s == 1.0).all()
    assert want[:7].tolist() == [127, 0, 2, 2, 0, -2, -2]
    q, s = Q.ln_quant(x, w, torch.zeros_like(w))
    assert (q == 0).all() and (s == 1e-8).all()
    q, s = Q.gelu_quant(torch.zeros(4, E, device=cuda, dtype=dtype))
    assert (q == 0).all() and (s == torch.tensor(1e-8)).all()


def test_quant_kernels_refuse_bad_inputs(cuda):
    x = torch.randn(2, 8, 772, device=cuda)
    w = torch.ones(772, device=cuda)
    with pytest.raises(ValueError, match="E % 8"):
        Q.ln_quant(x, w, w)
    with pytest.raises(ValueError, match="contiguous"):
        Q.gelu_quant(torch.randn(2, 8, 776, device=cuda)[..., 8:])
    with pytest.raises(TypeError):
        Q.gelu_quant(torch.randn(2, 8, 768, device=cuda).half())
    with pytest.raises(ValueError, match="weight and bias"):
        Q.ln_quant(torch.randn(2, 8, 768, device=cuda), w, w)

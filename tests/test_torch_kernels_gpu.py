"""The port's CUDA kernels (K1 forward, K2 backward) against their plain
versions, on the card.

JAX-free, so that it runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Without a CUDA device every test skips (decided inside the fixture).
"""

import pytest
import torch

from msclip_torch.models.layers import build_causal_mask
from msclip_torch.ops import attention as A

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

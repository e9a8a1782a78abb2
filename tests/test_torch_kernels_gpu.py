"""The port's CUDA kernels against their plain versions, on the card.

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

"""The port's attention core against the JAX package's, fp32 on the CPU.

``msclip_torch.ops.attention.fused_attention_qkv`` on a CPU tensor runs the
plain version of the CUDA kernel; it is held against the Pallas kernel in
interpret mode and against the XLA path of ``layers._attention_core``.
The kernel itself is checked on the card by ``chip_smoke.py`` and
``tests/test_torch_kernels_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msclip_tpu.models import layers as JL
from msclip_tpu.ops import fused_attention_qkv as jax_fused_attention_qkv
from msclip_torch.models import layers as TL
from msclip_torch.ops import attention as TA

ATOL = 2e-5  # fp32, sums in another order than XLA's


def _qkv(B, L, E, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, L, 3 * E)).astype(np.float32)


@pytest.mark.parametrize("L_seq,causal", [(50, False), (77, True),
                                          (197, False)])
def test_plain_matches_pallas_and_xla(L_seq, causal):
    B, H, E = 5, 2, 128
    qkv = _qkv(B, L_seq, E, seed=L_seq)
    jmask = JL.build_causal_mask(L_seq) if causal else None
    tmask = TL.build_causal_mask(L_seq) if causal else None
    got = TA.fused_attention_qkv(torch.from_numpy(qkv), H, tmask).numpy()
    pallas = np.asarray(jax_fused_attention_qkv(
        jnp.asarray(qkv), H, jmask, interpret=True))
    xla = np.asarray(JL._attention_core(jnp.asarray(qkv), H, jmask))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(got, xla, atol=ATOL, rtol=1e-5)


def test_causal_mask_matches_jax():
    np.testing.assert_array_equal(TL.build_causal_mask(77).numpy(),
                                  np.asarray(JL.build_causal_mask(77)))


def test_cpu_path_is_plain_and_launches_nothing():
    qkv = torch.from_numpy(_qkv(3, 50, 64, seed=1))
    before = TA.fused_attention_qkv.launches
    got = TA.fused_attention_qkv(qkv, 1)
    assert torch.equal(got, TA.attention_qkv_plain(qkv, 1))
    assert TA.fused_attention_qkv.launches == before


def test_plain_bf16_rounds_weights_like_the_kernel():
    """In bf16 the softmax weights are rounded to bf16 before the PV
    product; the result stays within the kernel tests' bf16 tolerance of
    the fp32 computation."""
    qkv = torch.from_numpy(_qkv(2, 50, 128, seed=2))
    got = TA.attention_qkv_plain(qkv.bfloat16(), 2)
    assert got.dtype == torch.bfloat16
    want = TA.attention_qkv_plain(qkv, 2)
    torch.testing.assert_close(got.float(), want, atol=3e-2, rtol=3e-2)


def test_no_kernel_for_other_devices():
    with pytest.raises(ValueError, match="no attention kernel"):
        TA.fused_attention_qkv(torch.empty(2, 50, 384, device="meta"), 2)


@pytest.mark.parametrize("case", [
    "dtype", "layout", "contiguous", "head_dim", "seq_len", "mask_dtype",
    "mask_shape"])
def test_kernel_input_checks(case):
    """What the CUDA wrapper refuses, checked on CPU tensors (the checks
    run before any launch)."""
    B, L, E, H = 2, 50, 128, 2
    qkv = torch.zeros(B, L, 3 * E)
    mask = None
    if case == "dtype":
        qkv = qkv.half()
    elif case == "layout":
        qkv = torch.zeros(B, L, 3 * E + 1)
    elif case == "contiguous":
        qkv = torch.zeros(B, 3 * E, L).transpose(1, 2)
    elif case == "head_dim":
        H = 4  # head width 24
        qkv = torch.zeros(B, L, 3 * 96)
    elif case == "seq_len":
        qkv = torch.zeros(B, 257, 3 * E)
    elif case == "mask_dtype":
        mask = torch.zeros(L, L, dtype=torch.float64)
    elif case == "mask_shape":
        mask = torch.zeros(L + 1, L + 1)
    with pytest.raises((TypeError, ValueError)):
        TA._check_cuda_inputs(qkv, H, mask)


def test_kernel_refuses_grad():
    qkv = torch.zeros(2, 50, 384, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        TA._check_cuda_inputs(qkv, 2, None)

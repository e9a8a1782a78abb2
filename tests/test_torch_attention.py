"""The port's attention core against the JAX package's, fp32 on the CPU.

``msclip_torch.ops.attention.fused_attention_qkv`` on a CPU tensor runs the
plain versions of the CUDA kernels (forward and backward); they are held
against the Pallas kernels in interpret mode and against the XLA path of
``layers._attention_core``. The kernels themselves are checked on the card
by ``chip_smoke.py`` and ``tests/test_torch_kernels_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msclip_tpu.models import layers as JL
from msclip_tpu.ops import fused_attention_qkv as jax_fused_attention_qkv
from msclip_torch.models import layers as TL
from msclip_torch.ops import attention as TA

ATOL = 2e-5  # fp32, sums in another order than XLA's


def _qkv(B, L, E, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, L, 3 * E)).astype(np.float32)


# the masks the CUDA kernels' staging must handle, beside none (False) and
# the causal one (True): a random -inf pattern over finite values, with
# one finite score per row; keys 16-31 masked on every row; the trailing
# 16-key tile masked on every row
MASKS = (False, True, "random", "band", "trailing")


def _mask(L, kind):
    """The additive fp32 ``[L, L]`` mask of ``kind`` as numpy, or None."""
    if kind is False:
        return None
    if kind is True:
        return np.array(JL.build_causal_mask(L), np.float32)
    rng = np.random.default_rng(L)
    m = np.zeros((L, L), np.float32)
    if kind == "random":
        off = rng.random((L, L)) < 0.5
        off[np.arange(L), rng.integers(0, L, L)] = False
        m = np.where(off, -np.inf, 0.5 * rng.standard_normal((L, L)))
    elif kind == "band":
        m[:, 16:32] = -np.inf
    else:
        m[:, 16 * ((L - 1) // 16):] = -np.inf
    assert np.isfinite(m).any(axis=1).all()
    return m.astype(np.float32)


@pytest.mark.parametrize("L_seq,causal", [(50, False), (77, True),
                                          (197, False)] + [
    (L, kind) for L in (50, 77, 197) for kind in MASKS[2:]])
def test_plain_matches_pallas_and_xla(L_seq, causal):
    B, H, E = 5, 2, 128
    qkv = _qkv(B, L_seq, E, seed=L_seq)
    mask = _mask(L_seq, causal)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
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
    "mask_shape", "grad_dtype", "grad_shape", "grad_contiguous"])
def test_kernel_input_checks(case):
    """What the CUDA wrappers refuse, checked on CPU tensors (the checks
    run before any launch)."""
    B, L, E, H = 2, 50, 128, 2
    qkv = torch.zeros(B, L, 3 * E)
    mask, g = None, None
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
    elif case == "grad_dtype":
        g = torch.zeros(B, L, E, dtype=torch.bfloat16)
    elif case == "grad_shape":
        g = torch.zeros(B, L, 3 * E)
    elif case == "grad_contiguous":
        g = torch.zeros(B, E, L).transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        TA._check_cuda_inputs(qkv, H, mask, g)


def test_kernel_takes_grad_and_cpu_backward_is_plain():
    """The wrappers take a tensor that needs a gradient; on the CPU the
    backward of ``fused_attention_qkv`` is the plain backward, and no
    kernel is launched."""
    TA._check_cuda_inputs(torch.zeros(2, 50, 384, requires_grad=True), 2,
                          None, torch.zeros(2, 50, 128))
    x = torch.from_numpy(_qkv(3, 50, 128, seed=3))
    g = torch.from_numpy(_qkv(3, 50, 128, seed=4)[..., :128].copy())
    qkv = x.clone().requires_grad_(True)
    launches = (TA.fused_attention_qkv.launches,
                TA.fused_attention_qkv_bwd.launches)
    TA.fused_attention_qkv(qkv, 2).backward(g)
    assert torch.equal(qkv.grad, TA.attention_qkv_bwd_plain(x, g, 2))
    assert (TA.fused_attention_qkv.launches,
            TA.fused_attention_qkv_bwd.launches) == launches


@pytest.mark.parametrize("L_seq,causal", [(50, False), (77, True),
                                          (21, True)] + [
    (L, kind) for L in (50, 77) for kind in MASKS[2:]])
def test_plain_backward_matches_the_pallas_vjp(L_seq, causal):
    """K2's plain version against the VJP of the JAX kernel in interpret
    mode (its custom VJP is the Pallas backward kernel), with the JAX
    package's grad-test tolerance."""
    B, H, E = 3, 2, 128
    qkv = _qkv(B, L_seq, E, seed=10 + L_seq)
    g = np.random.default_rng(L_seq).standard_normal(
        (B, L_seq, E)).astype(np.float32)
    mask = _mask(L_seq, causal)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    _, vjp = jax.vjp(lambda t: jax_fused_attention_qkv(
        t, H, jmask, interpret=True, lane_pack=1), jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(g))
    got = TA.attention_qkv_bwd_plain(torch.from_numpy(qkv),
                                     torch.from_numpy(g), H, tmask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_is_the_gradient_of_the_plain_forward(causal):
    x = torch.from_numpy(_qkv(2, 33, 128, seed=5))
    g = torch.randn(2, 33, 128, generator=torch.Generator().manual_seed(0))
    mask = TL.build_causal_mask(33) if causal else None
    qkv = x.clone().requires_grad_(True)
    TA.attention_qkv_plain(qkv, 2, mask).backward(g)
    torch.testing.assert_close(TA.attention_qkv_bwd_plain(x, g, 2, mask),
                               qkv.grad, atol=1e-5, rtol=1e-5)


def test_gradcheck_of_the_plain_pair():
    """``FusedAttentionQKV`` on float64 CPU tensors (its plain forward and
    backward) against finite differences."""
    qkv = torch.randn(1, 5, 3 * 64, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(0),
                      requires_grad=True)
    mask = TL.build_causal_mask(5).double()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # ~2k tiny evaluations: threads only contend
    try:
        for m in (mask, None):
            assert torch.autograd.gradcheck(
                lambda t: TA.FusedAttentionQKV.apply(t, 1, m), (qkv,))
    finally:
        torch.set_num_threads(threads)


def test_softmax_division_sequence_rounds_as_ieee_division():
    """The CUDA kernels divide the softmax weights by the row sum without
    IEEE division (``csrc/hopper.cuh`` ``rcp_rn``, ``div_rn``): the sum's
    reciprocal from an approximation and two fp64 Newton steps, rounded to
    fp32; then per weight ``q = x r`` and ``q + (x - q y) r``, each fma
    rounded once. Emulated with numpy (fp64 products of fp32 values are
    exact, fp64 sums round far below an fp32 ulp), both round as the
    division does on 2^20 random row sums in [1, 256] and weights."""
    rng = np.random.default_rng(0)
    n = 1 << 20
    y = (1 + 255 * rng.random(n)).astype(np.float32)
    ref = np.float32(1) / y
    for ulps in (-2, 2):  # the approximation two ulps off either way
        r = (ref.view(np.int32) + ulps).view(np.float32).astype(np.float64)
        for _ in range(2):
            r = r + r * (1.0 - y.astype(np.float64) * r)
        assert (r.astype(np.float32) == ref).all()
    x = (rng.random(n) * np.exp2(-rng.integers(0, 40, n))).astype(np.float32)
    q = x * ref
    rem = (x.astype(np.float64) - q.astype(np.float64) * y).astype(np.float32)
    quotient = (q + rem.astype(np.float64) * ref).astype(np.float32)
    assert (quotient == x / y).all()
    assert (q != x / y).any()  # the product alone does not round so

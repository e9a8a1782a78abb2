"""The attention core's wrapper features against the JAX package's, on the
CPU: lane packing (``lane_pack``), forward and gradient, against JAX's
``fused_attention_qkv(lane_pack=...)`` with the Pallas kernels in interpret
mode; ``fused_attention`` over head-split inputs, after
``tests/test_kernels.py``'s cases; and the tuning table (``ops/tuning.py``)
with its environment overrides."""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msclip_tpu.models import layers as JL
from msclip_tpu.ops import attention as JA
from msclip_tpu.ops import tuning as JT
from msclip_torch.models import layers as TL
from msclip_torch.ops import attention as TA
from msclip_torch.ops import tuning as TT

# fp32, sums in another order than the Pallas kernels'
# (tests/test_torch_attention.py); the gradient is a sum over L keys more
ATOL, GRAD_ATOL = 2e-5, 5e-5
# bf16: tests/test_kernels.py's limit for the bf16 core
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def _qkv(B, L, E, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, L, 3 * E)).astype(np.float32)


@pytest.mark.parametrize("B,L,lane_pack,pack", [
    (4, 50, 1, 1),   # off
    (4, 50, 2, 2),   # two rows of 50 in one row of 100
    (6, 40, 3, 3),   # three of 40
    (6, 50, 3, 2),   # 3 x 50 > 128: shrinks to 2
    (5, 40, 3, 1),   # 5 rows divide by neither 3 nor 2: shrinks to 1
    (4, 77, 2, 1),   # 2 x 77 > 128: off
])
def test_lane_pack_matches_jax(B, L, lane_pack, pack):
    """The port's pack (JAX's rule) and its forward and gradient against
    JAX's at the same ``lane_pack``, each held to the unpacked result."""
    H, E = 2, 128
    assert TA.lane_pack_for(B, L, lane_pack, False) == pack
    qkv = _qkv(B, L, E, seed=B * L)
    g = np.random.default_rng(1).standard_normal((B, L, E)).astype(np.float32)

    def jloss(x):
        out = JA.fused_attention_qkv(x, H, None, interpret=True,
                                     lane_pack=lane_pack)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(qkv))
    x = torch.from_numpy(qkv).requires_grad_(True)
    got = TA.fused_attention_qkv(x, H, lane_pack=lane_pack)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad),
                               atol=GRAD_ATOL, rtol=1e-5)
    unpacked = TA.fused_attention_qkv(torch.from_numpy(qkv), H, lane_pack=1)
    np.testing.assert_allclose(got.detach().numpy(), unpacked.numpy(),
                               atol=ATOL, rtol=1e-5)


def test_lane_pack_leaves_masked_rows_alone():
    """With a mask nothing packs, whatever ``lane_pack`` says (JAX: the
    caller's mask owns the score tile)."""
    assert TA.lane_pack_for(4, 50, 2, True) == 1
    qkv = torch.from_numpy(_qkv(4, 50, 128, seed=3))
    mask = TL.build_causal_mask(50)
    assert torch.equal(TA.fused_attention_qkv(qkv, 2, mask, lane_pack=2),
                       TA.fused_attention_qkv(qkv, 2, mask, lane_pack=1))


def test_pack_mask_is_jax_s_and_cached():
    m = TA.pack_mask(50, 2, torch.device("cpu"))
    np.testing.assert_array_equal(m.numpy(), JA._pack_mask_np(50, 2))
    assert TA.pack_mask(50, 2, torch.device("cpu")) is m


def test_default_pack_comes_from_the_table(monkeypatch):
    """No ``lane_pack``: the table's row for the tensor's device, which
    ``MSCLIP_ATTN_PACK`` overrides as it does JAX's."""
    seen = []
    real = TA.FusedAttentionQKV.apply
    monkeypatch.setattr(TA.FusedAttentionQKV, "apply",
                        lambda qkv, *a: seen.append(qkv.shape[1])
                        or real(qkv, *a))
    qkv = torch.from_numpy(_qkv(4, 50, 128, seed=4))
    TA.fused_attention_qkv(qkv, 2)
    monkeypatch.setenv("MSCLIP_ATTN_PACK", "2")
    TA.fused_attention_qkv(qkv, 2)
    assert seen == [50, 100]


def _heads(B, H, L, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, L, D)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("L_seq,causal,dtype", [
    (50, False, "float32"), (77, False, "float32"), (197, False, "float32"),
    (77, True, "float32"), (50, False, "bfloat16")])
def test_fused_attention_matches_jax(L_seq, causal, dtype):
    """``fused_attention`` over ``[B, H, L, D]`` against JAX's, in interpret
    mode: fp32 at ``ATOL`` and bf16 at tests/test_kernels.py's 3e-2."""
    q, k, v = _heads(2, 3, L_seq, 64, seed=L_seq)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jmask = JL.build_causal_mask(L_seq) if causal else None
    want = JA.fused_attention(*(jnp.asarray(t).astype(jdt) for t in (q, k, v)),
                              jmask, interpret=True)
    got = TA.fused_attention(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)),
                             TL.build_causal_mask(L_seq) if causal else None)
    assert got.shape == (2, 3, L_seq, 64) and got.dtype == tdt
    tol = dict(atol=ATOL, rtol=1e-5) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_tuning_default_row_is_jax_s():
    """The CPU and any device the table does not name take JAX's default
    row (v5e); the table names Hopper."""
    JT.get_tuning.cache_clear()
    jax_row = JT.get_tuning()
    mine = TT.get_tuning()
    assert (mine.int8_min_seq, mine.attn_lane_pack) == \
        (jax_row.int8_min_seq, jax_row.attn_lane_pack) == (96, 1)
    assert TT.DEFAULT == mine and TT.device_key(None) == "cpu"
    assert TT.device_key("cpu") == "cpu" and "sm_90" in TT._TABLE
    assert TL.int8_min_seq() == TL.INT8_MIN_SEQ == 96


@pytest.mark.parametrize("var,field,value", [
    ("MSCLIP_INT8_MIN_SEQ", "int8_min_seq", "64"),
    ("MSCLIP_ATTN_PACK", "attn_lane_pack", "2")])
def test_tuning_overrides_read_as_jax_reads_them(monkeypatch, var, field,
                                                 value):
    monkeypatch.setenv(var, value)
    JT.get_tuning.cache_clear()
    try:
        assert getattr(TT.get_tuning(), field) == \
            getattr(JT.get_tuning(), field) == int(value)
    finally:
        JT.get_tuning.cache_clear()
    monkeypatch.delenv(var)
    assert getattr(TT.get_tuning(), field) == getattr(TT.DEFAULT, field)


@pytest.mark.parametrize("var", ["MSCLIP_ATTN_VMEM", "MSCLIP_QUANT_VMEM"])
def test_vmem_budgets_warn_once_and_change_nothing(monkeypatch, caplog, var):
    monkeypatch.setenv(var, str(1 << 20))
    TT._warn_no_counterpart.cache_clear()
    with caplog.at_level(logging.WARNING):
        first, second = TT.get_tuning(), TT.get_tuning()
    assert first == second == TT.DEFAULT
    warned = [r for r in caplog.records if var in r.getMessage()]
    assert len(warned) == 1 and "no counterpart" in warned[0].getMessage()

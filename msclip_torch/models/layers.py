"""Core functional layers, the eval and train subset of
``msclip_tpu/models/layers.py``.

Parameters use the reference MS-CLIP ``state_dict`` layout (PyTorch's own):
linear weights ``[out, in]``, conv weights OIHW, activations NCHW inside the
convolutions. Parameters may be stored fp32; ``x``'s dtype is the compute
dtype, and every weight is cast to it at use, as in the JAX package.

Semantics that differ from PyTorch's defaults and are kept on purpose:

* ``layer_norm``: statistics in fp32, ``rsqrt(var + 1e-12)``, the normalized
  value cast to the compute dtype *before* the affine, which is applied in
  that dtype (reference ``clip_openai_pe_res_v1.py:204-219``);
* ``batch_norm``: in eval the running statistics are folded into one fp32
  scale/offset, then cast; in training the batch statistics are taken in
  fp32 as ``E[x^2] - E[x]^2``, the normalisation and affine run in fp32,
  and the new running statistics use momentum 0.1 and the unbiased
  variance. Its eps is the caller's (1e-5 or 1e-6).

A block quantized for eval (``models/quantize.py``, ``TPU.INT8_EVAL``)
holds each GEMM weight ``<key>`` as ``<key>_int8`` and ``<key>_scale``;
its linears then run W8A8 (``msclip_tpu/models/layers.py:117-145,
218-288``): per-token activation scales, the int8 GEMM with int32
accumulate (``torch._int_mm``), and the dequant ``y * s_a * w_scale`` in
fp32, cast to the compute dtype before the bias is added.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from ..ops.attention import fused_attention_qkv
from ..ops.quant import gelu_quant, ln_quant, quantize_rows_plain

BLOCK_KEYS = (
    "ln_1.weight", "ln_1.bias",
    "attn.in_proj_weight", "attn.in_proj_bias",
    "attn.out_proj.weight", "attn.out_proj.bias",
    "ln_2.weight", "ln_2.bias",
    "mlp.c_fc.weight", "mlp.c_fc.bias",
    "mlp.c_proj.weight", "mlp.c_proj.bias",
)
# the block's GEMM weights, which int8 eval stores as <key>_int8, <key>_scale
GEMM_KEYS = ("attn.in_proj_weight", "attn.out_proj.weight",
             "mlp.c_fc.weight", "mlp.c_proj.weight")
INT8_SUFFIXES = ("_int8", "_scale")
# the shortest sequence whose quantized block takes the fused quantizers
# K3/K4 (msclip_tpu/ops/tuning.py:63-66, ``int8_min_seq``); shorter ones
# quantize each GEMM input on the fly. ``MSCLIP_INT8_MIN_SEQ`` overrides it,
# as in the JAX package (msclip_tpu/ops/tuning.py:94)
INT8_MIN_SEQ = 96


def int8_min_seq() -> int:
    """The fused int8 gate: ``MSCLIP_INT8_MIN_SEQ`` if set, read at call
    time, else :data:`INT8_MIN_SEQ`."""
    return int(os.environ.get("MSCLIP_INT8_MIN_SEQ", INT8_MIN_SEQ))


# ---------------------------------------------------------------------------
# initializers (each draws from an explicit torch.Generator)
# ---------------------------------------------------------------------------

def trunc_normal(shape, generator, std=0.02):
    """timm ``trunc_normal_(std=0.02)``: clipped at +-2 absolute."""
    t = torch.empty(shape)
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0, 2.0,
                                       generator=generator)


def normal(shape, generator, std=1.0):
    return torch.randn(shape, generator=generator) * std


def xavier_uniform(shape, generator):
    """``nn.init.xavier_uniform_`` for a ``[out, in]`` weight."""
    fan_out, fan_in = shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


def init_layer_norm(prefix, dim):
    return {f"{prefix}.weight": torch.ones(dim),
            f"{prefix}.bias": torch.zeros(dim)}


def init_batch_norm(prefix, dim):
    return {f"{prefix}.weight": torch.ones(dim),
            f"{prefix}.bias": torch.zeros(dim),
            f"{prefix}.running_mean": torch.zeros(dim),
            f"{prefix}.running_var": torch.ones(dim)}


def init_conv(key, k, c_in, c_out, generator, groups=1, std=0.02):
    """OIHW conv weight; ``c_in`` is the full input channel count."""
    return {key: trunc_normal((c_out, c_in // groups, k, k), generator, std)}


def init_block(prefix, dim, generator, std=0.02):
    """Residual attention block: xavier-uniform in-projection (the
    reference's ``Attention_CUST._reset_parameters``), trunc-normal(0.02)
    out-projection and MLP, zero biases, unit LayerNorms."""
    p = {f"{prefix}.attn.in_proj_weight":
         xavier_uniform((3 * dim, dim), generator),
         f"{prefix}.attn.in_proj_bias": torch.zeros(3 * dim),
         f"{prefix}.attn.out_proj.weight":
         trunc_normal((dim, dim), generator, std),
         f"{prefix}.attn.out_proj.bias": torch.zeros(dim),
         f"{prefix}.mlp.c_fc.weight":
         trunc_normal((4 * dim, dim), generator, std),
         f"{prefix}.mlp.c_fc.bias": torch.zeros(4 * dim),
         f"{prefix}.mlp.c_proj.weight":
         trunc_normal((dim, 4 * dim), generator, std),
         f"{prefix}.mlp.c_proj.bias": torch.zeros(dim)}
    p.update(init_layer_norm(f"{prefix}.ln_1", dim))
    p.update(init_layer_norm(f"{prefix}.ln_2", dim))
    return p


def stored_names(params, prefix, key):
    """The names under which the block at ``prefix`` stores ``key``: the
    key itself, or a quantized GEMM weight's int8 tensor and scale."""
    if key in GEMM_KEYS and f"{prefix}.{key}" not in params:
        return tuple(key + suffix for suffix in INT8_SUFFIXES)
    return (key,)


def block_params(params, prefix):
    """The tensors of the block at ``prefix``, under local names."""
    return {name: params[f"{prefix}.{name}"] for k in BLOCK_KEYS
            for name in stored_names(params, prefix, k)}


# ---------------------------------------------------------------------------
# apply functions
# ---------------------------------------------------------------------------

def layer_norm(x, weight, bias, eps=1e-12):
    """fp32-island LayerNorm, eps inside the sqrt (TF-style)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return weight.to(x.dtype) * normed + bias.to(x.dtype)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def linear(x, weight, bias=None):
    """``x @ weight.T + bias`` with ``weight`` ``[out, in]``."""
    y = x @ weight.to(x.dtype).t()
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def _int_mm(a, b):
    """int8 ``[M, K] @ [K, N]`` -> int32 ``[M, N]``. cuBLAS's int8 GEMM
    takes ``M > 16``, so on the card a shorter ``a`` is zero-padded."""
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        a = torch.cat([a, a.new_zeros(17 - m, a.shape[1])])
    return torch._int_mm(a, b)[:m]


def int8_matmul(xq, s, w_int8, w_scale, bias, out_dtype):
    """Quantized activations ``xq`` int8 ``[..., in]`` with per-token
    scales ``s`` ``[...]`` times int8 weights ``[out, in]`` with scales
    ``[out]``: int32 accumulate, ``(y * s * w_scale)`` in fp32, cast to
    ``out_dtype``, then ``+ bias`` in ``out_dtype``."""
    y = _int_mm(xq.reshape(-1, xq.shape[-1]), w_int8.t())
    y = y.reshape(*xq.shape[:-1], -1)
    y = (y.float() * s[..., None] * w_scale).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y


def int8_linear(x, w_int8, w_scale, bias=None):
    """W8A8 linear: ``x`` quantized per token in fp32 on the fly, then
    :func:`int8_matmul` back to ``x.dtype``."""
    xq, s = quantize_rows_plain(x.float())
    return int8_matmul(xq, s, w_int8, w_scale, bias, x.dtype)


def block_linear(p, x, weight, bias):
    """The block's linear ``weight``/``bias`` (local names): W8A8 when the
    block holds the weight quantized, else :func:`linear`."""
    if weight + "_int8" in p:
        return int8_linear(x, p[weight + "_int8"], p[weight + "_scale"],
                           p[bias])
    return linear(x, p[weight], p[bias])


def mlp(p, x):
    h = quick_gelu(block_linear(p, x, "mlp.c_fc.weight", "mlp.c_fc.bias"))
    return block_linear(p, h, "mlp.c_proj.weight", "mlp.c_proj.bias")


def attention(p, x, n_head, mask=None):
    """Multi-head self-attention, batch-first ``[B, L, E]``; the core
    runs in :func:`msclip_torch.ops.attention.fused_attention_qkv`."""
    qkv = block_linear(p, x, "attn.in_proj_weight", "attn.in_proj_bias")
    out = fused_attention_qkv(qkv, n_head, mask)
    return block_linear(p, out, "attn.out_proj.weight", "attn.out_proj.bias")


def int8_block(p, x, n_head, mask=None, eps=1e-12):
    """Pre-LN block of a quantized eval model with the quantizers fused
    (``_int8_block``): K3 quantizes the LayerNorm outputs and K4 the
    QuickGELU output straight to int8; the out-projection's input (the
    attention context, from K1) is quantized on the fly."""
    xq, s = ln_quant(x, p["ln_1.weight"], p["ln_1.bias"], eps)
    qkv = int8_matmul(xq, s, p["attn.in_proj_weight_int8"],
                      p["attn.in_proj_weight_scale"], p["attn.in_proj_bias"],
                      x.dtype)
    ctx = fused_attention_qkv(qkv, n_head, mask)
    x = x + int8_linear(ctx, p["attn.out_proj.weight_int8"],
                        p["attn.out_proj.weight_scale"],
                        p["attn.out_proj.bias"])
    hq, s = ln_quant(x, p["ln_2.weight"], p["ln_2.bias"], eps)
    mid = int8_matmul(hq, s, p["mlp.c_fc.weight_int8"],
                      p["mlp.c_fc.weight_scale"], p["mlp.c_fc.bias"], x.dtype)
    mq, s = gelu_quant(mid)
    return x + int8_matmul(mq, s, p["mlp.c_proj.weight_int8"],
                           p["mlp.c_proj.weight_scale"], p["mlp.c_proj.bias"],
                           x.dtype)


def drop_path(x, rate, generator):
    """Stochastic depth on a residual branch (timm ``DropPath``): one keep
    draw per sample from ``generator``, the kept samples scaled by
    ``1 / (1 - rate)``."""
    keep = 1.0 - rate
    draw = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), device=x.device,
                      generator=generator)
    return x * (draw < keep).to(x.dtype) / keep


def transformer_block(p, x, n_head, mask=None, eps=1e-12, drop_path_rate=0.0,
                      generator=None):
    """Pre-LN residual attention block (reference ``:1027-1028``), with
    stochastic depth on both branches in training, when a rate and a
    ``torch.Generator`` are given. A quantized block without drop-path at
    ``L >= int8_min_seq()`` runs :func:`int8_block`."""
    dropping = drop_path_rate > 0.0 and generator is not None
    if "attn.in_proj_weight_int8" in p and not dropping \
            and x.shape[1] >= int8_min_seq():
        return int8_block(p, x, n_head, mask, eps)
    if dropping:
        def dp(t):
            return drop_path(t, drop_path_rate, generator)
    else:
        def dp(t):
            return t
    x = x + dp(attention(p, layer_norm(x, p["ln_1.weight"], p["ln_1.bias"],
                                       eps), n_head, mask))
    return x + dp(mlp(p, layer_norm(x, p["ln_2.weight"], p["ln_2.bias"],
                                    eps)))


def conv2d(x, weight, stride=1, padding=0, groups=1):
    """NCHW conv with an OIHW weight cast to ``x``'s dtype."""
    return F.conv2d(x, weight.to(x.dtype), stride=stride, padding=padding,
                    groups=groups)


def add_channel_bias(x, bias):
    """Per-channel bias on an NCHW map (a folded conv's bias)."""
    return x + bias.to(x.dtype)[None, :, None, None]


BN_MOMENTUM = 0.1  # torch's default, the reference's BatchNorm2d


def batch_norm(x, params, prefix, eps=1e-5, training=False):
    """BatchNorm over NCHW. Eval: running stats folded into an fp32
    scale/offset; returns ``y``. Training: batch statistics over N, H, W;
    returns ``(y, (new_running_mean, new_running_var))``, the new stats
    detached."""
    if training:
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = xf.square().mean(dim=(0, 2, 3)) - mean.square()
        y = (xf - mean[None, :, None, None]) \
            * torch.rsqrt(var + eps)[None, :, None, None]
        y = params[f"{prefix}.weight"].float()[None, :, None, None] * y \
            + params[f"{prefix}.bias"].float()[None, :, None, None]
        n = x.numel() // x.shape[1]
        unbiased = var.detach() * (n / max(n - 1, 1))
        new_stats = (
            (1 - BN_MOMENTUM) * params[f"{prefix}.running_mean"]
            + BN_MOMENTUM * mean.detach(),
            (1 - BN_MOMENTUM) * params[f"{prefix}.running_var"]
            + BN_MOMENTUM * unbiased)
        return y.to(x.dtype), new_stats
    scale = params[f"{prefix}.weight"].float() * torch.rsqrt(
        params[f"{prefix}.running_var"].float() + eps)
    offset = params[f"{prefix}.bias"].float() \
        - params[f"{prefix}.running_mean"].float() * scale
    return x * scale.to(x.dtype)[None, :, None, None] \
        + offset.to(x.dtype)[None, :, None, None]


def build_causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive causal mask, fp32: 0 on and below the diagonal, -inf above
    (reference ``build_attention_mask`` ``:2965-2971``)."""
    mask = torch.full((length, length), float("-inf"), device=device)
    return torch.triu(mask, diagonal=1)


def l2_normalize(x, dim=-1):
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True)

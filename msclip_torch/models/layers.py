"""Core functional layers, the eval subset of ``msclip_tpu/models/layers.py``.

Parameters use the reference MS-CLIP ``state_dict`` layout (PyTorch's own):
linear weights ``[out, in]``, conv weights OIHW, activations NCHW inside the
convolutions. Parameters may be stored fp32; ``x``'s dtype is the compute
dtype, and every weight is cast to it at use, as in the JAX package.

Semantics that differ from PyTorch's defaults and are kept on purpose:

* ``layer_norm``: statistics in fp32, ``rsqrt(var + 1e-12)``, the normalized
  value cast to the compute dtype *before* the affine, which is applied in
  that dtype (reference ``clip_openai_pe_res_v1.py:204-219``);
* ``batch_norm``: eval only, running statistics folded into one fp32
  scale/offset, then cast; its eps is the caller's (1e-5 or 1e-6).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.attention import fused_attention_qkv

BLOCK_KEYS = (
    "ln_1.weight", "ln_1.bias",
    "attn.in_proj_weight", "attn.in_proj_bias",
    "attn.out_proj.weight", "attn.out_proj.bias",
    "ln_2.weight", "ln_2.bias",
    "mlp.c_fc.weight", "mlp.c_fc.bias",
    "mlp.c_proj.weight", "mlp.c_proj.bias",
)


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


def block_params(params, prefix):
    """The twelve tensors of the block at ``prefix``, under local names."""
    return {k: params[f"{prefix}.{k}"] for k in BLOCK_KEYS}


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


def mlp(p, x):
    h = quick_gelu(linear(x, p["mlp.c_fc.weight"], p["mlp.c_fc.bias"]))
    return linear(h, p["mlp.c_proj.weight"], p["mlp.c_proj.bias"])


def attention(p, x, n_head, mask=None):
    """Multi-head self-attention, batch-first ``[B, L, E]``; the core
    runs in :func:`msclip_torch.ops.attention.fused_attention_qkv`."""
    qkv = linear(x, p["attn.in_proj_weight"], p["attn.in_proj_bias"])
    out = fused_attention_qkv(qkv, n_head, mask)
    return linear(out, p["attn.out_proj.weight"], p["attn.out_proj.bias"])


def transformer_block(p, x, n_head, mask=None, eps=1e-12):
    """Pre-LN residual attention block (reference ``:1027-1028``), eval."""
    x = x + attention(p, layer_norm(x, p["ln_1.weight"], p["ln_1.bias"],
                                    eps), n_head, mask)
    return x + mlp(p, layer_norm(x, p["ln_2.weight"], p["ln_2.bias"], eps))


def conv2d(x, weight, stride=1, padding=0, groups=1):
    """NCHW conv with an OIHW weight cast to ``x``'s dtype."""
    return F.conv2d(x, weight.to(x.dtype), stride=stride, padding=padding,
                    groups=groups)


def add_channel_bias(x, bias):
    """Per-channel bias on an NCHW map (a folded conv's bias)."""
    return x + bias.to(x.dtype)[None, :, None, None]


def batch_norm(x, params, prefix, eps=1e-5):
    """Eval BatchNorm over NCHW with running stats; fp32 scale/offset."""
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

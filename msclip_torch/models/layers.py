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

import torch
import torch.nn.functional as F

from ..ops import block_chain as K7
from ..ops.attention import fused_attention_qkv
from ..ops.quant import gelu_quant, ln_quant, quantize_rows_plain
from ..ops.tuning import DEFAULT as DEFAULT_TUNING, get_tuning
from ..parallel.collectives import (
    all_reduce_mean,
    copy_to_group,
    group_size,
    reduce_from_group,
)
from ..utils.summary import span

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
# K3/K4 on the CPU and any device the tuning table does not name
# (``ops/tuning.py``; msclip_tpu/ops/tuning.py:63-66); shorter ones
# quantize each GEMM input on the fly
INT8_MIN_SEQ = DEFAULT_TUNING.int8_min_seq


def int8_min_seq(device=None) -> int:
    """The fused int8 gate of ``device`` (the CPU for None): its row of
    the tuning table, or ``MSCLIP_INT8_MIN_SEQ`` if set, read at call
    time."""
    return get_tuning(device).int8_min_seq


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


def row_split_linear(x, weight, bias, tp):
    """A row-split linear under tensor parallelism: this process's partial
    product, summed over the model group ``tp``, then the whole bias."""
    return reduce_from_group(linear(x, weight), tp) + bias.to(x.dtype)


def mlp(p, x, tp=None):
    """The MLP; with a model group ``tp`` (tensor parallelism) ``p`` holds
    this process's ``c_fc`` rows and ``c_proj`` columns."""
    if tp is not None:
        h = quick_gelu(linear(copy_to_group(x, tp), p["mlp.c_fc.weight"],
                              p["mlp.c_fc.bias"]))
        return row_split_linear(h, p["mlp.c_proj.weight"],
                                 p["mlp.c_proj.bias"], tp)
    h = quick_gelu(block_linear(p, x, "mlp.c_fc.weight", "mlp.c_fc.bias"))
    return block_linear(p, h, "mlp.c_proj.weight", "mlp.c_proj.bias")


def attention(p, x, n_head, mask=None, tp=None):
    """Multi-head self-attention, batch-first ``[B, L, E]``; the core
    runs in :func:`msclip_torch.ops.attention.fused_attention_qkv`. With a
    model group ``tp`` (tensor parallelism) ``p`` holds this process's
    heads (their q, k and v rows of the in-projection, their columns of
    the out-projection), so the core runs on ``n_head / |tp|`` heads.

    The core call, and nothing else, runs in the span
    ``msclip.attention.fwd`` (``utils.summary.span``); its backward opens
    ``msclip.attention.bwd``. Any other kernel that runs the core alone
    keeps both spans around its own forward and backward, which is what
    the benchmark's ``attention_ms.train`` reads; the fused half-block
    K5 (LN1, core and out-projection in one kernel) opens none."""
    if tp is not None:
        qkv = linear(copy_to_group(x, tp), p["attn.in_proj_weight"],
                     p["attn.in_proj_bias"])
        with span("msclip.attention.fwd"):
            out = fused_attention_qkv(qkv, n_head // group_size(tp), mask)
        return row_split_linear(out, p["attn.out_proj.weight"],
                                 p["attn.out_proj.bias"], tp)
    qkv = block_linear(p, x, "attn.in_proj_weight", "attn.in_proj_bias")
    with span("msclip.attention.fwd"):
        out = fused_attention_qkv(qkv, n_head, mask)
    return block_linear(p, out, "attn.out_proj.weight", "attn.out_proj.bias")


def softmax_attention(q, k, v, n_head, mask=None, bias=None, scale=None,
                      blend=None):
    """Multi-head attention of projected ``q [B, Lq, H*D]`` over ``k``,
    ``v [B, Lk, H*D']`` in plain torch, as the JAX package's einsum
    attentions (ModifiedResNet's pool, the cross attentions, the extension
    zoo): the query scaled by ``scale`` (``D ** -0.5`` when None; 1 for a
    query scaled already) in its dtype, fp32 scores plus the additive
    ``bias`` ``[H, Lq, Lk]`` and ``mask``, fp32 softmax, ``blend`` (a
    function of the fp32 weights ``[B, H, Lq, Lk]``) applied, weights cast
    to ``v``'s dtype. Returns ``[B, Lq, H*D']``."""
    B, Lq, _ = q.shape
    qh = q.reshape(B, Lq, n_head, -1).transpose(1, 2)
    kh = k.reshape(B, k.shape[1], n_head, -1).transpose(1, 2)
    vh = v.reshape(B, v.shape[1], n_head, -1).transpose(1, 2)
    if scale is None:
        scale = qh.shape[-1] ** -0.5
    if scale != 1:
        qh = qh * torch.tensor(scale, dtype=q.dtype)
    scores = qh.float() @ kh.float().transpose(-1, -2)
    if bias is not None:
        scores = scores + bias.float()
    if mask is not None:
        scores = scores + mask.float()
    weights = scores.softmax(dim=-1)
    if blend is not None:
        weights = blend(weights)
    out = weights.to(v.dtype) @ vh
    return out.transpose(1, 2).reshape(B, Lq, -1)


def int8_block(p, x, n_head, mask=None, eps=1e-12):
    """Pre-LN block of a quantized eval model with the quantizers fused
    (``_int8_block``): K3 quantizes the LayerNorm outputs and K4 the
    QuickGELU output straight to int8; the out-projection's input (the
    attention context, from K1 in the span ``msclip.attention.fwd``) is
    quantized on the fly."""
    xq, s = ln_quant(x, p["ln_1.weight"], p["ln_1.bias"], eps)
    qkv = int8_matmul(xq, s, p["attn.in_proj_weight_int8"],
                      p["attn.in_proj_weight_scale"], p["attn.in_proj_bias"],
                      x.dtype)
    with span("msclip.attention.fwd"):
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


def drop_path_keep(x, rate, generator, rows=None):
    """The per-sample keep mask of :func:`drop_path` for ``x``: one
    uniform draw per sample from ``generator``, kept below ``1 - rate``.
    ``rows=(first, total)``: ``x`` holds rows ``first ..`` of a global
    batch of ``total`` (one process of several); the whole batch's draws
    are made and this process's rows taken, so the processes together
    draw what one process draws for the whole batch."""
    first, total = rows or (0, x.shape[0])
    draw = torch.rand((total,) + (1,) * (x.ndim - 1), device=x.device,
                      generator=generator)[first:first + x.shape[0]]
    return draw < 1.0 - rate


def drop_path(x, rate, keep):
    """Stochastic depth on a residual branch (timm ``DropPath``): the
    samples ``keep`` (:func:`drop_path_keep`) leaves out are dropped, the
    kept ones scaled by ``1 / (1 - rate)``."""
    return x * keep.to(x.dtype) / (1.0 - rate)


def backward_may_follow(p, x) -> bool:
    """Whether a backward may reach a block on ``x`` with tensors ``p``:
    outside inference mode, ``x`` or a block tensor requires grad. Grad
    mode alone does not settle it: under ``no_grad`` such a block records
    nothing, yet its caller may run it again with grad and pull gradients
    back through that run (GradCache's two passes), and both runs have to
    take one chain."""
    return not torch.is_inference_mode_enabled() and (
        x.requires_grad or any(t.requires_grad for t in p.values()))


def chain_route(p, x, tp=None, dropping=False) -> bool:
    """Whether :func:`transformer_block` runs :func:`chain_block`: the
    plain block (not int8, not tensor parallel), no drop-path, no backward
    to follow (:func:`backward_may_follow`), on a device, dtype and width
    the kernels take (``ops/block_chain.takes``)."""
    return (tp is None and not dropping and "attn.in_proj_weight" in p
            and K7.takes(x) and not backward_may_follow(p, x))


def chain_block(p, x, n_head, mask=None, eps=1e-12):
    """:func:`transformer_block`'s plain block with its elementwise chain
    in the five kernels of ``ops/block_chain`` (K7): the same operations
    and roundings, the LayerNorms' sums in another order. The GEMMs are
    :func:`linear`'s products without their bias; the attention core runs
    in the span ``msclip.attention.fwd``, as in :func:`attention`. A
    contiguous ``x`` of a width the kernels take starts each row 16-byte
    aligned, as they need."""
    x = x.contiguous()
    h = K7.ln(x, p["ln_1.weight"], p["ln_1.bias"], eps)
    qkv = K7.bias(linear(h, p["attn.in_proj_weight"]), p["attn.in_proj_bias"])
    with span("msclip.attention.fwd"):
        ctx = fused_attention_qkv(qkv, n_head, mask)
    x, h = K7.bias_residual_ln(linear(ctx, p["attn.out_proj.weight"]),
                               p["attn.out_proj.bias"], x, p["ln_2.weight"],
                               p["ln_2.bias"], eps)
    mid = K7.bias_gelu(linear(h, p["mlp.c_fc.weight"]), p["mlp.c_fc.bias"])
    return K7.bias_residual(linear(mid, p["mlp.c_proj.weight"]),
                            p["mlp.c_proj.bias"], x)


def transformer_block(p, x, n_head, mask=None, eps=1e-12, drop_path_rate=0.0,
                      keep=None, tp=None):
    """Pre-LN residual attention block (reference ``:1027-1028``), with
    stochastic depth on both branches in training when a rate and the
    branches' two keep masks ``keep`` (:func:`drop_path_keep`, drawn by the
    caller, so that a rematerialised block's recomputation drops the same
    samples) are given. A quantized block without drop-path at ``L >=
    int8_min_seq()`` runs :func:`int8_block`; where no backward can follow
    the plain block runs :func:`chain_block` on the card
    (:func:`chain_route`). ``tp``: the model group of tensor parallelism
    (:func:`attention`, :func:`mlp`)."""
    dropping = drop_path_rate > 0.0 and keep is not None
    if "attn.in_proj_weight_int8" in p and not dropping \
            and x.shape[1] >= int8_min_seq(x.device):
        return int8_block(p, x, n_head, mask, eps)
    if chain_route(p, x, tp, dropping):
        return chain_block(p, x, n_head, mask, eps)

    def dp(t, i):
        return drop_path(t, drop_path_rate, keep[i]) if dropping else t

    x = x + dp(attention(p, layer_norm(x, p["ln_1.weight"], p["ln_1.bias"],
                                       eps), n_head, mask, tp), 0)
    return x + dp(mlp(p, layer_norm(x, p["ln_2.weight"], p["ln_2.bias"],
                                    eps), tp), 1)


def conv2d(x, weight, stride=1, padding=0, groups=1):
    """NCHW conv with an OIHW weight cast to ``x``'s dtype."""
    return F.conv2d(x, weight.to(x.dtype), stride=stride, padding=padding,
                    groups=groups)


def conv_transpose2d(x, weight, stride=1, padding=0, groups=1):
    """NCHW transposed conv with torch ``ConvTranspose2d``'s weight
    ``[in, out / groups, k, k]`` and geometry, output side ``(H - 1) s -
    2 p + k`` (``msclip_tpu/models/layers.py:311``: a stride-1 conv of the
    ``s``-dilated input, padded ``k - 1 - p`` a side, with the kernel
    flipped; the JAX function takes HWIO with ``I = 1`` for the depthwise
    deconv it is used for, which is this layout's ``[C, 1, k, k]``)."""
    return F.conv_transpose2d(x, weight.to(x.dtype), stride=stride,
                              padding=padding, groups=groups)


def avg_pool(x, k):
    """NCHW average pool, kernel = stride = ``k`` (torch ``AvgPool2d(k)``;
    JAX's ``reduce_window`` sum over VALID windows / k^2)."""
    return F.avg_pool2d(x, k)


def add_channel_bias(x, bias):
    """Per-channel bias on an NCHW map (a folded conv's bias)."""
    return x + bias.to(x.dtype)[None, :, None, None]


BN_MOMENTUM = 0.1  # torch's default, the reference's BatchNorm2d


def batch_norm(x, params, prefix, eps=1e-5, training=False,
               momentum=BN_MOMENTUM, group=None):
    """BatchNorm over NCHW. Eval: running stats folded into an fp32
    scale/offset; returns ``y``. Training: batch statistics over N, H, W;
    returns ``(y, (new_running_mean, new_running_var))``, the new stats
    (blended at ``momentum``) detached. With a process ``group`` the
    statistics are the global batch's: ``E[x]`` and ``E[x^2]`` averaged
    over the group (its processes hold equal batches) through a
    differentiable all-reduce, and the unbiased variance counts every
    process's rows (JAX's ``axis_name`` branch)."""
    if training:
        xf = x.float()
        moments = torch.stack([xf.mean(dim=(0, 2, 3)),
                               xf.square().mean(dim=(0, 2, 3))])
        mean, mean_sq = all_reduce_mean(moments, group).unbind(0)
        var = mean_sq - mean.square()
        y = (xf - mean[None, :, None, None]) \
            * torch.rsqrt(var + eps)[None, :, None, None]
        y = params[f"{prefix}.weight"].float()[None, :, None, None] * y \
            + params[f"{prefix}.bias"].float()[None, :, None, None]
        n = x.numel() // x.shape[1] * group_size(group)
        unbiased = var.detach() * (n / max(n - 1, 1))
        new_stats = (
            (1 - momentum) * params[f"{prefix}.running_mean"]
            + momentum * mean.detach(),
            (1 - momentum) * params[f"{prefix}.running_var"]
            + momentum * unbiased)
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

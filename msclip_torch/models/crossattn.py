"""Cross-attention modules of the model zoo, the port of
``msclip_tpu/models/crossattn.py``. Plain torch (the JAX package computes
each with einsums outside Pallas), parameters in the reference
``state_dict`` layout under a key prefix:

* :func:`cross_attention_diffdim`: attention with separate q/k/v
  projections of different input widths (``<p>.{q,k,v}_proj_weight``,
  ``<p>.{q,k,v}_in_proj_bias``; reference ``CrossAttentionLayer_Diffdim``
  ``:1078-1184``), the bottom-to-top cross-attention adapter's;
* :func:`residual_cross_block`: the Perceiver block, tokens attending to a
  normed latent set through the fused in-projection split into q and k/v
  (``<p>.attn.in_proj_weight``, ``.norm_context``; ``:1036-1075``);
* :func:`window_cross_attention`: the windowed lateral fusion
  (``PARALLEL_T2B_WINDOWATTN``), each trunk grid token attending to its
  window of the branch map with a relative-position bias
  (``CrossAttentionLayer_Window`` ``:1187-1536``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.collectives import copy_to_group, group_size
from . import layers as L
from .stem import BNState


def _xavier(shape, generator):
    """xavier-uniform ``[out, in]``."""
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


# ---------------------------------------------------------------------------
# Diffdim cross attention
# ---------------------------------------------------------------------------

def init_cross_attention_diffdim(prefix, input_q_dim, input_k_dim, input_v_dim,
                                 output_qk_dim, output_v_dim, generator):
    p = {}
    for n, d_in, d_out in (("q", input_q_dim, output_qk_dim),
                           ("k", input_k_dim, output_qk_dim),
                           ("v", input_v_dim, output_v_dim)):
        p[f"{prefix}.{n}_proj_weight"] = _xavier((d_out, d_in), generator)
        p[f"{prefix}.{n}_in_proj_bias"] = torch.zeros(d_out)
    return p


def cross_attention_diffdim(params, prefix, query, key, value, head_dim):
    """``query [B, Lq, Dq]``, ``key [B, Lk, Dk]``, ``value [B, Lk, Dv]``
    -> ``[B, Lq, output_v_dim]``, ``output_qk_dim // head_dim`` heads."""
    q, k, v = (L.linear(t, params[f"{prefix}.{n}_proj_weight"],
                        params[f"{prefix}.{n}_in_proj_bias"])
               for n, t in (("q", query), ("k", key), ("v", value)))
    return L.softmax_attention(q, k, v, q.shape[-1] // head_dim,
                               scale=head_dim ** -0.5)


# ---------------------------------------------------------------------------
# Perceiver residual cross block
# ---------------------------------------------------------------------------

def init_residual_cross_block(prefix, dim, generator):
    p = L.init_block(prefix, dim, generator)
    p.update(L.init_layer_norm(f"{prefix}.norm_context", dim))
    return p


def residual_cross_block(params, prefix, x, context, n_head, eps=1e-12,
                         tp=None):
    """``x`` attends to ``norm_context(context)``, then the MLP (reference
    ``:1071-1075``): q from ``ln_1(x)``, k and v from the normed context,
    the three slices of the fused in-projection. With a model group ``tp``
    the block holds this process's heads and MLP columns, as a plain
    block under tensor parallelism: the attention runs on its heads and
    the out-projection and MLP sum over the group."""
    p = L.block_params(params, prefix)
    query = copy_to_group(L.layer_norm(x, p["ln_1.weight"], p["ln_1.bias"],
                                       eps), tp)
    ctx = copy_to_group(L.layer_norm(
        context, params[f"{prefix}.norm_context.weight"],
        params[f"{prefix}.norm_context.bias"], eps), tp)
    w_q, w_k, w_v = p["attn.in_proj_weight"].chunk(3)
    b_q, b_k, b_v = p["attn.in_proj_bias"].chunk(3)
    out = L.softmax_attention(L.linear(query, w_q, b_q),
                              L.linear(ctx, w_k, b_k),
                              L.linear(ctx, w_v, b_v),
                              n_head // group_size(tp))
    if tp is None:
        out = L.linear(out, p["attn.out_proj.weight"],
                       p["attn.out_proj.bias"])
    else:
        out = L.row_split_linear(out, p["attn.out_proj.weight"],
                                 p["attn.out_proj.bias"], tp)
    x = x + out
    return x + L.mlp(p, L.layer_norm(x, p["ln_2.weight"], p["ln_2.bias"],
                                     eps), tp=tp)


# ---------------------------------------------------------------------------
# Windowed top <-> bottom cross attention (lateral fusion variant)
# ---------------------------------------------------------------------------

def relative_position_index(window_q: int, window_kv: int) -> np.ndarray:
    """Pairwise relative-position index (reference ``:1239-1256``, its
    offset and scale arithmetic kept)."""
    kv = np.stack(np.meshgrid(np.arange(window_kv), np.arange(window_kv),
                              indexing="ij")).reshape(2, -1)
    q = np.stack(np.meshgrid(np.arange(window_q), np.arange(window_q),
                             indexing="ij")).reshape(2, -1)
    rel = (q[:, :, None] - kv[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += window_kv - 1
    rel[:, :, 1] += window_kv - 1
    rel[:, :, 0] *= window_kv + window_q - 1
    return rel.sum(-1)


def init_window_cross_attention(prefix, input_q_dim, input_kv_dim,
                                output_qk_dim, output_v_dim, window_q,
                                window_kv, num_heads, generator, output_dim=0,
                                relative_pos=True):
    """The window adapter as ``spec.window_geometry`` sizes it: depthwise
    k/v convs + BN on the branch map, an output linear, the bottom
    depthwise conv + BN and ``ln_adapt``."""
    output_dim = output_dim or output_v_dim
    p = {f"{prefix}.q_proj_weight":
         _xavier((output_qk_dim, input_q_dim), generator),
         f"{prefix}.q_in_proj_bias": torch.zeros(output_qk_dim)}
    for name, dim in (("bottom_dw_conv", input_q_dim),
                      ("k_dwconv", input_kv_dim), ("v_dwconv", input_kv_dim)):
        p.update(L.init_conv(f"{prefix}.{name}.conv.weight", 3, dim, dim,
                             generator, groups=dim))
        p.update(L.init_batch_norm(f"{prefix}.{name}.bn", dim))
    p[f"{prefix}.out_proj.weight"] = L.trunc_normal(
        (output_dim, output_v_dim), generator)
    p[f"{prefix}.out_proj.bias"] = torch.zeros(output_dim)
    p.update(L.init_layer_norm(f"{prefix}.ln_adapt", output_dim))
    if relative_pos:
        table = (window_q + window_kv - 1) ** 2
        p[f"{prefix}.relative_position_bias_table"] = L.trunc_normal(
            (table, num_heads), generator)
    return p


def _window_partition(x, ws):
    """``[B, H, W, C]`` -> ``[B * nW, ws * ws, C]``."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def _window_reverse(x, ws, H, W):
    """``[B * nW, ws * ws, C]`` -> ``[B, H, W, C]``."""
    C = x.shape[-1]
    B = x.shape[0] // ((H // ws) * (W // ws))
    x = x.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def _unfold(x, k, stride, pad):
    """``torch.nn.Unfold`` over NCHW ``x`` -> ``[B, nW, k * k, C]``
    (window-major, the JAX function's layout)."""
    B, C = x.shape[:2]
    cols = F.unfold(x, k, padding=pad, stride=stride)  # [B, C k k, nW]
    return cols.reshape(B, C, k * k, -1).permute(0, 3, 2, 1)


def window_cross_attention(params, prefix, top, tokens, grid_hw, *, num_heads,
                           head_qk_dim, window_q, window_kv,
                           slide_window, slide_kernel, slide_pad,
                           slide_stride, relative_pos=True,
                           bn: BNState | None = None, eps=1e-12):
    """Windowed lateral fusion (reference ``forward`` ``:1514-1536`` and
    ``cross_attn`` ``:1369-1512``): the trunk grid tokens (queries in
    ``window_q``-square windows) attend to the aligned ``window_kv``-square
    windows of the branch map ``top`` ``[B, C_top, Ht, Wt]`` (or, with
    ``slide_window``, to its sliding ``slide_kernel`` neighbourhoods, the
    padding masked), fused as the plain adapter with a zeroed CLS
    injection. Returns ``(top, fused)``."""
    bn = bn or BNState()
    B, _, C = tokens.shape
    H, W = grid_hw
    cls_tok = tokens[:, :1, :]
    grid = tokens[:, 1:, :].transpose(1, 2).reshape(B, C, H, W)

    def dw_bn(name, x):
        x = L.conv2d(x, params[f"{prefix}.{name}.conv.weight"], 1, 1,
                     groups=x.shape[1])
        return bn(x, params, f"{prefix}.{name}.bn")

    bottom = dw_bn("bottom_dw_conv", grid).flatten(2).transpose(1, 2)
    bottom_out = torch.cat([cls_tok, bottom], dim=1)

    grid_hwc = grid.permute(0, 2, 3, 1)
    q = L.linear(grid_hwc, params[f"{prefix}.q_proj_weight"],
                 params[f"{prefix}.q_in_proj_bias"])
    q = q * torch.tensor(head_qk_dim ** -0.5, dtype=q.dtype)
    k, v = dw_bn("k_dwconv", top), dw_bn("v_dwconv", top)

    q_win = _window_partition(q, window_q)
    n_kv = window_kv * window_kv
    mask = None
    if slide_window:
        k_win = _unfold(k, slide_kernel, slide_stride, slide_pad)
        v_win = _unfold(v, slide_kernel, slide_stride, slide_pad)
        nW = k_win.shape[1]
        k_win = k_win.reshape(B * nW, n_kv, -1)
        v_win = v_win.reshape(B * nW, n_kv, -1)
        if slide_pad:
            ones = torch.ones((1, 1) + tuple(k.shape[2:]), device=k.device)
            valid = _unfold(ones, slide_kernel, slide_stride, slide_pad)
            mask = torch.zeros(valid.shape, device=k.device).masked_fill(
                valid <= 0, float("-inf")).reshape(1, nW, 1, n_kv)
            mask = mask.expand(B, nW, 1, n_kv).reshape(B * nW, 1, 1, n_kv)
    else:
        k_win = _window_partition(k.permute(0, 2, 3, 1), window_kv)
        v_win = _window_partition(v.permute(0, 2, 3, 1), window_kv)

    bias = None
    if relative_pos:
        index = torch.from_numpy(relative_position_index(
            window_q, window_kv).reshape(-1)).to(top.device)
        table = params[f"{prefix}.relative_position_bias_table"]
        bias = table[index].reshape(window_q * window_q, n_kv,
                                    num_heads).permute(2, 0, 1)
    out = L.softmax_attention(q_win, k_win, v_win, num_heads, mask=mask,
                              bias=bias, scale=1)
    out = _window_reverse(out, window_q, H, W).reshape(B, H * W, -1)
    out = L.linear(out, params[f"{prefix}.out_proj.weight"],
                   params[f"{prefix}.out_proj.bias"])
    t2b = torch.cat([torch.zeros_like(cls_tok), out], dim=1)
    fused = L.layer_norm(bottom_out + t2b, params[f"{prefix}.ln_adapt.weight"],
                         params[f"{prefix}.ln_adapt.bias"], eps)
    return top, fused

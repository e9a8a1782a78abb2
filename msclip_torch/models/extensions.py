"""The experimental block families of the model zoo, the port of
``msclip_tpu/models/extensions.py``. They are off in every released
MS-CLIP config (SURVEY.md §2.3):

* Houlsby adapters (``ADAPTER_FLAG``; reference ``:819-833, 989-991``);
* CvT depthwise convs before the block (``CVT_IN_V``; ``:835-917,
  992-1011``) or inside it on q/k/v (``CVT_INSIDE*``; ``:300-314,
  599-606``);
* Container's conv mixing of the values (``CONTAINER_IN_V``; ``:324-343,
  516-533``);
* ConViT's gated positional attention (``CONVIT_IN_V``; ``:316-322,
  446-459, 493-514``);
* LoRA on q/k/v (and the attention output) with optional MoE gating
  (``LORA_ATTN_DIM``; ``:345-428, 548-581, 665-685``);
* Gumbel dual-branch shared/specific blocks (``GUMBEL_SELECT``; ``:943-987,
  2877-2935``).

A block's extension tensors sit under its reference prefix
(``visual.transformer.resblocks.<i>.adapter_attn.down_proj.weight``,
``.attn.cvt_q.conv.weight``, ``.attn.convit_gating_param``,
``.attn.q_proj_adapter1.weight``, ``.specific_attn.in_proj_weight``, ...).
The plug-ins inside the attention need its weights, so that attention is
plain torch (:func:`extended_attention`, the JAX function's einsums and
softmax); a block whose attention no plug-in touches (the Gumbel branches
alone, adapters, CvT before the block, a block the families skip) runs
``layers.attention``, the kernel K1 on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import layers as L
from .stem import BNState


@dataclass(frozen=True)
class ExtSpec:
    """Static switches of the experimental families (CUSTOM keys)."""

    adapter_flag: bool = False
    adapter_dim: int = 0
    adapter_layers: Tuple[int, ...] = ()

    cvt_in_v: bool = False
    cvt_inside: bool = False
    cvt_layers: Tuple[int, ...] = ()
    cvt_kernel: int = 3
    cvt_stride: int = 1
    cvt_pad: int = 1
    cvt_res: bool = False
    cvt_n_dwc: int = 1  # THREE_DWC_IN_CVT / TWO_DWC_IN_CVT
    cvt_inside_q: bool = False
    cvt_inside_k: bool = False
    cvt_inside_v: bool = False

    container_in_v: bool = False
    container_kernel: int = 3
    container_stride: int = 1
    container_pad: int = 1

    convit_in_v: bool = False
    convit_layers: Tuple[int, ...] = ()
    convit_local_strength: float = 1.0

    lora_attn_dim: int = 0
    lora_attn_alpha: float = 0.0
    lora_add_where: str = "v0"  # v0: q+v | v1: +k | v2: +k +fc
    lora_moe: int = 0
    lora_moe_act: str = "linear"
    lora_moe_lambda: float = 1.0
    lora_moe_softmax: int = 0
    lora_moe_group: int = 1

    gumbel_select: bool = False
    gumbel_addtwo: bool = False

    def layer_has(self, which: str, modality: str, layer_idx: int) -> bool:
        if which == "adapter":
            return self.adapter_flag and (not self.adapter_layers
                                          or layer_idx in self.adapter_layers)
        if which == "cvt":
            return self.cvt_in_v and modality == "visual" and (
                not self.cvt_layers or layer_idx in self.cvt_layers)
        if which == "convit":
            return self.convit_in_v and modality == "visual" and (
                not self.convit_layers or layer_idx in self.convit_layers)
        if which == "container":
            return self.container_in_v and modality == "visual"
        if which == "lora":
            return self.lora_attn_dim > 0
        raise KeyError(which)

    def block_has_any(self, modality: str, layer_idx: int) -> bool:
        """Does any family touch this block?"""
        return self.gumbel_select or any(
            self.layer_has(f, modality, layer_idx)
            for f in ("adapter", "cvt", "convit", "container", "lora"))

    @property
    def any_active(self) -> bool:
        return (self.adapter_flag or self.cvt_in_v or self.container_in_v
                or self.convit_in_v or self.lora_attn_dim > 0
                or self.gumbel_select)


def ext_spec_from_custom(custom) -> ExtSpec:
    """The switches from ``config.CUSTOM`` (``custom.get`` records what it
    reads), as ``msclip_tpu.models.extensions.ext_spec_from_custom``."""
    g = custom.get
    n_dwc = 3 if g("THREE_DWC_IN_CVT", False) else (
        2 if g("TWO_DWC_IN_CVT", False) else 1)
    pad = g("CVT_V_PAD", 1)
    return ExtSpec(
        adapter_flag=g("ADAPTER_FLAG", False),
        adapter_dim=g("ADAPTER_ATTN_DIM", 0),
        adapter_layers=tuple(g("ADAPTER_LAYERS", [])),
        cvt_in_v=g("CVT_IN_V", False),
        cvt_inside=g("CVT_INSIDE", False),
        cvt_layers=tuple(g("CVT_LAYERS", [])),
        cvt_kernel=g("CVT_V_KERNEL", 3) or 3,
        cvt_stride=g("CVT_V_STRIDE", 1) or 1,
        cvt_pad=pad if pad is not False else 1,
        cvt_res=g("CVT_V_RES", False),
        cvt_n_dwc=n_dwc,
        cvt_inside_q=g("CVT_INSIDE_Q", False),
        cvt_inside_k=g("CVT_INSIDE_K", False),
        cvt_inside_v=g("CVT_INSIDE_V", False),
        container_in_v=g("CONTAINER_IN_V", False),
        container_kernel=g("CONTAINER_V_KERNEL", 3),
        container_stride=g("CONTAINER_V_STRIDE", 1),
        container_pad=g("CONTAINER_V_PAD", 1),
        convit_in_v=g("CONVIT_IN_V", False),
        convit_layers=tuple(g("CONVIT_LAYERS", [])),
        convit_local_strength=g("CONVIT_LOCAL_STRENGTH", 1),
        lora_attn_dim=g("LORA_ATTN_DIM", 0)
        if g("LORA_OPEN", False) or g("LORA_ATTN_DIM", 0) else 0,
        lora_attn_alpha=g("LORA_ATTN_ALPHA", 0),
        lora_add_where=g("LORA_WHERE_ADD", "v0"),
        lora_moe=g("LORA_MOE", 0),
        lora_moe_act=g("LORA_MOE_ACT", "linear"),
        lora_moe_lambda=g("LORA_MOE_LAMBDA", 1.0),
        lora_moe_softmax=g("LORA_MOE_SOFTMAX", 0),
        lora_moe_group=g("LORA_MOE_GROUP", 1),
        gumbel_select=g("GUMBEL_SELECT", False),
        gumbel_addtwo=g("GUMBEL_ADDTWO", False),
    )


# the attention plug-ins' tensors (one each), under a block's prefix
_ATTN_PLUGINS = ("attn.cvt_q.conv.weight", "attn.cvt_k.conv.weight",
                 "attn.cvt_v.conv.weight", "attn.convit_gating_param",
                 "attn.container_gating", "attn.q_proj_adapter1.weight")


def lora_names(ext: ExtSpec):
    """The projections LoRA adapts: q and v, k too from ``v1``, the
    attention output (``fc``) too at ``v2``."""
    names = ["q", "v"]
    if ext.lora_add_where in ("v1", "v2"):
        names.append("k")
    if ext.lora_add_where == "v2":
        names.append("fc")
    return names


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block_extensions(prefix, ext: ExtSpec, dim, num_heads, modality,
                          layer_idx, generator):
    """The extension tensors of the block at ``prefix``; {} when no
    family touches it."""
    p = {}
    tn = L.trunc_normal
    if ext.layer_has("adapter", modality, layer_idx):
        for name in ("adapter_attn", "adapter_ffn"):
            for proj, (d_out, d_in) in (("down_proj", (ext.adapter_dim, dim)),
                                        ("up_proj", (dim, ext.adapter_dim))):
                p[f"{prefix}.{name}.{proj}.weight"] = tn((d_out, d_in),
                                                         generator)
                p[f"{prefix}.{name}.{proj}.bias"] = torch.zeros(d_out)
    if ext.layer_has("cvt", modality, layer_idx):
        if ext.cvt_inside:
            bases = [f"{prefix}.attn.cvt_{n}" for n, on in (
                ("q", ext.cvt_inside_q), ("k", ext.cvt_inside_k),
                ("v", ext.cvt_inside_v)) if on]
            suffixes = [""]
        else:
            bases = [f"{prefix}.cvt_dw"]
            suffixes = [f"_{i + 1}" if ext.cvt_n_dwc > 1 else ""
                        for i in range(ext.cvt_n_dwc)]
            if ext.cvt_res:
                p.update(L.init_layer_norm(f"{prefix}.ln_cvt", dim))
        for base in bases:
            for sx in suffixes:
                p.update(L.init_conv(f"{base}.conv{sx}.weight", ext.cvt_kernel,
                                     dim, dim, generator, groups=dim))
                p.update(L.init_batch_norm(f"{base}.bn{sx}", dim))
    if ext.layer_has("convit", modality, layer_idx):
        p[f"{prefix}.attn.convit_pos_proj.weight"] = convit_local_init(
            num_heads, ext.convit_local_strength)
        p[f"{prefix}.attn.convit_pos_proj.bias"] = torch.zeros(num_heads)
        p[f"{prefix}.attn.convit_gating_param"] = torch.ones(num_heads)
    if ext.layer_has("container", modality, layer_idx):
        base = f"{prefix}.attn.container_conv"
        p.update(L.init_conv(f"{base}.conv.weight", ext.container_kernel, dim,
                             dim, generator, groups=dim))
        p.update(L.init_batch_norm(f"{base}.bn", dim))
        p[f"{prefix}.attn.container_gating"] = torch.zeros(1)
    if ext.layer_has("lora", modality, layer_idx):
        r = ext.lora_attn_dim
        for n in lora_names(ext):
            p[f"{prefix}.attn.{n}_proj_adapter1.weight"] = tn((r, dim),
                                                              generator)
            p[f"{prefix}.attn.{n}_proj_adapter2.weight"] = torch.zeros(dim, r)
        if ext.lora_moe == 1:
            for n in ("q", "v"):
                p[f"{prefix}.attn.{n}_moe_adapter1.weight"] = tn(
                    (r // ext.lora_moe_group, dim), generator)
    if ext.gumbel_select:
        blk = L.init_block("b", dim, generator)
        p.update({f"{prefix}.specific_{k[2:]}": v for k, v in blk.items()})
    return p


def convit_local_init(num_heads, local_strength=1.0):
    """ConViT's positional projection ``[heads, 3]`` at its locality init
    (reference ``convit_local_init`` ``:446-459``)."""
    w = np.zeros((num_heads, 3), np.float32)
    k = int(num_heads ** 0.5)
    center = (k - 1) / 2 if k % 2 == 0 else k // 2
    for h1 in range(k):
        for h2 in range(k):
            pos = h1 + k * h2
            w[pos] = (2 * (h2 - center), 2 * (h1 - center), -1)
    return torch.from_numpy(w * local_strength)


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------

def grid_dwconv_bn(params, base, tokens, grid_hw, bn: BNState, stride, pad,
                   n_stages=1):
    """(depthwise conv + BN) x ``n_stages`` over grid tokens ``[B, HW, C]``
    (``<base>.conv<s>.weight``, ``<base>.bn<s>``)."""
    B, _, C = tokens.shape
    x = tokens.transpose(1, 2).reshape(B, C, *grid_hw)
    for i in range(n_stages):
        sx = f"_{i + 1}" if n_stages > 1 else ""
        x = L.conv2d(x, params[f"{base}.conv{sx}.weight"], stride, pad,
                     groups=C)
        x = bn(x, params, f"{base}.bn{sx}")
    return x.flatten(2).transpose(1, 2)


def tokens_dwconv_keep_cls(params, base, tokens, grid_hw, bn, stride, pad,
                           n_stages=1):
    """:func:`grid_dwconv_bn` on the grid of a CLS-first sequence, the CLS
    unchanged (reference ``cvt_dw_forward`` ``:583-590``)."""
    grid = grid_dwconv_bn(params, base, tokens[:, 1:], grid_hw, bn, stride,
                          pad, n_stages)
    return torch.cat([tokens[:, :1], grid], dim=1)


def apply_adapter(params, base, x):
    """down -> QuickGELU -> up (reference ``:824-833``)."""
    h = L.quick_gelu(L.linear(x, params[f"{base}.down_proj.weight"],
                              params[f"{base}.down_proj.bias"]))
    return L.linear(h, params[f"{base}.up_proj.weight"],
                    params[f"{base}.up_proj.bias"])


def lora_delta(ext: ExtSpec, params, base, x, moe=None):
    """LoRA's low-rank delta ``x A^T (gated) B^T alpha / r`` with the
    optional grouped MoE gate (reference ``adapter_forward``
    ``:548-581``); ``base`` is ``<prefix>.attn.<n>``."""
    result = x @ params[f"{base}_proj_adapter1.weight"].to(x.dtype).t()
    if moe is not None:
        g = x @ moe.to(x.dtype).t()
        act = {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
               "relu": F.relu}.get(ext.lora_moe_act)
        if act is not None:
            g = act(g)
        g = g * ext.lora_moe_lambda
        if ext.lora_moe_softmax == 1:
            g = g.softmax(dim=-1)
        B, Lq, r = result.shape
        result = (result.reshape(B, Lq, r // ext.lora_moe_group,
                                 ext.lora_moe_group) * g[..., None]
                  ).reshape(B, Lq, r)
    return (result @ params[f"{base}_proj_adapter2.weight"].to(x.dtype).t()) \
        * (ext.lora_attn_alpha / ext.lora_attn_dim)


def convit_rel_indices(n_patches: int, device=None):
    """``[N, N, 3]`` relative-position features ``(dx, dy, d^2)``
    (reference ``get_rel_indices`` ``:535-546``)."""
    img = int(n_patches ** 0.5)
    ind = np.arange(img)[None, :] - np.arange(img)[:, None]
    indx = np.tile(ind, (img, img))
    indy = np.repeat(np.repeat(ind, img, axis=0), img, axis=1)
    rel = np.stack([indx, indy, indx ** 2 + indy ** 2], axis=-1)
    return torch.from_numpy(rel.astype(np.float32)).to(device)


def convit_blend(params, prefix, weights):
    """Content attention ``[B, H, L, L]`` (fp32, post-softmax, ``L = 1 +
    N``) blended with the gated positional attention, rows renormalised
    (reference ``convit_forward`` ``:493-514``)."""
    n = weights.shape[-1] - 1
    rel = convit_rel_indices(n, weights.device)
    pos = rel @ params[f"{prefix}.attn.convit_pos_proj.weight"].float().t() \
        + params[f"{prefix}.attn.convit_pos_proj.bias"].float()  # [N, N, H]
    pos = F.pad(pos.softmax(dim=1).permute(2, 0, 1)[None], (1, 0, 1, 0))
    gate = torch.sigmoid(
        params[f"{prefix}.attn.convit_gating_param"].float())[None, :, None,
                                                              None]
    blended = (1.0 - gate) * weights + gate * pos
    return blended / blended.sum(dim=-1, keepdim=True)


def extended_attention(blk, params, prefix, x, n_head, ext: ExtSpec, grid_hw,
                       mask=None, bn: BNState | None = None):
    """Attention with the plug-ins of the block at ``prefix``, in the
    reference ``Attention_CUST.forward``'s order (``:592-755``): CvT on
    q/k/v, the three projections, LoRA, the scores and softmax, ConViT's
    blend, the context, Container's mix, LoRA on the output, the output
    projection. ``blk``: the block's local tensors
    (``layers.block_params``)."""
    bn = bn or BNState()
    query = key = value = x
    for n in ("q", "k", "v"):
        base = f"{prefix}.attn.cvt_{n}"
        if f"{base}.conv.weight" in params:
            t = tokens_dwconv_keep_cls(params, base, x, grid_hw, bn,
                                       ext.cvt_stride, ext.cvt_pad)
            query, key, value = (t if n == "q" else query,
                                 t if n == "k" else key,
                                 t if n == "v" else value)
    w = blk["attn.in_proj_weight"].chunk(3)
    b = blk["attn.in_proj_bias"].chunk(3)
    q = L.linear(query, w[0], b[0])
    k = L.linear(key, w[1], b[1])
    v = L.linear(value, w[2], b[2])
    lora = f"{prefix}.attn.q_proj_adapter1.weight" in params
    if lora:
        def moe(n):
            return params.get(f"{prefix}.attn.{n}_moe_adapter1.weight")

        q = q + lora_delta(ext, params, f"{prefix}.attn.q", query, moe("q"))
        v = v + lora_delta(ext, params, f"{prefix}.attn.v", query, moe("v"))
        if ext.lora_add_where in ("v1", "v2"):
            k = k + lora_delta(ext, params, f"{prefix}.attn.k", query)
    blend = None
    if f"{prefix}.attn.convit_gating_param" in params:
        def blend(weights):
            return convit_blend(params, prefix, weights)
    out = L.softmax_attention(q, k, v, n_head, mask=mask, blend=blend)
    if f"{prefix}.attn.container_gating" in params:
        conv = grid_dwconv_bn(params, f"{prefix}.attn.container_conv",
                              v[:, 1:], grid_hw, bn, ext.container_stride,
                              ext.container_pad)
        conv = torch.cat([out[:, :1], conv], dim=1)
        gate = torch.sigmoid(
            params[f"{prefix}.attn.container_gating"].to(out.dtype))
        out = gate * out + (1.0 - gate) * conv
    fc_delta = None
    if lora and ext.lora_add_where == "v2":
        fc_delta = lora_delta(ext, params, f"{prefix}.attn.fc", out)
    out = L.linear(out, blk["attn.out_proj.weight"], blk["attn.out_proj.bias"])
    return out if fc_delta is None else out + fc_delta


def extended_block(blk, params, prefix, x, n_head, ext: ExtSpec, modality,
                   grid_hw, mask=None, eps=1e-12, bn: BNState | None = None,
                   action=None, take_shared=True):
    """The residual block with the plug-ins of the block at ``prefix``,
    in the reference ``ResidualAttentionBlock.forward``'s order
    (``:941-1033``). ``blk``: the block's local tensors (a text block that
    shares the trunk's, resolved). ``action``: the block's Gumbel action
    ``[2]`` (``gumbel_action``), ``take_shared`` its hard choice, read on
    the host once a forward (the JAX function's ``where(a[0] > a[1],
    ...)``, whose other branch's value and gradient are dropped)."""
    bn = bn or BNState()
    plugins = any(f"{prefix}.{k}" in params for k in _ATTN_PLUGINS)

    def attend(p, t, with_plugins):
        if with_plugins:
            return extended_attention(p, params, prefix, t, n_head, ext,
                                      grid_hw, mask, bn)
        return L.attention(p, t, n_head, mask)

    def path(p, t, with_plugins):
        t = t + attend(p, L.layer_norm(t, p["ln_1.weight"], p["ln_1.bias"],
                                       eps), with_plugins)
        return t + L.mlp(p, L.layer_norm(t, p["ln_2.weight"], p["ln_2.bias"],
                                         eps))

    if ext.gumbel_select:
        specific = {k: params[f"{prefix}.specific_{k}"] for k in L.BLOCK_KEYS}
        a = action.to(x.dtype)
        if ext.gumbel_addtwo:
            return path(blk, x, plugins) * a[0] + path(specific, x, False) \
                * a[1]
        if take_shared:
            return path(blk, x, plugins) * a[0]
        return path(specific, x, False) * a[1]

    if f"{prefix}.adapter_attn.down_proj.weight" in params:
        x = x + apply_adapter(params, f"{prefix}.adapter_attn", attend(
            blk, L.layer_norm(x, blk["ln_1.weight"], blk["ln_1.bias"], eps),
            plugins))
        return x + apply_adapter(params, f"{prefix}.adapter_ffn", L.mlp(
            blk, L.layer_norm(x, blk["ln_2.weight"], blk["ln_2.bias"], eps)))

    if modality == "visual" and f"{prefix}.cvt_dw.{_first_conv(ext)}" \
            in params:
        conv = tokens_dwconv_keep_cls(params, f"{prefix}.cvt_dw", x, grid_hw,
                                      bn, ext.cvt_stride, ext.cvt_pad,
                                      ext.cvt_n_dwc)
        if ext.cvt_res:
            x = L.layer_norm(x + conv, params[f"{prefix}.ln_cvt.weight"],
                             params[f"{prefix}.ln_cvt.bias"], eps)
        else:
            x = conv
    return path(blk, x, plugins)


def _first_conv(ext: ExtSpec) -> str:
    return "conv_1.weight" if ext.cvt_n_dwc > 1 else "conv.weight"


def gumbel_action(logits, generator=None, tau: float = 5.0):
    """A hard one-hot action a layer by straight-through Gumbel-softmax
    (reference ``CLIP.gumbel_softmax`` ``:2892-2935``): the noise drawn
    from ``generator`` (a ``torch.Generator`` on the logits' device), or
    none for the deterministic argmax (eval)."""
    logits = logits.float()
    if generator is not None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
        logits = logits - torch.log(-torch.log(u + 1e-20) + 1e-20)
    y = (logits / tau).softmax(dim=-1)
    hard = F.one_hot(y.argmax(dim=-1), y.shape[-1]).to(y.dtype)
    return (hard - y).detach() + y


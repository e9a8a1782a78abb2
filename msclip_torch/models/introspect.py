"""Introspection taps: per-layer features and attention maps, the port of
``msclip_tpu/models/introspect.py`` (the reference threads
``output_layer_fea`` / ``output_last_attnmap`` / ``OUTPUT_ATTN_RAW``
through its forward, ``clip_openai_pe_res_v1.py:2357-2469, 3003-3041``).
The same blocks as the production path, plus every block's output and
its attention distribution (or its raw pre-softmax scores), recomputed
from the block's post-LN input in plain torch (the attention kernel
returns no weights). As the JAX functions, they cover the plain towers:
the stems, the parallel branch with its plain lateral adapters, and the
text tower; the ModifiedResNet tower has no blocks to tap.
"""

from __future__ import annotations

import torch

from . import layers as L
from . import stem as S
from .msclip import MSClipSpec, image_tokens, resolve_text_block


def attention_maps(p, x, n_head, mask=None, raw=False):
    """The attention weights ``[B, H, L, L]`` (fp32) of the block ``p``
    (local names; int8 weights too) on its post-LN input ``x``; ``raw``
    gives the pre-softmax scores."""
    B, Lq, E = x.shape
    qkv = L.block_linear(p, x, "attn.in_proj_weight", "attn.in_proj_bias")
    q, k, _ = qkv.chunk(3, dim=-1)
    hd = E // n_head
    qh = q.reshape(B, Lq, n_head, hd).transpose(1, 2) \
        * torch.tensor(hd ** -0.5, dtype=x.dtype)
    kh = k.reshape(B, Lq, n_head, hd).transpose(1, 2)
    scores = qh.float() @ kh.float().transpose(-1, -2)
    if mask is not None:
        scores = scores + mask.float()
    return scores if raw else scores.softmax(dim=-1)


def _tap(p, x, n_head, mask, eps, raw, feats, maps):
    normed = L.layer_norm(x, p["ln_1.weight"], p["ln_1.bias"], eps)
    maps.append(attention_maps(p, normed, n_head, mask, raw))
    x = L.transformer_block(p, x, n_head, mask, eps)
    feats.append(x)
    return x


def encode_image_with_taps(params, spec: MSClipSpec, images,
                           raw_attn: bool = False):
    """``(features, taps)``, ``taps = {'layer_features': [n_blocks, B, L,
    W], 'attn_maps': [n_blocks, B, H, L, L]}`` (eval BatchNorm)."""
    if spec.vision_resnet_layers:
        raise NotImplementedError("taps are for the transformer tower")
    bn = S.BNState()
    x = images.to(spec.dtype).permute(0, 3, 1, 2).contiguous()
    g = spec.grid
    tokens = image_tokens(params, spec, x, bn)
    feats, maps = [], []
    parallel_x = None
    for idx in range(spec.first_block, spec.effective_vision_layers):
        if spec.parallel and idx in spec.lateral_layers:
            li = spec.lateral_layers.index(idx)
            parallel_x = S.apply_parallel_stage(
                params, f"visual.transformer.parallel_branch_v.{li}",
                x if li == 0 else parallel_x, spec.parallel_strides[li],
                spec.parallel_paddings[li], spec.parallel_resnet_layers[li],
                bn)
            parallel_x, tokens = S.apply_lateral_adapter(
                params, f"visual.transformer.parallel_lateral_adapter.{li}",
                parallel_x, tokens, (g, g), spec.t2b_strides[li],
                spec.t2b_paddings[li], use_cls=spec.t2b_use_cls,
                eps=spec.ln_eps, bn=bn)
        tokens = _tap(L.block_params(params,
                                     f"visual.transformer.resblocks.{idx}"),
                      tokens, spec.vision_heads, None, spec.ln_eps, raw_attn,
                      feats, maps)
    pooled = L.layer_norm(tokens[:, 0, :], params["visual.ln_post.weight"],
                          params["visual.ln_post.bias"], spec.ln_eps)
    out = L.l2_normalize(pooled @ params["visual.proj"].to(spec.dtype))
    return out, {"layer_features": torch.stack(feats),
                 "attn_maps": torch.stack(maps)}


def encode_text_with_taps(params, spec: MSClipSpec, tokens,
                          raw_attn: bool = False):
    """:func:`encode_image_with_taps` for the text tower (causal maps)."""
    x = params["token_embedding.weight"][tokens.long()].to(spec.dtype)
    x = x + params["positional_embedding"].to(spec.dtype)
    mask = L.build_causal_mask(spec.context_length, device=x.device)
    feats, maps = [], []
    for i in range(spec.text_layers):
        x = _tap(resolve_text_block(params, spec, i), x, spec.text_heads,
                 mask, spec.ln_eps, raw_attn, feats, maps)
    eot = tokens.argmax(dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    pooled = L.layer_norm(pooled, params["ln_final.weight"],
                          params["ln_final.bias"], spec.ln_eps)
    out = L.l2_normalize(pooled @ params["text_projection"].to(spec.dtype))
    return out, {"layer_features": torch.stack(feats),
                 "attn_maps": torch.stack(maps)}

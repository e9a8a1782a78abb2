"""Reference ``state_dict`` key map and loaders for the zero-shot path.

The port stores parameters in the reference MS-CLIP ``state_dict`` layout,
so a released ``.pth`` loads without transposes. What loading checks:

* every key of the checkpoint is known, and every parameter is present;
* an aliased shared key (a text block that reuses the trunk's attn/mlp
  appears under both names, as ``model.state_dict()`` of the reference
  writes it) equals its visual twin, and is then dropped, so each tensor
  is held once;
* shapes match the spec; ``num_batches_tracked`` is ignored.

``export_state_dict`` writes the layout back, aliases included.
``params_from_jax`` carries a ``msclip_tpu`` ``init_params`` tree (as numpy
arrays) across through the same key map: JAX linear weights are
``[in, out]`` and convs HWIO, the port's ``[out, in]`` and OIHW. A tree
that ``msclip_tpu.models.quantize.quantize_params_for_eval`` produced
carries its int8 GEMM weights across too: JAX's ``qkv_w_int8`` /
``qkv_w_scale`` (or ``w_int8`` / ``w_scale``, ``[in, out]``) become the
port's ``<key>_int8`` (``[out, in]``) / ``<key>_scale``. ``block_from_jax``
carries one block tree across under the block's local names.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..models.extensions import lora_names
from ..models.layers import BLOCK_KEYS
from ..models.msclip import MSClipSpec

# key kinds: how a JAX leaf maps onto the reference tensor (POOL: the
# grouped Conv1d pooling head, JAX [L, C] <-> torch [C, 1, L])
LINEAR, CONV, SAME, POOL = "linear", "conv", "same", "pool"
_BLOCK_JAX = {
    "ln_1.weight": (("ln_1", "scale"), SAME),
    "ln_1.bias": (("ln_1", "bias"), SAME),
    "attn.in_proj_weight": (("attn", "qkv_w"), LINEAR),
    "attn.in_proj_bias": (("attn", "qkv_b"), SAME),
    "attn.out_proj.weight": (("attn", "out_w"), LINEAR),
    "attn.out_proj.bias": (("attn", "out_b"), SAME),
    "ln_2.weight": (("ln_2", "scale"), SAME),
    "ln_2.bias": (("ln_2", "bias"), SAME),
    "mlp.c_fc.weight": (("mlp", "c_fc", "w"), LINEAR),
    "mlp.c_fc.bias": (("mlp", "c_fc", "b"), SAME),
    "mlp.c_proj.weight": (("mlp", "c_proj", "w"), LINEAR),
    "mlp.c_proj.bias": (("mlp", "c_proj", "b"), SAME),
}


def derived_keys(spec: MSClipSpec):
    """Reference keys that are buffers derived from the spec, not
    parameters (the window adapters' relative-position index): a
    checkpoint may hold them, loading drops them, export leaves them
    out."""
    if not (spec.parallel and spec.t2b_windowattn
            and spec.window_relative_pos) or spec.vision_resnet_layers:
        return ()
    return tuple(f"visual.transformer.parallel_lateral_adapter.{i}."
                 "relative_position_index"
                 for i in range(len(spec.lateral_layers)))


def build_key_map(spec: MSClipSpec):
    """``(stored, aliases)``: ``stored`` maps each reference key the port
    holds to ``(msclip_tpu params path, kind)`` (the JAX package's
    ``build_key_map``); ``aliases`` maps each aliased text-side key to the
    stored key it must equal."""
    m: Dict[str, Tuple[tuple, str]] = {}
    aliases: Dict[str, str] = {}

    def ln(prefix, path):
        m[f"{prefix}.weight"] = (path + ("scale",), SAME)
        m[f"{prefix}.bias"] = (path + ("bias",), SAME)

    def bnorm(prefix, path):
        ln(prefix, path)
        m[f"{prefix}.running_mean"] = (path + ("mean",), SAME)
        m[f"{prefix}.running_var"] = (path + ("var",), SAME)

    def conv(key, path):
        m[key] = (path + ("w",), CONV)

    def lin(prefix, path):
        m[f"{prefix}.weight"] = (path + ("w",), LINEAR)
        m[f"{prefix}.bias"] = (path + ("b",), SAME)

    def block(prefix, path, own=BLOCK_KEYS):
        for k in own:
            sub, kind = _BLOCK_JAX[k]
            m[f"{prefix}.{k}"] = (path + sub, kind)

    def extensions(prefix, path, modality, i):
        ext = spec.ext
        if ext.layer_has("adapter", modality, i):
            for name in ("adapter_attn", "adapter_ffn"):
                for proj in ("down_proj", "up_proj"):
                    lin(f"{prefix}.{name}.{proj}", path + (name, proj))
        if ext.layer_has("cvt", modality, i) and not ext.cvt_inside:
            for j in range(ext.cvt_n_dwc):
                sx = f"_{j + 1}" if ext.cvt_n_dwc > 1 else ""
                conv(f"{prefix}.cvt_dw.conv{sx}.weight",
                     path + ("cvt_dw", f"conv{sx}"))
                bnorm(f"{prefix}.cvt_dw.bn{sx}", path + ("cvt_dw", f"bn{sx}"))
            if ext.cvt_res:
                ln(f"{prefix}.ln_cvt", path + ("ln_cvt",))
        if ext.layer_has("cvt", modality, i) and ext.cvt_inside:
            for n, on in (("q", ext.cvt_inside_q), ("k", ext.cvt_inside_k),
                          ("v", ext.cvt_inside_v)):
                if on:
                    conv(f"{prefix}.attn.cvt_{n}.conv.weight",
                         path + ("cvt_inside", n, "conv"))
                    bnorm(f"{prefix}.attn.cvt_{n}.bn",
                          path + ("cvt_inside", n, "bn"))
        if ext.layer_has("convit", modality, i):
            lin(f"{prefix}.attn.convit_pos_proj", path + ("convit",
                                                          "pos_proj"))
            m[f"{prefix}.attn.convit_gating_param"] = (
                path + ("convit", "gating"), SAME)
        if ext.layer_has("container", modality, i):
            conv(f"{prefix}.attn.container_conv.conv.weight",
                 path + ("container", "conv"))
            bnorm(f"{prefix}.attn.container_conv.bn",
                  path + ("container", "bn"))
            m[f"{prefix}.attn.container_gating"] = (
                path + ("container", "gating"), SAME)
        if ext.layer_has("lora", modality, i):
            for n in lora_names(ext):
                for j, leaf in (("1", "a"), ("2", "b")):
                    m[f"{prefix}.attn.{n}_proj_adapter{j}.weight"] = (
                        path + ("lora", n, leaf), LINEAR)
            if ext.lora_moe == 1:
                for n in ("q", "v"):
                    m[f"{prefix}.attn.{n}_moe_adapter1.weight"] = (
                        path + ("lora", f"{n}_moe"), LINEAR)
        if ext.gumbel_select:
            for k, (sub, kind) in _BLOCK_JAX.items():
                m[f"{prefix}.specific_{k}"] = (path + ("specific",) + sub,
                                               kind)

    def conv_pool(prefix, path):
        m[f"{prefix}.weight"] = (path + ("w",), POOL)
        m[f"{prefix}.bias"] = (path + ("b",), SAME)

    def perceiver(trunk, path):
        m[f"{trunk}.perceiver_latent"] = (path + ("perceiver_latent",), SAME)
        for i in range(len(spec.perceiver_layers)):
            bt = f"{trunk}.perceiver_latent2ori_blocks.{i}"
            bp = path + ("perceiver_blocks", i)
            block(bt, bp)
            ln(f"{bt}.norm_context", bp + ("norm_context",))

    V = ("visual",)
    m["logit_scale"] = (("logit_scale",), SAME)
    if spec.ext.gumbel_select:
        m["gumbel_logit"] = (("gumbel_logit",), SAME)
    if spec.vision_resnet_layers:
        rn = V + ("resnet",)
        for i in (1, 2, 3):
            conv(f"visual.conv{i}.weight", rn + (f"conv{i}",))
            bnorm(f"visual.bn{i}", rn + (f"bn{i}",))
        for stage, n_blocks in enumerate(spec.vision_resnet_layers):
            for j in range(n_blocks):
                bt = f"visual.layer{stage + 1}.{j}"
                bp = rn + (f"layer{stage + 1}", j)
                for n in ("1", "2", "3"):
                    conv(f"{bt}.conv{n}.weight", bp + (f"conv{n}",))
                    bnorm(f"{bt}.bn{n}", bp + (f"bn{n}",))
                if j == 0:  # the first block of a stage projects
                    conv(f"{bt}.downsample.0.weight", bp + ("down_conv",))
                    bnorm(f"{bt}.downsample.1", bp + ("down_bn",))
        ap = rn + ("attnpool",)
        m["visual.attnpool.positional_embedding"] = (
            ap + ("positional_embedding",), SAME)
        for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
            lin(f"visual.attnpool.{proj}", ap + (proj,))
    else:
        m["visual.class_embedding"] = (V + ("class_embedding",), SAME)
        m["visual.positional_embedding"] = (V + ("positional_embedding",),
                                            SAME)
        m["visual.proj"] = (V + ("proj",), SAME)
        ln("visual.ln_pre", V + ("ln_pre",))
        ln("visual.ln_post", V + ("ln_post",))
        if spec.pool_type == "linear":
            conv_pool("visual.conv_pool", V + ("conv_pool",))
        st, sp = spec.stem_prefix, V + ("stem",)
        if not spec.early_conv:
            conv("visual.conv1.weight", V + ("conv1",))
        elif spec.early_conv_res:
            conv(f"{st}.conv1.weight", sp + ("conv1",))
            bnorm(f"{st}.bn1", sp + ("bn1",))
            for i in range(len(spec.early_conv_strides)):
                t, p = f"{st}.resnet_stage.conv_{i}", sp + ("stages", i)
                conv(f"{t}.conv1.weight", p + ("conv1",))
                bnorm(f"{t}.bn1", p + ("bn1",))
                conv(f"{t}.downsample.0.weight", p + ("down_conv",))
                bnorm(f"{t}.downsample.1", p + ("down_bn",))
            conv(f"{st}.last_conv.weight", sp + ("last_conv",))
        else:  # the plain 6-conv stem
            for i in range(1, 6):
                conv(f"{st}.conv_{i}.weight", sp + (f"conv_{i}",))
                bnorm(f"{st}.bn_{i}", sp + (f"bn_{i}",))
            conv(f"{st}.conv_6.weight", sp + ("conv_6",))

        for i in range(spec.first_block, spec.effective_vision_layers):
            prefix = f"visual.transformer.resblocks.{i}"
            block(prefix, V + ("blocks", i - spec.first_block))
            if spec.ext.any_active:
                extensions(prefix, V + ("ext_blocks", i - spec.first_block),
                           "visual", i)
        if spec.perceiver_in_v:
            perceiver("visual.transformer", V)
        if spec.parallel:
            _map_branch(spec, conv, bnorm, ln, lin, m, V)

    T = ("text",)
    m["token_embedding.weight"] = (T + ("token_embedding",), SAME)
    m["positional_embedding"] = (T + ("positional_embedding",), SAME)
    m["text_projection"] = (T + ("text_projection",), SAME)
    ln("ln_final", T + ("ln_final",))
    if spec.pool_type == "linear":
        conv_pool("conv_pool", T + ("conv_pool",))
    if spec.perceiver_in_t:
        perceiver("transformer", T)
    shared = set(spec.shared_block_keys())
    minus1 = 1 if spec.visual_layer_minus1 else 0
    for i in range(spec.text_layers):
        own = f"transformer.resblocks.{i}"
        alias = [k for k in BLOCK_KEYS
                 if spec.text_layer_is_shared(i) and k in shared]
        for k in alias:
            aliases[f"{own}.{k}"] = \
                f"visual.transformer.resblocks.{i - minus1}.{k}"
        block(own, T + ("blocks", i),
              own=[k for k in BLOCK_KEYS if k not in alias])
        if spec.ext.any_active:
            extensions(own, T + ("ext_blocks", i), "text", i)
    return m, aliases


def _map_branch(spec: MSClipSpec, conv, bnorm, ln, lin, m, V):
    """The parallel branch's and lateral adapters' keys."""
    for i in range(spec.parallel_n_layers):
        bt, bp = f"visual.transformer.parallel_branch_v.{i}", \
            V + ("parallel_stages", i)
        if i == 0 or spec.parallel_resnet_layers[i] == 0:
            conv(f"{bt}.conv.weight", bp + ("conv",))
            bnorm(f"{bt}.bn", bp + ("bn",))
            continue
        for j in range(spec.parallel_resnet_layers[i]):
            ct, cp = f"{bt}.resnet_stage.conv_{j}", bp + ("blocks", j)
            for n in ("1", "2", "3"):
                conv(f"{ct}.conv{n}.weight", cp + (f"conv{n}",))
                bnorm(f"{ct}.bn{n}", cp + (f"bn{n}",))
            if j == 0:
                conv(f"{ct}.residual_conv.weight", cp + ("residual_conv",))
                bnorm(f"{ct}.residual_bn", cp + ("residual_bn",))
    for i in range(len(spec.lateral_layers)):
        at = f"visual.transformer.parallel_lateral_adapter.{i}"
        ap = V + ("lateral_adapters", i)
        if spec.t2b_windowattn:
            m[f"{at}.q_proj_weight"] = (ap + ("q_w",), LINEAR)
            m[f"{at}.q_in_proj_bias"] = (ap + ("q_b",), SAME)
            for name, conv_leaf, bn_leaf in (
                    ("k_dwconv", "k_dwconv", "k_dwbn"),
                    ("v_dwconv", "v_dwconv", "v_dwbn"),
                    ("bottom_dw_conv", "bottom_dw_conv", "bottom_dw_bn")):
                conv(f"{at}.{name}.conv.weight", ap + (conv_leaf,))
                bnorm(f"{at}.{name}.bn", ap + (bn_leaf,))
            lin(f"{at}.out_proj", ap + ("out",))
            ln(f"{at}.ln_adapt", ap + ("ln_adapt",))
            if spec.window_relative_pos:
                m[f"{at}.relative_position_bias_table"] = (
                    ap + ("rel_pos_table",), SAME)
            continue
        conv(f"{at}.top2bottom_dw_conv.conv.weight", ap + ("t2b_dw_conv",))
        bnorm(f"{at}.top2bottom_dw_conv.bn", ap + ("t2b_dw_bn",))
        conv(f"{at}.top2bottom_pw_conv.conv.weight", ap + ("t2b_pw_conv",))
        if spec.t2b_bn_relu:
            bnorm(f"{at}.top2bottom_pw_conv.bn", ap + ("t2b_pw_bn",))
        if spec.t2b_bn_ln_relu:
            ln(f"{at}.top2bottom_pw_conv.ln", ap + ("t2b_pw_ln",))
        conv(f"{at}.bottom_dw_conv.conv.weight", ap + ("bottom_dw_conv",))
        bnorm(f"{at}.bottom_dw_conv.bn", ap + ("bottom_dw_bn",))
        if not spec.t2b_noln_add:
            ln(f"{at}.ln_adapt", ap + ("ln_adapt",))
        if not spec.b2t_active(i):
            continue
        conv(f"{at}.top_dw_conv.conv.weight", ap + ("top_dw_conv",))
        bnorm(f"{at}.top_dw_conv.bn", ap + ("top_dw_bn",))
        if spec.b2t_mode == "deconv":
            conv(f"{at}.bottom2top_dw_deconv.conv.weight",
                 ap + ("b2t_dw_deconv",))
            bnorm(f"{at}.bottom2top_dw_deconv.bn", ap + ("b2t_dw_bn",))
            conv(f"{at}.bottom2top_pw_deconv.conv.weight",
                 ap + ("b2t_pw_conv",))
            bnorm(f"{at}.bottom2top_pw_deconv.bn", ap + ("b2t_pw_bn",))
            continue
        conv(f"{at}.bottom2top_dw_conv.conv.weight", ap + ("b2t_dw_conv",))
        bnorm(f"{at}.bottom2top_dw_conv.bn", ap + ("b2t_dw_bn",))
        if spec.b2t_mode == "bilinear":
            conv(f"{at}.bottom2top_pw_conv.conv.weight", ap + ("b2t_pw_conv",))
            bnorm(f"{at}.bottom2top_pw_conv.bn", ap + ("b2t_pw_bn",))
        else:  # crossattn
            ca = ap + ("crossattn",)
            for n in ("q", "k", "v"):
                m[f"{at}.bottom2top_crossattn.{n}_proj_weight"] = (
                    ca + (f"{n}_w",), LINEAR)
                m[f"{at}.bottom2top_crossattn.{n}_in_proj_bias"] = (
                    ca + (f"{n}_b",), SAME)
            ln(f"{at}.bottom2top_ln", ap + ("b2t_ln",))


def _get_path(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _from_jax(arr, kind):
    arr = np.asarray(arr, np.float32)
    if kind == LINEAR:
        arr = arr.T
    elif kind == CONV:
        arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    elif kind == POOL:
        arr = arr.T[:, None, :]  # [L, C] -> [C, 1, L]
    return torch.from_numpy(np.array(arr, order="C"))  # a writable copy


def params_from_jax(tree, spec: MSClipSpec):
    """A ``msclip_tpu.models.init_params`` tree (leaves as numpy arrays),
    int8-quantized for eval or not, -> the port's parameter dict."""
    stored, _ = build_key_map(spec)
    out = {}
    for k, (path, kind) in stored.items():
        *parent, leaf = path
        node = _get_path(tree, parent)
        if leaf in node or kind != LINEAR:
            out[k] = _from_jax(node[leaf], kind)
            continue
        q = np.asarray(node[leaf + "_int8"])
        if q.dtype != np.int8:
            raise TypeError(f"{k}: the JAX int8 weight is {q.dtype}")
        out[k + "_int8"] = torch.from_numpy(np.ascontiguousarray(q.T))
        out[k + "_scale"] = _from_jax(node[leaf + "_scale"], SAME)
    return out


def block_from_jax(blk):
    """One ``msclip_tpu`` block tree (``init_block``'s layout, leaves as
    numpy arrays) -> the port's local names (``layers.block_params``),
    linear weights ``[out, in]``, fp32."""
    return {k: _from_jax(_get_path(blk, path), kind)
            for k, (path, kind) in _BLOCK_JAX.items()}


def load_state_dict(state_dict, spec: MSClipSpec, expected_shapes=None):
    """A reference-layout ``state_dict`` -> the port's parameter dict
    (fp32 CPU tensors, aliased text keys verified and dropped).
    ``expected_shapes``: optional ``{key: shape}`` to check against."""
    stored, aliases = build_key_map(spec)
    derived = set(derived_keys(spec))
    sd = {k: torch.as_tensor(v).detach().cpu().float()
          for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked") and k not in derived}
    unknown = sorted(set(sd) - set(stored) - set(aliases))
    if unknown:
        raise KeyError(f"{len(unknown)} checkpoint keys are not parameters "
                       f"of this spec, e.g. {unknown[:5]}")
    missing = sorted(set(stored) - set(sd))
    if missing:
        raise KeyError(f"{len(missing)} parameters missing from the "
                       f"checkpoint, e.g. {missing[:5]}")
    for key, twin in aliases.items():
        if key in sd and not (sd[key].shape == sd[twin].shape and torch.allclose(
                sd[key], sd[twin], rtol=1e-5, atol=1e-6)):
            raise ValueError(
                f"aliased shared key {key!r} differs from its trunk twin "
                f"{twin!r}: this checkpoint is not weight-shared as the "
                "spec claims")
    out = {}
    for key in stored:
        t = sd[key]
        if expected_shapes is not None:
            want = tuple(expected_shapes[key])
            if tuple(t.shape) != want:
                if t.numel() != math.prod(want):
                    raise ValueError(f"shape of {key}: checkpoint "
                                     f"{tuple(t.shape)}, spec {want}")
                t = t.reshape(want)  # e.g. logit_scale stored as (1,)
        out[key] = t
    logging.info("=> loaded %d tensors: %d stored, %d aliased and verified",
                 len(sd), len(out), sum(k in sd for k in aliases))
    return out



def export_state_dict(params, spec: MSClipSpec):
    """The port's parameter dict -> a reference-layout ``state_dict``
    (contiguous fp32 CPU tensors), the counterpart of the JAX package's
    ``export_torch_state_dict``: a shared text-layer key is emitted under
    its own name too, holding its trunk twin's tensor, as the reference's
    ``model.state_dict()`` writes it."""
    stored, aliases = build_key_map(spec)
    out = {k: params[k].detach().cpu().float().contiguous() for k in stored}
    for key, twin in aliases.items():
        out[key] = out[twin].clone()
    return out

"""Reference ``state_dict`` key map and loaders for the zero-shot path.

The port stores parameters in the reference MS-CLIP ``state_dict`` layout,
so a released ``.pth`` loads without transposes. What loading checks:

* every key of the checkpoint is known, and every parameter is present;
* an aliased shared key (a text block that reuses the trunk's attn/mlp
  appears under both names, as ``model.state_dict()`` of the reference
  writes it) equals its visual twin, and is then dropped, so each tensor
  is held once;
* shapes match the spec; ``num_batches_tracked`` is ignored.

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

from ..models.layers import BLOCK_KEYS
from ..models.msclip import MSClipSpec

# key kinds: how a JAX leaf maps onto the reference tensor
LINEAR, CONV, SAME = "linear", "conv", "same"
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


def build_key_map(spec: MSClipSpec):
    """``(stored, aliases)``: ``stored`` maps each reference key the port
    holds to ``(msclip_tpu params path, kind)``; ``aliases`` maps each
    aliased text-side key to the stored key it must equal."""
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

    V = ("visual",)
    m["logit_scale"] = (("logit_scale",), SAME)
    m["visual.class_embedding"] = (V + ("class_embedding",), SAME)
    m["visual.positional_embedding"] = (V + ("positional_embedding",), SAME)
    m["visual.proj"] = (V + ("proj",), SAME)
    ln("visual.ln_pre", V + ("ln_pre",))
    ln("visual.ln_post", V + ("ln_post",))

    st, sp = spec.stem_prefix, V + ("stem",)
    conv(f"{st}.conv1.weight", sp + ("conv1",))
    bnorm(f"{st}.bn1", sp + ("bn1",))
    for i in range(len(spec.early_conv_strides)):
        t, p = f"{st}.resnet_stage.conv_{i}", sp + ("stages", i)
        conv(f"{t}.conv1.weight", p + ("conv1",))
        bnorm(f"{t}.bn1", p + ("bn1",))
        conv(f"{t}.downsample.0.weight", p + ("down_conv",))
        bnorm(f"{t}.downsample.1", p + ("down_bn",))
    conv(f"{st}.last_conv.weight", sp + ("last_conv",))

    for i in range(spec.first_block, spec.effective_vision_layers):
        for k, (path, kind) in _BLOCK_JAX.items():
            m[f"visual.transformer.resblocks.{i}.{k}"] = (
                V + ("blocks", i - spec.first_block) + path, kind)

    if spec.parallel:
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
            conv(f"{at}.top2bottom_dw_conv.conv.weight", ap + ("t2b_dw_conv",))
            bnorm(f"{at}.top2bottom_dw_conv.bn", ap + ("t2b_dw_bn",))
            conv(f"{at}.top2bottom_pw_conv.conv.weight", ap + ("t2b_pw_conv",))
            conv(f"{at}.bottom_dw_conv.conv.weight", ap + ("bottom_dw_conv",))
            bnorm(f"{at}.bottom_dw_conv.bn", ap + ("bottom_dw_bn",))
            ln(f"{at}.ln_adapt", ap + ("ln_adapt",))

    T = ("text",)
    m["token_embedding.weight"] = (T + ("token_embedding",), SAME)
    m["positional_embedding"] = (T + ("positional_embedding",), SAME)
    m["text_projection"] = (T + ("text_projection",), SAME)
    ln("ln_final", T + ("ln_final",))
    shared = set(spec.shared_block_keys())
    minus1 = 1 if spec.visual_layer_minus1 else 0
    for i in range(spec.text_layers):
        own = f"transformer.resblocks.{i}"
        for k in BLOCK_KEYS:
            if spec.text_layer_is_shared(i) and k in shared:
                aliases[f"{own}.{k}"] = \
                    f"visual.transformer.resblocks.{i - minus1}.{k}"
            else:
                path, kind = _BLOCK_JAX[k]
                m[f"{own}.{k}"] = (T + ("blocks", i) + path, kind)
    return m, aliases


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
    sd = {k: torch.as_tensor(v).detach().cpu().float()
          for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}
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


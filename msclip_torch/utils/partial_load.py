"""Partial pretrained loading: GPT-2 block weights into the shared trunk.

The port of ``msclip_tpu/utils/partial_load.py`` (reference
``smart_partial_load_model_state_dict``, ``lib/utils/utils.py:217-275``):
transformer-LM block weights under GPT-2's names go onto the *visual
trunk blocks* that the text tower shares, for the layer range that
``CUSTOM.N_LAYERS`` / ``CUSTOM.SHARE_BOTTOM_LAYER`` imply.

GPT-2's ``Conv1D`` stores a weight as ``[in, out]``, which is the JAX
package's layout (its loader transposes nothing); the port's linear
weights are torch's ``[out, in]``, so the four matrix weights are
**transposed** here.

Default mapping (the reference's ``pt_mapping``), GPT-2 name -> the block's
local name:
  ``attn.c_attn.* -> attn.in_proj_*``   ``attn.c_proj.* -> attn.out_proj.*``
  ``mlp.c_fc.* / mlp.c_proj.*``         ``ln_1.* / ln_2.*``
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

# GPT-2 name -> (the port's local block name, transposed)
DEFAULT_GPT2_MAPPING = {
    "attn.c_attn.weight": ("attn.in_proj_weight", True),
    "attn.c_attn.bias": ("attn.in_proj_bias", False),
    "attn.c_proj.weight": ("attn.out_proj.weight", True),
    "attn.c_proj.bias": ("attn.out_proj.bias", False),
    "mlp.c_fc.weight": ("mlp.c_fc.weight", True),
    "mlp.c_fc.bias": ("mlp.c_fc.bias", False),
    "mlp.c_proj.weight": ("mlp.c_proj.weight", True),
    "mlp.c_proj.bias": ("mlp.c_proj.bias", False),
    "ln_1.weight": ("ln_1.weight", False),
    "ln_1.bias": ("ln_1.bias", False),
    "ln_2.weight": ("ln_2.weight", False),
    "ln_2.bias": ("ln_2.bias", False),
}


def load_layer_range(spec) -> list:
    """Layers receiving pretrained weights (reference ``:218-226``)."""
    n = spec.text_layers
    if spec.share_n_layers == -1:
        return list(range(n))
    if spec.share_bottom_layer:
        return list(range(spec.share_n_layers))
    return list(range(spec.share_n_layers, n))


def partial_load_gpt2(params: Dict[str, torch.Tensor], spec,
                      pt_state_dict: Dict[str, np.ndarray], mapping=None):
    """Load GPT-2 block weights into the shared visual-trunk blocks.

    ``pt_state_dict``: a flat dict whose keys end in ``<layer>.<gpt2
    name>`` (``h.3.attn.c_attn.weight`` or ``3.attn.c_attn.weight``).
    Layer ``l`` lands in ``visual.transformer.resblocks.<l>`` (the JAX
    package's ``visual.blocks[l - stem]``: the port numbers the trunk's
    resblocks from the stem). Returns a new params dict, the tensors fp32;
    a shape that differs raises, and unmatched patterns are logged, not
    errors (the reference's matched/non-matched bookkeeping)."""
    if not spec.share_modules:
        raise ValueError(
            "partial pretrained load is only implemented for the "
            "modality-shared model (reference behavior)")
    mapping = mapping or DEFAULT_GPT2_MAPPING
    layers = load_layer_range(spec)
    params = dict(params)
    matched, unmatched = [], []
    for l_id in layers:
        prefix = f"visual.transformer.resblocks.{l_id}"
        for pt_suffix, (name, transpose) in mapping.items():
            pt_pattern = f"{l_id}.{pt_suffix}"
            hit = next((k for k in pt_state_dict if k.endswith(pt_pattern)),
                       None)
            if hit is None:
                unmatched.append(pt_pattern)
                continue
            value = np.asarray(pt_state_dict[hit], np.float32)
            if transpose:
                value = value.T
            expected = params[f"{prefix}.{name}"]
            if value.shape != tuple(expected.shape):
                raise ValueError(
                    f"shape mismatch {hit}: {value.shape} vs "
                    f"{tuple(expected.shape)}"
                    + (" (GPT-2's [in, out] transposed)" if transpose else ""))
            params[f"{prefix}.{name}"] = torch.from_numpy(
                np.ascontiguousarray(value)).to(expected.device)
            matched.append(hit)
    logging.info(
        f"[Partial Load] matched {len(matched)} tensors into layers "
        f"{layers}; unmatched patterns: {len(unmatched)}")
    return params

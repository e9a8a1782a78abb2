"""W8A8 int8 quantization of the transformer trunk's GEMMs for eval
(``TPU.INT8_EVAL``), the port of ``msclip_tpu/models/quantize.py``.

:func:`quantize_params_for_eval` rewrites the four GEMM weights of every
stored trunk block (visual resblocks 1.., and each text block's own
weights) to symmetric per-output-channel int8. A weight stored under
``<key>`` (``[out, in]``, e.g. ``visual.transformer.resblocks.3.mlp.c_fc.weight``)
is replaced by two tensors:

* ``<key>_int8``: int8 ``[out, in]``;
* ``<key>_scale``: fp32 ``[out]``, the per-output-channel scale.

:func:`msclip_torch.models.layers.transformer_block` dispatches on those
names: it quantizes the activations per token (on the fly, or fused into
the LayerNorm and QuickGELU by K3/K4 at ``L >= 96``) and runs the int8 GEMM
with int32 accumulate. Biases, LayerNorms, the stem, the branch, the
adapters, the embeddings and the projections keep full precision. A text
block that shares the trunk's attn/mlp holds no copy of its own and reads
the trunk's int8 tensors (``msclip.resolve_text_block``).

The JAX function's refusals hold here too: ``TPU.USE_FUSED_BLOCK`` with
``TPU.INT8_EVAL`` raises ``ValueError`` in ``msclip.spec_from_config``, and
:func:`quantize_params_for_eval` raises for the extension families and for
the ModifiedResNet tower. The Perceiver blocks keep full precision.
"""

from __future__ import annotations

import torch

from ..ops.quant import div127
from .layers import GEMM_KEYS


def quantize_linear_weight(w: torch.Tensor):
    """fp ``[out, in]`` -> (int8 ``[out, in]``, fp32 ``[out]`` scale); the
    scale of an output channel is the max of its ``|w|`` over ``in``."""
    wf = w.float()
    scale = torch.clamp_min(div127(wf.abs().amax(dim=1)), 1e-8)
    q = torch.clamp(torch.round(wf / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_params_for_eval(params, spec):
    """A copy of ``params`` with every stored trunk block's GEMM weights
    as ``<key>_int8`` / ``<key>_scale`` pairs (module docstring)."""
    if spec.vision_resnet_layers:
        raise ValueError(
            "TPU.INT8_EVAL quantizes the transformer trunk's blocks; the "
            "ModifiedResNet tower has none (the JAX package's "
            "quantize_params_for_eval fails on its tree too)")
    if spec.ext.any_active:
        raise ValueError(
            "TPU.INT8_EVAL does not support the experimental extension "
            "zoo (spec.ext is active); disable the CUSTOM extensions or "
            "the int8 mode")
    out = dict(params)
    prefixes = [f"visual.transformer.resblocks.{i}"
                for i in range(spec.first_block, spec.effective_vision_layers)]
    prefixes += [f"transformer.resblocks.{i}" for i in range(spec.text_layers)]
    for prefix in prefixes:
        for name in GEMM_KEYS:
            key = f"{prefix}.{name}"
            if key in out:  # a shared text block stores no copy of its own
                out[f"{key}_int8"], out[f"{key}_scale"] = \
                    quantize_linear_weight(out.pop(key))
    return out

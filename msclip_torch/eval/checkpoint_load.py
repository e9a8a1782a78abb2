"""Model parameters for evaluation (port of ``msclip_tpu/eval/checkpoint_load.py``).

``MODEL.PRETRAINED_MODEL``:

1. ``*.pth`` / ``*.pt``: a reference torch checkpoint (a bare
   ``state_dict`` like the released files, or a training dict with a
   ``state_dict`` key), loaded through the key map of ``utils/convert.py``;
2. empty or missing: random parameters from ``TPU.SEED`` (CI, benchmarks).

Native ``msclip_tpu`` checkpoints (msgpack / Orbax) are not read here.
"""

from __future__ import annotations

import logging
import os

import torch

from ..models.msclip import MSClipSpec, init_params
from ..utils.convert import load_state_dict


def load_model_params(config, spec: MSClipSpec):
    """fp32 CPU parameters in the reference layout."""
    seed = int(config.TPU.get("SEED", 0))
    template = init_params(spec, torch.Generator().manual_seed(seed))
    path = config.MODEL.get("PRETRAINED_MODEL", "")
    if path and os.path.exists(path):
        if not path.endswith((".pth", ".pt")):
            raise NotImplementedError(
                f"{path}: only reference torch checkpoints (.pth/.pt) load "
                "into msclip_torch; native msclip_tpu checkpoints come with "
                "the train step (ROADMAP M6)")
        logging.info(f"=> load model file: {path}")
        # tensors only: a released or exported checkpoint holds nothing else
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
            obj = obj["state_dict"]
        return load_state_dict(
            obj, spec, {k: v.shape for k, v in template.items()})
    if path:
        logging.warning(f"=> PRETRAINED_MODEL {path} not found; using random "
                        "init")
    return template

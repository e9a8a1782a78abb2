"""Model parameters for evaluation (port of ``msclip_tpu/eval/checkpoint_load.py``).

``MODEL.PRETRAINED_MODEL``:

1. ``*.pth`` / ``*.pt``: a reference torch checkpoint (a bare
   ``state_dict`` like the released files, or a training dict with a
   ``state_dict`` key), loaded through the key map of ``utils/convert.py``;
2. a directory: a checkpoint of the port's train driver, a step
   (``checkpoints/<step>``) or an EMA/SWA shadow (``checkpoints/ema``,
   ``checkpoints/swa``), as the JAX package restores its own
   (``train/checkpoint.py``);
3. empty or missing: random parameters from ``TPU.SEED`` (CI, benchmarks).

A JAX-trained checkpoint comes in as a ``.pth`` exported by the JAX
package (Orbax needs JAX).
"""

from __future__ import annotations

import logging
import os

import torch

from ..models.msclip import MSClipSpec, init_params
from ..train.checkpoint import restore_params
from ..utils.convert import load_state_dict


def load_model_params(config, spec: MSClipSpec):
    """fp32 CPU parameters in the reference layout."""
    seed = int(config.TPU.get("SEED", 0))
    template = init_params(spec, torch.Generator().manual_seed(seed))
    path = config.MODEL.get("PRETRAINED_MODEL", "")
    if path and os.path.exists(path):
        logging.info(f"=> load model file: {path}")
        if os.path.isdir(path):
            params = restore_params(path)
            bad = sorted(k for k in set(template) | set(params)
                         if k not in template or k not in params
                         or template[k].shape != params[k].shape)
            if bad:
                raise ValueError(f"{path}: {len(bad)} tensors do not fit "
                                 f"the configured model, e.g. {bad[:5]}")
            return {k: v.float() for k, v in params.items()}
        if not path.endswith((".pth", ".pt")):
            raise ValueError(f"{path}: a checkpoint is a .pth/.pt file or "
                             "a directory of the port's train driver")
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

"""Weight averaging, EMA and SWA: the port of ``msclip_tpu/train/averaging.py``.

``TRAIN.EMA_DECAY`` and the ``SWA.*`` tree (``lib/config/default.py:
109-116,146``); the reference keeps ``ema_shadow_states`` / ``swa_states``
in its training checkpoints (``lib/utils/utils.py:157-201``). Shadows are
flat reference-layout dicts of tensors (``MSClipModel.params()``), BN
running statistics included.
"""

from __future__ import annotations

import torch

from ..models import msclip as MM
from ..models.stem import BNState


@torch.no_grad()
def ema_update(ema_params, params, decay: float) -> None:
    """``ema = decay ema + (1 - decay) p``, in place."""
    for k, e in ema_params.items():
        e.mul_(decay).add_(params[k], alpha=1.0 - decay)


@torch.no_grad()
def swa_update(swa_params, params, n_averaged: int) -> int:
    """Running equal-weight average in place, ``swa += (p - swa) / (n +
    1)``; returns ``n + 1``."""
    for k, s in swa_params.items():
        s.add_((params[k] - s) / (n_averaged + 1.0))
    return n_averaged + 1


def swa_should_update(epoch: int, config) -> bool:
    return (config.SWA.ENABLED and config.SWA.BEGIN_EPOCH >= 0
            and epoch >= config.SWA.BEGIN_EPOCH)


@torch.no_grad()
def swa_refresh_bn(params, spec: MM.MSClipSpec, batches):
    """torch ``optim.swa_utils.update_bn`` for the averaged weights: the
    running statistics are recomputed as the cumulative average of the
    batch statistics of one pass of ``batches`` (image tensors ``[B, H,
    W, 3]`` on the params' device): batch k (0-based) blends at momentum
    ``1/(k+1)``, so batch 0 replaces the stale statistics. Only the image
    tower runs (the text tower has no BN). ``params`` is updated in place
    and returned; a spec without BatchNorm runs nothing."""
    if not any(k.endswith(".running_mean") for k in params):
        return params
    for k, images in enumerate(batches):
        bn = BNState(training=True, momentum=1.0 / (k + 1))
        MM.encode_image(params, spec, images, bn=bn, normalize=False)
        for prefix, (mean, var) in bn.updates.items():
            params[f"{prefix}.running_mean"].copy_(mean)
            params[f"{prefix}.running_var"].copy_(var)
    return params

"""The one-card contrastive train step, from ``msclip_tpu/train/trainer.py``.

Forward through both towers with BatchNorm in training mode, symmetric
InfoNCE over the batch, backward (the attention core's backward is kernel
K2 on the card), the global gradient norm, optional clipping, the AdamW
step and the schedule step; then the recorded BN running statistics are
written back, ``logit_scale`` is clamped at ln(100), and the EMA shadow is
updated when ``TRAIN.EMA_DECAY > 0``. Parameters stay fp32 and are cast to
the compute dtype at use.

``TPU.ACCUM_STEPS > 1`` (GradCache), the sharded/ring losses and the
multi-card meshes wait for later slices (ROADMAP M6, M7). A spec with
``TPU.USE_FUSED_BLOCK`` is refused: the fused half-block kernels are
inference-only and have no backward.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models import msclip as MM
from ..models.stem import BNState
from ..parallel.infonce import infonce_loss
from .optim import build_optimizer, clip_by_global_norm_, global_norm

# CLIP clamps the temperature at ln(100) to keep training stable
MAX_LOGIT_SCALE = 4.6052


def make_encode_fn(spec: MM.MSClipSpec):
    """``encode(params, images, tokens, generator) -> (fi, ft, bn_updates)``
    with BatchNorm in training mode. ``generator`` drives DropPath in the
    image tower (when ``spec.vision_drop_path > 0``). Raises ValueError for
    a spec with ``use_fused_block``: K5 has no backward (the JAX package's
    ``fused_attention_halfblock`` has no VJP either)."""
    if spec.use_fused_block:
        raise ValueError(
            "TPU.USE_FUSED_BLOCK is for eval only: the fused half-block "
            "kernels (K5, K6) have no backward, so the train step cannot "
            "run with it")

    def encode(params, images, tokens, generator=None):
        bn = BNState(training=True)
        fi = MM.encode_image(
            params, spec, images, bn=bn,
            generator=generator if spec.vision_drop_path > 0.0 else None)
        ft = MM.encode_text(params, spec, tokens)
        return fi, ft, bn.updates

    return encode


def make_loss_fn(spec: MM.MSClipSpec, label_smoothing: float = 0.0):
    """``loss_fn(params, images, tokens, generator) -> (loss,
    bn_updates)``."""
    encode = make_encode_fn(spec)

    def loss_fn(params, images, tokens, generator=None):
        fi, ft, bn_updates = encode(params, images, tokens, generator)
        return infonce_loss(fi, ft, params["logit_scale"],
                            label_smoothing), bn_updates

    return loss_fn


@dataclass
class TrainState:
    """What a step changes: the model's parameters and buffers, the
    optimizer and its schedule, the step count, the EMA shadow (a dict of
    every tensor of ``model.params()``, or None) with its decay, and the
    DropPath generator (or None)."""

    model: MM.MSClipModel
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
    ema: dict | None = None
    ema_decay: float = 0.0
    generator: torch.Generator | None = None


def init_train_state(config, spec: MM.MSClipSpec, params, steps_per_epoch,
                     device) -> TrainState:
    """A trainable model of ``params`` (reference layout, fp32) on
    ``device``, its optimizer and schedule from ``config``, the EMA shadow
    when ``TRAIN.EMA_DECAY > 0``, and a DropPath generator seeded from
    ``TPU.SEED`` when the spec drops paths."""
    model = MM.MSClipModel(spec, params, trainable=True).to(device)
    optimizer, scheduler = build_optimizer(config, model.params(), spec,
                                           steps_per_epoch)
    ema = None
    if config.TRAIN.EMA_DECAY > 0:
        ema = {k: v.detach().clone() for k, v in model.params().items()}
    generator = None
    if spec.vision_drop_path > 0.0:
        generator = torch.Generator(device=device).manual_seed(
            config.TPU.SEED)
    return TrainState(model, optimizer, scheduler, 0, ema,
                      config.TRAIN.EMA_DECAY, generator)


@torch.no_grad()
def apply_bn_updates(params, updates) -> None:
    """Write the running statistics a training forward recorded
    (``{prefix: (mean, var)}``) into the model's buffers."""
    for prefix, (mean, var) in updates.items():
        params[f"{prefix}.running_mean"].copy_(mean)
        params[f"{prefix}.running_var"].copy_(var)


def make_train_step(spec: MM.MSClipSpec, clip_grad_norm: float = 0.0,
                    label_smoothing: float = 0.0):
    """``step(state, images, tokens) -> metrics``: one train step on
    ``state`` in place. ``metrics`` holds the loss, the global norm of the
    gradients before clipping and the clamped ``logit_scale``, as 0-d
    tensors on the step's device (reading them syncs the device)."""
    loss_fn = make_loss_fn(spec, label_smoothing)

    def step(state: TrainState, images, tokens):
        model, optimizer = state.model, state.optimizer
        params = model.params()
        optimizer.zero_grad(set_to_none=True)
        loss, bn_updates = loss_fn(params, images, tokens, state.generator)
        loss.backward()
        trained = list(model.parameters())
        for p in trained:  # optax updates (and decays) unused tensors too
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in trained]
        grad_norm = global_norm(grads)
        if clip_grad_norm > 0:
            clip_by_global_norm_(grads, clip_grad_norm, grad_norm)
        optimizer.step()
        state.scheduler.step()
        with torch.no_grad():
            apply_bn_updates(params, bn_updates)
            params["logit_scale"].clamp_(max=MAX_LOGIT_SCALE)
            if state.ema is not None:
                d = state.ema_decay
                for k, e in state.ema.items():
                    e.mul_(d).add_(params[k], alpha=1 - d)
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm,
                "logit_scale": params["logit_scale"].detach().clone()}

    return step

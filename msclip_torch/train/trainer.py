"""The one-card contrastive train step, from ``msclip_tpu/train/trainer.py``.

Forward through both towers with BatchNorm in training mode (or in eval
mode, ``SWA.FROZEN_BN``), symmetric InfoNCE over the batch, backward (the
attention core's backward is kernel K2 on the card), the global gradient
norm, optional clipping, the AdamW step (with LARC on its update,
``TRAIN.LARC``) and the schedule step; then the recorded BN running
statistics are written back, ``logit_scale`` is clamped at ln(100), and the
EMA shadow is updated when ``TRAIN.EMA_DECAY > 0``. Parameters stay fp32
and are cast to the compute dtype at use.

``TPU.ACCUM_STEPS > 1`` takes the GradCache two-pass gradient
(:func:`gradcache_backward`). DropPath draws from a generator derived from
``(TPU.SEED, step, microbatch)`` (:func:`step_generator`), so GradCache's
second pass and a rematerialised block redraw the first pass's masks, and
a resumed run draws what an uninterrupted one would.

The sharded/ring losses and the multi-card meshes wait for a later slice
(ROADMAP M7). A spec with ``TPU.USE_FUSED_BLOCK`` is refused: the fused
half-block kernels are inference-only and have no backward.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models import msclip as MM
from ..models.stem import BNState
from ..parallel.infonce import infonce_loss
from .averaging import ema_update
from .optim import build_optimizer, clip_by_global_norm_, global_norm, \
    larc_step_

# CLIP clamps the temperature at ln(100) to keep training stable
MAX_LOGIT_SCALE = 4.6052


def step_generator(seed: int, step: int, microbatch: int, device):
    """A ``torch.Generator`` on ``device`` seeded from ``(seed, step,
    microbatch)`` (the port's ``fold_in(fold_in(PRNGKey(seed), step),
    i)``): the same triple gives the same draws."""
    words = np.random.SeedSequence([seed, step, microbatch]).generate_state(
        2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(words[0]) << 31 | int(words[1])) & (2 ** 63 - 1))
    return g


def make_encode_fn(spec: MM.MSClipSpec, freeze_bn: bool = False):
    """``encode(params, images, tokens, generator) -> (fi, ft,
    bn_updates)``. BatchNorm runs in training mode, or with ``freeze_bn``
    (``SWA.FROZEN_BN``) in eval mode on the running statistics, recording
    nothing. ``generator`` drives DropPath in the image tower (when
    ``spec.vision_drop_path > 0``). Raises ValueError for a spec with
    ``use_fused_block``: K5 has no backward (the JAX package's
    ``fused_attention_halfblock`` has no VJP either)."""
    if spec.use_fused_block:
        raise ValueError(
            "TPU.USE_FUSED_BLOCK is for eval only: the fused half-block "
            "kernels (K5, K6) have no backward, so the train step cannot "
            "run with it")

    def encode(params, images, tokens, generator=None):
        bn = BNState(training=not freeze_bn)
        fi = MM.encode_image(
            params, spec, images, bn=bn,
            generator=generator if spec.vision_drop_path > 0.0 else None)
        ft = MM.encode_text(params, spec, tokens)
        return fi, ft, bn.updates

    return encode


def make_loss_fn(spec: MM.MSClipSpec, label_smoothing: float = 0.0,
                 freeze_bn: bool = False):
    """``loss_fn(params, images, tokens, generator) -> (loss,
    bn_updates)``."""
    encode = make_encode_fn(spec, freeze_bn)

    def loss_fn(params, images, tokens, generator=None):
        fi, ft, bn_updates = encode(params, images, tokens, generator)
        return infonce_loss(fi, ft, params["logit_scale"],
                            label_smoothing), bn_updates

    return loss_fn


def gradcache_backward(encode, params, images, tokens, accum_steps: int,
                       label_smoothing: float = 0.0, generator_of=None):
    """GradCache (Gao et al. 2021, arXiv 2101.06983), the JAX package's
    ``_gradcache_value_and_grad`` on one card: InfoNCE couples the whole
    batch, so the gradient is taken in two passes over ``accum_steps``
    contiguous microbatches.

    * pass A, without autograd: each microbatch's embeddings (the peak
      holds one microbatch's activations);
    * the loss over the cached ``[B, E]`` embeddings, and its gradients
      with respect to them and to ``logit_scale``;
    * pass B: each microbatch encoded again with autograd and its cached
      embedding gradient pulled back, the parameter gradients summed into
      ``.grad``.

    ``generator_of(i)`` gives microbatch ``i``'s DropPath generator, the
    same in both passes, so pass B redraws pass A's masks. With training
    BatchNorm each microbatch normalizes with its own statistics and the
    returned running statistics are the mean of the microbatches'
    recorded ones (one momentum update from the mean statistics); pass B
    records nothing. Returns ``(loss, bn_updates)``."""
    a = accum_steps
    B = images.shape[0]
    if B % a:
        raise ValueError(f"batch {B} not divisible by ACCUM_STEPS={a}")
    im = images.reshape(a, B // a, *images.shape[1:])
    tk = tokens.reshape(a, B // a, *tokens.shape[1:])
    gen = generator_of or (lambda i: None)
    with torch.no_grad():
        outs = [encode(params, im[i], tk[i], gen(i)) for i in range(a)]
    fi = torch.cat([o[0] for o in outs]).requires_grad_()
    ft = torch.cat([o[1] for o in outs]).requires_grad_()
    bn_updates = {
        k: tuple(torch.stack([o[2][k][j] for o in outs]).mean(dim=0)
                 for j in range(2))
        for k in outs[0][2]}
    del outs
    scale = params["logit_scale"].detach().requires_grad_()
    loss = infonce_loss(fi, ft, scale, label_smoothing)
    d_fi, d_ft, d_scale = torch.autograd.grad(loss, (fi, ft, scale))
    d_fi, d_ft = d_fi.reshape(a, B // a, -1), d_ft.reshape(a, B // a, -1)
    for i in range(a):
        fi_i, ft_i, _ = encode(params, im[i], tk[i], gen(i))
        torch.autograd.backward((fi_i, ft_i), (d_fi[i], d_ft[i]))
    ls = params["logit_scale"]
    ls.grad = d_scale if ls.grad is None else ls.grad + d_scale
    return loss.detach(), bn_updates


@dataclass
class TrainState:
    """What a step changes: the model's parameters and buffers, the
    optimizer and its schedule, the step count, and the EMA shadow (a dict
    of every tensor of ``model.params()``, or None) with its decay."""

    model: MM.MSClipModel
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
    ema: dict | None = None
    ema_decay: float = 0.0


def init_train_state(config, spec: MM.MSClipSpec, params, steps_per_epoch,
                     device) -> TrainState:
    """A trainable model of ``params`` (reference layout, fp32) on
    ``device``, its optimizer and schedule from ``config``, and the EMA
    shadow when ``TRAIN.EMA_DECAY > 0``."""
    model = MM.MSClipModel(spec, params, trainable=True).to(device)
    optimizer, scheduler = build_optimizer(config, model.params(), spec,
                                           steps_per_epoch)
    ema = None
    if config.TRAIN.EMA_DECAY > 0:
        ema = {k: v.detach().clone() for k, v in model.params().items()}
    return TrainState(model, optimizer, scheduler, 0, ema,
                      config.TRAIN.EMA_DECAY)


@torch.no_grad()
def apply_bn_updates(params, updates) -> None:
    """Write the running statistics a training forward recorded
    (``{prefix: (mean, var)}``) into the model's buffers."""
    for prefix, (mean, var) in updates.items():
        params[f"{prefix}.running_mean"].copy_(mean)
        params[f"{prefix}.running_var"].copy_(var)


def make_train_step(spec: MM.MSClipSpec, clip_grad_norm: float = 0.0,
                    label_smoothing: float = 0.0, *, accum_steps: int = 1,
                    freeze_bn: bool = False, larc: bool = False,
                    seed: int = 0):
    """``step(state, images, tokens) -> metrics``: one train step on
    ``state`` in place (``make_step_core``). ``accum_steps > 1`` takes
    :func:`gradcache_backward`; ``freeze_bn`` runs BatchNorm in eval mode;
    ``larc`` scales AdamW's update (:func:`.optim.larc_step_`); ``seed``
    (``TPU.SEED``) and the step count seed DropPath. ``metrics`` holds the
    loss, the global norm of the gradients before clipping and the
    clamped ``logit_scale``, as 0-d tensors on the step's device (reading
    them syncs the device)."""
    encode = make_encode_fn(spec, freeze_bn)
    dropping = spec.vision_drop_path > 0.0

    def step(state: TrainState, images, tokens):
        model, optimizer = state.model, state.optimizer
        params = model.params()
        optimizer.zero_grad(set_to_none=True)

        def generator_of(i):
            return (step_generator(seed, state.step, i, images.device)
                    if dropping else None)

        if accum_steps > 1:
            loss, bn_updates = gradcache_backward(
                encode, params, images, tokens, accum_steps,
                label_smoothing, generator_of)
        else:
            fi, ft, bn_updates = encode(params, images, tokens,
                                        generator_of(0))
            loss = infonce_loss(fi, ft, params["logit_scale"],
                                label_smoothing)
            loss.backward()
            loss = loss.detach()
        trained = list(model.parameters())
        for p in trained:  # optax updates (and decays) unused tensors too
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in trained]
        grad_norm = global_norm(grads)
        if clip_grad_norm > 0:
            clip_by_global_norm_(grads, clip_grad_norm, grad_norm)
        if larc:
            larc_step_(optimizer)
        else:
            optimizer.step()
        state.scheduler.step()
        with torch.no_grad():
            apply_bn_updates(params, bn_updates)
            params["logit_scale"].clamp_(max=MAX_LOGIT_SCALE)
            if state.ema is not None:
                ema_update(state.ema, params, state.ema_decay)
        state.step += 1
        return {"loss": loss, "grad_norm": grad_norm,
                "logit_scale": params["logit_scale"].detach().clone()}

    return step


def make_train_step_from_config(config, spec: MM.MSClipSpec,
                                freeze_bn: bool = False):
    """:func:`make_train_step` with the config's clipping, label
    smoothing, ``TPU.ACCUM_STEPS``, ``TRAIN.LARC`` and ``TPU.SEED``."""
    return make_train_step(
        spec, clip_grad_norm=config.TRAIN.CLIP_GRAD_NORM,
        label_smoothing=config.LOSS.LABEL_SMOOTHING,
        accum_steps=int(config.TPU.get("ACCUM_STEPS", 1)),
        freeze_bn=freeze_bn, larc=bool(config.TRAIN.get("LARC", False)),
        seed=int(config.TPU.SEED))

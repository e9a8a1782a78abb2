"""Optimizer and LR schedule, from ``msclip_tpu/train/optim.py``.

AdamW with a no-weight-decay list (``TRAIN.WITHOUT_WD_LIST``), a separate
LR/WD for the trunk tensors that both towers share (``CUSTOM.LR_SHARE`` /
``CUSTOM.WD_SHARE``), the timm warmup-cosine schedule with optax
``join_schedules`` semantics step for step, and clipping by the global
gradient norm as optax ``clip_by_global_norm`` does it.

Parameters are named by their reference keys. BatchNorm running statistics
are buffers, never optimized (the JAX package's ``'state'`` label). LARC,
the SWA anneal and the Gumbel architecture group wait for later slices
(ROADMAP M6, M10); the model spec rejects their switches.
"""

from __future__ import annotations

import math

import torch

from ..models.msclip import MSClipSpec, is_bn_stat

NO_WD_NAMES = {
    # reference CLIP.no_weight_decay() (clip_openai_pe_res_v1.py:2950-2956)
    "positional_embedding",
    "class_embedding",
    "token_embedding",
    "logit_scale",
}


def _is_shared_param(key: str, spec: MSClipSpec) -> bool:
    """A visual-trunk tensor that a text block also reads (the aliased set
    of the reference; it gets LR_SHARE / WD_SHARE). Text block ``j`` reads
    visual resblock ``j - minus1`` (``msclip.resolve_text_block``)."""
    prefix = "visual.transformer.resblocks."
    if not spec.share_modules or not key.startswith(prefix):
        return False
    index, local = key[len(prefix):].split(".", 1)
    minus1 = 1 if spec.visual_layer_minus1 else 0
    return (spec.text_layer_is_shared(int(index) + minus1)
            and local in spec.shared_block_keys())


def param_labels(params, spec: MSClipSpec):
    """``{key: 'regular' | 'shared'}`` for every trained tensor of the
    reference-layout dict; BN running statistics get no label."""
    return {k: "shared" if _is_shared_param(k, spec) else "regular"
            for k in params if not is_bn_stat(k)}


def _without_wd(key: str, bn_modules, without_wd_list) -> bool:
    """The JAX package's rule on reference names: ``'bias'`` matches every
    bias, ``'bn'`` every BatchNorm affine (``downsample.1`` carries no
    ``bn`` in its name), any other token a substring of a name part, and
    the reference's ``no_weight_decay`` names match a whole part."""
    parts = key.split(".")
    for token in without_wd_list:
        if token == "bias":
            if parts[-1].endswith("bias"):
                return True
        elif token == "bn" and key.rsplit(".", 1)[0] in bn_modules:
            return True
        elif any(token in p for p in parts):
            return True
    return any(p in NO_WD_NAMES for p in parts)


def wd_mask(params, without_wd_list):
    """``{key: bool}``: True where weight decay applies, for every trained
    tensor of the reference-layout dict."""
    bn_modules = {k.rsplit(".", 1)[0] for k in params
                  if k.endswith(".running_mean")}
    return {k: not _without_wd(k, bn_modules, without_wd_list)
            for k in params if not is_bn_stat(k)}


def timm_cosine_schedule(base_lr: float, steps_per_epoch: int, epochs: int,
                         warmup_epochs: int = 5, warmup_lr: float = 1e-6,
                         min_lr: float = 1e-5, cooldown_epochs: int = 0):
    """timm 'cosine' semantics, as optax ``join_schedules`` of a linear
    warmup from ``warmup_lr``, a cosine decay to ``min_lr`` and a constant
    ``min_lr`` for the cooldown. Returns ``step -> lr``, step counted from
    0."""
    warmup_steps = warmup_epochs * steps_per_epoch
    ramp = max(warmup_steps, 1)
    decay_steps = max((epochs - warmup_epochs - cooldown_epochs)
                      * steps_per_epoch, 1)
    alpha = min_lr / max(base_lr, 1e-12)

    def sched(step: int) -> float:
        if step < warmup_steps:
            frac = 1 - min(max(step, 0), ramp) / ramp
            return (warmup_lr - base_lr) * frac + base_lr
        if step < warmup_steps + decay_steps:
            t = min(step - warmup_steps, decay_steps)
            cosine = 0.5 * (1 + math.cos(math.pi * t / decay_steps))
            return base_lr * ((1 - alpha) * cosine + alpha)
        return min_lr

    return sched


def build_schedule(config, steps_per_epoch: int):
    sched_cfg = config.TRAIN.LR_SCHEDULER
    method = sched_cfg.get("METHOD", "timm")
    if method == "timm":
        args = sched_cfg.get("ARGS", {})
        return timm_cosine_schedule(
            base_lr=config.TRAIN.LR,
            steps_per_epoch=steps_per_epoch,
            epochs=config.TRAIN.END_EPOCH,
            warmup_epochs=args.get("warmup_epochs", 5),
            warmup_lr=args.get("warmup_lr", 1e-6),
            min_lr=args.get("min_lr", 1e-5),
            cooldown_epochs=args.get("cooldown_epochs", 0),
        )
    if method == "constant":
        lr = config.TRAIN.LR
        return lambda step: lr
    raise ValueError(f"Unknown LR scheduler: {method}")


def build_optimizer(config, params, spec: MSClipSpec, steps_per_epoch: int):
    """``(torch.optim.AdamW, LambdaLR)`` over the trained tensors of
    ``params`` (``MSClipModel.params()``: reference key -> tensor; the BN
    running statistics among them tell the weight-decay rule which modules
    are BatchNorms, and are not optimized), in four groups: regular and
    shared, each with and without weight decay. The scheduler sets each
    group's LR to its schedule's value at the step about to run (group LRs
    start at 1 and the lambdas return the LR itself)."""
    without_wd = list(config.TRAIN.WITHOUT_WD_LIST)
    labels = param_labels(params, spec)
    mask = wd_mask(params, without_wd)
    base_sched = build_schedule(config, steps_per_epoch)
    lr_share = config.CUSTOM.get("LR_SHARE", 0.0) or config.TRAIN.LR
    share_scale = lr_share / max(config.TRAIN.LR, 1e-12)
    wd_share = config.CUSTOM.get("WD_SHARE", 0.0) or config.TRAIN.WD
    groups, lambdas = [], []
    for label, wd, sched in (
            ("regular", config.TRAIN.WD, base_sched),
            ("shared", wd_share, lambda t: base_sched(t) * share_scale)):
        for decay in (True, False):
            members = [params[k] for k in labels
                       if labels[k] == label and mask[k] == decay]
            if members:
                groups.append({"params": members, "lr": 1.0,
                               "weight_decay": wd if decay else 0.0,
                               "name": f"{label}{'' if decay else '_no_wd'}"})
                lambdas.append(sched)
    optimizer = torch.optim.AdamW(groups, lr=1.0, betas=(0.9, 0.999),
                                  eps=1e-8)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambdas)
    return optimizer, scheduler


def global_norm(tensors) -> torch.Tensor:
    """optax ``global_norm``: the fp32 L2 norm over every element."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


def clip_by_global_norm_(grads, max_norm: float, norm: torch.Tensor) -> None:
    """optax ``clip_by_global_norm`` in place: ``g / norm * max_norm`` when
    ``norm >= max_norm``, else unchanged (``clip_grad_norm_``'s
    ``+1e-6`` is not there). No host sync."""
    coef = torch.where(norm < max_norm, torch.ones_like(norm),
                       max_norm / norm)
    for g in grads:
        g.mul_(coef)

"""Optimizer and LR schedule, from ``msclip_tpu/train/optim.py``.

AdamW with a no-weight-decay list (``TRAIN.WITHOUT_WD_LIST``), a separate
LR/WD for the trunk tensors that both towers share (``CUSTOM.LR_SHARE`` /
``CUSTOM.WD_SHARE``), the timm warmup-cosine schedule with optax
``join_schedules`` semantics step for step, the SWA anneal
(``SWA.*``) wrapped around each group's schedule, clipping by the global
gradient norm as optax ``clip_by_global_norm`` does it, and LARC
(``TRAIN.LARC``) on AdamW's update, chained as the JAX package chains
them: clip -> AdamW -> LARC.

Parameters are named by their reference keys. BatchNorm running statistics
are buffers, never optimized (the JAX package's ``'state'`` label). The
Gumbel architecture group waits for a later slice (ROADMAP M10); the model
spec rejects its switch.
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


def swa_anneal_wrap(base_sched, config, steps_per_epoch: int):
    """``SWA.LR_RATIO`` / ``ANNEAL_EPOCHS`` / ``ANNEAL_STRATEGY`` with
    torch ``SWALR`` semantics: from ``SWA.BEGIN_EPOCH`` on, anneal from
    the base schedule's value at that step (frozen there) to ``swa_lr =
    TRAIN.LR * LR_RATIO`` over ``ANNEAL_EPOCHS`` ('cos' or 'linear'), then
    hold. Wraps each group's composed schedule, so every group (the shared
    one too) anneals to the same ``swa_lr``."""
    if not (config.SWA.ENABLED and config.SWA.BEGIN_EPOCH >= 0):
        return base_sched
    begin = config.SWA.BEGIN_EPOCH * steps_per_epoch
    anneal = max(config.SWA.ANNEAL_EPOCHS * steps_per_epoch, 1)
    strategy = config.SWA.ANNEAL_STRATEGY
    if strategy not in ("cos", "linear"):
        raise ValueError(f"Unknown SWA.ANNEAL_STRATEGY: {strategy}")
    swa_lr = config.TRAIN.LR * config.SWA.LR_RATIO
    lr0 = base_sched(begin)

    def sched(step: int) -> float:
        if step < begin:
            return base_sched(step)
        t = min(max((step - begin) / anneal, 0.0), 1.0)
        alpha = (1.0 - math.cos(math.pi * t)) / 2.0 if strategy == "cos" \
            else t
        return (1.0 - alpha) * lr0 + alpha * swa_lr

    return sched


def build_optimizer(config, params, spec: MSClipSpec, steps_per_epoch: int):
    """``(torch.optim.AdamW, LambdaLR)`` over the trained tensors of
    ``params`` (``MSClipModel.params()``: reference key -> tensor; the BN
    running statistics among them tell the weight-decay rule which modules
    are BatchNorms, and are not optimized), in four groups: regular and
    shared, each with and without weight decay. The scheduler sets each
    group's LR to its schedule's value at the step about to run (group LRs
    start at 1 and the lambdas return the LR itself; the SWA anneal, when
    configured, wraps each group's schedule)."""
    without_wd = list(config.TRAIN.WITHOUT_WD_LIST)
    labels = param_labels(params, spec)
    mask = wd_mask(params, without_wd)
    base_sched = build_schedule(config, steps_per_epoch)
    lr_share = config.CUSTOM.get("LR_SHARE", 0.0) or config.TRAIN.LR
    share_scale = lr_share / max(config.TRAIN.LR, 1e-12)
    wd_share = config.CUSTOM.get("WD_SHARE", 0.0) or config.TRAIN.WD
    groups, lambdas = [], []
    for label, wd, sched in (
            ("regular", config.TRAIN.WD,
             swa_anneal_wrap(base_sched, config, steps_per_epoch)),
            ("shared", wd_share,
             swa_anneal_wrap(lambda t: base_sched(t) * share_scale, config,
                             steps_per_epoch))):
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


@torch.no_grad()
def larc_step_(optimizer, trust_coefficient: float = 0.02,
               eps: float = 1e-8) -> None:
    """``optimizer.step()`` with LARC on its update (``TRAIN.LARC``,
    optax's ``larc`` chained after AdamW): each tensor's whole update
    ``u`` (AdamW's step and weight decay) is scaled by ``min(trust ||p|| /
    (||u|| + eps), 1)``, with ``||p||`` taken before the update and the
    ratio 1 where ``||p|| = 0``. torch's AdamW updates in place, so ``u``
    is read back as ``p_after - p_before`` (exact where the two lie
    within a factor of 2 of each other, as a step's do)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    before = [p.detach().clone() for p in params]
    optimizer.step()
    update = torch._foreach_sub([p.detach() for p in params], before)
    p_norm = torch.stack(torch._foreach_norm(
        [b.float() for b in before]))
    u_norm = torch.stack(torch._foreach_norm([u.float() for u in update]))
    ratio = trust_coefficient * p_norm / (u_norm + eps)
    ratio = torch.where(p_norm > 0, ratio, torch.ones_like(ratio))
    ratio = torch.minimum(ratio, torch.ones_like(ratio))
    for p, b, u, r in zip(params, before, update, ratio.unbind()):
        p.copy_(b + u * r.to(u.dtype))

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
Gumbel logits (``GUMBEL_SELECT``) are a group of their own, ``arch``, at
``CUSTOM.GUMBEL_LR`` without weight decay (:func:`build_optimizer`).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..models.msclip import MSClipSpec, is_bn_stat
from ..parallel.collectives import (
    gather_rows,
    group_rank,
    group_size,
    reduce_scatter_rows,
)
from ..parallel.mesh import tp_gather, tp_split

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
    """``{key: 'regular' | 'shared' | 'arch'}`` for every trained tensor of
    the reference-layout dict (``arch``: the Gumbel logits, the NAS
    architecture parameter); BN running statistics get no label."""
    return {k: "arch" if k == "gumbel_logit"
            else "shared" if _is_shared_param(k, spec) else "regular"
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
    shared, each with and without weight decay; and the Gumbel logits
    (``GUMBEL_SELECT``) at the constant ``CUSTOM.GUMBEL_LR`` without weight
    decay (the JAX package's ``arch`` group, ``optax.adamw``). The
    scheduler sets each group's LR to its schedule's value at the step
    about to run (group LRs start at 1 and the lambdas return the LR
    itself; the SWA anneal, when configured, wraps each group's schedule
    but the ``arch`` group's)."""
    without_wd = list(config.TRAIN.WITHOUT_WD_LIST)
    labels = param_labels(params, spec)
    mask = wd_mask(params, without_wd)
    base_sched = build_schedule(config, steps_per_epoch)
    lr_share = config.CUSTOM.get("LR_SHARE", 0.0) or config.TRAIN.LR
    share_scale = lr_share / max(config.TRAIN.LR, 1e-12)
    wd_share = config.CUSTOM.get("WD_SHARE", 0.0) or config.TRAIN.WD
    gumbel_lr = config.CUSTOM.get("GUMBEL_LR", 0.0) or config.TRAIN.LR
    groups, lambdas = [], []
    for label, wd, sched in (
            ("regular", config.TRAIN.WD,
             swa_anneal_wrap(base_sched, config, steps_per_epoch)),
            ("shared", wd_share,
             swa_anneal_wrap(lambda t: base_sched(t) * share_scale, config,
                             steps_per_epoch)),
            ("arch", 0.0, lambda t: gumbel_lr)):
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


def global_norm(tensors, reduce_norms=None) -> torch.Tensor:
    """optax ``global_norm``: the fp32 L2 norm over every element.
    ``reduce_norms(norms)``: the whole tensors' norms from the local
    tensors' ones where ``tensors`` are splits
    (:meth:`DataShards.reduce_norms`)."""
    norms = torch.stack([torch.linalg.vector_norm(t.float())
                         for t in tensors])
    if reduce_norms is not None:
        norms = reduce_norms(norms)
    return torch.linalg.vector_norm(norms)


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
               eps: float = 1e-8, reduce_norms=None) -> None:
    """``optimizer.step()`` with LARC on its update (``TRAIN.LARC``,
    optax's ``larc`` chained after AdamW): each tensor's whole update
    ``u`` (AdamW's step and weight decay) is scaled by ``min(trust ||p|| /
    (||u|| + eps), 1)``, with ``||p||`` taken before the update and the
    ratio 1 where ``||p|| = 0``. torch's AdamW updates in place, so ``u``
    is read back as ``p_after - p_before`` (exact where the two lie
    within a factor of 2 of each other, as a step's do).
    ``reduce_norms(norms)``: the whole tensors' norms from the local ones
    in the optimizer's order, where the optimizer holds splits of tensors
    (:meth:`DataShards.reduce_norms`)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    before = [p.detach().clone() for p in params]
    optimizer.step()
    update = torch._foreach_sub([p.detach() for p in params], before)
    p_norm = torch.stack(torch._foreach_norm(
        [b.float() for b in before]))
    u_norm = torch.stack(torch._foreach_norm([u.float() for u in update]))
    if reduce_norms is not None:
        p_norm, u_norm = reduce_norms(p_norm), reduce_norms(u_norm)
    ratio = trust_coefficient * p_norm / (u_norm + eps)
    ratio = torch.where(p_norm > 0, ratio, torch.ones_like(ratio))
    ratio = torch.minimum(ratio, torch.ones_like(ratio))
    for p, b, u, r in zip(params, before, update, ratio.unbind()):
        p.copy_(b + u * r.to(u.dtype))


def _split(t, dim: int, n: int, rank: int):
    """This rank's split of ``t`` along ``dim``, in storage of its own."""
    return t.chunk(n, dim=dim)[rank].clone(
        memory_format=torch.contiguous_format)


def _gather_dim(t, dim: int, group):
    """Every rank's split ``t`` concatenated along ``dim``."""
    moved = gather_rows(t.movedim(dim, 0), group)
    return moved.movedim(0, dim).contiguous()


def _reduce_scatter_mean(t, dim: int, group):
    """The mean of ``t`` over the group, this rank's split along ``dim``."""
    out = reduce_scatter_rows(t.movedim(dim, 0), group)
    return (out / group_size(group)).movedim(0, dim).contiguous()


BUCKET_ELEMENTS = 2 ** 25  # 128 MiB of fp32 a flat all-reduce


def all_reduce_mean_(tensors, group) -> None:
    """Average ``tensors`` over the group in place, in flat buckets of up
    to :data:`BUCKET_ELEMENTS` elements (one all-reduce a bucket)."""
    bucket, size = [], 0
    for t in list(tensors) + [None]:
        if t is not None and (not bucket or size + t.numel()
                              <= BUCKET_ELEMENTS):
            bucket.append(t)
            size += t.numel()
            continue
        if bucket:
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat, group=group)
            flat /= group_size(group)
            for b, v in zip(bucket, flat.split([b.numel() for b in bucket])):
                b.copy_(v.view_as(b))
        bucket, size = ([t], t.numel()) if t is not None else ([], 0)


class DataShards:
    """The trained tensors of a data-parallel step and how they meet the
    data ``group`` (None: one process, no collective).

    ``dims``: ``{name: dim or None}``. A tensor with a dim is split over
    the group along it (``parallel/mesh.py``'s rules): the optimizer holds
    this rank's split, a tensor of its own, so AdamW's moments exist only
    for it (ZeRO-1, ``TPU.ZERO1``); with ``fsdp`` (``TPU.FSDP``) the whole
    tensor is also dropped between steps and gathered again before the
    next forward (:meth:`materialize`). Every other tensor is whole on
    every rank and is its own optimizer tensor. With no dims at all this
    is plain data parallelism.

    After the backward, :meth:`reduce_grads` averages the gradients over
    the group: reduce-scattered into the splits, all-reduced (flat
    buckets) for the whole tensors. After the update, :meth:`gather`
    rebuilds the whole tensors from the splits.

    Under tensor parallelism the tensors are this process's parts
    (``parallel/mesh.split_for_model``; ``tp_keys`` names the cut ones),
    and ``model_group`` completes their norms and makes their optimizer
    state whole for a checkpoint."""

    def __init__(self, named_params, dims=None, group=None,
                 fsdp: bool = False, model_group=None, tp_keys=()):
        self.group, self.fsdp = group, fsdp
        self.model_group, self.tp_keys = model_group, frozenset(tp_keys)
        self.n, self.rank = group_size(group), group_rank(group)
        self.full = dict(named_params)
        self.dims = {k: d for k, d in (dims or {}).items()
                     if d is not None and k in self.full}
        self.shards = {k: torch.nn.Parameter(
            _split(self.full[k].detach(), d, self.n, self.rank))
            for k, d in self.dims.items()}
        self.released = False

    def opt_params(self):
        """``{name: tensor}`` the optimizer updates, in the model's order."""
        return {k: self.shards.get(k, p) for k, p in self.full.items()}

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """Each optimizer tensor's ``.grad`` becomes the group's mean
        gradient (a missing gradient counts as zeros); the whole
        tensors' gradients of the split ones are dropped."""
        for p in self.full.values():
            if p.grad is None:  # optax updates (and decays) unused tensors
                p.grad = torch.zeros_like(p)
        for k, d in self.dims.items():
            p = self.full[k]
            g = p.grad
            self.shards[k].grad = (_reduce_scatter_mean(g, d, self.group)
                                   if self.group is not None
                                   else _split(g, d, 1, 0))
            p.grad = None
        if self.group is not None:
            all_reduce_mean_([p.grad for k, p in self.full.items()
                              if k not in self.dims], self.group)

    def whole_grads(self):
        """``{name: gradient}`` with the split and the tensor-parallel ones
        gathered whole (collectives), after :meth:`reduce_grads`."""
        grads = {k: _gather_dim(g, self.dims[k], self.group)
                 if k in self.dims and self.group is not None else g
                 for k, g in self.grads().items()}
        return self._gather_model(grads)

    def _gather_model(self, tree):
        """``{name: tensor}`` with the tensor-parallel parts made whole."""
        return {k: tp_gather(k, v, self.model_group)
                if k in self.tp_keys else v for k, v in tree.items()}

    def grads(self):
        """``{name: gradient}`` of the optimizer tensors, in the model's
        order."""
        return {k: p.grad for k, p in self.opt_params().items()}

    def reduce_norms(self, norms, names=None):
        """The whole tensors' norms from this rank's ``norms`` of the
        tensors ``names`` (the model's order by default): the norm over
        the data group of each split tensor's local norms, then over the
        model group of each tensor-parallel one's."""
        names = list(self.full) if names is None else names
        for group, cut in ((self.group, self.dims),
                           (self.model_group, self.tp_keys)):
            split = [i for i, k in enumerate(names) if k in cut]
            if not split or group is None:
                continue
            local = norms[split].contiguous()
            every = gather_rows(local[None], group)  # [n, splits]
            norms = norms.clone()
            norms[split] = torch.linalg.vector_norm(every, dim=0)
        return norms

    def opt_names(self, optimizer):
        """The tensor names in ``optimizer``'s parameter order."""
        names = {id(p): k for k, p in self.opt_params().items()}
        return [names[id(p)] for g in optimizer.param_groups
                for p in g["params"]]

    @torch.no_grad()
    def gather(self) -> None:
        """Rebuild every split tensor whole from the ranks' splits."""
        for k, d in self.dims.items():
            s = self.shards[k].detach()
            self.full[k].data = (_gather_dim(s, d, self.group)
                                 if self.group is not None else s.clone())
        self.released = False

    def updated(self, keep_whole: bool = False) -> None:
        """After the optimizer step: rebuild the whole tensors from the
        updated splits, or under FSDP drop them unless ``keep_whole`` (the
        next step gathers them before its forward)."""
        if self.fsdp and not keep_whole:
            self.release()
        else:
            self.gather()

    def release(self) -> None:
        """FSDP: drop the whole copies of the split tensors."""
        if self.fsdp:
            for k in self.dims:
                self.full[k].data = self.full[k].data.new_empty(0)
            self.released = True

    def materialize(self) -> None:
        """Make every tensor whole again if :meth:`release` dropped them."""
        if self.released:
            self.gather()

    @torch.no_grad()
    def resplit(self) -> None:
        """Copy each whole tensor's split into the optimizer's (after a
        restore wrote the whole tensors)."""
        for k, d in self.dims.items():
            self.shards[k].copy_(_split(self.full[k].detach(), d, self.n,
                                        self.rank))

    def full_optimizer_state(self, optimizer):
        """``{name: {"step", "exp_avg", ...}}`` with every split moment
        gathered whole (a collective: every rank calls it)."""
        names = {id(p): k for k, p in self.opt_params().items()}
        out = {}
        for p, st in optimizer.state.items():
            k = names[id(p)]
            d = self.dims.get(k)
            out[k] = {}
            for n, v in st.items():
                if isinstance(v, torch.Tensor) and v.ndim > 0:
                    if d is not None and self.group is not None:
                        v = _gather_dim(v, d, self.group)
                    if k in self.tp_keys:
                        v = tp_gather(k, v, self.model_group)
                out[k][n] = v
        return out

    def split_optimizer_state(self, state):
        """A whole-tensor optimizer state (:meth:`full_optimizer_state`'s
        form) cut to this rank's splits."""
        m, r = group_size(self.model_group), group_rank(self.model_group)
        out = {}
        for k, st in state.items():
            d = self.dims.get(k)
            out[k] = {}
            for n, v in st.items():
                if isinstance(v, torch.Tensor) and v.ndim > 0:
                    if k in self.tp_keys:
                        v = tp_split(k, v, m, r)
                    if d is not None:
                        v = _split(v, d, self.n, self.rank)
                out[k][n] = v
        return out

    def stored_bytes(self, optimizer):
        """``{"params", "optimizer"}``: the bytes this rank keeps between
        steps for the trained tensors and for the optimizer's state."""
        params = sum(p.numel() * p.element_size()
                     for p in self.opt_params().values())
        if not self.fsdp:
            params += sum(self.full[k].numel() * self.full[k].element_size()
                          for k in self.dims)
        opt = sum(v.numel() * v.element_size()
                  for st in optimizer.state.values() for v in st.values()
                  if isinstance(v, torch.Tensor))
        return {"params": params, "optimizer": opt}

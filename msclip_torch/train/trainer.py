"""The contrastive train step, from ``msclip_tpu/train/trainer.py``.

Forward through both towers with BatchNorm in training mode (or in eval
mode, ``SWA.FROZEN_BN``), symmetric InfoNCE over the global batch,
backward (the attention core's backward is kernel K2 on the card), the
gradients averaged over the data group, the global gradient norm,
optional clipping, the AdamW step (with LARC on its update,
``TRAIN.LARC``) and the schedule step; then the recorded BN running
statistics are written back, ``logit_scale`` is clamped at ln(100), and the
EMA shadow is updated when ``TRAIN.EMA_DECAY > 0``. Parameters stay fp32
and are cast to the compute dtype at use.

Several processes (``parallel/mesh.py``; one a device, started by
``torchrun``) compute what one process computes on the concatenated
batch, as the JAX step does under ``jit`` on a data-sharded mesh: the
BatchNorm statistics are the global batch's (``layers.batch_norm``
all-reduces them over the data group), the loss is the global one (the
gathered ``[B, B]`` matrix, or with ``TPU.SHARDED_LOSS`` the chunked or,
with ``TPU.RING_LOSS``, the ring loss of ``parallel/infonce.py``), and
the parameter gradients are averaged over the data group by explicit
collectives over the parameter dict (``optim.DataShards``: one flat
all-reduce a bucket; reduce-scatter and all-gather under ``TPU.ZERO1``
and ``TPU.FSDP``). ``DistributedDataParallel``'s hooks are not used: the
step runs GradCache's two passes and REMAT's recomputation by hand, and
every collective is in sight here. With ``TPU.MESH_MODEL > 1`` each
process of a model group holds its part of every transformer block
(Megatron's column and row splits, ``parallel/mesh.split_for_model``) and
the blocks sum their partial outputs over the group
(``layers.attention``, ``layers.mlp``; the zoo's plug-in and Perceiver
blocks too, ``models/extensions.py``, ``models/crossattn.py``).

``TPU.ACCUM_STEPS > 1`` takes the GradCache two-pass gradient
(:func:`gradcache_backward`). DropPath draws from a generator derived from
``(TPU.SEED, step, microbatch)`` (:func:`step_generator`), the global
batch's masks on every process, each process taking its rows; so
GradCache's second pass and a rematerialised block redraw the first
pass's masks, a resumed run draws what an uninterrupted one would, and
several processes draw what one process draws. A spec with
``TPU.USE_FUSED_BLOCK`` is refused: the fused half-block kernels are
inference-only and have no backward.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..models import msclip as MM
from ..models.extensions import gumbel_action
from ..models.stem import BNState
from ..parallel.collectives import group_rank, group_size
from ..parallel.infonce import (
    chunked_sharded_infonce_loss,
    gathered_infonce_loss,
    ring_infonce_loss,
)
from ..parallel.mesh import (
    Mesh,
    fsdp_dims,
    gather_over_model,
    param_dim,
    split_for_model,
    zero1_dims,
)
from ..utils.summary import span
from .averaging import ema_update
from .optim import DataShards, build_optimizer, clip_by_global_norm_, \
    global_norm, larc_step_

# CLIP clamps the temperature at ln(100) to keep training stable
MAX_LOGIT_SCALE = 4.6052


# the stream of the Gumbel action's draws (step_generator's ``stream``)
GUMBEL_STREAM = 1


def step_generator(seed: int, step: int, microbatch: int, device,
                   stream: int | None = None):
    """A ``torch.Generator`` on ``device`` seeded from ``(seed, step,
    microbatch)`` (the port's ``fold_in(fold_in(PRNGKey(seed), step),
    i)``): the same triple gives the same draws. ``stream`` names another
    sequence of draws of the same step (the Gumbel action's,
    :data:`GUMBEL_STREAM`)."""
    entropy = [seed, step, microbatch] + ([] if stream is None else [stream])
    words = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(words[0]) << 31 | int(words[1])) & (2 ** 63 - 1))
    return g


def make_encode_fn(spec: MM.MSClipSpec, freeze_bn: bool = False,
                   group=None, tp=None):
    """``encode(params, images, tokens, generator, rows) -> (fi, ft,
    bn_updates)``, with the blocks split over the model group ``tp``
    under tensor parallelism. BatchNorm runs in training mode, its
    statistics over the data ``group``'s global batch, or with
    ``freeze_bn`` (``SWA.FROZEN_BN``) in eval mode on the running
    statistics, recording nothing. ``generator`` drives DropPath in the
    image tower (when ``spec.vision_drop_path > 0``), ``rows=(first,
    total)`` places the images in the global batch whose masks it draws.
    With ``GUMBEL_SELECT`` the action (``extensions.gumbel_action``) is
    drawn from ``action_generator()``, a fresh generator of the step's
    seed each call (so GradCache's passes and every microbatch take one
    action), or is the deterministic argmax without it. Raises ValueError
    for a spec with ``use_fused_block``: K5 has no backward (the JAX
    package's ``fused_attention_halfblock`` has no VJP either)."""
    if spec.use_fused_block:
        raise ValueError(
            "TPU.USE_FUSED_BLOCK is for eval only: the fused half-block "
            "kernels (K5, K6) have no backward, so the train step cannot "
            "run with it")

    def encode(params, images, tokens, generator=None, rows=None,
               action_generator=None):
        bn = BNState(training=not freeze_bn, group=group)
        action = None
        if spec.ext.gumbel_select:  # drawn anew a call: a graph each
            action = gumbel_action(
                params["gumbel_logit"],
                None if action_generator is None else action_generator())
        fi = MM.encode_image(
            params, spec, images, bn=bn,
            generator=generator if spec.vision_drop_path > 0.0 else None,
            rows=rows, tp=tp, action=action)
        ft = MM.encode_text(params, spec, tokens, tp=tp, action=action)
        return fi, ft, bn.updates

    return encode


def make_embedding_loss(group=None, sharded_loss: bool = False,
                        loss_chunk: int = 4096, label_smoothing: float = 0.0,
                        ring_loss: bool = False):
    """``emb_loss(fi, ft, logit_scale) -> loss`` over the data ``group``'s
    global batch (``msclip_tpu/train/trainer.py:104-134``): the gathered
    full matrix; with ``sharded_loss`` (``TPU.SHARDED_LOSS``) the chunked
    loss at ``loss_chunk`` columns, or with ``ring_loss``
    (``TPU.RING_LOSS``) the ring loss. The boundary GradCache caches at."""
    if not sharded_loss:
        return functools.partial(gathered_infonce_loss, group=group,
                                 label_smoothing=label_smoothing)
    if ring_loss:
        return functools.partial(ring_infonce_loss, group=group,
                                 label_smoothing=label_smoothing)
    return functools.partial(chunked_sharded_infonce_loss, group=group,
                             chunk=loss_chunk,
                             label_smoothing=label_smoothing)


def make_loss_fn(spec: MM.MSClipSpec, label_smoothing: float = 0.0,
                 freeze_bn: bool = False, group=None, **loss_kw):
    """``loss_fn(params, images, tokens, generator, rows) -> (loss,
    bn_updates)``; ``loss_kw`` picks the loss
    (:func:`make_embedding_loss`)."""
    encode = make_encode_fn(spec, freeze_bn, group)
    emb_loss = make_embedding_loss(group, label_smoothing=label_smoothing,
                                   **loss_kw)

    def loss_fn(params, images, tokens, generator=None, rows=None):
        fi, ft, bn_updates = encode(params, images, tokens, generator, rows)
        return emb_loss(fi, ft, params["logit_scale"]), bn_updates

    return loss_fn


def gradcache_backward(encode, params, images, tokens, accum_steps: int,
                       label_smoothing: float = 0.0, generator_of=None,
                       emb_loss=None, rows_of=None):
    """GradCache (Gao et al. 2021, arXiv 2101.06983), the JAX package's
    ``_gradcache_value_and_grad``: InfoNCE couples the whole batch, so the
    gradient is taken in two passes over ``accum_steps`` microbatches.

    * pass A, without autograd: each microbatch's embeddings (the peak
      holds one microbatch's activations);
    * the loss (``emb_loss``, by default the one-process InfoNCE) over the
      cached embeddings, and its gradients with respect to them and to
      ``logit_scale``;
    * pass B: each microbatch encoded again with autograd and its cached
      embedding gradient pulled back, the parameter gradients summed into
      ``.grad``.

    Microbatch ``i`` is the ``i``-th contiguous block of this process's
    rows; over several processes it is every process's ``i``-th block
    (JAX's interleaved ``to_micro`` on a data-sharded batch), whose
    BatchNorm statistics ``encode`` takes over the group, and the cached
    embeddings keep the global batch's order for the loss.
    ``generator_of(i)`` gives microbatch ``i``'s DropPath generator and
    ``rows_of(i)`` its rows in the global microbatch, the same in both
    passes, so pass B redraws pass A's masks. With training BatchNorm
    each microbatch normalizes with its own statistics and the returned
    running statistics are the mean of the microbatches' recorded ones
    (one momentum update from the mean statistics); pass B records
    nothing. Returns ``(loss, bn_updates)``."""
    loss, bn_updates, pull_back = gradcache_forward(
        encode, params, images, tokens, accum_steps, label_smoothing,
        generator_of, emb_loss, rows_of)
    pull_back()
    return loss, bn_updates


def gradcache_forward(encode, params, images, tokens, accum_steps: int,
                      label_smoothing: float = 0.0, generator_of=None,
                      emb_loss=None, rows_of=None):
    """The first half of :func:`gradcache_backward` (same arguments): pass
    A and the loss. Returns ``(loss, bn_updates, pull_back)``, where
    ``pull_back()`` runs the rest: the loss's gradients with respect to
    the cached embeddings and ``logit_scale``, and pass B."""
    a = accum_steps
    B = images.shape[0]
    if B % a:
        raise ValueError(f"batch {B} not divisible by ACCUM_STEPS={a}")
    im = images.reshape(a, B // a, *images.shape[1:])
    tk = tokens.reshape(a, B // a, *tokens.shape[1:])
    gen = generator_of or (lambda i: None)
    emb_loss = emb_loss or functools.partial(
        gathered_infonce_loss, label_smoothing=label_smoothing)

    def enc(i):
        if rows_of is None:
            return encode(params, im[i], tk[i], gen(i))
        return encode(params, im[i], tk[i], gen(i), rows_of(i))

    with torch.no_grad():
        outs = [enc(i) for i in range(a)]
    fi = torch.cat([o[0] for o in outs]).requires_grad_()
    ft = torch.cat([o[1] for o in outs]).requires_grad_()
    bn_updates = {
        k: tuple(torch.stack([o[2][k][j] for o in outs]).mean(dim=0)
                 for j in range(2))
        for k in outs[0][2]}
    del outs
    scale = params["logit_scale"].detach().requires_grad_()
    loss = emb_loss(fi, ft, scale)

    def pull_back():
        d_fi, d_ft, d_scale = torch.autograd.grad(loss, (fi, ft, scale))
        d_fi, d_ft = d_fi.reshape(a, B // a, -1), d_ft.reshape(a, B // a, -1)
        for i in range(a):
            fi_i, ft_i, _ = enc(i)
            torch.autograd.backward((fi_i, ft_i), (d_fi[i], d_ft[i]))
        ls = params["logit_scale"]
        ls.grad = d_scale if ls.grad is None else ls.grad + d_scale

    return loss.detach(), bn_updates, pull_back


@dataclass
class TrainState:
    """What a step changes: the model's parameters and buffers, the
    optimizer and its schedule, the step count, the EMA shadow (a dict of
    every tensor of ``model.params()``, or None) with its decay, and how
    the trained tensors meet the data group (:class:`.optim.DataShards`;
    its ``opt_params()`` are what the optimizer holds)."""

    model: MM.MSClipModel
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
    ema: dict | None = None
    ema_decay: float = 0.0
    shards: DataShards | None = None
    mesh: Mesh = Mesh()

    def full_params(self):
        """``model.params()`` with every tensor whole on this process (FSDP
        drops the split ones between steps; this gathers them, a
        collective); under tensor parallelism, this process's parts."""
        self.shards.materialize()
        return self.model.params()

    def whole_params(self):
        """Every tensor of the model whole, the tensor-parallel ones
        gathered over the model group (a collective): what a checkpoint
        holds."""
        return gather_over_model(self.full_params(), self.mesh)


def shard_dims(config, params, mesh: Mesh):
    """``{name: dim or None}`` of the trained tensors (``params``: whole,
    before any tensor-parallel cut) that ``TPU.FSDP`` (``fsdp_dims``) or
    ``TPU.ZERO1`` (``zero1_dims``) split over the data group; empty
    without either."""
    if config.TPU.get("FSDP", False):
        return fsdp_dims(params, mesh.data, mesh.model)
    if config.TPU.get("ZERO1", False):
        return zero1_dims(params, mesh.data, mesh.model)
    return {}


def init_train_state(config, spec: MM.MSClipSpec, params, steps_per_epoch,
                     device, mesh: Mesh | None = None) -> TrainState:
    """A trainable model of ``params`` (reference layout, fp32, the same
    on every process) on ``device``, its optimizer and schedule from
    ``config``, and the EMA shadow when ``TRAIN.EMA_DECAY > 0``. On a
    ``mesh`` with ``model > 1`` the model holds this process's part of
    each tensor-parallel tensor; with ``TPU.ZERO1`` or ``TPU.FSDP`` the
    optimizer holds this process's splits (:func:`shard_dims`)."""
    mesh = mesh or Mesh()
    model = MM.MSClipModel(spec, split_for_model(params, mesh),
                           trainable=True).to(device)
    named = dict(model.named_parameters())
    tp_keys = [k for k in named if mesh.model > 1
               and param_dim(k, tuple(params[k].shape)) is not None]
    shards = DataShards(named, shard_dims(config, {k: params[k]
                                                   for k in named}, mesh),
                        mesh.data_group, bool(config.TPU.get("FSDP", False)),
                        mesh.model_group, tp_keys)
    optimizer, scheduler = build_optimizer(
        config, {**dict(model.named_buffers()), **shards.opt_params()},
        spec, steps_per_epoch)
    ema = None
    if config.TRAIN.EMA_DECAY > 0:
        ema = {k: v.detach().clone() for k, v in model.params().items()}
    shards.release()
    return TrainState(model, optimizer, scheduler, 0, ema,
                      config.TRAIN.EMA_DECAY, shards, mesh)


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
                    seed: int = 0, mesh: Mesh | None = None,
                    sharded_loss: bool = False, loss_chunk: int = 4096,
                    ring_loss: bool = False):
    """``step(state, images, tokens) -> metrics``: one train step on
    ``state`` in place (``make_step_core``). ``images``/``tokens`` are
    this process's rows of the global batch (all of it for one process);
    ``mesh`` gives the data group, ``sharded_loss``/``loss_chunk``/
    ``ring_loss`` the loss (:func:`make_embedding_loss`); with
    ``mesh.model > 1`` the blocks run split over the model group (the
    state from :func:`init_train_state` on the same mesh).
    ``accum_steps > 1`` takes GradCache (:func:`gradcache_forward`,
    then its ``pull_back``); ``freeze_bn``
    runs BatchNorm in eval mode; ``larc`` scales AdamW's update
    (:func:`.optim.larc_step_`); ``seed`` (``TPU.SEED``) and the step
    count seed DropPath. ``metrics`` holds the global batch's loss, the
    global norm of the averaged gradients before clipping and the clamped
    ``logit_scale``, as 0-d tensors on the step's device (reading them
    syncs the device).

    Under a profiler the step runs in three spans (``utils.summary.span``):
    ``msclip.train.forward`` from its start through the loss (GradCache's
    first pass included), ``msclip.train.backward`` around the backward on
    the calling thread (autograd launches the backward's kernels from its
    own device thread, so their device time lies under autograd's node
    ranges, not under this span), and ``msclip.train.optimizer`` from the
    gradients' reduction through the EMA update."""
    mesh = mesh or Mesh()
    group = mesh.data_group
    encode = make_encode_fn(spec, freeze_bn, group,
                            mesh.model_group if mesh.model > 1 else None)
    emb_loss = make_embedding_loss(group, sharded_loss, loss_chunk,
                                   label_smoothing, ring_loss)
    dropping = spec.vision_drop_path > 0.0
    n, rank = group_size(group), group_rank(group)

    def step(state: TrainState, images, tokens):
        model, optimizer, shards = state.model, state.optimizer, state.shards
        micro = images.shape[0] // accum_steps

        def generator_of(i):
            return (step_generator(seed, state.step, i, images.device)
                    if dropping else None)

        def rows_of(i):  # microbatch i's rows of the global microbatch
            return rank * micro, n * micro

        step_encode = encode
        if spec.ext.gumbel_select:  # one action a step, every process's
            step_encode = functools.partial(
                encode, action_generator=lambda: step_generator(
                    seed, state.step, 0, images.device, GUMBEL_STREAM))
        with span("msclip.train.forward"):
            shards.materialize()
            params = model.params()
            optimizer.zero_grad(set_to_none=True)
            for p in model.parameters():
                p.grad = None
            if accum_steps > 1:
                loss, bn_updates, pull_back = gradcache_forward(
                    step_encode, params, images, tokens, accum_steps,
                    generator_of=generator_of, emb_loss=emb_loss,
                    rows_of=rows_of)
            else:
                fi, ft, bn_updates = step_encode(params, images, tokens,
                                                 generator_of(0), rows_of(0))
                loss = emb_loss(fi, ft, params["logit_scale"])
                pull_back = loss.backward
        with span("msclip.train.backward"):
            pull_back()
        loss = loss.detach()
        with span("msclip.train.optimizer"):
            shards.reduce_grads()
            grads = list(shards.grads().values())
            grad_norm = global_norm(grads, shards.reduce_norms)
            if clip_grad_norm > 0:
                clip_by_global_norm_(grads, clip_grad_norm, grad_norm)
            if larc:
                names = shards.opt_names(optimizer)
                larc_step_(optimizer,
                           reduce_norms=lambda v: shards.reduce_norms(
                               v, names))
            else:
                optimizer.step()
            state.scheduler.step()
            shards.updated(keep_whole=state.ema is not None)
            with torch.no_grad():
                apply_bn_updates(params, bn_updates)
                params["logit_scale"].clamp_(max=MAX_LOGIT_SCALE)
                if state.ema is not None:
                    ema_update(state.ema, params, state.ema_decay)
        shards.release()
        state.step += 1
        return {"loss": loss, "grad_norm": grad_norm,
                "logit_scale": params["logit_scale"].detach().clone()}

    return step


def make_train_step_from_config(config, spec: MM.MSClipSpec,
                                freeze_bn: bool = False,
                                mesh: Mesh | None = None):
    """:func:`make_train_step` with the config's clipping, label
    smoothing, ``TPU.ACCUM_STEPS``, ``TRAIN.LARC``, ``TPU.SEED`` and
    loss (``TPU.SHARDED_LOSS``, ``TPU.LOSS_CHUNK``, ``TPU.RING_LOSS``)."""
    return make_train_step(
        spec, clip_grad_norm=config.TRAIN.CLIP_GRAD_NORM,
        label_smoothing=config.LOSS.LABEL_SMOOTHING,
        accum_steps=int(config.TPU.get("ACCUM_STEPS", 1)),
        freeze_bn=freeze_bn, larc=bool(config.TRAIN.get("LARC", False)),
        seed=int(config.TPU.SEED), mesh=mesh,
        sharded_loss=bool(config.TPU.get("SHARDED_LOSS", False)),
        loss_chunk=int(config.TPU.get("LOSS_CHUNK", 4096)),
        ring_loss=bool(config.TPU.get("RING_LOSS", False)))

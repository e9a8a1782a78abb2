"""Contrastive training of MS-CLIP on one card, the single-process driver of
the JAX package's ``tools/train.py``.

    python -m msclip_torch.tools.train --cfg <config.yaml|json> \\
        [--device cuda|cpu] [KEY VALUE ...]

Runs on the CUDA card unless ``--device cpu`` is given. Weights start from
``TPU.SEED``; each epoch draws its order with ``DATASET.SAMPLER``; the
pairs come from tar shards, TSV lists, a caption folder or the synthetic
set (``data/pairs.py``). Under ``OUTPUT_DIR/<dataset>/<config>/`` the CLI
writes its log and ``checkpoints/``: a step checkpoint every
``TRAIN.SAVE_EVERY_STEPS`` steps (but on an epoch's last step) and at each
epoch's end, the EMA/SWA shadows as ``checkpoints/{ema,swa}``; with
``TRAIN.AUTO_RESUME`` a rerun resumes from the latest checkpoint and skips
the batches its epoch already saw. ``TPU.ACCUM_STEPS`` (GradCache),
``TPU.REMAT``, ``TRAIN.LARC``, ``SWA.*`` (with ``SWA.FROZEN_BN``, else a
BN refresh of the averaged weights at the end) and
``TRAIN.DETECT_ANOMALY`` apply as in the JAX driver. Every ``PRINT_FREQ``
steps the loss and the samples/s are logged; one closing ``RESULT`` line
gives the steps, the final loss, the samples/s end to end, the peak device
memory and the loss of every step run. Multi-card training waits for a
later slice (ROADMAP M7), and so does ``MSCLIP_TRACE`` (M13), which
raises.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import torch

from ..config import get_default_config, update_config
from ..data.loader import BatchLoaderPairs
from ..data.pairs import make_train_dataset
from ..eval.zero_shot import resolve_device
from ..models.msclip import build_spec, init_params
from ..train.averaging import swa_refresh_bn, swa_should_update, swa_update
from ..train.checkpoint import (
    CheckpointManager,
    auto_resume,
    optimizer_state_by_name,
    save_params,
)
from ..train.trainer import init_train_state, make_train_step_from_config
from ..utils.logging import create_logger


def _clone(params):
    return {k: v.detach().clone() for k, v in params.items()}


def train(config, device="cuda", out_dir=None):
    """Run ``TRAIN.BEGIN_EPOCH .. END_EPOCH`` of the config on ``device``.
    With ``out_dir`` the checkpoints go to ``out_dir/checkpoints`` (and a
    run resumes from them under ``TRAIN.AUTO_RESUME``); without it nothing
    is written. Returns ``(state, stats)``: the final :class:`TrainState`
    and ``steps`` (run by this call), ``first_step`` (the global step it
    started from), ``losses`` (one float per step), ``samples_per_s``
    (end to end, host clock around the whole loop), ``seconds``,
    ``step_ms`` (each step's end after the previous one's, the first after
    the loop's start, so it holds the loader's fill; on the device's clock
    on CUDA) and ``peak_mem_gb`` (CUDA only, else None)."""
    device = resolve_device(device)
    if os.environ.get("MSCLIP_TRACE"):
        raise NotImplementedError(
            "MSCLIP_TRACE: the train loop's profiler trace is not ported "
            "(ROADMAP M13); unset it")
    spec = build_spec(config)
    step_fn = make_train_step_from_config(config, spec)  # refuses an
    # eval-only spec before any work
    if config.TRAIN.DETECT_ANOMALY:
        # reference lib/config/default.py:151 (torch autograd anomaly mode)
        torch.autograd.set_detect_anomaly(True)
        logging.info("=> TRAIN.DETECT_ANOMALY: autograd anomaly mode on")
    dataset = make_train_dataset(config)
    batch = config.TRAIN.BATCH_SIZE_PER_GPU
    loader = BatchLoaderPairs(dataset, batch, workers=config.WORKERS,
                              shuffle=config.TRAIN.SHUFFLE,
                              sampler=config.DATASET.SAMPLER,
                              seed=config.TPU.SEED)
    steps_per_epoch = max(len(dataset) // batch, 1)
    params = init_params(spec, torch.Generator().manual_seed(config.TPU.SEED))
    state = init_train_state(config, spec, params, steps_per_epoch, device)
    names = {id(p): k for k, p in state.model.named_parameters()}

    ckpt = (CheckpointManager(os.path.join(out_dir, "checkpoints"))
            if out_dir else None)
    begin_epoch = config.TRAIN.BEGIN_EPOCH
    resume_skip = 0
    swa, swa_n = None, 0
    # the per-epoch batch count by arithmetic (no sampler draw)
    n_batches = max(loader.num_batches, 1)
    if ckpt is not None and config.TRAIN.AUTO_RESUME:
        step, extra = auto_resume(ckpt, state)
        if step:
            begin_epoch = extra.get("epoch", begin_epoch)
            shadows = extra.get("shadows", {})
            if state.ema is not None:
                if "ema" in shadows:
                    state.ema = shadows["ema"]
                else:  # no shadow saved: anchor it to the restored weights
                    logging.info("=> no EMA shadow in checkpoint; "
                                 "re-anchoring EMA to restored weights")
                    state.ema = _clone(state.model.params())
            if "swa" in shadows:
                swa, swa_n = shadows["swa"], int(extra.get("swa_n", 0))
            resume_skip = step % n_batches
            if resume_skip:
                logging.info(
                    f"=> resume fast-forward: skipping {resume_skip} "
                    f"already-seen batches of epoch {begin_epoch}")

    def save(epoch, force=False):
        ckpt.save(state.step, state.model.params(),
                  optimizer_state_by_name(state.optimizer, names),
                  extra={"epoch": epoch, "swa_n": swa_n},
                  shadows={"ema": state.ema, "swa": swa}, force=force)

    frozen_step_fn = None
    logging.info(f"=> training on {device}: {steps_per_epoch} steps/epoch x "
                 f"{config.TRAIN.END_EPOCH} epochs, batch {batch}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    save_every = config.TRAIN.SAVE_EVERY_STEPS
    first_step = state.step
    losses, seen = [], 0
    # each step's end: a CUDA event (stream-ordered, no sync) or the host
    # clock; the first mark is the loop's start
    marks = []

    def mark():
        if device.type == "cuda":
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())

    t0 = time.time()
    mark()
    for epoch in range(begin_epoch, config.TRAIN.END_EPOCH):
        loader.set_epoch(epoch)
        if resume_skip and epoch == begin_epoch:
            loader.fast_forward(resume_skip)
        epoch_step_fn = step_fn
        if config.SWA.FROZEN_BN and swa_should_update(epoch, config):
            # SWA.FROZEN_BN: once averaging starts, BatchNorm runs in eval
            # mode on its running statistics and records no update
            if frozen_step_fn is None:
                frozen_step_fn = make_train_step_from_config(
                    config, spec, freeze_bn=True)
            epoch_step_fn = frozen_step_fn
        te = time.time()
        for i, b in enumerate(loader):
            images = torch.from_numpy(b["image"]).to(device, non_blocking=True)
            tokens = torch.from_numpy(b["tokens"]).to(device, non_blocking=True)
            metrics = epoch_step_fn(state, images, tokens)
            losses.append(metrics["loss"])
            mark()
            seen += images.shape[0]
            if (ckpt is not None and save_every
                    and state.step % save_every == 0
                    and state.step % n_batches != 0):
                # mid-epoch: the epoch is not advanced (a resume re-enters
                # it and fast-forwards); the epoch's last step is left to
                # the epoch-end save, whose metadata must own it
                save(epoch)
            if (i + 1) % config.PRINT_FREQ == 0:
                logging.info(
                    f"Epoch[{epoch}] Step[{i + 1}/{steps_per_epoch}] loss "
                    f"{float(metrics['loss']):.4f} "
                    f"({seen / (time.time() - t0):.0f} samples/s)")
        if swa_should_update(epoch, config):
            if swa is None:  # the first snapshot counts as one model
                swa, swa_n = _clone(state.model.params()), 1
            else:
                swa_n = swa_update(swa, state.model.params(), swa_n)
        if ckpt is not None:
            # force: an epoch of no batches leaves the step where the last
            # save put it, and the epoch-end save must replace it
            save(epoch + 1, force=True)
            for name, shadow in (("ema", state.ema), ("swa", swa)):
                if shadow is not None:
                    save_params(os.path.join(ckpt.directory, name), shadow)
        logging.info(f"=> epoch {epoch} done in {time.time() - te:.1f}s")
    losses = [float(x) for x in losses]  # syncs the device
    seconds = time.time() - t0
    step_ms = [a.elapsed_time(b) if device.type == "cuda" else (b - a) * 1e3
               for a, b in zip(marks, marks[1:])]
    if swa is not None and not config.SWA.FROZEN_BN:
        # the averaged weights' BN statistics are the last model's: recompute
        # them over one pass of the training data (torch update_bn)
        logging.info("=> SWA: refreshing BN statistics over one epoch")
        swa_refresh_bn(swa, spec, (
            torch.from_numpy(b["image"]).to(device) for b in loader))
        if ckpt is not None:
            save_params(os.path.join(ckpt.directory, "swa"), swa)
    logging.info("=> training complete")
    stats = {
        "steps": len(losses), "first_step": first_step, "losses": losses,
        "seconds": seconds, "step_ms": step_ms,
        "samples_per_s": seen / seconds if seconds > 0 else 0.0,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                        if device.type == "cuda" else None),
    }
    return state, stats


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train an MS-CLIP model on one card (PyTorch).")
    parser.add_argument("--cfg", required=True,
                        help="model config (yaml or json)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' for the "
                             "plain versions of the kernels)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="Modify config options using the command-line")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    config = get_default_config()
    update_config(config, args.cfg, opts=args.opts)
    resolve_device(args.device)  # no card: raise before writing anything
    out_dir = create_logger(config, args.cfg, "train")
    _, stats = train(config, device=args.device, out_dir=out_dir)
    peak = stats["peak_mem_gb"]
    print(f"RESULT steps={stats['steps']} "
          f"final_loss={stats['losses'][-1] if stats['losses'] else 'nan'} "
          f"samples_per_s={stats['samples_per_s']:.1f} "
          f"peak_mem_gb={'n/a' if peak is None else f'{peak:.2f}'} "
          f"first_step={stats['first_step']} "
          f"losses={json.dumps(stats['losses'], separators=(',', ':'))}")
    return stats


if __name__ == "__main__":
    main()

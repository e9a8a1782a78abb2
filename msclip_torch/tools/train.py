"""Contrastive training of MS-CLIP, the driver of the JAX package's
``tools/train.py``.

    python -m msclip_torch.tools.train --cfg <config.yaml|json> \\
        [--device cuda|cpu] [KEY VALUE ...]
    torchrun --nproc_per_node N -m msclip_torch.tools.train --cfg ... \\
        [TPU.SHARDED_LOSS True] [TPU.RING_LOSS True] [TPU.ZERO1 True] ...

Runs on the CUDA card unless ``--device cpu`` is given. Under ``torchrun``
(``WORLD_SIZE`` set) every process joins the process group (NCCL on the
card, gloo with ``--device cpu``, ``utils/comm.init_distributed``) and
drives its own card, ``cuda:LOCAL_RANK``; the global batch is
``TRAIN.BATCH_SIZE_PER_GPU x WORLD_SIZE`` (``tools/train.py:68-76``),
each data rank loads its equal stripe of the epoch's order, and the step
is the global batch's (``train/trainer.py``). Weights start from
``TPU.SEED``; each epoch draws its order with ``DATASET.SAMPLER``; the
pairs come from tar shards, TSV lists, a caption folder or the synthetic
set (``data/pairs.py``). Under ``OUTPUT_DIR/<dataset>/<config>/`` the CLI
writes its log (a file per rank) and ``checkpoints/`` (rank 0): a step
checkpoint every ``TRAIN.SAVE_EVERY_STEPS`` steps (but on an epoch's last
step) and at each epoch's end, the EMA/SWA shadows as
``checkpoints/{ema,swa}``; with ``TRAIN.AUTO_RESUME`` a rerun resumes from
the latest checkpoint, on any number of processes, and skips the batches
its epoch already saw. ``TPU.ACCUM_STEPS`` (GradCache), ``TPU.REMAT``,
``TPU.SHARDED_LOSS``/``TPU.LOSS_CHUNK``/``TPU.RING_LOSS`` (the loss),
``TPU.ZERO1``, ``TPU.FSDP``, ``TRAIN.LARC``, ``SWA.*`` (with
``SWA.FROZEN_BN``, else a BN refresh of the averaged weights at the end,
on rank 0) and ``TRAIN.DETECT_ANOMALY`` apply as in the JAX driver. Every
``PRINT_FREQ`` steps the loss and the samples/s are logged; rank 0 prints
one closing ``RESULT`` line: the steps, the final loss, the samples/s end
to end, the peak device memory, the world, the global batch, the bytes
this process keeps between steps, its K1/K2 launches, each step's ms and
the loss of every step run.
``TPU.MESH_MODEL > 1`` splits every transformer block over that many
processes (tensor parallelism; each model group shares its rows).
``MSCLIP_TRACE=<dir>`` writes a ``torch.profiler`` trace of steps 4-7 of
the first epoch on rank 0 (``utils/summary.TraceWindow``).
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
from ..eval.device import resolve_device
from ..models.msclip import build_spec, init_params
from ..ops import attention as A
from ..parallel.mesh import gather_over_model, mesh_from_config
from ..train.averaging import swa_refresh_bn, swa_should_update, swa_update
from ..train.checkpoint import CheckpointManager, auto_resume, save_params
from ..train.trainer import init_train_state, make_train_step_from_config
from ..utils.comm import comm, init_distributed, shutdown
from ..utils.logging import create_logger
from ..utils.platform import apply_platform_override
from ..utils.summary import TraceWindow


def _clone(params):
    return {k: v.detach().clone() for k, v in params.items()}


def train(config, device="cuda", out_dir=None):
    """Run ``TRAIN.BEGIN_EPOCH .. END_EPOCH`` of the config on ``device``,
    in every process of a ``torchrun`` launch (each joins the group here
    if the caller has not). With ``out_dir`` the checkpoints go to
    ``out_dir/checkpoints`` (and a run resumes from them under
    ``TRAIN.AUTO_RESUME``); without it nothing is written. Returns
    ``(state, stats)``: the final :class:`TrainState` (every tensor
    whole) and ``steps`` (run by this call), ``first_step`` (the global
    step it started from), ``losses`` (the global batch's, one float per
    step), ``samples_per_s`` (global samples end to end, host clock
    around the whole loop), ``seconds``, ``step_ms`` (each step's end
    after the previous one's, the first after the loop's start, so it
    holds the loader's fill; on the device's clock on CUDA),
    ``peak_mem_gb`` (CUDA only, else None), ``world``, ``global_batch``,
    ``state_bytes`` (what this process keeps between steps for the
    trained tensors and the optimizer) and ``launches`` (this process's
    attention kernel launches, K1 and K2, during the run; 0 on the CPU).
    ``CUDNN.DETERMINISTIC`` sets ``torch.backends.cudnn.deterministic``
    for the run."""
    device = resolve_device(device)
    spec = build_spec(config)
    init_distributed(device)
    torch.backends.cudnn.deterministic = bool(config.CUDNN.DETERMINISTIC)
    launched = (A.fused_attention_qkv.launches,
                A.fused_attention_qkv_bwd.launches)
    mesh = mesh_from_config(config)
    step_fn = make_train_step_from_config(config, spec, mesh=mesh)
    # (refuses an eval-only spec before any work)
    if config.TRAIN.DETECT_ANOMALY:
        # reference lib/config/default.py:151 (torch autograd anomaly mode)
        torch.autograd.set_detect_anomaly(True)
        logging.info("=> TRAIN.DETECT_ANOMALY: autograd anomaly mode on")
    dataset = make_train_dataset(config)
    global_batch = config.TRAIN.BATCH_SIZE_PER_GPU * comm.world_size
    batch = global_batch // mesh.data  # a model group shares its rows
    loader = BatchLoaderPairs(dataset, batch, workers=config.WORKERS,
                              shuffle=config.TRAIN.SHUFFLE,
                              sampler=config.DATASET.SAMPLER,
                              seed=config.TPU.SEED,
                              shard=(mesh.data_rank, mesh.data))
    steps_per_epoch = max(len(dataset) // global_batch, 1)
    params = init_params(spec, torch.Generator().manual_seed(config.TPU.SEED))
    state = init_train_state(config, spec, params, steps_per_epoch, device,
                             mesh)
    main = comm.is_main_process()

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
                    state.ema = _clone(state.full_params())
            if "swa" in shadows:
                swa, swa_n = shadows["swa"], int(extra.get("swa_n", 0))
            resume_skip = step % n_batches
            if resume_skip:
                logging.info(
                    f"=> resume fast-forward: skipping {resume_skip} "
                    f"already-seen batches of epoch {begin_epoch}")

    def whole(shadow):  # a shadow of this process's tensor-parallel parts
        return None if shadow is None else gather_over_model(shadow, mesh)

    def save(epoch, force=False):
        ckpt.save(state.step, state.whole_params(),
                  state.shards.full_optimizer_state(state.optimizer),
                  extra={"epoch": epoch, "swa_n": swa_n},
                  shadows={"ema": whole(state.ema), "swa": whole(swa)},
                  force=force)

    frozen_step_fn = None
    logging.info(f"=> training on {device}: {steps_per_epoch} steps/epoch x "
                 f"{config.TRAIN.END_EPOCH} epochs, global batch "
                 f"{global_batch} ({mesh.data} data x {mesh.model} model "
                 f"processes, {batch} rows each)")
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

    # MSCLIP_TRACE=<dir>: a torch.profiler trace of steps 4-7 of the first
    # epoch (past the first steps' set-up), rank 0 only, as the JAX hook
    trace = TraceWindow(os.environ.get("MSCLIP_TRACE") if comm.rank == 0
                        else None, 3, 6, device, "train steps 4-7")
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
            if epoch == begin_epoch:
                trace.before(i)
            images = torch.from_numpy(b["image"]).to(device, non_blocking=True)
            tokens = torch.from_numpy(b["tokens"]).to(device, non_blocking=True)
            metrics = epoch_step_fn(state, images, tokens)
            losses.append(metrics["loss"])
            mark()
            trace.after(i)
            seen += global_batch
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
        trace.close()  # a first epoch shorter than the window
        if swa_should_update(epoch, config):
            if swa is None:  # the first snapshot counts as one model
                swa, swa_n = _clone(state.full_params()), 1
            else:
                swa_n = swa_update(swa, state.full_params(), swa_n)
        if ckpt is not None:
            # force: an epoch of no batches leaves the step where the last
            # save put it, and the epoch-end save must replace it
            save(epoch + 1, force=True)
            for name, shadow in (("ema", whole(state.ema)),
                                 ("swa", whole(swa))):
                if shadow is not None and main:
                    save_params(os.path.join(ckpt.directory, name), shadow)
            comm.synchronize()
        logging.info(f"=> epoch {epoch} done in {time.time() - te:.1f}s")
    losses = [float(x) for x in losses]  # syncs the device
    seconds = time.time() - t0
    step_ms = [a.elapsed_time(b) if device.type == "cuda" else (b - a) * 1e3
               for a, b in zip(marks, marks[1:])]
    swa = whole(swa)
    if swa is not None and not config.SWA.FROZEN_BN and main:
        # the averaged weights' BN statistics are the last model's: recompute
        # them over one pass of the training data (torch update_bn; rank 0,
        # over its stripe, with the whole tensors)
        logging.info("=> SWA: refreshing BN statistics over one epoch")
        swa_refresh_bn(swa, spec, (
            torch.from_numpy(b["image"]).to(device) for b in loader))
        if ckpt is not None:
            save_params(os.path.join(ckpt.directory, "swa"), swa)
    comm.synchronize()
    state_bytes = state.shards.stored_bytes(state.optimizer)
    state.full_params()  # the returned model is whole
    logging.info("=> training complete")
    stats = {
        "steps": len(losses), "first_step": first_step, "losses": losses,
        "seconds": seconds, "step_ms": step_ms,
        "samples_per_s": seen / seconds if seconds > 0 else 0.0,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                        if device.type == "cuda" else None),
        "world": comm.world_size, "global_batch": global_batch,
        "state_bytes": state_bytes,
        "launches": [A.fused_attention_qkv.launches - launched[0],
                     A.fused_attention_qkv_bwd.launches - launched[1]],
    }
    return state, stats


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train an MS-CLIP model (PyTorch; one process a card, "
                    "several under torchrun).")
    parser.add_argument("--cfg", required=True,
                        help="model config (yaml or json)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda, or cpu under "
                             "MSCLIP_PLATFORM=cpu; 'cpu' for the plain "
                             "versions of the kernels)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="Modify config options using the command-line")
    return parser.parse_args(argv)


def main(argv=None):
    device = apply_platform_override()  # MSCLIP_PLATFORM, MSCLIP_DEBUG_NANS
    args = parse_args(argv)
    args.device = args.device or device
    config = get_default_config()
    update_config(config, args.cfg, opts=args.opts)
    init_distributed(resolve_device(args.device))  # no card: raise
    # before writing anything
    out_dir = create_logger(config, args.cfg, "train")
    _, stats = train(config, device=args.device, out_dir=out_dir)
    peak = stats["peak_mem_gb"]
    main_process = comm.is_main_process()
    shutdown()
    if not main_process:
        return stats
    step_ms = [round(x, 3) for x in stats["step_ms"]]
    print(f"RESULT steps={stats['steps']} "
          f"final_loss={stats['losses'][-1] if stats['losses'] else 'nan'} "
          f"samples_per_s={stats['samples_per_s']:.1f} "
          f"peak_mem_gb={'n/a' if peak is None else f'{peak:.2f}'} "
          f"first_step={stats['first_step']} world={stats['world']} "
          f"global_batch={stats['global_batch']} "
          f"param_bytes={stats['state_bytes']['params']} "
          f"optimizer_bytes={stats['state_bytes']['optimizer']} "
          f"attention_launches={stats['launches'][0]},"
          f"{stats['launches'][1]} "
          f"step_ms={json.dumps(step_ms, separators=(',', ':'))} "
          f"losses={json.dumps(stats['losses'], separators=(',', ':'))}")
    return stats


if __name__ == "__main__":
    main()

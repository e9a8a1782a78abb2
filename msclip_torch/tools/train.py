"""Contrastive training of MS-CLIP on one card, the single-process loop of
the JAX package's ``tools/train.py``.

    python -m msclip_torch.tools.train --cfg <config.yaml|json> \\
        [--device cuda|cpu] [KEY VALUE ...]

Runs on the CUDA card unless ``--device cpu`` is given. Weights start from
``TPU.SEED``; each epoch reshuffles the pairs; every ``PRINT_FREQ`` steps
the loss and the samples/s are logged; one closing ``RESULT`` line gives the
steps, the final loss, the samples/s end to end and the peak device memory.
Checkpoints with auto-resume, the EMA/SWA shadows on disk, GradCache and
multi-card training wait for later slices (ROADMAP M6, M7).
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

import torch

from ..config import get_default_config, update_config
from ..data.loader import PairBatchLoader
from ..data.pairs import make_train_dataset
from ..eval.zero_shot import resolve_device
from ..models.msclip import build_spec, init_params
from ..train.trainer import init_train_state, make_train_step


def train(config, device="cuda"):
    """Run ``TRAIN.BEGIN_EPOCH .. END_EPOCH`` of the config on ``device``.
    Returns ``(state, stats)``: the final :class:`TrainState` and ``steps``,
    ``losses`` (one float per step), ``samples_per_s`` (end to end, host
    clock around the whole loop), ``seconds`` and ``peak_mem_gb`` (CUDA
    only, else None)."""
    device = resolve_device(device)
    spec = build_spec(config)
    step_fn = make_train_step(  # refuses an eval-only spec before any work
        spec, clip_grad_norm=config.TRAIN.CLIP_GRAD_NORM,
        label_smoothing=config.LOSS.LABEL_SMOOTHING)
    dataset = make_train_dataset(config)
    if config.DATASET.SAMPLER not in ("default", ""):
        raise NotImplementedError(
            f"DATASET.SAMPLER {config.DATASET.SAMPLER!r} is not ported to "
            "msclip_torch yet (ROADMAP M12); use 'default'")
    batch = config.TRAIN.BATCH_SIZE_PER_GPU
    loader = PairBatchLoader(dataset, batch, workers=config.WORKERS,
                             shuffle=config.TRAIN.SHUFFLE,
                             seed=config.TPU.SEED)
    steps_per_epoch = max(len(dataset) // batch, 1)
    params = init_params(spec, torch.Generator().manual_seed(config.TPU.SEED))
    state = init_train_state(config, spec, params, steps_per_epoch, device)
    logging.info(f"=> training on {device}: {steps_per_epoch} steps/epoch x "
                 f"{config.TRAIN.END_EPOCH} epochs, batch {batch}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, seen = [], 0
    t0 = time.time()
    for epoch in range(config.TRAIN.BEGIN_EPOCH, config.TRAIN.END_EPOCH):
        loader.set_epoch(epoch)
        for i, b in enumerate(loader):
            images = torch.from_numpy(b["image"]).to(device, non_blocking=True)
            tokens = torch.from_numpy(b["tokens"]).to(device, non_blocking=True)
            metrics = step_fn(state, images, tokens)
            losses.append(metrics["loss"])
            seen += images.shape[0]
            if (i + 1) % config.PRINT_FREQ == 0:
                logging.info(
                    f"Epoch[{epoch}] Step[{i + 1}/{steps_per_epoch}] loss "
                    f"{float(metrics['loss']):.4f} "
                    f"({seen / (time.time() - t0):.0f} samples/s)")
    losses = [float(x) for x in losses]  # syncs the device
    seconds = time.time() - t0
    stats = {
        "steps": len(losses), "losses": losses, "seconds": seconds,
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
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(message)s")
    args = parse_args(argv)
    config = get_default_config()
    update_config(config, args.cfg, opts=args.opts)
    _, stats = train(config, device=args.device)
    peak = stats["peak_mem_gb"]
    print(f"RESULT steps={stats['steps']} "
          f"final_loss={stats['losses'][-1] if stats['losses'] else 'nan'} "
          f"samples_per_s={stats['samples_per_s']:.1f} "
          f"peak_mem_gb={'n/a' if peak is None else f'{peak:.2f}'}")
    return stats


if __name__ == "__main__":
    main()

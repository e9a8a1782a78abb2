"""Classification finetuning (the JAX package's ``tools/finetune.py``; the
``FINETUNE.*`` tree, ``lib/config/default.py:170-177``).

    python -m msclip_torch.tools.finetune --ds <dataset.yaml> \\
        --model <model.yaml|json> [--device cuda|cpu] \\
        [FINETUNE.BASE_LR 0.003 TRAIN.END_EPOCH 10 ...]

A linear head on the frozen image tower (BN unfolded, eval mode), trained
with AdamW (``FINETUNE.BASE_LR``, ``TRAIN.WD``) at ``FINETUNE.BATCH_SIZE``
over ``TRAIN.BEGIN_EPOCH .. END_EPOCH`` with mixup/cutmix (``AUG.MIXUP``,
``AUG.MIXCUT``, ``AUG.MIXUP_SWITCH_PROB``) and label smoothing
(``LOSS.LABEL_SMOOTHING``); then top-1 on the same dataset's eval split
(the test split stands in for the training set, as in the JAX tool).
Runs on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from ..config import get_default_config, update_config
from ..data.loader import BatchLoader
from ..data.transforms import dataset_normalizer, mixup_cutmix
from ..eval.zero_shot import load_eval_model, make_dataset, resolve_device
from ..models.msclip import build_spec
from ..utils import metrics as M
from ..utils.logging import create_logger


def run_finetune(config, device="cuda"):
    """Train the head and evaluate it. Returns ``(top1, stats)``: the head
    (``w [E, n_classes]``, ``b``), the loss of each step and the eval
    logits with their labels."""
    device = resolve_device(device)
    spec = build_spec(config)
    model = load_eval_model(config, spec, device, fold_bn=False, int8=False)
    n_classes = config.DATASET.get("NUM_CLASSES", 1000)
    head = {"w": torch.zeros(spec.embed_dim, n_classes, device=device,
                             requires_grad=True),
            "b": torch.zeros(n_classes, device=device, requires_grad=True)}
    # optax adamw's defaults; weight decay on both tensors
    opt = torch.optim.AdamW(head.values(), lr=config.FINETUNE.BASE_LR,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=config.TRAIN.WD)
    train_ds = make_dataset(config)  # the test split stands in
    pre = dataset_normalizer(train_ds)
    gen = torch.Generator(device=device).manual_seed(config.TPU.SEED)

    def features(images):
        with torch.no_grad():  # frozen tower
            return model.encode_image(pre(images), normalize=False).float()

    loader = BatchLoader(train_ds, config.FINETUNE.BATCH_SIZE,
                         workers=config.WORKERS, shuffle=True, drop_last=True,
                         seed=config.TPU.SEED)
    losses = []
    for epoch in range(config.TRAIN.BEGIN_EPOCH, config.TRAIN.END_EPOCH):
        loader.set_epoch(epoch)
        t0, epoch_losses = time.time(), []
        for batch in loader:
            images = torch.from_numpy(batch["image"]).to(device)
            labels = torch.from_numpy(batch["label"]).to(device)
            images, soft = mixup_cutmix(
                gen, pre(images), labels, n_classes,
                mixup_alpha=config.AUG.MIXUP, cutmix_alpha=config.AUG.MIXCUT,
                switch_prob=config.AUG.MIXUP_SWITCH_PROB,
                label_smoothing=config.LOSS.LABEL_SMOOTHING)
            with torch.no_grad():
                feats = model.encode_image(images, normalize=False).float()
            logp = torch.log_softmax(feats @ head["w"] + head["b"], dim=-1)
            loss = -(soft * logp).sum(-1).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            epoch_losses.append(loss.detach())
        epoch_losses = [float(x) for x in epoch_losses]
        losses += epoch_losses
        logging.info(f"Epoch[{epoch}] loss {np.mean(epoch_losses):.4f} "
                     f"({time.time() - t0:.1f}s)")

    top1 = M.AverageMeter()
    all_logits, all_labels = [], []
    for batch in BatchLoader(train_ds, config.TEST.BATCH_SIZE_PER_GPU,
                             workers=config.WORKERS):
        images = torch.from_numpy(batch["image"]).to(device)
        with torch.no_grad():
            logits = (features(images) @ head["w"] + head["b"]).cpu().numpy()
        mask = batch["mask"]
        top1.update(M.topk_accuracy(logits, batch["label"], (1,), mask)[0],
                    int(mask.sum()))
        all_logits.append(logits[mask])
        all_labels.append(np.asarray(batch["label"])[mask])
    return top1.avg, {
        "head": {k: v.detach().cpu() for k, v in head.items()},
        "losses": losses, "logits": np.concatenate(all_logits),
        "labels": np.concatenate(all_labels)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Finetune a classifier head.")
    p.add_argument("--ds", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' for the plain "
                        "versions of the kernels)")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    config = get_default_config()
    update_config(config, args.ds)
    update_config(config, args.model, opts=args.opts)
    resolve_device(args.device)  # no card: raise before writing anything
    create_logger(config, args.model, "finetune")
    top1, _ = run_finetune(config, device=args.device)
    print(f"RESULT finetune top1={top1:.3f}")
    return top1


if __name__ == "__main__":
    main()

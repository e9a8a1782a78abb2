"""Zero-shot evaluation (port of ``msclip_tpu/eval/zero_shot.py``).

Classifier build (every ``class x template`` prompt tokenized on the host,
text-encoded in chunks on the device), then the image loop over a
prefetching loader, then top-1 accuracy. Single process, one device; the
entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..data import ClipTokenizer, get_classnames, get_templates
from ..data.loader import BatchLoader
from ..data.transforms import dataset_normalizer
from ..models.msclip import (
    MSClipModel,
    MSClipSpec,
    build_spec,
    cast_params,
)
from ..utils import metrics as M

# datasets the JAX package evaluates with loaders of their own; this port
# reads ImageFolder trees and the synthetic set only (ROADMAP M4/M8)
_UNPORTED_DATASETS = frozenset({
    "voc2007classification", "hatefulmemes", "chestxray8", "cifar-10",
    "cifar-100", "mnist", "fer-2013", "stl-10", "food-101", "dtd", "sun397",
    "oxford-iiit-pets", "gtsrb", "oxford-flower-102", "fgvc-aircraft-2013b",
    "stanford-cars", "pcam", "eurosat", "resisc45", "caltech-101",
    "country211", "rendered-sst2", "birdsnap", "kitti-distance",
})


def resolve_device(device) -> torch.device:
    """The entry points' device rule: ``cuda`` unless the caller asks for
    the CPU, and no silent fall back when there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(CLI: --device cpu) to run on the CPU")
    return device


@torch.inference_mode()
def build_zeroshot_classifier(model: MSClipModel, tokenizer, classnames,
                              templates, chunk_size: int = 1024):
    """Prompt-ensemble classifier ``[embed_dim, n_classes]``: per class,
    encode all templates (L2-normed), average, re-normalize (reference
    ``zeroshot_classifier``, tools/zero_shot.py:122-134). Returns the
    classifier and the number of text chunks encoded."""
    n_classes, n_templates = len(classnames), len(templates)
    texts = [t.format(c) for c in classnames for t in templates]
    tokens = torch.from_numpy(tokenizer(texts, model.spec.context_length))
    device = next(model.buffers()).device
    chunks = [model.encode_text(tokens[i:i + chunk_size].to(device))
              for i in range(0, len(tokens), chunk_size)]
    embeds = torch.cat(chunks).reshape(n_classes, n_templates, -1)
    class_embeds = embeds.mean(dim=1)
    class_embeds = class_embeds / torch.linalg.vector_norm(
        class_embeds, dim=-1, keepdim=True)
    return class_embeds.t(), len(chunks)


def resolve_prompts(prompt_name: str, dataset):
    """``(classnames, templates)``: the curated prompt set when one exists,
    else the dataset's own classnames under the ImageNet-80 templates.
    Numeric placeholder classnames are rejected: prompts like 'a photo of
    a 42.' would give a plausible near-chance accuracy instead of an
    error."""
    try:
        return get_classnames(prompt_name), get_templates(prompt_name)
    except ValueError:
        classnames = [str(c).replace("_", " ")
                      for c in getattr(dataset, "classes", [])]
        if not classnames:
            raise
        if all(c.strip().isdigit() for c in classnames):
            raise ValueError(
                f"dataset '{prompt_name}' exposes only numeric placeholder "
                "classnames — zero-shot needs real class names")
        logging.info(f"=> no prompt set for '{prompt_name}'; using "
                     f"{len(classnames)} dataset classnames with the "
                     "imagenet template ensemble")
        return classnames, get_templates("imagenet")


def make_dataset(config):
    """The test split: an ImageFolder tree under ``DATASET.ROOT`` or the
    synthetic set."""
    from ..data.datasets import ImageFolderDataset, SyntheticImageDataset

    name = config.DATASET.DATASET
    if name in _UNPORTED_DATASETS:
        raise NotImplementedError(
            f"dataset {name!r} has a loader of its own in msclip_tpu that "
            "is not ported yet (ROADMAP M4/M8)")
    if name == "synthetic":
        return SyntheticImageDataset(
            n=config.DATASET.get("NUM_SAMPLES", 256),
            size=config.TEST.IMAGE_SIZE[0],
            n_classes=config.DATASET.get("NUM_CLASSES", 1000))
    return ImageFolderDataset(
        os.path.join(config.DATASET.ROOT, config.DATASET.TEST_SET),
        image_size=config.TEST.IMAGE_SIZE[0],
        mean=tuple(config.INPUT.MEAN), std=tuple(config.INPUT.STD))


def load_eval_model(config, spec: MSClipSpec, device) -> MSClipModel:
    """Parameters from the config, BN folded (``TPU.FOLD_BN``, default
    on), with ``TPU.INT8_EVAL`` the trunk's GEMM weights quantized from the
    fp32 weights (as ``msclip_tpu/eval/zero_shot.py:200-207``), then cast
    to the compute dtype (BN running stats and the int8 weights with their
    scales stay as they are; every weight is cast to the compute dtype at
    use anyway, so casting once changes no result), on ``device``."""
    from ..models.folding import fold_params_for_eval
    from ..models.quantize import quantize_params_for_eval
    from .checkpoint_load import load_model_params

    params = load_model_params(config, spec)
    if config.TPU.get("FOLD_BN", True):
        params = fold_params_for_eval(params, spec)
    if config.TPU.get("INT8_EVAL", False):
        params = quantize_params_for_eval(params, spec)
    params = cast_params(params, spec.dtype)
    return MSClipModel(spec, params).to(device)


@torch.inference_mode()
def run_zero_shot(config, dataset=None, prompt_dataset: str | None = None,
                  device="cuda"):
    """Full zero-shot eval; returns ``(metric_value, stats)``."""
    device = resolve_device(device)
    metric = config.TEST.get("METRIC", "accuracy")
    if metric != "accuracy":
        raise NotImplementedError(
            f"TEST.METRIC={metric!r}: only 'accuracy' is ported (11-point "
            "mAP, mean-per-class and ROC-AUC: ROADMAP M4)")
    spec = build_spec(config)
    model = load_eval_model(config, spec, device)

    prompt_name = prompt_dataset or config.DATASET.DATASET
    if prompt_name == "synthetic":
        prompt_name = "imagenet"
    if dataset is None:
        dataset = make_dataset(config)
    classnames, templates = resolve_prompts(prompt_name, dataset)
    subset = int(config.TEST.get("SUBSET_CLASSES", 0) or 0)
    if subset > 0:
        classnames = classnames[:subset]

    logging.info("=> Start to build zeroshot classifier "
                 f"({len(classnames)} classes x {len(templates)} templates)")
    t0 = time.time()
    weights, n_chunks = build_zeroshot_classifier(
        model, ClipTokenizer(), classnames, templates)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    classifier_s = time.time() - t0
    logging.info(f"=> classifier built in {classifier_s:.1f}s")

    loader = BatchLoader(dataset, batch_size=config.TEST.BATCH_SIZE_PER_GPU,
                         workers=config.WORKERS)
    pre = dataset_normalizer(dataset)
    save_pred = config.TEST.get("SAVE_PRED", "")
    top1 = M.AverageMeter()
    preds, labels = [], []
    n_images = n_batches = 0
    t0 = time.time()
    logging.info("=> Start to inference")

    def consume(logits_dev, batch):
        logits = logits_dev.float().cpu().numpy()
        mask = batch["mask"]
        if save_pred:
            preds.append(logits[mask].argmax(-1).astype(np.int64))
            labels.append(np.asarray(batch["label"])[mask])
        top1.update(M.topk_accuracy(logits, batch["label"], (1,), mask)[0],
                    int(mask.sum()))
        return int(mask.sum())

    # double buffering: batch i+1 is queued on the device before batch i's
    # logits are read back
    pending = None
    for batch in loader:
        images = torch.from_numpy(batch["image"]).to(device, non_blocking=True)
        logits = 100.0 * model.encode_image(pre(images)) @ weights
        n_batches += 1
        if pending is not None:
            n_images += consume(*pending)
        pending = (logits, batch)
    if pending is not None:
        n_images += consume(*pending)
    elapsed = time.time() - t0

    if save_pred and preds:
        np.savez(save_pred, pred=np.concatenate(preds),
                 label=np.concatenate(labels))
        logging.info(f"=> saved per-image predictions to {save_pred}")

    stats = {
        "n_images": n_images,
        "elapsed_s": elapsed,
        "images_per_sec": n_images / max(elapsed, 1e-9),
        "metric": metric,
        "classifier_s": classifier_s,
        "n_image_batches": n_batches,
        "n_text_chunks": n_chunks,
        "device": str(device),
    }
    logging.info(
        f"=> {config.DATASET.DATASET}% TEST:\tError@1 {100 - top1.avg:.3f}%"
        f"\t{metric}@1 {top1.avg:.3f}%\t({stats['images_per_sec']:.0f} img/s)")
    return top1.avg, stats

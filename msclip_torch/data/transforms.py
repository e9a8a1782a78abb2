"""Eval image preprocessing, the eval part of ``msclip_tpu/data/transforms.py``.

``pil_eval_transform`` is the reference eval transform
(``tools/zero_shot.py:202-207``): PIL bicubic resize of the short side,
center crop, /255, ImageNet-stats normalize. ``normalize_uint8`` runs the
same fp32 ops in the same order on a uint8 batch in torch, on the batch's
device, so a uint8 boundary plus this function equals host-side fp32
normalisation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def pil_eval_uint8(image, size: int = 224) -> np.ndarray:
    """PIL image -> uint8 ``[size, size, 3]`` center crop."""
    from PIL import Image

    if image.mode != "RGB":
        image = image.convert("RGB")
    w, h = image.size
    # torchvision Resize(size): the short side goes to `size`, the long
    # side TRUNCATES (int(size * long / short)); parity-critical.
    if w <= h:
        new_w, new_h = size, int(size * h / w)
    else:
        new_w, new_h = int(size * w / h), size
    image = image.resize((new_w, new_h), Image.BICUBIC)
    left = int(round((new_w - size) / 2.0))
    top = int(round((new_h - size) / 2.0))
    image = image.crop((left, top, left + size, top + size))
    return np.asarray(image, dtype=np.uint8)


def pil_eval_transform(image, size: int = 224,
                       mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    """PIL image -> float32 HWC array, reference-eval-compatible."""
    arr = pil_eval_uint8(image, size).astype(np.float32) / 255.0
    arr = (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return arr


def normalize_uint8(images_u8: torch.Tensor, mean=IMAGENET_MEAN,
                    std=IMAGENET_STD) -> torch.Tensor:
    """/255 + mean/std normalize of a uint8 ``[..., 3]`` tensor in fp32,
    in :func:`pil_eval_transform`'s op order."""
    dev = images_u8.device
    x = images_u8.to(torch.float32) / 255.0
    return (x - torch.tensor(mean, dtype=torch.float32, device=dev)) \
        / torch.tensor(std, dtype=torch.float32, device=dev)


def dataset_normalizer(dataset):
    """Input stage matching what ``dataset`` emits: uint8-boundary
    datasets (``emits_uint8``) are normalized with the stats they were
    built with; fp32 datasets, already normalized on the host, pass
    through."""
    if getattr(dataset, "emits_uint8", False):
        mean = tuple(getattr(dataset, "mean", IMAGENET_MEAN))
        std = tuple(getattr(dataset, "std", IMAGENET_STD))
        return functools.partial(normalize_uint8, mean=mean, std=std)
    return lambda x: x

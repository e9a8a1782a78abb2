"""Eval datasets, the zero-shot subset of ``msclip_tpu/data/datasets.py``.

``ImageFolderDataset`` (torchvision ``ImageFolder`` semantics, PIL decode)
and ``SyntheticImageDataset``. Each yields ``(np.float32 HWC image, label)``.
"""

from __future__ import annotations

import functools
import os
from typing import List

import numpy as np

from .transforms import IMAGENET_MEAN, IMAGENET_STD, pil_eval_transform

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp", ".tif",
                  ".tiff")


def _load_image(path):
    from PIL import Image, ImageFile

    # tolerate truncated files like the reference (tools/zero_shot.py:32-33)
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    return Image.open(path).convert("RGB")


def scan_image_folder(root: str):
    """Sorted class subdirectories, images sorted within class. Returns
    ``([(path, label)], classes)``; raises on an empty tree, so that a
    mislaid ROOT never gives a silent 0-image eval."""
    classes = sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d))
    )
    if not classes:
        raise FileNotFoundError(f"No class directories under {root}")
    samples: List = []
    for idx, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(IMG_EXTENSIONS):
                samples.append((os.path.join(cdir, fname), idx))
    if not samples:
        raise FileNotFoundError(
            f"No images under {root} (classes: {classes[:5]}...) — "
            "expected <class>/<image> ImageFolder layout"
        )
    return samples, classes


class ImageFolderDataset:
    """One subdirectory per class, classes sorted lexicographically, images
    sorted within class, decoded with PIL."""

    def __init__(self, root: str, image_size: int = 224, mean=IMAGENET_MEAN,
                 std=IMAGENET_STD):
        self.root = root
        self.transform = functools.partial(
            pil_eval_transform, size=image_size, mean=tuple(mean),
            std=tuple(std))
        self.samples, self.classes = scan_image_folder(root)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        path, label = self.samples[i]
        return self.transform(_load_image(path)), label


class SyntheticImageDataset:
    """Deterministic random images: the stand-in when no dataset is on
    disk. Sample ``i`` draws from ``numpy.random.default_rng(i)``, as in
    the JAX package (seed 0), so both packages see the same images."""

    def __init__(self, n: int = 256, size: int = 224, n_classes: int = 1000):
        self.n = n
        self.size = size
        self.n_classes = n_classes

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        img = rng.standard_normal((self.size, self.size, 3)).astype(np.float32)
        return img, int(rng.integers(0, self.n_classes))

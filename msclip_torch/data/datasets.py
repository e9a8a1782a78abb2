"""Eval datasets, the port of ``msclip_tpu/data/datasets.py``.

``ImageFolderDataset`` (torchvision ``ImageFolder`` semantics, PIL decode),
the reference's three custom datasets (``lib/evaluation/dataset.py``:
``Voc2007Classification`` :11-69, ``HatefulMemes`` :72-116, ``ChestXRay8``
:119-179) with the same annotation parsing, and ``SyntheticImageDataset``.
Each yields ``(np.float32 HWC image, label)``. The JAX package's native C++
decoder (``MSCLIP_NATIVE_DECODE``) is not ported (ROADMAP M14).
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Optional, Sequence

import numpy as np

from .transforms import pil_eval_transform

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp", ".tif",
                  ".tiff")


def _load_image(path):
    from PIL import Image, ImageFile

    # tolerate truncated files like the reference (tools/zero_shot.py:32-33)
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    return Image.open(path).convert("RGB")


def scan_image_folder(root: str, skip: Sequence[str] = ()):
    """Sorted class subdirectories (but those in ``skip``), images sorted
    within class. Returns ``([(path, label)], classes)``; raises on an
    empty tree, so that a mislaid ROOT never gives a silent 0-image
    eval."""
    classes = sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d)) and d not in skip
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
    sorted within class, decoded with PIL and passed through ``transform``
    (default: the eval transform at 224 px with the ImageNet statistics)."""

    def __init__(self, root: str, transform: Optional[Callable] = None):
        self.root = root
        self.transform = transform or pil_eval_transform
        self.samples, self.classes = scan_image_folder(root)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        path, label = self.samples[i]
        return self.transform(_load_image(path)), label


class Voc2007Classification:
    """PASCAL VOC2007 multilabel classification (20 classes)."""

    CATEGORIES = [
        "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
        "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
        "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
    ]

    def __init__(self, data_root: str, image_set: str = "train",
                 transform: Optional[Callable] = None):
        # the reference's roots, its "VOCdevkit 2" included
        if image_set in ("train", "val"):
            data_root += "train/VOCdevkit/VOC2007"
        elif image_set == "test":
            data_root += "test/VOCdevkit 2/VOC2007"
        else:
            raise ValueError("Incorrect image set!")
        self.data_root = data_root
        self.transform = transform or pil_eval_transform
        self.labels = self._read_annotation(image_set)
        self.images = list(self.labels.keys())

    def _read_annotation(self, image_set):
        folder = os.path.join(self.data_root, "ImageSets/Main/")
        files = [f for f in os.listdir(folder)
                 if f.endswith("_" + image_set + ".txt")]
        labels_all = {}
        for file_name in files:
            label_int = self.CATEGORIES.index(file_name.split("_")[0])
            with open(os.path.join(folder, file_name)) as f:
                for line in f.readlines():
                    index = line[:6]
                    labels_all.setdefault(index, [0] * len(self.CATEGORIES))
                    # "-1" marks a negative example; " 1" / " 0" positive
                    if not (line[7:9] and int(line[7:9]) != 1):
                        labels_all[index][label_int] = 1
        return labels_all

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        name = self.images[i]
        path = os.path.join(self.data_root, "JPEGImages", name + ".jpg")
        label = np.asarray(self.labels[name], np.int64)
        return self.transform(_load_image(path)), label


class HatefulMemes:
    """Facebook Hateful Memes binary classification from jsonl."""

    def __init__(self, data_root: str, image_set: str = "train",
                 transform: Optional[Callable] = None):
        self.data_root = data_root
        self.transform = transform or pil_eval_transform
        name = {"train": "train.jsonl", "val": "dev_seen.jsonl"}.get(image_set)
        if name is None:
            raise ValueError(f"Incorrect image_set value: {image_set}!")
        self.records = []
        with open(os.path.join(data_root, name)) as f:
            for line in f.readlines():
                r = json.loads(line)
                self.records.append(
                    {"image_file": r["img"], "text": r["text"],
                     "label": r["label"]})

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i):
        r = self.records[i]
        path = os.path.join(self.data_root, r["image_file"])
        return self.transform(_load_image(path)), r["label"]


class ChestXRay8:
    """ChestX-ray8 14-way multilabel classification from the CSV index."""

    CATEGORIES = [
        "Atelectasis", "Cardiomegaly", "Consolidation", "Edema", "Effusion",
        "Emphysema", "Fibrosis", "Hernia", "Infiltration", "Mass", "Nodule",
        "Pleural_Thickening", "Pneumonia", "Pneumothorax", "No Finding",
    ]

    def __init__(self, data_root: str, image_set: str = "train",
                 transform: Optional[Callable] = None):
        self.data_root = data_root
        self.transform = transform or pil_eval_transform
        split = {"train": "train_val_list.txt",
                 "test": "test_list.txt"}.get(image_set)
        if split is None:
            raise ValueError("Incorrect image set!")
        self.labels = self._read_annotation()
        with open(os.path.join(data_root, split)) as f:
            self.images = [ln.strip() for ln in f.readlines() if ln.strip()]

    def _read_annotation(self):
        path = os.path.join(self.data_root, "Data_Entry_2017_v2020.csv")
        image2labels = {}
        with open(path) as f:
            for i, line in enumerate(f.readlines()):
                if i == 0:
                    continue
                parts = line.split(",")
                image_name, labels_raw = parts[0], parts[1]
                labels_int = [0] * (len(self.CATEGORIES) - 1)
                for label in labels_raw.split("|"):
                    if label != "No Finding":
                        labels_int[self.CATEGORIES.index(label)] = 1
                image2labels[image_name] = labels_int
        return image2labels

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        name = self.images[i]
        path = os.path.join(self.data_root, "images", name)
        label = np.asarray(self.labels[name], np.int64)
        return self.transform(_load_image(path)), label


class SyntheticImageDataset:
    """Deterministic random images: the stand-in when no dataset is on
    disk. Sample ``i`` draws from ``numpy.random.default_rng(seed + i)``,
    as in the JAX package, so both packages see the same images."""

    def __init__(self, n: int = 256, size: int = 224, n_classes: int = 1000,
                 seed: int = 0):
        self.n = n
        self.size = size
        self.n_classes = n_classes
        self._rng_seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(self._rng_seed + i)
        img = rng.standard_normal((self.size, self.size, 3)).astype(np.float32)
        return img, int(rng.integers(0, self.n_classes))

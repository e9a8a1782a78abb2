"""Image-text retrieval dataset loaders (Karpathy splits), a copy of
``msclip_tpu/data/retrieval_datasets.py``.

Flickr30k / COCO retrieval use the standard Karpathy JSON annotation
(``dataset_flickr30k.json`` / ``dataset_coco.json``):

    {"images": [{"filename": ..., "filepath": <coco only>,
                 "split": "train|val|test|restval",
                 "sentences": [{"raw": ...}, ...]}, ...]}

``load_karpathy_split`` returns ``(image_dataset, captions,
caption_to_image)`` in the shape ``eval/retrieval.py:run_retrieval``
consumes. Not in the reference release (its eval is classification
only); part of the capability surface of the MS-CLIP paper's evaluation.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np

from .transforms import pil_eval_transform


class _RetrievalImages:
    """Image side of a retrieval corpus: list of paths + eval transform;
    labels are the image indices (so BatchLoader masks stay usable)."""

    def __init__(self, paths, transform=None):
        self.paths = list(paths)
        self.transform = transform or pil_eval_transform

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        from .datasets import _load_image

        return self.transform(_load_image(self.paths[i])), i


def load_karpathy_split(root: str, ann_file: str, split: str = "test",
                        transform: Optional[Callable] = None):
    """Parse a Karpathy annotation for one split.

    ``root``: image root (Flickr30k: the flat image dir; COCO: the dir
    containing ``train2014``/``val2014`` — each record's ``filepath``
    joins under it). ``restval`` records count as train (the standard
    Karpathy COCO convention).
    """
    with open(ann_file) as f:
        ann = json.load(f)
    want = {"train": ("train", "restval")}.get(split, (split,))
    paths, captions, cap2img = [], [], []
    for rec in ann["images"]:
        if rec["split"] not in want:
            continue
        rel = os.path.join(rec.get("filepath", ""), rec["filename"])
        idx = len(paths)
        paths.append(os.path.join(root, rel))
        for s in rec["sentences"]:
            captions.append(s["raw"])
            cap2img.append(idx)
    if not paths:
        raise ValueError(
            f"no images for split {split!r} in {ann_file}"
        )
    return (_RetrievalImages(paths, transform), captions,
            np.asarray(cap2img, np.int64))

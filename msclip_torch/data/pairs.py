"""Image-text pair datasets for contrastive training, the port of
``msclip_tpu/data/pairs.py``.

* ``TsvPairDataset``: tab-separated ``image_path<TAB>caption`` lists
  (``DATASET.TRAIN_TSV_LIST``; paths relative to the TSV's directory or
  absolute);
* ``FolderPairDataset``: a directory of images with ``.txt`` caption
  sidecars (``DATASET.ROOT/TRAIN_SET``);
* ``TarShardPairDataset`` (``shards.py``): WebDataset tar shards
  (``DATASET.TRAIN_SHARD_LIST``);
* ``SyntheticPairDataset``: deterministic random pairs, with the same numpy
  draws per index as the JAX package's.

All yield ``(float32 HWC image, int32 [context_length] tokens)``.
``make_train_dataset`` gives the real datasets the training transform
(RandomResizedCrop over ``AUG.SCALE``/``AUG.RATIO``, bilinear, flip,
normalize), whose draws come from a thread-local stream of
``MSCLIP_SEED`` (:func:`_worker_rng`); a bare dataset takes the eval
transform. Under ``MSCLIP_NATIVE_DECODE=1`` JPEGs take the native C++
pipeline (``msclip_torch.native.decode_train``: the same crop and flip
semantics with bicubic resampling, seeded from the same stream), with
``MSCLIP_DCT_SCALE=1`` at a reduced IDCT scale; anything else, and a JPEG
the pipeline cannot decode, takes PIL.
"""

from __future__ import annotations

import functools
import io
import os
import threading
from typing import List, Optional

import numpy as np

from .datasets import IMG_EXTENSIONS, _load_image
from .tokenizer import ClipTokenizer
from .transforms import pil_eval_transform, pil_train_transform

_RNG_LOCAL = threading.local()
_RNG_SS = np.random.SeedSequence(
    int(os.environ["MSCLIP_SEED"]) if os.environ.get("MSCLIP_SEED") else None)
_RNG_SS_LOCK = threading.Lock()


def _worker_rng() -> np.random.Generator:
    """The calling thread's Generator for augmentation draws: each loader
    thread spawns one child stream of a shared SeedSequence (seeded by
    ``MSCLIP_SEED`` when set, OS entropy otherwise) and reuses it, so no
    sample pays for a fresh PRNG. Which sample gets which draw depends on
    the threads' timing."""
    rng = getattr(_RNG_LOCAL, "rng", None)
    if rng is None:
        with _RNG_SS_LOCK:
            rng = np.random.default_rng(_RNG_SS.spawn(1)[0])
        _RNG_LOCAL.rng = rng
    return rng


def _native_train_decode(path: str, size, mean, std, scale, ratio, hflip_p,
                         rng=None):
    """The native training decode of the JPEG at ``path`` under
    ``MSCLIP_NATIVE_DECODE=1`` (``msclip_tpu/data/pairs.py:56-88``).
    Returns ``(image or None, bytes or None)``: None for the image where
    the native path does not apply or fails, and then the bytes already
    read, so that the PIL fallback does not read the file again. The
    library and the extension are checked first, and the seed is drawn
    (from ``rng``, else :func:`_worker_rng`) only for JPEG bytes."""
    if os.environ.get("MSCLIP_NATIVE_DECODE") != "1":
        return None, None
    from .. import native as N

    if not N.native_available():
        return None, None
    if not path.lower().endswith((".jpg", ".jpeg")):
        return None, None
    with open(path, "rb") as f:
        data = f.read()
    if not N.is_jpeg(data):
        return None, data
    seed = int((rng if rng is not None else _worker_rng()).integers(
        1, 2 ** 63))
    img = N.decode_train(
        data, size, mean, std, seed=seed, scale=scale, ratio=ratio,
        hflip_p=hflip_p, dct_scale=os.environ.get("MSCLIP_DCT_SCALE") == "1")
    return img, data


def open_tolerant(data: bytes):
    """A PIL image of ``data`` that tolerates a truncated JPEG (as
    ``datasets._load_image``; the native decoder rejects one, which is how
    it reaches PIL), so that one bad file does not stop a run."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    return Image.open(io.BytesIO(data))


def _image_of(transform, path):
    """``transform`` applied to the image at ``path``: the path itself for
    a transform that ``takes_path``, else the PIL image."""
    if getattr(transform, "takes_path", False):
        return transform(path)
    return transform(_load_image(path))


class TsvPairDataset:
    def __init__(self, tsv_paths: List[str], tokenizer: ClipTokenizer,
                 context_length: int = 77, transform=None):
        self.tokenizer = tokenizer
        self.context_length = context_length
        self.transform = transform or pil_eval_transform
        self.entries = []
        for tsv in tsv_paths:
            base = os.path.dirname(os.path.abspath(tsv))
            with open(tsv) as f:
                for line in f:
                    line = line.rstrip("\n")
                    if not line:
                        continue
                    path, caption = line.split("\t", 1)
                    if not os.path.isabs(path):
                        path = os.path.join(base, path)
                    self.entries.append((path, caption))

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        path, caption = self.entries[i]
        image = _image_of(self.transform, path)
        tokens = self.tokenizer([caption], self.context_length)[0]
        return image, tokens


class FolderPairDataset:
    """``<root>/xxx.jpg`` + ``<root>/xxx.txt`` caption sidecars."""

    def __init__(self, root: str, tokenizer: ClipTokenizer,
                 context_length: int = 77, transform=None):
        self.root = root
        self.tokenizer = tokenizer
        self.context_length = context_length
        self.transform = transform or pil_eval_transform
        self.items = []
        for fname in sorted(os.listdir(root)):
            if fname.lower().endswith(IMG_EXTENSIONS):
                txt = os.path.join(root, os.path.splitext(fname)[0] + ".txt")
                if os.path.exists(txt):
                    self.items.append((os.path.join(root, fname), txt))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        img_path, txt_path = self.items[i]
        with open(txt_path) as f:
            caption = f.read().strip()
        image = _image_of(self.transform, img_path)
        tokens = self.tokenizer([caption], self.context_length)[0]
        return image, tokens


class SyntheticPairDataset:
    """Deterministic random pairs: sample ``i`` draws from
    ``numpy.random.default_rng(seed + i)`` a normal image and a token row
    ``[sot, n - 1 random ids, eot, 0 ...]``."""

    def __init__(self, n: int = 1024, size: int = 224,
                 context_length: int = 77, vocab_size: int = 49408,
                 seed: int = 0):
        self.n = n
        self.size = size
        self.context_length = context_length
        self.vocab_size = vocab_size
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(self.seed + i)
        image = rng.standard_normal(
            (self.size, self.size, 3)).astype(np.float32)
        tokens = np.zeros(self.context_length, np.int32)
        n = int(rng.integers(4, min(24, self.context_length - 1)))
        tokens[0] = self.vocab_size - 2
        tokens[1:n] = rng.integers(1, self.vocab_size - 2, n - 1)
        tokens[n] = self.vocab_size - 1
        return image, tokens


def make_train_transform(config, rng=None):
    """The training transform: RandomResizedCrop(``AUG.SCALE``,
    ``AUG.RATIO``) at ``TRAIN.IMAGE_SIZE`` + flip + normalize with
    ``INPUT.MEAN``/``STD``. It takes a path (``takes_path``: the pair
    datasets hand it theirs, so that the native pipeline decodes the raw
    bytes under ``MSCLIP_NATIVE_DECODE=1``) or a PIL image (bilinear, in
    PIL). Draws from ``rng`` when given (a ``numpy.random.Generator``; one
    thread), else from :func:`_worker_rng`. Tar-shard members take
    ``shards.make_shard_train_transform``, which feeds the native decoder
    their bytes."""
    size = config.TRAIN.IMAGE_SIZE[0]
    mean, std = tuple(config.INPUT.MEAN), tuple(config.INPUT.STD)
    scale, ratio = tuple(config.AUG.SCALE), tuple(config.AUG.RATIO)
    fn = functools.partial(pil_train_transform, size=size, mean=mean,
                           std=std, scale=scale, ratio=ratio)

    def transform(src):
        draws = rng if rng is not None else _worker_rng()
        if isinstance(src, str):
            img, data = _native_train_decode(src, size, mean, std, scale,
                                             ratio, 0.5, rng)
            if img is not None:
                return img
            src = open_tolerant(data) if data is not None \
                else _load_image(src)
        return fn(src, rng=draws)

    transform.takes_path = True
    return transform


def make_train_dataset(config, tokenizer: Optional[ClipTokenizer] = None):
    """The training pairs the config names, checked in this order:
    ``DATASET.TRAIN_SHARD_LIST``, ``DATASET.TRAIN_TSV_LIST``, ``DATASET
    synthetic``, else the folder ``DATASET.ROOT/TRAIN_SET``."""
    ctx = config.MODEL.SPEC.TEXT.get("CONTEXT_LENGTH", 77)
    shards = config.DATASET.get("TRAIN_SHARD_LIST", [])
    if shards:
        from .shards import TarShardPairDataset, make_shard_train_transform

        return TarShardPairDataset(
            shards, tokenizer or ClipTokenizer(), ctx,
            transform=make_shard_train_transform(config))
    tsvs = config.DATASET.get("TRAIN_TSV_LIST", [])
    if tsvs:
        return TsvPairDataset(tsvs, tokenizer or ClipTokenizer(), ctx,
                              transform=make_train_transform(config))
    if config.DATASET.DATASET == "synthetic":
        return SyntheticPairDataset(
            n=config.DATASET.get("NUM_SAMPLES", 1024),
            size=config.TRAIN.IMAGE_SIZE[0], context_length=ctx,
            vocab_size=config.MODEL.SPEC.TEXT.get("VOCAB_SIZE", 49408))
    root = os.path.join(config.DATASET.ROOT, config.DATASET.TRAIN_SET)
    return FolderPairDataset(root, tokenizer or ClipTokenizer(), ctx,
                             transform=make_train_transform(config))

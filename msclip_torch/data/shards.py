"""Tar-shard image-text pairs (WebDataset layout), the port of
``msclip_tpu/data/shards.py``.

Each shard holds paired members ``<key>.jpg`` + ``<key>.txt``. One pass
over the tar headers (512-byte blocks; no image byte is read) records each
member's offset and size, cached beside the shard as ``<shard>.idx.npz``
(rebuilt when the shard's mtime or size changes; the cache format is the
JAX package's, so either package reads the other's). Samples are read with
``os.pread`` on one cached descriptor a shard, which is safe under the
loader's threads. The ``chunk`` sampler keeps reads sequential within a
shard while shuffling the chunk order.

Config: ``DATASET.TRAIN_SHARD_LIST`` (tar paths or globs), checked before
``TRAIN_TSV_LIST``. The training transform of a member is
:func:`make_shard_train_transform`, which takes its bytes (``takes_bytes``)
and decodes JPEGs natively under ``MSCLIP_NATIVE_DECODE=1``.
"""

from __future__ import annotations

import glob as _glob
import io
import os
import tarfile
import threading
from typing import List

import numpy as np

from .tokenizer import ClipTokenizer

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _index_shard(path: str):
    """``int64 [n, 4]``: (image offset, image size, text offset, text
    size) per sample key present with both members, keys sorted."""
    imgs, txts = {}, {}
    with tarfile.open(path, "r:") as tf:  # plain tar: members seekable
        for m in tf:
            if not m.isfile():
                continue
            key, ext = os.path.splitext(m.name)
            ext = ext.lower()
            if ext in _IMG_EXTS:
                imgs[key] = (m.offset_data, m.size)
            elif ext == ".txt":
                txts[key] = (m.offset_data, m.size)
    keys = sorted(k for k in imgs if k in txts)
    rec = np.zeros((len(keys), 4), np.int64)
    for i, k in enumerate(keys):
        rec[i] = (*imgs[k], *txts[k])
    return rec


def _cached_index(path: str):
    cache = path + ".idx.npz"
    st = os.stat(path)
    if os.path.exists(cache):
        try:
            z = np.load(cache, allow_pickle=False)
            if (int(z["mtime"]) == int(st.st_mtime)
                    and int(z["size"]) == st.st_size):
                return z["rec"]
        except Exception:
            pass  # corrupt or stale cache: rebuild
    rec = _index_shard(path)
    try:
        np.savez(cache, rec=rec, mtime=int(st.st_mtime), size=st.st_size)
    except OSError:
        pass  # read-only data dir: the index stays in memory
    return rec


class TarShardPairDataset:
    """Image-text pairs from WebDataset-style tar shards."""

    def __init__(self, shard_paths: List[str], tokenizer: ClipTokenizer,
                 context_length: int = 77, transform=None):
        paths = []
        for p in shard_paths:
            paths.extend(sorted(_glob.glob(p)) if any(
                c in p for c in "*?[") else [p])
        if not paths:
            raise FileNotFoundError(f"no shards match {shard_paths}")
        self.paths = paths
        self.tokenizer = tokenizer
        self.context_length = context_length
        if transform is None:
            from .transforms import pil_eval_transform

            transform = pil_eval_transform
        self.transform = transform
        recs, shard_ids, starts = [], [], [0]
        for si, p in enumerate(paths):
            rec = _cached_index(p)
            recs.append(rec)
            shard_ids.append(np.full(len(rec), si, np.int32))
            starts.append(starts[-1] + len(rec))
        self.rec = np.concatenate(recs)
        self.shard_of = np.concatenate(shard_ids)
        self.chunk_starts = starts[:-1]  # shard boundaries
        self._fds = {}
        self._fd_lock = threading.Lock()

    def __len__(self):
        return len(self.rec)

    def _fd(self, si: int) -> int:
        fd = self._fds.get(si)
        if fd is None:
            with self._fd_lock:
                fd = self._fds.get(si)
                if fd is None:
                    fd = os.open(self.paths[si], os.O_RDONLY)
                    self._fds[si] = fd
        return fd

    def _read(self, si: int, off: int, size: int) -> bytes:
        return os.pread(self._fd(si), size, off)

    def __getitem__(self, i):
        io_, is_, to_, ts_ = (int(v) for v in self.rec[i])
        si = int(self.shard_of[i])
        caption = self._read(si, to_, ts_).decode(
            "utf-8", errors="replace").strip()
        data = self._read(si, io_, is_)
        if getattr(self.transform, "takes_bytes", False):
            image = self.transform(data)
        else:
            from PIL import Image

            image = self.transform(Image.open(io.BytesIO(data)))
        tokens = self.tokenizer([caption], self.context_length)[0]
        return image, tokens

    def __del__(self):
        for fd in getattr(self, "_fds", {}).values():
            try:
                os.close(fd)
            except OSError:
                pass


def make_shard_train_transform(config):
    """The training transform of a shard member's bytes (``takes_bytes``;
    ``msclip_tpu/data/shards.py:165-200``): under
    ``MSCLIP_NATIVE_DECODE=1`` the native RandomResizedCrop + flip +
    normalize (``native.decode_train``, seeded from
    :func:`.pairs._worker_rng`; ``MSCLIP_DCT_SCALE=1`` at a reduced IDCT
    scale), else, and for bytes the pipeline cannot decode, PIL's
    (``pairs.make_train_transform``'s, truncated JPEGs tolerated)."""
    from .pairs import _worker_rng, make_train_transform, open_tolerant

    size = config.TRAIN.IMAGE_SIZE[0]
    mean, std = tuple(config.INPUT.MEAN), tuple(config.INPUT.STD)
    scale, ratio = tuple(config.AUG.SCALE), tuple(config.AUG.RATIO)
    pil_fn = make_train_transform(config)

    def transform(data: bytes):
        if os.environ.get("MSCLIP_NATIVE_DECODE") == "1":
            from .. import native as N

            seed = int(_worker_rng().integers(1, 2 ** 63))
            img = N.decode_train(
                data, size, mean, std, seed=seed, scale=scale, ratio=ratio,
                hflip_p=0.5,
                dct_scale=os.environ.get("MSCLIP_DCT_SCALE") == "1")
            if img is not None:
                return img
        return pil_fn(open_tolerant(data))

    transform.takes_bytes = True
    return transform

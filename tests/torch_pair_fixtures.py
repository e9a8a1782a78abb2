"""Image-text pair fixtures in each training format's public layout, for
the port's data tests and ``chip_smoke.py`` (numpy and PIL only): a caption folder (``<key>.jpg`` + ``<key>.txt``), a
TSV list (``path<TAB>caption``, paths relative to the TSV) and WebDataset
tar shards (``<key>.jpg`` + ``<key>.txt`` members). Images are JPEG blocks
of random colour and size; captions come from a fixed word list."""

import io
import os
import tarfile

import numpy as np

WORDS = ("a", "photo", "of", "dog", "cat", "red", "blue", "harbour",
         "kitchen", "mountain", "small", "large", "bicycle", "market")


def pair(rng, min_px=40, max_px=100, block=8):
    """(JPEG bytes, caption) with sides drawn in ``[min_px, max_px]``, in
    colour blocks of ``block`` px."""
    from PIL import Image

    h, w = (int(v) for v in rng.integers(min_px, max_px + 1, 2))
    arr = np.kron(rng.random((-(-h // block), -(-w // block), 3)),
                  np.ones((block, block, 1)))[:h, :w]
    buf = io.BytesIO()
    Image.fromarray((arr * 255).astype(np.uint8)).save(buf, format="JPEG")
    caption = " ".join(rng.choice(WORDS, int(rng.integers(3, 9))))
    return buf.getvalue(), caption


def write_folder(root, n, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        data, caption = pair(rng)
        with open(os.path.join(root, f"{i:05d}.jpg"), "wb") as f:
            f.write(data)
        with open(os.path.join(root, f"{i:05d}.txt"), "w") as f:
            f.write(caption)
    return root


def write_tsv(root, n, seed=0, **pair_kw):
    """``root/images/*.jpg`` and ``root/pairs.tsv``; returns the TSV.
    ``pair_kw`` goes to :func:`pair`."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    lines = []
    for i in range(n):
        data, caption = pair(rng, **pair_kw)
        with open(os.path.join(root, "images", f"{i:05d}.jpg"), "wb") as f:
            f.write(data)
        lines.append(f"images/{i:05d}.jpg\t{caption}\n")
    tsv = os.path.join(root, "pairs.tsv")
    with open(tsv, "w") as f:
        f.writelines(lines)
    return tsv


def write_shards(root, n_shards, per_shard, seed=0, **pair_kw):
    """``root/shard-<k>.tar``; returns their paths. ``pair_kw`` goes to
    :func:`pair`."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    paths = []
    for s in range(n_shards):
        path = os.path.join(root, f"shard-{s:03d}.tar")
        with tarfile.open(path, "w") as tf:
            for i in range(per_shard):
                data, caption = pair(rng, **pair_kw)
                for ext, blob in ((".jpg", data),
                                  (".txt", caption.encode())):
                    info = tarfile.TarInfo(f"{s:03d}{i:05d}{ext}")
                    info.size = len(blob)
                    tf.addfile(info, io.BytesIO(blob))
        paths.append(path)
    return paths

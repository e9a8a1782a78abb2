"""Image-text pair datasets for contrastive training, the synthetic part of
``msclip_tpu/data/pairs.py``.

``SyntheticPairDataset`` yields ``(float32 HWC image, int32
[context_length] tokens)`` with the same numpy draws per index as the JAX
package's. The folder, TSV and tar-shard pair datasets with their training
transforms wait for a later slice (ROADMAP M12).
"""

from __future__ import annotations

import numpy as np


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


def make_train_dataset(config):
    """The training pairs ``DATASET.DATASET synthetic`` names; every other
    source raises."""
    for key in ("TRAIN_SHARD_LIST", "TRAIN_TSV_LIST"):
        if config.DATASET.get(key, []):
            raise NotImplementedError(
                f"DATASET.{key}: the tar-shard and TSV pair datasets are not "
                "ported to msclip_torch yet (ROADMAP M12); use msclip_tpu")
    if config.DATASET.DATASET != "synthetic":
        raise NotImplementedError(
            f"training on DATASET.DATASET {config.DATASET.DATASET!r} (folder "
            "pairs with the training transforms) is not ported to "
            "msclip_torch yet (ROADMAP M12); use 'synthetic' or msclip_tpu")
    return SyntheticPairDataset(
        n=config.DATASET.get("NUM_SAMPLES", 1024),
        size=config.TRAIN.IMAGE_SIZE[0],
        context_length=config.MODEL.SPEC.TEXT.get("CONTEXT_LENGTH", 77),
        vocab_size=config.MODEL.SPEC.TEXT.get("VOCAB_SIZE", 49408),
    )

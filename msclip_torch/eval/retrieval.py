"""Image-text retrieval evaluation, recall@K (port of
``msclip_tpu/eval/retrieval.py``).

The CLIP-family protocol of Flickr30k and COCO: encode all images and
captions, rank by cosine similarity in both directions, report R@1/5/10.
"""

from __future__ import annotations

import logging
from typing import Dict, Sequence

import numpy as np
import torch

from ..data import ClipTokenizer
from ..data.loader import BatchLoader
from ..data.transforms import dataset_normalizer
from ..models.msclip import MSClipModel


@torch.inference_mode()
def encode_corpus(model: MSClipModel, image_dataset, captions: Sequence[str],
                  tokenizer=None, batch_size=256, workers=8):
    """Encode all images and captions -> ``(img_feats [N, E], txt_feats
    [M, E])``, float32. Captions go through the text tower in chunks of
    ``batch_size``, the last padded by repeating row 0 (one shape for
    every chunk, as the JAX package)."""
    tokenizer = tokenizer or ClipTokenizer()
    device = next(model.buffers()).device
    pre = dataset_normalizer(image_dataset)

    feats = []
    for batch in BatchLoader(image_dataset, batch_size, workers=workers):
        images = torch.from_numpy(batch["image"]).to(device)
        f = model.encode_image(pre(images)).float().cpu().numpy()
        feats.append(f[batch["mask"]])
    img_feats = np.concatenate(feats)

    tokens = tokenizer(list(captions), model.spec.context_length)
    pad = (-len(tokens)) % batch_size
    if pad:  # repeat row 0: always long enough, even for tiny caption sets
        tokens = np.concatenate([tokens, np.repeat(tokens[:1], pad, axis=0)])
    tokens = torch.from_numpy(tokens)
    tfeats = [model.encode_text(tokens[i:i + batch_size].to(device))
              .float().cpu().numpy()
              for i in range(0, len(tokens), batch_size)]
    txt_feats = np.concatenate(tfeats)[:len(captions)]
    return img_feats, txt_feats


def recall_at_k(similarity: np.ndarray, gt_index: np.ndarray,
                ks=(1, 5, 10)) -> Dict[int, float]:
    """similarity [Q, C]; gt_index [Q] ground-truth column per query row."""
    order = np.argsort(-similarity, axis=1)
    ranks = np.argmax(order == gt_index[:, None], axis=1)
    return {k: 100.0 * float((ranks < k).mean()) for k in ks}


def run_retrieval(model: MSClipModel, image_dataset, captions: Sequence[str],
                  caption_to_image: Sequence[int], batch_size=256, workers=8,
                  ks=(1, 5, 10)):
    """Bidirectional retrieval; ``caption_to_image[m]`` is the image index
    caption ``m`` describes. Returns ``{'i2t': {k: R@k}, 't2i': {k:
    R@k}}``."""
    img_feats, txt_feats = encode_corpus(
        model, image_dataset, captions, batch_size=batch_size,
        workers=workers)
    sim = img_feats @ txt_feats.T  # [N, M]
    cap2img = np.asarray(caption_to_image)

    # text -> image: rank images per caption; gt is its image
    t2i = recall_at_k(sim.T, cap2img, ks)

    # image -> text: rank captions per image; an image may have several
    # captions, and the best-ranked one counts
    order = np.argsort(-sim, axis=1)  # [N, M]
    hit_matrix = cap2img[order] == np.arange(sim.shape[0])[:, None]
    first_hit = np.argmax(hit_matrix, axis=1)
    i2t = {k: 100.0 * float((first_hit < k).mean()) for k in ks}

    logging.info(f"=> retrieval i2t: {i2t}  t2i: {t2i}")
    return {"i2t": i2t, "t2i": t2i}

"""Image-text retrieval CLI of the port (Flickr30k / COCO, Karpathy
splits; the JAX package's ``tools/retrieval.py``).

    python -m msclip_torch.tools.retrieval --model <model.yaml|json> \\
        --ann DATASET/flickr30k/dataset_flickr30k.json \\
        --images DATASET/flickr30k/images [--split test] \\
        [--device cuda|cpu] [KEY VALUE ...]

Encodes the split's images and captions (BN folded unless
``TPU.FOLD_BN False``) and reports bidirectional recall@{1,5,10}.
"""

from __future__ import annotations

import argparse
import functools
import logging

from ..config import get_default_config, update_config
from ..data.retrieval_datasets import load_karpathy_split
from ..data.transforms import pil_eval_transform
from ..eval.retrieval import run_retrieval
from ..eval.zero_shot import load_eval_model, resolve_device
from ..models.msclip import build_spec
from ..utils.logging import create_logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Image-text retrieval eval.")
    p.add_argument("--model", required=True, help="model configure file")
    p.add_argument("--ann", required=True, help="Karpathy json annotation")
    p.add_argument("--images", required=True, help="image root directory")
    p.add_argument("--split", default="test",
                   choices=["train", "val", "test"])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    config = get_default_config()
    update_config(config, args.model, opts=args.opts)
    config.NAME = ""
    create_logger(config, args.model, f"retrieval_{args.split}")

    model = load_eval_model(config, build_spec(config), device, int8=False)
    transform = functools.partial(
        pil_eval_transform, size=config.TEST.IMAGE_SIZE[0],
        mean=tuple(config.INPUT.MEAN), std=tuple(config.INPUT.STD))
    images, captions, cap2img = load_karpathy_split(
        args.images, args.ann, split=args.split, transform=transform)
    logging.info(f"=> retrieval {args.split}: {len(images)} images, "
                 f"{len(captions)} captions")
    out = run_retrieval(model, images, captions, cap2img,
                        batch_size=config.TEST.BATCH_SIZE_PER_GPU,
                        workers=config.WORKERS)
    i2t, t2i = out["i2t"], out["t2i"]
    print("RESULT retrieval "
          f"i2t_r1={i2t[1]:.2f} i2t_r5={i2t[5]:.2f} i2t_r10={i2t[10]:.2f} "
          f"t2i_r1={t2i[1]:.2f} t2i_r5={t2i[5]:.2f} t2i_r10={t2i[10]:.2f}")
    return out


if __name__ == "__main__":
    main()

"""Feature extraction CLI of the port (the JAX package's
``tools/extract_features.py``).

    python -m msclip_torch.tools.extract_features --ds <dataset.yaml> \\
        --model <model.yaml|json> --out features.npz \\
        [--image-set train|test] [--device cuda|cpu] [KEY VALUE ...]

Dumps the L2-normalized image-tower features (float32) and labels of one
split to an ``.npz`` (``features``, ``labels``). BN is not folded, as in
the JAX tool: it runs in eval mode on the running statistics.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..config import get_default_config, update_config
from ..eval.linear_probe import extract_features
from ..eval.zero_shot import load_eval_model, make_dataset, resolve_device
from ..models.msclip import build_spec
from ..utils.logging import create_logger
from ..utils.platform import apply_platform_override


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Extract image features.")
    p.add_argument("--ds", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--out", default="features.npz")
    p.add_argument("--image-set", default="test", choices=["train", "test"],
                   help="dataset split to featurize (probe protocols need "
                        "both)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu under "
                        "MSCLIP_PLATFORM=cpu)")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def main(argv=None):
    device = apply_platform_override()  # MSCLIP_PLATFORM, MSCLIP_DEBUG_NANS
    args = parse_args(argv)
    args.device = args.device or device
    device = resolve_device(args.device)
    config = get_default_config()
    update_config(config, args.ds)
    update_config(config, args.model, opts=args.opts)
    create_logger(config, args.model, "extract_features")

    model = load_eval_model(config, build_spec(config), device,
                            fold_bn=False, int8=False)
    dataset = make_dataset(config, image_set=args.image_set)
    feats, labels = extract_features(
        model, dataset, batch_size=config.TEST.BATCH_SIZE_PER_GPU,
        workers=config.WORKERS)
    np.savez(args.out, features=feats, labels=labels)
    print(f"RESULT saved {feats.shape} features to {args.out}")


if __name__ == "__main__":
    main()

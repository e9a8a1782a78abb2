"""Released-checkpoint verification of the port (the JAX package's
``tools/eval_released.py``).

    python -m msclip_torch.tools.eval_released --ckpt <released.pth> \\
        [--model b32-yfcc-msclips] [--imagenet <ImageNet-1K val dir>] \\
        [--tolerance 0.1] [--batch 256] [--device cuda|cpu]

* tier 1, always: strict conversion of the reference ``state_dict`` (every
  key known, every parameter present, aliased shared keys equal to their
  twins) and one forward of two images, finite and unit-norm;
* tier 2, with ``--imagenet``: zero-shot ImageNet-1K top-1 through
  ``run_zero_shot``; the exit status is non-zero unless it is within
  ``--tolerance`` of the published number (36.7 b32-yfcc, 39.0 b16-yfcc,
  40.2 b32-laion: the reference's headline table, its ``README.md:26-28``)
  on at least 49,000 images.

The model configs are the resolved ``msclip_torch/config/<model>.json``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

EXPECTED_TOP1 = {
    "b32-yfcc-msclips": 36.7,
    "b16-yfcc-msclips": 39.0,
    "b32-laion-msclips": 40.2,
}
CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "config")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True, help="released .pth path")
    ap.add_argument("--model", default="b32-yfcc-msclips",
                    choices=sorted(EXPECTED_TOP1))
    ap.add_argument("--imagenet", default=None,
                    help="ImageNet-1K val dir (ImageFolder layout); omit "
                         "for the convert+forward gate only")
    ap.add_argument("--tolerance", type=float, default=0.1)
    ap.add_argument("--batch", type=int,
                    default=int(os.environ.get("MSCLIP_EVAL_BATCH", "256")))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap.parse_args(argv)


def main(argv=None):
    from ..config import get_default_config, update_config
    from ..eval.zero_shot import load_eval_model, resolve_device, run_zero_shot
    from ..models.msclip import build_spec

    args = parse_args(argv)
    device = resolve_device(args.device)
    if not os.path.exists(args.ckpt):
        sys.exit(f"checkpoint not found: {args.ckpt}")
    cfg = get_default_config()
    update_config(cfg, os.path.join(CONFIG_DIR, args.model + ".json"))
    cfg.MODEL.PRETRAINED_MODEL = args.ckpt

    # tier 1: strict conversion + one forward
    spec = build_spec(cfg)
    model = load_eval_model(cfg, spec, device, fold_bn=False, int8=False)
    images = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, spec.image_resolution, spec.image_resolution, 3)).astype(
            np.float32)).to(device)
    with torch.inference_mode():
        feats = model.encode_image(images).float().cpu().numpy()
    if not np.isfinite(feats).all():
        sys.exit("non-finite embeddings")
    norms = np.linalg.norm(feats, axis=-1)
    if not np.allclose(norms, 1.0, atol=1e-3):
        sys.exit(f"embeddings not unit-norm: {norms}")
    print(f"[tier 1 OK] {args.ckpt}: state_dict fully consumed, forward "
          f"finite and unit-norm ({args.model}, {device})")

    if not args.imagenet:
        print("no --imagenet given; skipping the top-1 check "
              f"(published: {EXPECTED_TOP1[args.model]})")
        return

    val = args.imagenet.rstrip("/")
    if not os.path.isdir(val):
        sys.exit(f"ImageNet val dir not found: {val}")
    cfg.DATASET.DATASET = "imagenet"
    cfg.DATASET.ROOT = os.path.dirname(val)
    cfg.DATASET.TEST_SET = os.path.basename(val)
    cfg.TEST.BATCH_SIZE_PER_GPU = args.batch

    top1, stats = run_zero_shot(cfg, device=device)
    expected = EXPECTED_TOP1[args.model]
    delta = abs(top1 - expected)
    print(f"zero-shot IN-1K top-1 {top1:.2f} vs published {expected} "
          f"(|delta| {delta:.3f}, n={stats.get('n_images')})")
    if stats.get("n_images", 0) < 49000:
        sys.exit(f"val set incomplete: {stats.get('n_images')} images")
    if delta > args.tolerance:
        sys.exit(f"FAIL: top-1 {top1:.2f} outside +/-{args.tolerance} "
                 f"of {expected}")
    print("[tier 2 OK] matches the published number")


if __name__ == "__main__":
    main()

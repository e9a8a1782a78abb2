"""Export a model config (and its checkpoint) into a serving bundle: the
port's ``tools/export_serving.py``.

    python -m msclip_torch.tools.export_serving --model <model.yaml|json> \\
        --out <dir> [--buckets 1,4,16,64] [--classify-prompts imagenet] \\
        [--device cuda|cpu] [KEY VALUE ...]

The bundle (``MANIFEST.json`` with the resolved model spec, fp32
parameters with BN folded, and an optional prompt-ensemble classifier)
loads with ``msclip_torch.serve.load_bundle`` and serves under
``python -m msclip_torch.tools.serve --bundle <dir>``. ``TPU.INT8_EVAL`` is
ignored, as the JAX tool ignores it; ``TPU.USE_FUSED_BLOCK`` is kept in
the spec. ``--device`` runs the classifier's text encoding (``cuda``
unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import logging
import os

from ..config import get_default_config, update_config
from ..eval.zero_shot import resolve_device
from ..utils.platform import apply_platform_override


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export a serving bundle.")
    p.add_argument("--model", required=True, help="model config yaml/json")
    p.add_argument("--out", required=True, help="bundle output directory")
    p.add_argument("--buckets", default="1,4,16,64",
                   help="comma-separated static batch buckets")
    p.add_argument("--classify-prompts", default="",
                   help="prompt-set name (e.g. imagenet) to bake a "
                        "zero-shot classifier into the bundle")
    p.add_argument("--device", default=None,
                   help="torch device of the classifier build (default "
                        "cuda; cpu under MSCLIP_PLATFORM=cpu)")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def build_classifier(spec, params, prompts: str, device):
    """``(classifier [E, C] fp32 numpy, classnames)`` of a prompt set, from
    folded fp32 ``params`` cast to the spec's compute dtype on ``device``."""
    from ..data import ClipTokenizer, get_classnames, get_templates
    from ..eval.zero_shot import build_zeroshot_classifier
    from ..models.msclip import MSClipModel, cast_params

    classnames = get_classnames(prompts)
    templates = get_templates(prompts)
    logging.info(f"=> building classifier: {len(classnames)} classes "
                 f"x {len(templates)} templates")
    model = MSClipModel(spec, cast_params(params, spec.dtype)).to(device)
    weights, _ = build_zeroshot_classifier(model, ClipTokenizer(),
                                           classnames, templates)
    return weights.float().cpu().numpy(), classnames


def main(argv=None):
    device = apply_platform_override()  # MSCLIP_PLATFORM, MSCLIP_DEBUG_NANS
    args = parse_args(argv)
    args.device = args.device or device
    device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO)
    config = get_default_config()
    update_config(config, args.model, opts=args.opts)

    from ..eval.checkpoint_load import load_model_params
    from ..models.msclip import build_spec
    from ..serve.export import export_bundle, serving_params

    spec = build_spec(config)
    params = serving_params(spec, load_model_params(config, spec))
    classifier = classnames = None
    if args.classify_prompts:
        classifier, classnames = build_classifier(
            spec, params, args.classify_prompts, device)
    manifest = export_bundle(
        spec, params, args.out,
        buckets=[int(b) for b in args.buckets.split(",") if b],
        image_size=config.TEST.IMAGE_SIZE[0],
        classifier=classifier, classnames=classnames,
        mean=tuple(config.INPUT.MEAN), std=tuple(config.INPUT.STD),
    )
    n_bytes = sum(os.path.getsize(os.path.join(args.out, f))
                  for f in os.listdir(args.out))
    print(f"EXPORTED {args.out} buckets={manifest['buckets']} "
          f"bytes={n_bytes}", flush=True)
    return manifest


if __name__ == "__main__":
    main()

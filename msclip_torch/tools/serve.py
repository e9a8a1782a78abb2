"""Serve a model over HTTP with dynamic batching: the port's
``tools/serve.py``.

Bundle mode (a bundle written by ``msclip_torch.tools.export_serving``):

    python -m msclip_torch.tools.serve --bundle <dir> [--host 0.0.0.0] \\
        [--port 8000] [--max-wait-ms 5] [--device cuda|cpu]

Live mode (the model built in process from its config):

    python -m msclip_torch.tools.serve --model <model.yaml|json> \\
        [--classify-prompts imagenet] [--buckets 1,4,16,64] \\
        [--device cuda:0,cuda:1] [KEY VALUE ...]

In live mode ``--device`` may list several devices: each batch is split
across them (``serve/live.py``), the buckets rounded up to multiples of
their count. Without ``--device`` live mode serves over every visible card
(as the JAX CLI over every local chip); a bundle serves on one.

Before it accepts traffic it captures a CUDA graph per tower and bucket
(``cuda``, the default) and calls every bucket once; then it prints
``SERVING http://host:port``. Endpoints: POST /v1/embed/image (JPEG/PNG/npy
body), POST /v1/embed/text ({"texts": [...]}), POST /v1/classify?topk=5,
POST /v1/rank, GET /healthz, GET /stats. Scale out by running one process
per card behind any HTTP load balancer.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from ..eval.device import resolve_device
from ..utils.platform import apply_platform_override


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="HTTP inference server.")
    p.add_argument("--bundle", help="serving bundle dir (bundle mode)")
    p.add_argument("--model", help="model config yaml/json (live mode)")
    p.add_argument("--buckets", default="",
                   help="live mode: comma-separated batch buckets")
    p.add_argument("--classify-prompts", default="",
                   help="live mode: prompt-set name (e.g. imagenet) to "
                        "build a zero-shot classifier for /v1/classify")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="dynamic-batching window")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda, or cpu under "
                        "MSCLIP_PLATFORM=cpu; 'cpu' runs the plain "
                        "versions eagerly); live mode takes a comma-"
                        "separated list and defaults to every visible "
                        "card")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def load_live(args, devices):
    """A live ServingModel from a model config on ``devices`` (the
    classifier is built on the first)."""
    from ..config import get_default_config, update_config
    from ..eval.checkpoint_load import load_model_params
    from ..models.msclip import build_spec
    from ..serve import live_serving_model
    from ..serve.export import serving_params
    from .export_serving import build_classifier

    config = get_default_config()
    update_config(config, args.model, opts=args.opts)
    spec = build_spec(config)
    params = serving_params(spec, load_model_params(config, spec))
    classifier = classnames = None
    if args.classify_prompts:
        classifier, classnames = build_classifier(
            spec, params, args.classify_prompts, devices[0])
    buckets = [int(b) for b in args.buckets.split(",") if b] or None
    return live_serving_model(
        spec, params, buckets=buckets,
        image_size=config.TEST.IMAGE_SIZE[0],
        classifier=classifier, classnames=classnames,
        mean=tuple(config.INPUT.MEAN), std=tuple(config.INPUT.STD),
        devices=devices,
    )


def serving_devices(args, default):
    """The devices to serve on: ``--device``'s list; else, in live mode on
    the card, every visible card (``serve/live.local_devices``); else
    ``default`` (the platform's, one device)."""
    from ..serve.live import local_devices

    if args.device:
        return [resolve_device(d) for d in args.device.split(",")]
    if args.model and default == "cuda":
        return local_devices()
    return [resolve_device(default)]


def main(argv=None):
    device = apply_platform_override()  # MSCLIP_PLATFORM, MSCLIP_DEBUG_NANS
    args = parse_args(argv)
    if bool(args.bundle) == bool(args.model):
        raise SystemExit("pass exactly one of --bundle or --model")
    devices = serving_devices(args, device)
    if args.bundle and len(devices) > 1:
        raise SystemExit("a bundle serves on one device: run one server a "
                         "card, or --model for several devices")
    logging.basicConfig(level=logging.INFO)

    from ..serve import load_bundle
    from ..serve.server import InferenceServer

    if args.bundle:
        logging.info(f"=> loading bundle {args.bundle}")
        model = load_bundle(args.bundle, device=devices[0])
    else:
        logging.info(f"=> building live model from {args.model}")
        model = load_live(args, devices)
    # one call per bucket before traffic (on a card: each graph replayed)
    for b in model.buckets:
        model.encode_image(
            np.zeros((b, model.image_size, model.image_size, 3), np.uint8))
        model.encode_text(np.zeros((b, model.context_length), np.int32))
    logging.info(f"=> warmed {len(model.buckets)} image+text buckets")
    server = InferenceServer(model, host=args.host, port=args.port,
                             max_wait_ms=args.max_wait_ms)
    print(f"SERVING http://{server.address[0]}:{server.address[1]}",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.close()


if __name__ == "__main__":
    main()

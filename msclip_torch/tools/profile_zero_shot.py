"""Where the time of zero-shot MS-CLIP-S B/32 eval goes on one CUDA card.

    python -m msclip_torch.tools.profile_zero_shot [--iters 10]

At full B/32 width, random weights from a seed, bf16, BN folded, it times
on the device (CUDA events, after warm-up, inputs resident on the card):

* ``encode_image`` of a batch of 256 images at 224 px;
* ``encode_text`` of a chunk of 1024 prompts (the classifier build's unit);

then traces one call of each with ``torch.profiler`` and prints the device
time by kernel, the share of the attention kernel, and the device's idle
share of the traced window. Last, it runs ``run_zero_shot`` end to end on
2048 synthetic images. Each result is one JSON line on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from ..config import get_default_config, update_config
from ..data import ClipTokenizer, get_classnames, get_templates
from ..eval.zero_shot import load_eval_model, run_zero_shot
from ..models.msclip import build_spec

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "config", "b32-yfcc-msclips.json")


def emit(**kw):
    print(json.dumps(kw), flush=True)


def device_ms(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_breakdown(fn):
    """Device time per kernel over one traced call, and the idle share of
    the traced window (1 - summed kernel time / window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + us
    total = sum(kernels.values())
    attn = sum(v for k, v in kernels.items() if "attention_fwd" in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"window_us": window_us, "kernel_us": total,
            "idle_share": 1.0 - total / window_us if window_us else None,
            "attention_us": attn,
            "attention_share": attn / total if total else None,
            "top": [[k[:80], v] for k, v in top]}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_zero_shot needs a CUDA device")
    emit(card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())

    cfg = get_default_config()
    update_config(cfg, CONFIG, opts=["TPU.COMPUTE_DTYPE", "bfloat16",
                                     "MODEL.PRETRAINED_MODEL", ""])
    spec = build_spec(cfg)
    model = load_eval_model(cfg, spec, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn(256, 224, 224, 3, device="cuda", generator=gen)
    texts = [t.format(c) for c in get_classnames("imagenet")[:13]
             for t in get_templates("imagenet")][:1024]
    tokens = torch.from_numpy(ClipTokenizer()(texts)).cuda()

    with torch.inference_mode():
        for name, fn, n in (
                ("encode_image", lambda: model.encode_image(images), 256),
                ("encode_text", lambda: model.encode_text(tokens), 1024)):
            ms = device_ms(fn, args.iters)
            emit(phase=name, batch=n, ms=ms, items_per_s=n / ms * 1e3,
                 **kernel_breakdown(fn))

    cfg.merge_from_list(["DATASET.DATASET", "synthetic",
                         "DATASET.NUM_SAMPLES", 2048,
                         "TEST.BATCH_SIZE_PER_GPU", 256,
                         "TEST.SUBSET_CLASSES", 100])
    value, stats = run_zero_shot(cfg, device="cuda")
    emit(phase="run_zero_shot", top1=value, **stats)


if __name__ == "__main__":
    main()

"""Smoke run of the PyTorch/CUDA port (msclip_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line and each fatal on failure:

1. device and packages: the card's name and power limit, and which of the
   optional host packages (yaml, regex, PIL, ftfy) import;
2. build: compile every CUDA kernel of the zero-shot path from the sources
   in this checkout, and print what ``ptxas -v`` reports;
3. kernels: call each kernel's wrapper at the shapes the main path gives
   it, hold the result against its plain PyTorch version, and time the
   kernel, the plain version and the nearest PyTorch library call;
4. slice: zero-shot eval of MS-CLIP-S ViT-B/32 at full width through
   ``msclip_torch.eval.zero_shot.run_zero_shot`` (random weights from a
   seed, bf16, BN folded, synthetic images), with each kernel's launches
   counted over that run;
5. card against CPU: the same fp32 weights through both towers on the card
   (kernels) and on the CPU (plain versions).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from msclip_torch.ops import attention as A
from msclip_torch.ops import cuda_build

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense tensor-core bf16
              torch.float32: 67e12}    # fp32 outside the tensor cores
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
B32_CONFIG = os.path.join(REPO, "msclip_torch", "config",
                          "b32-yfcc-msclips.json")
L2_BYTES = 50 * 2 ** 20


def log(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def device_and_packages():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing to check")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    found = {}
    for mod in ("yaml", "regex", "PIL", "ftfy"):
        try:
            __import__(mod)
            found[mod] = True
        except ImportError:
            found[mod] = False
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0],
        packages=json.dumps(found))
    return smi


def build_kernels():
    t0 = time.time()
    path = cuda_build.build(A.SOURCE)
    with open(path + ".log") as f:
        report = sorted({ln.split(":", 1)[-1].strip() for ln in f
                         if "ptxas info" in ln and "Used" in ln})
    log("build", source=A.SOURCE, seconds=f"{time.time() - t0:.1f}",
        ptxas=json.dumps(report))


def cuda_ms(fn, n_inputs, iters=30, warmup=3):
    """Mean device time of ``fn(i)`` over ``iters`` calls, cycling
    through ``n_inputs`` input sets so that each call finds its inputs
    out of the L2 cache."""
    for i in range(warmup):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_inputs)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def attention_bound(B, L, E, H, dtype, mask):
    """``(ms, by)``: the least time for the attention function, the larger
    of its I/O (each input byte read once, each output byte written once)
    over the memory rate and its matrix work (the pairs this mask leaves:
    masked -inf pairs need no product) over the peak rate of ``dtype``."""
    item = torch.finfo(dtype).bits // 8
    nbytes = B * L * 4 * E * item + (0 if mask is None else L * L * 4)
    pairs = L * L if mask is None else int(torch.isfinite(mask).sum())
    flops = 4 * B * H * pairs * (E // H)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


ATTN_SHAPES = [  # (B, L, causal): image tower, text chunk, B/16, odd batch
    (256, 50, False), (1024, 77, True), (64, 197, False), (5, 77, True)]


def check_attention(E=768, H=12):
    from msclip_torch.models.layers import build_causal_mask

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, L, causal in ATTN_SHAPES:
        mask = build_causal_mask(L, device="cuda") if causal else None
        for dtype in (torch.float32, torch.bfloat16):
            item = torch.finfo(dtype).bits // 8
            n_inputs = max(1, math.ceil(2 * L2_BYTES / (B * L * 3 * E * item)))
            qkv = [torch.randn(B, L, 3 * E, device="cuda", generator=gen)
                   .to(dtype) for _ in range(n_inputs)]
            got = A.fused_attention_qkv(qkv[0], H, mask)
            want = A.attention_qkv_plain(qkv[0], H, mask)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not err <= TOL[dtype]:
                raise AssertionError(
                    f"attention kernel B={B} L={L} {dtype}: max |err| "
                    f"{err} > {TOL[dtype]}")
            heads = [t.view(B, L, 3, H, E // H).permute(2, 0, 3, 1, 4)
                     for t in qkv]
            row = {
                "B": B, "L": L, "causal": causal,
                "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": err,
                "ms": cuda_ms(lambda i: A.fused_attention_qkv(
                    qkv[i], H, mask), n_inputs),
                "plain_ms": cuda_ms(lambda i: A.attention_qkv_plain(
                    qkv[i], H, mask), n_inputs, iters=10),
                "library_ms": cuda_ms(
                    lambda i: torch.nn.functional.scaled_dot_product_attention(
                        heads[i][0], heads[i][1], heads[i][2],
                        is_causal=causal), n_inputs),
            }
            row["bound_ms"], row["bound_by"] = attention_bound(
                B, L, E, H, dtype, mask)
            log("kernel", name="attention_fwd", **row,
                bound_us=row["bound_ms"] * 1e3)
            rows.append(row)
            del qkv, heads
    return rows


def run_slice():
    """Zero-shot MS-CLIP-S B/32 at full width through the port's entry
    point, with the attention kernel's launches counted over the run."""
    from msclip_torch.config import get_default_config, update_config
    from msclip_torch.eval.zero_shot import run_zero_shot

    cfg = get_default_config()
    update_config(cfg, B32_CONFIG)
    cfg.merge_from_list([
        "DATASET.DATASET", "synthetic", "DATASET.NUM_SAMPLES", 512,
        "TEST.BATCH_SIZE_PER_GPU", 256, "TEST.SUBSET_CLASSES", 100,
        "TPU.COMPUTE_DTYPE", "bfloat16", "TPU.SEED", 0,
        "MODEL.PRETRAINED_MODEL", ""])
    torch.cuda.reset_peak_memory_stats()
    A.fused_attention_qkv.launches = 0
    value, stats = run_zero_shot(cfg, device="cuda")
    torch.cuda.synchronize()
    launches = A.fused_attention_qkv.launches
    expected = 11 * stats["n_image_batches"] + 12 * stats["n_text_chunks"]
    log("slice", model="b32-yfcc-msclips", dtype="bfloat16",
        top1=value, n_images=stats["n_images"],
        images_per_s=stats["images_per_sec"],
        classifier_s=stats["classifier_s"],
        image_batches=stats["n_image_batches"],
        text_chunks=stats["n_text_chunks"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
        attention_launches=launches)
    if stats["n_images"] != 512 or not 0.0 <= value <= 100.0:
        raise AssertionError(f"zero-shot run gave {value} on "
                             f"{stats['n_images']} images")
    if launches != expected or launches == 0:
        raise AssertionError(f"attention kernel launched {launches} times, "
                             f"expected 11 x {stats['n_image_batches']} "
                             f"image batches + 12 x {stats['n_text_chunks']} "
                             f"text chunks = {expected}")
    return launches


def card_against_cpu(atol=1e-3):
    """Full-width fp32 features of 8 images and 16 prompts: the card with
    its kernels against the CPU with the plain versions, same weights."""
    from msclip_torch.config import get_default_config, update_config
    from msclip_torch.data import ClipTokenizer, get_classnames, get_templates
    from msclip_torch.data.datasets import SyntheticImageDataset
    from msclip_torch.eval.zero_shot import load_eval_model
    from msclip_torch.models.msclip import build_spec

    cfg = get_default_config()
    update_config(cfg, B32_CONFIG, opts=["MODEL.PRETRAINED_MODEL", ""])
    spec = build_spec(cfg)  # fp32: also turns TF32 off
    ds = SyntheticImageDataset(n=8, size=spec.image_resolution)
    images = torch.from_numpy(np.stack([ds[i][0] for i in range(8)]))
    texts = [t.format(c) for c in get_classnames("imagenet")[:4]
             for t in get_templates("imagenet")[:4]]
    tokens = torch.from_numpy(ClipTokenizer()(texts))
    feats = {}
    for dev in ("cuda", "cpu"):
        model = load_eval_model(cfg, spec, dev)
        with torch.inference_mode():
            feats[dev] = (model.encode_image(images.to(dev)).cpu(),
                          model.encode_text(tokens.to(dev)).cpu())
    errs = [(a - b).abs().max().item()
            for a, b in zip(feats["cuda"], feats["cpu"])]
    log("card_vs_cpu", dtype="float32", image_err=errs[0], text_err=errs[1],
        atol=atol)
    if not all(math.isfinite(e) and e <= atol for e in errs):
        raise AssertionError(f"card and CPU features differ: {errs} > {atol}")


def kernel_line(rows, launches):
    """The per-kernel JSON entry: the headline row is the image tower's
    shape (B=256, L=50, bf16); every checked shape is under ``shapes``."""
    head = next(r for r in rows if r["L"] == 50 and r["dtype"] == "bfloat16")
    return {
        "name": "attention_fwd", "route": "cuda",
        "source": "msclip_torch/csrc/attention_fwd.cu",
        "replaces": "msclip_tpu/ops/attention.py:243",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": f"B={head['B']} L=50 E=768 H=12 bfloat16",
        "shapes": rows,
    }


def main():
    device_and_packages()
    build_kernels()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    attn_rows = check_attention()
    launches = run_slice()
    card_against_cpu()
    print(json.dumps({"kernels": [kernel_line(attn_rows, launches)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

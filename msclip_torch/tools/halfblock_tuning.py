"""Time the attention half-block's tuning variants on one CUDA card.

    python -m msclip_torch.tools.halfblock_tuning [--device cpu] \\
        [--batch 256] [--seq 50] [--width 768] [--dtype bfloat16] \\
        [--iters 32] [--tbs 8,16,32]

Port of ``experiments/halfblock_tuning.py``, the JAX package's tool for
tuning the fused half-block. Each row chains 11 layers of one attention
half (the script's ``bench``) on ``x + i 1e-6`` for ``i < K`` inputs, after
3 inputs of warm-up, and prints ``<name> <ms> ms/11-layers``: the mean time
of the 11 layers over the K inputs, from CUDA events on the card. With
``--device cpu`` every kernel takes its plain version and the time is the
host clock's, no device's. Unlike the script, it subtracts no round-trip
time (the script's 28 ms / K was its TPU connection's).

Rows: every E1 variant of the script (``make_attn_half``: v0, v1, v2, v3,
v2a, v2c) and E2 (``make_hybrid_b``) at each batch tile of ``--tbs`` and at
the default tile (``ops.halfblock_tuning.default_tb``: K5's group at the
dtype on the card, ``ops.block_fused.group_samples``, or the largest
divisor of B below it); then, as
references, K5 (``ops.block_fused.fused_attention_halfblock``) and the
unfused half (LayerNorm, the in-projection GEMM, K1, the out-projection and
the residual: ``layers.attention``). The script's own ``__main__`` times only
v0 and v1, since it comes before the other bodies are defined.

Weights are ``layers.init_block``'s from a ``torch.Generator`` (zero biases
and unit LayerNorms, as the script's ``init_block``); the GEMM weights and
the LayerNorm are held in the compute dtype and the biases in fp32, as the
script hands them to its kernels. Defaults are the script's: B=256, L=50,
E=768, H=12, bf16, K=32; ``--width`` and ``--dtype`` let the CPU run at a
tiny size in seconds (bf16 is slow on the CPU).
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from ..eval.zero_shot import resolve_device
from ..models import layers
from ..ops import attention as A
from ..ops import block_fused as BF
from ..ops import halfblock_tuning as HT

B, Lq, E = 256, 50, 768
K = 32          # inputs a row is timed over
WARMUP = 3      # inputs run before the timing
LAYERS = 11     # chained half-blocks per input
TBS = (8, 16, 32)
BIASES = ("attn.in_proj_bias", "attn.out_proj.bias", "mlp.c_fc.bias",
          "mlp.c_proj.bias")


def make_attn_half(variant, tb):
    """One E1 layer: ``x -> attention_halfblock_variant(x, p, variant, tb)``."""
    def apply(x, p):
        return HT.attention_halfblock_variant(x, p, variant, tb)

    apply.kernel = HT.attention_halfblock_variant
    return apply


def make_hybrid_b(tb):
    """One hybrid layer: LayerNorm, the library qkv GEMM, then E2."""
    def apply(x, p):
        return HT.hybrid_b(x, p, tb)

    apply.kernel = HT.core_out_halfblock
    return apply


def make_k5():
    def apply(x, p):
        return BF.fused_attention_halfblock(x, p, x.shape[-1] // BF.HEAD_DIM)

    apply.kernel = BF.fused_attention_halfblock
    return apply


def make_unfused():
    def apply(x, p):
        h = layers.layer_norm(x, p["ln_1.weight"], p["ln_1.bias"])
        return x + layers.attention(p, h, x.shape[-1] // BF.HEAD_DIM)

    apply.kernel = A.fused_attention_qkv
    return apply


def bench(name, fn, x0, p, iters=K, warmup=WARMUP):
    """The script's ``bench``: ``LAYERS`` chained calls of ``fn`` on ``x0 +
    i 1e-6``, summed as ``sum(y^2)``; the mean ms of one input's layers
    over ``iters`` inputs after ``warmup``, and the launches of
    ``fn.kernel`` over all of them. Prints ``<name> <ms> ms/11-layers``."""
    def run(i):
        y = x0 + i * 1e-6
        for _ in range(LAYERS):
            y = fn(y, p)
        return y.float().square().sum()

    before = fn.kernel.launches
    total = torch.zeros((), device=x0.device)
    for i in range(warmup):
        total += run(i)
    if x0.is_cuda:
        torch.cuda.synchronize(x0.device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            total += run(warmup + i)
        stop.record()
        torch.cuda.synchronize(x0.device)
        ms = start.elapsed_time(stop) / iters
    else:
        t0 = time.perf_counter()
        for i in range(iters):
            total += run(warmup + i)
        ms = (time.perf_counter() - t0) * 1e3 / iters
    if not torch.isfinite(total):
        raise FloatingPointError(f"{name}: the chained layers overflowed")
    print(f"{name:28s} {ms:9.3f} ms/11-layers", flush=True)
    return {"name": name, "ms": ms, "launches": fn.kernel.launches - before}


def block_weights(width, dtype, device):
    """``init_block``'s tensors under local names, from seed 0: biases
    fp32, the rest in ``dtype``."""
    gen = torch.Generator().manual_seed(0)
    p = layers.block_params(layers.init_block("blk", width, gen), "blk")
    return {k: v.to(device, torch.float32 if k in BIASES else dtype)
            for k, v in p.items()}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' for the "
                             "plain versions of the kernels)")
    parser.add_argument("--batch", type=int, default=B)
    parser.add_argument("--seq", type=int, default=Lq)
    parser.add_argument("--width", type=int, default=E)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("bfloat16", "float32"))
    parser.add_argument("--iters", type=int, default=K)
    parser.add_argument("--tbs", default=",".join(map(str, TBS)),
                        help="batch tiles (samples per block), each "
                             "dividing --batch")
    return parser.parse_args(argv)


def main(argv=None):
    """Every row of the sweep; returns a list of ``{"name", "kernel",
    "tb", "ms", "launches"}``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    tbs = [int(t) for t in args.tbs.split(",") if t]
    default = HT.default_tb(
        args.batch, args.seq, dtype,
        BF.sm_count(device) if device.type == "cuda" else None)
    bad = [t for t in tbs if t < 1 or args.batch % t]
    if bad:
        raise SystemExit(f"--tbs {bad} do not divide --batch {args.batch}")
    tbs = list(dict.fromkeys(tbs + [default]))
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[device.index or 0]
        print(f"# {card}; CUDA events", flush=True)
    else:
        print("# cpu: plain versions, host clock", flush=True)
    print(f"# B={args.batch} L={args.seq} E={args.width} {args.dtype} "
          f"K={args.iters} default tb={default}", flush=True)
    p = block_weights(args.width, dtype, device)
    gen = torch.Generator().manual_seed(1)
    x0 = torch.randn(args.batch, args.seq, args.width, generator=gen) \
        .to(device, dtype)

    rows = []

    def row(name, fn, tb):
        r = bench(name, fn, x0, p, args.iters)
        rows.append({**r, "kernel": fn.kernel.__name__, "tb": tb})

    for variant in HT.VARIANTS:
        for tb in tbs:
            row(f"attn_{variant} tb={tb}", make_attn_half(variant, tb), tb)
    for tb in tbs:
        row(f"hybrid_b tb={tb}", make_hybrid_b(tb), tb)
    row("k5 fused_attention_halfblock", make_k5(), None)
    row("unfused half (K1)", make_unfused(), None)
    return rows


if __name__ == "__main__":
    main()

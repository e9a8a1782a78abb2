"""Where the time of one MS-CLIP-S B/32 train step goes on one CUDA card.

    python -m msclip_torch.tools.profile_train [--iters 5] [--batch 256]

At full B/32 width, random weights from a seed, bf16, on a batch resident
on the card, it times on the device (CUDA events, after warm-up):

* the forward and loss;
* the forward, loss and backward;
* the whole train step (``msclip_torch.train.trainer``), whose remainder is
  the gradient norm, the AdamW step, the BN write-back and the clamp;

then traces one step with ``torch.profiler`` and prints the device time by
kernel, the shares of the attention kernels (K1 forward, K2 backward) and
the device's idle share of the traced window. Each result is one JSON line
on stdout.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from ..config import get_default_config, update_config
from ..models.msclip import build_spec, init_params
from ..train.trainer import init_train_state, make_loss_fn, make_train_step
from .profile_zero_shot import CONFIG, device_ms, emit, kernel_breakdown


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--batch", type=int, default=256)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    emit(card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())

    cfg = get_default_config()
    update_config(cfg, CONFIG, opts=["TPU.COMPUTE_DTYPE", "bfloat16",
                                     "MODEL.PRETRAINED_MODEL", ""])
    spec = build_spec(cfg)
    params = init_params(spec, torch.Generator().manual_seed(0))
    state = init_train_state(cfg, spec, params, 1000, "cuda")
    B = args.batch
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn(B, spec.image_resolution, spec.image_resolution, 3,
                         device="cuda", generator=gen)
    tokens = torch.randint(1, spec.vocab_size - 2, (B, spec.context_length),
                           device="cuda", generator=gen, dtype=torch.int32)
    tokens[:, 0], tokens[:, 20] = spec.vocab_size - 2, spec.vocab_size - 1
    tokens[:, 21:] = 0

    loss_fn = make_loss_fn(spec)
    step = make_train_step(spec)

    def forward():
        return loss_fn(state.model.params(), images, tokens)[0]

    def forward_backward():
        state.optimizer.zero_grad(set_to_none=True)
        forward().backward()

    with torch.no_grad():
        fwd_nograd_ms = device_ms(forward, args.iters)
    fwd_ms = device_ms(forward, args.iters)
    fwd_bwd_ms = device_ms(forward_backward, args.iters)
    torch.cuda.reset_peak_memory_stats()
    step_ms = device_ms(lambda: step(state, images, tokens), args.iters)
    emit(phase="train_step", batch=B, dtype="bfloat16", step_ms=step_ms,
         samples_per_s=B / step_ms * 1e3, forward_ms=fwd_ms,
         forward_no_grad_ms=fwd_nograd_ms,
         backward_ms=fwd_bwd_ms - fwd_ms,
         optimizer_and_rest_ms=step_ms - fwd_bwd_ms,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    emit(phase="train_step_trace", **kernel_breakdown(
        lambda: step(state, images, tokens),
        names=("attention_fwd", "attention_bwd")))


if __name__ == "__main__":
    main()

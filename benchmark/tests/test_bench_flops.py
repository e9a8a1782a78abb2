"""The operation counts of ``benchmark/flops.py`` against
``FlopCounterMode`` on the plain reference at batch 1, at the cells'
configurations, and the attention costs against their formulas."""

import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, manifest
from benchmark import reference as R

CONFIGS = sorted(os.listdir(os.path.join(manifest.BENCH_DIR, "configs")))


def counted(fn, *args):
    with FlopCounterMode(display=False) as c, torch.no_grad():
        fn(*args)
    return c.get_total_flops()


@pytest.mark.parametrize("name", CONFIGS)
def test_tower_flops_match_the_flop_counter(name):
    a = R.arch_from_file(os.path.join(manifest.BENCH_DIR, "configs", name))
    p = R.draw_params(R.param_layout(a), 3, "cpu")
    image = torch.zeros(1, a.resolution, a.resolution, 3, dtype=torch.uint8)
    classifier = torch.randn(1000, a.embed)
    tokens = torch.zeros(1, a.context, dtype=torch.int32)
    tokens[0, 0], tokens[0, 9] = a.vocab - 2, a.vocab - 1
    assert counted(R.zero_shot_logits, p, a, image, classifier) \
        == flops.eval_flops_per_image(a, 1000)
    assert counted(R.encode_text, p, a, tokens) == flops.text_flops(a)
    assert counted(R.infonce, torch.randn(8, a.embed),
                   torch.randn(8, a.embed), torch.zeros(())) \
        == 8 * 2 * 8 * a.embed
    per_sample = (flops.image_flops(a) + flops.text_flops(a)
                  + 2 * 8 * a.embed)
    assert flops.train_flops_per_sample(a, 8) == 3 * per_sample


@pytest.mark.parametrize("causal", [False, True])
def test_attention_costs(causal):
    B, L, W, H = 4, 50, 768, 12
    x = torch.randn(B, L, W)
    p = {"attn.in_proj_weight": torch.randn(3 * W, W),
         "attn.in_proj_bias": torch.zeros(3 * W),
         "attn.out_proj.weight": torch.randn(W, W),
         "attn.out_proj.bias": torch.zeros(W)}
    projections = 2 * B * L * W * 4 * W
    core = counted(R.attention, x, p, H, None, R.FP32) - projections
    fwd, fwd_bytes = flops.attention_fwd_cost(B, L, W, H, causal)
    bwd, bwd_bytes = flops.attention_bwd_cost(B, L, W, H, causal)
    kept = L * (L + 1) / 2 / L ** 2 if causal else 1.0
    assert fwd == pytest.approx(core * kept)
    assert bwd == pytest.approx(2.5 * core * kept)
    mask = L * L * 4 if causal else 0
    assert fwd_bytes == B * L * (3 * W + W) * 2 + mask
    assert bwd_bytes == B * L * (3 * W + W + 3 * W) * 2 + mask

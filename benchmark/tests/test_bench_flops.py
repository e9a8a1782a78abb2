"""The operation counts of ``benchmark/flops.py`` against
``FlopCounterMode`` on the plain reference at batch 1, at the cells'
configurations and the plain ViT layout's small one, the attention costs
against their formulas, and MS-CLIP-S's counts pinned at the values that
``mfu.*`` and ``attn_*_roofline`` read before the layouts were looked up
by ``MODEL.NAME``."""

import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, manifest
from benchmark import reference as R
from benchmark.tests import helpers

CONFIGS = sorted(os.listdir(os.path.join(manifest.BENCH_DIR, "configs")))


def counted(fn, *args):
    with FlopCounterMode(display=False) as c, torch.no_grad():
        fn(*args)
    return c.get_total_flops()


@pytest.mark.parametrize("name", CONFIGS)
def test_tower_flops_match_the_flop_counter(name):
    a = manifest.arch(os.path.join(manifest.BENCH_DIR, "configs", name))
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
    per_sample = (a.image_flops() + flops.text_flops(a)
                  + 2 * 8 * a.embed)
    assert flops.train_flops_per_sample(a, 8) == 3 * per_sample


def test_vit_image_flops_match_the_flop_counter():
    layout = manifest.layout(helpers.SMALL_CLIP)
    a = manifest.arch(helpers.SMALL_CLIP)
    p = R.draw_params(layout.param_layout(a), 3, "cpu")
    image = torch.zeros(1, a.resolution, a.resolution, 3, dtype=torch.uint8)
    assert a.attention_blocks == a.layers
    assert counted(layout.zero_shot_logits, p, a, image,
                   torch.randn(1000, a.embed)) \
        == flops.eval_flops_per_image(a, 1000)


# (operations, bytes) at batch 256 of the image tower's attention and the
# causal text tower's, and the image tower's attention blocks
PINNED = {
    "msclips-b32": {"eval": 10251212800, "train": 70649223168,
                    "fwd": (1966080000, 78643200),
                    "bwd": (4915200000, 137625600),
                    "text_fwd": (2361655296, 121134244),
                    "text_bwd": (5904138240, 211967140), "blocks": 11},
    "msclips-b16": {"eval": 36318447616, "train": 148850927616,
                    "fwd": (30520639488, 309854208),
                    "bwd": (76301598720, 542244864),
                    "text_fwd": (2361655296, 121134244),
                    "text_bwd": (5904138240, 211967140), "blocks": 11},
    "small": {"eval": 225906688, "train": 5255890944,
              "fwd": (26214400, 5242880), "bwd": (65536000, 9175040),
              "text_fwd": (787218432, 40393892),
              "text_bwd": (1968046080, 70671524), "blocks": 11},
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_msclips_counts_are_pinned(name):
    path = helpers.SMALL if name == "small" else os.path.join(
        manifest.BENCH_DIR, "configs", name + ".json")
    a = manifest.arch(path)
    want = PINNED[name]
    assert flops.eval_flops_per_image(a, 1000) == want["eval"]
    assert flops.train_flops_per_sample(a, 256) == want["train"]
    assert flops.attention_fwd_cost(256, a.seq, a.width, a.heads,
                                    False) == want["fwd"]
    assert flops.attention_bwd_cost(256, a.seq, a.width, a.heads,
                                    False) == want["bwd"]
    assert flops.attention_fwd_cost(256, a.context, a.text_width,
                                    a.text_heads, True) == want["text_fwd"]
    assert flops.attention_bwd_cost(256, a.context, a.text_width,
                                    a.text_heads, True) == want["text_bwd"]
    assert a.attention_blocks == want["blocks"]


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

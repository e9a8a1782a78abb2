"""Tiny model-zoo configurations for the tests that hold msclip_torch's zoo
against msclip_tpu's, on weights drawn with numpy (``torch_port_params``).

Each family is switched on over the tiny MS-CLIP-S geometry of
``reference_oracle.tiny_msclips_config`` (width 128, 64 px, vocabulary
512) cut to 6 layers with the lateral adapters at layers 1-5, so that all
five branch stages run. The window adapter needs heads of 48 and 64 over
channels of ``W / 16 .. W``, so its configuration is 768 wide."""

import copy

import numpy as np

from msclip_tpu.models import build_model as jax_build_model
from msclip_torch.models import msclip as TM
from msclip_torch.utils.convert import params_from_jax

from reference_oracle import tiny_msclips_config
from torch_port_params import random_jax_params

# family -> overrides ({"CUSTOM": {...}, "MODEL": {...}}) over the base
FAMILIES = {
    "adapter": {"CUSTOM": {"ADAPTER_FLAG": True, "ADAPTER_ATTN_DIM": 16,
                           "ADAPTER_LAYERS": [1, 3, 4]}},
    "lora_moe": {"CUSTOM": {"LORA_ATTN_DIM": 8, "LORA_ATTN_ALPHA": 16,
                            "LORA_WHERE_ADD": "v2", "LORA_MOE": 1,
                            "LORA_MOE_ACT": "sigmoid", "LORA_MOE_GROUP": 2,
                            "LORA_MOE_SOFTMAX": 1, "LORA_MOE_LAMBDA": 2.0}},
    "cvt": {"CUSTOM": {"CVT_IN_V": True, "CVT_V_RES": True,
                       "TWO_DWC_IN_CVT": True, "CVT_LAYERS": [2, 3]}},
    "cvt_inside": {"CUSTOM": {"CVT_IN_V": True, "CVT_INSIDE": True,
                              "CVT_INSIDE_Q": True, "CVT_INSIDE_V": True}},
    "convit": {"CUSTOM": {"CONVIT_IN_V": True, "CONVIT_LAYERS": [1, 2],
                          "CONVIT_LOCAL_STRENGTH": 2.0}},
    "container": {"CUSTOM": {"CONTAINER_IN_V": True}},
    "gumbel": {"CUSTOM": {"GUMBEL_SELECT": True}},
    "gumbel_addtwo": {"CUSTOM": {"GUMBEL_SELECT": True,
                                 "GUMBEL_ADDTWO": True}},
    "perceiver": {"CUSTOM": {"PERCEIVER_IN_V": True, "PERCEIVER_IN_T": True,
                             "PERCEIVER_LAYER": [2, 4],
                             "PERCEIVER_N_LATENT": 3}},
    "b2t_deconv": {"CUSTOM": {"PARALLEL_B2T": True,
                              "PARALLEL_B2T_NO_LASTLAYER": True}},
    "b2t_bilinear": {"CUSTOM": {"PARALLEL_B2T": True,
                                "PARALLEL_B2T_BILINEAR": True}},
    "b2t_crossattn": {"CUSTOM": {
        "PARALLEL_B2T": True, "PARALLEL_B2T_CROSSATTN": True,
        # cross attention has heads of 64: the stages of 64 and 128 only
        "PARALLEL_B2T_LAYER": [False, False, False, True, True]}},
    "t2b_bn_relu": {"CUSTOM": {"PRALLEL_T2B_ADD_BN_RELU": True}},
    "t2b_bn_ln_relu": {"CUSTOM": {"PRALLEL_T2B_ADD_BN_LN_RELU": True}},
    "t2b_noln_add": {"CUSTOM": {"PRALLEL_T2B_NOLN_ADD": True}},
    "t2b_pool": {"CUSTOM": {"PARALLEL_T2B_POOL_SIZE": [2, 2, 1, 1, 1],
                            "PRALLEL_T2B_KERNELS": [8, 4, 4, 2, 1],
                            "PRALLEL_T2B_STRIDES": [8, 4, 4, 2, 1]}},
    "plain_stem": {"CUSTOM": {"EARLY_CONV_RES": False}},
    "stem_outside": {"CUSTOM": {"EARLY_CONV_NEW_IMPLEMENT": False}},
    "conv_pool": {"MODEL": {"SPEC": {"POOL_TYPE": "linear"}}},
    "conv_pool_skip_cls": {"MODEL": {"SPEC": {"POOL_TYPE": "linear",
                                              "SKIP_CLS": True}}},
    "window": {"CUSTOM": {"PARALLEL_T2B_WINDOWATTN": True}},
    "window_no_relpos": {"CUSTOM": {"PARALLEL_T2B_WINDOWATTN": True,
                                    "T2B_WINDOWATTN_RELATIVE_POS": False}},
}
WIDE = {"window", "window_no_relpos"}  # 768 wide (heads of 48 and 64)


def family_config(name):
    """The tiny config with ``name``'s family on."""
    width = 768 if name in WIDE else 128
    cfg = tiny_msclips_config(width=width, layers=6)
    cfg.merge_from_dict({"CUSTOM": {"PARALLEL_LATERAL_LAYER":
                                    [1, 2, 3, 4, 5]}})
    cfg.merge_from_dict(copy.deepcopy(FAMILIES[name]))
    return cfg


def vit_config(layers=2, width=128, text_width=64, image=64):
    """Plain CLIP ViT (``experiments/model/b32.yaml``'s geometry, patch 32,
    a separate text tower of its own width) at a tiny size."""
    cfg = tiny_msclips_config(width=width, image_size=image, layers=layers)
    cfg.MODEL.SPEC.TEXT.WIDTH = text_width
    cfg.MODEL.SPEC.TEXT.HEADS = text_width // 32
    cfg.MODEL.SPEC.EMBED_DIM = 32
    cfg.CUSTOM.clear()
    cfg.CUSTOM.CUSTOM_ATTN = True
    return cfg


def resnet_config(layers=(1, 1, 1, 1), width=16, image=64):
    """The ModifiedResNet tower (width 16: heads of 64 in the pool) with
    b32.yaml's separate text tower, at a tiny size."""
    cfg = vit_config(layers=2, image=image)
    cfg.MODEL.SPEC.VISION.LAYERS = list(layers)
    cfg.MODEL.SPEC.VISION.WIDTH = width
    return cfg


def build(cfg, seed=0):
    """``(jax model, jax params (numpy), port spec, port params)``."""
    jm = jax_build_model(cfg)
    jp = random_jax_params(jm, seed=seed)
    spec = TM.spec_from_config(cfg)
    return jm, jp, spec, params_from_jax(jp, spec)


def inputs(image=64, vocab=512, batch=3, seed=42):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, image, image, 3)).astype(np.float32)
    tokens = np.zeros((batch, 77), dtype=np.int32)
    for i in range(batch):
        n = int(rng.integers(5, 20))
        tokens[i, 0] = vocab - 2
        tokens[i, 1:n] = rng.integers(1, vocab - 2, n - 1)
        tokens[i, n] = vocab - 1
    return images, tokens


def action(n_layers, seed=3):
    """A hard Gumbel action ``[n_layers, 2]`` with both choices in it."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, 2, n_layers)
    pick[:2] = (0, 1)
    return np.eye(2, dtype=np.float32)[pick]

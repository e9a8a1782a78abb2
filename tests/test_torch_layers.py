"""The port's layers, folding, tokenizer, config and transforms against the
JAX package's, fp32 on the CPU, on inputs made with numpy from a seed."""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msclip_tpu.config import get_default_config as jax_default_config
from msclip_tpu.config import update_config as jax_update_config
from msclip_tpu.data import ClipTokenizer as JaxTokenizer
from msclip_tpu.data import transforms as JT
from msclip_tpu.models import build_model as jax_build_model
from msclip_tpu.models import layers as JL
from msclip_tpu.models.folding import fold_params_for_eval as jax_fold
from msclip_torch.config import get_default_config, update_config
from msclip_torch.data import ClipTokenizer, get_classnames, get_templates
from msclip_torch.data import transforms as TT
from msclip_torch.models import layers as TL
from msclip_torch.models import msclip as TM
from msclip_torch.models.folding import fold_params_for_eval
from msclip_torch.utils.convert import params_from_jax

from reference_oracle import tiny_msclips_config
from torch_port_params import random_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, w, b = _np(rng, 4, 50, 128), _np(rng, 128), _np(rng, 128)
    want = JL.layer_norm({"scale": w, "bias": b}, jnp.asarray(x))
    got = TL.layer_norm(_t(x), _t(w), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_layer_norm_casts_before_the_affine_in_bf16():
    rng = np.random.default_rng(1)
    x, w, b = _np(rng, 4, 128), _np(rng, 128), _np(rng, 128)
    xb = _t(x).bfloat16()
    got = TL.layer_norm(xb, _t(w), _t(b))
    xf = xb.float()
    normed = ((xf - xf.mean(-1, keepdim=True))
              * torch.rsqrt(xf.var(-1, unbiased=False, keepdim=True)
                            + 1e-12)).bfloat16()
    want = _t(w).bfloat16() * normed + _t(b).bfloat16()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_block_matches_jax():
    """Pre-LN block with a causal mask; JAX weights [in, out], the
    port's [out, in]."""
    rng = np.random.default_rng(2)
    E, H, B, L = 128, 2, 3, 77
    jp = {
        "attn": {"qkv_w": _np(rng, E, 3 * E, scale=0.05),
                 "qkv_b": _np(rng, 3 * E, scale=0.1),
                 "out_w": _np(rng, E, E, scale=0.05),
                 "out_b": _np(rng, E, scale=0.1)},
        "ln_1": {"scale": 1 + _np(rng, E, scale=0.1),
                 "bias": _np(rng, E, scale=0.1)},
        "ln_2": {"scale": 1 + _np(rng, E, scale=0.1),
                 "bias": _np(rng, E, scale=0.1)},
        "mlp": {"c_fc": {"w": _np(rng, E, 4 * E, scale=0.05),
                         "b": _np(rng, 4 * E, scale=0.1)},
                "c_proj": {"w": _np(rng, 4 * E, E, scale=0.05),
                           "b": _np(rng, E, scale=0.1)}},
    }
    tp = {
        "attn.in_proj_weight": _t(jp["attn"]["qkv_w"].T),
        "attn.in_proj_bias": _t(jp["attn"]["qkv_b"]),
        "attn.out_proj.weight": _t(jp["attn"]["out_w"].T),
        "attn.out_proj.bias": _t(jp["attn"]["out_b"]),
        "ln_1.weight": _t(jp["ln_1"]["scale"]),
        "ln_1.bias": _t(jp["ln_1"]["bias"]),
        "ln_2.weight": _t(jp["ln_2"]["scale"]),
        "ln_2.bias": _t(jp["ln_2"]["bias"]),
        "mlp.c_fc.weight": _t(jp["mlp"]["c_fc"]["w"].T),
        "mlp.c_fc.bias": _t(jp["mlp"]["c_fc"]["b"]),
        "mlp.c_proj.weight": _t(jp["mlp"]["c_proj"]["w"].T),
        "mlp.c_proj.bias": _t(jp["mlp"]["c_proj"]["b"]),
    }
    x = _np(rng, B, L, E)
    want = JL.transformer_block(jp, jnp.asarray(x), H,
                                JL.build_causal_mask(L))
    got = TL.transformer_block(tp, _t(x), H, TL.build_causal_mask(L))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("stride,padding,groups", [(2, 1, 1), (1, 0, 1),
                                                   (16, 0, 16), (1, 1, 16)])
def test_conv2d_matches_jax(stride, padding, groups):
    """NHWC/HWIO in JAX, NCHW/OIHW in the port (depthwise included)."""
    rng = np.random.default_rng(3)
    k = 16 if stride == 16 else 3
    x = _np(rng, 2, 32, 32, 16)
    w = _np(rng, k, k, 16 // groups, 16, scale=0.1)
    want = JL.conv2d({"w": w}, jnp.asarray(x), stride, padding, groups)
    got = TL.conv2d(_t(x).permute(0, 3, 1, 2), _t(w.transpose(3, 2, 0, 1)),
                    stride, padding, groups)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_batch_norm_matches_jax(eps):
    rng = np.random.default_rng(4)
    x = _np(rng, 2, 8, 8, 16)
    p = {"scale": _np(rng, 16), "bias": _np(rng, 16), "mean": _np(rng, 16),
         "var": rng.uniform(0.5, 1.5, 16).astype(np.float32)}
    want = JL.batch_norm(p, jnp.asarray(x), eps=eps)
    tp = {"bn.weight": _t(p["scale"]), "bn.bias": _t(p["bias"]),
          "bn.running_mean": _t(p["mean"]), "bn.running_var": _t(p["var"])}
    got = TL.batch_norm(_t(x).permute(0, 3, 1, 2), tp, "bn", eps)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=ATOL)


def test_quick_gelu_and_l2_normalize_match_jax():
    rng = np.random.default_rng(5)
    x = _np(rng, 4, 64)
    np.testing.assert_allclose(TL.quick_gelu(_t(x)).numpy(),
                               np.asarray(JL.quick_gelu(jnp.asarray(x))),
                               atol=ATOL)
    np.testing.assert_allclose(TL.l2_normalize(_t(x)).numpy(),
                               np.asarray(JL.l2_normalize(jnp.asarray(x))),
                               atol=ATOL)


def test_folding_matches_jax():
    """Folded stem (merged stage), branch and adapter convs, tensor by
    tensor, against ``msclip_tpu.models.folding``."""
    cfg = tiny_msclips_config()
    jm = jax_build_model(cfg)
    jp = random_jax_params(jm, seed=6)
    spec = TM.spec_from_config(cfg)
    folded = fold_params_for_eval(params_from_jax(jp, spec), spec)
    jf = jax.tree.map(np.asarray,
                      jax.jit(lambda p: jax_fold(p, jm.spec))(jp))
    v = jf["visual"]
    stem = "visual.transformer.resblocks.0"
    pairs = [
        (f"{stem}.conv1", v["stem"]["conv1"]),
        (f"{stem}.resnet_stage.conv_2.conv1", v["stem"]["stages"][2]),
        ("visual.transformer.parallel_branch_v.0.conv",
         v["parallel_stages"][0]["conv"]),
        ("visual.transformer.parallel_branch_v.3.resnet_stage.conv_0.conv2",
         v["parallel_stages"][3]["blocks"][0]["conv2"]),
        ("visual.transformer.parallel_branch_v.1.resnet_stage.conv_0."
         "residual_conv", v["parallel_stages"][1]["blocks"][0]
         ["residual_conv"]),
        ("visual.transformer.parallel_lateral_adapter.1.top2bottom_dw_conv"
         ".conv", v["lateral_adapters"][1]["t2b_dw_conv"]),
        ("visual.transformer.parallel_lateral_adapter.4.bottom_dw_conv.conv",
         v["lateral_adapters"][4]["bottom_dw_conv"]),
    ]
    for key, jconv in pairs:
        np.testing.assert_allclose(
            folded[f"{key}.weight"].numpy(),
            jconv["w"].transpose(3, 2, 0, 1), atol=1e-6, err_msg=key)
        np.testing.assert_allclose(folded[f"{key}.bias"].numpy(),
                                   jconv["b"], atol=1e-6, err_msg=key)
    assert not any(".bn" in k or "downsample" in k or "residual_bn" in k
                   for k in folded)


# ---------------------------------------------------------------------------
# tokenizer, prompts, config, transforms
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tokenizers():
    return ClipTokenizer(), JaxTokenizer()


def test_tokenizer_matches_golden_tokens(tokenizers):
    tok, _ = tokenizers
    with open(os.path.join(REPO, "tests", "golden_tokens.json")) as f:
        golden = json.load(f)
    for text, ids in golden.items():
        np.testing.assert_array_equal(tok([text])[0], ids, err_msg=text)


def test_tokenizer_matches_jax_on_unicode_and_prompts(tokenizers):
    """The stdlib-``re`` word pattern selects what ``regex``'s
    ``\\p{L}``/``\\p{N}`` select, non-ASCII letters and numbers included."""
    tok, jtok = tokenizers
    texts = ["Héllo wörld 123 ½ ² x_y 東京 don't", "a ⅷ cat's 3.5 [x]",
             "ünïcode—dash ٣٤ ǅ Ⅻ", "  spaced\tout  &amp; html  "]
    texts += [t.format(c) for c in get_classnames("imagenet")[::50]
              for t in get_templates("imagenet")[::20]]
    np.testing.assert_array_equal(tok(texts), jtok(texts))


def test_assets_are_byte_identical():
    for name in ("bpe_simple_vocab_16e6.txt.gz", "prompts.json"):
        assert filecmp.cmp(
            os.path.join(REPO, "msclip_tpu", "data", "assets", name),
            os.path.join(REPO, "msclip_torch", "data", "assets", name),
            shallow=False), name


@pytest.mark.parametrize("name", ["b32-yfcc-msclips", "b32-laion-msclips",
                                  "b16-yfcc-msclips"])
def test_config_matches_jax(name):
    """YAML configs merge to the same tree in both packages, but for
    ``TPU.USE_PALLAS``: the port has no such switch."""
    path = os.path.join(REPO, "experiments", "model", f"{name}.yaml")
    a, b = get_default_config(), jax_default_config()
    update_config(a, path, opts=["TEST.SUBSET_CLASSES", "5"])
    jax_update_config(b, path, opts=["TEST.SUBSET_CLASSES", "5"])
    want = b.to_dict()
    del want["TPU"]["USE_PALLAS"]
    assert "USE_PALLAS" not in a.TPU
    assert a.to_dict() == want


def test_resolved_json_config_equals_yaml():
    """The resolved JSON copy of the B/32 config (read without PyYAML)
    merges to the same tree as the YAML with its BASE."""
    a, b = get_default_config(), get_default_config()
    update_config(a, os.path.join(REPO, "experiments", "model",
                                  "b32-yfcc-msclips.yaml"))
    update_config(b, os.path.join(REPO, "msclip_torch", "config",
                                  "b32-yfcc-msclips.json"))
    assert a.to_dict() == b.to_dict()


def test_eval_transforms_match_jax():
    from PIL import Image

    rng = np.random.default_rng(7)
    img = Image.fromarray((rng.random((80, 100, 3)) * 255).astype(np.uint8))
    np.testing.assert_array_equal(TT.pil_eval_transform(img, 64),
                                  JT.pil_eval_transform(img, 64))
    u8 = TT.pil_eval_uint8(img, 64)
    np.testing.assert_array_equal(u8, JT.pil_eval_uint8(img, 64))
    got = TT.normalize_uint8(torch.tensor(u8)[None]).numpy()[0]
    np.testing.assert_array_equal(got, np.asarray(
        JT.normalize_uint8(jnp.asarray(u8))))
    np.testing.assert_array_equal(got, TT.pil_eval_transform(img, 64))

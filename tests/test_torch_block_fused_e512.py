"""The fused half-blocks at E = 512 (8 heads of 64: the text towers of
``experiments/model/b32.yaml`` and the RN50 geometry) against the JAX
package's, on the CPU: the plain K5 and K6 against the Pallas kernels in
interpret mode, and b32.yaml's and RN50's towers with
``TPU.USE_FUSED_BLOCK`` at their published widths (768 image, 512 text),
cut to two layers, against JAX's fused towers with the same weights. Also
the width check that a CUDA tensor meets. The kernels themselves are
checked on the card by ``chip_smoke.py`` and
``tests/test_torch_kernels_gpu.py``."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msclip_tpu.config import get_default_config as jax_default_config
from msclip_tpu.config import update_config as jax_update_config
from msclip_tpu.models import build_model as jax_build_model
from msclip_tpu.models import layers as JL
from msclip_tpu.ops import block_fused as JBF
from msclip_torch.config import get_default_config, update_config
from msclip_torch.models import layers as TL
from msclip_torch.models import msclip as TM
from msclip_torch.ops import block_fused as BF
from msclip_torch.utils.convert import params_from_jax

from test_torch_block_fused import _case, _close, _strict
from torch_port_params import random_jax_params
from torch_threads import one_torch_thread  # noqa: F401
from torch_zoo_configs import inputs, resnet_config, vit_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, H, L = 512, 8, 77  # the text towers' width and heads, the context
# whole towers in fp32 (tests/test_torch_model.py's limit); the sums of
# width-512 and -768 rows give fp32 roundings of the order 1e-6 relative
TOWER_ATOL = 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_halfblock_plain_matches_jax_kernel_at_512(dtype, causal):
    """K5's plain version at E = 512, 8 heads, L = 77, 3 samples (JAX pads
    them to its batch tile of 2), at test_torch_block_fused.py's limits:
    fp32 atol 2e-5 / rtol 1e-4, bf16 atol 1e-2 / rtol 2e-2."""
    jb, tp, tx, jx = _case(E, L, dtype, seed=5 + causal)
    jmask = JL.build_causal_mask(L) if causal else None
    want = _strict(lambda x: JBF.fused_attention_halfblock(
        x, jb, H, jmask, interpret=True, batch_tile=2), jx)
    got = BF.fused_attention_halfblock(
        tx, tp, H, TL.build_causal_mask(L) if causal else None)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_halfblock_plain_matches_jax_kernel_at_512(dtype):
    jb, tp, tx, jx = _case(E, L, dtype, seed=9)
    want = _strict(lambda x: JBF.fused_mlp_halfblock(
        x, jb, interpret=True, batch_tile=2), jx)
    _close(BF.fused_mlp_halfblock(tx, tp), want, dtype)


@pytest.mark.parametrize("width", [512, 768])
def test_kernel_widths_pass_the_cuda_check(width):
    x = torch.empty(2, 50, width, device="meta")
    assert BF._check_cuda_input(x, width // 64) == width


@pytest.mark.parametrize("width", [640, 256, 1024])
def test_other_widths_raise_naming_the_kernel_widths(width):
    """A tensor of a width K5/K6 are not built for raises before any
    launch, and the error names the widths they take (a meta tensor shows
    the check that a CUDA tensor meets)."""
    x = torch.empty(2, 50, width, device="meta")
    with pytest.raises(ValueError, match=r"E one of \(512, 768\)"):
        BF._check_cuda_input(x, width // 64)


def _fused(cfg):
    cfg.TPU.USE_FUSED_BLOCK = True
    cfg.MODEL.SPEC.TEXT.HEADS = cfg.MODEL.SPEC.TEXT.WIDTH // 64
    return cfg


@functools.lru_cache(maxsize=None)
def _tower_models(name):
    """b32.yaml's geometry at its published widths (ViT 768, text 512),
    two layers, 64 px; or the RN50 ModifiedResNet (tiny) with the 512-wide
    text tower. ``(jax model, jax params, port spec, port params)``."""
    if name == "vit":
        cfg = vit_config(layers=2, width=768, text_width=512)
    else:
        cfg = resnet_config()
        cfg.MODEL.SPEC.TEXT.WIDTH = 512
    cfg = _fused(cfg)
    jm = jax_build_model(cfg)
    jp = random_jax_params(jm, seed=0)
    spec = TM.spec_from_config(cfg)
    assert spec.use_fused_block and jm.spec.use_fused_block
    return jm, jp, spec, params_from_jax(jp, spec)


@pytest.mark.parametrize("name,tower", [("vit", "image"), ("vit", "text"),
                                        ("resnet", "image"),
                                        ("resnet", "text")])
def test_fused_zoo_towers_match_jax(monkeypatch, name, tower):
    """fp32 towers with the switch on against JAX's, whose ``_block_fn``
    takes ``fused_block`` with the Pallas kernels in interpret mode: every
    transformer block goes through K5's function once, at E = 768 in the
    ViT and E = 512 in the text towers; the ResNet tower has none."""
    jm, jp, spec, tp = _tower_models(name)
    monkeypatch.setattr(JBF, "fused_block", functools.partial(
        JBF.fused_block, interpret=True))
    widths, real = [], BF.fused_attention_halfblock
    monkeypatch.setattr(BF, "fused_attention_halfblock",
                        lambda x, *a, **k: widths.append(x.shape[-1])
                        or real(x, *a, **k))
    images, tokens = inputs(batch=2)
    if tower == "image":
        want = jax.jit(jm.encode_image)(jp, jnp.asarray(images))
        got = TM.encode_image(tp, spec, torch.from_numpy(images))
        expected = [] if name == "resnet" else [768] * (
            spec.effective_vision_layers - spec.first_block)
    else:
        want = jax.jit(jm.encode_text)(jp, jnp.asarray(tokens))
        got = TM.encode_text(tp, spec, torch.from_numpy(tokens))
        expected = [512] * spec.text_layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOWER_ATOL)
    assert widths == expected


@pytest.mark.parametrize("base", ["experiments/model/b32.yaml",
                                  "msclip_torch/config/rn50.json"])
def test_published_configs_build_with_the_fused_block(base):
    """b32.yaml and rn50.json with ``TPU.USE_FUSED_BLOCK`` build (the port
    refused both before K5/K6 took E = 512), as JAX's b32.yaml does; the
    text tower is 512 wide with 8 heads of 64."""
    cfg = get_default_config()
    update_config(cfg, os.path.join(REPO, base),
                  opts=["TPU.USE_FUSED_BLOCK", "True"])
    spec = TM.spec_from_config(cfg)
    assert spec.use_fused_block
    assert (spec.text_width, spec.text_heads) == (512, 8)
    jcfg = jax_default_config()
    jax_update_config(jcfg, os.path.join(REPO, "experiments", "model",
                                         "b32.yaml"),
                      opts=["TPU.USE_FUSED_BLOCK", "True"])
    assert jax_build_model(jcfg).spec.use_fused_block

"""The model zoo's modules in the port against the JAX package's, one at a
time, fp32 on the CPU, on the same numpy weights: ``conv_transpose2d``,
the plain stem, the lateral-adapter variants and the bottom-to-top path,
the window and Perceiver cross attentions, the ModifiedResNet tower and
its pieces, and the extended block of every experimental family."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msclip_tpu.models import crossattn as JX
from msclip_tpu.models import extensions as JE
from msclip_tpu.models import layers as JL
from msclip_tpu.models import resnet as JR
from msclip_tpu.models import stem as JS
from msclip_tpu.models.msclip import gumbel_action as jax_gumbel
from msclip_tpu.models.msclip import resolve_text_block as jax_resolve
from msclip_torch.models import crossattn as TX
from msclip_torch.models import extensions as TE
from msclip_torch.models import layers as TL
from msclip_torch.models import msclip as TM
from msclip_torch.models import resnet as TR
from msclip_torch.models import stem as TS

from torch_threads import one_torch_thread  # noqa: F401
from torch_zoo_configs import (
    action,
    build,
    family_config,
    resnet_config,
)

# one module in fp32, sums in another order than XLA's
ATOL = 2e-5


@functools.lru_cache(maxsize=None)
def _built(name):
    return build(family_config(name))


def _np(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol)


def _nhwc(x):
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------------------
# layers.conv_transpose2d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride,size,k,pad", [
    (1, 5, 3, 1), (1, 6, 3, 0), (2, 5, 4, 1), (2, 6, 3, 1), (4, 7, 6, 1),
    (4, 8, 4, 0), (16, 2, 18, 1)])
def test_conv_transpose2d_matches_jax(stride, size, k, pad):
    """The depthwise deconv of the bottom-to-top path at odd and even
    sizes and strides 1, 2, 4 (and b2t stage 0's 16), its output side
    ``(H - 1) s - 2 p + k``."""
    C = 6
    x = _np((2, C, size, size), 0)
    w = _np((C, 1, k, k), 1, 0.3)  # ConvTranspose2d [in, out / groups, k, k]
    got = TL.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w),
                              stride, pad, groups=C)
    want = JL.conv_transpose2d({"w": jnp.asarray(w.transpose(2, 3, 1, 0))},
                               jnp.asarray(_nhwc(x)), stride, pad, groups=C)
    assert got.shape[-1] == (size - 1) * stride - 2 * pad + k
    _close(got.permute(0, 2, 3, 1), want)


# ---------------------------------------------------------------------------
# stems and adapters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("training", [False, True])
def test_plain_conv_stem_matches_jax(training):
    jm, jp, spec, tp = _built("plain_stem")
    x = _np((2, 64, 64, 3), 2)
    jbn, tbn = JS.BNState(training=training), TS.BNState(training=training)
    want = JS.apply_plain_conv_stem(jp["visual"]["stem"], jnp.asarray(x),
                                    jbn)
    got = TS.apply_plain_conv_stem(tp, spec.stem_prefix, _nchw(x), tbn)
    _close(got.permute(0, 2, 3, 1), want)
    assert len(tbn.updates) == len(jbn.updates) == (5 if training else 0)


@pytest.mark.parametrize("name", ["t2b_bn_relu", "t2b_bn_ln_relu",
                                  "t2b_noln_add", "t2b_pool"])
def test_lateral_adapter_variant_matches_jax(name):
    """Each ``PRALLEL_T2B_*`` variant and t2b pooling at stage 0 (a branch
    map of 32 x 32 onto a grid of 2)."""
    jm, jp, spec, tp = _built(name)
    li, g, C = 0, spec.grid, spec.vision_width
    top = _np((2, 32, 32, C // 16), 3)
    tokens = _np((2, 1 + g * g, C), 4)
    _, want = JS.apply_lateral_adapter(
        jp["visual"]["lateral_adapters"][li], jnp.asarray(top),
        jnp.asarray(tokens), (g, g), spec.t2b_kernels[li],
        spec.t2b_strides[li], spec.t2b_paddings[li], JS.BNState(),
        "a", use_cls=spec.t2b_use_cls, pool_kernel=spec.t2b_pool_sizes[li],
        bn_relu=spec.t2b_bn_relu, bn_ln_relu=spec.t2b_bn_ln_relu,
        noln_add=spec.t2b_noln_add)
    _, got = TS.apply_lateral_adapter(
        tp, f"visual.transformer.parallel_lateral_adapter.{li}", _nchw(top),
        torch.from_numpy(tokens), (g, g), spec.t2b_strides[li],
        spec.t2b_paddings[li], use_cls=spec.t2b_use_cls,
        pool_kernel=spec.t2b_pool_sizes[li], bn_relu=spec.t2b_bn_relu,
        bn_ln_relu=spec.t2b_bn_ln_relu, noln_add=spec.t2b_noln_add)
    _close(got, want)


@pytest.mark.parametrize("name,li", [("b2t_deconv", 0), ("b2t_deconv", 3),
                                     ("b2t_bilinear", 1),
                                     ("b2t_crossattn", 3),
                                     ("b2t_crossattn", 4)])
def test_b2t_path_matches_jax(name, li):
    """The bottom-to-top path's new branch map: deconv (the strided
    depthwise ``conv_transpose2d``), bilinear resize, cross attention."""
    jm, jp, spec, tp = _built(name)
    g, C = spec.grid, spec.vision_width
    side = 32 // 2 ** li
    top = _np((2, side, side, C // 16 * 2 ** li), 5)
    tokens = _np((2, 1 + g * g, C), 6)
    grid = tokens[:, 1:].reshape(2, g, g, C)
    want = JS.apply_lateral_adapter_b2t(
        jp["visual"]["lateral_adapters"][li], jnp.asarray(top),
        jnp.asarray(grid), jnp.asarray(tokens[:, :1]), (g, g), spec.b2t_mode,
        spec.b2t_kernels[li], spec.b2t_strides[li], spec.b2t_paddings[li],
        JS.BNState(), "a")
    got = TS.apply_lateral_adapter_b2t(
        tp, f"visual.transformer.parallel_lateral_adapter.{li}", _nchw(top),
        _nchw(grid), torch.from_numpy(tokens[:, :1]), spec.b2t_mode,
        spec.b2t_strides[li], spec.b2t_paddings[li])
    _close(got.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("li", [0, 2, 4])
def test_window_cross_attention_matches_jax(li):
    """The windowed fusion at 768 wide: stage 0 (one head of 48, windows
    of 16 x 16), stage 2 (three heads of 64) and stage 4 (the sliding 3 x
    3 window with its padding masked)."""
    jm, jp, spec, tp = _built("window")
    g, C = spec.grid, spec.vision_width
    geo = spec.window_geometry(li)
    side = g * geo["window_kv"] if not geo["slide_window"] else g
    top = _np((2, side, side, geo["kv_dim"]), 7)
    tokens = _np((2, 1 + g * g, C), 8)
    ad = jp["visual"]["lateral_adapters"][li]
    _, want = JX.window_cross_attention(
        ad, jnp.asarray(top), jnp.asarray(tokens), (g, g),
        num_heads=geo["num_heads"], head_qk_dim=geo["head_dim"],
        head_v_dim=geo["head_dim"], window_q=1, window_kv=geo["window_kv"],
        dwconv_kv=True, slide_window=geo["slide_window"],
        slide_kernel=geo["slide_kernel"], slide_pad=geo["slide_pad"],
        slide_stride=geo["slide_stride"], rel_pos_table=ad["rel_pos_table"],
        rel_pos_index=jnp.asarray(JX.relative_position_index(
            1, geo["window_kv"])), bn=JS.BNState(), path="a")
    _, got = TX.window_cross_attention(
        tp, f"visual.transformer.parallel_lateral_adapter.{li}", _nchw(top),
        torch.from_numpy(tokens), (g, g), num_heads=geo["num_heads"],
        head_qk_dim=geo["head_dim"], window_q=1,
        window_kv=geo["window_kv"], slide_window=geo["slide_window"],
        slide_kernel=geo["slide_kernel"], slide_pad=geo["slide_pad"],
        slide_stride=geo["slide_stride"])
    _close(got, want)


def test_relative_position_index_matches_jax():
    for wq, wkv in ((1, 16), (1, 3), (2, 4)):
        np.testing.assert_array_equal(TX.relative_position_index(wq, wkv),
                                      JX.relative_position_index(wq, wkv))


def test_perceiver_block_matches_jax():
    jm, jp, spec, tp = _built("perceiver")
    x = _np((2, spec.vision_seq_len, spec.vision_width), 9)
    latent = _np((2, 3, spec.vision_width), 10)
    want = JX.residual_cross_block(jp["visual"]["perceiver_blocks"][1],
                                   jnp.asarray(x), jnp.asarray(latent),
                                   spec.vision_heads)
    got = TX.residual_cross_block(
        tp, "visual.transformer.perceiver_latent2ori_blocks.1",
        torch.from_numpy(x), torch.from_numpy(latent), spec.vision_heads)
    _close(got, want)


def test_cross_attention_diffdim_matches_jax():
    jm, jp, spec, tp = _built("b2t_crossattn")
    ca = jp["visual"]["lateral_adapters"][4]["crossattn"]
    q, kv = _np((2, 4, 128), 11), _np((2, 5, 128), 12)
    want = JX.cross_attention_diffdim(ca, jnp.asarray(q), jnp.asarray(kv),
                                      jnp.asarray(kv), head_dim=64)
    got = TX.cross_attention_diffdim(
        tp, "visual.transformer.parallel_lateral_adapter.4."
        "bottom2top_crossattn", torch.from_numpy(q), torch.from_numpy(kv),
        torch.from_numpy(kv), head_dim=64)
    _close(got, want)


# ---------------------------------------------------------------------------
# ModifiedResNet
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _resnet():
    return build(resnet_config(layers=(2, 1, 2, 1)))


@pytest.mark.parametrize("training", [False, True])
def test_resnet_tower_matches_jax(training):
    """The whole ModifiedResNet (two-block stages: a projecting and a plain
    bottleneck) with eval or training BatchNorm, and its pieces."""
    jm, jp, spec, tp = _resnet()
    x = _np((2, 64, 64, 3), 13)
    jbn, tbn = JS.BNState(training=training), TS.BNState(training=training)
    want = JR.apply_modified_resnet(jp["visual"]["resnet"], jnp.asarray(x),
                                    spec.vision_resnet_layers,
                                    spec.vision_heads, jbn)
    got = TR.apply_modified_resnet(tp, _nchw(x), spec.vision_resnet_layers,
                                   spec.vision_heads, tbn)
    _close(got, want, atol=1e-4)
    assert len(tbn.updates) == len(jbn.updates)


@pytest.mark.parametrize("stride", [1, 2])
def test_bottleneck_matches_jax(stride):
    jm, jp, spec, tp = _resnet()
    layer = 1 if stride == 1 else 3
    blk = jp["visual"]["resnet"][f"layer{layer}"][0]
    c_in = blk["conv1"]["w"].shape[2]
    x = _np((2, 8, 8, c_in), 14)
    want = JR.apply_bottleneck(blk, jnp.asarray(x), stride, JS.BNState(),
                               "a")
    got = TR.apply_bottleneck(tp, f"visual.layer{layer}.0", _nchw(x), stride,
                              TS.BNState())
    _close(got.permute(0, 2, 3, 1), want)


def test_attention_pool_matches_jax():
    jm, jp, spec, tp = _resnet()
    x = _np((2, 2, 2, spec.vision_width * 32), 15)
    want = JR.apply_attention_pool(jp["visual"]["resnet"]["attnpool"],
                                   jnp.asarray(x), spec.vision_heads)
    got = TR.apply_attention_pool(tp, _nchw(x), spec.vision_heads)
    _close(got, want)


# ---------------------------------------------------------------------------
# the experimental families' blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,modality,layer", [
    ("adapter", "visual", 1), ("adapter", "text", 3),
    ("lora_moe", "visual", 2), ("lora_moe", "text", 0),
    ("lora_moe", "text", 4),
    ("cvt", "visual", 2), ("cvt_inside", "visual", 3),
    ("convit", "visual", 1), ("container", "visual", 4),
    ("gumbel", "visual", 1), ("gumbel", "visual", 2), ("gumbel", "text", 3),
    ("gumbel_addtwo", "text", 1)])
def test_extended_block_matches_jax(name, modality, layer):
    """One block of each family: visual blocks on the CLS + 2 x 2 grid,
    text blocks causal at 77 (a shared text block reads the trunk's
    attention and MLP); the Gumbel blocks on each hard choice."""
    jm, jp, spec, tp = _built(name)
    E = spec.vision_width
    if modality == "visual":
        prefix = f"visual.transformer.resblocks.{layer}"
        jblk = jp["visual"]["blocks"][layer - spec.first_block]
        jext = jp["visual"]["ext_blocks"][layer - spec.first_block]
        blk = TL.block_params(tp, prefix)
        x, mask, grid, heads = _np((2, spec.vision_seq_len, E), 16), None, \
            (spec.grid, spec.grid), spec.vision_heads
    else:
        prefix = f"transformer.resblocks.{layer}"
        jblk = jax_resolve(jp, jm.spec, layer)
        jext = jp["text"]["ext_blocks"][layer]
        blk = TM.resolve_text_block(tp, spec, layer)
        x, grid, heads = _np((2, 77, E), 17), None, spec.text_heads
        mask = TL.build_causal_mask(77)
    a = action(spec.vision_layers)[layer] if spec.ext.gumbel_select else None
    want = JE.extended_block(
        jblk, jext, jnp.asarray(x), heads, jm.spec.ext, modality, layer,
        grid, mask=None if mask is None else jnp.asarray(mask.numpy()),
        action=None if a is None else jnp.asarray(a))
    got = TE.extended_block(
        blk, tp, prefix, torch.from_numpy(x), heads, spec.ext, modality, grid,
        mask=mask, action=None if a is None else torch.from_numpy(a),
        take_shared=None if a is None else bool(a[0] > a[1]))
    _close(got, want)


def test_gumbel_action_is_straight_through():
    """The deterministic action is the argmax one-hot of ``logits / 5``
    (JAX's without a key), its gradient the softmax's; a drawn one is a
    one-hot too, the same for the same generator seed."""
    logits = _np((6, 2), 18)
    want = jax_gumbel(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    got = TE.gumbel_action(t)
    _close(got, want)
    jg = jax.grad(lambda z: (jax_gumbel(z) * jnp.arange(12.0).reshape(6, 2)
                             ).sum())(jnp.asarray(logits))
    (got * torch.arange(12.0).reshape(6, 2)).sum().backward()
    _close(t.grad, jg)
    draws = [TE.gumbel_action(t, torch.Generator().manual_seed(5))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert set(draws[0].detach().round().sum(dim=1).tolist()) == {1.0}

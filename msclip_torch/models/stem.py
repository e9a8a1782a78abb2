"""MS-CLIP conv modules, the port of ``msclip_tpu/models/stem.py``.

NCHW activations, OIHW weights, parameters in the reference ``state_dict``
layout under a key prefix:

* EarlyconvRes stem (``<stem>.conv1``, ``.bn1``, ``.resnet_stage.conv_<i>``,
  ``.last_conv``; reference ``clip_openai_pe_res_v1.py:1898-2000``) and the
  plain 6-conv stem (``<stem>.conv_<i>``, ``.bn_<i>``; ``:2282-2342``),
  each at ``visual.transformer.resblocks.0`` (inside the trunk) or
  ``visual.conv1`` (outside it);
* parallel branch stages (``visual.transformer.parallel_branch_v.<i>``):
  stage 0 conv+BN+ReLU, later stages ``ConvResBlock`` bottlenecks whose BN
  eps is **1e-6** (reference ``:1812-1895``);
* the top-to-bottom lateral adapter
  (``visual.transformer.parallel_lateral_adapter.<i>``, ``:1752-1778``)
  with its ``PRALLEL_T2B_*`` variants and t2b pooling, and the
  bottom-to-top back path (deconv, bilinear or cross attention,
  ``:1639-1742, 1780-1808``).

BatchNorm runs through a :class:`BNState` context: in eval it reads the
running statistics; in training it normalises with batch statistics and
records the new running statistics under the BN's reference key prefix.
Each apply function also takes the BN-folded form that
:func:`..folding.fold_params_for_eval` makes: a conv whose BN was folded
carries a ``.bias`` key and its BN keys are gone.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from .layers import (
    BN_MOMENTUM,
    add_channel_bias,
    avg_pool,
    batch_norm,
    conv2d,
    conv_transpose2d,
    init_batch_norm,
    init_conv,
    init_layer_norm,
    layer_norm,
)

CONV_RES_BN_EPS = 1e-6  # ConvResBlock's BatchNorms (reference :1831-1840)


@dataclass
class BNState:
    """BatchNorm context (``msclip_tpu/models/stem.py:40-66``).

    ``training=False``: the running statistics are read. ``training=True``:
    batch statistics are used and the new running statistics, blended at
    ``momentum`` (the SWA BN refresh sweeps it), are recorded in
    ``updates`` as ``{prefix: (running_mean, running_var)}``. With a
    process ``group`` (the data group of a multi-process step) the batch
    statistics are those of the group's global batch."""

    training: bool = False
    updates: dict = field(default_factory=dict)
    momentum: float = BN_MOMENTUM
    group: object = None  # the data group: global-batch statistics

    def __call__(self, x, params, prefix, eps=1e-5):
        if not self.training:
            return batch_norm(x, params, prefix, eps)
        y, self.updates[prefix] = batch_norm(x, params, prefix, eps,
                                             training=True,
                                             momentum=self.momentum,
                                             group=self.group)
        return y


# ---------------------------------------------------------------------------
# EarlyconvRes stem
# ---------------------------------------------------------------------------

def init_earlyconv_res(prefix, width, generator, first_conv_k=3, n_stages=4):
    """width/16 -> width over ``n_stages`` channel-doubling stages."""
    c0 = width // (2 ** n_stages)
    p = init_conv(f"{prefix}.conv1.weight", first_conv_k, 3, c0, generator)
    p.update(init_batch_norm(f"{prefix}.bn1", c0))
    for i in range(n_stages):
        c_in = width // (2 ** (n_stages - i))
        sp = f"{prefix}.resnet_stage.conv_{i}"
        p.update(init_conv(f"{sp}.conv1.weight", 3, c_in, 2 * c_in, generator))
        p.update(init_batch_norm(f"{sp}.bn1", 2 * c_in))
        p.update(init_conv(f"{sp}.downsample.0.weight", 1, c_in, 2 * c_in,
                           generator))
        p.update(init_batch_norm(f"{sp}.downsample.1", 2 * c_in))
    p.update(init_conv(f"{prefix}.last_conv.weight", 1, width, width,
                       generator))
    return p


def apply_earlyconv_res(params, prefix, x, strides, first_conv_k=3,
                        bn: BNState | None = None):
    """NCHW image -> NCHW feature map at 1/(2*prod(strides))."""
    bn = bn or BNState()
    pad = (first_conv_k - 1) // 2
    if f"{prefix}.bn1.weight" not in params:  # BN folded
        x = F.relu(add_channel_bias(
            conv2d(x, params[f"{prefix}.conv1.weight"], 2, pad),
            params[f"{prefix}.conv1.bias"]))
        for i, s in enumerate(strides):
            sp = f"{prefix}.resnet_stage.conv_{i}.conv1"
            x = F.relu(add_channel_bias(
                conv2d(x, params[f"{sp}.weight"], s, 1),
                params[f"{sp}.bias"]))
        return conv2d(x, params[f"{prefix}.last_conv.weight"])
    x = conv2d(x, params[f"{prefix}.conv1.weight"], 2, pad)
    x = F.relu(bn(x, params, f"{prefix}.bn1"))
    for i, s in enumerate(strides):
        # ResBasicBlock_v0: conv3x3(s)+BN, 1x1-downsample(s)+BN, add, ReLU
        sp = f"{prefix}.resnet_stage.conv_{i}"
        out = bn(conv2d(x, params[f"{sp}.conv1.weight"], s, 1),
                 params, f"{sp}.bn1")
        identity = bn(conv2d(x, params[f"{sp}.downsample.0.weight"], s, 0),
                      params, f"{sp}.downsample.1")
        x = F.relu(out + identity)
    return conv2d(x, params[f"{prefix}.last_conv.weight"])


def init_plain_conv_stem(prefix, width, generator):
    """The non-residual 6-conv stem (EARLY_CONV without EARLY_CONV_RES):
    five conv3x3 s2 (3 -> w/16 -> w/8 -> w/4 -> w/2 -> w) + BN + ReLU,
    then a 1x1 conv."""
    dims = [3, width // 16, width // 8, width // 4, width // 2, width]
    p = {}
    for i in range(5):
        p.update(init_conv(f"{prefix}.conv_{i + 1}.weight", 3, dims[i],
                           dims[i + 1], generator))
        p.update(init_batch_norm(f"{prefix}.bn_{i + 1}", dims[i + 1]))
    p.update(init_conv(f"{prefix}.conv_6.weight", 1, width, width, generator))
    return p


def apply_plain_conv_stem(params, prefix, x, bn: BNState | None = None):
    """NCHW image -> NCHW feature map at 1/32."""
    bn = bn or BNState()
    folded = f"{prefix}.bn_1.weight" not in params
    for i in range(1, 6):
        x = conv2d(x, params[f"{prefix}.conv_{i}.weight"], 2, 1)
        if folded:
            x = F.relu(add_channel_bias(x, params[f"{prefix}.conv_{i}.bias"]))
        else:
            x = F.relu(bn(x, params, f"{prefix}.bn_{i}"))
    return conv2d(x, params[f"{prefix}.conv_6.weight"])


# ---------------------------------------------------------------------------
# Parallel conv branch
# ---------------------------------------------------------------------------

def init_conv_res_block(prefix, c_in, c_mid, c_out, k, res_conv, generator):
    p = {}
    for name, (ci, co, kk) in (("1", (c_in, c_mid, 1)), ("2", (c_mid, c_mid, k)),
                               ("3", (c_mid, c_out, 1))):
        p.update(init_conv(f"{prefix}.conv{name}.weight", kk, ci, co,
                           generator))
        p.update(init_batch_norm(f"{prefix}.bn{name}", co))
    if res_conv:
        p.update(init_conv(f"{prefix}.residual_conv.weight", 1, c_in, c_out,
                           generator))
        p.update(init_batch_norm(f"{prefix}.residual_bn", c_out))
    return p


def init_parallel_branch(prefix, width, n_layers, resnet_layers, kernels,
                         generator):
    """Stages [3, w/16, w/8, w/4, w/2] -> [w/16, w/8, w/4, w/2, w]
    (reference ``:2131-2168``)."""
    in_dims = [3, width // 16, width // 8, width // 4, width // 2]
    out_dims = [width // 16, width // 8, width // 4, width // 2, width]
    p = {}
    for i in range(n_layers):
        bt = f"{prefix}.{i}"
        if i == 0 or resnet_layers[i] == 0:
            p.update(init_conv(f"{bt}.conv.weight", kernels[i], in_dims[i],
                               out_dims[i], generator))
            p.update(init_batch_norm(f"{bt}.bn", out_dims[i]))
            continue
        for j in range(resnet_layers[i]):
            c_in = in_dims[i] if j == 0 else out_dims[i]
            p.update(init_conv_res_block(
                f"{bt}.resnet_stage.conv_{j}", c_in, out_dims[i] // 2,
                out_dims[i], kernels[i], res_conv=(j == 0),
                generator=generator))
    return p


def apply_conv_res_block(params, prefix, x, stride, padding,
                         bn: BNState | None = None):
    """1x1 -> kxk(stride) -> 1x1 bottleneck with projected residual
    (reference ``ConvResBlock.forward`` ``:1842-1861``; BN eps 1e-6)."""
    bn = bn or BNState()
    folded = f"{prefix}.bn1.weight" not in params
    geometry = {"1": (1, 0), "2": (stride, padding), "3": (1, 0)}
    out = x
    for name, (s, pad) in geometry.items():
        out = conv2d(out, params[f"{prefix}.conv{name}.weight"], s, pad)
        if folded:
            out = add_channel_bias(out, params[f"{prefix}.conv{name}.bias"])
        else:
            out = bn(out, params, f"{prefix}.bn{name}", CONV_RES_BN_EPS)
        if name != "3":
            out = F.relu(out)
    residual = x
    if f"{prefix}.residual_conv.weight" in params:
        residual = conv2d(x, params[f"{prefix}.residual_conv.weight"],
                          stride, 0)
        if folded:
            residual = add_channel_bias(
                residual, params[f"{prefix}.residual_conv.bias"])
        else:
            residual = bn(residual, params, f"{prefix}.residual_bn",
                          CONV_RES_BN_EPS)
    return F.relu(out + residual)


def apply_parallel_stage(params, prefix, x, stride, padding, n_blocks,
                         bn: BNState | None = None):
    """One branch stage: conv+BN+ReLU, or ``n_blocks`` ConvResBlocks."""
    bn = bn or BNState()
    if f"{prefix}.conv.weight" in params:
        x = conv2d(x, params[f"{prefix}.conv.weight"], stride, padding)
        if f"{prefix}.bn.weight" not in params:  # folded
            return F.relu(add_channel_bias(x, params[f"{prefix}.conv.bias"]))
        return F.relu(bn(x, params, f"{prefix}.bn"))
    for j in range(n_blocks):
        x = apply_conv_res_block(params, f"{prefix}.resnet_stage.conv_{j}", x,
                                 stride if j == 0 else 1, padding, bn)
    return x


# ---------------------------------------------------------------------------
# Lateral adapter (released top-to-bottom path)
# ---------------------------------------------------------------------------

def init_lateral_adapter(prefix, top_dim, bottom_dim, t2b_kernel, generator,
                         bn_relu=False, bn_ln_relu=False, noln_add=False):
    """Top-to-bottom adapter; ``bn_relu`` (PRALLEL_T2B_ADD_BN_RELU) adds a
    BN after the pointwise conv, ``bn_ln_relu`` (PRALLEL_T2B_ADD_BN_LN_RELU)
    a token-space LN, ``noln_add`` (PRALLEL_T2B_NOLN_ADD) drops
    ``ln_adapt``."""
    p = init_conv(f"{prefix}.top2bottom_dw_conv.conv.weight", t2b_kernel,
                  top_dim, top_dim, generator, groups=top_dim)
    p.update(init_batch_norm(f"{prefix}.top2bottom_dw_conv.bn", top_dim))
    p.update(init_conv(f"{prefix}.top2bottom_pw_conv.conv.weight", 1, top_dim,
                       bottom_dim, generator))
    if bn_relu:
        p.update(init_batch_norm(f"{prefix}.top2bottom_pw_conv.bn",
                                 bottom_dim))
    if bn_ln_relu:
        p.update(init_layer_norm(f"{prefix}.top2bottom_pw_conv.ln",
                                 bottom_dim))
    p.update(init_conv(f"{prefix}.bottom_dw_conv.conv.weight", 3, bottom_dim,
                       bottom_dim, generator, groups=bottom_dim))
    p.update(init_batch_norm(f"{prefix}.bottom_dw_conv.bn", bottom_dim))
    if not noln_add:
        p.update(init_layer_norm(f"{prefix}.ln_adapt", bottom_dim))
    return p


def init_lateral_adapter_b2t(prefix, top_dim, bottom_dim, b2t_kernel,
                             generator, mode="deconv"):
    """The bottom-to-top back path's tensors; ``mode`` is ``deconv``,
    ``bilinear`` or ``crossattn``."""
    from .crossattn import init_cross_attention_diffdim

    p = init_conv(f"{prefix}.top_dw_conv.conv.weight", 3, top_dim, top_dim,
                  generator, groups=top_dim)
    p.update(init_batch_norm(f"{prefix}.top_dw_conv.bn", top_dim))
    if mode == "deconv":
        # ConvTranspose2d's [in, out / groups, k, k]: [C, 1, k, k]
        p.update(init_conv(f"{prefix}.bottom2top_dw_deconv.conv.weight",
                           b2t_kernel, bottom_dim, bottom_dim, generator,
                           groups=bottom_dim))
        p.update(init_batch_norm(f"{prefix}.bottom2top_dw_deconv.bn",
                                 bottom_dim))
        p.update(init_conv(f"{prefix}.bottom2top_pw_deconv.conv.weight", 1,
                           bottom_dim, top_dim, generator))
        p.update(init_batch_norm(f"{prefix}.bottom2top_pw_deconv.bn",
                                 top_dim))
        return p
    p.update(init_conv(f"{prefix}.bottom2top_dw_conv.conv.weight", 3,
                       bottom_dim, bottom_dim, generator, groups=bottom_dim))
    p.update(init_batch_norm(f"{prefix}.bottom2top_dw_conv.bn", bottom_dim))
    if mode == "bilinear":
        p.update(init_conv(f"{prefix}.bottom2top_pw_conv.conv.weight", 1,
                           bottom_dim, top_dim, generator))
        p.update(init_batch_norm(f"{prefix}.bottom2top_pw_conv.bn", top_dim))
    elif mode == "crossattn":
        p.update(init_cross_attention_diffdim(
            f"{prefix}.bottom2top_crossattn", top_dim, bottom_dim, bottom_dim,
            top_dim, top_dim, generator))
        p.update(init_layer_norm(f"{prefix}.bottom2top_ln", top_dim))
    else:
        raise ValueError(mode)
    return p


def _dw_conv_bn(params, prefix, x, stride, padding, bn: BNState):
    """Depthwise conv + BN (or its folded bias) over NCHW."""
    x = conv2d(x, params[f"{prefix}.conv.weight"], stride, padding,
               groups=x.shape[1])
    if f"{prefix}.bn.weight" not in params:  # folded
        return add_channel_bias(x, params[f"{prefix}.conv.bias"])
    return bn(x, params, f"{prefix}.bn")


def apply_lateral_adapter(params, prefix, top, tokens, grid_hw, t2b_stride,
                          t2b_padding, use_cls=True, eps=1e-12,
                          bn: BNState | None = None, pool_kernel=0,
                          bn_relu=False, bn_ln_relu=False, noln_add=False):
    """Fuse the branch map ``top`` ``[B, C_top, Ht, Wt]`` into the trunk
    tokens ``[B, 1 + H*W, C]`` (CLS first). Returns ``(top, fused)``.

    The reference's CLS arithmetic is kept: with ``use_cls`` the CLS both
    passes through the bottom path and is prepended to the top-to-bottom
    injection, so the fused CLS is ``ln(2 * cls)``. ``pool_kernel``
    (PARALLEL_T2B_POOL_SIZE) average-pools ``top`` first; ``bn_relu``,
    ``bn_ln_relu`` and ``noln_add`` as :func:`init_lateral_adapter`."""
    bn = bn or BNState()
    B, _, C = tokens.shape
    H, W = grid_hw
    top_in = avg_pool(top, pool_kernel) if pool_kernel else top
    t2b = _dw_conv_bn(params, f"{prefix}.top2bottom_dw_conv", top_in,
                      t2b_stride, t2b_padding, bn)
    if bn_relu:
        t2b = F.relu(t2b)
    t2b = conv2d(t2b, params[f"{prefix}.top2bottom_pw_conv.conv.weight"])
    if bn_relu:
        t2b = F.relu(bn(t2b, params, f"{prefix}.top2bottom_pw_conv.bn"))
    t2b = t2b.flatten(2).transpose(1, 2)  # [B, H*W, C], row-major grid
    if bn_ln_relu:
        t2b = F.relu(layer_norm(
            t2b, params[f"{prefix}.top2bottom_pw_conv.ln.weight"],
            params[f"{prefix}.top2bottom_pw_conv.ln.bias"], eps))

    cls_tok = tokens[:, :1, :]
    grid = tokens[:, 1:, :].transpose(1, 2).reshape(B, C, H, W)
    grid = _dw_conv_bn(params, f"{prefix}.bottom_dw_conv", grid, 1, 1, bn)
    bottom_out = torch.cat([cls_tok, grid.flatten(2).transpose(1, 2)], dim=1)

    t2b_cls = cls_tok if use_cls else torch.zeros_like(cls_tok)
    t2b = torch.cat([t2b_cls, t2b], dim=1)
    if noln_add:
        return top, bottom_out + t2b
    fused = layer_norm(bottom_out + t2b, params[f"{prefix}.ln_adapt.weight"],
                       params[f"{prefix}.ln_adapt.bias"], eps)
    return top, fused


def apply_lateral_adapter_b2t(params, prefix, top, bottom_grid, cls_tok,
                              mode, b2t_stride, b2t_padding,
                              bn: BNState | None = None, eps=1e-12):
    """The new branch map from the pre-fusion trunk grid ``bottom_grid``
    ``[B, C, H, W]`` and the branch map ``top`` ``[B, C_top, Ht, Wt]``
    (``msclip_tpu/models/stem.py:326-375``): ``top``'s depthwise conv +
    BN, plus the trunk grid brought to ``top``'s size by a strided
    depthwise deconv (``deconv``), a bilinear resize (``bilinear``), or
    ``top``'s cross attention over CLS + grid tokens (``crossattn``,
    which replaces the sum by ``LN(top + attn)``)."""
    from .crossattn import cross_attention_diffdim

    bn = bn or BNState()
    B, C_top, Ht, Wt = top.shape
    C = bottom_grid.shape[1]
    top_out = _dw_conv_bn(params, f"{prefix}.top_dw_conv", top, 1, 1, bn)
    if mode == "deconv":
        b2t = conv_transpose2d(
            bottom_grid, params[f"{prefix}.bottom2top_dw_deconv.conv.weight"],
            b2t_stride, b2t_padding, groups=C)
        b2t = bn(b2t, params, f"{prefix}.bottom2top_dw_deconv.bn")
        b2t = conv2d(b2t,
                     params[f"{prefix}.bottom2top_pw_deconv.conv.weight"])
        return top_out + bn(b2t, params, f"{prefix}.bottom2top_pw_deconv.bn")
    b2t = _dw_conv_bn(params, f"{prefix}.bottom2top_dw_conv", bottom_grid, 1,
                      1, bn)
    if mode == "bilinear":
        b2t = conv2d(b2t, params[f"{prefix}.bottom2top_pw_conv.conv.weight"])
        b2t = bn(b2t, params, f"{prefix}.bottom2top_pw_conv.bn")
        b2t = F.interpolate(b2t, size=(Ht, Wt), mode="bilinear",
                            align_corners=False)
        return top_out + b2t
    if mode != "crossattn":
        raise ValueError(mode)
    top_flat = top_out.flatten(2).transpose(1, 2)  # [B, Ht*Wt, C_top]
    kv = torch.cat([cls_tok, b2t.flatten(2).transpose(1, 2)], dim=1)
    attn = cross_attention_diffdim(params, f"{prefix}.bottom2top_crossattn",
                                   top_flat, kv, kv, head_dim=64)
    top_flat = layer_norm(top_flat + attn,
                          params[f"{prefix}.bottom2top_ln.weight"],
                          params[f"{prefix}.bottom2top_ln.bias"], eps)
    return top_flat.transpose(1, 2).reshape(B, C_top, Ht, Wt)

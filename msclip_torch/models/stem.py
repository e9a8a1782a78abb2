"""MS-CLIP-S conv modules, the MS-CLIP-S subset of ``msclip_tpu/models/stem.py``.

NCHW activations, OIHW weights, parameters in the reference ``state_dict``
layout under a key prefix:

* EarlyconvRes stem (``<stem>.conv1``, ``.bn1``, ``.resnet_stage.conv_<i>``,
  ``.last_conv``; reference ``clip_openai_pe_res_v1.py:1898-2000``);
* parallel branch stages (``visual.transformer.parallel_branch_v.<i>``):
  stage 0 conv+BN+ReLU, later stages ``ConvResBlock`` bottlenecks whose BN
  eps is **1e-6** (reference ``:1812-1895``);
* the released top-to-bottom lateral adapter
  (``visual.transformer.parallel_lateral_adapter.<i>``, ``:1752-1778``).

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
    batch_norm,
    conv2d,
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
    ``updates`` as ``{prefix: (running_mean, running_var)}``."""

    training: bool = False
    updates: dict = field(default_factory=dict)
    momentum: float = BN_MOMENTUM

    def __call__(self, x, params, prefix, eps=1e-5):
        if not self.training:
            return batch_norm(x, params, prefix, eps)
        y, self.updates[prefix] = batch_norm(x, params, prefix, eps,
                                             training=True,
                                             momentum=self.momentum)
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

def init_lateral_adapter(prefix, top_dim, bottom_dim, t2b_kernel, generator):
    p = init_conv(f"{prefix}.top2bottom_dw_conv.conv.weight", t2b_kernel,
                  top_dim, top_dim, generator, groups=top_dim)
    p.update(init_batch_norm(f"{prefix}.top2bottom_dw_conv.bn", top_dim))
    p.update(init_conv(f"{prefix}.top2bottom_pw_conv.conv.weight", 1, top_dim,
                       bottom_dim, generator))
    p.update(init_conv(f"{prefix}.bottom_dw_conv.conv.weight", 3, bottom_dim,
                       bottom_dim, generator, groups=bottom_dim))
    p.update(init_batch_norm(f"{prefix}.bottom_dw_conv.bn", bottom_dim))
    p.update(init_layer_norm(f"{prefix}.ln_adapt", bottom_dim))
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
                          bn: BNState | None = None):
    """Fuse the branch map ``top`` ``[B, C_top, Ht, Wt]`` into the trunk
    tokens ``[B, 1 + H*W, C]`` (CLS first). Returns ``(top, fused)``.

    The reference's CLS arithmetic is kept: with ``use_cls`` the CLS both
    passes through the bottom path and is prepended to the top-to-bottom
    injection, so the fused CLS is ``ln(2 * cls)``."""
    bn = bn or BNState()
    B, _, C = tokens.shape
    H, W = grid_hw
    t2b = _dw_conv_bn(params, f"{prefix}.top2bottom_dw_conv", top,
                      t2b_stride, t2b_padding, bn)
    t2b = conv2d(t2b, params[f"{prefix}.top2bottom_pw_conv.conv.weight"])
    t2b = t2b.flatten(2).transpose(1, 2)  # [B, H*W, C], row-major grid

    cls_tok = tokens[:, :1, :]
    grid = tokens[:, 1:, :].transpose(1, 2).reshape(B, C, H, W)
    grid = _dw_conv_bn(params, f"{prefix}.bottom_dw_conv", grid, 1, 1, bn)
    bottom_out = torch.cat([cls_tok, grid.flatten(2).transpose(1, 2)], dim=1)

    t2b_cls = cls_tok if use_cls else torch.zeros_like(cls_tok)
    t2b = torch.cat([t2b_cls, t2b], dim=1)
    fused = layer_norm(bottom_out + t2b, params[f"{prefix}.ln_adapt.weight"],
                       params[f"{prefix}.ln_adapt.bias"], eps)
    return top, fused

"""Eval-time BatchNorm folding (port of ``msclip_tpu/models/folding.py``).

At inference BN is an affine map, so every conv+BN pair folds into a conv
with a bias, and each ``ResBasicBlock_v0`` stem stage (conv3x3+BN plus a
1x1 downsample+BN, reference ``:1898-1936``) collapses into one conv3x3
with the 1x1 weights added to the centre tap, ``[:, :, 1, 1]`` in OIHW;
the plain 6-conv stem folds conv by conv.

The folded state keeps reference key names: a folded conv gains a
``.bias`` key and its BN keys are dropped, which is how the apply
functions in ``stem.py`` recognise it. Eps per place: 1e-5 in the stem,
branch stage 0 and adapters, 1e-6 in ``ConvResBlock``.
"""

from __future__ import annotations

import torch

from .stem import CONV_RES_BN_EPS

BN_SUFFIXES = ("weight", "bias", "running_mean", "running_var")


def fold_conv_bn(params, conv_key, bn_prefix, eps=1e-5):
    """OIHW conv weight + BN -> (scaled weight, bias), in fp32."""
    scale = params[f"{bn_prefix}.weight"] * torch.rsqrt(
        params[f"{bn_prefix}.running_var"] + eps)
    offset = params[f"{bn_prefix}.bias"] \
        - params[f"{bn_prefix}.running_mean"] * scale
    return params[conv_key] * scale[:, None, None, None], offset


def _set_folded(out, conv_prefix, bn_prefix, w, b):
    out[f"{conv_prefix}.weight"] = w
    out[f"{conv_prefix}.bias"] = b
    for s in BN_SUFFIXES:
        del out[f"{bn_prefix}.{s}"]


def fold_params_for_eval(params, spec):
    """Inference copy of ``params`` with every conv+BN of the stem,
    parallel branch and lateral adapters folded, where the JAX package's
    ``fold_params_for_eval`` folds: nothing for the ModifiedResNet or
    patchify towers, nor for the adapter variants with a BN or LN after
    the pointwise conv or the bottom-to-top path; the window adapters keep
    their BatchNorms."""
    if spec.vision_resnet_layers or not spec.early_conv:
        return params
    if spec.t2b_bn_relu or spec.t2b_bn_ln_relu or spec.parallel_b2t:
        return params
    out = dict(params)
    stem = spec.stem_prefix
    if not spec.early_conv_res:  # the plain 6-conv stem
        for i in range(1, 6):
            w, b = fold_conv_bn(params, f"{stem}.conv_{i}.weight",
                                f"{stem}.bn_{i}")
            _set_folded(out, f"{stem}.conv_{i}", f"{stem}.bn_{i}", w, b)
    else:
        w, b = fold_conv_bn(params, f"{stem}.conv1.weight", f"{stem}.bn1")
        _set_folded(out, f"{stem}.conv1", f"{stem}.bn1", w, b)
        for i in range(len(spec.early_conv_strides)):
            sp = f"{stem}.resnet_stage.conv_{i}"
            w3, b3 = fold_conv_bn(params, f"{sp}.conv1.weight", f"{sp}.bn1")
            w1, b1 = fold_conv_bn(params, f"{sp}.downsample.0.weight",
                                  f"{sp}.downsample.1")
            w3 = w3.clone()
            w3[:, :, 1, 1] += w1[:, :, 0, 0]
            _set_folded(out, f"{sp}.conv1", f"{sp}.bn1", w3, b3 + b1)
            del out[f"{sp}.downsample.0.weight"]
            for s in BN_SUFFIXES:
                del out[f"{sp}.downsample.1.{s}"]
    if not spec.parallel:
        return out
    for i in range(spec.parallel_n_layers):
        bt = f"visual.transformer.parallel_branch_v.{i}"
        if f"{bt}.conv.weight" in params:
            w, b = fold_conv_bn(params, f"{bt}.conv.weight", f"{bt}.bn")
            _set_folded(out, f"{bt}.conv", f"{bt}.bn", w, b)
            continue
        for j in range(spec.parallel_resnet_layers[i]):
            ct = f"{bt}.resnet_stage.conv_{j}"
            names = [("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3")]
            if f"{ct}.residual_conv.weight" in params:
                names.append(("residual_conv", "residual_bn"))
            for conv, bn in names:
                w, b = fold_conv_bn(params, f"{ct}.{conv}.weight",
                                    f"{ct}.{bn}", CONV_RES_BN_EPS)
                _set_folded(out, f"{ct}.{conv}", f"{ct}.{bn}", w, b)
    if spec.t2b_windowattn:
        return out
    for i in range(len(spec.lateral_layers)):
        at = f"visual.transformer.parallel_lateral_adapter.{i}"
        for name in ("top2bottom_dw_conv", "bottom_dw_conv"):
            w, b = fold_conv_bn(params, f"{at}.{name}.conv.weight",
                                f"{at}.{name}.bn")
            _set_folded(out, f"{at}.{name}.conv", f"{at}.{name}.bn", w, b)
    return out

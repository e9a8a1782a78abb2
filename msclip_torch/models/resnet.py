"""CLIP's ModifiedResNet vision tower, the port of
``msclip_tpu/models/resnet.py`` (reference ``clip_openai_pe_res_v1.py:
33-201``, chosen when ``VISION.LAYERS`` is a list, ``:2748-2756``): a 3-conv
stem with an average pool, anti-aliased bottlenecks (the strided ones pool
before their last conv and their projection), and the QKV attention-pool
head. NCHW, parameters in the reference layout under ``visual.``
(``visual.conv1``, ``visual.layer<s>.<j>.conv1``, ``.downsample.0``,
``visual.attnpool.q_proj``, ...). The pool's attention is plain torch, as
the JAX package computes it with einsums outside Pallas.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers as L
from .stem import BNState

EXPANSION = 4
PREFIX = "visual"


def init_bottleneck(prefix, inplanes, planes, stride, generator):
    p = {}
    for name, (c_in, c_out, k) in (("1", (inplanes, planes, 1)),
                                   ("2", (planes, planes, 3)),
                                   ("3", (planes, planes * EXPANSION, 1))):
        p.update(L.init_conv(f"{prefix}.conv{name}.weight", k, c_in, c_out,
                             generator))
        p.update(L.init_batch_norm(f"{prefix}.bn{name}", c_out))
    if stride > 1 or inplanes != planes * EXPANSION:
        p.update(L.init_conv(f"{prefix}.downsample.0.weight", 1, inplanes,
                             planes * EXPANSION, generator))
        p.update(L.init_batch_norm(f"{prefix}.downsample.1",
                                   planes * EXPANSION))
    return p


def apply_bottleneck(params, prefix, x, stride, bn: BNState):
    """All convs stride 1; an average pool after conv2 (and before the
    projection) when ``stride > 1``."""
    out = F.relu(bn(L.conv2d(x, params[f"{prefix}.conv1.weight"]), params,
                    f"{prefix}.bn1"))
    out = F.relu(bn(L.conv2d(out, params[f"{prefix}.conv2.weight"], 1, 1),
                    params, f"{prefix}.bn2"))
    if stride > 1:
        out = L.avg_pool(out, stride)
    out = bn(L.conv2d(out, params[f"{prefix}.conv3.weight"]), params,
             f"{prefix}.bn3")
    identity = x
    if f"{prefix}.downsample.0.weight" in params:
        if stride > 1:
            identity = L.avg_pool(identity, stride)
        identity = bn(L.conv2d(identity,
                               params[f"{prefix}.downsample.0.weight"]),
                      params, f"{prefix}.downsample.1")
    return F.relu(out + identity)


def init_modified_resnet(layers, output_dim, width, input_resolution,
                         generator):
    p = {}
    for i, (c_in, c_out) in enumerate(((3, width // 2),
                                       (width // 2, width // 2),
                                       (width // 2, width)), 1):
        p.update(L.init_conv(f"{PREFIX}.conv{i}.weight", 3, c_in, c_out,
                             generator))
        p.update(L.init_batch_norm(f"{PREFIX}.bn{i}", c_out))
    inplanes = width
    for stage, n_blocks in enumerate(layers):
        planes = width * 2 ** stage
        for j in range(n_blocks):
            p.update(init_bottleneck(
                f"{PREFIX}.layer{stage + 1}.{j}", inplanes, planes,
                (1 if stage == 0 else 2) if j == 0 else 1, generator))
            inplanes = planes * EXPANSION
    embed = width * 32
    ap = f"{PREFIX}.attnpool"
    p[f"{ap}.positional_embedding"] = L.normal(
        ((input_resolution // 32) ** 2 + 1, embed), generator, embed ** -0.5)
    for proj, d_out in (("q_proj", embed), ("k_proj", embed),
                        ("v_proj", embed), ("c_proj", output_dim)):
        p[f"{ap}.{proj}.weight"] = L.trunc_normal((d_out, embed), generator)
        p[f"{ap}.{proj}.bias"] = torch.zeros(d_out)
    return p


def apply_attention_pool(params, x, num_heads):
    """``[B, C, H, W]`` -> ``[B, output_dim]``: the mean token prepended,
    the learned positional embedding added, one attention step whose
    query is the mean token alone (reference ``:91-117``)."""
    ap = f"{PREFIX}.attnpool"
    tokens = x.flatten(2).transpose(1, 2)  # [B, HW, C]
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    tokens = tokens + params[f"{ap}.positional_embedding"].to(tokens.dtype)

    def proj(name, t):
        return L.linear(t, params[f"{ap}.{name}.weight"],
                        params[f"{ap}.{name}.bias"])

    out = L.softmax_attention(proj("q_proj", tokens[:, :1]),
                              proj("k_proj", tokens),
                              proj("v_proj", tokens), num_heads)
    return proj("c_proj", out[:, 0])


def apply_modified_resnet(params, x, layers, num_heads,
                          bn: BNState | None = None):
    """NCHW images -> ``[B, output_dim]``."""
    bn = bn or BNState()
    for i in (1, 2, 3):
        x = L.conv2d(x, params[f"{PREFIX}.conv{i}.weight"], 2 if i == 1 else 1,
                     1)
        x = F.relu(bn(x, params, f"{PREFIX}.bn{i}"))
    x = L.avg_pool(x, 2)
    for stage, n_blocks in enumerate(layers):
        for j in range(n_blocks):
            x = apply_bottleneck(params, f"{PREFIX}.layer{stage + 1}.{j}", x,
                                 (1 if stage == 0 else 2) if j == 0 else 1,
                                 bn)
    return apply_attention_pool(params, x, num_heads)

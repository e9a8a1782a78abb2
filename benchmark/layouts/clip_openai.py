"""Plain CLIP ViT (``MODEL.NAME clip_openai``, ``experiments/model/b32.yaml``):
OpenAI CLIP's image tower (Radford et al. 2021; ``github.com/openai/CLIP``
``clip/model.py`` ``VisionTransformer``) as the port names it: the
patchify convolution without bias (``visual.conv1.weight``), the class
token and positional embedding, ``ln_pre``, ``layers`` pre-LN blocks with
a QuickGELU MLP, ``ln_post`` of the class token, ``visual.proj``.

The reference is plain torch in float32 with TF32 off, through
``reference.py``'s blocks, LayerNorm and draws, and imports nothing of the
port. Its LayerNorm epsilon is ``reference.LN_EPS`` (1e-12), as the MS-CLIP
release and the port run every layout; OpenAI's release uses torch's
default, 1e-5. There is no text-tower or train reference here: the eval
kind alone takes this layout.
"""

import json
from dataclasses import dataclass

import torch

from benchmark import flops
from benchmark import reference as R

# CUSTOM keys that leave the plain tower as it is
PLAIN_CUSTOM = {"CUSTOM_ATTN"}


@dataclass(frozen=True)
class Arch:
    """The shapes of a plain CLIP ViT configuration."""

    embed: int
    width: int
    layers: int
    heads: int
    patch: int
    resolution: int
    context: int
    vocab: int
    text_width: int
    text_heads: int
    text_layers: int

    @property
    def grid(self):
        return self.resolution // self.patch

    @property
    def seq(self):
        return self.grid ** 2 + 1

    @property
    def attention_blocks(self):
        return self.layers

    def image_flops(self):
        return flops.vit_image_flops(self)


def arch_from_file(path):
    """The :class:`Arch` of a configuration file (the release's keys)."""
    with open(path) as f:
        cfg = json.load(f)
    spec = cfg["MODEL"]["SPEC"]
    vis, txt = spec["VISION"], spec["TEXT"]
    custom = {k for k, v in cfg.get("CUSTOM", {}).items() if v}
    if vis.get("MODEL", "vit") != "vit" or not isinstance(vis["LAYERS"], int) \
            or spec.get("POOL_TYPE", "default") != "default" \
            or custom - PLAIN_CUSTOM:
        raise ValueError(f"{path}: the clip_openai reference covers the plain "
                         f"ViT only (CUSTOM {sorted(custom - PLAIN_CUSTOM)})")
    return Arch(
        embed=spec["EMBED_DIM"], width=vis["WIDTH"], layers=vis["LAYERS"],
        heads=vis["WIDTH"] // 64, patch=vis["PATCH_SIZE"],
        resolution=cfg["TRAIN"]["IMAGE_SIZE"][0],
        context=txt["CONTEXT_LENGTH"], vocab=txt["VOCAB_SIZE"],
        text_width=txt["WIDTH"], text_heads=txt["HEADS"],
        text_layers=txt["LAYERS"])


def param_layout(a: Arch):
    """``{name: (shape, init)}`` in the port's names, drawn by
    ``reference.draw_params`` under MS-CLIP-S's rules (two outlier gains
    in each block's LayerNorms). The text tower is there because the
    port's model holds it; no reference here reads it."""
    W, E, TW = a.width, a.embed, a.text_width
    p = {"logit_scale": ((), "logit_scale"),
         "visual.class_embedding": ((W,), W ** -0.5),
         "visual.positional_embedding": ((a.seq, W), W ** -0.5),
         "visual.proj": ((W, E), W ** -0.5)}
    R._conv(p, "visual.conv1.weight", W, 3, a.patch)
    R._ln(p, "visual.ln_pre", W)
    R._ln(p, "visual.ln_post", W)
    for i in range(a.layers):
        R._block(p, f"visual.transformer.resblocks.{i}", W)
    for j in range(a.text_layers):
        R._block(p, f"transformer.resblocks.{j}", TW)
    p["token_embedding.weight"] = ((a.vocab, TW), 1.0)
    p["positional_embedding"] = ((a.context, TW), 0.01)
    p["text_projection"] = ((TW, E), TW ** -0.5)
    R._ln(p, "ln_final", TW)
    return p


def encode_image(p, a: Arch, images_u8, prec=R.FP32):
    """uint8 ``[B, H, W, 3]`` -> unit-norm ``[B, embed]``."""
    x = R.normalize_images(images_u8)
    patches = R.conv(x, p["visual.conv1.weight"], a.patch, prec=prec)
    B = x.shape[0]
    tokens = torch.cat([p["visual.class_embedding"].expand(B, 1, -1),
                        patches.flatten(2).transpose(1, 2)], 1)
    tokens = R.layer_norm(tokens + p["visual.positional_embedding"],
                          p["visual.ln_pre.weight"], p["visual.ln_pre.bias"])
    for i in range(a.layers):
        tokens = R.block(tokens,
                         R._local(p, f"visual.transformer.resblocks.{i}"),
                         a.heads, None, prec)
    pooled = R.layer_norm(tokens[:, 0], p["visual.ln_post.weight"],
                          p["visual.ln_post.bias"])
    feats = R.matmul(pooled, p["visual.proj"], prec)
    return feats / feats.norm(dim=-1, keepdim=True)


def zero_shot_logits(p, a: Arch, images_u8, classifier, prec=R.FP32):
    """``100 * image features @ classifier.T``: ``[B, classes]``."""
    return 100.0 * R.matmul(encode_image(p, a, images_u8, prec),
                            classifier.float().t(), prec)

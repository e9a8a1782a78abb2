"""The MS-CLIP model family, the port of ``msclip_tpu/models/msclip.py``:
plain CLIP (the patchify ViT, ``experiments/model/b32.yaml``, or the
ModifiedResNet tower), MS-CLIP-S (the shared trunk, a conv stem, the
parallel branch and its lateral adapters) and the model zoo's [off]
variants (the plain and outside-the-trunk stems, the adapter variants and
the bottom-to-top path, windowed fusion, the Perceiver latents, the
conv1d pooling head, the experimental block families of
``extensions.py``).

Parameters are one flat dict in the reference ``state_dict`` layout
(``visual.transformer.resblocks.<i>.attn.in_proj_weight``, ...), holding
each tensor once: a text block that shares the visual trunk's attn/mlp
(``CUSTOM.SHARE_MODULES``) has no keys of its own for them, and
:func:`resolve_text_block` reads the trunk's. For int8 eval
(``TPU.INT8_EVAL``, ``models/quantize.py``) each trunk GEMM weight is held
as an int8 tensor and its fp32 scale instead. With ``TPU.USE_FUSED_BLOCK``
(eval only) every trunk and text block runs ``ops.block_fused.fused_block``
(the fused attention half-block K5, then the MLP half unfused). Activations are batch-first
``[B, L, D]``; ``encode_image`` takes ``[B, H, W, 3]`` like the JAX
function and runs the convolutions in NCHW.

:class:`MSClipModel` holds the dict as a module tree: buffers only for eval
(``load_eval_model``), or, with ``trainable=True``, the trained tensors as
``nn.Parameter``s and the BatchNorm running statistics as buffers.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.utils.checkpoint

from ..ops.block_fused import fused_block
from ..utils.summary import span
from . import crossattn as X
from . import layers as L
from . import resnet as R
from . import stem as S
from .extensions import (
    ExtSpec,
    ext_spec_from_custom,
    extended_block,
    gumbel_action,
    init_block_extensions,
)

# SHARE_MODULES names (b32-yfcc-msclips.yaml) -> the block keys they alias
_SHARE_NAME_MAP = {
    "attn.in_proj_weight": ("attn.in_proj_weight",),
    "attn.in_proj_bias": ("attn.in_proj_bias",),
    "attn.out_proj": ("attn.out_proj.weight", "attn.out_proj.bias"),
    "mlp": ("mlp.c_fc.weight", "mlp.c_fc.bias", "mlp.c_proj.weight",
            "mlp.c_proj.bias"),
}
# the compute types the attention kernel takes
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class MSClipSpec:
    """Static architecture description (``msclip_tpu`` ``MSClipSpec``'s
    fields, less the TPU-only ``use_pallas``, ``conv_layout`` and
    ``gather_tensors``)."""

    embed_dim: int = 512
    image_resolution: int = 224
    vision_width: int = 768
    vision_layers: int = 12
    vision_patch_size: int = 32
    vision_heads: int = 12
    # non-empty: the ModifiedResNet tower (VISION.LAYERS as a list)
    vision_resnet_layers: Tuple[int, ...] = ()

    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 768
    text_heads: int = 12
    text_layers: int = 12

    pool_type: str = "default"
    skip_cls: bool = False
    ln_eps: float = 1e-12

    # conv stem (CUSTOM.EARLY_CONV*): EarlyconvRes or the plain 6-conv
    # stem, as visual resblock 0 or as visual.conv1
    early_conv: bool = False
    early_conv_res: bool = True
    early_conv_new_implement: bool = True
    early_conv_first_k: int = 3
    early_conv_strides: Tuple[int, ...] = (2, 2, 2, 2)
    visual_layer_minus1: bool = False

    # Parallel branch + lateral adapters (CUSTOM.PARALLEL*)
    parallel: bool = False
    parallel_n_layers: int = 5
    lateral_layers: Tuple[int, ...] = ()
    parallel_kernels: Tuple[int, ...] = (3, 3, 3, 3, 3)
    parallel_paddings: Tuple[int, ...] = (1, 1, 1, 1, 1)
    parallel_strides: Tuple[int, ...] = (2, 2, 2, 2, 2)
    parallel_resnet_layers: Tuple[int, ...] = (0, 1, 1, 1, 1)
    t2b_kernels: Tuple[int, ...] = (18, 10, 6, 4, 3)
    t2b_paddings: Tuple[int, ...] = (1, 1, 1, 1, 1)
    t2b_strides: Tuple[int, ...] = (16, 8, 4, 2, 1)
    t2b_use_cls: bool = False
    t2b_pool_sizes: Tuple[int, ...] = (0, 0, 0, 0, 0)
    t2b_bn_relu: bool = False
    t2b_bn_ln_relu: bool = False
    t2b_noln_add: bool = False

    # the bottom-to-top back path (reference :1639-1742, :2182-2203)
    parallel_b2t: bool = False
    b2t_mode: str = "deconv"  # deconv | bilinear | crossattn
    b2t_kernels: Tuple[int, ...] = (18, 10, 6, 4, 3)
    b2t_paddings: Tuple[int, ...] = (1, 1, 1, 1, 1)
    b2t_strides: Tuple[int, ...] = (16, 8, 4, 2, 1)
    b2t_no_lastlayer: bool = False
    b2t_layer_flags: Tuple[bool, ...] = (True, True, True, True, True)

    # windowed t2b lateral fusion (reference :1187-1536, :2205-2243)
    t2b_windowattn: bool = False
    window_relative_pos: bool = True

    # Perceiver latents (reference :2105-2124, :2389-2394)
    perceiver_in_v: bool = False
    perceiver_in_t: bool = False
    perceiver_layers: Tuple[int, ...] = ()
    perceiver_n_latents: int = 0

    # Modality sharing (CUSTOM.SHARE_MODULES / N_LAYERS / SHARE_BOTTOM_LAYER)
    share_modules: Tuple[str, ...] = ()
    share_n_layers: int = -1
    share_bottom_layer: bool = False

    compute_dtype: str = "float32"
    vision_drop_path: float = 0.0  # MODEL.SPEC.VISION.DROP_PATH
    use_fused_block: bool = False  # TPU.USE_FUSED_BLOCK: eval through K5
    remat: bool = False  # TPU.REMAT: blocks recomputed in the backward

    # the experimental block families (extensions.py)
    ext: ExtSpec = ExtSpec()

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def grid(self) -> int:
        if not self.early_conv:
            return self.image_resolution // self.vision_patch_size
        if not self.early_conv_res:
            return self.image_resolution // 32  # five stride-2 convs
        return self.image_resolution // (2 * math.prod(
            self.early_conv_strides))

    @property
    def vision_seq_len(self) -> int:
        return self.grid * self.grid + 1

    @property
    def effective_vision_layers(self) -> int:
        """Resblock count after VISUAL_LAYER_MINUS1 (:2509-2511)."""
        return self.vision_layers - (1 if self.visual_layer_minus1 else 0)

    @property
    def stem_in_trunk(self) -> bool:
        """EARLY_CONV_NEW_IMPLEMENT: the conv stem is visual resblock 0
        (reference :2042-2051)."""
        return self.early_conv and self.early_conv_new_implement

    @property
    def stem_prefix(self) -> str:
        return ("visual.transformer.resblocks.0" if self.stem_in_trunk
                else "visual.conv1")

    @property
    def first_block(self) -> int:
        """The first visual resblock that is a transformer block."""
        return 1 if self.stem_in_trunk else 0

    def text_layer_is_shared(self, j: int) -> bool:
        """Does text block ``j`` take the visual trunk's tensors? The
        reference maps text[i + minus1] <- visual resblock i for eligible
        i (``:2808-2830``); a ResNet tower has no trunk to share."""
        if not self.share_modules or self.vision_resnet_layers:
            return False
        i = j - (1 if self.visual_layer_minus1 else 0)
        if i < 0 or i >= self.effective_vision_layers:
            return False
        if self.stem_in_trunk and i == 0:
            return False  # resblock 0 is the conv stem
        if self.share_n_layers == -1:
            return True
        if self.share_bottom_layer:
            return i < self.share_n_layers
        return i >= self.share_n_layers

    def shared_block_keys(self) -> Tuple[str, ...]:
        return tuple(k for name in self.share_modules
                     for k in _SHARE_NAME_MAP[name])

    def b2t_active(self, li: int) -> bool:
        if not self.parallel_b2t or not self.b2t_layer_flags[li]:
            return False
        return not (li == len(self.lateral_layers) - 1
                    and self.b2t_no_lastlayer)

    def window_geometry(self, li: int) -> dict:
        """Stage ``li``'s window-attention geometry (reference
        :2206-2220)."""
        W = self.vision_width
        kv = [W // 16, W // 8, W // 4, W // 2, W][li]
        head = [48, 48, 64, 64, 64][li]
        slide = li == 4
        return {"kv_dim": kv, "head_dim": head, "num_heads": kv // head,
                "window_q": 1, "window_kv": [16, 8, 4, 2, 3][li],
                "slide_window": slide, "slide_kernel": 3 if slide else 0,
                "slide_pad": 1 if slide else 0,
                "slide_stride": 1 if slide else 0}


# ---------------------------------------------------------------------------
# Config -> spec
# ---------------------------------------------------------------------------

# CUSTOM keys that are read elsewhere (training) or accepted by construction
_CUSTOM_KEYS_CONSUMED_ELSEWHERE = frozenset({
    "LR_SHARE", "WD_SHARE", "GUMBEL_LR", "CUSTOM_ATTN",
    "EARLY_CONV_RES_BLOCK", "EARLY_CONV_RES_LAYERS",
})


class _KeyRecorder:
    """Records which ``config.CUSTOM`` keys the spec reads, so that keys it
    never reads can be reported instead of becoming silent no-ops."""

    def __init__(self, node):
        self._node = node
        self.seen: set = set()

    def get(self, key, default=None):
        self.seen.add(key)
        return self._node.get(key, default)


def _validate(config, custom: _KeyRecorder) -> None:
    """Raise for what the JAX package's ``_validate_spec_config`` rejects
    (the reference's own asserts) and for the TPU options that exclude
    each other. ``TPU.USE_FUSED_BLOCK`` builds at any width, as in JAX:
    the CPU runs K5's plain version, and on the card K5 takes the widths
    it is built for (``ops.block_fused.WIDTHS``) and raises for another."""
    text = config.MODEL.SPEC.TEXT
    if text.get("STYLE", "clip") != "clip" or \
            text.get("TOKENIZER", "clip") != "clip":
        raise ValueError(
            "only the CLIP text transformer and BPE tokenizer exist (the "
            "reference asserts TEXT.STYLE == 'clip', "
            "clip_openai_pe_res_v1.py:2994,3011)")
    if custom.get("EARLY_CONV_RES_BLOCK", "basic_v0") != "basic_v0":
        raise ValueError("CUSTOM.EARLY_CONV_RES_BLOCK must be 'basic_v0' "
                         "(reference asserts :1968-1970)")
    layers = custom.get("EARLY_CONV_RES_LAYERS", None)
    if layers is not None and any(n != 1 for n in layers):
        raise ValueError("CUSTOM.EARLY_CONV_RES_LAYERS must be all 1 "
                         "(reference asserts :1968-1970)")
    tpu = config.TPU
    if tpu.get("USE_FUSED_BLOCK", False) and tpu.get("INT8_EVAL", False):
        raise ValueError(
            "TPU.INT8_EVAL and TPU.USE_FUSED_BLOCK are mutually exclusive "
            "(the bf16 half-block megakernel reads full-precision "
            "weights; msclip_tpu/models/quantize.py:71-75)")
    if int(tpu.get("MESH_MODEL", 1)) > 1:
        for key, why in (
                ("INT8_EVAL", "the int8 eval path quantizes each whole GEMM "
                 "weight a row on one process"),
                ("USE_FUSED_BLOCK", "the fused half-block kernels (K5, K6) "
                 "take a whole block, every head and both projections, in "
                 "one launch")):
            if tpu.get(key, False):
                raise ValueError(f"TPU.{key} cannot run with tensor "
                                 f"parallelism (TPU.MESH_MODEL > 1): {why}")


def spec_from_config(config) -> MSClipSpec:
    """An MSClipSpec from a merged config tree, reading the keys of the
    reference factory (``get_clip_model`` ``:3182-3227``) as
    ``msclip_tpu.models.msclip.spec_from_config`` does. What it rejects
    raises (:func:`_validate`); CUSTOM keys the spec never reads are
    warned about."""
    custom = _KeyRecorder(config.CUSTOM)
    _validate(config, custom)
    spec_cfg = config.MODEL.SPEC
    vision, text = spec_cfg.VISION, spec_cfg.TEXT
    width = vision.get("WIDTH", 768)
    n_parallel = custom.get("PARALLEL_N_LAYERS", 5)
    layers_cfg = vision.get("LAYERS", 12)
    if isinstance(layers_cfg, int):
        resnet_layers, vision_layers, heads = (), layers_cfg, width // 64
    else:  # the ResNet tower: heads = width * 32 // 64 (reference :2749)
        resnet_layers, vision_layers, heads = tuple(layers_cfg), 0, \
            width * 32 // 64
    dtype = config.TPU.COMPUTE_DTYPE
    if dtype not in _DTYPES:
        raise ValueError(f"TPU.COMPUTE_DTYPE={dtype!r} not in {list(_DTYPES)}")
    spec = MSClipSpec(
        embed_dim=spec_cfg.get("EMBED_DIM", 512),
        image_resolution=config.TRAIN.IMAGE_SIZE[0],  # as the reference
        vision_width=width,
        vision_layers=vision_layers,
        vision_resnet_layers=resnet_layers,
        vision_patch_size=vision.get("PATCH_SIZE", 32),
        vision_heads=heads,
        context_length=text.get("CONTEXT_LENGTH", 77),
        vocab_size=text.get("VOCAB_SIZE", 49408),
        text_width=text.get("WIDTH", 512),
        text_heads=text.get("HEADS", 8),
        text_layers=text.get("LAYERS", 12),
        pool_type=spec_cfg.get("POOL_TYPE", "default"),
        skip_cls=spec_cfg.get("SKIP_CLS", False),
        early_conv=custom.get("EARLY_CONV", False),
        early_conv_res=custom.get("EARLY_CONV_RES", False),
        early_conv_new_implement=custom.get("EARLY_CONV_NEW_IMPLEMENT",
                                            False),
        visual_layer_minus1=custom.get("VISUAL_LAYER_MINUS1", False),
        early_conv_first_k=custom.get("EARLY_CONV_RES_FIRSTCONV_KERNEL", 3),
        early_conv_strides=tuple(
            custom.get("EARLY_CONV_RES_STRIDES", [2, 2, 2, 2])),
        parallel=custom.get("PARALLEL_IN_V", False),
        parallel_n_layers=n_parallel,
        lateral_layers=tuple(custom.get("PARALLEL_LATERAL_LAYER", [])),
        parallel_kernels=tuple(custom.get("PARALLEL_KERNELS", [3] * 5)),
        parallel_paddings=tuple(custom.get("PARALLEL_PADDINGS", [1] * 5)),
        parallel_strides=tuple(custom.get("PARALLEL_STRIDES", [2] * 5)),
        parallel_resnet_layers=tuple(
            custom.get("PARALLEL_RESNET_LAYERS", [0, 1, 1, 1, 1]))
        if custom.get("PARALLEL_RESNET", False) else (0,) * n_parallel,
        t2b_kernels=tuple(custom.get("PRALLEL_T2B_KERNELS",
                                     [18, 10, 6, 4, 3])),
        t2b_paddings=tuple(custom.get("PRALLEL_T2B_PADDINGS", [1] * 5)),
        t2b_strides=tuple(custom.get("PRALLEL_T2B_STRIDES",
                                     [16, 8, 4, 2, 1])),
        t2b_use_cls=custom.get("PRALLEL_T2B_USECLS", False),
        t2b_pool_sizes=tuple(custom.get("PARALLEL_T2B_POOL_SIZE",
                                        [0, 0, 0, 0, 0]) or [0] * 5),
        t2b_bn_relu=custom.get("PRALLEL_T2B_ADD_BN_RELU", False),
        t2b_bn_ln_relu=custom.get("PRALLEL_T2B_ADD_BN_LN_RELU", False),
        t2b_noln_add=custom.get("PRALLEL_T2B_NOLN_ADD", False),
        parallel_b2t=custom.get("PARALLEL_B2T", False),
        b2t_mode=("bilinear" if custom.get("PARALLEL_B2T_BILINEAR", False)
                  else "crossattn"
                  if custom.get("PARALLEL_B2T_CROSSATTN", False)
                  else "deconv"),
        b2t_no_lastlayer=custom.get("PARALLEL_B2T_NO_LASTLAYER", False),
        b2t_layer_flags=tuple(custom.get("PARALLEL_B2T_LAYER", [True] * 5)),
        t2b_windowattn=custom.get("PARALLEL_T2B_WINDOWATTN", False),
        window_relative_pos=custom.get("T2B_WINDOWATTN_RELATIVE_POS", True),
        perceiver_in_v=custom.get("PERCEIVER_IN_V", False),
        perceiver_in_t=custom.get("PERCEIVER_IN_T", False),
        perceiver_layers=tuple(custom.get("PERCEIVER_LAYER", [])),
        perceiver_n_latents=custom.get("PERCEIVER_N_LATENT", 0),
        share_modules=tuple(custom.get("SHARE_MODULES", []) or []),
        share_n_layers=custom.get("N_LAYERS", -1),
        share_bottom_layer=custom.get("SHARE_BOTTOM_LAYER", False),
        compute_dtype=dtype,
        vision_drop_path=vision.get("DROP_PATH", 0.0),
        use_fused_block=bool(config.TPU.get("USE_FUSED_BLOCK", False)),
        remat=bool(config.TPU.get("REMAT", False)),
        ext=ext_spec_from_custom(custom),
    )
    unread = (set(config.CUSTOM.keys()) - custom.seen
              - _CUSTOM_KEYS_CONSUMED_ELSEWHERE)
    if unread:
        warnings.warn(
            f"CUSTOM keys set but never read by the model spec: "
            f"{sorted(unread)} — they have NO effect (unknown or "
            "unsupported; check spelling against config/defaults.py and "
            "the reference CUSTOM namespace).", stacklevel=2)
    return spec


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(spec: MSClipSpec, generator: torch.Generator,
                device="cpu"):
    """Random parameters in the reference layout, fp32, drawn on the CPU
    from ``generator`` (so a seed gives the same weights on any device),
    then moved to ``device``. Distributions follow the reference's
    construction (SURVEY.md §3.4): xavier-uniform in-projections,
    trunc-normal(0.02) Linear/Conv, ``width**-0.5 * randn`` visual
    embeddings, N(0, 1) token embedding, ``logit_scale = 1``; the Gumbel
    logits ``1e-3 randn`` (reference :2745)."""
    g = generator
    W, E = spec.vision_width, spec.embed_dim
    p = {"logit_scale": torch.ones(())}
    if spec.vision_resnet_layers:
        p.update(R.init_modified_resnet(spec.vision_resnet_layers, E, W,
                                        spec.image_resolution, g))
    else:
        p.update(_init_vit(spec, g))
    p.update(_init_text(spec, g))
    if spec.ext.gumbel_select:
        p["gumbel_logit"] = L.normal((spec.vision_layers, 2), g, 1e-3)
    return {k: v.to(device) for k, v in p.items()}


def _init_vit(spec: MSClipSpec, g):
    W, E = spec.vision_width, spec.embed_dim
    vis_scale = W ** -0.5
    p = {
        "visual.class_embedding": L.normal((W,), g, vis_scale),
        "visual.positional_embedding":
            L.normal((spec.vision_seq_len, W), g, vis_scale),
        "visual.proj": L.normal((W, E), g, vis_scale),
    }
    p.update(L.init_layer_norm("visual.ln_pre", W))
    p.update(L.init_layer_norm("visual.ln_post", W))
    if not spec.early_conv:
        p.update(L.init_conv("visual.conv1.weight", spec.vision_patch_size, 3,
                             W, g))
    elif spec.early_conv_res:
        p.update(S.init_earlyconv_res(spec.stem_prefix, W, g,
                                      spec.early_conv_first_k,
                                      len(spec.early_conv_strides)))
    else:
        p.update(S.init_plain_conv_stem(spec.stem_prefix, W, g))
    for i in range(spec.first_block, spec.effective_vision_layers):
        prefix = f"visual.transformer.resblocks.{i}"
        p.update(L.init_block(prefix, W, g))
        p.update(init_block_extensions(prefix, spec.ext, W, spec.vision_heads,
                                       "visual", i, g))
    if spec.parallel:
        p.update(S.init_parallel_branch(
            "visual.transformer.parallel_branch_v", W, spec.parallel_n_layers,
            spec.parallel_resnet_layers, spec.parallel_kernels, g))
        out_dims = [W // 16, W // 8, W // 4, W // 2, W]
        for i in range(len(spec.lateral_layers)):
            at = f"visual.transformer.parallel_lateral_adapter.{i}"
            if spec.t2b_windowattn:
                geo = spec.window_geometry(i)
                p.update(X.init_window_cross_attention(
                    at, W, geo["kv_dim"], geo["kv_dim"], geo["kv_dim"],
                    geo["window_q"], geo["window_kv"], geo["num_heads"], g,
                    output_dim=W, relative_pos=spec.window_relative_pos))
                continue
            p.update(S.init_lateral_adapter(
                at, out_dims[i], W, spec.t2b_kernels[i], g,
                bn_relu=spec.t2b_bn_relu, bn_ln_relu=spec.t2b_bn_ln_relu,
                noln_add=spec.t2b_noln_add))
            if spec.b2t_active(i):
                p.update(S.init_lateral_adapter_b2t(
                    at, out_dims[i], W, spec.b2t_kernels[i], g,
                    mode=spec.b2t_mode))
    if spec.perceiver_in_v:
        p.update(_init_perceiver("visual.transformer", spec, W, g))
    if spec.pool_type == "linear":
        p.update(_init_conv_pool(
            "visual.conv_pool", W,
            spec.vision_seq_len - (1 if spec.skip_cls else 0), g))
    return p


def _init_perceiver(trunk, spec: MSClipSpec, dim, g):
    p = {f"{trunk}.perceiver_latent":
         L.normal((spec.perceiver_n_latents, dim), g)}
    for i in range(len(spec.perceiver_layers)):
        p.update(X.init_residual_cross_block(
            f"{trunk}.perceiver_latent2ori_blocks.{i}", dim, g))
    return p


def _init_conv_pool(prefix, width, length, g):
    """The grouped Conv1d pooling head (POOL_TYPE 'linear', reference
    :2516-2522): weight ``[C, 1, L]``, one per channel and position."""
    return {f"{prefix}.weight": L.trunc_normal((width, 1, length), g),
            f"{prefix}.bias": torch.zeros(width)}


def _init_text(spec: MSClipSpec, g):
    TW, E = spec.text_width, spec.embed_dim
    p = {}
    shared = set(spec.shared_block_keys())
    for i in range(spec.text_layers):
        prefix = f"transformer.resblocks.{i}"
        blk = L.init_block(prefix, TW, g)
        if spec.text_layer_is_shared(i):
            blk = {k: v for k, v in blk.items()
                   if k.split(".", 3)[3] not in shared}
        p.update(blk)
        p.update(init_block_extensions(prefix, spec.ext, TW, spec.text_heads,
                                       "text", i, g))
    p["token_embedding.weight"] = L.normal((spec.vocab_size, TW), g)
    p["positional_embedding"] = L.trunc_normal((spec.context_length, TW), g)
    p["text_projection"] = L.trunc_normal((TW, E), g)
    p.update(L.init_layer_norm("ln_final", TW))
    if spec.pool_type == "linear":
        p.update(_init_conv_pool("conv_pool", TW, spec.context_length, g))
    if spec.perceiver_in_t:
        p.update(_init_perceiver("transformer", spec, TW, g))
    return p


def resolve_text_block(params, spec: MSClipSpec, i: int):
    """Local-name params of text block ``i``: its own tensors, with the
    shared attn/mlp taken from the visual trunk. Text block ``i`` shares
    visual resblock ``i - minus1`` (``msclip.py:670-694``)."""
    own = f"transformer.resblocks.{i}"
    if not spec.text_layer_is_shared(i):
        return L.block_params(params, own)
    vis = "visual.transformer.resblocks." \
        f"{i - (1 if spec.visual_layer_minus1 else 0)}"
    shared = set(spec.shared_block_keys())
    out = {}
    for k in L.BLOCK_KEYS:
        src = vis if k in shared else own
        for name in L.stored_names(params, src, k):  # int8 eval: two each
            out[name] = params[f"{src}.{name}"]
    return out


BN_STATS = ("running_mean", "running_var")


def is_bn_stat(key: str) -> bool:
    return key.rsplit(".", 1)[-1] in BN_STATS


_QUANTIZED = tuple(k + suffix for k in L.GEMM_KEYS
                   for suffix in L.INT8_SUFFIXES)


def cast_params(params, dtype=torch.bfloat16):
    """Cast every tensor to ``dtype`` except BN running statistics and the
    int8 GEMM weights of int8 eval with their fp32 scales."""
    return {k: v if is_bn_stat(k) or k.endswith(_QUANTIZED) else v.to(dtype)
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _block_fn(spec: MSClipSpec, dropping: bool = False):
    """The trunk/text block (``_block_fn``): the fused block with
    ``use_fused_block`` and no drop-path, else ``layers.transformer_block``,
    under ``torch.utils.checkpoint`` with ``spec.remat`` (its activations
    recomputed in the backward; any drop-path masks come in as ``keep``,
    so the recomputation draws nothing)."""
    if spec.use_fused_block and not dropping:
        def fused(p, x, n_head, mask, **kw):
            # the CPU runs K5's plain version at any width, the card K5 at
            # the widths it is built for
            return fused_block(x, p, n_head, mask, spec.ln_eps)

        return fused

    def block(p, x, n_head, mask, **kw):
        return L.transformer_block(p, x, n_head, mask, spec.ln_eps, **kw)

    if not spec.remat:
        return block

    def remat_block(p, x, n_head, mask, **kw):
        return torch.utils.checkpoint.checkpoint(
            block, p, x, n_head, mask, use_reentrant=False,
            preserve_rng_state=False, **kw)

    return remat_block


def _gumbel(params, spec: MSClipSpec, action):
    """The Gumbel action ``[layers, 2]`` and its hard choices (shared
    branch or not, a layer), read on the host once: the given ``action``,
    or at eval the deterministic argmax of the logits (what the JAX
    package's ``forward`` takes without a key)."""
    if not spec.ext.gumbel_select:
        return None, None
    if action is None:
        action = gumbel_action(params["gumbel_logit"])
    return action, (action[:, 0] > action[:, 1]).tolist()


def image_tokens(params, spec: MSClipSpec, x, bn: S.BNState):
    """NCHW images -> the trunk's input ``[B, 1 + g*g, W]``: the stem (the
    patchify conv, EarlyconvRes or the plain 6-conv stem), CLS,
    positional embedding, ``ln_pre``."""
    B, W = x.shape[0], spec.vision_width
    if not spec.early_conv:
        fmap = L.conv2d(x, params["visual.conv1.weight"],
                        spec.vision_patch_size)
    elif spec.early_conv_res:
        fmap = S.apply_earlyconv_res(params, spec.stem_prefix, x,
                                     spec.early_conv_strides,
                                     spec.early_conv_first_k, bn)
    else:
        fmap = S.apply_plain_conv_stem(params, spec.stem_prefix, x, bn)
    tokens = fmap.flatten(2).transpose(1, 2)  # [B, g*g, W]
    cls_tok = params["visual.class_embedding"].to(spec.dtype).expand(B, 1, W)
    tokens = torch.cat([cls_tok, tokens], dim=1)
    tokens = tokens + params["visual.positional_embedding"].to(spec.dtype)
    return L.layer_norm(tokens, params["visual.ln_pre.weight"],
                        params["visual.ln_pre.bias"], spec.ln_eps)


def encode_image(params, spec: MSClipSpec, images, *, normalize=True,
                 bn: S.BNState | None = None, generator=None, rows=None,
                 tp=None, action=None):
    """``[B, H, W, 3]`` preprocessed images -> ``[B, embed_dim]``: the
    ModifiedResNet tower, or stem -> tokens -> +CLS/+pos/ln_pre -> trunk
    blocks (the Perceiver blocks, the parallel branch and its adapters at
    their layers; the extension families' blocks) -> pool -> ln_post ->
    proj. Under a profiler the stem (from the input's cast through
    ``ln_pre``), each branch stage with its adapter and each trunk block
    run in the spans ``msclip.image.stem``, ``msclip.image.branch`` and
    ``msclip.image.block`` (``utils.summary.span``).

    ``bn``: the BatchNorm context (eval when None). ``generator``: a
    ``torch.Generator`` on the images' device that drives DropPath
    (``spec.vision_drop_path``) in the plain trunk blocks; None turns it
    off. ``rows=(first, total)``: the images are rows ``first ..`` of a
    global batch of ``total``, whose DropPath masks are drawn whole
    (``layers.drop_path_keep``). ``tp``: the model group of tensor
    parallelism, whose process holds its part of each trunk block
    (``parallel/mesh.split_for_model``). ``action``: the Gumbel action
    ``[vision_layers, 2]`` (``GUMBEL_SELECT``; the deterministic one when
    None)."""
    bn = bn or S.BNState()
    if spec.vision_resnet_layers:
        feats = R.apply_modified_resnet(params, _nchw(images, spec),
                                        spec.vision_resnet_layers,
                                        spec.vision_heads, bn)
        return L.l2_normalize(feats) if normalize else feats
    g = spec.grid
    with span("msclip.image.stem"):
        x = _nchw(images, spec)
        tokens = image_tokens(params, spec, x, bn)

    # with an extension family on, the JAX package runs every block as an
    # extended block, which drops no path
    dropping = spec.vision_drop_path > 0.0 and generator is not None \
        and not spec.ext.any_active
    block = _block_fn(spec, dropping)
    action, take_shared = _gumbel(params, spec, action)
    parallel_x = None
    for idx in range(spec.first_block, spec.effective_vision_layers):
        if spec.perceiver_in_v and idx in spec.perceiver_layers:
            tokens = _perceiver(params, "visual.transformer", spec,
                                spec.perceiver_layers.index(idx), tokens,
                                spec.vision_heads, tp)
        if spec.parallel and idx in spec.lateral_layers:
            with span("msclip.image.branch"):
                parallel_x, tokens = _lateral(params, spec, idx, x,
                                              parallel_x, tokens, bn)
        prefix = f"visual.transformer.resblocks.{idx}"
        if spec.ext.block_has_any("visual", idx):
            with span("msclip.image.block"):
                tokens = extended_block(
                    L.block_params(params, prefix), params, prefix, tokens,
                    spec.vision_heads, spec.ext, "visual", (g, g),
                    eps=spec.ln_eps, bn=bn,
                    action=None if action is None else action[idx],
                    take_shared=None if action is None else take_shared[idx],
                    tp=tp)
            continue
        keep = None
        if dropping:  # drawn here, in block order, for both branches
            keep = tuple(L.drop_path_keep(tokens, spec.vision_drop_path,
                                          generator, rows)
                         for _ in range(2))
        with span("msclip.image.block"):
            tokens = block(L.block_params(params, prefix), tokens,
                           spec.vision_heads, None,
                           drop_path_rate=spec.vision_drop_path, keep=keep,
                           tp=tp)

    pooled = _pool(tokens, spec, params, "visual.conv_pool")
    pooled = L.layer_norm(pooled, params["visual.ln_post.weight"],
                          params["visual.ln_post.bias"], spec.ln_eps)
    feats = pooled @ params["visual.proj"].to(spec.dtype)
    return L.l2_normalize(feats) if normalize else feats


def _nchw(images, spec: MSClipSpec):
    """``[B, H, W, 3]`` images in the compute dtype, as NCHW. Contiguous:
    the CPU build's oneDNN conv backward corrupts the heap when the stem's
    input keeps the permuted (channels-last) strides."""
    return images.to(spec.dtype).permute(0, 3, 1, 2).contiguous()


def _perceiver(params, trunk, spec: MSClipSpec, pi, x, n_head, tp=None):
    """The Perceiver block ``pi``: ``x`` attends to the learned latents."""
    latent = params[f"{trunk}.perceiver_latent"].to(x.dtype).expand(
        x.shape[0], -1, -1)
    return X.residual_cross_block(
        params, f"{trunk}.perceiver_latent2ori_blocks.{pi}", x, latent,
        n_head, spec.ln_eps, tp)


def _lateral(params, spec: MSClipSpec, idx, x, parallel_x, tokens, bn):
    """The branch stage and lateral adapter at trunk layer ``idx``:
    ``(new branch map, fused tokens)``."""
    li = spec.lateral_layers.index(idx)
    g = spec.grid
    parallel_x = S.apply_parallel_stage(
        params, f"visual.transformer.parallel_branch_v.{li}",
        x if li == 0 else parallel_x, spec.parallel_strides[li],
        spec.parallel_paddings[li], spec.parallel_resnet_layers[li], bn)
    at = f"visual.transformer.parallel_lateral_adapter.{li}"
    if spec.t2b_windowattn:
        geo = spec.window_geometry(li)
        return X.window_cross_attention(
            params, at, parallel_x, tokens, (g, g),
            num_heads=geo["num_heads"], head_qk_dim=geo["head_dim"],
            window_q=geo["window_q"],
            window_kv=geo["window_kv"], slide_window=geo["slide_window"],
            slide_kernel=geo["slide_kernel"], slide_pad=geo["slide_pad"],
            slide_stride=geo["slide_stride"],
            relative_pos=spec.window_relative_pos, bn=bn, eps=spec.ln_eps)
    B, _, C = tokens.shape
    pre_cls = tokens[:, :1, :]
    pre_grid = tokens[:, 1:, :].transpose(1, 2).reshape(B, C, g, g)
    new_top, tokens = S.apply_lateral_adapter(
        params, at, parallel_x, tokens, (g, g), spec.t2b_strides[li],
        spec.t2b_paddings[li], use_cls=spec.t2b_use_cls, eps=spec.ln_eps,
        bn=bn, pool_kernel=spec.t2b_pool_sizes[li],
        bn_relu=spec.t2b_bn_relu, bn_ln_relu=spec.t2b_bn_ln_relu,
        noln_add=spec.t2b_noln_add)
    if spec.b2t_active(li):
        new_top = S.apply_lateral_adapter_b2t(
            params, at, parallel_x, pre_grid, pre_cls, spec.b2t_mode,
            spec.b2t_strides[li], spec.b2t_paddings[li], bn, spec.ln_eps)
    return new_top, tokens


def encode_text(params, spec: MSClipSpec, tokens, *, normalize=True,
                tp=None, action=None):
    """``[B, 77]`` token ids -> ``[B, embed_dim]``: embedding + positional,
    causal blocks (shared ones read the visual trunk; the Perceiver and
    the extension families' blocks at their layers), EOT (or mean, or
    conv1d) pooling, ln_final, text projection. ``tp`` and ``action`` as
    :func:`encode_image`'s."""
    x = params["token_embedding.weight"][tokens.long()].to(spec.dtype)
    x = x + params["positional_embedding"].to(spec.dtype)
    mask = L.build_causal_mask(spec.context_length, device=x.device)
    block = _block_fn(spec)
    action, take_shared = _gumbel(params, spec, action)
    for i in range(spec.text_layers):
        if spec.perceiver_in_t and i in spec.perceiver_layers:
            x = _perceiver(params, "transformer", spec,
                           spec.perceiver_layers.index(i), x, spec.text_heads,
                           tp)
        blk = resolve_text_block(params, spec, i)
        if spec.ext.block_has_any("text", i):
            x = extended_block(
                blk, params, f"transformer.resblocks.{i}", x,
                spec.text_heads, spec.ext, "text", None, mask=mask,
                eps=spec.ln_eps,
                action=None if action is None else action[i],
                take_shared=None if action is None else take_shared[i],
                tp=tp)
            continue
        x = block(blk, x, spec.text_heads, mask, tp=tp)
    if spec.pool_type == "linear":
        pooled = _conv_pool(x, params, "conv_pool")
    elif spec.pool_type != "default":
        pooled = x.mean(dim=1)
    else:
        # EOT pooling: the EOT token has the highest id in each row;
        # argmax returns its (first) position (reference :3055-3060)
        eot = tokens.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    pooled = L.layer_norm(pooled, params["ln_final.weight"],
                          params["ln_final.bias"], spec.ln_eps)
    feats = pooled @ params["text_projection"].to(spec.dtype)
    return L.l2_normalize(feats) if normalize else feats


def forward(params, spec: MSClipSpec, images, tokens, *,
            bn: S.BNState | None = None, generator=None, action=None):
    """Training logits ``exp(logit_scale) * img @ txt.T`` ``[B, B]`` over
    the one-card batch (``msclip_tpu/models/msclip.py:949-966`` without
    the cross-device gather)."""
    feats_i = encode_image(params, spec, images, bn=bn, generator=generator,
                           action=action)
    feats_t = encode_text(params, spec, tokens, action=action)
    T = torch.exp(params["logit_scale"]).to(feats_i.dtype)
    return T * feats_i @ feats_t.t()


def _conv_pool(tokens, params, prefix):
    """The grouped Conv1d over the sequence (reference :2678-2683):
    ``out[b, c] = sum_l tokens[b, l, c] w[c, 0, l] + bias[c]``."""
    w = params[f"{prefix}.weight"][:, 0, :].t().to(tokens.dtype)  # [L, C]
    return torch.einsum("blc,lc->bc", tokens, w) \
        + params[f"{prefix}.bias"].to(tokens.dtype)


def _pool(tokens, spec: MSClipSpec, params=None, prefix=None):
    if spec.pool_type in ("average", "linear") and spec.skip_cls:
        tokens = tokens[:, 1:, :]
    if spec.pool_type == "average":
        return tokens.mean(dim=1)
    if spec.pool_type == "linear":
        return _conv_pool(tokens, params, prefix)
    return tokens[:, 0, :]  # 'default': the CLS token


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------

class MSClipModel(nn.Module):
    """A spec and its parameters as a module tree whose ``state_dict()``
    keys are the reference names; ``.to(device)`` moves every tensor.

    ``trainable=False`` (eval): every tensor is a buffer.
    ``trainable=True``: every tensor but the BN running statistics is an
    ``nn.Parameter``; the running statistics stay buffers, updated from
    the forward's ``BNState`` and never by the optimizer."""

    def __init__(self, spec: MSClipSpec, params, trainable: bool = False):
        super().__init__()
        self.spec = spec
        for key, tensor in params.items():
            *path, leaf = key.split(".")
            mod = self
            for part in path:
                if part not in mod._modules:
                    mod.add_module(part, nn.Module())
                mod = mod._modules[part]
            if trainable and not is_bn_stat(key):
                mod.register_parameter(leaf, nn.Parameter(tensor))
            else:
                mod.register_buffer(leaf, tensor)

    def params(self):
        """The flat reference-layout dict the apply functions take."""
        return {**dict(self.named_parameters()), **dict(self.named_buffers())}

    def encode_image(self, images, **kw):
        return encode_image(self.params(), self.spec, images, **kw)

    def encode_text(self, tokens, **kw):
        return encode_text(self.params(), self.spec, tokens, **kw)


def set_fp32_precision(spec: MSClipSpec) -> None:
    """With an fp32 compute dtype, keep fp32 matmuls and convs in full fp32
    on the card (the JAX package runs them at Precision.HIGHEST); cuDNN
    convs would otherwise take TF32."""
    if spec.dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def build_spec(config) -> MSClipSpec:
    spec = spec_from_config(config)
    set_fp32_precision(spec)
    return spec


def build_model(config, generator: Optional[torch.Generator] = None,
                device=None) -> MSClipModel:
    """The reference factory (``get_clip_model(config)``): an eval
    :class:`MSClipModel` of the config's spec with random parameters from
    ``generator`` (default: seeded with ``TPU.SEED``, as the train CLI
    draws them) on ``device`` (default the card; raises without one)."""
    from ..eval.device import resolve_device

    spec = build_spec(config)
    if generator is None:
        generator = torch.Generator().manual_seed(
            int(config.TPU.get("SEED", 0)))
    return MSClipModel(spec, init_params(
        spec, generator, resolve_device(device or "cuda")))


def param_count(params_or_module) -> int:
    """The number of elements over every tensor of a parameter dict or a
    module (its parameters and buffers: the BN running statistics count,
    as in the JAX package's pytree)."""
    if isinstance(params_or_module, nn.Module):
        params_or_module = params_or_module.state_dict()
    return sum(t.numel() for t in params_or_module.values())

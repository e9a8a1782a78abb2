"""MS-CLIP-S, the eval and train paths of ``msclip_tpu/models/msclip.py``.

Parameters are one flat dict in the reference MS-CLIP ``state_dict`` layout
(``visual.transformer.resblocks.<i>.attn.in_proj_weight``, ...), holding
each tensor once: a text block that shares the visual trunk's attn/mlp
(``CUSTOM.SHARE_MODULES``) has no keys of its own for them, and
:func:`resolve_text_block` reads the trunk's. For int8 eval
(``TPU.INT8_EVAL``, ``models/quantize.py``) each trunk GEMM weight is held
as an int8 tensor and its fp32 scale instead. With ``TPU.USE_FUSED_BLOCK``
(eval only) every trunk and text block runs ``ops.block_fused.fused_block``
(the fused attention half-block K5, then the MLP half unfused). Activations are batch-first
``[B, L, D]``; ``encode_image`` takes ``[B, H, W, 3]`` like the JAX
function and runs the conv stem and branch in NCHW.

:class:`MSClipModel` holds the dict as a module tree: buffers only for eval
(``load_eval_model``), or, with ``trainable=True``, the trained tensors as
``nn.Parameter``s and the BatchNorm running statistics as buffers.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.utils.checkpoint

from ..ops.block_fused import fused_block
from . import layers as L
from . import stem as S

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
    """Static architecture description of an MS-CLIP-S model."""

    embed_dim: int = 512
    image_resolution: int = 224
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12

    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 768
    text_heads: int = 12
    text_layers: int = 12

    pool_type: str = "default"
    skip_cls: bool = False
    ln_eps: float = 1e-12

    # EarlyconvRes stem (CUSTOM.EARLY_CONV_RES*), visual resblock 0
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

    # Modality sharing (CUSTOM.SHARE_MODULES / N_LAYERS / SHARE_BOTTOM_LAYER)
    share_modules: Tuple[str, ...] = ()
    share_n_layers: int = -1
    share_bottom_layer: bool = False

    compute_dtype: str = "float32"
    vision_drop_path: float = 0.0  # MODEL.SPEC.VISION.DROP_PATH
    use_fused_block: bool = False  # TPU.USE_FUSED_BLOCK: eval through K5
    remat: bool = False  # TPU.REMAT: blocks recomputed in the backward

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def grid(self) -> int:
        return self.image_resolution // (2 * math.prod(self.early_conv_strides))

    @property
    def vision_seq_len(self) -> int:
        return self.grid * self.grid + 1

    @property
    def effective_vision_layers(self) -> int:
        """Resblock count after VISUAL_LAYER_MINUS1 (:2509-2511)."""
        return self.vision_layers - (1 if self.visual_layer_minus1 else 0)

    # EARLY_CONV_NEW_IMPLEMENT: the stem is visual resblock 0, so the
    # transformer blocks are resblocks 1.. (reference :2042-2051)
    stem_prefix = "visual.transformer.resblocks.0"
    first_block = 1

    def text_layer_is_shared(self, j: int) -> bool:
        """Does text block ``j`` take the visual trunk's tensors? The
        reference maps text[i + minus1] <- visual resblock i for eligible
        i (``:2808-2830``)."""
        if not self.share_modules:
            return False
        i = j - (1 if self.visual_layer_minus1 else 0)
        if i < 0 or i >= self.effective_vision_layers:
            return False
        if i == 0:
            return False  # resblock 0 is the conv stem
        if self.share_n_layers == -1:
            return True
        if self.share_bottom_layer:
            return i < self.share_n_layers
        return i >= self.share_n_layers

    def shared_block_keys(self) -> Tuple[str, ...]:
        return tuple(k for name in self.share_modules
                     for k in _SHARE_NAME_MAP[name])


# ---------------------------------------------------------------------------
# Config -> spec, with loud rejection of what this slice does not port
# ---------------------------------------------------------------------------

# CUSTOM keys that are read elsewhere (training) or accepted by construction
_CUSTOM_KEYS_CONSUMED_ELSEWHERE = frozenset({
    "LR_SHARE", "WD_SHARE", "GUMBEL_LR", "CUSTOM_ATTN",
    "EARLY_CONV_RES_BLOCK", "EARLY_CONV_RES_LAYERS",
})

# the experimental plug-in families of msclip_tpu/models/extensions.py:
# their switches are read (and must be off); their other knobs are inert
_EXT_SWITCHES = ("ADAPTER_FLAG", "CVT_IN_V", "CONTAINER_IN_V", "CONVIT_IN_V",
                 "GUMBEL_SELECT")
_EXT_KNOBS = frozenset({
    "ADAPTER_ATTN_DIM", "ADAPTER_LAYERS", "CVT_INSIDE", "CVT_LAYERS",
    "CVT_V_KERNEL", "CVT_V_STRIDE", "CVT_V_PAD", "CVT_V_RES",
    "THREE_DWC_IN_CVT", "TWO_DWC_IN_CVT", "CVT_INSIDE_Q", "CVT_INSIDE_K",
    "CVT_INSIDE_V", "CONTAINER_V_KERNEL", "CONTAINER_V_STRIDE",
    "CONTAINER_V_PAD", "CONVIT_LAYERS", "CONVIT_LOCAL_STRENGTH",
    "LORA_ATTN_ALPHA", "LORA_WHERE_ADD", "LORA_MOE", "LORA_MOE_ACT",
    "LORA_MOE_LAMBDA", "LORA_MOE_SOFTMAX", "LORA_MOE_GROUP", "GUMBEL_ADDTWO",
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


def _not_ported(what: str, roadmap: str):
    raise NotImplementedError(
        f"{what} is not ported to msclip_torch yet (ROADMAP {roadmap}); "
        "use msclip_tpu for it")


def _reject_unported(config, custom: _KeyRecorder) -> None:
    """Raise for every configured feature outside the ported MS-CLIP-S
    paths (eval, serving, the multi-process train step), naming the
    ROADMAP item that ports it."""
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
    if not isinstance(config.MODEL.SPEC.VISION.get("LAYERS", 12), int):
        _not_ported("the ModifiedResNet vision tower", "M10")
    if not custom.get("EARLY_CONV", False):
        _not_ported("the patchify ViT stem (CUSTOM.EARLY_CONV off)", "M10")
    if not custom.get("EARLY_CONV_RES", False):
        _not_ported("the plain 6-conv stem (CUSTOM.EARLY_CONV_RES off)",
                    "M10")
    if not custom.get("EARLY_CONV_NEW_IMPLEMENT", False):
        _not_ported("the stem outside the trunk "
                    "(CUSTOM.EARLY_CONV_NEW_IMPLEMENT off)", "M10")
    for key in _EXT_SWITCHES:
        if custom.get(key, False):
            _not_ported(f"the experimental block family CUSTOM.{key} "
                        "(ext.any_active)", "M10")
    custom.get("LORA_OPEN", False)  # LoRA is on whenever its dim is set
    if custom.get("LORA_ATTN_DIM", 0):
        _not_ported("LoRA (CUSTOM.LORA_ATTN_DIM, ext.any_active)", "M10")
    for key in ("PERCEIVER_IN_V", "PERCEIVER_IN_T"):
        if custom.get(key, False):
            _not_ported(f"the Perceiver latents (CUSTOM.{key})", "M10")
    if custom.get("PARALLEL_B2T", False):
        _not_ported("the bottom-to-top adapter path (CUSTOM.PARALLEL_B2T)",
                    "M10")
    if custom.get("PARALLEL_T2B_WINDOWATTN", False):
        _not_ported("windowed t2b fusion (CUSTOM.PARALLEL_T2B_WINDOWATTN)",
                    "M10")
    for key in ("PRALLEL_T2B_ADD_BN_RELU", "PRALLEL_T2B_ADD_BN_LN_RELU",
                "PRALLEL_T2B_NOLN_ADD"):
        if custom.get(key, False):
            _not_ported(f"the lateral-adapter variant CUSTOM.{key}", "M10")
    if any(custom.get("PARALLEL_T2B_POOL_SIZE", None) or []):
        _not_ported("t2b pooling (CUSTOM.PARALLEL_T2B_POOL_SIZE)", "M10")
    if config.MODEL.SPEC.get("POOL_TYPE", "default") == "linear":
        _not_ported("the conv1d pooling head (POOL_TYPE 'linear')", "M10")
    if config.TPU.get("USE_FUSED_BLOCK", False) and \
            config.TPU.get("INT8_EVAL", False):
        raise ValueError(
            "TPU.INT8_EVAL and TPU.USE_FUSED_BLOCK are mutually exclusive "
            "(the bf16 half-block megakernel reads full-precision "
            "weights; msclip_tpu/models/quantize.py:71-75)")
    if int(config.TPU.get("MESH_MODEL", 1)) > 1:
        for key, why in (
                ("INT8_EVAL", "the int8 eval path quantizes each whole GEMM "
                 "weight a row on one process"),
                ("USE_FUSED_BLOCK", "the fused half-block kernels (K5, K6) "
                 "take a whole E=768 block, every head and both "
                 "projections, in one launch")):
            if config.TPU.get(key, False):
                raise ValueError(f"TPU.{key} cannot run with tensor "
                                 f"parallelism (TPU.MESH_MODEL > 1): {why}")


def spec_from_config(config) -> MSClipSpec:
    """An MSClipSpec from a merged config tree, reading the keys of the
    reference factory (``get_clip_model`` ``:3182-3227``). Features outside
    this port raise; CUSTOM keys the spec never reads are warned about."""
    custom = _KeyRecorder(config.CUSTOM)
    _reject_unported(config, custom)
    spec_cfg = config.MODEL.SPEC
    vision, text = spec_cfg.VISION, spec_cfg.TEXT
    width = vision.get("WIDTH", 768)
    n_parallel = custom.get("PARALLEL_N_LAYERS", 5)
    dtype = config.TPU.COMPUTE_DTYPE
    if dtype not in _DTYPES:
        raise ValueError(f"TPU.COMPUTE_DTYPE={dtype!r} not in {list(_DTYPES)}")
    spec = MSClipSpec(
        embed_dim=spec_cfg.get("EMBED_DIM", 512),
        image_resolution=config.TRAIN.IMAGE_SIZE[0],  # as the reference
        vision_width=width,
        vision_layers=vision.get("LAYERS", 12),
        vision_heads=width // 64,
        context_length=text.get("CONTEXT_LENGTH", 77),
        vocab_size=text.get("VOCAB_SIZE", 49408),
        text_width=text.get("WIDTH", 512),
        text_heads=text.get("HEADS", 8),
        text_layers=text.get("LAYERS", 12),
        pool_type=spec_cfg.get("POOL_TYPE", "default"),
        skip_cls=spec_cfg.get("SKIP_CLS", False),
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
        share_modules=tuple(custom.get("SHARE_MODULES", []) or []),
        share_n_layers=custom.get("N_LAYERS", -1),
        share_bottom_layer=custom.get("SHARE_BOTTOM_LAYER", False),
        compute_dtype=dtype,
        vision_drop_path=vision.get("DROP_PATH", 0.0),
        use_fused_block=bool(config.TPU.get("USE_FUSED_BLOCK", False)),
        remat=bool(config.TPU.get("REMAT", False)),
    )
    unread = (set(config.CUSTOM.keys()) - custom.seen
              - _CUSTOM_KEYS_CONSUMED_ELSEWHERE - _EXT_KNOBS)
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
    embeddings, N(0, 1) token embedding, ``logit_scale = 1``."""
    g = generator
    W, E, TW = spec.vision_width, spec.embed_dim, spec.text_width
    vis_scale = W ** -0.5
    p = {
        "visual.class_embedding": L.normal((W,), g, vis_scale),
        "visual.positional_embedding":
            L.normal((spec.vision_seq_len, W), g, vis_scale),
        "visual.proj": L.normal((W, E), g, vis_scale),
        "logit_scale": torch.ones(()),
    }
    p.update(L.init_layer_norm("visual.ln_pre", W))
    p.update(L.init_layer_norm("visual.ln_post", W))
    p.update(S.init_earlyconv_res(spec.stem_prefix, W, g,
                                  spec.early_conv_first_k,
                                  len(spec.early_conv_strides)))
    for i in range(spec.first_block, spec.effective_vision_layers):
        p.update(L.init_block(f"visual.transformer.resblocks.{i}", W, g))
    if spec.parallel:
        p.update(S.init_parallel_branch(
            "visual.transformer.parallel_branch_v", W, spec.parallel_n_layers,
            spec.parallel_resnet_layers, spec.parallel_kernels, g))
        out_dims = [W // 16, W // 8, W // 4, W // 2, W]
        for i in range(len(spec.lateral_layers)):
            p.update(S.init_lateral_adapter(
                f"visual.transformer.parallel_lateral_adapter.{i}",
                out_dims[i], W, spec.t2b_kernels[i], g))

    shared = set(spec.shared_block_keys())
    for i in range(spec.text_layers):
        blk = L.init_block(f"transformer.resblocks.{i}", TW, g)
        if spec.text_layer_is_shared(i):
            blk = {k: v for k, v in blk.items()
                   if k.split(".", 3)[3] not in shared}
        p.update(blk)
    p["token_embedding.weight"] = L.normal((spec.vocab_size, TW), g)
    p["positional_embedding"] = L.trunc_normal((spec.context_length, TW), g)
    p["text_projection"] = L.trunc_normal((TW, E), g)
    p.update(L.init_layer_norm("ln_final", TW))
    return {k: v.to(device) for k, v in p.items()}


def resolve_text_block(params, spec: MSClipSpec, i: int):
    """Local-name params of text block ``i``: its own tensors, with the
    shared attn/mlp taken from the visual trunk. Text block ``i`` shares
    visual resblock ``i - minus1``, which (resblock 0 being the stem) is
    visual transformer block ``i - 1`` (``msclip.py:670-694``)."""
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
        return lambda p, x, n_head, mask, **kw: fused_block(
            x, p, n_head, mask, spec.ln_eps)

    def block(p, x, n_head, mask, **kw):
        return L.transformer_block(p, x, n_head, mask, spec.ln_eps, **kw)

    if not spec.remat:
        return block

    def remat_block(p, x, n_head, mask, **kw):
        return torch.utils.checkpoint.checkpoint(
            block, p, x, n_head, mask, use_reentrant=False,
            preserve_rng_state=False, **kw)

    return remat_block


def encode_image(params, spec: MSClipSpec, images, *, normalize=True,
                 bn: S.BNState | None = None, generator=None, rows=None,
                 tp=None):
    """``[B, H, W, 3]`` preprocessed images -> ``[B, embed_dim]``: stem ->
    tokens -> +CLS/+pos/ln_pre -> trunk blocks with the parallel branch
    fused in at the lateral layers -> CLS pool -> ln_post -> proj.

    ``bn``: the BatchNorm context (eval when None). ``generator``: a
    ``torch.Generator`` on the images' device that drives DropPath
    (``spec.vision_drop_path``) in the trunk blocks; None turns it off.
    ``rows=(first, total)``: the images are rows ``first ..`` of a global
    batch of ``total``, whose DropPath masks are drawn whole
    (``layers.drop_path_keep``). ``tp``: the model group of tensor
    parallelism, whose process holds its part of each trunk block
    (``parallel/mesh.split_for_model``)."""
    bn = bn or S.BNState()
    # NCHW, contiguous: the CPU build's oneDNN conv backward corrupts the
    # heap when the stem's input keeps the permuted (channels-last) strides
    x = images.to(spec.dtype).permute(0, 3, 1, 2).contiguous()
    B, W, g = x.shape[0], spec.vision_width, spec.grid
    fmap = S.apply_earlyconv_res(params, spec.stem_prefix, x,
                                 spec.early_conv_strides,
                                 spec.early_conv_first_k, bn)
    tokens = fmap.flatten(2).transpose(1, 2)  # [B, g*g, W]
    cls_tok = params["visual.class_embedding"].to(spec.dtype).expand(B, 1, W)
    tokens = torch.cat([cls_tok, tokens], dim=1)
    tokens = tokens + params["visual.positional_embedding"].to(spec.dtype)
    tokens = L.layer_norm(tokens, params["visual.ln_pre.weight"],
                          params["visual.ln_pre.bias"], spec.ln_eps)

    dropping = spec.vision_drop_path > 0.0 and generator is not None
    block = _block_fn(spec, dropping)
    parallel_x = None
    for idx in range(spec.first_block, spec.effective_vision_layers):
        if spec.parallel and idx in spec.lateral_layers:
            li = spec.lateral_layers.index(idx)
            parallel_x = S.apply_parallel_stage(
                params, f"visual.transformer.parallel_branch_v.{li}",
                x if li == 0 else parallel_x,
                spec.parallel_strides[li], spec.parallel_paddings[li],
                spec.parallel_resnet_layers[li], bn)
            parallel_x, tokens = S.apply_lateral_adapter(
                params, f"visual.transformer.parallel_lateral_adapter.{li}",
                parallel_x, tokens, (g, g),
                spec.t2b_strides[li], spec.t2b_paddings[li],
                use_cls=spec.t2b_use_cls, eps=spec.ln_eps, bn=bn)
        keep = None
        if dropping:  # drawn here, in block order, for both branches
            keep = tuple(L.drop_path_keep(tokens, spec.vision_drop_path,
                                          generator, rows)
                         for _ in range(2))
        tokens = block(
            L.block_params(params, f"visual.transformer.resblocks.{idx}"),
            tokens, spec.vision_heads, None,
            drop_path_rate=spec.vision_drop_path, keep=keep, tp=tp)

    pooled = _pool(tokens, spec)
    pooled = L.layer_norm(pooled, params["visual.ln_post.weight"],
                          params["visual.ln_post.bias"], spec.ln_eps)
    feats = pooled @ params["visual.proj"].to(spec.dtype)
    return L.l2_normalize(feats) if normalize else feats


def encode_text(params, spec: MSClipSpec, tokens, *, normalize=True,
                tp=None):
    """``[B, 77]`` token ids -> ``[B, embed_dim]``: embedding + positional,
    causal blocks (shared ones read the visual trunk), EOT pooling,
    ln_final, text projection. ``tp`` as :func:`encode_image`'s."""
    x = params["token_embedding.weight"][tokens.long()].to(spec.dtype)
    x = x + params["positional_embedding"].to(spec.dtype)
    mask = L.build_causal_mask(spec.context_length, device=x.device)
    block = _block_fn(spec)
    for i in range(spec.text_layers):
        x = block(resolve_text_block(params, spec, i), x, spec.text_heads,
                  mask, tp=tp)
    if spec.pool_type != "default":
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
            bn: S.BNState | None = None, generator=None):
    """Training logits ``exp(logit_scale) * img @ txt.T`` ``[B, B]`` over
    the one-card batch (``msclip_tpu/models/msclip.py:949-966`` without
    the cross-device gather)."""
    feats_i = encode_image(params, spec, images, bn=bn, generator=generator)
    feats_t = encode_text(params, spec, tokens)
    T = torch.exp(params["logit_scale"]).to(feats_i.dtype)
    return T * feats_i @ feats_t.t()


def _pool(tokens, spec: MSClipSpec):
    if spec.pool_type == "average":
        if spec.skip_cls:
            tokens = tokens[:, 1:, :]
        return tokens.mean(dim=1)
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

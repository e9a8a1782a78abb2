"""The plain reference of MS-CLIP-S: both towers, the zero-shot logits and
the contrastive train step, in plain PyTorch.

It follows the released model (``clip_openai_pe_res_v1.py`` of the MS-CLIP
release, configs ``experiments/model/b{32,16}-yfcc-msclips.yaml``): the
EarlyconvRes stem as visual resblock 0, the parallel conv branch with its
lateral top-to-bottom adapters, the trunk of pre-LN blocks whose attention
and MLP the text tower shares from block 1 on, CLS and EOT pooling,
symmetric InfoNCE, and AdamW with the release's groups and warm-up. Its
shapes (:class:`Arch`) come from the configuration file through the
layout module ``benchmark/layouts/clip_openai_pe_res_v1.py``; it takes its
weights and inputs from the caller, and imports nothing but torch. Other
layouts' references (``benchmark/layouts/``) reuse its blocks, draws and
arithmetic.

Everything runs in float32 with TF32 off (``set_full_precision``), and
BatchNorm runs unfolded: in eval on the running statistics, in training
on the batch's. ``Precision`` rounds the operands of every matrix product
and convolution (``Precision.fp8``: float8 e4m3 with a scale a tensor), so
that the same code gives the lower-precision control.

Under a process group the train step spans the group's processes, each
with its rows of the global batch, as data parallelism does: BatchNorm
takes the global batch's statistics, the loss is that of the gathered
features, and the gradients are averaged (``world`` above 1 only; the
collectives are plain ``torch.distributed``).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

LN_EPS = 1e-12
BN_EPS = 1e-5
CONV_RES_BN_EPS = 1e-6
BN_MOMENTUM = 0.1
MAX_LOGIT_SCALE = 4.6052
IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)
FP8_MAX = 448.0
LN_OUTLIERS = 2
LN_OUTLIER_GAIN = 30.0


def set_full_precision():
    """float32 products and convolutions on the card, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class Arch:
    """The shapes of one released MS-CLIP-S configuration."""

    embed: int
    width: int
    layers: int
    heads: int
    resolution: int
    context: int
    vocab: int
    text_width: int
    text_heads: int
    text_layers: int
    first_k: int
    stem_strides: tuple
    lateral_layers: tuple
    par_kernels: tuple
    par_paddings: tuple
    par_strides: tuple
    t2b_kernels: tuple
    t2b_paddings: tuple
    t2b_strides: tuple
    share_from: int  # text block j takes visual block j's attn and MLP from here

    @property
    def grid(self):
        return self.resolution // (2 * math.prod(self.stem_strides))

    @property
    def seq(self):
        return self.grid ** 2 + 1

    def shared(self, j):
        return 1 <= j < self.layers and j >= self.share_from


# ---------------------------------------------------------------------------
# the parameters: names, shapes and how each is drawn
# ---------------------------------------------------------------------------

def _bn(p, prefix, c):
    for s in ("weight", "bias", "running_mean", "running_var"):
        p[f"{prefix}.{s}"] = ((c,), "bn_" + s)


def _ln(p, prefix, c):
    p[f"{prefix}.weight"] = ((c,), "ones")
    p[f"{prefix}.bias"] = ((c,), "zeros")


def _conv(p, key, c_out, c_in, k):
    """He's normal draw, so that activations keep their scale through the
    convolutions and the running statistics fit them."""
    p[key] = ((c_out, c_in, k, k), (2.0 / (c_in * k * k)) ** 0.5)


def _block(p, prefix, w, attn_mlp=True):
    for ln in ("ln_1", "ln_2"):
        p[f"{prefix}.{ln}.weight"] = ((w,), "ln_gain")
        p[f"{prefix}.{ln}.bias"] = ((w,), "zeros")
    if not attn_mlp:
        return
    p[f"{prefix}.attn.in_proj_weight"] = ((3 * w, w), (2.0 / (4 * w)) ** 0.5)
    p[f"{prefix}.attn.in_proj_bias"] = ((3 * w,), "zeros")
    p[f"{prefix}.attn.out_proj.weight"] = ((w, w), 0.02)
    p[f"{prefix}.attn.out_proj.bias"] = ((w,), "zeros")
    p[f"{prefix}.mlp.c_fc.weight"] = ((4 * w, w), 0.02)
    p[f"{prefix}.mlp.c_fc.bias"] = ((4 * w,), "zeros")
    p[f"{prefix}.mlp.c_proj.weight"] = ((w, 4 * w), 0.02)
    p[f"{prefix}.mlp.c_proj.bias"] = ((w,), "zeros")


def param_layout(a: Arch):
    """``{name: (shape, init)}`` in the release's ``state_dict`` names,
    each tensor once (a shared text block has no attn or MLP of its own).
    ``init`` is a standard deviation of a normal draw or one of ``ones``,
    ``zeros``, ``logit_scale``, ``ln_gain`` (a block's LayerNorm gains,
    with the outlier channels of trained transformers) and ``bn_*``
    (BatchNorm tensors, drawn near their identity so that folding them
    changes the numbers); :func:`draw_params` draws them."""
    W, E = a.width, a.embed
    p = {"logit_scale": ((), "logit_scale"),
         "visual.class_embedding": ((W,), W ** -0.5),
         "visual.positional_embedding": ((a.seq, W), W ** -0.5),
         "visual.proj": ((W, E), W ** -0.5)}
    _ln(p, "visual.ln_pre", W)
    _ln(p, "visual.ln_post", W)
    stem = "visual.transformer.resblocks.0"
    n = len(a.stem_strides)
    _conv(p, f"{stem}.conv1.weight", W >> n, 3, a.first_k)
    _bn(p, f"{stem}.bn1", W >> n)
    for i in range(n):
        c = W >> (n - i)
        sp = f"{stem}.resnet_stage.conv_{i}"
        _conv(p, f"{sp}.conv1.weight", 2 * c, c, 3)
        _bn(p, f"{sp}.bn1", 2 * c)
        _conv(p, f"{sp}.downsample.0.weight", 2 * c, c, 1)
        _bn(p, f"{sp}.downsample.1", 2 * c)
    _conv(p, f"{stem}.last_conv.weight", W, W, 1)
    for i in range(1, a.layers):
        _block(p, f"visual.transformer.resblocks.{i}", W)
    ins = [3, W // 16, W // 8, W // 4, W // 2]
    outs = [W // 16, W // 8, W // 4, W // 2, W]
    for i in range(5):
        bt = f"visual.transformer.parallel_branch_v.{i}"
        if i == 0:
            _conv(p, f"{bt}.conv.weight", outs[0], 3, a.par_kernels[0])
            _bn(p, f"{bt}.bn", outs[0])
            continue
        ct = f"{bt}.resnet_stage.conv_0"
        mid = outs[i] // 2
        for name, (ci, co, k) in (("1", (ins[i], mid, 1)),
                                  ("2", (mid, mid, a.par_kernels[i])),
                                  ("3", (mid, outs[i], 1))):
            _conv(p, f"{ct}.conv{name}.weight", co, ci, k)
            _bn(p, f"{ct}.bn{name}", co)
        _conv(p, f"{ct}.residual_conv.weight", outs[i], ins[i], 1)
        _bn(p, f"{ct}.residual_bn", outs[i])
    for i in range(len(a.lateral_layers)):
        at = f"visual.transformer.parallel_lateral_adapter.{i}"
        _conv(p, f"{at}.top2bottom_dw_conv.conv.weight", outs[i], 1,
              a.t2b_kernels[i])
        _bn(p, f"{at}.top2bottom_dw_conv.bn", outs[i])
        _conv(p, f"{at}.top2bottom_pw_conv.conv.weight", W, outs[i], 1)
        _conv(p, f"{at}.bottom_dw_conv.conv.weight", W, 1, 3)
        _bn(p, f"{at}.bottom_dw_conv.bn", W)
        _ln(p, f"{at}.ln_adapt", W)
    TW = a.text_width
    for j in range(a.text_layers):
        _block(p, f"transformer.resblocks.{j}", TW, not a.shared(j))
    p["token_embedding.weight"] = ((a.vocab, TW), 1.0)
    p["positional_embedding"] = ((a.context, TW), 0.01)
    p["text_projection"] = ((TW, E), TW ** -0.5)
    _ln(p, "ln_final", TW)
    return p


def draw_params(layout, seed, device):
    """float32 tensors of ``layout`` from ``seed``: one normal draw on
    ``device`` by a generator there, cut into the tensors and scaled.
    BatchNorm weights ``1 + 0.1 z``, biases and running means ``0.1 z``,
    running variances ``exp(0.2 z)``; ``logit_scale`` ``ln(1 / 0.07)``.
    A block's LayerNorm gains are ``1 + 0.1 z`` but at the two channels of
    largest ``z``, which get ``LN_OUTLIER_GAIN``: trained vision and text
    transformers carry a few such channels (Bondarenko et al. 2021,
    Dettmers et al. 2022), and they are what makes a coarser number format
    lose accuracy, which the correctness check has to see."""
    drawn = [(k, shape) for k, (shape, init) in layout.items()
             if init not in ("ones", "zeros", "logit_scale")]
    total = sum(math.prod(shape) for _, shape in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k, (shape, init) in layout.items():
        if init == "ones":
            out[k] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[k] = torch.zeros(shape, device=device)
        elif init == "logit_scale":
            out[k] = torch.full(shape, math.log(1 / 0.07), device=device)
        else:
            n = math.prod(shape)
            z = flat[at:at + n].view(shape)
            at += n
            if init == "ln_gain":
                gain = 1.0 + 0.1 * z
                gain[z.topk(LN_OUTLIERS).indices] = LN_OUTLIER_GAIN
                out[k] = gain
                continue
            out[k] = (1.0 + 0.1 * z if init == "bn_weight"
                      else 0.1 * z if init in ("bn_bias", "bn_running_mean")
                      else torch.exp(0.2 * z) if init == "bn_running_var"
                      else z * init)
    return out


def shared_keys(a: Arch):
    """The visual trunk's tensors that text blocks read too (the release's
    ``SHARE_MODULES``), the group of ``LR_SHARE`` and ``WD_SHARE``."""
    local = ("attn.in_proj_weight", "attn.in_proj_bias",
             "attn.out_proj.weight", "attn.out_proj.bias", "mlp.c_fc.weight",
             "mlp.c_fc.bias", "mlp.c_proj.weight", "mlp.c_proj.bias")
    return {f"visual.transformer.resblocks.{j}.{k}"
            for j in range(a.text_layers) if a.shared(j) for k in local}


def _block_of(p, a: Arch, j):
    """Text block ``j``'s tensors under local names."""
    own = f"transformer.resblocks.{j}"
    src = f"visual.transformer.resblocks.{j}" if a.shared(j) else own
    out = {k: p[f"{own}.{k}"] for k in ("ln_1.weight", "ln_1.bias",
                                        "ln_2.weight", "ln_2.bias")}
    for k in ("attn.in_proj_weight", "attn.in_proj_bias",
              "attn.out_proj.weight", "attn.out_proj.bias", "mlp.c_fc.weight",
              "mlp.c_fc.bias", "mlp.c_proj.weight", "mlp.c_proj.bias"):
        out[k] = p[f"{src}.{k}"]
    return out


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------

class Precision:
    """Where the operands of products and convolutions are rounded:
    ``None`` keeps float32, ``torch.bfloat16`` or ``"fp8"`` (float8 e4m3,
    each tensor scaled so that its largest magnitude is 448) round them."""

    def __init__(self, kind=None):
        self.kind = kind

    def __call__(self, t):
        if self.kind is None:
            return t
        if self.kind == "fp8":
            amax = t.detach().abs().amax().clamp(min=1e-30)
            scale = FP8_MAX / amax
            q = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
            return t + (q - t).detach()  # rounded forward, straight gradient
        return t + (t.detach().to(self.kind).float() - t.detach())


FP32 = Precision()


def matmul(a, b, prec=FP32):
    return prec(a) @ prec(b)


def linear(x, w, b, prec=FP32):
    return matmul(x, w.t(), prec) + b


def conv(x, w, stride=1, padding=0, groups=1, prec=FP32):
    return F.conv2d(prec(x), prec(w), stride=stride, padding=padding,
                    groups=groups)


def layer_norm(x, w, b):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return w * (x - mean) * torch.rsqrt(var + LN_EPS) + b


def world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


class _SumOver(torch.autograd.Function):
    """The sum over the processes; its gradient is summed too."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


class _GatherRows(torch.autograd.Function):
    """Every process's rows, in rank order; the gradient of this
    process's rows is the sum of every process's gradient of them."""

    @staticmethod
    def forward(ctx, x):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        ctx.rows = slice(dist.get_rank() * x.shape[0],
                         (dist.get_rank() + 1) * x.shape[0])
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g[ctx.rows]


def sum_over(x, world):
    return x if world == 1 else _SumOver.apply(x)


def gather_rows(x, world):
    return x if world == 1 else _GatherRows.apply(x)


class BatchNorm:
    """Eval (running statistics) or training (batch statistics, biased in
    the normalisation, unbiased in the running variance, momentum 0.1).
    In training the new running statistics are kept in ``updates``; the
    batch is that of ``world`` processes, each with its rows."""

    def __init__(self, training=False, world=1):
        self.training = training
        self.world = world
        self.updates = {}

    def __call__(self, x, p, prefix, eps=BN_EPS):
        w, b = p[f"{prefix}.weight"], p[f"{prefix}.bias"]
        if self.training:
            n = self.world * (x.numel() // x.shape[1])
            mean = sum_over(x.sum(dim=(0, 2, 3)), self.world) / n
            var = sum_over((x - mean[None, :, None, None]).square()
                           .sum(dim=(0, 2, 3)), self.world) / n
            self.updates[prefix] = (
                (1 - BN_MOMENTUM) * p[f"{prefix}.running_mean"]
                + BN_MOMENTUM * mean.detach(),
                (1 - BN_MOMENTUM) * p[f"{prefix}.running_var"]
                + BN_MOMENTUM * var.detach() * n / (n - 1))
        else:
            mean, var = p[f"{prefix}.running_mean"], p[f"{prefix}.running_var"]
        scale = w * torch.rsqrt(var + eps)
        return x * scale[None, :, None, None] \
            + (b - mean * scale)[None, :, None, None]


def attention(x, p, heads, mask, prec):
    B, L, E = x.shape
    qkv = linear(x, p["attn.in_proj_weight"], p["attn.in_proj_bias"], prec)
    q, k, v = qkv.view(B, L, 3, heads, E // heads).permute(2, 0, 3, 1, 4)
    scores = matmul(q, k.transpose(-1, -2), prec) * (E // heads) ** -0.5
    if mask is not None:
        scores = scores + mask
    out = matmul(scores.softmax(-1), v, prec)
    out = out.transpose(1, 2).reshape(B, L, E)
    return linear(out, p["attn.out_proj.weight"], p["attn.out_proj.bias"],
                  prec)


def block(x, p, heads, mask, prec):
    x = x + attention(layer_norm(x, p["ln_1.weight"], p["ln_1.bias"]), p,
                      heads, mask, prec)
    h = linear(layer_norm(x, p["ln_2.weight"], p["ln_2.bias"]),
               p["mlp.c_fc.weight"], p["mlp.c_fc.bias"], prec)
    h = h * torch.sigmoid(1.702 * h)
    return x + linear(h, p["mlp.c_proj.weight"], p["mlp.c_proj.bias"], prec)


def _local(p, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix + ".")}


def normalize_images(images_u8):
    """uint8 ``[B, H, W, 3]`` -> float32 NCHW, /255 then ImageNet
    mean and standard deviation."""
    x = images_u8.float() / 255.0
    mean = torch.tensor(IMAGE_MEAN, device=x.device)
    std = torch.tensor(IMAGE_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def stem(p, a: Arch, x, bn, prec):
    s = "visual.transformer.resblocks.0"
    x = conv(x, p[f"{s}.conv1.weight"], 2, (a.first_k - 1) // 2, prec=prec)
    x = F.relu(bn(x, p, f"{s}.bn1"))
    for i, st in enumerate(a.stem_strides):
        sp = f"{s}.resnet_stage.conv_{i}"
        out = bn(conv(x, p[f"{sp}.conv1.weight"], st, 1, prec=prec), p,
                 f"{sp}.bn1")
        ident = bn(conv(x, p[f"{sp}.downsample.0.weight"], st, prec=prec), p,
                   f"{sp}.downsample.1")
        x = F.relu(out + ident)
    return conv(x, p[f"{s}.last_conv.weight"], prec=prec)


def branch_stage(p, a: Arch, i, x, bn, prec):
    bt = f"visual.transformer.parallel_branch_v.{i}"
    s, pad = a.par_strides[i], a.par_paddings[i]
    if i == 0:
        x = conv(x, p[f"{bt}.conv.weight"], s, pad, prec=prec)
        return F.relu(bn(x, p, f"{bt}.bn"))
    ct = f"{bt}.resnet_stage.conv_0"
    out = x
    for name, (st, pd) in (("1", (1, 0)), ("2", (s, pad)), ("3", (1, 0))):
        out = bn(conv(out, p[f"{ct}.conv{name}.weight"], st, pd, prec=prec),
                 p, f"{ct}.bn{name}", CONV_RES_BN_EPS)
        if name != "3":
            out = F.relu(out)
    res = bn(conv(x, p[f"{ct}.residual_conv.weight"], s, prec=prec), p,
             f"{ct}.residual_bn", CONV_RES_BN_EPS)
    return F.relu(out + res)


def lateral(p, a: Arch, i, top, tokens, bn, prec):
    at = f"visual.transformer.parallel_lateral_adapter.{i}"
    B, _, C = tokens.shape
    g = a.grid
    t2b = conv(top, p[f"{at}.top2bottom_dw_conv.conv.weight"],
               a.t2b_strides[i], a.t2b_paddings[i], groups=top.shape[1],
               prec=prec)
    t2b = bn(t2b, p, f"{at}.top2bottom_dw_conv.bn")
    t2b = conv(t2b, p[f"{at}.top2bottom_pw_conv.conv.weight"], prec=prec)
    t2b = t2b.flatten(2).transpose(1, 2)
    cls = tokens[:, :1]
    grid = tokens[:, 1:].transpose(1, 2).reshape(B, C, g, g)
    grid = bn(conv(grid, p[f"{at}.bottom_dw_conv.conv.weight"], 1, 1,
                   groups=C, prec=prec), p, f"{at}.bottom_dw_conv.bn")
    fused = torch.cat([cls, grid.flatten(2).transpose(1, 2)], 1) \
        + torch.cat([cls, t2b], 1)
    return layer_norm(fused, p[f"{at}.ln_adapt.weight"],
                      p[f"{at}.ln_adapt.bias"])


def encode_image(p, a: Arch, images_u8, bn=None, prec=FP32):
    """uint8 ``[B, H, W, 3]`` -> unit-norm ``[B, embed]``."""
    bn = bn or BatchNorm()
    x = normalize_images(images_u8)
    fmap = stem(p, a, x, bn, prec)
    B = x.shape[0]
    tokens = torch.cat([p["visual.class_embedding"].expand(B, 1, -1),
                        fmap.flatten(2).transpose(1, 2)], 1)
    tokens = layer_norm(tokens + p["visual.positional_embedding"],
                        p["visual.ln_pre.weight"], p["visual.ln_pre.bias"])
    top = x
    for idx in range(1, a.layers):
        if idx in a.lateral_layers:
            li = a.lateral_layers.index(idx)
            top = branch_stage(p, a, li, top, bn, prec)
            tokens = lateral(p, a, li, top, tokens, bn, prec)
        tokens = block(tokens, _local(p, f"visual.transformer.resblocks.{idx}"),
                       a.heads, None, prec)
    pooled = layer_norm(tokens[:, 0], p["visual.ln_post.weight"],
                        p["visual.ln_post.bias"])
    feats = matmul(pooled, p["visual.proj"], prec)
    return feats / feats.norm(dim=-1, keepdim=True)


def encode_text(p, a: Arch, tokens, prec=FP32):
    """int ``[B, context]`` token ids -> unit-norm ``[B, embed]``."""
    x = p["token_embedding.weight"][tokens.long()] + p["positional_embedding"]
    mask = torch.full((a.context, a.context), float("-inf"),
                      device=x.device).triu(1)
    for j in range(a.text_layers):
        x = block(x, _block_of(p, a, j), a.text_heads, mask, prec)
    pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(-1)]
    pooled = layer_norm(pooled, p["ln_final.weight"], p["ln_final.bias"])
    feats = matmul(pooled, p["text_projection"], prec)
    return feats / feats.norm(dim=-1, keepdim=True)


def zero_shot_logits(p, a: Arch, images_u8, classifier, prec=FP32):
    """``100 * image features @ classifier.T``: ``[B, classes]``."""
    return 100.0 * matmul(encode_image(p, a, images_u8, prec=prec),
                          classifier.float().t(), prec)


def infonce(fi, ft, logit_scale, prec=FP32):
    logits = logit_scale.exp() * matmul(fi, ft.t(), prec)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels)
                  + F.cross_entropy(logits.t(), labels))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Optim:
    """AdamW as the release configures it: ``lr`` and ``wd`` of the
    regular tensors, ``lr_share`` and ``wd_share`` of the shared trunk,
    no decay on BatchNorm and biases, LayerNorms and the embeddings, the
    timm warm-up from ``warmup_lr`` over ``warmup_epochs`` epochs of
    ``steps_per_epoch`` steps."""

    lr: float
    wd: float
    lr_share: float
    wd_share: float
    warmup_lr: float
    warmup_steps: int
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8

    def lr_at(self, step, shared):
        base = self.lr_share if shared else self.lr
        warm = self.warmup_lr * (self.lr_share / self.lr if shared else 1.0)
        if step >= self.warmup_steps:
            raise ValueError("the reference follows the warm-up only")
        return warm + (base - warm) * step / self.warmup_steps


def optim_from_file(path, steps_per_epoch):
    with open(path) as f:
        cfg = json.load(f)
    train, custom = cfg["TRAIN"], cfg["CUSTOM"]
    args = train["LR_SCHEDULER"]["ARGS"]
    assert train["OPTIMIZER"] == "adamW" and \
        train["LR_SCHEDULER"]["METHOD"] == "timm"
    return Optim(lr=train["LR"], wd=train["WD"],
                 lr_share=custom.get("LR_SHARE") or train["LR"],
                 wd_share=custom.get("WD_SHARE") or train["WD"],
                 warmup_lr=args["warmup_lr"],
                 warmup_steps=args["warmup_epochs"] * steps_per_epoch)


def decays(name, params):
    """The release's weight-decay rule: none on biases, BatchNorms,
    LayerNorms (names with ``ln``) and the embeddings and scale."""
    parts = name.split(".")
    if parts[-1].endswith("bias") or any("ln" in q for q in parts):
        return False
    if name.rsplit(".", 1)[0] + ".running_mean" in params:
        return False
    return not any(q in ("positional_embedding", "class_embedding",
                         "token_embedding", "logit_scale") for q in parts)


def is_bn_stat(name):
    return name.endswith((".running_mean", ".running_var"))


FAULTS = ("half_batch", "no_exchange")


class TrainReference:
    """The step in float32 (or rounded by ``prec``): forward with batch
    statistics, InfoNCE over the batch, backward, AdamW, the running
    statistics written back, ``logit_scale`` clamped. ``params`` is
    changed in place. Under a process group each process holds its rows
    of the global batch (see the module's note). ``fault`` plants one:
    ``half_batch``, the loss over the first half of the global batch;
    ``no_exchange``, each process alone, with nothing exchanged between
    the processes."""

    def __init__(self, params, a: Arch, opt: Optim, prec=FP32, fault=None):
        assert fault in (None,) + FAULTS
        self.p, self.a, self.opt, self.prec = params, a, opt, prec
        self.fault = fault
        self.world = 1 if fault == "no_exchange" else world_size()
        self.trained = [k for k in params if not is_bn_stat(k)]
        self.shared = shared_keys(a)
        self.m = {k: torch.zeros_like(params[k]) for k in self.trained}
        self.v = {k: torch.zeros_like(params[k]) for k in self.trained}
        self.t = 0

    def loss(self, images_u8, tokens):
        bn = BatchNorm(training=True, world=self.world)
        fi = gather_rows(encode_image(self.p, self.a, images_u8, bn,
                                      self.prec), self.world)
        ft = gather_rows(encode_text(self.p, self.a, tokens, self.prec),
                         self.world)
        if self.fault == "half_batch":
            h = fi.shape[0] // 2
            fi, ft = fi[:h], ft[:h]
        return infonce(fi, ft, self.p["logit_scale"], self.prec), bn.updates

    def step(self, images_u8, tokens):
        """One step; returns ``(loss, {name: gradient})``."""
        leaves = [self.p[k].requires_grad_() for k in self.trained]
        loss, updates = self.loss(images_u8, tokens)
        grads = dict(zip(self.trained, torch.autograd.grad(loss, leaves)))
        if self.world > 1:  # each process's share: their mean is the step's
            for g in grads.values():
                dist.all_reduce(g)
                g /= self.world
        b1, b2 = self.opt.betas
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        with torch.no_grad():
            for k in self.trained:
                w = self.p[k].detach_()
                shared = k in self.shared
                lr = self.opt.lr_at(self.t - 1, shared)
                if decays(k, self.p):
                    w.mul_(1 - lr * (self.opt.wd_share if shared
                                     else self.opt.wd))
                self.m[k].lerp_(grads[k], 1 - b1)
                self.v[k].mul_(b2).addcmul_(grads[k], grads[k], value=1 - b2)
                denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(self.opt.eps)
                w.addcdiv_(self.m[k], denom, value=-lr / c1)
            for prefix, (mean, var) in updates.items():
                self.p[f"{prefix}.running_mean"].copy_(mean)
                self.p[f"{prefix}.running_var"].copy_(var)
            self.p["logit_scale"].clamp_(max=MAX_LOGIT_SCALE)
        return loss.detach(), grads

"""Image preprocessing, the port of ``msclip_tpu/data/transforms.py``.

Eval: ``pil_eval_transform`` is the reference eval transform
(``tools/zero_shot.py:202-207``): PIL bicubic resize of the short side,
center crop, /255, ImageNet-stats normalize. ``normalize_uint8`` runs the
same fp32 ops in the same order on a uint8 batch in torch, on the batch's
device, so a uint8 boundary plus this function equals host-side fp32
normalisation.

Train: ``pil_train_transform`` (host, numpy draws: the JAX package's array
for the same ``numpy.random.Generator``), and the tensor functions
``random_resized_crop_params``, ``bilinear_crop_resize``, ``train_augment``,
``device_preprocess`` and ``mixup_cutmix``, which run on the batch's device
and draw from an explicit ``torch.Generator`` (the JAX functions draw with
``jax.random``, so the draws agree in distribution, not bit for bit).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def pil_eval_uint8(image, size: int = 224) -> np.ndarray:
    """PIL image -> uint8 ``[size, size, 3]`` center crop."""
    from PIL import Image

    if image.mode != "RGB":
        image = image.convert("RGB")
    w, h = image.size
    # torchvision Resize(size): the short side goes to `size`, the long
    # side TRUNCATES (int(size * long / short)); parity-critical.
    if w <= h:
        new_w, new_h = size, int(size * h / w)
    else:
        new_w, new_h = int(size * w / h), size
    image = image.resize((new_w, new_h), Image.BICUBIC)
    left = int(round((new_w - size) / 2.0))
    top = int(round((new_h - size) / 2.0))
    image = image.crop((left, top, left + size, top + size))
    return np.asarray(image, dtype=np.uint8)


def pil_eval_transform(image, size: int = 224,
                       mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    """PIL image -> float32 HWC array, reference-eval-compatible."""
    arr = pil_eval_uint8(image, size).astype(np.float32) / 255.0
    arr = (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return arr


def normalize_uint8(images_u8: torch.Tensor, mean=IMAGENET_MEAN,
                    std=IMAGENET_STD) -> torch.Tensor:
    """/255 + mean/std normalize of a uint8 ``[..., 3]`` tensor in fp32,
    in :func:`pil_eval_transform`'s op order."""
    dev = images_u8.device
    x = images_u8.to(torch.float32) / 255.0
    return (x - torch.tensor(mean, dtype=torch.float32, device=dev)) \
        / torch.tensor(std, dtype=torch.float32, device=dev)


def dataset_normalizer(dataset):
    """Input stage matching what ``dataset`` emits: uint8-boundary
    datasets (``emits_uint8``) are normalized with the stats they were
    built with; fp32 datasets, already normalized on the host, pass
    through."""
    if getattr(dataset, "emits_uint8", False):
        mean = tuple(getattr(dataset, "mean", IMAGENET_MEAN))
        std = tuple(getattr(dataset, "std", IMAGENET_STD))
        return functools.partial(normalize_uint8, mean=mean, std=std)
    return lambda x: x


def pil_train_transform(image, size: int = 224,
                        mean=IMAGENET_MEAN, std=IMAGENET_STD,
                        scale=(0.08, 1.0),
                        ratio=(3.0 / 4.0, 4.0 / 3.0),
                        hflip_p: float = 0.5, rng=None) -> np.ndarray:
    """Training transform: torchvision ``RandomResizedCrop(size, scale,
    ratio)`` (10 box attempts, then the clamped-ratio center-crop
    fallback; BILINEAR over the box) + horizontal flip + normalize.
    ``rng``: a ``numpy.random.Generator`` (OS entropy when omitted)."""
    from PIL import Image

    rng = rng if rng is not None else np.random.default_rng()
    if image.mode != "RGB":
        image = image.convert("RGB")
    w, h = image.size
    area = float(w * h)
    for _ in range(10):
        target = area * rng.uniform(scale[0], scale[1])
        ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            break
    else:  # torchvision fallback: center crop at the clamped ratio
        in_ratio = w / h
        if in_ratio < ratio[0]:
            cw, ch = w, int(round(w / ratio[0]))
        elif in_ratio > ratio[1]:
            ch, cw = h, int(round(h * ratio[1]))
        else:
            cw, ch = w, h
        x0, y0 = (w - cw) // 2, (h - ch) // 2
    image = image.resize((size, size), Image.BILINEAR,
                         box=(x0, y0, x0 + cw, y0 + ch))
    if rng.random() < hflip_p:
        image = image.transpose(Image.FLIP_LEFT_RIGHT)
    arr = np.asarray(image, dtype=np.float32) / 255.0
    arr = (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return arr


def _normalize(x, mean, std):
    dev = x.device
    return (x - torch.tensor(mean, dtype=torch.float32, device=dev)) \
        / torch.tensor(std, dtype=torch.float32, device=dev)


def _keys_cubic(x):
    """The Keys cubic kernel (a = -0.5) of ``jax.image.resize``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in: int, n_out: int, antialias: bool, device):
    """``[n_in, n_out]`` fp32 bicubic weights, ``jax.image``'s
    ``compute_weight_mat`` with scale ``n_out / n_in`` and no
    translation: the kernel widened when downsampling with
    ``antialias``, each column normalized, columns outside the input
    zeroed."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample_f = ((torch.arange(n_out, dtype=torch.float32, device=device)
                 + 0.5) * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]).abs() \
        / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def device_preprocess(images_u8: torch.Tensor, size: int = 224,
                      mean=IMAGENET_MEAN, std=IMAGENET_STD,
                      antialias: bool = True) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` -> normalized fp32 ``[B, size, size, 3]`` on
    the batch's device: ``jax.image.resize``'s bicubic resize of the short
    side to ``size`` (the long side truncated as torchvision does), center
    crop (Python's half-to-even ``round``), normalize. Close to, not bit
    equal with, PIL."""
    x = images_u8.to(torch.float32) / 255.0
    B, H, W, C = x.shape
    new_h = size if H <= W else int(size * H / W)
    new_w = size if W <= H else int(size * W / H)
    if new_h != H:
        x = torch.einsum("bhwc,hn->bnwc", x,
                         _resize_weights(H, new_h, antialias, x.device))
    if new_w != W:
        x = torch.einsum("bhwc,wn->bhnc", x,
                         _resize_weights(W, new_w, antialias, x.device))
    top = int(round((new_h - size) / 2.0))
    left = int(round((new_w - size) / 2.0))
    x = x[:, top:top + size, left:left + size, :]
    return _normalize(x, mean, std)


def mixup_cutmix_params(generator: torch.Generator, shape, mixup_alpha=0.0,
                        cutmix_alpha=0.0, switch_prob=0.5):
    """One batch's draws for :func:`mixup_cutmix`: ``{"cut": bool, "lam":
    float, "box": (y0, y1, x0, x1) or None}``, or None when neither mode is
    configured. With both modes, cutmix fires with ``switch_prob``; the
    mixup weight is ``Beta(mixup_alpha, mixup_alpha)``; the cutmix box has
    sides ``int(H sqrt(1 - lam))`` and ``int(W sqrt(1 - lam))`` for ``lam ~
    Beta(cutmix_alpha, cutmix_alpha)``, centred on a uniform pixel and
    clipped to the image (``msclip_tpu/data/transforms.py:174``). The Beta
    draws come from a numpy stream seeded from ``generator``."""
    do_mixup, do_cutmix = mixup_alpha > 0.0, cutmix_alpha > 0.0
    if not do_mixup and not do_cutmix:
        return None
    dev = generator.device

    def uniform():
        return torch.rand((), generator=generator, device=dev).item()

    cut = do_cutmix and (not do_mixup or uniform() < switch_prob)
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=dev).item())
    beta_rng = np.random.default_rng(seed)
    if not cut:
        return {"cut": False,
                "lam": float(beta_rng.beta(mixup_alpha, mixup_alpha)),
                "box": None}
    lam = float(beta_rng.beta(cutmix_alpha, cutmix_alpha))
    H, W = shape[1], shape[2]
    ratio = np.sqrt(1.0 - lam)
    cut_h, cut_w = int(H * ratio), int(W * ratio)
    cy = int(torch.randint(0, H, (), generator=generator, device=dev).item())
    cx = int(torch.randint(0, W, (), generator=generator, device=dev).item())
    box = (min(max(cy - cut_h // 2, 0), H), min(max(cy + cut_h // 2, 0), H),
           min(max(cx - cut_w // 2, 0), W), min(max(cx + cut_w // 2, 0), W))
    return {"cut": True, "lam": lam, "box": box}


def mixup_cutmix_apply(images, labels, n_classes, params,
                       label_smoothing=0.0):
    """The blend of :func:`mixup_cutmix` for given draws ``params`` (see
    :func:`mixup_cutmix_params`): each sample mixed with the one before it
    (``roll`` by 1), soft labels ``lam y + (1 - lam) y[perm]`` from
    label-smoothed one-hots, where a cutmix ``lam`` is the share of pixels
    outside the box."""
    B = images.shape[0]
    perm = torch.roll(torch.arange(B, device=images.device), 1)
    off = label_smoothing / n_classes
    on = 1.0 - label_smoothing + off
    y1 = torch.nn.functional.one_hot(labels.long(), n_classes).to(
        torch.float32) * (on - off) + off
    if params is None:
        return images, y1
    y2 = y1[perm]
    if params["cut"]:
        H, W = images.shape[1:3]
        y0, y1_, x0, x1_ = params["box"]
        mixed = images.clone()
        mixed[:, y0:y1_, x0:x1_] = images[perm][:, y0:y1_, x0:x1_]
        lam = 1.0 - ((y1_ - y0) * (x1_ - x0)) / (H * W)
    else:
        lam = params["lam"]
        mixed = lam * images + (1.0 - lam) * images[perm]
    return mixed, lam * y1 + (1.0 - lam) * y2


def mixup_cutmix(generator, images, labels, n_classes, mixup_alpha=0.0,
                 cutmix_alpha=0.0, switch_prob=0.5, label_smoothing=0.0):
    """Batch-mode mixup / cutmix with soft labels (``AUG.MIXUP``,
    ``AUG.MIXCUT``, ``AUG.MIXUP_SWITCH_PROB``; the finetune path) on NHWC
    ``images``. Returns (mixed images, soft labels ``[B, n_classes]``)."""
    params = mixup_cutmix_params(generator, images.shape, mixup_alpha,
                                 cutmix_alpha, switch_prob)
    return mixup_cutmix_apply(images, labels, n_classes, params,
                              label_smoothing)


def random_resized_crop_params(generator: torch.Generator, B: int, H: int,
                               W: int, scale=(0.08, 1.0),
                               ratio=(3 / 4, 4 / 3)):
    """torchvision ``RandomResizedCrop.get_params`` for a batch: 10 attempts
    a sample, the first whose integer box fits, else the ratio-clamped
    center crop. Returns int32 tensors ``(y0, x0, ch, cw)`` of shape
    ``[B]`` on the generator's device."""
    dev = generator.device
    ta = H * W * (scale[0] + (scale[1] - scale[0]) * torch.rand(
        (B, 10), generator=generator, device=dev))
    lo, hi = float(np.log(ratio[0])), float(np.log(ratio[1]))
    aspect = torch.exp(lo + (hi - lo) * torch.rand(
        (B, 10), generator=generator, device=dev))
    cw = torch.round(torch.sqrt(ta * aspect)).to(torch.int32)
    ch = torch.round(torch.sqrt(ta / aspect)).to(torch.int32)
    valid = (cw > 0) & (cw <= W) & (ch > 0) & (ch <= H)
    first = valid.to(torch.uint8).argmax(dim=1)  # first True, or 0
    any_valid = valid.any(dim=1)
    rows = torch.arange(B, device=dev)
    cw, ch = cw[rows, first], ch[rows, first]
    in_ratio = W / H
    if in_ratio < ratio[0]:
        fw, fh = W, int(round(W / ratio[0]))
    elif in_ratio > ratio[1]:
        fh, fw = H, int(round(H * ratio[1]))
    else:
        fw, fh = W, H
    cw = torch.where(any_valid, cw, torch.full_like(cw, fw))
    ch = torch.where(any_valid, ch, torch.full_like(ch, fh))
    u = torch.rand((2, B), generator=generator, device=dev)
    y0 = torch.floor(u[0] * (H - ch + 1)).to(torch.int32)
    x0 = torch.floor(u[1] * (W - cw + 1)).to(torch.int32)
    y0 = torch.where(any_valid, y0, torch.full_like(y0, (H - fh) // 2))
    x0 = torch.where(any_valid, x0, torch.full_like(x0, (W - fw) // 2))
    return y0, x0, ch, cw


def _crop_resize(x, y0, x0, ch, cw, size: int):
    """:func:`bilinear_crop_resize` of every image of ``x [B, H, W, C]``
    over its own box (``y0, x0, ch, cw``: int tensors ``[B]``)."""
    B, H, W, _ = x.shape
    grid = torch.arange(size, device=x.device, dtype=torch.float32) + 0.5
    y0f, x0f = y0.to(torch.float32)[:, None], x0.to(torch.float32)[:, None]
    chf, cwf = ch.to(torch.float32)[:, None], cw.to(torch.float32)[:, None]
    ys = y0f + grid * (chf / size) - 0.5
    xs = x0f + grid * (cwf / size) - 0.5
    ys = torch.minimum(torch.maximum(ys, y0f), y0f + chf - 1)
    xs = torch.minimum(torch.maximum(xs, x0f), x0f + cwf - 1)
    yf, xf = torch.floor(ys), torch.floor(xs)
    wy = (ys - yf)[:, :, None, None]
    wx = (xs - xf)[:, None, :, None]
    yi0 = yf.to(torch.int64).clamp(0, H - 1)
    xi0 = xf.to(torch.int64).clamp(0, W - 1)
    yi1 = torch.minimum(
        yi0 + 1, (y0 + ch - 1).to(torch.int64).clamp(max=H - 1)[:, None])
    xi1 = torch.minimum(
        xi0 + 1, (x0 + cw - 1).to(torch.int64).clamp(max=W - 1)[:, None])
    b = torch.arange(B, device=x.device)[:, None, None]

    def at(yi, xi):
        return x[b, yi[:, :, None], xi[:, None, :]]

    top = at(yi0, xi0) * (1 - wx) + at(yi0, xi1) * wx
    bot = at(yi1, xi0) * (1 - wx) + at(yi1, xi1) * wx
    return top * (1 - wy) + bot * wy


def bilinear_crop_resize(img, y0, x0, ch, cw, size: int):
    """``img [H, W, C]`` cropped to the box ``(y0, x0, ch, cw)`` and
    resampled to ``[size, size, C]`` bilinearly: ``src = (dst + 0.5)
    crop / size - 0.5``, clamped to the box (torchvision's tensor resize
    without antialias), as ``msclip_tpu/data/transforms.py:286``."""
    box = [torch.as_tensor(v, device=img.device).reshape(1)
           for v in (y0, x0, ch, cw)]
    return _crop_resize(img[None], *box, size)[0]


def train_augment(generator: torch.Generator, images_u8: torch.Tensor,
                  size: int = 224, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                  scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)) -> torch.Tensor:
    """RandomResizedCrop (bilinear) + horizontal flip + normalize of a
    uint8 ``[B, H, W, 3]`` batch on its device, drawing from
    ``generator`` (on the same device)."""
    B, H, W, _ = images_u8.shape
    x = images_u8.to(torch.float32) / 255.0
    y0, x0, ch, cw = random_resized_crop_params(generator, B, H, W,
                                                scale=scale, ratio=ratio)
    x = _crop_resize(x, y0, x0, ch, cw, size)
    flip = torch.rand(B, generator=generator,
                      device=generator.device) < 0.5
    x = torch.where(flip[:, None, None, None], x.flip(2), x)
    return _normalize(x, mean, std)

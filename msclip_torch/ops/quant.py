"""Fused per-token int8 quantizers of the W8A8 eval mode (``TPU.INT8_EVAL``).

Port of ``msclip_tpu/ops/quant.py``. Two functions, each a hand-written
Hopper kernel in ``csrc/quant.cu`` on a CUDA tensor and a plain torch
version on a CPU tensor; there is no other path and no fallback:

* :func:`ln_quant` (K3): the fp32-island LayerNorm of
  :func:`msclip_torch.models.layers.layer_norm`, then symmetric per-token
  int8 quantization;
* :func:`gelu_quant` (K4): QuickGELU in fp32, then the same quantization.

Both take ``x [B, L, E]`` and return ``(q int8 [B, L, E], s fp32 [B, L])``
with ``h ~= q * s[..., None]``, where ``s = max(max|h| / 127, 1e-8)`` and
``q = clamp(round(h / s), -127, 127)``, rounding half to even. The plain
versions follow ``_ln_quant_kernel`` and ``_gelu_quant_kernel`` step by
step, and so do the kernels; the two differ only in the order of the
LayerNorm's sums (and, on the card, not at all for K4).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

SOURCE = "quant.cu"
MAX_WIDTH = 4096
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def div127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as an IEEE division on every device: torch divides a
    CUDA tensor by a Python scalar as a multiply by its reciprocal, which
    can land one ulp away."""
    return t / torch.full_like(t, 127.0)


def quantize_rows_plain(h: torch.Tensor):
    """fp32 ``[..., E]`` -> ``(int8 [..., E], fp32 [...])``, symmetric per
    row (``_quantize_rows``)."""
    s = torch.clamp_min(div127(h.abs().amax(dim=-1, keepdim=True)), 1e-8)
    q = torch.clamp(torch.round(h / s), -127, 127)
    return q.to(torch.int8), s[..., 0]


def ln_quant_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-12):
    """Plain-torch K3: LayerNorm in fp32, the normalized value cast to
    ``x.dtype`` before the affine in ``x.dtype``, then the quantization."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    h = weight.to(x.dtype) * normed + bias.to(x.dtype)
    return quantize_rows_plain(h.float())


def gelu_quant_plain(x: torch.Tensor):
    """Plain-torch K4: ``x / (1 + exp(-1.702 x))`` in fp32 (the TPU
    kernel's formula, not ``sigmoid``), then the quantization."""
    xf = x.float()
    return quantize_rows_plain(xf / (1.0 + torch.exp(-1.702 * xf)))


def _lib():
    lib = cuda_build.load(SOURCE)
    lib.msclip_ln_quant.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p]
    lib.msclip_ln_quant.restype = ctypes.c_int
    lib.msclip_gelu_quant.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.msclip_gelu_quant.restype = ctypes.c_int
    return lib


def _device_type(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no quantization kernel for device {x.device}")
    return x.device.type


def _check_cuda_input(x, *vectors):
    """Raise for what the kernels do not take: they read rows of 8-element
    chunks with 16-byte loads."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"quantization kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"quantization kernel takes a non-empty [..., E] "
                         f"tensor, got {tuple(x.shape)}")
    E = x.shape[-1]
    if E % 8 or E > MAX_WIDTH:
        raise ValueError(f"quantization kernel takes E % 8 == 0 and "
                         f"E <= {MAX_WIDTH}, got E={E}")
    for t in (x, *vectors):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("quantization kernel needs contiguous, 16-byte "
                             "aligned tensors")
    for v in vectors:
        if v.device != x.device or tuple(v.shape) != (E,):
            raise ValueError(f"LayerNorm weight and bias must be [{E}] on "
                             f"{x.device}, got {tuple(v.shape)} on {v.device}")


def _outputs(x):
    return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
            torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device))


def ln_quant(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float = 1e-12):
    """LayerNorm + per-token int8 quantization, fused: ``x [..., E]`` ->
    ``(q int8 [..., E], s fp32 [...])``. CPU tensors take
    :func:`ln_quant_plain`; CUDA tensors launch K3, counted in
    ``ln_quant.launches``."""
    if _device_type(x) == "cpu":
        return ln_quant_plain(x, weight, bias, eps)
    weight = weight.to(x.dtype).contiguous()
    bias = bias.to(x.dtype).contiguous()
    _check_cuda_input(x, weight, bias)
    q, s = _outputs(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.msclip_ln_quant(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), q.data_ptr(),
            s.data_ptr(), x.numel() // x.shape[-1], x.shape[-1], eps,
            _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "msclip_ln_quant")
    ln_quant.launches += 1
    return q, s


ln_quant.launches = 0


def gelu_quant(x: torch.Tensor):
    """QuickGELU + per-token int8 quantization, fused: ``x [..., F]`` ->
    ``(q int8 [..., F], s fp32 [...])``. CPU tensors take
    :func:`gelu_quant_plain`; CUDA tensors launch K4, counted in
    ``gelu_quant.launches``."""
    if _device_type(x) == "cpu":
        return gelu_quant_plain(x)
    _check_cuda_input(x)
    q, s = _outputs(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.msclip_gelu_quant(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), x.numel() // x.shape[-1],
            x.shape[-1], _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "msclip_gelu_quant")
    gelu_quant.launches += 1
    return q, s


gelu_quant.launches = 0

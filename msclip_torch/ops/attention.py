"""Fused multi-head attention core: ``[B, L, 3E]`` -> ``[B, L, E]``.

Port of ``msclip_tpu/ops/attention.py``. On a CUDA tensor
:func:`fused_attention_qkv` launches the hand-written Hopper kernel in
``csrc/attention_fwd.cu``; on a CPU tensor it takes
:func:`attention_qkv_plain`, which does the kernel's arithmetic in plain
torch. There is no other path and no fallback: a CUDA tensor the kernel
does not take raises.

The arithmetic is the TPU kernel's (``_attn_kernel``): scores are the fp32
sum of input-dtype products, scaled by ``D**-0.5`` after the product, plus
an optional fp32 additive ``[L, L]`` mask; softmax in fp32; the weights are
rounded to the input dtype before the PV product, which sums in fp32. The
XLA path of ``msclip_tpu/models/layers.py`` pre-scales q in the compute
dtype instead, so the two agree exactly in fp32 and differ slightly in bf16.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

SOURCE = "attention_fwd.cu"
MAX_SEQ = 256
HEAD_DIM = 64  # the one head width of every MS-CLIP tower
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def attention_qkv_plain(qkv: torch.Tensor, n_head: int,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain-torch version of the kernel, same arithmetic, any device."""
    B, L, three_e = qkv.shape
    E = three_e // 3
    D = E // n_head
    q, k, v = qkv.float().view(B, L, 3, n_head, D).unbind(2)
    scores = torch.einsum("blhd,bmhd->bhlm", q, k) * D ** -0.5
    if mask is not None:
        scores = scores + mask.float()
    weights = torch.softmax(scores, dim=-1).to(qkv.dtype).float()
    out = torch.einsum("bhlm,bmhd->blhd", weights, v)
    return out.reshape(B, L, E).to(qkv.dtype)


def _lib():
    lib = cuda_build.load(SOURCE)
    fn = lib.msclip_attention_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check_cuda_inputs(qkv, n_head, mask):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, L, 3E], got {tuple(qkv.shape)}")
    B, L, three_e = qkv.shape
    E = three_e // 3
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"attention kernel takes float32 or bfloat16, "
                        f"got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("attention kernel needs a contiguous, 16-byte "
                         "aligned qkv")
    if E != n_head * HEAD_DIM:
        raise ValueError(f"attention kernel takes heads of width {HEAD_DIM}, "
                         f"got {E}/{n_head}")
    if not 0 < L <= MAX_SEQ or B == 0:
        raise ValueError(f"attention kernel takes 0 < L <= {MAX_SEQ} and "
                         f"B > 0, got B={B}, L={L}")
    if qkv.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("the attention kernel is forward-only (its "
                           "backward is not ported yet); run under no_grad")
    if mask is not None:
        if (mask.device != qkv.device or mask.dtype != torch.float32
                or tuple(mask.shape) != (L, L) or not mask.is_contiguous()):
            raise ValueError(
                f"mask must be a contiguous float32 [{L}, {L}] tensor on "
                f"{qkv.device}, got {mask.dtype} {tuple(mask.shape)} on "
                f"{mask.device}")


def fused_attention_qkv(qkv: torch.Tensor, n_head: int,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """qkv ``[B, L, 3E]`` (after the in-projection) -> context ``[B, L, E]``.

    ``mask``: additive float32 ``[L, L]`` (e.g. causal) or None. CPU
    tensors take the plain version; CUDA tensors launch the kernel and
    count the launch in ``fused_attention_qkv.launches``."""
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, n_head, mask)
    if qkv.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {qkv.device}")
    _check_cuda_inputs(qkv, n_head, mask)
    B, L, three_e = qkv.shape
    lib = _lib()
    out = torch.empty(B, L, three_e // 3, dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = lib.msclip_attention_fwd(
        qkv.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), B, L, three_e // 3, n_head, _DTYPE_CODE[qkv.dtype],
        stream)
    cuda_build.check(lib, err, "msclip_attention_fwd")
    fused_attention_qkv.launches += 1
    return out


fused_attention_qkv.launches = 0

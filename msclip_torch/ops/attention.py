"""Fused multi-head attention core: ``[B, L, 3E]`` -> ``[B, L, E]``.

Port of ``msclip_tpu/ops/attention.py``. :func:`fused_attention_qkv` runs
through :class:`FusedAttentionQKV`, which pairs two hand-written Hopper
kernels on a CUDA tensor: the forward in ``csrc/attention_fwd.cu`` and the
backward in ``csrc/attention_bwd.cu``. On a CPU tensor the pair is
:func:`attention_qkv_plain` and :func:`attention_qkv_bwd_plain`, which do
the kernels' arithmetic in plain torch. There is no other path and no
fallback: a CUDA tensor the kernels do not take raises.

The arithmetic is the TPU kernels' (``_attn_kernel``, ``_attn_bwd_kernel``):
scores are the fp32 sum of input-dtype products, scaled by ``D**-0.5`` after
the product, plus an optional fp32 additive ``[L, L]`` mask; softmax in
fp32; the weights are rounded to the input dtype before the PV product (and
before dV in the backward), which sums in fp32; the backward's dS is rounded
to the input dtype before dQ and dK. The XLA path of
``msclip_tpu/models/layers.py`` pre-scales q in the compute dtype instead,
so the two agree exactly in fp32 and differ slightly in bf16.

Two wrapper features of the JAX function come with it: lane packing
(``lane_pack``: maskless rows short enough are packed ``pack`` to a row of
``pack * L <= 128`` under a block-diagonal mask, the default from the
tuning table, ``ops/tuning.py``), and :func:`fused_attention`, the same
core over head-split ``[B, H, L, D]`` inputs.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from . import cuda_build
from .tuning import get_tuning

SOURCE = "attention_fwd.cu"
BWD_SOURCE = "attention_bwd.cu"
MAX_SEQ = 256
HEAD_DIM = 64  # the one head width of every MS-CLIP tower
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _acc_dtype(dtype):
    """The dtype the plain versions sum in: fp32, or fp64 for fp64 inputs
    (``gradcheck``)."""
    return torch.promote_types(dtype, torch.float32)


def _split_heads(qkv, n_head):
    B, L, three_e = qkv.shape
    E = three_e // 3
    q, k, v = qkv.to(_acc_dtype(qkv.dtype)).view(
        B, L, 3, n_head, E // n_head).unbind(2)
    return q, k, v


def _weights(q, k, mask):
    """fp32 softmax of the scaled, masked scores ``[B, H, L, L]``."""
    scores = torch.einsum("blhd,bmhd->bhlm", q, k) * q.shape[-1] ** -0.5
    if mask is not None:
        scores = scores + mask.to(scores.dtype)
    return torch.softmax(scores, dim=-1)


def attention_qkv_plain(qkv: torch.Tensor, n_head: int,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain-torch version of the forward kernel, same arithmetic."""
    B, L, three_e = qkv.shape
    q, k, v = _split_heads(qkv, n_head)
    weights = _weights(q, k, mask).to(qkv.dtype).to(q.dtype)
    out = torch.einsum("bhlm,bmhd->blhd", weights, v)
    return out.reshape(B, L, three_e // 3).to(qkv.dtype)


def attention_qkv_bwd_plain(qkv: torch.Tensor, g: torch.Tensor, n_head: int,
                            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain-torch version of the backward kernel: ``dqkv [B, L, 3E]`` for
    the output gradient ``g [B, L, E]``, step by step as
    ``_attn_bwd_kernel``."""
    B, L, three_e = qkv.shape
    E = three_e // 3
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, n_head)
    gh = g.to(q.dtype).view(B, L, n_head, E // n_head)
    scale = q.shape[-1] ** -0.5
    w = _weights(q, k, mask)
    wc = w.to(dt).to(q.dtype)
    dv = torch.einsum("bhlm,blhd->bmhd", wc, gh)
    dw = torch.einsum("blhd,bmhd->bhlm", gh, v)
    ds = ((dw - (dw * w).sum(-1, keepdim=True)) * w).to(dt).to(q.dtype)
    dq = torch.einsum("bhlm,bmhd->blhd", ds, k) * scale
    dk = torch.einsum("bhlm,blhd->bmhd", ds, q) * scale
    return torch.cat([t.reshape(B, L, E) for t in (dq, dk, dv)],
                     dim=-1).to(dt)


def _fwd_lib():
    lib = cuda_build.load(SOURCE)
    fn = lib.msclip_attention_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = cuda_build.load(BWD_SOURCE)
    fn = lib.msclip_attention_bwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check_cuda_inputs(qkv, n_head, mask, g=None):
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
    if g is not None and (
            g.dtype != qkv.dtype or tuple(g.shape) != (B, L, E)
            or g.device != qkv.device or not g.is_contiguous()
            or g.data_ptr() % 16):
        raise ValueError(
            f"attention backward needs a contiguous, 16-byte aligned output "
            f"gradient {qkv.dtype} [{B}, {L}, {E}] on {qkv.device}, got "
            f"{g.dtype} {tuple(g.shape)} on {g.device}")
    if mask is not None:
        if (mask.device != qkv.device or mask.dtype != torch.float32
                or tuple(mask.shape) != (L, L) or not mask.is_contiguous()):
            raise ValueError(
                f"mask must be a contiguous float32 [{L}, {L}] tensor on "
                f"{qkv.device}, got {mask.dtype} {tuple(mask.shape)} on "
                f"{mask.device}")


def _device_type(qkv):
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {qkv.device}")
    return qkv.device.type


def _forward(qkv, n_head, mask):
    """The forward wrapper: plain version on the CPU, kernel K1 on CUDA
    (counted in ``fused_attention_qkv.launches``)."""
    if _device_type(qkv) == "cpu":
        return attention_qkv_plain(qkv, n_head, mask)
    _check_cuda_inputs(qkv, n_head, mask)
    B, L, three_e = qkv.shape
    lib = _fwd_lib()
    out = torch.empty(B, L, three_e // 3, dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.msclip_attention_fwd(
            qkv.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), B, L, three_e // 3, n_head, _DTYPE_CODE[qkv.dtype],
            stream)
    cuda_build.check(lib, err, "msclip_attention_fwd")
    fused_attention_qkv.launches += 1
    return out


def fused_attention_qkv_bwd(qkv: torch.Tensor, g: torch.Tensor, n_head: int,
                            mask: torch.Tensor | None = None) -> torch.Tensor:
    """``dqkv [B, L, 3E]`` for the output gradient ``g [B, L, E]``. CPU
    tensors take the plain version; CUDA tensors launch kernel K2 and count
    the launch in ``fused_attention_qkv_bwd.launches``."""
    if _device_type(qkv) == "cpu":
        return attention_qkv_bwd_plain(qkv, g, n_head, mask)
    _check_cuda_inputs(qkv, n_head, mask, g)
    B, L, three_e = qkv.shape
    lib = _bwd_lib()
    dqkv = torch.empty_like(qkv)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.msclip_attention_bwd(
            qkv.data_ptr(), g.data_ptr(),
            None if mask is None else mask.data_ptr(), dqkv.data_ptr(),
            B, L, three_e // 3, n_head, _DTYPE_CODE[qkv.dtype], stream)
    cuda_build.check(lib, err, "msclip_attention_bwd")
    fused_attention_qkv_bwd.launches += 1
    return dqkv


fused_attention_qkv_bwd.launches = 0


class FusedAttentionQKV(torch.autograd.Function):
    """The forward kernel and its backward as one differentiable op. The
    mask gets no gradient (the TPU kernel's zero ``dmask``)."""

    @staticmethod
    def forward(ctx, qkv, n_head, mask):
        ctx.n_head = n_head
        ctx.save_for_backward(qkv, mask)
        return _forward(qkv, n_head, mask)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        qkv, mask = ctx.saved_tensors
        return (fused_attention_qkv_bwd(qkv, g.contiguous(), ctx.n_head, mask),
                None, None)


@functools.lru_cache(maxsize=None)
def pack_mask(seq: int, pack: int, device) -> torch.Tensor:
    """The block-diagonal additive fp32 mask of ``pack`` rows of length
    ``seq`` sharing one attention row (JAX's ``_pack_mask_np``): 0 inside
    each row's own ``[seq, seq]`` block, -1e9 across rows, so that each
    query's softmax covers its own keys only. Cached per device."""
    m = torch.full((pack * seq, pack * seq), -1e9, dtype=torch.float32)
    for i in range(pack):
        m[i * seq:(i + 1) * seq, i * seq:(i + 1) * seq] = 0.0
    return m.to(device)


def lane_pack_for(B: int, L: int, lane_pack: int, masked: bool) -> int:
    """The pack JAX's rule takes (``msclip_tpu/ops/attention.py:231-234``):
    1 with a mask, else ``lane_pack`` shrunk until ``pack * L <= 128`` and
    ``B % pack == 0``."""
    pack = 1 if masked else max(1, int(lane_pack))
    while pack > 1 and (pack * L > 128 or B % pack):
        pack -= 1
    return pack


def fused_attention_qkv(qkv: torch.Tensor, n_head: int,
                        mask: torch.Tensor | None = None, *,
                        lane_pack: int | None = None) -> torch.Tensor:
    """qkv ``[B, L, 3E]`` (after the in-projection) -> context ``[B, L, E]``.

    ``mask``: additive float32 ``[L, L]`` (e.g. causal) or None.
    Differentiable in ``qkv``. CPU tensors take the plain versions; CUDA
    tensors launch the kernels, the forward counted in
    ``fused_attention_qkv.launches`` and the backward in
    ``fused_attention_qkv_bwd.launches``.

    ``lane_pack`` (default: the tuning table's ``attn_lane_pack`` for
    ``qkv``'s device, ``MSCLIP_ATTN_PACK``): without a mask, ``pack``
    rows (:func:`lane_pack_for`) are viewed as one, ``[B / pack, pack L,
    3E]`` (a free reshape of the contiguous batch), and run under the
    block-diagonal :func:`pack_mask`: one launch, as unpacked."""
    B, L, three_e = qkv.shape
    if lane_pack is None:
        lane_pack = get_tuning(qkv.device).attn_lane_pack
    pack = lane_pack_for(B, L, lane_pack, mask is not None)
    if pack > 1:
        out = FusedAttentionQKV.apply(
            qkv.reshape(B // pack, pack * L, three_e), n_head,
            pack_mask(L, pack, qkv.device))
        return out.reshape(B, L, three_e // 3)
    return FusedAttentionQKV.apply(qkv, n_head, mask)


fused_attention_qkv.launches = 0


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Head-split inputs ``[B, H, L, D]`` -> context ``[B, H, L, D]`` (JAX's
    ``fused_attention``): repacks into ``[B, L, 3E]``, runs
    :func:`fused_attention_qkv` and splits the heads again. Prefer
    :func:`fused_attention_qkv` right after the in-projection, which needs
    no repack."""
    B, H, L, D = q.shape

    def flat(t):
        return t.transpose(1, 2).reshape(B, L, H * D)

    qkv = torch.cat([flat(q), flat(k), flat(v)], dim=-1)
    out = fused_attention_qkv(qkv, H, mask)
    return out.reshape(B, L, H, D).transpose(1, 2)

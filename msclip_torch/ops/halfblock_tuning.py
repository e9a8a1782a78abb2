"""The attention half-block's tuning variants (E1) and the hybrid core +
out-projection kernel (E2) of ``experiments/halfblock_tuning.py``.

Port of the JAX package's tool for tuning the fused half-block. Two
functions, each a hand-written Hopper kernel in ``csrc/halfblock_tuning.cu``
on a CUDA tensor and a plain torch version on a CPU tensor; there is no
other path and no fallback:

* :func:`attention_halfblock_variant` (E1, ``make_attn_half``): K5's
  function ``x + out_proj(MHA(LN1(x)))`` without a mask, at the rounding
  points of one of the script's kernel bodies;
* :func:`core_out_halfblock` (E2, ``make_hybrid_b``'s ``core_out_kern``):
  ``x + (ctx(qkv) @ Wo + bo)``, the attention core, the out-projection and
  the residual, from a qkv ``[B, L, 3E]`` computed outside the kernel.

:func:`hybrid_b` is ``make_hybrid_b``'s whole function: LayerNorm, the qkv
GEMM as a library call (the JAX package leaves it to XLA), then E2.

``tb`` is the samples a kernel block takes, the script's batch tile: the
grid is ``B / tb`` blocks, and ``B % tb`` must be 0 (the JAX grid drops a
remainder silently; these functions raise). A block walks its samples in
groups of at most ``tb`` (:func:`tuning_group`, K5's largest group), and
the default ``tb`` is K5's group (``block_fused.group_samples``), or the
largest divisor of ``B`` below it.
The plain versions ignore ``tb``: the result does not depend on it.
Parameters are a block's tensors under the port's local names, linear
weights ``[out, in]``; inference only.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .block_fused import (_DTYPE_CODE, HEAD_DIM, _check_cuda_input,
                          _device_type, _operands, _proj, group_samples,
                          layer_norm, max_group, slot_elems, sm_count)

SOURCE = "halfblock_tuning.cu"
WIDTH = 768  # E1's and E2's one width (kE in halfblock.cuh): the tool's ViT-B
VARIANTS = ("v0", "v1", "v2", "v3", "v2a", "v2c")
# the kernel's numeric variant of each JAX body (``Variant`` in the source)
_VARIANT_CODE = {"v0": 0, "v2": 0, "v3": 0, "v1": 1, "v2c": 2, "v2a": 3}
NO_HEADS_COEF = 1e-4  # v2a's ctx = v + 1e-4 q + 1e-4 k
_SHAPES = {"ln_1.weight": (WIDTH,), "ln_1.bias": (WIDTH,),
           "attn.in_proj_weight": (3 * WIDTH, WIDTH),
           "attn.out_proj.weight": (WIDTH, WIDTH),
           "attn.in_proj_bias": (3 * WIDTH,), "attn.out_proj.bias": (WIDTH,)}


def default_tb(B: int, L: int, dtype: torch.dtype,
               sms: int | None = None) -> int:
    """K5's group at ``dtype`` on a card of ``sms`` SMs
    (``block_fused.group_samples``), or the largest divisor of ``B``
    below it."""
    tb = group_samples(B, L, dtype, sms)
    while B % tb:
        tb -= 1
    return tb


def tuning_group(L: int, tb: int, dtype: torch.dtype) -> int:
    """E1's and E2's samples per group inside a block of ``tb``: K5's
    largest group (``block_fused.max_group``: in bf16 at most 256 rows and
    512 padded attention rows, in fp32 a GEMM pass of 128 rows), at most
    ``tb``."""
    return min(tb, max_group(L, dtype))


def workspace_elems(B: int, L: int, tb: int, dtype: torch.dtype,
                    core_out: bool = False) -> tuple[int, int]:
    """``(G, slot)``: a block's group and the elements of its workspace
    slice, of which there are ``B / tb``: E1's h and ctx ``[G L, E]`` (and
    q/k/v ``[G L, 3 D]`` in fp32), E2's ctx ``[G L, E]``."""
    G = tuning_group(L, tb, dtype)
    return G, G * L * WIDTH if core_out else slot_elems(G, L, dtype, WIDTH)


def _softmax_weights(s, dtype, reciprocal):
    """fp32 softmax of ``s`` rounded to ``dtype``: ``e / Σe``
    (``jax.nn.softmax``), or ``e · (1/Σe)`` (v2c)."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    total = e.sum(dim=-1, keepdim=True)
    w = e * (1.0 / total) if reciprocal else e / total
    return w.to(dtype)


def _core(q, k, v, dtype, reciprocal=False):
    """Per-head attention of ``q, k, v [B, L, H, D]`` (fp32 values of the
    compute dtype): fp32 scores scaled after the product, the weights
    rounded to ``dtype`` before the fp32 PV sum, the context rounded."""
    B, L, H, D = q.shape
    s = torch.einsum("blhd,bmhd->bhlm", q, k) * D ** -0.5
    w = _softmax_weights(s, dtype, reciprocal).float()
    return torch.einsum("bhlm,bmhd->blhd", w, v).reshape(B, L, H * D) \
        .to(dtype)


def _out(x, ctx, p):
    """``x + (ctx @ Wo^T + bo)``: the fp32 sum plus the fp32 bias, rounded,
    then the residual in the compute dtype."""
    return x + _proj(ctx, p["attn.out_proj.weight"], p["attn.out_proj.bias"])


def attention_halfblock_variant_plain(x: torch.Tensor, p, variant: str,
                                      eps: float = 1e-12) -> torch.Tensor:
    """Plain-torch E1, step by step at the rounding points of the JAX body
    ``attn_kern_<variant>``; heads of 64, no mask.

    ======  =========================================================
    body    function
    ======  =========================================================
    v0      K5 without a mask: each projection an fp32 sum plus the
    v2      fp32 bias, rounded once; fp32 scores; softmax divides; the
    v3      weights and the context rounded; the out-projection an fp32
            sum plus the fp32 bias, rounded; the residual in the compute
            dtype
    v1      as v0, but the qkv GEMM is rounded to the compute dtype
            first and its bias added in that dtype
    v2c     as v0, but softmax is ``e · (1/Σe)``
    v2a     as v0, but no attention: ``ctx = v + 1e-4 q + 1e-4 k`` in
            the compute dtype, each operation rounded
    ======  =========================================================

    On the TPU, v0, v2 and v3 differ only in Mosaic layouts (2-D against
    3-D dots, one ``[E, 3E]`` dot against three ``[E, E]`` dots), which have
    no Hopper counterpart; they are one function here and one kernel."""
    if variant not in _VARIANT_CODE:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    B, L, E = x.shape
    dt, H = x.dtype, E // HEAD_DIM
    h = layer_norm(x, p["ln_1.weight"], p["ln_1.bias"], eps)
    w, b = p["attn.in_proj_weight"], p["attn.in_proj_bias"]
    if variant == "v1":
        qkv = (h.float() @ w.to(dt).float().t()).to(dt) + b.to(dt)
        q, k, v = qkv.split(E, dim=-1)
    else:
        q, k, v = (_proj(h, w[i * E:(i + 1) * E], b[i * E:(i + 1) * E])
                   for i in range(3))
    if variant == "v2a":
        # the coefficient in the compute dtype, as JAX's weak-typed scalar;
        # each product and sum is computed in fp32 and rounded to ``dt``
        c = torch.tensor(NO_HEADS_COEF, dtype=dt)
        ctx = v + c * q + c * k
    else:
        q, k, v = (t.float().view(B, L, H, HEAD_DIM) for t in (q, k, v))
        ctx = _core(q, k, v, dt, reciprocal=variant == "v2c")
    return _out(x, ctx, p)


def core_out_plain(x: torch.Tensor, qkv: torch.Tensor, p) -> torch.Tensor:
    """Plain-torch E2 (``core_out_kern``): per head of 64 the attention
    core from ``qkv [B, L, 3E]`` (q, k, v column blocks, as K1 reads it),
    then ``x + (ctx @ Wo^T + bo)`` at K5's rounding points."""
    B, L, E = x.shape
    q, k, v = qkv.float().view(B, L, 3, E // HEAD_DIM, HEAD_DIM).unbind(2)
    return _out(x, _core(q, k, v, x.dtype), p)


def _lib():
    lib = cuda_build.load(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.msclip_attention_halfblock_variant.argtypes = [ptr] * 9 + [
        i64, i32, i32, i32, i32, ctypes.c_float, i32, i32, ptr]
    lib.msclip_attention_halfblock_variant.restype = i32
    lib.msclip_core_out_halfblock.argtypes = [ptr] * 6 + [
        i64, i32, i32, i32, i32, i32, ptr]
    lib.msclip_core_out_halfblock.restype = i32
    return lib


def _check(x, tb, variant=None):
    """The device rule, the variant, ``tb`` and the width: ``(device type,
    tb)``. The kernels take E = 768 (heads of 64; K5 also takes 512) and
    0 < L <= 256; the plain versions any width in heads of 64."""
    device = _device_type(x)
    if variant is not None and variant not in _VARIANT_CODE:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if x.dim() != 3 or x.shape[-1] % HEAD_DIM:
        raise ValueError(f"x must be [B, L, E] with E a multiple of "
                         f"{HEAD_DIM}, got {tuple(x.shape)}")
    B, L, _ = x.shape
    if tb is None:
        tb = default_tb(B, L, x.dtype,
                        sm_count(x.device) if device == "cuda" else None)
    tb = int(tb)
    if tb < 1 or B % tb:
        raise ValueError(f"tb (samples per block) must divide B={B}, got {tb}")
    return device, tb


def _workspace(x, tb, core_out=False):
    """``(G, slot, ws)``: the group, the slice and the workspace of
    ``B / tb`` slices."""
    B, L, _ = x.shape
    G, slot = workspace_elems(B, L, tb, x.dtype, core_out)
    return G, slot, torch.empty(B // tb * slot, dtype=x.dtype,
                                device=x.device)


def attention_halfblock_variant(x: torch.Tensor, p, variant: str,
                                tb: int | None = None,
                                eps: float = 1e-12) -> torch.Tensor:
    """E1: ``x + out_proj(MHA(LN1(x)))`` for ``x [B, L, E]`` at the rounding
    points of ``variant`` (one of :data:`VARIANTS`), ``tb`` samples a block.
    CPU tensors take :func:`attention_halfblock_variant_plain`; CUDA
    tensors launch E1 (E = 768, heads of 64, L <= 256), counted in
    ``attention_halfblock_variant.launches``."""
    device, tb = _check(x, tb, variant)
    if device == "cpu":
        return attention_halfblock_variant_plain(x, p, variant, eps)
    _check_cuda_input(x, widths=(WIDTH,))
    g, beta, w_in, w_out, b_in, b_out = _operands(
        x, p, ["ln_1.weight", "ln_1.bias", "attn.in_proj_weight",
               "attn.out_proj.weight"],
        ["attn.in_proj_bias", "attn.out_proj.bias"], _SHAPES)
    lib = _lib()
    out = torch.empty_like(x)
    B, L, _ = x.shape
    G, slot, ws = _workspace(x, tb)
    with torch.cuda.device(x.device):
        err = lib.msclip_attention_halfblock_variant(
            x.data_ptr(), g.data_ptr(), beta.data_ptr(), w_in.data_ptr(),
            b_in.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
            out.data_ptr(),
            ws.data_ptr(), slot, B, L, tb, G, eps, _VARIANT_CODE[variant],
            _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "msclip_attention_halfblock_variant")
    attention_halfblock_variant.launches += 1
    return out


attention_halfblock_variant.launches = 0


def core_out_halfblock(x: torch.Tensor, qkv: torch.Tensor, p,
                       tb: int | None = None) -> torch.Tensor:
    """E2: ``x + (ctx(qkv) @ Wo^T + bo)`` for ``x [B, L, E]`` and ``qkv
    [B, L, 3E]`` of ``x``'s dtype, ``tb`` samples a block. CPU tensors take
    :func:`core_out_plain`; CUDA tensors launch E2 (E = 768, heads of 64,
    L <= 256), counted in ``core_out_halfblock.launches``."""
    device, tb = _check(x, tb)
    B, L, E = x.shape
    if qkv.device != x.device or qkv.dtype != x.dtype \
            or tuple(qkv.shape) != (B, L, 3 * E):
        raise ValueError(f"qkv must be a {x.dtype} [{B}, {L}, {3 * E}] "
                         f"tensor on {x.device}, got {qkv.dtype} "
                         f"{tuple(qkv.shape)} on {qkv.device}")
    if device == "cpu":
        return core_out_plain(x, qkv, p)
    _check_cuda_input(x, widths=(WIDTH,))
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("core_out kernel needs a contiguous, 16-byte "
                         "aligned qkv")
    w_out, b_out = _operands(x, p, ["attn.out_proj.weight"],
                             ["attn.out_proj.bias"], _SHAPES)
    lib = _lib()
    out = torch.empty_like(x)
    G, slot, ws = _workspace(x, tb, core_out=True)
    with torch.cuda.device(x.device):
        err = lib.msclip_core_out_halfblock(
            x.data_ptr(), qkv.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
            out.data_ptr(), ws.data_ptr(), slot, B, L, tb, G,
            _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "msclip_core_out_halfblock")
    core_out_halfblock.launches += 1
    return out


core_out_halfblock.launches = 0


def hybrid_b(x: torch.Tensor, p, tb: int | None = None,
             eps: float = 1e-12) -> torch.Tensor:
    """``make_hybrid_b``: LayerNorm, the qkv GEMM as a library call in the
    compute dtype with the bias added in that dtype (``torch.matmul``; the
    JAX package computes it outside its kernel, in XLA), then E2."""
    h = layer_norm(x, p["ln_1.weight"], p["ln_1.bias"], eps)
    qkv = torch.matmul(h, p["attn.in_proj_weight"].to(x.dtype).t()) \
        + p["attn.in_proj_bias"].to(x.dtype)
    return core_out_halfblock(x, qkv, p, tb)

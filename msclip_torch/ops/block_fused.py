"""Fused pre-LN half-blocks of the trunk, for eval (``TPU.USE_FUSED_BLOCK``).

Port of ``msclip_tpu/ops/block_fused.py``. Two functions, each a
hand-written Hopper kernel in ``csrc/block_fused.cu`` on a CUDA tensor and a
plain torch version on a CPU tensor; there is no other path and no
fallback:

* :func:`fused_attention_halfblock` (K5): ``x + out_proj(MHA(LN1(x)))``;
* :func:`fused_mlp_halfblock` (K6): ``x + c_proj(QuickGELU(c_fc(LN2(x))))``.

:func:`fused_block` is the JAX package's hybrid block: K5, then the MLP
half unfused (its two GEMMs are plain ``torch.matmul``, as the JAX package
leaves them to XLA). Inference only: nothing here has a backward.

Parameters are a block's tensors under the port's local names
(``layers.block_params``), linear weights ``[out, in]``; K5 reads rows
``[0, E)``, ``[E, 2E)`` and ``[2E, 3E)`` of ``attn.in_proj_weight`` for q, k
and v. The rounding points are the TPU kernels' (``_attn_half_kernel``,
``_mlp_half_kernel``), not the unfused block's: each projection adds its
fp32 bias to the fp32 sum *before* rounding to the compute dtype, where
``layers.linear`` adds the bias after. So in bf16 K5 is held against JAX's
K5, not against ``transformer_block``; in fp32 the two agree.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

SOURCE = "block_fused.cu"
WIDTH = 768      # the kernels' one width: ViT-B's trunk and B/32's text tower
HEAD_DIM = 64
MAX_SEQ = 256
# K5's group limits, as the source has them (kGroupRows, kWgRows and
# kWgTileRows in halfblock.cuh; a test holds these to them): the wrappers
# plan the groups and the workspace, the kernels check the plan
GROUP_ROWS = 128  # fp32 K5's GEMM rows per pass
WGMMA_ROWS = 256  # bf16 K5's GEMM rows per group
TILE_ROWS = 512   # bf16 K5's padded attention rows per group
# K6's, as block_fused.cu has them (kMlpBigRows, kMlpSmallRows, kMlpRows,
# kFChunk; a test holds these to them)
MLP_BIG_ROWS = 256    # bf16 K6's rows of a big group (two m-tiles a warpgroup)
MLP_SMALL_ROWS = 128  # and of a small one (one)
MLP_TILE_ROWS = 32    # fp32 K6's rows a tile
MLP_F_CHUNK = 128     # fp32 K6's hidden columns a chunk
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def padded_len(L: int) -> int:
    """The bf16 attention tile's padded length, K1's: 64, 80, 128, 208 or
    256 (``padded_len`` in attn_core.cuh)."""
    return next(p for p in (64, 80, 128, 208, 256) if L <= p)


def max_group(L: int, dtype: torch.dtype) -> int:
    """The most samples of length ``L`` a group of K5 holds: in bf16 as many
    as fit 256 GEMM rows and 512 padded attention rows (5 at L=50, 3 at
    L=77), in fp32 as many as fill a GEMM pass of 128 rows; at least one."""
    if dtype == torch.bfloat16:
        return max(1, min(WGMMA_ROWS // L, TILE_ROWS // padded_len(L)))
    return max(1, GROUP_ROWS // L)


def group_samples(B: int, L: int, dtype: torch.dtype,
                  sms: int | None = None) -> int:
    """K5's samples per group: :func:`max_group`, and in bf16 no more than
    spread ``B`` samples over ``sms`` blocks (one a streaming
    multiprocessor), so that a small batch still fills the card (2 at
    256 x 50 on 132 SMs, 3 at 1024 x 77). ``sms`` None: the group of a
    batch that fills any card."""
    s = max_group(L, dtype)
    if dtype == torch.bfloat16 and sms:
        s = min(s, max(1, -(-B // sms)))
    return s


def slot_elems(S: int, L: int, dtype: torch.dtype) -> int:
    """Workspace elements of a K5 or E1 block at ``S`` samples a group: h
    and ctx ``[S L, 768]``, and q/k/v ``[S L, 192]`` in fp32 (the least
    the source's ``attn_slot_elems`` accepts)."""
    return S * L * (2 * WIDTH + (0 if dtype == torch.bfloat16 else 3 * HEAD_DIM))


def attn_plan(B: int, L: int, dtype: torch.dtype, sms: int) -> dict:
    """K5's launch plan on a card of ``sms`` SMs: samples per group ``S``,
    ``groups``, workspace ``slots`` (one per block that can be resident,
    at most two an SM and one a group) and ``slot`` elements of each
    (:func:`slot_elems`). Block ``i`` of the grid takes groups ``i,
    i + grid, ...`` and slot ``i``."""
    S = group_samples(B, L, dtype, sms)
    groups = -(-B // S)
    return {"S": S, "groups": groups, "slots": max(1, min(groups, 2 * sms)),
            "slot": slot_elems(S, L, dtype)}


def mlp_plan(rows: int, dtype: torch.dtype, sms: int) -> dict:
    """K6's launch plan over ``rows`` token rows on a card of ``sms`` SMs.

    bf16: ``big`` groups of 256 rows first, as many whole rounds of one a
    block as the rows hold, then groups of 128 (``mlp_group`` in
    block_fused.cu; the last one ragged), on
    ``slots`` blocks, one an SM, block ``i`` taking groups ``i, i + slots,
    ...``: the busiest block takes ``ceil(ceil(rows / 128) / sms)`` units of
    128 rows, as few as any walk of whole m-tile pairs allows, and most
    rows sit in 256-row groups, whose weight tiles serve twice the rows.
    Each slot holds ``slot_rows`` rows of h (768) and of the hidden rows
    (3072): 256 where there are big groups, else 128. fp32: tiles of 32
    rows on at most two blocks an SM, slots of 32 x (768 + 128).
    ``elems``: the workspace's elements of ``dtype``."""
    if dtype == torch.bfloat16:
        big = rows // (MLP_BIG_ROWS * sms) * sms
        groups = big + -(-(rows - big * MLP_BIG_ROWS) // MLP_SMALL_ROWS)
        slots = min(sms, groups)
        slot_rows = MLP_BIG_ROWS if big else MLP_SMALL_ROWS
        return {"big": big, "groups": groups, "slots": slots,
                "slot_rows": slot_rows,
                "elems": slots * slot_rows * 5 * WIDTH}
    groups = -(-rows // MLP_TILE_ROWS)
    slots = max(1, min(groups, 2 * sms))
    return {"big": 0, "groups": groups, "slots": slots,
            "slot_rows": MLP_TILE_ROWS,
            "elems": slots * MLP_TILE_ROWS * (WIDTH + MLP_F_CHUNK)}


def layer_norm(x, weight, bias, eps=1e-12):
    """fp32 statistics, the normalized value rounded to ``x.dtype`` before
    the affine in that dtype (``_ln``; ``layers.layer_norm``, which this
    module cannot import: ``layers`` imports ``ops``)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return weight.to(x.dtype) * normed + bias.to(x.dtype)


def _proj(h, weight, bias):
    """``h @ weight.T`` summed in fp32 with the fp32 bias added, then
    rounded to ``h.dtype``."""
    return (h.float() @ weight.to(h.dtype).float().t()
            + bias.float()).to(h.dtype)


def attention_halfblock_plain(x: torch.Tensor, p, n_head: int,
                              mask: torch.Tensor | None = None,
                              eps: float = 1e-12) -> torch.Tensor:
    """Plain-torch K5, step by step as ``_attn_half_kernel``."""
    B, L, E = x.shape
    D = E // n_head
    h = layer_norm(x, p["ln_1.weight"], p["ln_1.bias"], eps)
    w, b = p["attn.in_proj_weight"], p["attn.in_proj_bias"]
    q, k, v = (_proj(h, w[i * E:(i + 1) * E], b[i * E:(i + 1) * E])
               .float().view(B, L, n_head, D) for i in range(3))
    s = torch.einsum("blhd,bmhd->bhlm", q, k) * D ** -0.5
    if mask is not None:
        s = s + mask.float()
    wts = torch.softmax(s, dim=-1).to(x.dtype).float()
    ctx = torch.einsum("bhlm,bmhd->blhd", wts, v).reshape(B, L, E).to(x.dtype)
    return x + _proj(ctx, p["attn.out_proj.weight"], p["attn.out_proj.bias"])


def mlp_halfblock_plain(x: torch.Tensor, p, eps: float = 1e-12) -> torch.Tensor:
    """Plain-torch K6, step by step as ``_mlp_half_kernel``: QuickGELU
    ``m * sigmoid(1.702 m)`` in fp32 before the rounding."""
    h = layer_norm(x, p["ln_2.weight"], p["ln_2.bias"], eps)
    mid = h.float() @ p["mlp.c_fc.weight"].to(x.dtype).float().t() \
        + p["mlp.c_fc.bias"].float()
    mid = (mid * torch.sigmoid(1.702 * mid)).to(x.dtype)
    return x + _proj(mid, p["mlp.c_proj.weight"], p["mlp.c_proj.bias"])


def _lib():
    lib = cuda_build.load(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.msclip_attention_halfblock.argtypes = [ptr] * 10 + [
        i64, i32, i32, i32, i32, ctypes.c_float, i32, ptr]
    lib.msclip_attention_halfblock.restype = i32
    lib.msclip_mlp_halfblock.argtypes = [ptr] * 9 + [
        i32, i32, i32, i32, ctypes.c_float, i32, ptr]
    lib.msclip_mlp_halfblock.restype = i32
    return lib


def _device_type(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no half-block kernel for device {x.device}")
    return x.device.type


def _check_cuda_input(x, n_head=None, mask=None):
    """Raise for what the kernels do not take."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"half-block kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 3 or x.shape[-1] != WIDTH:
        raise ValueError(f"half-block kernel takes x [B, L, {WIDTH}], got "
                         f"{tuple(x.shape)}")
    B, L, E = x.shape
    if n_head is not None and E != n_head * HEAD_DIM:
        raise ValueError(f"half-block kernel takes heads of width {HEAD_DIM}, "
                         f"got {E}/{n_head}")
    if not 0 < L <= MAX_SEQ or B == 0:
        raise ValueError(f"half-block kernel takes 0 < L <= {MAX_SEQ} and "
                         f"B > 0, got B={B}, L={L}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("half-block kernel needs a contiguous, 16-byte "
                         "aligned x")
    if mask is not None and (
            mask.device != x.device or mask.dtype != torch.float32
            or tuple(mask.shape) != (L, L) or not mask.is_contiguous()):
        raise ValueError(
            f"mask must be a contiguous float32 [{L}, {L}] tensor on "
            f"{x.device}, got {mask.dtype} {tuple(mask.shape)} on "
            f"{mask.device}")


def _operands(x, p, weights, biases, shapes):
    """The kernel's operands: weights (and LayerNorm affine) in ``x.dtype``,
    biases in fp32, each contiguous on ``x.device`` with its shape
    checked."""
    out = []
    for key in weights + biases:
        dtype = torch.float32 if key in biases else x.dtype
        t = p[key].to(device=x.device, dtype=dtype).contiguous()
        if tuple(t.shape) != shapes[key] or t.data_ptr() % 16:
            raise ValueError(f"{key} must be a 16-byte aligned "
                             f"{shapes[key]} tensor, got {tuple(t.shape)}")
        out.append(t)
    return out


def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_attention_halfblock(x: torch.Tensor, p, n_head: int,
                              mask: torch.Tensor | None = None,
                              eps: float = 1e-12) -> torch.Tensor:
    """``x + out_proj(MHA(LN1(x)))`` for ``x [B, L, E]`` and ``mask`` an
    additive fp32 ``[L, L]`` or None. CPU tensors take
    :func:`attention_halfblock_plain`; CUDA tensors launch K5 (E = 768,
    heads of 64, L <= 256), counted in
    ``fused_attention_halfblock.launches``."""
    if _device_type(x) == "cpu":
        return attention_halfblock_plain(x, p, n_head, mask, eps)
    _check_cuda_input(x, n_head, mask)
    E = WIDTH
    ops = _operands(
        x, p, ["ln_1.weight", "ln_1.bias", "attn.in_proj_weight",
               "attn.out_proj.weight"],
        ["attn.in_proj_bias", "attn.out_proj.bias"],
        {"ln_1.weight": (E,), "ln_1.bias": (E,),
         "attn.in_proj_weight": (3 * E, E), "attn.out_proj.weight": (E, E),
         "attn.in_proj_bias": (3 * E,), "attn.out_proj.bias": (E,)})
    g, beta, w_in, w_out, b_in, b_out = ops
    lib = _lib()
    out = torch.empty_like(x)
    B, L, _ = x.shape
    plan = attn_plan(B, L, x.dtype, sm_count(x.device))
    ws = torch.empty(plan["slots"] * plan["slot"], dtype=x.dtype,
                     device=x.device)
    err = lib.msclip_attention_halfblock(
        x.data_ptr(), g.data_ptr(), beta.data_ptr(), w_in.data_ptr(),
        b_in.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        ws.data_ptr(), plan["slot"], plan["slots"], B, L, plan["S"], eps,
        _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "msclip_attention_halfblock")
    fused_attention_halfblock.launches += 1
    return out


fused_attention_halfblock.launches = 0


def fused_mlp_halfblock(x: torch.Tensor, p, eps: float = 1e-12
                        ) -> torch.Tensor:
    """``x + c_proj(QuickGELU(c_fc(LN2(x))))`` for ``x [B, L, E]``. CPU
    tensors take :func:`mlp_halfblock_plain`; CUDA tensors launch K6
    (E = 768) on the plan of :func:`mlp_plan`, counted in
    ``fused_mlp_halfblock.launches``."""
    if _device_type(x) == "cpu":
        return mlp_halfblock_plain(x, p, eps)
    _check_cuda_input(x)
    E, F = WIDTH, 4 * WIDTH
    g, beta, w_fc, w_proj, b_fc, b_proj = _operands(
        x, p, ["ln_2.weight", "ln_2.bias", "mlp.c_fc.weight",
               "mlp.c_proj.weight"], ["mlp.c_fc.bias", "mlp.c_proj.bias"],
        {"ln_2.weight": (E,), "ln_2.bias": (E,),
         "mlp.c_fc.weight": (F, E), "mlp.c_proj.weight": (E, F),
         "mlp.c_fc.bias": (F,), "mlp.c_proj.bias": (E,)})
    lib = _lib()
    out = torch.empty_like(x)
    rows = x.shape[0] * x.shape[1]
    plan = mlp_plan(rows, x.dtype, sm_count(x.device))
    ws = torch.empty(plan["elems"], dtype=x.dtype, device=x.device)
    err = lib.msclip_mlp_halfblock(
        x.data_ptr(), g.data_ptr(), beta.data_ptr(), w_fc.data_ptr(),
        b_fc.data_ptr(), w_proj.data_ptr(), b_proj.data_ptr(),
        out.data_ptr(), ws.data_ptr(), plan["slots"], plan["slot_rows"],
        plan["big"], rows, eps, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, "msclip_mlp_halfblock")
    fused_mlp_halfblock.launches += 1
    return out


fused_mlp_halfblock.launches = 0


def fused_block(x: torch.Tensor, p, n_head: int,
                mask: torch.Tensor | None = None,
                eps: float = 1e-12) -> torch.Tensor:
    """Pre-LN block as the JAX package's ``fused_block``: K5, then the MLP
    half unfused, each GEMM's output in the compute dtype with the bias
    added in that dtype, QuickGELU in that dtype."""
    x = fused_attention_halfblock(x, p, n_head, mask, eps)
    h = layer_norm(x, p["ln_2.weight"], p["ln_2.bias"], eps)
    mid = h @ p["mlp.c_fc.weight"].to(x.dtype).t() \
        + p["mlp.c_fc.bias"].to(x.dtype)
    mid = mid * torch.sigmoid(1.702 * mid)
    return x + (mid @ p["mlp.c_proj.weight"].to(x.dtype).t()
                + p["mlp.c_proj.bias"].to(x.dtype))

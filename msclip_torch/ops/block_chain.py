"""The trunk block's elementwise chain fused into five kernels (K7), for
inference.

``layers.transformer_block`` runs the block as LN1, the qkv projection, the
attention core, the out-projection, the residual add, LN2, the MLP and the
second residual add. Between the GEMMs and the core, PyTorch's eager ops
take ~28 full-tensor passes a block (the LayerNorm's fp32 island, four bias
adds, QuickGELU's three passes, two residual adds). Where no backward can
follow (inference mode, or no tensor of the block requires grad) the block
runs them as five hand-written kernels in ``csrc/block_chain.cu`` instead
(``layers.chain_block``):

* :func:`ln`: LN1, ``layers.layer_norm``;
* :func:`bias`: the qkv projection's bias add;
* :func:`bias_residual_ln`: the out-projection's bias add, the residual
  add and LN2, returning both the new residual stream and its LayerNorm;
* :func:`bias_gelu`: the fc layer's bias add and QuickGELU;
* :func:`bias_residual`: the c_proj layer's bias add and the second
  residual add.

Each takes a CPU tensor to its ``_plain`` version, the exact composition of
the ``layers`` functions it replaces, and a CUDA tensor to its kernel
(counted in ``<fn>.launches``), or raises on a dtype, shape or alignment the
kernel does not take; there is no fallback. Launches run on the current
stream with no host sync, so a CUDA graph can capture them. The kernels
round as the eager ops do, step by step: ``bias``, ``bias_gelu`` and
``bias_residual`` equal their plain versions bit for bit on the card; the
LayerNorms sum in another order, so their normalized value may land one
ulp of the compute dtype away.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .quant import MAX_WIDTH

SOURCE = "block_chain.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KIND = {"bias": 0, "bias_gelu": 1, "bias_residual": 2}


# ---------------------------------------------------------------------------
# plain versions: the eager ops of layers.transformer_block, restated here
# (``layers`` imports this module); the CPU tests hold them to those ops
# bit for bit
# ---------------------------------------------------------------------------

def ln_plain(x, weight, bias, eps=1e-12):
    """``layers.layer_norm``: fp32 statistics, the normalized value cast
    to ``x.dtype`` before the affine in ``x.dtype``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return weight.to(x.dtype) * normed + bias.to(x.dtype)


def bias_plain(y, b):
    """``linear``'s bias add."""
    return y + b.to(y.dtype)


def bias_gelu_plain(y, b):
    """``layers.quick_gelu`` of the bias add."""
    t = bias_plain(y, b)
    return t * torch.sigmoid(1.702 * t)


def bias_residual_plain(y, b, x):
    return x + bias_plain(y, b)


def bias_residual_ln_plain(y, b, x, weight, ln_bias, eps=1e-12):
    x1 = bias_residual_plain(y, b, x)
    return x1, ln_plain(x1, weight, ln_bias, eps)


# ---------------------------------------------------------------------------
# the route and the wrappers
# ---------------------------------------------------------------------------

def takes(x) -> bool:
    """Whether the kernels take the residual stream ``x [..., E]`` by its
    device, dtype and width (a block's widths are E, 3E and 4E)."""
    E = x.shape[-1]
    return (x.is_cuda and x.dtype in DTYPES and E % 8 == 0
            and 0 < E <= MAX_WIDTH and x.numel() > 0)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.msclip_block_ln.argtypes = [p, p, p, p, i, i, f, i, p]
    lib.msclip_block_bias_residual_ln.argtypes = [p, p, p, p, p, p, p, i, i,
                                                  f, i, p]
    lib.msclip_block_bias.argtypes = [i, p, p, p, p, ctypes.c_longlong, i, i,
                                      p]
    for fn in (lib.msclip_block_ln, lib.msclip_block_bias_residual_ln,
               lib.msclip_block_bias):
        fn.restype = ctypes.c_int
    return lib


def _check(x, others=(), vectors=(), max_width=None):
    """Raise for what the kernels do not take: every tensor of ``x``'s
    dtype and device, contiguous and 16-byte aligned (they read 8-element
    chunks with 16-byte loads); ``others`` of its shape; ``vectors`` ``[N]``
    with ``N`` its width, a multiple of 8 and at most ``max_width``."""
    dtype, device = x.dtype, x.device
    if dtype not in DTYPES:
        raise TypeError(f"block chain kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    N = x.shape[-1] if x.dim() else 0
    if x.dim() < 2 or x.numel() == 0 or N % 8:
        raise ValueError(f"block chain kernel takes a non-empty [..., N] "
                         f"tensor with N % 8 == 0, got {tuple(x.shape)}")
    if max_width is not None and N > max_width:
        raise ValueError(f"LayerNorm kernel takes E <= {max_width}, got {N}")
    for t in (x, *others, *vectors):
        if t.dtype != dtype or t.device != device:
            raise ValueError("block chain kernel takes tensors of one dtype "
                             "on one device")
        if t.data_ptr() % 16 or not t.is_contiguous():
            raise ValueError("block chain kernel needs contiguous, 16-byte "
                             "aligned tensors")
    for t in others:
        if t.shape != x.shape:
            raise ValueError(f"shapes differ: {tuple(t.shape)} against "
                             f"{tuple(x.shape)}")
    for v in vectors:
        if tuple(v.shape) != (N,):
            raise ValueError(f"a bias or LayerNorm vector must be [{N}], got "
                             f"{tuple(v.shape)}")


def _vectors(x, *vs):
    """The [N] vectors in ``x``'s dtype, contiguous (as they are, where
    they are already)."""
    return [v if v.dtype == x.dtype and v.is_contiguous()
            else v.to(x.dtype).contiguous() for v in vs]


def _launch(fn, c_fn, x, *args):
    """``c_fn(*args, stream)`` on ``x``'s device and its current stream,
    counted in ``fn.launches``."""
    index = x.get_device()
    with torch.cuda.device(index):
        err = c_fn(*args, torch._C._cuda_getCurrentRawStream(index))
    cuda_build.check(_lib(), err, c_fn.__name__)
    fn.launches += 1


def _rows(x):
    return x.numel() // x.shape[-1]


def ln(x, weight, bias, eps=1e-12):
    """``layers.layer_norm(x, weight, bias, eps)``; on the card one warp a
    row, counted in ``ln.launches``."""
    if not x.is_cuda:
        return ln_plain(x, weight, bias, eps)
    weight, bias = _vectors(x, weight, bias)
    _check(x, vectors=(weight, bias), max_width=MAX_WIDTH)
    out = torch.empty_like(x)
    _launch(ln, _lib().msclip_block_ln, x, x.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), out.data_ptr(), _rows(x), x.shape[-1], eps,
            DTYPES[x.dtype])
    return out


def bias_residual_ln(y, b, x, weight, ln_bias, eps=1e-12):
    """``x1 = x + (y + b)`` and ``layers.layer_norm(x1, weight, ln_bias,
    eps)``, returned as ``(x1, ln)``; counted in
    ``bias_residual_ln.launches``."""
    if not y.is_cuda:
        return bias_residual_ln_plain(y, b, x, weight, ln_bias, eps)
    b, weight, ln_bias = _vectors(y, b, weight, ln_bias)
    _check(y, (x,), (b, weight, ln_bias), MAX_WIDTH)
    x1, h = torch.empty_like(y), torch.empty_like(y)
    _launch(bias_residual_ln, _lib().msclip_block_bias_residual_ln, y,
            y.data_ptr(), b.data_ptr(), x.data_ptr(), weight.data_ptr(),
            ln_bias.data_ptr(), x1.data_ptr(), h.data_ptr(), _rows(y),
            y.shape[-1], eps, DTYPES[y.dtype])
    return x1, h


def _bias_launch(fn, y, b, x=None):
    b, = _vectors(y, b)
    _check(y, () if x is None else (x,), (b,))
    out = torch.empty_like(y)
    _launch(fn, _lib().msclip_block_bias, y, _KIND[fn.__name__], y.data_ptr(),
            b.data_ptr(), 0 if x is None else x.data_ptr(), out.data_ptr(),
            _rows(y), y.shape[-1], DTYPES[y.dtype])
    return out


def bias(y, b):
    """``y + b`` (``linear``'s bias add); counted in ``bias.launches``."""
    if not y.is_cuda:
        return bias_plain(y, b)
    return _bias_launch(bias, y, b)


def bias_gelu(y, b):
    """``layers.quick_gelu(y + b)``; counted in ``bias_gelu.launches``."""
    if not y.is_cuda:
        return bias_gelu_plain(y, b)
    return _bias_launch(bias_gelu, y, b)


def bias_residual(y, b, x):
    """``x + (y + b)``; counted in ``bias_residual.launches``."""
    if not y.is_cuda:
        return bias_residual_plain(y, b, x)
    return _bias_launch(bias_residual, y, b, x)


KERNELS = (ln, bias, bias_residual_ln, bias_gelu, bias_residual)
for _fn in KERNELS:
    _fn.launches = 0

"""The LayerNorm limit of the block chain K7 (``ops/block_chain.py``),
shared by its CPU tests and its card tests. Imports neither JAX nor the
JAX package."""

import torch

from msclip_torch.models import layers as L


def ulp(a, dtype):
    """The spacing of ``dtype`` at magnitudes ``a`` (fp32), normal range."""
    bits = {torch.bfloat16: 8, torch.float32: 24}[dtype]
    _, e = torch.frexp(a.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(a), e - bits)


def assert_ln_close(got, x, w, b, eps=1e-12):
    """A LayerNorm of ``x`` that sums in another order against
    ``layers.layer_norm``: each element within what k ulps of the
    normalized value ``n`` (at unit scale or above: a row's n is of order
    1, and the sums' order moves its mean by an absolute amount) make
    after the affine's two roundings, ``k |w| ulp(max(|n|, 1)) + ulp(w n)
    + ulp(h)``. bf16: k = 1, n's rounding to bf16 takes up the fp32
    statistics' differences, and at most 1% of the elements differ at all.
    fp32: k = 4, n is not rounded to a coarser type, so the few fp32 ulps
    by which another order of the sums and ``rsqrtf`` (within two ulps)
    move the mean and ``rstd`` reach it whole."""
    dtype = x.dtype
    want = L.layer_norm(x, w, b, eps)
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    n = ((xf - mean) * torch.rsqrt(var + eps)).to(dtype).float()
    wf = w.float()
    k = 1 if dtype == torch.bfloat16 else 4
    tol = (k * wf.abs() * ulp(n.abs().clamp_min(1.0), dtype)
           + ulp(wf * n, dtype) + ulp(want.float(), dtype))
    diff = (got.float() - want.float()).abs()
    assert got.dtype == dtype and got.shape == want.shape
    assert bool((diff <= tol).all()), (
        f"{int((diff > tol).sum())} elements beyond {k} ulps; worst "
        f"{float((diff / tol).max())} of its limit")
    if dtype == torch.bfloat16:
        assert float((diff > 0).float().mean()) <= 0.01

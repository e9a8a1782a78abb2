"""The port's int8 eval (``TPU.INT8_EVAL``) against the JAX package's, on the
CPU: the plain versions of K3/K4 against the Pallas kernels in interpret
mode, weight quantization, the int8 blocks, the towers, the resolved B/16
config and the zero-shot CLI, on inputs made with numpy from a seed."""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msclip_tpu.models import build_model as jax_build_model
from msclip_tpu.models import layers as JL
from msclip_tpu.models.folding import fold_params_for_eval as jax_fold
from msclip_tpu.models.quantize import _quantize_block as jax_quantize_block
from msclip_tpu.models.quantize import (
    quantize_linear_weight as jax_quantize_linear_weight,
)
from msclip_tpu.models.quantize import (
    quantize_params_for_eval as jax_quantize_params,
)
from msclip_tpu.ops import quant as JQ
from msclip_tpu.utils import export_torch_state_dict
from msclip_torch.config import get_default_config, update_config
from msclip_torch.models import layers as TL
from msclip_torch.models import msclip as TM
from msclip_torch.models.folding import fold_params_for_eval
from msclip_torch.models.quantize import (
    quantize_linear_weight,
    quantize_params_for_eval,
)
from msclip_torch.ops import quant as Q
from msclip_torch.utils.convert import params_from_jax

from reference_oracle import tiny_msclips_config
from torch_port_params import random_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TIES = (127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5)
BLOCK_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_quantize.py:137


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _strict(fn, *args):
    """``fn`` jitted without excess precision. XLA on the CPU otherwise
    skips the bf16 rounding of a value that is converted to fp32 next (the
    kernel's ``h``), which the TPU kernel and torch both do."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _assert_quant_matches(got, want):
    """Equal ``s`` at rtol 1e-6 and equal ``q``, but that where the
    LayerNorm's sums run in another order (torch against XLA) a value of
    ``h`` can move by one ulp and a ``q`` next to a tie by one: |dq| <= 1
    on at most 0.1% of the elements."""
    (q, s), (jq, js) = got, [np.asarray(a) for a in want]
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-6)
    dq = np.abs(q.numpy().astype(np.int32) - jq.astype(np.int32))
    assert dq.max() <= 1 and (dq > 0).mean() <= 1e-3, (dq.max(), dq.mean())


def _ln_rows(rng, kind, E=256):
    """``(x [3, 20, E], weight, bias)``: random rows, constant rows with
    the ties as bias (h = bias exactly: s = 1, q half to even), or zero
    rows with a zero bias (s = 1e-8, q = 0)."""
    w = 1 + _np(rng, E, scale=0.1)
    if kind == "random":
        return _np(rng, 3, 20, E), w, _np(rng, E, scale=0.1)
    consts = np.array([0.0, 1.0, -3.0, 0.5, 1024.0], np.float32)
    x = np.broadcast_to(np.resize(consts, (3, 20, 1)), (3, 20, E)).copy()
    if kind == "zeros":
        return np.zeros_like(x), w, np.zeros(E, np.float32)
    return x, w, np.resize(np.array(TIES, np.float32), E)


def _gelu_rows(rng, kind, F=512):
    """Random rows; rows whose GELU is exact (x >= 61: exp(-1.702 x)
    underflows) with max 254, so s = 2 and the others sit on ties
    (61 -> 30.5 -> 30, 63 -> 31.5 -> 32, ...); zero rows."""
    if kind == "random":
        return _np(rng, 3, 20, F, scale=2.0)
    if kind == "zeros":
        return np.zeros((3, 20, F), np.float32)
    row = np.resize(np.array([254.0, 61.0, 63.0, 65.0, 67.0, 0.0, -61.0],
                             np.float32), F)
    return np.broadcast_to(row, (3, 20, F)).copy()


@pytest.mark.parametrize("kind", ["random", "ties", "zeros"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_quant_plain_matches_jax_kernel(dtype, kind):
    tdt, jdt = DTYPES[dtype]
    x, w, b = _ln_rows(np.random.default_rng(0), kind)
    got = Q.ln_quant(_t(x).to(tdt), _t(w), _t(b))
    want = _strict(lambda x, w, b: JQ.ln_quant(
        x, {"scale": w, "bias": b}, 1e-12, interpret=True),
        jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(b))
    _assert_quant_matches(got, want)
    if kind == "ties":
        ties = torch.round(_t(b)).to(torch.int8)
        assert (got[0] == ties).all() and (got[1] == 1.0).all()
        assert ties[:7].tolist() == [127, 0, 2, 2, 0, -2, -2]
    if kind == "zeros":
        assert (got[0] == 0).all() and (got[1] == torch.tensor(1e-8)).all()


@pytest.mark.parametrize("kind", ["random", "ties", "zeros"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_quant_plain_matches_jax_kernel(dtype, kind):
    tdt, jdt = DTYPES[dtype]
    x = _gelu_rows(np.random.default_rng(1), kind)
    got = Q.gelu_quant(_t(x).to(tdt))
    want = _strict(lambda x: JQ.gelu_quant(x, interpret=True),
                   jnp.asarray(x).astype(jdt))
    _assert_quant_matches(got, want)
    if kind == "ties":
        assert got[0][0, 0, :7].tolist() == [127, 30, 32, 32, 34, 0, 0]
        assert (got[1] == 2.0).all()
    if kind == "zeros":
        assert (got[0] == 0).all() and (got[1] == torch.tensor(1e-8)).all()


# K4's division sequences (csrc/quant.cu), emulated with numpy: an fp32
# fma rounds the exact a b + c once; fp64 holds a b exactly and a two-sum
# gives the error of a b + c in fp64, which breaks an fp32 tie.
F32, F64 = np.float32, np.float64


def _round32(s, e):
    """fp32 rounding of the exact ``s + e`` (``s`` fp64, ``|e|`` at most
    half an fp64 ulp of ``s``): fp64 to fp32 rounds ``s``, right unless
    ``s`` lies on an fp32 midpoint and ``e`` moves it off."""
    r = s.astype(F32)
    up = r.astype(F64) > s
    lo = np.where(up, np.nextafter(r, F32(-np.inf)), r)
    hi = np.where(up, r, np.nextafter(r, F32(np.inf)))
    tie = (s == (lo.astype(F64) + hi.astype(F64)) / 2) & (e != 0)
    return np.where(tie, np.where(e > 0, hi, lo), r)


def _fma32(a, b, c):
    p = a.astype(F64) * b.astype(F64)
    c = np.broadcast_to(c, p.shape).astype(F64)
    s = p + c
    bb = s - p
    return _round32(s, (p - (s - bb)) + (c - bb))


def _mul32(a, b):
    return (a.astype(F64) * b.astype(F64)).astype(F32)


def _div_newton(x, d, r0):
    """``div_newton``: an approximate 1 / d, one Newton step, q = x r and
    Markstein's correction."""
    r = _fma32(r0, _fma32(-d, r0, F32(1)), r0)
    q = _mul32(x, r)
    return _fma32(_fma32(-q, d, x), r, q)


def _div_rn(x, y, r):
    """``hopper.cuh div_rn``: q = x r, then q + (x - q y) r."""
    q = _mul32(x, r)
    return _fma32(_fma32(-q, y, x), r, q)


def _ulps(v, k):
    """``v`` moved ``k`` fp32 ulps away from zero (``v > 0``)."""
    return (v.view(np.int32) + np.int32(k)).view(F32)


def _same(a, b):
    """Bitwise equal, but any NaN equal to any NaN and -0 to 0."""
    return (a.view(np.int32) == b.view(np.int32)) | (a == b) \
        | (np.isnan(a) & np.isnan(b))


def _quick_gelu_kernel(x, d, r_off):
    """K4's QuickGELU quotient of ``x`` and ``d = 1 + exp(-1.702 x)``:
    ``div_newton``, the reciprocal approximation ``r_off`` ulps off 1 / d
    rounded, or where ``gelu_is_wide`` holds, ``quick_gelu_wide``."""
    with np.errstate(all="ignore"):
        ones = (d.view(np.uint32) & 0x7FFFFF) == 0x7FFFFF
        wide = ~(d < F32(2.0 ** 126)) | (x == np.inf) | ones
        safe = np.where(d < F32(2.0 ** 126), d, F32(1))
        h = _div_newton(x, safe, _ulps(F32(1) / safe, r_off))
        big = d >= F32(2.0 ** 126)
        xs = np.where(big, x * F32(2.0 ** -64), x)
        ds = np.where(big & np.isfinite(d), d * F32(2.0 ** -64), safe)
        exact = _div_rn(xs, ds, F32(1) / ds)  # rcp_rn: 1 / d rounded once
        special = np.where(np.isnan(x) | np.isnan(d), x + d,
                           np.where(d == np.inf, x * F32(0), x))
        rare = np.isnan(x) | np.isnan(d) | (d == np.inf) | (x == np.inf)
        return np.where(wide, np.where(rare, special, exact), h)


def test_quick_gelu_quotient_rounds_as_ieee_division():
    """K4's ``x / (1 + e)`` (``div_newton``, and ``quick_gelu_wide`` where
    1 / d is not normal or x is not finite) equals IEEE division bit for
    bit on every bf16 x and on 2^20 fp32 x, at the denominator numpy's exp
    gives and two ulps either side (the card's expf may differ by one;
    there the quotient of an |x| below 2^-100 need only stay below it), the hardware
    reciprocal two ulps off either way: -0 where e overflows, exact scaled
    quotients down to x = -52.1, NaN and infinities as IEEE has them."""
    rng = np.random.default_rng(0)
    bf16 = (np.arange(1 << 16, dtype=np.uint32) << 16).view(F32)
    fp32 = (rng.choice([-1, 1], 1 << 20) * rng.random(1 << 20)
            * np.exp2(rng.integers(-40, 12, 1 << 20))).astype(F32)
    near = np.linspace(-52.5, -51.0, 4096, dtype=F32)  # d >= 2^126 and inf
    x = np.concatenate([bf16, fp32, near])
    with np.errstate(all="ignore"):
        d0 = F32(1) + np.exp(F32(-1.702) * x)
        checked = 0
        for d_off in (-2, -1, 0, 1, 2):
            d = np.where(np.isfinite(d0), _ulps(d0, d_off), d0)
            d = np.where(np.isnan(d) | (d >= 1), d, F32(1))
            want = x / d
            # below |x| = 2^-100 the residual x - q d can underflow; there
            # exp gives 1 and d = 2, where the sequence is exact, but at a
            # neighbouring d it need only stay below 2^-100 (rint(h / s) = 0
            # and h is under the scale's floor)
            tiny = (np.abs(x) < F32(2.0 ** -100)) & (d_off != 0)
            for r_off in (-2, -1, 0, 1, 2):
                got = _quick_gelu_kernel(x, d, r_off)
                bad = ~_same(got, want) & ~tiny
                assert not bad.any(), (x[bad][:5], d[bad][:5], got[bad][:5])
                assert (np.abs(got[tiny]) < F32(2.0 ** -100)).all()
                checked += x.size
    assert checked >= 25 * (1 << 20)
    assert (bf16 == 0).any() and np.isnan(bf16).sum() == 254
    # the sequence alone (no wide path) is wrong where it must be: e
    # overflowing (NaN, not -0), x = +inf, d >= 2^126 (-0, not x / d), and
    # an all-ones significand with the reciprocal an ulp low
    for xv, dv, off in ((-53.0, np.inf, 0), (np.inf, 1.0, 0),
                        (-51.75, 2.0 ** 127, 0), (2.0 ** -23, 2 - 2.0 ** -23, -1)):
        xv, dv = np.array([xv], F32), np.array([dv], F32)
        with np.errstate(all="ignore"):
            r0 = _ulps(F32(1) / dv, off) if np.isfinite(dv).all() else F32([0])
            plain = _div_newton(xv, dv, np.where(dv < 2.0 ** 126, r0, F32(0)))
        assert not _same(plain, xv / dv).all(), (xv, dv, plain)


def test_quantize_quotient_rounds_as_ieee_division():
    """K4's scale ``max(div_rn(amax, 127, RN(1/127)), 1e-8)`` equals the
    plain version's IEEE ``max(amax / 127, 1e-8)`` on 2^20 amax, and its
    quantize quotient ``div_rn(h, s, rcp_rn(s))`` the IEEE ``h / s`` on
    2^21 pairs from the kernel's domain (|h| <= amax, ties at .5 and
    quotients near +-127), except where that quotient is below 2^-24,
    where both round to 0; the int8 from ``v + 1.5 2^23`` is
    ``clamp(rint(h / s), -127, 127)``."""
    rng = np.random.default_rng(1)
    n = 1 << 20
    amax = (rng.random(n) * np.exp2(rng.integers(-140, 128, n))).astype(F32)
    amax = np.concatenate([amax, F32([0, 1e-30, 1.27e-6, 1.27e-6 * 1.0001,
                                      3.4028235e38])])
    with np.errstate(over="ignore"):
        s = np.maximum(_div_rn(amax, F32(127), F32(1) / F32(127)), F32(1e-8))
        assert _same(s, np.maximum(amax / F32(127), F32(1e-8))).all()
    # rcp_rn: two fp64 Newton steps from two ulps off, rounded once
    r = F32(1) / s
    for off in (-2, 2):
        rr = _ulps(r, off).astype(F64)
        for _ in range(2):
            rr = rr + rr * (1.0 - s.astype(F64) * rr)
        assert (rr.astype(F32) == r).all()
    # h: uniform in [-amax, amax], +-amax, ties (k + 0.5) s where exact, and
    # their neighbours; half the scales with 16-bit significands, on which
    # most ties are exact
    amax, s, r = amax[:n], s[:n], r[:n]
    short = (rng.integers(1 << 15, 1 << 16, n // 2)
             * np.exp2(rng.integers(-43, 100, n // 2))).astype(F32)
    s[: n // 2], r[: n // 2] = short, F32(1) / short
    amax[: n // 2] = (F64(127) * short).astype(F32)
    k = rng.integers(-127, 127, n).astype(F64) + 0.5
    tie = (k * s.astype(F64)).astype(F32)
    tie = np.where(tie.astype(F64) == k * s.astype(F64), tie, F32(0))
    h = np.concatenate([
        (rng.uniform(-1, 1, n) * amax).astype(F32), amax, -amax, tie,
        np.nextafter(tie, F32(np.inf)), np.nextafter(tie, F32(-np.inf))])
    s, r = np.tile(s, 6), np.tile(r, 6)
    got = _div_rn(h, s, r)
    want = h / s
    # below 2^-24 (h under 2^-100, or far under s) x - q y can underflow;
    # there both quotients round to 0
    normal = np.abs(want) >= F32(2.0 ** -24)
    assert (tie != 0).mean() > 0.3 and np.abs(want).max() <= 127.0001
    assert _same(got[normal], want[normal]).all()
    assert (np.rint(got[~normal]) == 0).all()
    q = ((got + F32(12582912.0)).view(np.uint32) & 0xFF).astype(np.uint8) \
        .view(np.int8)
    assert (q == np.clip(np.rint(want), -127, 127).astype(np.int8)).all()
    assert (np.abs(np.rint(want)) == 127).any() and (q == 0).any()


def test_gelu_quant_constants_mirror_the_source():
    """The literals of K4's sequences in ``csrc/quant.cu`` are the ones the
    emulations above take: RN(1 / 127), 1.5 2^23, 2^126, 2^-64."""
    import re

    with open(os.path.join(REPO, "msclip_torch", "csrc", "quant.cu")) as f:
        src = f.read()
    rcp = re.search(r"kRcp127 = (0x[0-9a-fp.+-]+)f;", src).group(1)
    assert F32(float.fromhex(rcp)) == F32(1) / F32(127)
    assert float(re.search(r"kRintMagic = ([0-9.]+)f;", src).group(1)) \
        == 1.5 * 2 ** 23
    assert "!(d < 0x1p126f)" in src and "d >= 0x1p126f" in src
    assert "x *= 0x1p-64f;" in src and "d *= 0x1p-64f;" in src
    assert "(__float_as_uint(d) & 0x7FFFFFu) == 0x7FFFFFu" in src
    assert "rcp.approx.ftz.f32" in src and "max.NaN.f32" in src


def test_ln_quant_constants_mirror_the_source():
    """K3 in ``csrc/quant.cu`` takes the quantization K4 takes (the scale by
    ``div_rn`` with RN(1 / 127), the quotient by ``div_rn`` with one rounded
    reciprocal a row, the NaN-propagating abs-max, zeros for a non-finite
    scale: the sequences the emulations here check) and the sums the
    emulation below takes; its widest row is the wrapper's ``MAX_WIDTH``."""
    import re

    with open(os.path.join(REPO, "msclip_torch", "csrc", "quant.cu")) as f:
        src = f.read()
    k3 = src[src.index("ln_quant_kernel(const T*"):src.index("// K4\n")]
    for piece in ("tree_sum8(v[j])", "sq[j] = fmaf(v[j][i], v[j][i], sq[j]);",
                  "__fdiv_rn(warp_sum(sum), (float)E)",
                  "rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq_all), (float)E), eps))",
                  "affine.run(v[j], wc, bc, rstd);",
                  "row_scale(warp_max_nan(affine.amax()))", "scale_rcp(sc)",
                  "quantize8(v[j], sc, r)"):
        assert piece in k3, piece
    # the affine: bf16 rounded once an op on bf16x2 (equal to an fp32 op
    # rounded to bf16: fp32's 24 bits >= 2 x 8 + 2), fp32 unfused
    for piece in ("__floats2bfloat162_rn(__fmul_rn(v[i], rstd),",
                  "__hadd2_rn(__hmul2_rn(w2[i / 2], n2), b2[i / 2])",
                  "amax2 = __hmax2_nan(amax2, __habs2(h2));",
                  "__fadd_rn(__fmul_rn(w.get(i), __fmul_rn(v[i], rstd)), b.get(i))",
                  "amax_ = max_nan(amax_, fabsf(v[i]));"):
        assert piece in src, piece
    assert "amax <= kFltMax ? fmaxf(div_rn(amax, 127.0f, kRcp127), 1e-8f) : amax" in src
    assert "sc <= kFltMax ? packed : make_uint2(0u, 0u)" in src
    assert "__fadd_rn(div_rn(h[i], sc, r), kRintMagic)" in src
    chunks = int(re.search(r"constexpr int kLnMaxChunks = (\d+);", src).group(1))
    chunk = int(re.search(r"constexpr int kChunk = (\d+);", src).group(1))
    assert 32 * chunks * chunk == Q.MAX_WIDTH


def _bf16_round_once(x):
    """fp64 ``x`` rounded once to bf16 (to nearest even, bf16's subnormals
    below 2^-126, inf past the largest), as fp32."""
    with np.errstate(all="ignore"):
        e = np.floor(np.log2(np.abs(x)))
        quantum = np.exp2(np.maximum(np.where(np.isfinite(e), e, 0), -126) - 7)
        r = np.round(x / quantum) * quantum
        return np.where(np.abs(r) >= 2.0 ** 128, np.sign(r) * np.inf, r).astype(F32)


def test_bf16_ops_round_once_as_fp32_then_bf16():
    """K3's packed bf16 affine (``__hmul2_rn``, ``__hadd2_rn``: the exact
    product or sum rounded once to bf16) against torch's (the fp32 op,
    then bf16): equal on 2^20 pairs of random bf16 values of every sign and
    binade (fp32's 24 bits are at least 2 x 8 + 2, so rounding through fp32
    is the one rounding), but for products in fp32's subnormal range, below
    2^-126, which K3 needs equal only up to quantizing to 0 under the
    scale's floor."""
    rng = np.random.default_rng(9)
    n = 1 << 20
    bits = rng.integers(0, 1 << 16, (2, n), dtype=np.int64).astype(np.int16)
    a, b = (torch.from_numpy(v).view(torch.bfloat16).float().numpy() for v in bits)
    ok = np.isfinite(a) & np.isfinite(b)
    a, b = a[ok], b[ok]
    with np.errstate(all="ignore"):
        # half the pairs close in exponent, where the sum rounds at all
        near = np.arange(a.size) % 2 == 0
        b = np.where(near, _round_to((a * F32(rng.uniform(-4, 4, a.size)))
                                     .astype(F32), torch.bfloat16), b)
        for op in (np.add, np.multiply):
            once = _bf16_round_once(op(a.astype(F64), b.astype(F64)))
            torch_way = _round_to(op(a, b).astype(F32), torch.bfloat16)
            normal = np.abs(op(a.astype(F64), b.astype(F64))) >= 2.0 ** -126
            both = normal | (op is np.add)
            assert _same(once[both], torch_way[both]).all(), op
            assert (np.abs(once[~both]) < 2.0 ** -100).all()


def _round_to(v, dtype):
    """fp32 ``v`` rounded to ``dtype`` (to nearest even) and back."""
    return torch.from_numpy(v).to(dtype).float().numpy()


def _warp_sum(v):
    """``warp_sum`` over the lane axis (-1) of 32: the xor butterfly, each
    step one fp32 add (commutative, so every lane ends with one value)."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ o]).astype(F32)
    return v[..., 0]


def _ln_quant_kernel(x, w, b, dtype, eps=1e-12):
    """K3 of ``csrc/quant.cu`` emulated with numpy on rows ``x [R, E]`` of
    values of ``dtype`` (fp32 arrays): lane l holds the chunks l, l + 32, ...
    of 8; each chunk's tree sum into the lane's sum; ``warp_sum``; the
    squares as fp32 fmas a chunk; rsqrt rounded once (the card's
    ``rsqrtf`` is within an ulp or two); the three roundings to ``dtype``;
    the NaN-propagating abs-max; ``row_scale``, ``div_rn`` by the rounded
    reciprocal, and the low byte of ``v + 1.5 2^23``, 0 where s is not
    finite."""
    R, E = x.shape
    C = -(-E // 256)
    v = np.zeros((R, C, 32, 8), F32)  # chunk lane + 32 j at [:, j, lane]
    have = np.zeros((C, 32), bool)
    for c in range(E // 8):
        v[:, c // 32, c % 32] = x[:, 8 * c:8 * c + 8]
        have[c // 32, c % 32] = True
    with np.errstate(all="ignore"):
        t = [(v[..., 2 * i] + v[..., 2 * i + 1]).astype(F32) for i in range(4)]
        tree = ((t[0] + t[1]).astype(F32) + (t[2] + t[3]).astype(F32)).astype(F32)
        lane_sum = np.zeros((R, 32), F32)
        for j in range(C):
            lane_sum = np.where(have[j], (lane_sum + tree[:, j]).astype(F32), lane_sum)
        mean = (_warp_sum(lane_sum) / F32(E)).astype(F32)[:, None, None, None]
        d = (v - mean).astype(F32)
        sq = np.zeros((R, C, 32), F32)
        for i in range(8):
            sq = _fma32(d[..., i], d[..., i], sq)
        sq_lane = np.zeros((R, 32), F32)
        for j in range(C):
            sq_lane = np.where(have[j], (sq_lane + sq[:, j]).astype(F32), sq_lane)
        var = (_warp_sum(sq_lane) / F32(E)).astype(F32)
        rstd = (1.0 / np.sqrt((var + F32(eps)).astype(F32).astype(F64))).astype(F32)
        wv, bv = (np.zeros((C, 32, 8), F32) for _ in range(2))
        for c in range(E // 8):
            wv[c // 32, c % 32] = w[8 * c:8 * c + 8]
            bv[c // 32, c % 32] = b[8 * c:8 * c + 8]
        normed = _round_to((d * rstd[:, None, None, None]).astype(F32), dtype)
        prod = _round_to((wv * normed).astype(F32), dtype)
        h = _round_to((prod + bv).astype(F32), dtype)
        habs = np.where(have[..., None], np.abs(h), F32(0)).reshape(R, -1)
        amax = np.where(np.isnan(habs).any(-1), F32(np.nan), habs.max(-1))
        finite = amax <= F32(3.402823466e38)
        s = np.where(finite, np.maximum(_div_rn(amax, F32(127), F32(1) / F32(127)),
                                        F32(1e-8)), amax).astype(F32)
        ss = np.where(finite, s, F32(1))[:, None, None, None]
        u = (_div_rn(h, ss, (F32(1) / ss).astype(F32)) + F32(12582912.0)).astype(F32)
        q = (u.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
        q = np.where(finite[:, None, None, None], q, np.int8(0))
    out = np.zeros((R, E), np.int8)
    for c in range(E // 8):
        out[:, 8 * c:8 * c + 8] = q[:, c // 32, c % 32]
    return torch.from_numpy(out), torch.from_numpy(s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E", [64, 768, 1032])
def test_ln_quant_kernel_arithmetic_matches_plain(dtype, E):
    """K3's arithmetic (:func:`_ln_quant_kernel`) against ``ln_quant_plain``
    on the CPU, at the card checks' limits: random rows, rows with ties, and
    a zero row (q within 1, per row |s - s_plain| <= S_RTOL s_plain, q s
    within one step), and ``chip_smoke.ln_quant_nonfinite_rows`` (an inf,
    a NaN, a -inf, w n + b overflowing, a scale near the largest) bit for
    bit: q equal, s equal or both NaN. E = 1032 leaves lanes without their
    last chunk."""
    import chip_smoke

    s_rtol = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}[dtype]
    rng = np.random.default_rng(E)
    x = _np(rng, 64, E)
    x[5] = 3.0  # constant row: h = b
    x[6] = 0.0
    w = (1 + _np(rng, E, scale=0.1))
    b = np.resize(np.array(TIES, F32), E)
    x, w, b = (torch.from_numpy(a).to(dtype) for a in (x, w, b))
    q, s = _ln_quant_kernel(x.float().numpy(), w.float().numpy(),
                            b.float().numpy(), dtype)
    qp, sp = Q.ln_quant_plain(x, w, b)
    assert (q.int() - qp.int()).abs().max() <= 1
    assert ((s - sp).abs() <= s_rtol * sp).all()
    step = torch.maximum(s, sp).double() + 127 * (s - sp).abs().double()
    deq = (q.double() * s.double()[:, None] - qp.double() * sp.double()[:, None])
    assert (deq.abs() <= step[:, None]).all()
    assert (q[5] == torch.round(b.float()).to(torch.int8)).all() and s[5] == 1.0
    xn, wn, bn = chip_smoke.ln_quant_nonfinite_rows(E, dtype, "cpu")
    q, s = _ln_quant_kernel(xn[0].float().numpy(), wn.float().numpy(),
                            bn.float().numpy(), dtype)
    qp, sp = Q.ln_quant_plain(xn[0], wn, bn)
    assert torch.equal(q, qp)
    assert ((s.view(torch.int32) == sp.view(torch.int32))
            | (torch.isnan(s) & torch.isnan(sp))).all()
    assert torch.isnan(sp[:3]).all() and sp[3] == math.inf and sp[4] > 1e36


def test_quantize_linear_weight_matches_jax():
    """The port's ``[out, in]`` weight against JAX's ``[in, out]``."""
    rng = np.random.default_rng(2)
    w = _np(rng, 96, 64, scale=0.05)
    w[3] = 0.0  # an all-zero output channel: scale 1e-8
    q, s = quantize_linear_weight(_t(w))
    jq, js = jax_quantize_linear_weight(jnp.asarray(w.T))
    assert q.dtype == torch.int8 and q.shape == (96, 64)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[3] == torch.tensor(1e-8) and (q[3] == 0).all()


def _jax_block(rng, E):
    return {
        "attn": {"qkv_w": _np(rng, E, 3 * E, scale=0.05),
                 "qkv_b": _np(rng, 3 * E, scale=0.1),
                 "out_w": _np(rng, E, E, scale=0.05),
                 "out_b": _np(rng, E, scale=0.1)},
        "ln_1": {"scale": 1 + _np(rng, E, scale=0.1),
                 "bias": _np(rng, E, scale=0.1)},
        "ln_2": {"scale": 1 + _np(rng, E, scale=0.1),
                 "bias": _np(rng, E, scale=0.1)},
        "mlp": {"c_fc": {"w": _np(rng, E, 4 * E, scale=0.05),
                         "b": _np(rng, 4 * E, scale=0.1)},
                "c_proj": {"w": _np(rng, 4 * E, E, scale=0.05),
                           "b": _np(rng, E, scale=0.1)}},
    }


def _port_block(qb):
    """A JAX block quantized by ``_quantize_block`` under the port's local
    names: the very same int8 tensors, transposed to ``[out, in]``."""
    a, m = qb["attn"], qb["mlp"]

    def i8(v):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(v).T))

    p = {"ln_1.weight": _t(qb["ln_1"]["scale"]),
         "ln_1.bias": _t(qb["ln_1"]["bias"]),
         "ln_2.weight": _t(qb["ln_2"]["scale"]),
         "ln_2.bias": _t(qb["ln_2"]["bias"]),
         "attn.in_proj_bias": _t(a["qkv_b"]),
         "attn.out_proj.bias": _t(a["out_b"]),
         "mlp.c_fc.bias": _t(m["c_fc"]["b"]),
         "mlp.c_proj.bias": _t(m["c_proj"]["b"])}
    for key, (q, s) in {
            "attn.in_proj_weight": (a["qkv_w_int8"], a["qkv_w_scale"]),
            "attn.out_proj.weight": (a["out_w_int8"], a["out_w_scale"]),
            "mlp.c_fc.weight": (m["c_fc"]["w_int8"], m["c_fc"]["w_scale"]),
            "mlp.c_proj.weight": (m["c_proj"]["w_int8"],
                                  m["c_proj"]["w_scale"])}.items():
        p[f"{key}_int8"], p[f"{key}_scale"] = i8(q), _t(s)
    return p


@pytest.fixture(scope="module")
def int8_block_pair():
    rng = np.random.default_rng(3)
    qb = jax.tree.map(np.asarray, jax_quantize_block(_jax_block(rng, 128)))
    return qb, _port_block(qb), rng


def test_int8_block_matches_jax_fused_block(int8_block_pair):
    """The fused form against ``_int8_block`` with the Pallas kernels in
    interpret mode, fp32, at the JAX package's tolerance."""
    qb, tp, rng = int8_block_pair
    x = _np(rng, 2, 100, 128, scale=0.5)
    want = jax.jit(lambda x: JL._int8_block(
        qb, x, 2, None, 1e-12, use_pallas=True, pallas_interpret=True))(
        jnp.asarray(x))
    got = TL.int8_block(tp, _t(x), 2, None, 1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


@pytest.mark.parametrize("L,causal,fused", [(77, True, False),
                                            (95, False, False),
                                            (96, False, True),
                                            (197, False, True)])
def test_transformer_block_on_int8_weights_matches_jax(
        int8_block_pair, monkeypatch, L, causal, fused):
    """Below ``INT8_MIN_SEQ`` = 96 every GEMM quantizes its input on the
    fly and QuickGELU runs in the compute dtype, as JAX's
    ``transformer_block`` with ``use_pallas=False``; from 96 on the block
    takes the fused form, held against JAX's with the Pallas kernels in
    interpret mode (JAX's gate is the same 96). The unfused form computes
    QuickGELU as ``x * sigmoid(1.702 x)``, the fused one as
    ``x / (1 + exp(-1.702 x))``: an ulp apart, which moves a quantized
    value next to a tie by one step, beyond this tolerance."""
    qb, tp, rng = int8_block_pair
    fused_calls, real = [], TL.int8_block

    def spy(*args):
        fused_calls.append(1)
        return real(*args)

    monkeypatch.setattr(TL, "int8_block", spy)
    x = _np(rng, 2, L, 128, scale=0.5)
    mask = JL.build_causal_mask(L) if causal else None
    want = jax.jit(lambda x: JL.transformer_block(
        qb, x, 2, mask, 1e-12, use_pallas=fused, pallas_interpret=True))(
        jnp.asarray(x))
    got = TL.transformer_block(
        tp, _t(x), 2, TL.build_causal_mask(L) if causal else None, 1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    assert bool(fused_calls) == fused


@pytest.mark.parametrize("min_seq,L,fused", [("64", 77, True),
                                              ("128", 100, False)])
def test_int8_min_seq_moves_both_gates(int8_block_pair, monkeypatch,
                                       min_seq, L, fused):
    """``MSCLIP_INT8_MIN_SEQ`` moves the fused int8 gate in both packages
    (``msclip_tpu/ops/tuning.py:94``; the port reads it at call time): at
    a length between the new gate and the default 96 both take the same
    form, fused at 77 under a gate of 64 and unfused at 100 under one of
    128, and give the same features."""
    from msclip_tpu.ops import tuning

    qb, tp, _ = int8_block_pair
    rng = np.random.default_rng(L)  # the module rng's draws hang on order
    fused_calls, real = [], TL.int8_block

    def spy(*args):
        fused_calls.append(1)
        return real(*args)

    monkeypatch.setattr(TL, "int8_block", spy)
    monkeypatch.setenv("MSCLIP_INT8_MIN_SEQ", min_seq)
    tuning.get_tuning.cache_clear()
    try:
        assert tuning.get_tuning().int8_min_seq == TL.int8_min_seq() \
            == int(min_seq)
        x = _np(rng, 2, L, 128, scale=0.5)
        want = jax.jit(lambda x: JL.transformer_block(
            qb, x, 2, None, 1e-12, use_pallas=True, pallas_interpret=True))(
            jnp.asarray(x))
        got = TL.transformer_block(tp, _t(x), 2, None, 1e-12)
    finally:
        monkeypatch.delenv("MSCLIP_INT8_MIN_SEQ")
        tuning.get_tuning.cache_clear()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    assert bool(fused_calls) == fused
    assert TL.int8_min_seq() == TL.INT8_MIN_SEQ == 96



def _tiny_b16_config():
    """Tiny MS-CLIP-S with B/16's strides (stem, branch, adapters) at
    160 px: a grid of 10, so the image tower runs at L = 101 >= 96 and
    takes the fused form in the port; the text tower runs at 77."""
    cfg = tiny_msclips_config(image_size=160)
    cfg.merge_from_dict({"CUSTOM": {
        "EARLY_CONV_RES_STRIDES": [2, 2, 2, 1],
        "PARALLEL_STRIDES": [2, 2, 2, 2, 1],
        "PRALLEL_T2B_KERNELS": [8, 4, 2, 1, 1],
        "PRALLEL_T2B_STRIDES": [8, 4, 2, 1, 1]}})
    return cfg


def _inputs(image, vocab=512, batch=2):
    rng = np.random.default_rng(42)
    images = rng.standard_normal((batch, image, image, 3)).astype(np.float32)
    tokens = np.zeros((batch, 77), dtype=np.int32)
    for i in range(batch):
        n = int(rng.integers(5, 20))
        tokens[i, 0] = vocab - 2
        tokens[i, 1:n] = rng.integers(1, vocab - 2, n - 1)
        tokens[i, n] = vocab - 1
    return images, tokens


@pytest.fixture(scope="module")
def tiny_int8():
    """The tiny model quantized by the JAX package and folded there (the
    eval order, fold then quantize, gives the same tensors: folding touches
    no trunk block), and the same int8 tensors carried across to the port,
    folded there."""
    cfg = _tiny_b16_config()
    jm = jax_build_model(cfg)
    jp = random_jax_params(jm, seed=0)
    jq = jax.jit(lambda p: jax_quantize_params(p, jm.spec))(jp)
    spec = TM.spec_from_config(cfg)
    assert spec.vision_seq_len == jm.spec.vision_seq_len == 101
    tp = params_from_jax(jax.tree.map(np.asarray, jq), spec)
    return (jm, jax.jit(lambda p: jax_fold(p, jm.spec))(jq), spec,
            fold_params_for_eval(tp, spec))


def _nudged(tree, path, scale):
    """``tree`` with the leaf at ``path`` scaled by ``scale``."""
    if not path:
        return tree * scale
    return {**tree, path[0]: _nudged(tree[path[0]], path[1:], scale)}


def test_int8_towers_match_jax(tiny_int8, monkeypatch):
    """Whole towers on the same int8 tensors. A quantized value next to a
    tie moves by one step when its input moves by one ulp (the order of a
    LayerNorm or attention sum, the stem's convs), and the blocks after it
    carry that on: nudging JAX's own input by 2^-22 of itself moves its
    int8 features by as much as the port differs from it (about 4e-3 on
    unit-norm features here, against 1e-4 in fp32). So each tower is held
    within 4x how far the larger of two nudges (+-2^-22: the images, or the
    token embedding for the text tower) moves JAX's features, and every
    trunk block is shown to run its GEMMs in int8: the fused form in the
    image tower (L = 101), the unfused one in the text tower (L = 77). The
    blocks themselves are held to 2e-5 above."""
    jm, jq, spec, tp = tiny_int8
    images, tokens = _inputs(160)
    calls, fused, real_mm, real_block = [], [], TL._int_mm, TL.int8_block
    monkeypatch.setattr(TL, "_int_mm", lambda *a: calls.append(1) or
                        real_mm(*a))
    monkeypatch.setattr(TL, "int8_block", lambda *a: fused.append(1) or
                        real_block(*a))
    n_vis = spec.effective_vision_layers - spec.first_block
    for encode, port_encode, x, path in (
            (jm.encode_image, TM.encode_image, images, None),
            (jm.encode_text, TM.encode_text, tokens,
             ("text", "token_embedding"))):
        fn = jax.jit(encode)
        want = np.asarray(fn(jq, jnp.asarray(x)))
        noise = max(np.abs(np.asarray(
            fn(jq, jnp.asarray(x * (1 + d))) if path is None else
            fn(_nudged(jq, path, 1 + d), jnp.asarray(x))) - want).max()
            for d in (2.0 ** -22, -2.0 ** -22))
        calls.clear()
        got = port_encode(tp, spec, torch.from_numpy(x)).numpy()
        n_blocks = n_vis if path is None else spec.text_layers
        assert len(calls) == 4 * n_blocks
        np.testing.assert_allclose(got, want, atol=max(4 * noise, 1e-4))
    assert len(fused) == n_vis


def test_quantize_params_matches_jax_and_carries_across(tiny_int8):
    """The port's quantization of the carried-across fp32 weights equals
    JAX's int8 tree carried across: the same keys and the same tensors."""
    jm, _, spec, _ = tiny_int8
    jp = jax.tree.map(np.asarray, random_jax_params(jm, seed=0))
    mine = quantize_params_for_eval(params_from_jax(jp, spec), spec)
    theirs = params_from_jax(jax.tree.map(np.asarray, jax_quantize_params(
        jp, jm.spec)), spec)
    assert set(mine) == set(theirs)
    n_int8 = sum(v.dtype == torch.int8 for v in mine.values())
    # 4 GEMMs in each of the 11 trunk blocks and in text block 0, the one
    # text block that shares nothing (N_LAYERS 1)
    assert n_int8 == 4 * (spec.effective_vision_layers - 1 + 1)
    for k in mine:
        torch.testing.assert_close(mine[k], theirs[k], atol=0, rtol=0)


def test_shared_text_block_resolves_the_trunk_int8_tensors(tiny_int8):
    _, _, spec, tp = tiny_int8
    blk = TM.resolve_text_block(tp, spec, 3)
    vis = "visual.transformer.resblocks.3"
    for name in ("mlp.c_fc.weight", "attn.in_proj_weight"):
        for suffix in ("_int8", "_scale"):
            assert blk[name + suffix] is tp[f"{vis}.{name}{suffix}"]
        assert name not in blk
    assert blk["ln_1.weight"] is tp["transformer.resblocks.3.ln_1.weight"]
    own = TM.resolve_text_block(tp, spec, 0)
    assert own["attn.in_proj_weight_int8"] is \
        tp["transformer.resblocks.0.attn.in_proj_weight_int8"]
    assert set(own) == set(blk)


def test_cast_params_leaves_int8_weights_and_scales(tiny_int8):
    _, _, _, tp = tiny_int8
    cast = TM.cast_params(tp, torch.bfloat16)
    for k, v in cast.items():
        if k.endswith("_int8"):
            want = torch.int8
        elif k.endswith(("weight_scale", "running_mean", "running_var")):
            want = torch.float32
        else:
            want = torch.bfloat16
        assert v.dtype == want, k
    assert cast["logit_scale"].dtype == torch.bfloat16


def test_int8_with_fused_blocks_is_refused():
    cfg = get_default_config()
    update_config(cfg, os.path.join(REPO, "experiments", "model",
                                    "b16-yfcc-msclips.yaml"),
                  opts=["TPU.INT8_EVAL", True, "TPU.USE_FUSED_BLOCK", True])
    with pytest.raises(ValueError, match="mutually exclusive"):
        TM.spec_from_config(cfg)


def test_resolved_b16_json_config_equals_yaml():
    """The resolved JSON copy of the B/16 config (read without PyYAML)
    merges to the same tree as the YAML with its BASE, and runs the image
    tower at L = 197."""
    a, b = get_default_config(), get_default_config()
    update_config(a, os.path.join(REPO, "experiments", "model",
                                  "b16-yfcc-msclips.yaml"))
    update_config(b, os.path.join(REPO, "msclip_torch", "config",
                                  "b16-yfcc-msclips.json"))
    assert a.to_dict() == b.to_dict()
    assert TM.spec_from_config(b).vision_seq_len == 197


# MS-CLIP-S B/32's geometry cut to width 128 and 6 layers at 320 px: a grid
# of 10, so the port's image tower takes the fused int8 form (L = 101)
CLI_OPTS = [
    "TRAIN.IMAGE_SIZE", "[320,320]", "TEST.IMAGE_SIZE", "[320,320]",
    "TEST.BATCH_SIZE_PER_GPU", "4", "TEST.SUBSET_CLASSES", "10",
    "MODEL.SPEC.VISION.WIDTH", "128", "MODEL.SPEC.VISION.LAYERS", "6",
    "MODEL.SPEC.TEXT.WIDTH", "128", "MODEL.SPEC.TEXT.HEADS", "2",
    "MODEL.SPEC.TEXT.LAYERS", "6", "MODEL.SPEC.EMBED_DIM", "32",
    "WORKERS", "2", "TPU.INT8_EVAL", "True",
]


def test_int8_cli_matches_jax_cli_per_image(tmp_path):
    """``--device cpu ... TPU.INT8_EVAL True``: the same per-image top-1 as
    the JAX CLI on the same JPEG folder and the same exported weights."""
    from PIL import Image

    from msclip_tpu.config import get_default_config as jax_default_config
    from msclip_tpu.config import update_config as jax_update_config

    model_yaml = os.path.join(REPO, "experiments", "model",
                              "b32-yfcc-msclips.yaml")
    root = tmp_path / "val"
    rng = np.random.default_rng(0)
    for cls in ("n01440764", "n01443537"):
        (root / cls).mkdir(parents=True)
        for i in range(3):
            arr = np.kron(rng.random((4, 5, 3)), np.ones((20, 20, 1)))
            Image.fromarray((arr * 255).astype(np.uint8)).save(
                root / cls / f"{cls}_{i}.JPEG")
    cfg = jax_default_config()
    jax_update_config(cfg, model_yaml, opts=CLI_OPTS)
    jm = jax_build_model(cfg)
    sd = export_torch_state_dict(random_jax_params(jm, seed=0), jm.spec)
    ckpt = tmp_path / "model.pth"
    torch.save({k: torch.tensor(np.array(v)) for k, v in sd.items()}, ckpt)
    common = ["--ds", os.path.join(REPO, "experiments", "dataset",
                                   "imagenet.yaml"),
              "--model", model_yaml, "MODEL.PRETRAINED_MODEL", str(ckpt),
              "DATASET.ROOT", str(tmp_path), "DATASET.TEST_SET", "val"]
    common += CLI_OPTS
    env = dict(os.environ, MSCLIP_PLATFORM="cpu")
    cmds = ([sys.executable, "tools/zero_shot.py"] + common + [
        "OUTPUT_DIR", str(tmp_path / "out"),
        "TEST.SAVE_PRED", str(tmp_path / "jax.npz")],
        [sys.executable, "-m", "msclip_torch.tools.zero_shot",
         "--device", "cpu"] + common + [
        "TEST.SAVE_PRED", str(tmp_path / "port.npz")])
    procs = [subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for cmd in cmds]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert "RESULT imagenet accuracy=" in out
    jax_res, port_res = (np.load(tmp_path / f"{n}.npz")
                         for n in ("jax", "port"))
    np.testing.assert_array_equal(port_res["label"], jax_res["label"])
    np.testing.assert_array_equal(port_res["pred"], jax_res["pred"])
    assert len(set(port_res["pred"].tolist())) > 1  # not a constant guess

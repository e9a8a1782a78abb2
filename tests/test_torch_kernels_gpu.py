"""The port's CUDA kernels (K1 attention forward, K2 attention backward, K3
and K4 the int8 quantizers, K5 and K6 the fused half-blocks, E1 and E2 the
half-block tuning kernels) against their plain versions, on the card; K4
bit for bit, on every bf16 bit pattern too. Serving's CUDA graphs (one a
tower and bucket, K1 or K5 inside) against eager calls, bit for bit.

JAX-free, so that it runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Without a CUDA device every test skips (decided inside the fixture).
"""

import numpy as np
import pytest
import torch

from msclip_torch.models.layers import build_causal_mask
from msclip_torch.ops import attention as A
from msclip_torch.ops import block_fused as BF
from msclip_torch.ops import halfblock_tuning as HT
from msclip_torch.ops import quant as Q

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# K1 in bf16 also holds mean |got - plain| <= 2^-10 mean |plain|
# (chip_smoke.py FWD_MEAN_TOL): weights left unrounded before P V read
# above it
FWD_MEAN_TOL = 2.0 ** -10
BWD_TOL = {torch.float32: (2e-4, 1e-4), torch.bfloat16: (1e-2, 2e-2)}
# K2 in bf16 also holds mean |got - plain| <= 2^-10 mean |plain| for each
# of dQ, dK and dV (chip_smoke.py BWD_MEAN_TOL): a rounding point of W or
# dS moved or dropped reads above it, sums in another order far below
BWD_MEAN_TOL = 2.0 ** -10
# every padding bucket of K1/K2 (64, 80, 128, 208, 256) at, below and
# above its edge, and the towers' lengths
LENGTHS = [1, 16, 17, 49, 50, 63, 64, 65, 77, 80, 81, 128, 129, 197, 208,
           209, 256]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,causal", [(256, 50, False), (64, 77, True),
                                        (8, 197, False), (5, 77, True)])
def test_attention_kernel_matches_plain(cuda, dtype, B, L, causal):
    gen = torch.Generator(device=cuda).manual_seed(L)
    qkv = torch.randn(B, L, 3 * 768, device=cuda, generator=gen).to(dtype)
    mask = build_causal_mask(L, device=cuda) if causal else None
    before = A.fused_attention_qkv.launches
    got = A.fused_attention_qkv(qkv, 12, mask)
    torch.cuda.synchronize()
    assert A.fused_attention_qkv.launches == before + 1
    want = A.attention_qkv_plain(qkv, 12, mask)
    assert got.shape == (B, L, 768)
    _assert_fwd_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,H", [(768, 12), (256, 4)])
@pytest.mark.parametrize("L", [1, 17, 64, 65, 129, 256])
def test_attention_kernel_edge_lengths(cuda, dtype, E, H, L):
    """Lengths at and around the kernels' padding buckets, causal."""
    gen = torch.Generator(device=cuda).manual_seed(L)
    qkv = torch.randn(3, L, 3 * E, device=cuda, generator=gen).to(dtype)
    mask = build_causal_mask(L, device=cuda)
    got = A.fused_attention_qkv(qkv, H, mask)
    torch.cuda.synchronize()
    _assert_fwd_close(got, A.attention_qkv_plain(qkv, H, mask), dtype)


def _assert_fwd_close(got, want, dtype):
    """K1's elementwise limit, and in bf16 its mean limit."""
    assert got.dtype == dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    assert diff.max().item() <= TOL[dtype]
    if dtype == torch.bfloat16:
        assert diff.mean() <= FWD_MEAN_TOL * want.float().abs().mean()


def _mask(L, kind, cuda):
    """Additive fp32 masks with a finite score in every row: causal; a
    random -inf pattern over finite values; keys 16-31 masked on every row;
    the trailing 16-key tile masked on every row (past key 0 where L <=
    16)."""
    if kind == "causal":
        return build_causal_mask(L, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(L)
    m = torch.zeros(L, L, device=cuda)
    if kind == "random":
        off = torch.rand(L, L, device=cuda, generator=gen) < 0.5
        off[torch.arange(L, device=cuda),
            torch.randint(0, L, (L,), device=cuda, generator=gen)] = False
        m = torch.where(off, -torch.inf,
                        0.5 * torch.randn(L, L, device=cuda, generator=gen))
    elif kind == "band":
        m[:, 16:32] = -torch.inf
    else:
        m[:, max(1, 16 * ((L - 1) // 16)):] = -torch.inf
    assert torch.isfinite(m).any(dim=1).all()
    return m.contiguous()


def _assert_bwd_close(got, want, dtype):
    """K2's elementwise limit, and in bf16 its mean limit per gradient."""
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    atol, rtol = BWD_TOL[dtype]
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    assert (diff <= atol + rtol * want.abs()).all(), diff.max().item()
    if dtype == torch.bfloat16:
        E = got.shape[-1] // 3
        for i in range(3):
            part = slice(i * E, (i + 1) * E)
            assert diff[..., part].mean() <= \
                BWD_MEAN_TOL * want[..., part].abs().mean(), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["causal", "random", "band", "trailing"])
@pytest.mark.parametrize("L", LENGTHS)
def test_attention_kernels_masks_and_lengths(cuda, dtype, kind, L):
    """K1 and K2 under each mask the staging of the mask in shared memory
    must carry, at every padding bucket, odd batch."""
    gen = torch.Generator(device=cuda).manual_seed(L + 1)
    qkv = torch.randn(3, L, 3 * 768, device=cuda, generator=gen).to(dtype)
    g = torch.randn(3, L, 768, device=cuda, generator=gen).to(dtype)
    mask = _mask(L, kind, cuda)
    before = (A.fused_attention_qkv.launches,
              A.fused_attention_qkv_bwd.launches)
    got = A.fused_attention_qkv(qkv, 12, mask)
    got_bwd = A.fused_attention_qkv_bwd(qkv, g, 12, mask)
    torch.cuda.synchronize()
    assert (A.fused_attention_qkv.launches,
            A.fused_attention_qkv_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    _assert_fwd_close(got, A.attention_qkv_plain(qkv, 12, mask), dtype)
    _assert_bwd_close(got_bwd, A.attention_qkv_bwd_plain(qkv, g, 12, mask),
                      dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 5, 45])
@pytest.mark.parametrize("L,kind", [(50, None), (77, "causal"),
                                    (197, None), (64, "random")])
def test_attention_kernels_walk_units(cuda, dtype, B, L, kind):
    """Odd batches, and B = 45: 540 (sample, head) units, more than the
    persistent grid holds at any bucket (132 SMs, at most 4 blocks each),
    so a block walks several units through its ring."""
    gen = torch.Generator(device=cuda).manual_seed(B * L)
    qkv = torch.randn(B, L, 3 * 768, device=cuda, generator=gen).to(dtype)
    g = torch.randn(B, L, 768, device=cuda, generator=gen).to(dtype)
    mask = None if kind is None else _mask(L, kind, cuda)
    got = A.fused_attention_qkv(qkv, 12, mask)
    got_bwd = A.fused_attention_qkv_bwd(qkv, g, 12, mask)
    torch.cuda.synchronize()
    _assert_fwd_close(got, A.attention_qkv_plain(qkv, 12, mask), dtype)
    _assert_bwd_close(got_bwd, A.attention_qkv_bwd_plain(qkv, g, 12, mask),
                      dtype)


def test_attention_kernel_refuses_a_bad_mask(cuda):
    qkv = torch.zeros(2, 77, 3 * 768, device=cuda)
    with pytest.raises(ValueError):
        A.fused_attention_qkv(qkv, 12, build_causal_mask(77))  # CPU mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("E,H", [(768, 12), (256, 4)])
@pytest.mark.parametrize("L", [1, 17, 64, 65, 129, 256])
def test_attention_bwd_kernel_edge_lengths(cuda, dtype, causal, E, H, L):
    """K2 against its plain version at and around the padding buckets,
    elementwise and, in bf16, by the mean of each gradient. fp32 is held to
    the JAX package's grad-test tolerance (atol 2e-4, rtol 1e-4); bf16 to
    atol 1e-2, rtol 2e-2, room for one bf16 ulp of the output (2^-7
    relative at most) where the kernel and the plain version, summing in
    another order, round to neighbours, and to mean |got - plain| <=
    2^-10 mean |plain| for each of dQ, dK and dV."""
    gen = torch.Generator(device=cuda).manual_seed(L)
    qkv = torch.randn(3, L, 3 * E, device=cuda, generator=gen).to(dtype)
    g = torch.randn(3, L, E, device=cuda, generator=gen).to(dtype)
    mask = build_causal_mask(L, device=cuda) if causal else None
    before = A.fused_attention_qkv_bwd.launches
    got = A.fused_attention_qkv_bwd(qkv, g, H, mask)
    torch.cuda.synchronize()
    assert A.fused_attention_qkv_bwd.launches == before + 1
    _assert_bwd_close(got, A.attention_qkv_bwd_plain(qkv, g, H, mask), dtype)


# b32.yaml's and RN50's text tower (E = 512, 8 heads of 64, L = 77 causal)
# and a 512-wide tower at the image length without a mask
ZOO_SHAPES = [(256, 77, True), (1024, 77, True), (5, 77, True),
              (256, 50, False), (7, 50, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,causal", ZOO_SHAPES)
def test_attention_kernels_at_e512(cuda, dtype, B, L, causal):
    """K1 and K2 at E = 512, H = 8 against their plain versions, to the
    limits of the E = 768 tests (elementwise, and by the mean in bf16)."""
    gen = torch.Generator(device=cuda).manual_seed(B + L)
    qkv = torch.randn(B, L, 3 * 512, device=cuda, generator=gen).to(dtype)
    g = torch.randn(B, L, 512, device=cuda, generator=gen).to(dtype)
    mask = build_causal_mask(L, device=cuda) if causal else None
    before = (A.fused_attention_qkv.launches,
              A.fused_attention_qkv_bwd.launches)
    got = A.fused_attention_qkv(qkv, 8, mask)
    dqkv = A.fused_attention_qkv_bwd(qkv, g, 8, mask)
    torch.cuda.synchronize()
    assert (A.fused_attention_qkv.launches,
            A.fused_attention_qkv_bwd.launches) == (before[0] + 1,
                                                    before[1] + 1)
    assert got.shape == (B, L, 512) and dqkv.shape == qkv.shape
    _assert_fwd_close(got, A.attention_qkv_plain(qkv, 8, mask), dtype)
    _assert_bwd_close(dqkv, A.attention_qkv_bwd_plain(qkv, g, 8, mask), dtype)


def test_attention_autograd_round_trip_on_the_card(cuda):
    """Gradients through FusedAttentionQKV on the card (K1 forward, K2
    backward) against torch autograd of the plain forward."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    B, L, E, H = 4, 77, 768, 12
    x = torch.randn(B, L, 3 * E, device=cuda, generator=gen)
    g = torch.randn(B, L, E, device=cuda, generator=gen)
    mask = build_causal_mask(L, device=cuda)
    grads, launches = [], []
    for fn in (A.fused_attention_qkv, A.attention_qkv_plain):
        qkv = x.clone().requires_grad_(True)
        before = (A.fused_attention_qkv.launches,
                  A.fused_attention_qkv_bwd.launches)
        (fn(qkv, H, mask) * g).sum().backward()
        torch.cuda.synchronize()
        grads.append(qkv.grad)
        launches.append((A.fused_attention_qkv.launches - before[0],
                         A.fused_attention_qkv_bwd.launches - before[1]))
    assert launches == [(1, 1), (0, 0)]
    diff = (grads[0] - grads[1]).abs()
    assert (diff <= 2e-4 + 1e-4 * grads[1].abs()).all(), diff.max().item()


# K3/K4: q within 1 of the plain version's where the LayerNorm sums in
# another order; per row |s - s_plain| <= 1e-6 s_plain in fp32 and one bf16
# ulp of the row's largest |h| (2^-7 relative) in bf16; q * s within one
# quantization step of the plain dequant: the step of the larger scale
# (each rounds h to its own grid, half a step either way), plus what the
# two scales' difference moves the largest value, 127 |s - s_plain|
S_RTOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}
TIES = (127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5)


def _assert_quant_close(got, want, dtype):
    (q, s), (qp, sp) = got, want
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == qp.shape and s.shape == sp.shape
    assert (q.int() - qp.int()).abs().max().item() <= 1
    assert ((s - sp).abs() <= S_RTOL[dtype] * sp).all()
    # in fp64, where q s is exact: one step reads exactly one step
    q, s, qp, sp = q.double(), s.double(), qp.double(), sp.double()
    deq = (q * s[..., None] - qp * sp[..., None]).abs()
    step = torch.maximum(s, sp) + 127 * (s - sp).abs()
    assert (deq <= step[..., None]).all()


def _ln_inputs(B, L, E, dtype, gen, cuda):
    x = torch.randn(B, L, E, device=cuda, generator=gen).to(dtype)
    w = 1 + 0.1 * torch.randn(E, device=cuda, generator=gen)
    b = 0.1 * torch.randn(E, device=cuda, generator=gen)
    return x, w.to(dtype), b.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E", [64, 768, 3072])
@pytest.mark.parametrize("L", [1, 17, 96, 197, 256])
def test_quant_kernels_match_plain(cuda, dtype, E, L):
    gen = torch.Generator(device=cuda).manual_seed(L + E)
    x, w, b = _ln_inputs(3, L, E, dtype, gen, cuda)
    before = (Q.ln_quant.launches, Q.gelu_quant.launches)
    got_ln, got_gelu = Q.ln_quant(x, w, b), Q.gelu_quant(x)
    torch.cuda.synchronize()
    assert (Q.ln_quant.launches, Q.gelu_quant.launches) == \
        (before[0] + 1, before[1] + 1)
    _assert_quant_close(got_ln, Q.ln_quant_plain(x, w, b), dtype)
    _assert_quant_close(got_gelu, Q.gelu_quant_plain(x), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E", [64, 768, 3072])
def test_quant_kernels_edge_rows(cuda, dtype, E):
    """Constant rows give h = bias exactly: with the ties as bias, s = 1
    and q rounds half to even; zero rows with a zero bias (K3) or zero
    input (K4) give s = 1e-8 and q = 0. K3's rows whose LayerNorm or
    affine is not finite (``chip_smoke.ln_quant_nonfinite_rows``: an inf, a
    NaN, a -inf, w n + b overflowing to inf, a scale near the largest)
    equal the plain version's bit for bit: q equal, s equal or both NaN."""
    import chip_smoke

    ties = torch.tensor(TIES, device=cuda).repeat(E // len(TIES) + 1)[:E]
    x = torch.tensor([0.0, 1.0, -3.0, 0.5, 1024.0], device=cuda)[:, None]
    x = x.expand(5, E).contiguous().to(dtype)
    w = torch.linspace(-2, 2, E, device=cuda).to(dtype)
    q, s = Q.ln_quant(x, w, ties.to(dtype))
    want = torch.round(ties).to(torch.int8)
    assert (q == want).all() and (s == 1.0).all()
    assert want[:7].tolist() == [127, 0, 2, 2, 0, -2, -2]
    q, s = Q.ln_quant(x, w, torch.zeros_like(w))
    assert (q == 0).all() and (s == 1e-8).all()
    q, s = Q.gelu_quant(torch.zeros(4, E, device=cuda, dtype=dtype))
    assert (q == 0).all() and (s == torch.tensor(1e-8)).all()
    x, w, b = chip_smoke.ln_quant_nonfinite_rows(E, dtype, cuda)
    _assert_bitwise(Q.ln_quant(x, w, b), Q.ln_quant_plain(x, w, b))


def _assert_bitwise(got, want):
    """q and s of a quantizer against its plain version's, bit for bit
    (any NaN scale equal to any NaN)."""
    torch.cuda.synchronize()
    (q, s), (qp, sp) = got, want
    assert q.dtype == torch.int8 and q.shape == qp.shape
    s_same = (s.view(torch.int32) == sp.view(torch.int32)) \
        | (torch.isnan(s) & torch.isnan(sp))
    q_same = (q == qp).all(dim=-1)
    bad = ~(s_same & q_same)
    assert not bad.any(), (
        f"{int(bad.sum())} rows differ: s {s[bad][:8].tolist()} against "
        f"{sp[bad][:8].tolist()}, q differing in "
        f"{(q != qp).sum(dim=-1)[bad][:8].tolist()} elements, q "
        f"{q[bad][:8, :4].tolist()} against {qp[bad][:8, :4].tolist()}")


def _gelu_quant_bitwise(x):
    """K4's q and s against ``gelu_quant_plain``'s, bit for bit."""
    _assert_bitwise(Q.gelu_quant(x), Q.gelu_quant_plain(x))


def test_gelu_quant_kernel_every_bf16_pattern(cuda):
    """All 65,536 bf16 bit patterns, one a row of 3072 with planted row
    maxima (``chip_smoke.every_bf16_rows``): K4 equals its plain version
    bit for bit, NaN and infinite rows included."""
    import chip_smoke

    x = chip_smoke.every_bf16_rows(3072, cuda)
    assert x.shape == (1 << 16, 3072)
    _gelu_quant_bitwise(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,E", [(256, 197, 3072), (3, 17, 3072),
                                   (5, 77, 64), (1, 1, 4096), (2, 3, 1032)])
def test_gelu_quant_kernel_equals_plain_bitwise(cuda, dtype, B, L, E):
    """K4's q and s equal the plain version's bit for bit at the B/16 int8
    shape and at widths that leave threads without a chunk, on random
    rows and on rows with an exact GELU maximum, ties, zeros and an
    outlier."""
    gen = torch.Generator(device=cuda).manual_seed(B + L + E)
    x = 2 * torch.randn(B, L, E, device=cuda, generator=gen)
    _gelu_quant_bitwise(x.to(dtype))
    ties = torch.tensor([254.0, 61.0, 63.0, 65.0, 67.0, 0.0, -61.0],
                        device=cuda).repeat(E // 7 + 1)[:E]
    rows = torch.stack([ties, torch.zeros(E, device=cuda),
                        torch.zeros(E, device=cuda).index_fill(0, torch.tensor(
                            [E // 2], device=cuda), 100.0)])
    _gelu_quant_bitwise(rows.to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gelu_quant_kernel_wide_rows(cuda, dtype):
    """Rows holding what K4's main sequence does not take (e overflowing
    below x = -52.1, 1 / (1 + e) below 2^-126 down to x = -51.3, +-inf,
    NaN), among ordinary values: the block recomputes the row exactly, and
    q and s equal the plain version's bit for bit; the other rows are
    untouched by it."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(8, 3072, device=cuda, generator=gen)
    x[0, 5] = -53.0
    x[1, 7] = -51.75
    x[2, 9] = float("inf")
    x[3, 11] = float("-inf")
    x[4, 13] = float("nan")
    x[5, 100:200] = torch.linspace(-52.5, -51.0, 100, device=cuda)
    _gelu_quant_bitwise(x.to(dtype))


def test_quant_kernels_refuse_bad_inputs(cuda):
    x = torch.randn(2, 8, 772, device=cuda)
    w = torch.ones(772, device=cuda)
    with pytest.raises(ValueError, match="E % 8"):
        Q.ln_quant(x, w, w)
    with pytest.raises(ValueError, match="contiguous"):
        Q.gelu_quant(torch.randn(2, 8, 776, device=cuda)[..., 8:])
    with pytest.raises(TypeError):
        Q.gelu_quant(torch.randn(2, 8, 768, device=cuda).half())
    with pytest.raises(ValueError, match="weight and bias"):
        Q.ln_quant(torch.randn(2, 8, 768, device=cuda), w, w)


# K5/K6, elementwise |got - plain| <= atol + rtol max(|plain|, |plain - x|):
# fp32 at the JAX package's block tolerance (tests/test_kernels.py); bf16
# with room for a few bf16 ulps (2^-7 relative at most each) of the
# residual branch, plain - x, where the kernel and the plain version,
# summing in another order, round it to neighbours (where the branch
# cancels x, one ulp of the branch is many ulps of the result)
HALF_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (1e-2, 2e-2)}


def _block(E, gen, cuda):
    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=cuda, generator=gen)

    return {"ln_1.weight": 1 + r(E, scale=0.1), "ln_1.bias": r(E, scale=0.1),
            "ln_2.weight": 1 + r(E, scale=0.1), "ln_2.bias": r(E, scale=0.1),
            "attn.in_proj_weight": r(3 * E, E, scale=E ** -0.5),
            "attn.in_proj_bias": r(3 * E, scale=0.1),
            "attn.out_proj.weight": r(E, E, scale=E ** -0.5),
            "attn.out_proj.bias": r(E, scale=0.1),
            "mlp.c_fc.weight": r(4 * E, E, scale=E ** -0.5),
            "mlp.c_fc.bias": r(4 * E, scale=0.1),
            "mlp.c_proj.weight": r(E, 4 * E, scale=(4 * E) ** -0.5),
            "mlp.c_proj.bias": r(E, scale=0.1)}


def _assert_half_close(got, want, x, dtype):
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    atol, rtol = HALF_TOL[dtype]
    want = want.float()
    scale = torch.maximum(want.abs(), (want - x.float()).abs())
    diff = (got.float() - want).abs()
    assert (diff <= atol + rtol * scale).all(), diff.max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", [1, 17, 50, 64, 65, 77, 80, 81, 128, 129, 197,
                               208, 209, 256])
def test_attention_halfblock_kernel_matches_plain(cuda, dtype, causal, L):
    """K5 at every padding bucket of its attention, odd batch (fp32: every
    split of its GEMM rows into passes of 64, 80 and 128; bf16: one or two
    m-tiles a warpgroup)."""
    gen = torch.Generator(device=cuda).manual_seed(L)
    p = {k: v.to(dtype) for k, v in _block(768, gen, cuda).items()}
    x = torch.randn(3, L, 768, device=cuda, generator=gen).to(dtype)
    mask = build_causal_mask(L, device=cuda) if causal else None
    before = BF.fused_attention_halfblock.launches
    got = BF.fused_attention_halfblock(x, p, 12, mask)
    torch.cuda.synchronize()
    assert BF.fused_attention_halfblock.launches == before + 1
    _assert_half_close(got, BF.attention_halfblock_plain(x, p, 12, mask), x,
                       dtype)


# lengths at which a bf16 group of K5 holds 8, 5, 5, 4, 3, 3, 3, 2, 2, 1,
# 1 and 1 samples (block_fused.max_group: 256 GEMM rows, 512 padded
# attention rows)
GROUP_LENGTHS = [1, 50, 51, 64, 65, 77, 85, 86, 128, 129, 197, 256]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", GROUP_LENGTHS)
@pytest.mark.parametrize("fill", ["full", "below_sms"])
def test_attention_halfblock_kernel_groups(cuda, dtype, causal, L, fill):
    """K5 at batches that fill its groups: ``full`` takes K5's largest
    group on this card and leaves the last group one sample short;
    ``below_sms`` is a batch of one sample fewer than the card's SMs (one
    sample a group)."""
    sms = BF.sm_count(cuda)
    most = BF.max_group(L, dtype)
    B = sms * most - 1 if fill == "full" else sms - 1
    plan = BF.attn_plan(B, L, dtype, sms)
    if dtype == torch.bfloat16:
        assert plan["S"] == (most if fill == "full" else 1)
    gen = torch.Generator(device=cuda).manual_seed(L + B)
    p = {k: v.to(dtype) for k, v in _block(768, gen, cuda).items()}
    x = torch.randn(B, L, 768, device=cuda, generator=gen).to(dtype)
    mask = build_causal_mask(L, device=cuda) if causal else None
    got = BF.fused_attention_halfblock(x, p, 12, mask)
    torch.cuda.synchronize()
    want = BF.attention_halfblock_plain(x, p, 12, mask)
    _assert_half_close(got, want, x, dtype)
    if dtype == torch.bfloat16:
        mean = (got.float() - want.float()).abs().mean().item()
        branch = (want.float() - x.float()).abs().mean().item()
        assert mean <= 2.0 ** -10 * branch, (mean, branch)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L", [(1, 1), (3, 17), (5, 50), (3, 77), (2, 197)])
def test_mlp_halfblock_kernel_matches_plain(cuda, dtype, B, L):
    """K6 over token counts that fill and leave ragged its row groups (fp32:
    tiles of 32; bf16: one or two m-tiles of 64 a warpgroup)."""
    gen = torch.Generator(device=cuda).manual_seed(B * L)
    p = {k: v.to(dtype) for k, v in _block(768, gen, cuda).items()}
    x = torch.randn(B, L, 768, device=cuda, generator=gen).to(dtype)
    before = BF.fused_mlp_halfblock.launches
    got = BF.fused_mlp_halfblock(x, p)
    torch.cuda.synchronize()
    assert BF.fused_mlp_halfblock.launches == before + 1
    _assert_half_close(got, BF.mlp_halfblock_plain(x, p), x, dtype)


@pytest.mark.parametrize("fill", ["one_round_of_big", "big_and_small",
                                  "below_sms", "one_small_each"])
def test_mlp_halfblock_kernel_groups(cuda, fill):
    """bf16 K6 at the edges of its plan on this card (``mlp_plan``): one
    round of 256-row groups exactly, a round of them and a ragged round of
    128-row groups, fewer 128-row groups than SMs, and one 128-row group a
    block; elementwise and at the mean limit."""
    sms = BF.sm_count(cuda)
    rows = {"one_round_of_big": 256 * sms, "big_and_small": 256 * sms + 129,
            "below_sms": 128 * (sms - 3) - 5, "one_small_each": 128 * sms}[fill]
    plan = BF.mlp_plan(rows, torch.bfloat16, sms)
    assert (plan["big"] > 0) == fill.startswith(("one_round", "big"))
    gen = torch.Generator(device=cuda).manual_seed(rows)
    p = {k: v.to(torch.bfloat16) for k, v in _block(768, gen, cuda).items()}
    x = torch.randn(rows, 1, 768, device=cuda, generator=gen).to(torch.bfloat16)
    got = BF.fused_mlp_halfblock(x, p)
    torch.cuda.synchronize()
    want = BF.mlp_halfblock_plain(x, p)
    _assert_half_close(got, want, x, torch.bfloat16)
    mean = (got.float() - want.float()).abs().mean().item()
    branch = (want.float() - x.float()).abs().mean().item()
    assert mean <= 2.0 ** -10 * branch, (mean, branch)


def test_halfblock_kernels_refuse_bad_inputs(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = _block(768, gen, cuda)
    x = torch.randn(2, 50, 768, device=cuda, generator=gen)
    with pytest.raises(ValueError, match="x \\[B, L, 768\\]"):
        BF.fused_attention_halfblock(torch.randn(2, 50, 512, device=cuda),
                                     _block(512, gen, cuda), 8)
    with pytest.raises(ValueError, match="heads of width 64"):
        BF.fused_attention_halfblock(x, p, 8)  # D = 96
    with pytest.raises(ValueError, match="L <= 256"):
        BF.fused_attention_halfblock(torch.randn(1, 257, 768, device=cuda),
                                     p, 12)
    with pytest.raises(TypeError):
        BF.fused_mlp_halfblock(x.half(), p)
    with pytest.raises(ValueError, match="mask"):
        BF.fused_attention_halfblock(x, p, 12, build_causal_mask(50))
    with pytest.raises(ValueError, match="contiguous"):
        BF.fused_mlp_halfblock(x.transpose(0, 1), p)


# E1/E2: K5's elementwise limit, and in bf16 chip_smoke.py's mean limit,
# mean |got - plain| <= 2^-10 mean |plain - x|, which a rounding point
# moved or dropped (v1's against v2's) exceeds
HALF_MEAN_TOL = 2.0 ** -10
# every padding bucket of the attention tile (bf16 64, 80, 128, 208, 256;
# fp32 keys per lane 2, 4, 8) and GEMM passes of 64, 80 and 128 rows
TUNING_LENGTHS = [1, 17, 50, 65, 77, 129, 197, 256]
# (B, tb): an odd batch at one sample a block and at the default tile (K5's
# group cut to a divisor of B), the script's tile of 8, and a block whose
# last group is ragged (3 samples in groups of 2 at L = 50)
TUNING_TILES = [(3, 1), (3, None), (16, 8), (9, 3)]


def _assert_tuning_close(got, want, x, dtype):
    _assert_half_close(got, want, x, dtype)
    if dtype == torch.bfloat16:
        mean = (got.float() - want.float()).abs().mean().item()
        branch = (want.float() - x.float()).abs().mean().item()
        assert mean <= HALF_MEAN_TOL * branch, (mean, branch)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["v2", "v1", "v2c", "v2a"])
@pytest.mark.parametrize("L", TUNING_LENGTHS)
@pytest.mark.parametrize("B,tb", TUNING_TILES)
def test_halfblock_variant_kernel_matches_plain(cuda, dtype, variant, L, B,
                                                tb):
    """E1's four numeric variants (v0 and v3 launch v2's kernel)."""
    gen = torch.Generator(device=cuda).manual_seed(L + B)
    p = {k: v.to(dtype) for k, v in _block(768, gen, cuda).items()}
    x = torch.randn(B, L, 768, device=cuda, generator=gen).to(dtype)
    before = HT.attention_halfblock_variant.launches
    got = HT.attention_halfblock_variant(x, p, variant, tb)
    torch.cuda.synchronize()
    assert HT.attention_halfblock_variant.launches == before + 1
    _assert_tuning_close(
        got, HT.attention_halfblock_variant_plain(x, p, variant), x, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["v2", "v1", "v2c", "v2a"])
@pytest.mark.parametrize("L", GROUP_LENGTHS)
@pytest.mark.parametrize("extra", [0, 1])
def test_halfblock_variant_kernel_groups(cuda, dtype, variant, L, extra):
    """E1 at blocks of K5's largest group (``extra`` 0) and of one sample
    more, whose last group holds one sample; two blocks."""
    tb = BF.max_group(L, dtype) + extra
    assert HT.tuning_group(L, tb, dtype) == tb - extra
    gen = torch.Generator(device=cuda).manual_seed(L + tb)
    p = {k: v.to(dtype) for k, v in _block(768, gen, cuda).items()}
    x = torch.randn(2 * tb, L, 768, device=cuda, generator=gen).to(dtype)
    got = HT.attention_halfblock_variant(x, p, variant, tb)
    torch.cuda.synchronize()
    _assert_tuning_close(
        got, HT.attention_halfblock_variant_plain(x, p, variant), x, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", TUNING_LENGTHS)
@pytest.mark.parametrize("B,tb", TUNING_TILES)
def test_core_out_kernel_matches_plain(cuda, dtype, L, B, tb):
    """E2 on the qkv of the hybrid's own LayerNorm and library GEMM."""
    gen = torch.Generator(device=cuda).manual_seed(L + B)
    p = {k: v.to(dtype) for k, v in _block(768, gen, cuda).items()}
    x = torch.randn(B, L, 768, device=cuda, generator=gen).to(dtype)
    h = BF.layer_norm(x, p["ln_1.weight"], p["ln_1.bias"])
    qkv = (h @ p["attn.in_proj_weight"].t() + p["attn.in_proj_bias"]) \
        .contiguous()
    before = HT.core_out_halfblock.launches
    got = HT.core_out_halfblock(x, qkv, p, tb)
    torch.cuda.synchronize()
    assert HT.core_out_halfblock.launches == before + 1
    _assert_tuning_close(got, HT.core_out_plain(x, qkv, p), x, dtype)


def _core_out_case(cuda, dtype, B, L, tb, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    p = {k: v.to(dtype) for k, v in _block(768, gen, cuda).items()}
    x = torch.randn(B, L, 768, device=cuda, generator=gen).to(dtype)
    h = BF.layer_norm(x, p["ln_1.weight"], p["ln_1.bias"])
    qkv = (h @ p["attn.in_proj_weight"].t() + p["attn.in_proj_bias"]) \
        .contiguous()
    got = HT.core_out_halfblock(x, qkv, p, tb)
    torch.cuda.synchronize()
    _assert_tuning_close(got, HT.core_out_plain(x, qkv, p), x, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", range(1, 257))
def test_core_out_kernel_every_length(cuda, dtype, L):
    """E2 at every L in 1..256 on an odd batch of 3 at the default tile (in
    bf16 K5's group cut to a divisor of 3: groups of 1 or 3 samples)."""
    _core_out_case(cuda, dtype, 3, L, None, L)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [50, 77, 197])
@pytest.mark.parametrize("tb", [8, 16, 32, None])
def test_core_out_kernel_script_tiles(cuda, dtype, L, tb):
    """E2 at the tool's batch tiles (8, 16, 32) and its default, on 32
    samples: blocks of several groups, ragged last groups in bf16 (8 = 5 +
    3 at L = 50), one sample a group at L = 197."""
    _core_out_case(cuda, dtype, 32, L, tb, L + (tb or 0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,tb", [(1, None), (7, 1), (7, 7), (45, 5),
                                  (45, None), (135, 27)])
@pytest.mark.parametrize("L", [50, 129])
def test_core_out_kernel_odd_batches(cuda, dtype, B, tb, L):
    """E2 on odd batches, at one sample a block, the whole batch a block,
    and tiles that leave groups ragged."""
    _core_out_case(cuda, dtype, B, L, tb, B + L)


def test_halfblock_tuning_kernels_refuse_bad_inputs(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = _block(768, gen, cuda)
    x = torch.randn(4, 50, 768, device=cuda, generator=gen)
    qkv = torch.randn(4, 50, 3 * 768, device=cuda, generator=gen)
    with pytest.raises(ValueError, match="tb"):
        HT.attention_halfblock_variant(x, p, "v2", 3)
    with pytest.raises(ValueError, match="x \\[B, L, 768\\]"):
        HT.attention_halfblock_variant(torch.randn(4, 50, 512, device=cuda),
                                       _block(512, gen, cuda), "v2")
    with pytest.raises(ValueError, match="L <= 256"):
        HT.core_out_halfblock(torch.randn(1, 257, 768, device=cuda),
                              torch.randn(1, 257, 3 * 768, device=cuda), p)
    with pytest.raises(ValueError, match="contiguous"):
        HT.core_out_halfblock(x, qkv.transpose(0, 1).contiguous()
                              .transpose(0, 1), p)
    with pytest.raises(TypeError):
        HT.attention_halfblock_variant(x.half(), p, "v1")


# ---------------------------------------------------------------------------
# K1/K2 under the train path's call patterns (GradCache, REMAT)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,causal", [(64, 50, False), (64, 77, True),
                                        (8, 50, False), (8, 77, True)])
def test_attention_kernels_under_no_grad_and_checkpoint(cuda, dtype, B, L,
                                                        causal):
    """At GradCache's microbatch shapes (256 / 4 and 32 / 4): under
    ``torch.no_grad`` (pass A) K1 launches once and nothing is kept for a
    backward; under non-reentrant ``torch.utils.checkpoint`` (REMAT) K1
    launches twice (the forward, then its recomputation in the backward)
    and K2 once, each against its plain version, and the gradient equals
    the one without the checkpoint bit for bit."""
    import torch.utils.checkpoint as ckpt

    gen = torch.Generator(device=cuda).manual_seed(B + L)
    x = torch.randn(B, L, 3 * 768, device=cuda, generator=gen).to(dtype)
    g = torch.randn(B, L, 768, device=cuda, generator=gen).to(dtype)
    mask = build_causal_mask(L, device=cuda) if causal else None
    want = A.attention_qkv_plain(x, 12, mask)
    qkv = x.clone().requires_grad_(True)
    before = (A.fused_attention_qkv.launches,
              A.fused_attention_qkv_bwd.launches)
    with torch.no_grad():
        out = A.fused_attention_qkv(qkv, 12, mask)
    torch.cuda.synchronize()
    assert out.grad_fn is None and not out.requires_grad
    _assert_fwd_close(out, want, dtype)
    assert A.fused_attention_qkv.launches == before[0] + 1

    grads = []
    for remat in (False, True):
        qkv = x.clone().requires_grad_(True)
        before = (A.fused_attention_qkv.launches,
                  A.fused_attention_qkv_bwd.launches)
        if remat:
            out = ckpt.checkpoint(A.fused_attention_qkv, qkv, 12, mask,
                                  use_reentrant=False)
        else:
            out = A.fused_attention_qkv(qkv, 12, mask)
        out.backward(g)
        torch.cuda.synchronize()
        assert (A.fused_attention_qkv.launches - before[0],
                A.fused_attention_qkv_bwd.launches - before[1]) == \
            (1 + remat, 1)
        _assert_fwd_close(out.detach(), want, dtype)
        grads.append(qkv.grad)
    assert torch.equal(grads[0], grads[1])
    _assert_bwd_close(grads[1], A.attention_qkv_bwd_plain(x, g, 12, mask),
                      dtype)


def test_gradcache_matches_the_one_shot_step_on_the_card(cuda, tmp_path):
    """A small MS-CLIP-S (width 128, heads of 64) in fp32 with frozen BN on
    the card: the ``ACCUM_STEPS 4`` gradients (GradCache) against the
    one-shot step's within 2e-5, with K1 and K2 launched 46a and 23a
    times per 23 blocks (here 2 x 4 x blocks and 4 x blocks)."""
    import json
    import os

    from msclip_torch.config import get_default_config, update_config
    from msclip_torch.models import msclip as TM
    from msclip_torch.train import trainer as TT

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "msclip_torch", "config",
                           "b32-yfcc-msclips.json")) as f:
        raw = json.load(f)
    raw["MODEL"]["SPEC"]["EMBED_DIM"] = 64
    raw["MODEL"]["SPEC"]["VISION"].update(WIDTH=128, LAYERS=6)
    raw["MODEL"]["SPEC"]["TEXT"].update(WIDTH=128, HEADS=2, LAYERS=6)
    raw["TRAIN"]["IMAGE_SIZE"] = [64, 64]
    raw["TPU"] = {"COMPUTE_DTYPE": "float32"}
    path = tmp_path / "small.json"
    path.write_text(json.dumps(raw))
    cfg = get_default_config()
    update_config(cfg, str(path))
    spec = TM.build_spec(cfg)
    params = TM.init_params(spec, torch.Generator().manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    images = torch.randn(8, 64, 64, 3, device=cuda, generator=gen)
    tokens = torch.randint(1, 49406, (8, 77), device=cuda, generator=gen,
                           dtype=torch.int32)
    tokens[:, 0], tokens[:, 9], tokens[:, 10:] = 49406, 49407, 0
    blocks = spec.effective_vision_layers - 1 + spec.text_layers
    grads, launches = [], []
    for accum in (1, 4):
        model = TM.MSClipModel(spec, {k: v.clone() for k, v in
                                      params.items()}, trainable=True).to(cuda)
        before = (A.fused_attention_qkv.launches,
                  A.fused_attention_qkv_bwd.launches)
        if accum == 1:
            loss, _ = TT.make_loss_fn(spec, freeze_bn=True)(
                model.params(), images, tokens)
            loss.backward()
        else:
            TT.gradcache_backward(TT.make_encode_fn(spec, freeze_bn=True),
                                  model.params(), images, tokens, accum)
        torch.cuda.synchronize()
        launches.append((A.fused_attention_qkv.launches - before[0],
                         A.fused_attention_qkv_bwd.launches - before[1]))
        grads.append({k: p.grad for k, p in model.named_parameters()
                      if p.grad is not None})
    assert launches == [(blocks, blocks), (8 * blocks, 4 * blocks)]
    assert set(grads[0]) == set(grads[1])
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, atol=2e-5, rtol=0,
                                   msg=k)


# ---------------------------------------------------------------------------
# serving: one CUDA graph a tower and bucket (msclip_torch.serve)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def b32_served(tmp_path_factory):
    """Full-width B/32 (seed-0 weights, bf16, BN folded) loaded from
    bundles on the card: unfused with buckets 1/4/16/64, and fused (K5 in
    every block) with buckets 1/64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    import os

    from msclip_torch.config import get_default_config, update_config
    from msclip_torch.eval.checkpoint_load import load_model_params
    from msclip_torch.models import msclip as TM
    from msclip_torch.serve import export_bundle, load_bundle
    from msclip_torch.serve.export import serving_params

    torch.backends.cuda.matmul.allow_tf32 = False
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = get_default_config()
    update_config(cfg, os.path.join(repo, "msclip_torch", "config",
                                    "b32-yfcc-msclips.json"),
                  opts=["TPU.COMPUTE_DTYPE", "bfloat16", "TPU.SEED", 0,
                        "MODEL.PRETRAINED_MODEL", ""])
    spec = TM.build_spec(cfg)
    params = serving_params(spec, load_model_params(cfg, spec))
    out = tmp_path_factory.mktemp("serve")
    export_bundle(spec, params, str(out / "b32"), buckets=(1, 4, 16, 64))
    export_bundle(dataclasses.replace(spec, use_fused_block=True), params,
                  str(out / "fused"), buckets=(1, 64))
    return {name: load_bundle(str(out / name), device="cuda")
            for name in ("b32", "fused")}


@pytest.mark.parametrize("bundle", ["b32", "fused"])
def test_serving_graph_replay_equals_eager_bitwise(b32_served, bundle):
    """Every bucket of both towers: the replay equals an eager call of the
    same towers on the same padded batch bit for bit, and the capture
    recorded K1 (unfused) or K5 (fused) once a block."""
    import chip_smoke

    served = b32_served[bundle]
    kernel = "attention_fwd" if bundle == "b32" else "attention_halfblock"
    blocks = {"image": 11, "text": 12}
    for tower, fns in (("image", served.image_fns),
                       ("text", served.text_fns)):
        for b, r in fns.items():
            assert {k: v for k, v in r.launches.items() if v} == \
                {kernel: blocks[tower]}, (tower, b)
            for seed in range(2):
                x = chip_smoke.tower_inputs(tower, b, seed)
                got = r(x)
                assert got.shape == (b, 512) and got.dtype == np.float32
                np.testing.assert_array_equal(got, r.eager(x))


def test_serving_concurrent_towers_equal_serial(b32_served):
    """Image and text replays from two threads at once (each tower its
    stream and lock, each graph its pool) equal the same calls made one
    after another."""
    import threading

    import chip_smoke

    served = b32_served["b32"]
    images = [chip_smoke.tower_inputs("image", n, 10 + n) for n in
              (1, 3, 16, 64, 70)]
    tokens = [chip_smoke.tower_inputs("text", n, 20 + n) for n in
              (2, 4, 9, 64, 65)]
    want_i = [served.encode_image(x) for x in images]
    want_t = [served.encode_text(x) for x in tokens]
    got = {}

    def run(name, fn, xs):
        got[name] = [fn(x) for _ in range(5) for x in xs]

    threads = [threading.Thread(target=run, args=(
                   "image", served.encode_image, images)),
               threading.Thread(target=run, args=(
                   "text", served.encode_text, tokens))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    for name, want in (("image", want_i), ("text", want_t)):
        assert len(got[name]) == 5 * len(want)
        for i, g in enumerate(got[name]):
            np.testing.assert_array_equal(g, want[i % len(want)])


def test_serving_graph_tracks_changing_inputs(b32_served):
    """100 replays of one bucket with a new input each: each equals the
    eager call on its input (no stale static buffer), and consecutive
    outputs differ."""
    import chip_smoke

    r = b32_served["b32"].image_fns[4]
    before = r.replays
    prev = None
    for seed in range(100):
        x = chip_smoke.tower_inputs("image", 4, 1000 + seed)
        got = r(x)
        np.testing.assert_array_equal(got, r.eager(x))
        assert prev is None or not np.array_equal(got, prev)
        prev = got
    assert r.replays == before + 100


def test_world_one_nccl_steps_equal_the_plain_step(cuda):
    """``python -m msclip_torch.tools.dryrun --nproc 1 --device cuda``: one
    process under ``torchrun`` with NCCL, where every collective is a copy,
    against the step without a process group (``dp``), and the ring,
    GradCache, ZeRO-1 and FSDP steps against theirs, at the tiny width
    with K1 and K2 in every block (fp32, TF32 off)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "msclip_torch.tools.dryrun",
                        "--nproc", "1", "--device", "cuda"], cwd=repo,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "DRYRUN ok world=1 device=cuda" in r.stdout


@pytest.mark.parametrize("causal", [False, True])
def test_kernels_launch_on_the_tensors_device(cuda, causal):
    """K1 and K2 on ``cuda:1`` while ``cuda:0`` is current: each wrapper
    makes its tensor's device current around the launch (the libraries'
    static CUDA runtime launches on the current device). Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    gen = torch.Generator(device=dev).manual_seed(7)
    qkv = torch.randn(16, 77, 3 * 768, device=dev, generator=gen)
    g = torch.randn(16, 77, 768, device=dev, generator=gen)
    mask = build_causal_mask(77, device=dev) if causal else None
    with torch.cuda.device(0):
        out = A.fused_attention_qkv(qkv, 12, mask)
        dqkv = A.fused_attention_qkv_bwd(qkv, g, 12, mask)
    torch.cuda.synchronize(dev)
    assert out.device == dev and dqkv.device == dev
    torch.testing.assert_close(out, A.attention_qkv_plain(qkv, 12, mask),
                               atol=TOL[torch.float32], rtol=0)
    torch.testing.assert_close(dqkv, A.attention_qkv_bwd_plain(qkv, g, 12,
                                                                mask),
                               atol=BWD_TOL[torch.float32][0],
                               rtol=BWD_TOL[torch.float32][1])

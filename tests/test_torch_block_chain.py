"""The trunk block's elementwise chain K7 (``ops/block_chain.py``) on the
CPU: its plain versions against the eager ops they replace, bit for bit;
the wrappers' CPU path; when ``transformer_block`` takes the chain; and the
LayerNorm kernel's arithmetic emulated with numpy against its plain
version. The kernels themselves run in ``test_torch_block_chain_gpu.py``."""

import types

import numpy as np
import pytest
import torch

from msclip_torch.models import layers as L
from msclip_torch.ops import block_chain as K7

from block_chain_checks import assert_ln_close

DTYPES = [torch.float32, torch.bfloat16]
F32, F64 = np.float32, np.float64


def _block(E, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = L.init_block("b", E, g)
    p = {k[2:]: v for k, v in p.items()}
    for k, v in p.items():  # nonzero biases, LayerNorm gains off 1
        if k.endswith("bias"):
            p[k] = 0.1 * torch.randn(v.shape, generator=g)
        elif k.startswith("ln_"):
            p[k] = 1.0 + 0.1 * torch.randn(v.shape, generator=g)
    p["ln_1.weight"][:2] = 30.0
    return {k: v.to(dtype) for k, v in p.items()}


def _eager_block(p, x, n_head, mask=None):
    """``transformer_block``'s eager chain."""
    x = x + L.attention(p, L.layer_norm(x, p["ln_1.weight"], p["ln_1.bias"]),
                        n_head, mask)
    return x + L.mlp(p, L.layer_norm(x, p["ln_2.weight"], p["ln_2.bias"]))


def _launches():
    return [fn.launches for fn in K7.KERNELS]


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_equal_the_eager_chain(dtype):
    """Each ``_plain`` version against the ``layers`` calls it replaces,
    bit for bit: ``linear``'s bias add, QuickGELU after it, the residual
    adds, the LayerNorms."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, 64, generator=g).to(dtype)
    h = torch.randn(3, 5, 64, generator=g).to(dtype)
    w = (0.1 * torch.randn(256, 64, generator=g)).to(dtype)
    b = torch.randn(256, generator=g).to(dtype)
    w2 = (0.1 * torch.randn(64, 64, generator=g)).to(dtype)
    b2, lw, lb = (torch.randn(64, generator=g).to(dtype) for _ in range(3))
    assert torch.equal(K7.ln_plain(x, lw, lb), L.layer_norm(x, lw, lb))
    assert torch.equal(K7.bias_plain(L.linear(h, w), b), L.linear(h, w, b))
    assert torch.equal(K7.bias_gelu_plain(L.linear(h, w), b),
                       L.quick_gelu(L.linear(h, w, b)))
    assert torch.equal(K7.bias_residual_plain(L.linear(h, w2), b2, x),
                       x + L.linear(h, w2, b2))
    x1, got = K7.bias_residual_ln_plain(L.linear(h, w2), b2, x, lw, lb)
    assert torch.equal(x1, x + L.linear(h, w2, b2))
    assert torch.equal(got, L.layer_norm(x1, lw, lb))


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_wrappers_take_plain_and_launch_nothing(dtype):
    g = torch.Generator().manual_seed(2)
    y, x = (torch.randn(4, 7, 32, generator=g).to(dtype) for _ in range(2))
    b, w, lb = (torch.randn(32, generator=g).to(dtype) for _ in range(3))
    before = _launches()
    assert torch.equal(K7.ln(x, w, lb), K7.ln_plain(x, w, lb))
    assert torch.equal(K7.bias(y, b), K7.bias_plain(y, b))
    assert torch.equal(K7.bias_gelu(y, b), K7.bias_gelu_plain(y, b))
    assert torch.equal(K7.bias_residual(y, b, x),
                       K7.bias_residual_plain(y, b, x))
    for got, want in zip(K7.bias_residual_ln(y, b, x, w, lb),
                         K7.bias_residual_ln_plain(y, b, x, w, lb)):
        assert torch.equal(got, want)
    assert _launches() == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "grad"])
def test_cpu_block_is_the_eager_chain(dtype, mode):
    """On the CPU ``transformer_block`` never takes the chain, under any
    grad mode: its output is the eager chain's bit for bit, and no
    counter moves. ``chain_block`` (the wrappers' plain versions there)
    computes the same chain bit for bit too."""
    p = _block(64, dtype)
    x = torch.randn(2, 9, 64, generator=torch.Generator().manual_seed(3))
    x = x.to(dtype)
    mask = L.build_causal_mask(9)
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "grad": torch.enable_grad}[mode]
    before = _launches()
    with ctx():
        assert not L.chain_route(p, x)
        got = L.transformer_block(p, x, 4, mask)
        chained = L.chain_block(p, x, 4, mask)
        want = _eager_block(p, x, 4, mask)
    assert torch.equal(got, want) and torch.equal(chained, want)
    assert _launches() == before


def test_backward_may_follow():
    """Inference mode rules a backward out; outside it, a tensor that
    requires grad lets one follow, under ``no_grad`` too (GradCache runs
    its first pass there and the same forward again with grad)."""
    p = {"w": torch.ones(4)}
    x = torch.ones(2, 4)
    grad_p = {"w": torch.ones(4, requires_grad=True)}
    for mode in (torch.enable_grad, torch.no_grad):
        with mode():
            assert not L.backward_may_follow(p, x)
            assert L.backward_may_follow(grad_p, x)
            assert L.backward_may_follow(p, x.clone().requires_grad_())
    with torch.inference_mode():
        assert not L.backward_may_follow(grad_p, x)


def _card_tensor(dtype=torch.bfloat16, E=768, requires_grad=False):
    """A stand-in for a CUDA tensor of the residual stream: what
    ``chain_route`` reads of it (device, dtype, shape, grad)."""
    return types.SimpleNamespace(is_cuda=True, dtype=dtype, shape=(2, 50, E),
                                 requires_grad=requires_grad,
                                 numel=lambda: 2 * 50 * E)


def test_chain_route_decision():
    """The chain is taken on the card, in bf16 or fp32, at a width the
    kernels take, where no backward can follow; never under tensor
    parallelism, drop-path or an int8 block, nor outside inference mode
    with a tensor that requires grad, whatever the grad mode. A real CPU
    tensor never takes it."""
    p = _block(64, torch.float32)
    trained = dict(p, **{"ln_1.weight": p["ln_1.weight"].clone()
                         .requires_grad_()})
    with torch.enable_grad():
        assert L.chain_route(p, _card_tensor())
        assert L.chain_route(p, _card_tensor(torch.float32))
        assert not L.chain_route(p, _card_tensor(torch.float16))
        assert not L.chain_route(p, _card_tensor(E=100))
        assert not L.chain_route(p, _card_tensor(E=4104))
        assert not L.chain_route(p, _card_tensor(), tp=object())
        assert not L.chain_route(p, _card_tensor(), dropping=True)
        assert not L.chain_route(p, _card_tensor(requires_grad=True))
        assert not L.chain_route(trained, _card_tensor())
        int8 = {k: v for k, v in p.items() if k != "attn.in_proj_weight"}
        int8["attn.in_proj_weight_int8"] = torch.zeros(192, 64,
                                                       dtype=torch.int8)
        assert not L.chain_route(int8, _card_tensor())
        assert not L.chain_route(p, torch.zeros(2, 50, 64))
    with torch.no_grad():
        assert L.chain_route(p, _card_tensor())
        assert not L.chain_route(trained, _card_tensor())
        assert not L.chain_route(p, _card_tensor(requires_grad=True))
        assert not L.chain_route(p, torch.zeros(2, 50, 64))
    with torch.inference_mode():
        assert L.chain_route(trained, _card_tensor())
        assert not L.chain_route(p, torch.zeros(2, 50, 64))


def test_gradcache_passes_take_one_chain(monkeypatch):
    """GradCache's no-grad first pass and its second pass with grad run
    the same chain: with the kernels' device check read as the card's, a
    GradCache step on a trainable block takes the eager chain in both
    passes, while the same forward under ``inference_mode`` takes
    ``chain_block`` (the wrappers' plain versions on the CPU)."""
    from msclip_torch.train import trainer as TT

    monkeypatch.setattr(L.K7, "takes", lambda x: True)
    chained = []
    chain_block = L.chain_block
    monkeypatch.setattr(L, "chain_block",
                        lambda *a, **k: chained.append(1) or
                        chain_block(*a, **k))
    p = {k: v.clone().requires_grad_() for k, v in
         _block(64, torch.float32).items()}
    params = {**{f"b.{k}": v for k, v in p.items()},
              "logit_scale": torch.tensor(2.6592, requires_grad=True)}
    g = torch.Generator().manual_seed(5)
    images, tokens = (torch.randn(4, 9, 64, generator=g) for _ in range(2))

    def encode(params, im, tk, gen=None):
        bp = {k[2:]: v for k, v in params.items() if k.startswith("b.")}
        return (L.transformer_block(bp, im, 4).mean(dim=1),
                L.transformer_block(bp, tk, 4).mean(dim=1), {})

    loss, _ = TT.gradcache_backward(encode, params, images, tokens, 2)
    assert torch.isfinite(loss) and not chained
    assert all(v.grad is not None for v in p.values())
    with torch.inference_mode():
        encode(params, images, tokens)
    assert len(chained) == 2


def test_ops_import_nothing_of_models():
    """``ops`` sits below ``models``: no module of ``msclip_torch/ops``
    imports ``msclip_torch.models`` (``layers`` imports ``ops``)."""
    import ast
    import pathlib

    import msclip_torch.ops as ops

    for path in pathlib.Path(ops.__file__).parent.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                name = "." * node.level + (node.module or "")
                assert not name.startswith("..models") \
                    and "msclip_torch.models" not in name, (path.name, name)
            elif isinstance(node, ast.Import):
                assert not any("msclip_torch.models" in a.name
                               for a in node.names), path.name


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_block_with_drop_path_or_int8_launches_nothing(dtype):
    """The other routes of ``transformer_block`` under ``no_grad``:
    drop-path and a quantized block (int8 at and below the fused gate)
    launch no K7 kernel."""
    p = _block(64, dtype)
    x = torch.randn(2, 9, 64, generator=torch.Generator().manual_seed(4))
    x = x.to(dtype)
    keep = [torch.ones(2, 1, 1, dtype=torch.bool)] * 2
    q = {k: v for k, v in p.items() if k not in L.GEMM_KEYS}
    for k in L.GEMM_KEYS:
        s = p[k].float().abs().amax(dim=1).clamp_min(1e-8) / 127
        q[k + "_scale"] = s
        q[k + "_int8"] = torch.round(p[k].float() / s[:, None]).to(torch.int8)
    before = _launches()
    with torch.no_grad():
        L.transformer_block(p, x, 4, drop_path_rate=0.1, keep=keep)
        L.transformer_block(q, x, 4)
        L.transformer_block(q, x[:, :1], 4)
    assert _launches() == before


def test_span_split_counts_each_kernel_once():
    """``profile_zero_shot.span_split`` on a made-up trace of two steps:
    each kernel goes to the innermost and to the outermost span open on
    its launching thread at its launch, a repeated record (the profiler's
    ``Command Buffer Full`` copy) counts once, and a kernel launched
    outside every span is named so."""
    from msclip_torch.tools.profile_zero_shot import span_split

    def span(name, ts, dur, tid=1):
        return {"ph": "X", "cat": "user_annotation", "name": name,
                "ts": ts, "dur": dur, "tid": tid}

    def launch(corr, ts, tid=1):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 1, "tid": tid, "args": {"correlation": corr}}

    def kernel(corr, ts, dur, name="k"):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": dur, "tid": 7, "args": {"correlation": corr}}

    events = [span("msclip.image.block", 0, 100),
              span("msclip.attention.fwd", 10, 20),
              launch(1, 5), launch(2, 15), launch(3, 150), launch(4, 16),
              kernel(1, 200, 1000), kernel(2, 1300, 3000, "attn"),
              kernel(2, 1300, 3000, "attn"), kernel(3, 4400, 500),
              kernel(4, 4900, 2000), {"ph": "i", "name": "marker"}]
    inner, outer = span_split({"traceEvents": events}, steps=2)
    assert outer == {"msclip.image.block": 3.0,
                     "outside any span": 0.25}
    assert inner == {"msclip.image.block": 0.5,
                     "msclip.attention.fwd": 2.5,
                     "outside any span": 0.25}


# ---------------------------------------------------------------------------
# the LayerNorm kernel's arithmetic, emulated
# ---------------------------------------------------------------------------

def _round_to(v, dtype):
    return torch.from_numpy(np.ascontiguousarray(v, F32)).to(dtype).float(
    ).numpy()


def _fma32(a, b, c):
    """fp32 fused multiply-add: the product exact in fp64, one rounding of
    the sum (exact too for these magnitudes: fp64 holds both terms)."""
    return (a.astype(F64) * b.astype(F64) + c.astype(F64)).astype(F32)


def _warp_sum(v):
    """``warp_sum`` over the lane axis (-1): the xor butterfly."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ o]).astype(F32)
    return v[..., 0]


def _ln_kernel(x, w, b, dtype, eps=1e-12):
    """``ln_row.cuh`` on rows ``x [R, E]`` (fp32 arrays of ``dtype``
    values): lane l holds chunks l, l + 32, ... of 8; each chunk's tree
    sum into the lane's sum, ``warp_sum``, the mean; the squares as fp32
    fmas a chunk, the variance; rsqrt rounded once (the card's ``rsqrtf``
    is within an ulp or two); n, w n and w n + b each rounded to
    ``dtype``."""
    R, E = x.shape
    C = -(-E // 256)
    v = np.zeros((R, C, 32, 8), F32)
    have = np.zeros((C, 32), bool)
    wv, bv = (np.zeros((C, 32, 8), F32) for _ in range(2))
    for c in range(E // 8):
        v[:, c // 32, c % 32] = x[:, 8 * c:8 * c + 8]
        wv[c // 32, c % 32] = w[8 * c:8 * c + 8]
        bv[c // 32, c % 32] = b[8 * c:8 * c + 8]
        have[c // 32, c % 32] = True
    t = [(v[..., 2 * i] + v[..., 2 * i + 1]).astype(F32) for i in range(4)]
    tree = ((t[0] + t[1]).astype(F32) + (t[2] + t[3]).astype(F32)).astype(F32)
    lane_sum = np.zeros((R, 32), F32)
    for j in range(C):
        lane_sum = np.where(have[j], (lane_sum + tree[:, j]).astype(F32),
                            lane_sum)
    mean = (_warp_sum(lane_sum) / F32(E)).astype(F32)[:, None, None, None]
    d = (v - mean).astype(F32)
    sq = np.zeros((R, C, 32), F32)
    for i in range(8):
        sq = _fma32(d[..., i], d[..., i], sq)
    sq_lane = np.zeros((R, 32), F32)
    for j in range(C):
        sq_lane = np.where(have[j], (sq_lane + sq[:, j]).astype(F32), sq_lane)
    var = (_warp_sum(sq_lane) / F32(E)).astype(F32)
    rstd = (1.0 / np.sqrt((var + F32(eps)).astype(F32).astype(F64))).astype(
        F32)
    n = _round_to((d * rstd[:, None, None, None]).astype(F32), dtype)
    h = _round_to((_round_to((wv * n).astype(F32), dtype) + bv).astype(F32),
                  dtype)
    out = np.zeros((R, E), F32)
    for c in range(E // 8):
        out[:, 8 * c:8 * c + 8] = h[:, c // 32, c % 32]
    return torch.from_numpy(out).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E", [64, 512, 768, 1032])
def test_ln_kernel_arithmetic_matches_plain(dtype, E):
    """The LayerNorm kernel's arithmetic (:func:`_ln_kernel`) against
    ``ln_plain`` on the CPU within the card tests' limit: random rows of
    scale 3 with two gains of 30, a constant row and a zero row (h = b).
    E = 1032 leaves lanes without their last chunk."""
    rng = np.random.default_rng(E)
    x = (3 * rng.standard_normal((64, E))).astype(F32)
    x[5], x[6] = 3.0, 0.0
    w = (1 + 0.1 * rng.standard_normal(E)).astype(F32)
    w[:2] = 30.0
    b = (0.1 * rng.standard_normal(E)).astype(F32)
    x, w, b = (torch.from_numpy(a).to(dtype) for a in (x, w, b))
    got = _ln_kernel(x.float().numpy(), w.float().numpy(), b.float().numpy(),
                     dtype)
    assert_ln_close(got, x, w, b)
    assert torch.equal(got[5], b) and torch.equal(got[6], b)

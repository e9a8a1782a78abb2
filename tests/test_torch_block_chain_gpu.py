"""The trunk block's elementwise chain K7 (``ops/block_chain.py``,
``csrc/block_chain.cu``) against its plain versions on the card: ``bias``,
``bias_gelu`` and ``bias_residual`` bit for bit, the two LayerNorms within
one ulp of their normalized value; a whole B/32 block against the eager
block; a CUDA graph's replay against eager calls bit for bit; and which
paths launch the kernels.

JAX-free, so that it runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_block_chain_gpu.py

Without a CUDA device every test skips (decided inside the fixture).
"""

import os

import pytest
import torch

from msclip_torch.models import layers as L
from msclip_torch.ops import block_chain as K7

from block_chain_checks import assert_ln_close

pytestmark = pytest.mark.gpu
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# rows x E: the B/32 image tower at 256 images (12,800 rows), B/16's
# (50,432), the text tower at E = 512 (256 x 77), a ragged count, and a
# LayerNorm as wide as the MLP's hidden layer
SHAPES = [(12800, 768), (50432, 768), (19712, 512), (1237, 768), (999, 3072)]
DTYPES = [torch.bfloat16, torch.float32]
LN_OUTLIER_GAIN = 30.0  # two channels a LayerNorm, as the benchmark draws


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def _ln_vectors(gen, E, dtype):
    """A LayerNorm's gain ``1 + 0.1 z`` with two channels at 30, and a
    bias ``0.1 z``."""
    w = 1.0 + _randn(gen, E, scale=0.1)
    w[torch.randperm(E, generator=gen, device=gen.device)[:2]] = \
        LN_OUTLIER_GAIN
    return w.to(dtype), _randn(gen, E, scale=0.1, dtype=dtype)


def _launches():
    return [fn.launches for fn in K7.KERNELS]


def _assert_bitwise(got, want):
    """Equal bits, or both NaN."""
    assert got.dtype == want.dtype and got.shape == want.shape
    same = got.view(torch.int16 if got.dtype == torch.bfloat16 else
                    torch.int32) == want.view(torch.int16 if want.dtype ==
                                              torch.bfloat16 else torch.int32)
    same |= torch.isnan(got) & torch.isnan(want)
    assert bool(same.all()), (
        f"{int((~same).sum())} of {same.numel()} elements differ, the "
        f"largest by {(got.float() - want.float()).abs().nan_to_num().max()}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,E", SHAPES)
@pytest.mark.parametrize("kind", ["bias", "bias_gelu", "bias_residual"])
def test_bias_kernels_equal_plain_bitwise(cuda, kind, rows, E, dtype):
    """At the block's widths: the qkv bias at 3E, QuickGELU's at 4E, the
    c_proj bias and residual at E."""
    gen = torch.Generator(device=cuda).manual_seed(rows + E)
    N = {"bias": 3 * E, "bias_gelu": 4 * E, "bias_residual": E}[kind]
    y = _randn(gen, rows, N, scale=2.0, dtype=dtype)
    b = _randn(gen, N, scale=0.5, dtype=dtype)
    fn, plain = getattr(K7, kind), getattr(K7, kind + "_plain")
    args = (y, b) if kind != "bias_residual" else \
        (y, b, _randn(gen, rows, N, scale=4.0, dtype=dtype))
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _assert_bitwise(got, plain(*args))


def test_bias_gelu_every_bf16_pattern(cuda):
    """QuickGELU on every bf16 bit pattern (infinities, NaNs, subnormals,
    the tails where the sigmoid saturates), bias 0 and 1."""
    y = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device=cuda)
    y = y.to(torch.int16).view(torch.bfloat16).reshape(-1, 256)
    for fill in (0.0, 1.0):
        b = torch.full((256,), fill, dtype=torch.bfloat16, device=cuda)
        got = K7.bias_gelu(y, b)
        torch.cuda.synchronize()
        _assert_bitwise(got, K7.bias_gelu_plain(y, b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,E", SHAPES)
def test_layer_norm_kernels_within_one_ulp(cuda, rows, E, dtype):
    """``ln`` and ``bias_residual_ln`` (its residual ``x1`` bit for bit)
    against their plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(rows * E)
    x = _randn(gen, rows, E, scale=3.0, dtype=dtype)
    w, lb = _ln_vectors(gen, E, dtype)
    before = _launches()
    got = K7.ln(x, w, lb)
    y = _randn(gen, rows, E, dtype=dtype)
    yb = _randn(gen, E, scale=0.5, dtype=dtype)
    x1, h = K7.bias_residual_ln(y, yb, x, w, lb)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launches(), before)] == [1, 0, 1, 0, 0]
    assert_ln_close(got, x, w, lb)
    want_x1, _ = K7.bias_residual_ln_plain(y, yb, x, w, lb)
    _assert_bitwise(x1, want_x1)
    assert_ln_close(h, x1, w, lb)


def test_layer_norm_kernel_constant_and_zero_rows(cuda):
    """A constant row normalizes to 0 (h = b), a zero row too, and the
    zero biases of the benchmark's draw."""
    x = torch.randn(64, 768, device=cuda).to(torch.bfloat16)
    x[5], x[6] = 3.0, 0.0
    w = torch.ones(768, device=cuda, dtype=torch.bfloat16)
    for b in (torch.zeros_like(w), torch.randn(768, device=cuda).to(w.dtype)):
        got = K7.ln(x, w, b)
        torch.cuda.synchronize()
        assert_ln_close(got, x, w, b)
        assert torch.equal(got[5], b) and torch.equal(got[6], b)


def _b32_block(gen, dtype, E=768):
    """A B/32 trunk block's tensors as the benchmark draws them (LayerNorm
    gains with two channels at 30), with nonzero biases."""
    p = {}
    for ln in ("ln_1", "ln_2"):
        p[f"{ln}.weight"], p[f"{ln}.bias"] = _ln_vectors(gen, E, dtype)
    for key, (n_out, n_in, std) in {
            "attn.in_proj": (3 * E, E, (2.0 / (4 * E)) ** 0.5),
            "attn.out_proj": (E, E, 0.02), "mlp.c_fc": (4 * E, E, 0.02),
            "mlp.c_proj": (E, 4 * E, 0.02)}.items():
        name = key + ("_weight" if key == "attn.in_proj" else ".weight")
        p[name] = _randn(gen, n_out, n_in, scale=std, dtype=dtype)
        bias = key + ("_bias" if key == "attn.in_proj" else ".bias")
        p[bias] = _randn(gen, n_out, scale=0.02, dtype=dtype)
    return p


def _eager_block(p, x, n_head):
    """``transformer_block``'s eager chain, as it runs with a graph."""
    x = x + L.attention(p, L.layer_norm(x, p["ln_1.weight"], p["ln_1.bias"]),
                        n_head)
    return x + L.mlp(p, L.layer_norm(x, p["ln_2.weight"], p["ln_2.bias"]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_b32_block_matches_the_eager_block(cuda, dtype):
    """One B/32 block (256 x 50, E = 768, 12 heads) under
    ``inference_mode`` through K7 against the eager block on the same
    tensors: rms gap under 2^-9 of the output's rms in bf16 (1e-6 in
    fp32), every element within 2^-5 (1e-4) of 1 + |want|: only the
    LayerNorms' ulps differ."""
    gen = torch.Generator(device=cuda).manual_seed(32)
    p = _b32_block(gen, dtype)
    x = _randn(gen, 256, 50, 768, scale=2.0, dtype=dtype)
    before = _launches()
    with torch.inference_mode():
        assert L.chain_route(p, x)
        got = L.transformer_block(p, x, 12)
    with torch.no_grad():
        want = _eager_block(p, x, 12)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launches(), before)] == [1] * 5
    rms_tol, el_tol = {torch.bfloat16: (2.0 ** -9, 2.0 ** -5),
                       torch.float32: (1e-6, 1e-4)}[dtype]
    d = (got.float() - want.float())
    assert d.square().mean().sqrt() <= rms_tol * want.float().square().mean(
    ).sqrt()
    assert bool((d.abs() <= el_tol * (1 + want.float().abs())).all())


def test_cuda_graph_replay_equals_eager_bitwise(cuda):
    """The five kernels of a B/32 block's chain captured in one CUDA graph
    on a side stream: three replays on new inputs each equal the eager
    calls on those inputs bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    dt, rows, E = torch.bfloat16, 12800, 768
    p = _b32_block(gen, dt)
    static = {"x": _randn(gen, rows, E, dtype=dt),
              "qkv": _randn(gen, rows, 3 * E, dtype=dt),
              "out": _randn(gen, rows, E, dtype=dt),
              "fc": _randn(gen, rows, 4 * E, dtype=dt),
              "proj": _randn(gen, rows, E, dtype=dt)}

    def chain(t):
        h = K7.ln(t["x"], p["ln_1.weight"], p["ln_1.bias"])
        qkv = K7.bias(t["qkv"], p["attn.in_proj_bias"])
        x1, h2 = K7.bias_residual_ln(t["out"], p["attn.out_proj.bias"],
                                     t["x"], p["ln_2.weight"], p["ln_2.bias"])
        mid = K7.bias_gelu(t["fc"], p["mlp.c_fc.bias"])
        return h, qkv, x1, h2, mid, K7.bias_residual(
            t["proj"], p["mlp.c_proj.bias"], x1)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.inference_mode(), torch.cuda.stream(stream):
        chain(static)  # warm-up: the library's build and load
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _launches()
    with torch.inference_mode(), torch.cuda.graph(graph, stream=stream):
        outs = chain(static)
    assert [a - b for a, b in zip(_launches(), before)] == [1] * 5
    for seed in range(3):
        g = torch.Generator(device=cuda).manual_seed(100 + seed)
        fresh = {k: _randn(g, *v.shape, scale=1.0 + seed, dtype=dt)
                 for k, v in static.items()}
        for k, v in fresh.items():
            static[k].copy_(v)
        graph.replay()
        with torch.inference_mode():
            want = chain(fresh)
        torch.cuda.synchronize()
        for got, w in zip(outs, want):
            _assert_bitwise(got, w)


def test_block_chain_kernels_refuse_bad_inputs(cuda):
    x = torch.randn(4, 768, device=cuda, dtype=torch.bfloat16)
    v = torch.randn(768, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        K7.ln(x.half(), v.half(), v.half())
    with pytest.raises(ValueError):
        K7.bias(torch.randn(4, 12, device=cuda), torch.randn(12,
                                                              device=cuda))
    with pytest.raises(ValueError):  # not contiguous
        K7.bias(x.t().contiguous().t(), v)
    with pytest.raises(ValueError):  # 16-byte misaligned
        K7.bias(torch.cat([v[:1], x.flatten()])[1:].view(4, 768), v)
    with pytest.raises(ValueError):  # the bias's width
        K7.bias(x, v[:8])
    with pytest.raises(ValueError):  # the residual's shape
        K7.bias_residual(x, v, x[:2])
    with pytest.raises(ValueError):  # wider than the LayerNorm kernel takes
        wide = torch.zeros(2, 4104, device=cuda, dtype=torch.bfloat16)
        K7.ln(wide, wide[0], wide[0])


def test_launches_by_path_at_b32(cuda):
    """At full width (B/32, bf16, random weights): one ``encode_image``
    batch under ``inference_mode`` launches each K7 kernel once in each of
    the 11 trunk blocks, and ``encode_text`` once in each of its 12; one
    contrastive train step with grad (forward and backward) launches
    none."""
    from msclip_torch.config import get_default_config, update_config
    from msclip_torch.eval.zero_shot import load_eval_model
    from msclip_torch.models import msclip as TM
    from msclip_torch.train import trainer as TT

    cfg = get_default_config()
    update_config(cfg, os.path.join(REPO, "msclip_torch", "config",
                                    "b32-yfcc-msclips.json"),
                  opts=["TPU.COMPUTE_DTYPE", "bfloat16", "TPU.SEED", 0,
                        "MODEL.PRETRAINED_MODEL", ""])
    spec = TM.build_spec(cfg)
    gen = torch.Generator(device=cuda).manual_seed(3)
    images = torch.randn(8, 224, 224, 3, device=cuda, generator=gen)
    tokens = torch.randint(1, 49406, (8, 77), device=cuda, generator=gen,
                           dtype=torch.int32)
    tokens[:, 0], tokens[:, 9], tokens[:, 10:] = 49406, 49407, 0

    model = load_eval_model(cfg, spec, cuda)
    with torch.inference_mode():
        for fn, arg, blocks in ((model.encode_image, images, 11),
                                (model.encode_text, tokens, 12)):
            before = _launches()
            fn(arg)
            torch.cuda.synchronize()
            assert [a - b for a, b in zip(_launches(), before)] == \
                [blocks] * 5
    del model

    params = TM.init_params(spec, torch.Generator().manual_seed(0))
    model = TM.MSClipModel(spec, params, trainable=True).to(cuda)
    before = _launches()
    loss, _ = TT.make_loss_fn(spec)(model.params(), images, tokens)
    loss.backward()
    torch.cuda.synchronize()
    assert _launches() == before
    assert torch.isfinite(loss)

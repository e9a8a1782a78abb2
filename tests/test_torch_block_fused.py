"""The port's fused half-blocks (``TPU.USE_FUSED_BLOCK``) against the JAX
package's, on the CPU: the plain versions of K5 and K6 against the Pallas
kernels in interpret mode, the hybrid ``fused_block``, and the towers with
the switch on, on inputs made with numpy from a seed. The kernels
themselves are checked on the card by ``chip_smoke.py`` and
``tests/test_torch_kernels_gpu.py``."""

import dataclasses
import functools
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msclip_tpu.models import build_model as jax_build_model
from msclip_tpu.models import layers as JL
from msclip_tpu.ops import block_fused as JBF
from msclip_torch.eval.zero_shot import run_zero_shot
from msclip_torch.models import layers as TL
from msclip_torch.models import msclip as TM
from msclip_torch.ops import block_fused as BF
from msclip_torch.ops import cuda_build
from msclip_torch.utils.convert import params_from_jax

from reference_oracle import tiny_msclips_config
from torch_port_params import random_jax_params

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# fp32: the JAX package's block tolerance (tests/test_kernels.py:250).
# bf16: elementwise |port - jax| <= atol + rtol |jax|, with room for one
# bf16 ulp of the output (2^-7 relative at most) where an fp32 sum in
# another order rounds a q, k, v or context value to its neighbour
TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
       "bfloat16": dict(atol=1e-2, rtol=2e-2)}
SHAPES = [(64, 2), (128, 2)]  # (E, H): the JAX test's, and heads of 64


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _jax_block(rng, E):
    return {
        "attn": {"qkv_w": _np(rng, E, 3 * E, scale=E ** -0.5),
                 "qkv_b": _np(rng, 3 * E, scale=0.1),
                 "out_w": _np(rng, E, E, scale=E ** -0.5),
                 "out_b": _np(rng, E, scale=0.1)},
        "ln_1": {"scale": 1 + _np(rng, E, scale=0.1),
                 "bias": _np(rng, E, scale=0.1)},
        "ln_2": {"scale": 1 + _np(rng, E, scale=0.1),
                 "bias": _np(rng, E, scale=0.1)},
        "mlp": {"c_fc": {"w": _np(rng, E, 4 * E, scale=E ** -0.5),
                         "b": _np(rng, 4 * E, scale=0.1)},
                "c_proj": {"w": _np(rng, 4 * E, E, scale=(4 * E) ** -0.5),
                           "b": _np(rng, E, scale=0.1)}},
    }


def _port_block(jb):
    """A JAX block tree under the port's local names, weights ``[out,
    in]``."""
    def t(a, transpose=False):
        a = np.asarray(a)
        return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))

    a, m = jb["attn"], jb["mlp"]
    return {"ln_1.weight": t(jb["ln_1"]["scale"]),
            "ln_1.bias": t(jb["ln_1"]["bias"]),
            "ln_2.weight": t(jb["ln_2"]["scale"]),
            "ln_2.bias": t(jb["ln_2"]["bias"]),
            "attn.in_proj_weight": t(a["qkv_w"], True),
            "attn.in_proj_bias": t(a["qkv_b"]),
            "attn.out_proj.weight": t(a["out_w"], True),
            "attn.out_proj.bias": t(a["out_b"]),
            "mlp.c_fc.weight": t(m["c_fc"]["w"], True),
            "mlp.c_fc.bias": t(m["c_fc"]["b"]),
            "mlp.c_proj.weight": t(m["c_proj"]["w"], True),
            "mlp.c_proj.bias": t(m["c_proj"]["b"])}


def _strict(fn, *args):
    """``fn`` jitted without excess precision: XLA on the CPU otherwise
    skips bf16 roundings that the TPU kernel and torch both make."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _case(E, L, dtype, seed):
    rng = np.random.default_rng(seed)
    jb = _jax_block(rng, E)
    x = _np(rng, 3, L, E)  # B = 3: JAX pads it to its batch tile of 2
    tdt, jdt = DTYPES[dtype]
    return jb, _port_block(jb), torch.from_numpy(x).to(tdt), \
        jnp.asarray(x).astype(jdt)


def _close(got, want, dtype):
    assert got.dtype == DTYPES[dtype][0]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,H", SHAPES)
@pytest.mark.parametrize("L,causal", [(50, False), (50, True), (13, False),
                                      (13, True)])
def test_attention_halfblock_plain_matches_jax_kernel(dtype, E, H, L, causal):
    jb, tp, tx, jx = _case(E, L, dtype, seed=E + L)
    jmask = JL.build_causal_mask(L) if causal else None
    want = _strict(lambda x: JBF.fused_attention_halfblock(
        x, jb, H, jmask, interpret=True, batch_tile=2), jx)
    got = BF.fused_attention_halfblock(
        tx, tp, H, TL.build_causal_mask(L) if causal else None)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E", [64, 128])
@pytest.mark.parametrize("L", [50, 13])
def test_mlp_halfblock_plain_matches_jax_kernel(dtype, E, L):
    jb, tp, tx, jx = _case(E, L, dtype, seed=2 * E + L)
    want = _strict(lambda x: JBF.fused_mlp_halfblock(
        x, jb, interpret=True, batch_tile=2), jx)
    _close(BF.fused_mlp_halfblock(tx, tp), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_fused_block_matches_jax(dtype, causal):
    """K5 and the unfused MLP half against JAX's ``fused_block``."""
    jb, tp, tx, jx = _case(128, 50, dtype, seed=7)
    jmask = JL.build_causal_mask(50) if causal else None
    want = _strict(lambda x: JBF.fused_block(x, jb, 2, jmask,
                                             interpret=True), jx)
    got = BF.fused_block(tx, tp, 2, TL.build_causal_mask(50) if causal
                         else None)
    _close(got, want, dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("E,H", SHAPES)
def test_fused_block_matches_transformer_block_in_fp32(causal, E, H):
    """In fp32 the bias added before or after the rounding is the same
    value, so the fused block is the port's unfused block, at the JAX
    test's limit."""
    _, tp, tx, _ = _case(E, 50, "float32", seed=11)
    mask = TL.build_causal_mask(50) if causal else None
    np.testing.assert_allclose(
        BF.fused_block(tx, tp, H, mask).numpy(),
        TL.transformer_block(tp, tx, H, mask).numpy(), atol=2e-5, rtol=1e-4)


def test_cpu_path_is_plain_and_launches_nothing():
    _, tp, tx, _ = _case(64, 13, "float32", seed=3)
    before = (BF.fused_attention_halfblock.launches,
              BF.fused_mlp_halfblock.launches)
    assert torch.equal(BF.fused_attention_halfblock(tx, tp, 2),
                       BF.attention_halfblock_plain(tx, tp, 2))
    assert torch.equal(BF.fused_mlp_halfblock(tx, tp),
                       BF.mlp_halfblock_plain(tx, tp))
    assert (BF.fused_attention_halfblock.launches,
            BF.fused_mlp_halfblock.launches) == before


def _walk(B, S, grid):
    """Each sample's count over K5's walk: block ``i < grid`` takes the
    groups of ``S`` samples starting at ``i S, (i + grid) S, ...``."""
    counts = np.zeros(B, dtype=np.int64)
    for i in range(grid):
        for b0 in range(i * S, B, grid * S):
            counts[b0:b0 + min(S, B - b0)] += 1
    return counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sms", [132, 7])
def test_attn_plan_covers_every_sample_once(dtype, sms):
    """K5's group and workspace reckoning (``attn_plan``) for every B in
    1..300 and L in 1..256: groups of whole samples that the bf16 design's
    shared memory holds (256 GEMM rows, 512 padded attention rows, or one
    sample; fp32: the mma.sync design's 128-row group), a slice of h and
    ctx (and fp32 q/k/v) per group, and the kernel's walk, at one or two
    blocks an SM, covering every sample exactly once."""
    bf = dtype == torch.bfloat16
    walks = {}
    for L in range(1, 257):
        for B in range(1, 301):
            plan = BF.attn_plan(B, L, dtype, sms)
            S, groups, slots = plan["S"], plan["groups"], plan["slots"]
            assert groups == -(-B // S) and 1 <= slots <= 2 * sms
            if bf:
                assert S == 1 or (S * L <= 256 and S * BF.padded_len(L) <= 512)
                assert S <= max(1, -(-B // sms))
            else:
                assert S == max(1, 128 // L)
            assert plan["slot"] == S * L * (2 * 768 + (0 if bf else 192))
            for per_sm in (1, 2):
                grid = min(per_sm * sms, groups, slots)
                key = (B, S, grid)
                if key not in walks:
                    walks[key] = bool((_walk(B, S, grid) == 1).all())
                assert walks[key], (B, L, plan, grid)


def _source(name):
    with open(os.path.join(cuda_build.CSRC_DIR, name)) as f:
        return f.read()


def _constant(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_group_limits_mirror_the_source():
    """The wrappers plan K5's and E1's groups and workspace with the
    source's limits, which the kernels check: the padded length of K1's
    ``padded_len`` (attn_core.cuh) at every L, the group limits of
    halfblock.cuh, and the slice of ``attn_slot_elems`` and E1's
    ``variant_slot_elems``."""
    core, half = _source("attn_core.cuh"), _source("halfblock.cuh")
    body = re.search(r"constexpr int padded_len\(int L\) \{\s*return ([^;]*);",
                     core).group(1)
    steps = [(int(a), int(b)) for a, b in re.findall(r"L <= (\d+) \? (\d+)", body)]
    last = int(body.rsplit(":", 1)[1])
    for L in range(1, 257):
        assert BF.padded_len(L) == next((p for at, p in steps if L <= at), last)
    assert (_constant(half, "kE"), _constant(half, "kD")) == (BF.WIDTH, BF.HEAD_DIM)
    assert _constant(half, "kGroupRows") == BF.GROUP_ROWS
    assert _constant(half, "kWgRows") == BF.WGMMA_ROWS
    assert _constant(half, "kWgTileRows") == BF.TILE_ROWS
    slot = "S * L * (2 * kE + (std::is_same<T, bf16>::value ? 0 : kQkv))"
    assert slot in _source("block_fused.cu")
    assert slot.replace("S * L", "G * L") in _source("halfblock_tuning.cu")
    assert BF.slot_elems(3, 77, torch.bfloat16) == 3 * 77 * 2 * 768
    assert BF.slot_elems(1, 77, torch.float32) == 77 * (2 * 768 + 3 * 64)


# token counts of the main paths and edges of K6's plan on 132 SMs: the
# image tower, the text chunk, B/16, one round of big groups exactly, one
# row past it, and one row short of it
MLP_ROWS = list(range(1, 3001)) + [12_800, 78_848, 50_432, 33_792, 33_793,
                                   33_791]


def _mlp_group(g, rows, big):
    """``(first row, rows)`` of bf16 K6's group ``g``, as ``mlp_group`` in
    block_fused.cu walks them: ``big`` groups of 256 rows, then groups of
    128, the last ragged."""
    if g < big:
        return g * 256, 256
    r0 = big * 256 + (g - big) * 128
    return r0, min(128, rows - r0)


@pytest.mark.parametrize("sms", [132, 114, 7, 1])
def test_mlp_plan_covers_every_row_once(sms):
    """bf16 K6's groups (``mlp_plan``, ``mlp_group``, as block_fused.cu
    walks them) for every row count up to 3000 and the main paths': block
    ``i < slots`` takes groups ``i, i + slots, ...``; every row lies in
    exactly one group, a group of 256 rows only whole and only in 256-row
    slots, no more blocks than SMs or groups, and the busiest block takes
    ``ceil(ceil(rows / 128) / sms)`` units of 128 rows (a big group two),
    the least a walk of whole m-tile pairs allows. fp32: 32-row tiles on at
    most two blocks an SM, their slices of 32 x (768 + 128)."""
    for rows in MLP_ROWS:
        plan = BF.mlp_plan(rows, torch.bfloat16, sms)
        big, groups, slots = plan["big"], plan["groups"], plan["slots"]
        assert big % sms == 0 and big * 256 <= rows
        assert plan["slot_rows"] == (256 if big else 128)
        assert 1 <= slots <= min(sms, groups)
        assert plan["elems"] == slots * plan["slot_rows"] * (768 + 3072)
        covered = np.zeros(rows, dtype=np.int64)
        units = np.zeros(slots, dtype=np.int64)
        for g in range(groups):
            r0, n = _mlp_group(g, rows, big)
            assert 1 <= n <= plan["slot_rows"] and (n == 256) == (g < big)
            covered[r0:r0 + n] += 1
            units[g % slots] += 2 if n > 128 else 1
        assert (covered == 1).all(), rows
        assert units.max() == -(-(-(-rows // 128)) // sms), (rows, plan)
        fp = BF.mlp_plan(rows, torch.float32, sms)
        assert fp["big"] == 0 and fp["slot_rows"] == 32
        assert fp["groups"] == -(-rows // 32)
        assert fp["slots"] == min(fp["groups"], 2 * sms)
        assert fp["elems"] == fp["slots"] * 32 * (768 + 128)


def test_mlp_group_limits_mirror_the_source():
    """K6's plan takes block_fused.cu's limits, which the kernel checks: the
    bf16 groups' rows (``kMlpBigRows``, ``kMlpSmallRows``, the ring's row
    tiles), the fp32 tile (``kMlpRows``, ``kFChunk``), the walk of
    ``mlp_group`` and ``mlp_groups``, and the plan the launch accepts."""
    src = _source("block_fused.cu")
    assert _constant(src, "kMlpBigRows") == BF.MLP_BIG_ROWS == BF.WGMMA_ROWS
    assert _constant(src, "kMlpSmallRows") == BF.MLP_SMALL_ROWS
    assert _constant(src, "kMlpRows") == BF.MLP_TILE_ROWS
    assert _constant(src, "kFChunk") == BF.MLP_F_CHUNK
    assert _constant(_source("halfblock.cuh"), "kBoxRows") == BF.MLP_SMALL_ROWS
    for line in (
            "return big + (rows - big * kMlpBigRows + kMlpSmallRows - 1) / "
            "kMlpSmallRows;",
            "*r0 = g < big ? g * kMlpBigRows : big * kMlpBigRows + "
            "(g - big) * kMlpSmallRows;",
            "*n = g < big ? kMlpBigRows : min(kMlpSmallRows, rows - *r0);",
            "for (int g = blockIdx.x; g < groups; g += gridDim.x) {",
            "(big > 0 && slot_rows != kMlpBigRows) || "
            "(long long)big * kMlpBigRows > rows)",
            "if (slot_rows != kMlpRows || big != 0) return "
            "cudaErrorInvalidValue;"):
        assert line in src, line
    assert "return (long long)kMlpRows * (kE + kFChunk);" in src
    # the walk's group count, from the Python groups
    for rows, sms in ((12_800, 132), (78_848, 132), (1, 7)):
        plan = BF.mlp_plan(rows, torch.bfloat16, sms)
        big = plan["big"]
        assert plan["groups"] == big + (rows - big * 256 + 127) // 128


def _tiny_fused_config():
    cfg = tiny_msclips_config()
    cfg.TPU.USE_FUSED_BLOCK = True  # as bench.py sets it
    return cfg


@pytest.fixture(scope="module")
def tiny_fused():
    cfg = _tiny_fused_config()
    jm = jax_build_model(cfg)
    jp = random_jax_params(jm, seed=0)
    spec = TM.spec_from_config(cfg)
    assert spec.use_fused_block and jm.spec.use_fused_block
    return jm, jp, spec, params_from_jax(jp, spec)


def _inputs(image=64, vocab=512, batch=3):
    rng = np.random.default_rng(42)
    images = rng.standard_normal((batch, image, image, 3)).astype(np.float32)
    tokens = np.zeros((batch, 77), dtype=np.int32)
    for i in range(batch):
        n = int(rng.integers(5, 20))
        tokens[i, 0] = vocab - 2
        tokens[i, 1:n] = rng.integers(1, vocab - 2, n - 1)
        tokens[i, n] = vocab - 1
    return images, tokens


@pytest.mark.parametrize("tower", ["image", "text"])
def test_fused_towers_match_jax(tiny_fused, monkeypatch, tower):
    """Tiny MS-CLIP-S with the switch on, fp32: the port's towers against
    JAX's, whose ``_block_fn`` takes ``fused_block`` with the Pallas kernel
    in interpret mode; every trunk block (image) or text layer (text) goes
    through K5's function once."""
    jm, jp, spec, tp = tiny_fused
    monkeypatch.setattr(JBF, "fused_block", functools.partial(
        JBF.fused_block, interpret=True))
    calls, real = [], BF.fused_attention_halfblock
    monkeypatch.setattr(BF, "fused_attention_halfblock",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    images, tokens = _inputs()
    if tower == "image":
        want = jax.jit(jm.encode_image)(jp, jnp.asarray(images))
        got = TM.encode_image(tp, spec, torch.from_numpy(images))
        n_blocks = spec.effective_vision_layers - spec.first_block
    else:
        want = jax.jit(jm.encode_text)(jp, jnp.asarray(tokens))
        got = TM.encode_text(tp, spec, torch.from_numpy(tokens))
        n_blocks = spec.text_layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert len(calls) == n_blocks


def test_drop_path_takes_the_unfused_block(tiny_fused, monkeypatch):
    """With drop-path active (a rate and a generator) the image tower runs
    ``transformer_block``, as JAX's ``_block_fn`` does."""
    _, _, spec, tp = tiny_fused
    spec = dataclasses.replace(spec, vision_drop_path=0.1)
    calls, real = [], TL.transformer_block
    monkeypatch.setattr(TL, "transformer_block",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    images, _ = _inputs()
    TM.encode_image(tp, spec, torch.from_numpy(images),
                    generator=torch.Generator().manual_seed(0))
    assert len(calls) == spec.effective_vision_layers - spec.first_block


def test_zero_shot_runs_the_fused_path(tmp_path, monkeypatch):
    """``run_zero_shot`` on the CPU with the switch set: the same
    per-image predictions as with it off (fp32: the two blocks agree to
    sums in another order), and K5's function once per block."""
    calls, real = [], BF.fused_attention_halfblock
    monkeypatch.setattr(BF, "fused_attention_halfblock",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    preds = {}
    for fused in (False, True):
        cfg = tiny_msclips_config(layers=4, vocab_size=49408)
        cfg.merge_from_list([
            "DATASET.DATASET", "synthetic", "DATASET.NUM_SAMPLES", 6,
            "TEST.BATCH_SIZE_PER_GPU", 3, "TEST.SUBSET_CLASSES", 3,
            "WORKERS", 1, "MODEL.PRETRAINED_MODEL", "",
            "TEST.SAVE_PRED", str(tmp_path / f"{fused}.npz"),
            "TPU.USE_FUSED_BLOCK", fused])
        calls.clear()
        _, stats = run_zero_shot(cfg, device="cpu")
        assert stats["n_images"] == 6
        # 3 trunk blocks per image batch, 4 text layers per text chunk
        assert len(calls) == (3 * stats["n_image_batches"]
                              + 4 * stats["n_text_chunks"] if fused else 0)
        preds[fused] = np.load(tmp_path / f"{fused}.npz")["pred"]
    np.testing.assert_array_equal(preds[True], preds[False])

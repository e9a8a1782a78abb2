"""The port of the half-block tuning tool (``experiments/halfblock_tuning.py``)
against the JAX script, on the CPU: the plain versions of E1 (every variant
of ``make_attn_half``) and E2 (``core_out_kern``, and the whole
``make_hybrid_b``) against the script's Pallas bodies in interpret mode, on
inputs and weights made with numpy from a seed; the wrappers' dispatch, the
tool's ``main``, and the build's header hashing. The kernels themselves are
checked on the card by ``chip_smoke.py`` and
``tests/test_torch_kernels_gpu.py``."""

import functools
import importlib.util
import os
import shutil
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from msclip_torch.ops import block_fused as BF
from msclip_torch.ops import cuda_build
from msclip_torch.ops import halfblock_tuning as HT
from msclip_torch.tools import halfblock_tuning as tool
from msclip_torch.utils.convert import block_from_jax

from test_torch_block_fused import _jax_block, _port_block, _strict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "experiments", "halfblock_tuning.py")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# fp32: the JAX package's block tolerance (tests/test_kernels.py:250); bf16:
# room for one bf16 ulp of the output (2^-7 relative at most) where an fp32
# sum in another order rounds a q, k, v or context value to its neighbour
TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
       "bfloat16": dict(atol=1e-2, rtol=2e-2)}
# (E, H, L, B, tb): a tiny geometry, and full width at the script's L
GEOMETRIES = {"tiny": (128, 2, 8, 4, 2), "full": (768, 12, 50, 2, 2)}
# chip_smoke.py's bf16 mean limit: 2^-10 mean |branch|
MEAN_LIMIT = 2.0 ** -10


@pytest.fixture(scope="module")
def script():
    """``experiments/halfblock_tuning.py`` loaded by path (its import draws
    the script's full-size input), unchanged on disk."""
    spec = importlib.util.spec_from_file_location("halfblock_tuning_script",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_at(script, monkeypatch):
    """The script with its ``pallas_call`` in interpret mode and its
    geometry globals set to ``(E, H, L, B)``."""
    monkeypatch.setattr(script, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))

    def at(E, H, L, B):
        D = E // H
        for name, value in dict(B=B, Lq=L, E=E, H=H, D=D,
                                SCALE=D ** -0.5).items():
            monkeypatch.setattr(script, name, value)
        return script

    return at


def _case(geometry, dtype, seed):
    E, H, L, B, tb = GEOMETRIES[geometry]
    rng = np.random.default_rng(seed)
    jb = _jax_block(rng, E)  # biases of std 0.1
    x = rng.standard_normal((B, L, E)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    return (jb, block_from_jax(jb), torch.from_numpy(x).to(tdt),
            jnp.asarray(x).astype(jdt), tb)


def _jax_variant(s, variant, jb, jx, tb):
    apply = s.make_attn_half(getattr(s, f"attn_kern_{variant}"), tb)
    return _strict(apply, jx, jb)


def _jax_core_out(s, jx, jqkv, jb, tb):
    """``core_out_kern`` on a given qkv, called as ``make_hybrid_b`` calls
    it."""
    def rows(*shape):
        return pl.BlockSpec(shape, lambda i: (i, 0, 0),
                            memory_space=pltpu.VMEM)

    def apply(x, qkv, blk):
        B, L, E = s.B, s.Lq, s.E
        return s.pl.pallas_call(
            s.core_out_kern, grid=(B // tb,),
            in_specs=[rows(tb, L, E), rows(tb, L, 3 * E),
                      s._full((E, E)), s._full((E,))],
            out_specs=rows(tb, L, E),
            out_shape=jax.ShapeDtypeStruct((B, L, E), x.dtype),
            scratch_shapes=[pltpu.VMEM((tb, L, E), x.dtype)],
        )(x, qkv, blk["attn"]["out_w"].astype(x.dtype), blk["attn"]["out_b"])

    return _strict(apply, jx, jqkv, jb)


def _close(got, want, dtype):
    assert got.dtype == DTYPES[dtype][0]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[dtype])


def _seed(*parts):
    return sum(ord(c) for c in "".join(map(str, parts)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geometry", ["tiny", "full"])
@pytest.mark.parametrize("variant", HT.VARIANTS)
def test_variant_plain_matches_jax_body(jax_at, variant, geometry, dtype):
    """Each E1 variant's plain version against the script's body
    ``attn_kern_<variant>`` through ``make_attn_half``."""
    E, H, L, B, _ = GEOMETRIES[geometry]
    jb, tp, tx, jx, tb = _case(geometry, dtype, _seed(variant, geometry))
    want = _jax_variant(jax_at(E, H, L, B), variant, jb, jx, tb)
    _close(HT.attention_halfblock_variant(tx, tp, variant, tb), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geometry", ["tiny", "full"])
def test_core_out_plain_matches_jax_body(jax_at, geometry, dtype):
    """E2's plain version against ``core_out_kern`` on one shared qkv."""
    E, H, L, B, _ = GEOMETRIES[geometry]
    jb, tp, tx, jx, tb = _case(geometry, dtype, _seed("core", geometry))
    qkv = np.random.default_rng(1).standard_normal((B, L, 3 * E)) \
        .astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    want = _jax_core_out(jax_at(E, H, L, B), jx, jnp.asarray(qkv).astype(jdt),
                         jb, tb)
    got = HT.core_out_halfblock(tx, torch.from_numpy(qkv).to(tdt), tp, tb)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geometry", ["tiny", "full"])
def test_hybrid_b_matches_jax(jax_at, geometry, dtype):
    """The whole ``make_hybrid_b``: LayerNorm, the qkv GEMM outside the
    kernel, then E2."""
    E, H, L, B, _ = GEOMETRIES[geometry]
    jb, tp, tx, jx, tb = _case(geometry, dtype, _seed("hybrid", geometry))
    want = _strict(jax_at(E, H, L, B).make_hybrid_b(tb), jx, jb)
    _close(HT.hybrid_b(tx, tp, tb), want, dtype)


def test_port_keeps_the_variants_rounding_points(jax_at):
    """In bf16 at full width, v1 (the qkv GEMM rounded before its bias)
    and v2 are at least 4x chip_smoke.py's mean limit apart, and the port's
    v1 stands closer to JAX's v1 than to JAX's v2."""
    E, H, L, B, _ = GEOMETRIES["full"]
    jb, tp, tx, jx, tb = _case("full", "bfloat16", 5)
    s = jax_at(E, H, L, B)
    j1, j2 = (np.asarray(_jax_variant(s, v, jb, jx, tb)).astype(np.float32)
              for v in ("v1", "v2"))
    t1 = HT.attention_halfblock_variant(tx, tp, "v1").float().numpy()
    branch = np.abs(j2 - tx.float().numpy()).mean()
    gap = np.abs(j1 - j2).mean()
    assert gap >= 4 * MEAN_LIMIT * branch, (gap, branch)
    assert np.abs(t1 - j1).mean() < np.abs(t1 - j2).mean()


def test_v0_v2_v3_are_one_function():
    _, tp, tx, _, _ = _case("tiny", "bfloat16", 3)
    outs = [HT.attention_halfblock_variant(tx, tp, v) for v in ("v0", "v2",
                                                                "v3")]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_block_from_jax_matches_the_tests_port_block():
    jb = _jax_block(np.random.default_rng(0), 64)
    got, want = block_from_jax(jb), _port_block(jb)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].is_contiguous()
        assert torch.equal(got[k], want[k]), k


def test_cpu_path_is_plain_and_launches_nothing():
    _, tp, tx, _, _ = _case("tiny", "float32", 4)
    qkv = torch.randn(*tx.shape[:2], 3 * tx.shape[-1])
    before = (HT.attention_halfblock_variant.launches,
              HT.core_out_halfblock.launches)
    for v in HT.VARIANTS:
        assert torch.equal(HT.attention_halfblock_variant(tx, tp, v, 1),
                           HT.attention_halfblock_variant_plain(tx, tp, v))
    assert torch.equal(HT.core_out_halfblock(tx, qkv, tp, 2),
                       HT.core_out_plain(tx, qkv, tp))
    assert (HT.attention_halfblock_variant.launches,
            HT.core_out_halfblock.launches) == before


def test_wrappers_refuse_what_they_do_not_take():
    _, tp, tx, _, _ = _case("tiny", "float32", 6)  # B = 4
    qkv = torch.randn(*tx.shape[:2], 3 * tx.shape[-1])
    for tb in (3, 0, 8):
        with pytest.raises(ValueError, match="tb"):
            HT.attention_halfblock_variant(tx, tp, "v2", tb)
        with pytest.raises(ValueError, match="tb"):
            HT.core_out_halfblock(tx, qkv, tp, tb)
    with pytest.raises(ValueError, match="variant"):
        HT.attention_halfblock_variant(tx, tp, "v4")
    with pytest.raises(ValueError, match="multiple of 64"):
        HT.attention_halfblock_variant(tx[..., :100], tp, "v2")
    with pytest.raises(ValueError, match="qkv"):
        HT.core_out_halfblock(tx, qkv[..., :-64], tp)
    with pytest.raises(ValueError, match="no half-block kernel for device"):
        HT.attention_halfblock_variant(tx.to("meta"), tp, "v2")
    with pytest.raises(ValueError, match="no half-block kernel for device"):
        HT.core_out_halfblock(tx.to("meta"), qkv.to("meta"), tp)


@pytest.mark.parametrize("B,L,dtype,sms,want", [
    (256, 50, torch.float32, None, 2), (5, 77, torch.float32, None, 1),
    (3, 50, torch.float32, None, 1), (4, 8, torch.float32, None, 4),
    (6, 30, torch.float32, None, 3), (1, 1, torch.float32, None, 1),
    # bf16: K5's group of at most 256 rows, spread over the card's SMs
    (256, 50, torch.bfloat16, 132, 2), (700, 50, torch.bfloat16, 132, 5),
    (1023, 77, torch.bfloat16, 132, 3), (1024, 77, torch.bfloat16, 132, 2),
    (256, 197, torch.bfloat16, 132, 1), (4, 8, torch.bfloat16, None, 4),
    (6, 30, torch.bfloat16, None, 6)])
def test_default_tb_is_k5s_group_or_a_divisor_of_b(B, L, dtype, sms, want):
    assert HT.default_tb(B, L, dtype, sms) == want


def _e1_walk(B, tb, G):
    """Each sample's count over E1's (and E2's) walk: block b takes
    ``[b tb, (b + 1) tb)`` in groups of ``G``."""
    counts = np.zeros(B, dtype=np.int64)
    for b in range(B // tb):
        end = (b + 1) * tb
        for b0 in range(b * tb, end, G):
            counts[b0:b0 + min(G, end - b0)] += 1
    return counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tuning_blocks_cover_every_sample_once(dtype):
    """E1's and E2's group and workspace reckoning for every B in 1..300 and
    L in 1..256, at the default tile (on 132 SMs, and for any card) and at
    tiles of one sample and of the whole batch: a group fits the block and,
    for E1 in bf16, K5's shared memory; the slices are h and ctx (and fp32
    q/k/v) for E1, ctx for E2; the walk covers every sample exactly once."""
    bf = dtype == torch.bfloat16
    walks = {}
    for L in range(1, 257):
        for B in range(1, 301):
            tbs = {HT.default_tb(B, L, dtype, 132),
                   HT.default_tb(B, L, dtype, None), 1, B}
            for tb in tbs:
                assert B % tb == 0
                G, slot = HT.workspace_elems(B, L, tb, dtype)
                assert 1 <= G <= tb
                if bf:
                    assert G == 1 or (G * L <= 256
                                      and G * BF.padded_len(L) <= 512)
                assert slot == G * L * (2 * 768 + (0 if bf else 192))
                G2, slot2 = HT.workspace_elems(B, L, tb, dtype, core_out=True)
                assert 1 <= G2 <= tb and slot2 == G2 * L * 768
                for g in {G, G2}:
                    if (B, tb, g) not in walks:
                        walks[B, tb, g] = bool((_e1_walk(B, tb, g) == 1).all())
                    assert walks[B, tb, g], (B, L, tb, g)


def _source_group_fits():
    """``bf16_group_fits`` of ``csrc/halfblock.cuh`` as Python, with the
    source's own constants and ``padded_len`` (``csrc/attn_core.cuh``),
    after checking that its body is the one read here."""
    import re

    def read(name):
        with open(os.path.join(cuda_build.CSRC_DIR, name)) as f:
            return f.read()

    half, core = read("halfblock.cuh"), read("attn_core.cuh")
    body = re.search(r"bool bf16_group_fits\(int ns, int L\) \{\s*return ([^;]*);",
                     half).group(1)
    assert " ".join(body.split()) == ("ns == 1 || (ns >= 1 && ns * L <= kWgRows "
                                      "&& ns * padded_len(L) <= kWgTileRows)")
    rows, tile = (int(re.search(rf"constexpr int {n} = (\d+);", half).group(1))
                  for n in ("kWgRows", "kWgTileRows"))
    pad = re.search(r"constexpr int padded_len\(int L\) \{\s*return ([^;]*);",
                    core).group(1)
    steps = [(int(a), int(b)) for a, b in re.findall(r"L <= (\d+) \? (\d+)", pad)]
    last = int(pad.rsplit(":", 1)[1])

    def fits(ns, L):
        lp = next((p for at, p in steps if L <= at), last)
        return ns == 1 or (ns >= 1 and ns * L <= rows and ns * lp <= tile)

    return fits


def test_core_out_bf16_groups_fit_the_source():
    """E2's bf16 group plan for every B in 1..300, L in 1..256 and every tb
    that divides B: the group ``G`` fits ``bf16_group_fits`` as the source
    computes it (which the kernel checks and refuses otherwise), the slice
    is ctx ``[G L, 768]``, a whole number of rows of 768 (the kernel's
    tensor map over the workspace), and the block's walk covers every
    sample exactly once; ``G`` is K5's largest group wherever tb allows."""
    fits = _source_group_fits()
    walks = {}
    for B in range(1, 301):
        tbs = [tb for tb in range(1, B + 1) if B % tb == 0]
        for L in range(1, 257):
            for tb in tbs:
                G, slot = HT.workspace_elems(B, L, tb, torch.bfloat16,
                                             core_out=True)
                assert 1 <= G <= tb and fits(G, L), (B, L, tb, G)
                assert G == min(tb, BF.max_group(L, torch.bfloat16))
                assert slot == G * L * 768 and slot % 768 == 0
                if (B, tb, G) not in walks:
                    walks[B, tb, G] = bool((_e1_walk(B, tb, G) == 1).all())
                assert walks[B, tb, G], (B, L, tb, G)
    assert len(walks) > 1000


def test_tool_main_runs_every_row_on_the_cpu(capsys):
    rows = tool.main(["--device", "cpu", "--batch", "4", "--seq", "8",
                      "--width", "128", "--iters", "2", "--tbs", "1,2",
                      "--dtype", "float32"])
    out = capsys.readouterr().out
    # tbs 1, 2 and the default 4 (K5's group of 16 samples, cut to B)
    want = [f"attn_{v} tb={tb}" for v in HT.VARIANTS for tb in (1, 2, 4)]
    want += [f"hybrid_b tb={tb}" for tb in (1, 2, 4)]
    want += ["k5 fused_attention_halfblock", "unfused half (K1)"]
    assert [r["name"] for r in rows] == want
    assert all(r["launches"] == 0 and r["ms"] > 0 for r in rows)
    for name in want:
        assert f"{name:28s}" in out and "ms/11-layers" in out
    assert "# cpu" in out


def test_tool_main_refuses_a_tile_that_does_not_divide_the_batch():
    with pytest.raises(SystemExit, match="divide"):
        tool.main(["--device", "cpu", "--batch", "4", "--seq", "8",
                   "--width", "128", "--tbs", "3"])


@pytest.mark.parametrize("entry", ["halfblock_tuning", "zero_shot", "train",
                                   "profile_zero_shot", "profile_train",
                                   "export_serving", "serve_bundle",
                                   "serve_live"])
def test_entry_points_default_to_the_card(monkeypatch, tmp_path, entry):
    """Every entry point runs on the card unless asked for the CPU, and
    raises where there is none."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = {"serve_bundle": "serve", "serve_live": "serve"}.get(entry, entry)
    mod = importlib.import_module(f"msclip_torch.tools.{module}")
    cfg = os.path.join(REPO, "msclip_torch", "config",
                       "b32-yfcc-msclips.json")
    argv = {"zero_shot": ["--ds", cfg, "--model", cfg],
            "train": ["--cfg", cfg],
            "export_serving": ["--model", cfg, "--out", str(tmp_path)],
            "serve_bundle": ["--bundle", str(tmp_path)],
            "serve_live": ["--model", cfg]}.get(entry, [])
    with pytest.raises((RuntimeError, SystemExit), match="CUDA device"):
        mod.main(argv)


def test_library_path_hashes_the_shared_headers(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` changes the library path of every source,
    so no stale library of K5 or E1/E2 is loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(csrc))
    sources = ("block_fused.cu", "halfblock_tuning.cu", "attention_fwd.cu")
    before = {s: cuda_build.library_path(s) for s in sources}
    assert before == {s: cuda_build.library_path(s) for s in sources}
    header = csrc / "halfblock.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s: cuda_build.library_path(s) for s in sources}
    assert all(after[s] != before[s] for s in sources)
    assert len(set(after.values())) == len(sources)

"""The port's native JPEG pipeline (``msclip_torch/native``) against the JAX
package's (``msclip_tpu/native``), on the CPU: the same bytes, sizes and
seeds through every entry point of both libraries give the same bytes out;
the build through Pillow's libjpeg-62 gives the system build's bytes; and
the datasets and training transforms that route through it under
``MSCLIP_NATIVE_DECODE=1`` give the JAX package's samples.

The tests skip only where neither of the port's link routes builds (the
reason carries the build error); a comparison that needs the JAX
package's library, or both routes, skips where that one does not build.
"""

import io
import os
import threading

import numpy as np
import pytest

import msclip_tpu.data.datasets as JD
import msclip_tpu.data.pairs as JP
import msclip_tpu.data.shards as JS
from msclip_tpu import native as JN
from msclip_tpu.config import get_default_config as jax_default_config
from msclip_tpu.eval.zero_shot import make_dataset as jax_make_dataset
from msclip_torch import native as N
from msclip_torch.config import get_default_config
from msclip_torch.data import datasets as PD
from msclip_torch.data import pairs as P
from msclip_torch.data import shards as S
from msclip_torch.eval.zero_shot import make_dataset

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
OTHER_MEAN, OTHER_STD = (0.5, 0.4, 0.3), (0.25, 0.3, 0.2)

pytestmark = pytest.mark.skipif(
    not N.native_available(),
    reason=f"no link route of the native pipeline builds: {N.build_error()}")


def _needs_jax_library():
    if not JN.native_available():
        pytest.skip(f"the JAX package's native pipeline did not build: "
                    f"{JN.build_error()}")


def jpeg(w, h, seed, quality=90, subsampling=0, gray=False):
    """A JPEG of smooth random content (bilinear from a coarse grid, as
    ``tests/test_native_pipeline.py``), 4:4:4 (``subsampling=0``) or
    4:2:0 (2), or grayscale."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3), np.uint8)
    img = Image.fromarray(small, "RGB").resize((w, h), Image.BILINEAR)
    if gray:
        img = img.convert("L")
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=quality,
             **({} if gray else {"subsampling": subsampling}))
    return buf.getvalue()


def cases(n=12, seed=0):
    """``n`` JPEGs: sides 40-480 px, quality 50-97, 4:4:4 and 4:2:0, every
    fourth grayscale."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        w, h = (int(v) for v in rng.integers(40, 481, 2))
        out.append(jpeg(w, h, seed=100 + i, quality=int(rng.integers(50, 98)),
                        subsampling=(0, 2)[i % 2], gray=i % 4 == 3))
    return out


def assert_bitwise(got, want):
    """The same shape, dtype and bytes (None where the other is None)."""
    if want is None or got is None:
        assert got is None and want is None, (got is None, want is None)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes(), \
        f"{int((got != want).sum())} of {got.size} values differ"


def _decodes(mod, datas, dct):
    """Every entry point of ``mod`` (the port's or the JAX package's
    ``native``) on ``datas``, as a flat list of arrays."""
    out = []
    for i, d in enumerate(datas):
        size = (32, 48, 224)[i % 3]
        out.append(mod.decode_eval(d, size, MEAN, STD, dct_scale=dct))
        out.append(mod.decode_eval(d, size, OTHER_MEAN, OTHER_STD,
                                   dct_scale=dct))
        out.append(mod.decode_eval_u8(d, size, dct_scale=dct))
        out.append(mod.decode_train(d, size, MEAN, STD, seed=1000 + i,
                                    dct_scale=dct))
        out.append(mod.decode_train(d, 40, OTHER_MEAN, OTHER_STD,
                                    seed=2 ** 63 + 7 * i, scale=(0.3, 0.9),
                                    ratio=(0.5, 2.0), hflip_p=0.7,
                                    dct_scale=dct))
    return out


def truncated(data):
    """``data`` cut inside its header, which libjpeg refuses (a JPEG cut in
    its scan decodes, padded with grey)."""
    return data[:120]


def _batch_inputs():
    """A batch of JPEGs with a PNG and a truncated JPEG among them."""
    from PIL import Image

    datas = cases(6, seed=5)
    png = io.BytesIO()
    Image.fromarray(np.zeros((20, 30, 3), np.uint8)).save(png, "PNG")
    return datas[:2] + [png.getvalue()] + datas[2:4] \
        + [truncated(datas[4])] + datas[5:]


def _batches(mod, dct):
    datas = _batch_inputs()
    a, ok_a = mod.decode_eval_batch(datas, 48, MEAN, STD, n_threads=3,
                                    dct_scale=dct)
    b, ok_b = mod.decode_eval_batch_u8(datas, 48, n_threads=2, dct_scale=dct)
    return [a, ok_a, b, ok_b]


@pytest.mark.parametrize("dct", [False, True])
def test_every_entry_point_equals_the_jax_library_bitwise(dct):
    """``decode_eval`` (two statistics), ``decode_eval_u8``,
    ``decode_train`` (default and other crop, ratio and flip arguments,
    seeds past 2^63), at three sizes, on grayscale, 4:4:4 and 4:2:0
    JPEGs, with the DCT scale off and on: the port's bytes are the JAX
    package's."""
    _needs_jax_library()
    datas = cases()
    got, want = _decodes(N, datas, dct), _decodes(JN, datas, dct)
    assert len(got) == len(want) == 5 * len(datas)
    assert all(g is not None for g in got)
    for g, w in zip(got, want):
        assert_bitwise(g, w)


@pytest.mark.parametrize("dct", [False, True])
def test_batch_entry_points_equal_the_jax_library_bitwise(dct):
    """The batch calls' crops and ok masks, with a PNG and a truncated JPEG
    in the list (ok False, zeros), equal the JAX package's, and each ok
    crop equals the one-image call's."""
    _needs_jax_library()
    got, want = _batches(N, dct), _batches(JN, dct)
    for g, w in zip(got, want):
        assert_bitwise(g, w)
    a, ok_a, b, ok_b = got
    assert ok_a.tolist() == ok_b.tolist() == [True, True, False, True, True,
                                              False, True]
    assert not a[2].any() and not a[5].any() and not b[5].any()
    datas = _batch_inputs()
    for i in np.flatnonzero(ok_b):
        assert_bitwise(b[i], N.decode_eval_u8(datas[i], 48, dct_scale=dct))
    assert N.decode_eval_u8(datas[2], 48) is None  # not a JPEG
    assert N.decode_eval_u8(datas[5], 48) is None  # truncated


def test_a_planted_pixel_fails_the_bitwise_check():
    """The bitwise check sees one value moved by one."""
    d = cases(1)[0]
    got = N.decode_eval_u8(d, 32)
    planted = got.copy()
    planted[7, 3, 1] ^= 1
    assert_bitwise(got, N.decode_eval_u8(d, 32))
    with pytest.raises(AssertionError, match="1 of"):
        assert_bitwise(planted, got)


def test_pillow_route_equals_the_system_route_bitwise(monkeypatch):
    """The library built against Pillow's libjpeg-62 (vendored ABI-62
    headers) decodes every entry point's bytes as the one built against
    the system's ``-ljpeg``."""
    libs = {}
    for route in N.ROUTES:
        try:
            libs[route] = N.bind(N._build(route=route)[0])
        except Exception as e:  # noqa: BLE001
            pytest.skip(f"the {route} route did not build: {e}")
    assert N.pillow_libjpeg() is not None
    assert os.path.basename(N.library_path("pillow")) \
        != os.path.basename(N.library_path("system"))
    datas = cases(9, seed=3)
    outs = {}
    for route, lib in libs.items():
        monkeypatch.setattr(N, "_LIB", lib)
        outs[route] = _decodes(N, datas, False) + _decodes(N, datas, True) \
            + _batches(N, False)
    for g, w in zip(outs["pillow"], outs["system"]):
        assert_bitwise(g, w)


def test_build_names_its_route_and_hashes_its_inputs():
    """The loaded library's route is named; each route has its own file
    under ``msclip_torch/_build``, named by the hash of its inputs."""
    route = N.build_route()
    assert route.split(":")[0] in N.ROUTES
    path = N.library_path(route.split(":")[0])
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(
        os.path.dirname(os.path.dirname(N.__file__)), "_build")
    with pytest.raises(ValueError, match="unknown link route"):
        N.library_path("nope")


def _folder(tmp_path):
    from PIL import Image

    for c, seeds in (("a", (1, 2)), ("b", (3,))):
        os.makedirs(tmp_path / c, exist_ok=True)
        for s in seeds:
            (tmp_path / c / f"{s}.jpg").write_bytes(
                jpeg(60 + 37 * s, 90 - 11 * s, seed=s, subsampling=s % 2 * 2))
    Image.fromarray(np.full((50, 60, 3), 7, np.uint8)).save(
        tmp_path / "b" / "z.png")
    return str(tmp_path)


@pytest.mark.parametrize("u8", ["1", "0"])
def test_image_folder_native_equals_jax(tmp_path, monkeypatch, u8):
    """``ImageFolderDataset(native=True)`` in uint8 and (``MSCLIP_NATIVE_U8
    =0``) fp32, at another size and statistics: the JAX package's samples
    bit for bit, the PNG through the PIL fallback in the same dtype."""
    _needs_jax_library()
    monkeypatch.setenv("MSCLIP_NATIVE_U8", u8)
    root = _folder(tmp_path)
    kw = dict(native=True, image_size=40, mean=OTHER_MEAN, std=OTHER_STD)
    got, want = PD.ImageFolderDataset(root, **kw), \
        JD.ImageFolderDataset(root, **kw)
    assert got.emits_uint8 == want.emits_uint8 == (u8 == "1")
    assert len(got) == len(want) == 4
    for i in range(4):
        (g, gl), (w, wl) = got[i], want[i]
        assert gl == wl
        assert_bitwise(g, w)
    assert got.served == {"native": 3, "pil": 1}


def _eval_cfgs(root):
    out = []
    for c in (get_default_config(), jax_default_config()):
        c.DATASET.DATASET = "imagenet"
        c.DATASET.ROOT = root
        c.DATASET.TEST_SET = "val"
        c.TEST.IMAGE_SIZE = [40, 40]
        c.INPUT.MEAN, c.INPUT.STD = list(OTHER_MEAN), list(OTHER_STD)
        out.append(c)
    return out


def test_make_dataset_native_equals_jax(tmp_path, monkeypatch):
    """``make_dataset`` under ``MSCLIP_NATIVE_DECODE=1``: the native
    ImageFolder at the config's size and statistics, sample for sample the
    JAX package's."""
    _needs_jax_library()
    monkeypatch.setenv("MSCLIP_NATIVE_DECODE", "1")
    root = _folder(tmp_path / "val")
    cfg, jcfg = _eval_cfgs(str(tmp_path))
    got, want = make_dataset(cfg), jax_make_dataset(jcfg)
    assert got.native and got.emits_uint8 and got.image_size == 40
    assert got.mean == OTHER_MEAN and root
    for i in range(len(want)):
        assert_bitwise(got[i][0], want[i][0])


def _train_cfgs():
    from msclip_torch.config import update_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = get_default_config()
    update_config(cfg, os.path.join(repo, "msclip_torch", "config",
                                    "b32-yfcc-msclips.json"))
    cfg.TRAIN.IMAGE_SIZE = [48, 48]
    cfg.AUG.SCALE = [0.2, 0.9]
    jcfg = jax_default_config()
    jcfg.TRAIN.IMAGE_SIZE = [48, 48]
    jcfg.AUG.SCALE = [0.2, 0.9]
    assert list(cfg.AUG.RATIO) == list(jcfg.AUG.RATIO)
    assert list(cfg.INPUT.MEAN) == list(jcfg.INPUT.MEAN)
    return cfg, jcfg


def _same_streams(monkeypatch, seed=21):
    """Both packages' worker streams from one SeedSequence, anew."""
    for mod in (P, JP):
        monkeypatch.setattr(mod, "_RNG_SS", np.random.SeedSequence(seed))
        monkeypatch.setattr(mod, "_RNG_LOCAL", threading.local())


def test_train_transforms_native_equal_jax(tmp_path, monkeypatch):
    """``make_train_transform`` (a path) and ``make_shard_train_transform``
    (bytes) under ``MSCLIP_NATIVE_DECODE=1``, both packages' streams from
    one SeedSequence on one thread: the same seeds are drawn and the same
    crops come out, bit for bit, JPEG after JPEG. A PNG under a ``.jpg``
    name takes PIL from the bytes already read, and a JPEG cut in its
    scan decodes through PIL's tolerance where the library is reported
    unavailable (the PIL draws come from the worker stream in the port,
    from OS entropy in JAX's, so only their shape is held)."""
    from PIL import Image

    _needs_jax_library()
    monkeypatch.setenv("MSCLIP_NATIVE_DECODE", "1")
    cfg, jcfg = _train_cfgs()
    datas = cases(6, seed=9)
    paths = []
    for i, d in enumerate(datas):
        p = tmp_path / f"{i}.jpg"
        p.write_bytes(d)
        paths.append(str(p))
    _same_streams(monkeypatch)
    ours, theirs = P.make_train_transform(cfg), JP.make_train_transform(jcfg)
    assert ours.takes_path and theirs.takes_path
    for p in paths:
        assert_bitwise(ours(p), theirs(p))
    _same_streams(monkeypatch, seed=22)
    ours, theirs = S.make_shard_train_transform(cfg), \
        JS.make_shard_train_transform(jcfg)
    assert ours.takes_bytes and theirs.takes_bytes
    for d in datas:
        assert_bitwise(ours(d), theirs(d))
    png = tmp_path / "png.jpg"
    Image.fromarray(np.full((30, 40, 3), 9, np.uint8)).save(png, "PNG")
    assert P.make_train_transform(cfg)(str(png)).shape == (48, 48, 3)
    assert ours(png.read_bytes()).shape == (48, 48, 3)
    cut = tmp_path / "cut.jpg"
    cut.write_bytes(datas[0][:len(datas[0]) // 2])
    monkeypatch.setattr(N, "_load", lambda: None)
    assert P.make_train_transform(cfg)(str(cut)).shape == (48, 48, 3)
    assert S.make_shard_train_transform(cfg)(cut.read_bytes()).shape \
        == (48, 48, 3)


def test_pair_datasets_native_equal_jax(tmp_path, monkeypatch):
    """The TSV and folder pair datasets hand the path-taking transform
    their paths (``takes_path``), and the tar-shard dataset hands its
    bytes transform the member's bytes (``takes_bytes``), as the JAX
    package's: the same samples under one stream."""
    _needs_jax_library()
    from msclip_tpu.data.tokenizer import ClipTokenizer as JaxTokenizer
    from msclip_torch.data.tokenizer import ClipTokenizer

    from torch_pair_fixtures import write_folder, write_shards, write_tsv

    monkeypatch.setenv("MSCLIP_NATIVE_DECODE", "1")
    cfg, jcfg = _train_cfgs()
    tok, jtok = ClipTokenizer(), JaxTokenizer()
    for kind, where in (("folder", write_folder(str(tmp_path / "f"), 3)),
                        ("tsv", write_tsv(str(tmp_path / "t"), 3, seed=1)),
                        ("shards", write_shards(str(tmp_path / "s"), 1, 3,
                                                seed=2))):
        _same_streams(monkeypatch)
        if kind == "folder":
            got = P.FolderPairDataset(where, tok, 77,
                                      P.make_train_transform(cfg))
            want = JP.FolderPairDataset(where, jtok, 77,
                                        JP.make_train_transform(jcfg))
        elif kind == "tsv":
            got = P.TsvPairDataset([where], tok, 77,
                                   P.make_train_transform(cfg))
            want = JP.TsvPairDataset([where], jtok, 77,
                                     JP.make_train_transform(jcfg))
        else:
            got = S.TarShardPairDataset(where, tok, 77,
                                        S.make_shard_train_transform(cfg))
            want = JS.TarShardPairDataset(
                where, jtok, 77, JS.make_shard_train_transform(jcfg))
        for i in range(len(want)):
            (gi, gt), (wi, wt) = got[i], want[i]
            assert_bitwise(gi, wi)
            np.testing.assert_array_equal(gt, wt)

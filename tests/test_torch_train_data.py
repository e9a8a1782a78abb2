"""The port's training data path against the JAX package's, on the CPU:
the samplers, the loader's order with stripes and fast-forward, the train
transforms (host and tensor), mixup/cutmix, and the TSV, folder and
tar-shard pair datasets with their shard index caches."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msclip_tpu.data import loader as JLD
from msclip_tpu.data import pairs as JP
from msclip_tpu.data import shards as JS
from msclip_tpu.data import transforms as JT
from msclip_torch.config import get_default_config, update_config
from msclip_torch.data import loader as LD
from msclip_torch.data import pairs as P
from msclip_torch.data import shards as S
from msclip_torch.data import transforms as T
from msclip_torch.data.tokenizer import ClipTokenizer

from torch_pair_fixtures import pair, write_folder, write_shards, write_tsv
from torch_threads import one_torch_thread  # noqa: F401


class _Indexed:
    """A dataset whose sample ``i`` is ``(i, label_i)``."""

    def __init__(self, n, n_classes=3):
        self.samples = [(i, (i * 7) % n_classes) for i in range(n)]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return np.full((2, 2, 3), i, np.float32), self.samples[i][1]


# ---------------------------------------------------------------------------
# samplers and loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampler,shuffle,n", [
    ("default", False, 11), ("default", True, 11), ("class_aware", True, 23),
    ("chunk", True, 23), ("chunk", False, 0)])
@pytest.mark.parametrize("seed", [0, 7])
def test_sampler_order_matches_jax(sampler, shuffle, n, seed):
    labels = [(i * 5) % 4 for i in range(n)] if sampler == "class_aware" \
        else None
    kw = dict(shuffle=shuffle, seed=seed, labels=labels, chunk_size=4)
    np.testing.assert_array_equal(LD.sampler_order(n, sampler, **kw),
                                  JLD.sampler_order(n, sampler, **kw))


def test_sampler_order_rejects_what_jax_rejects():
    for kw in ({"sampler": "class_aware"}, {"sampler": "nope"}):
        with pytest.raises(ValueError):
            LD.sampler_order(5, **kw)
        with pytest.raises(ValueError):
            JLD.sampler_order(5, **kw)


@pytest.mark.parametrize("sampler", ["default", "class_aware", "chunk"])
@pytest.mark.parametrize("shard,equal,drop", [
    ((0, 1), False, True), ((1, 3), True, True), ((2, 3), False, False),
    ((0, 4), True, False)])
def test_loader_order_stripes_and_fast_forward_match_jax(sampler, shard,
                                                         equal, drop):
    """Two pinned epochs, the second fast-forwarded by one batch, then a
    bare epoch: the same batches, masks and batch counts."""
    ds = _Indexed(22)
    kw = dict(workers=2, shuffle=True, seed=3, drop_last=drop, shard=shard,
              sampler=sampler, chunk_size=5, equal_shards=equal)
    ours, theirs = LD.BatchLoader(ds, 3, **kw), JLD.BatchLoader(ds, 3, **kw)
    assert ours.num_batches == theirs.num_batches == len(ours)
    for epoch, skip in ((0, 0), (4, 1), (None, 0)):
        if epoch is not None:
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
        ours.fast_forward(skip)
        theirs.fast_forward(skip)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == ours.num_batches - skip
        for a, b in zip(got, want):
            for key in ("image", "label", "mask"):
                np.testing.assert_array_equal(a[key], b[key])


def test_pair_loader_is_the_jax_drivers():
    """``BatchLoaderPairs`` takes ``tools/train.py:302``'s settings: drop
    the ragged batch, equal stripes; ``tokens`` are the labels."""
    ds = P.SyntheticPairDataset(n=11, size=8, vocab_size=64)
    ours = LD.BatchLoaderPairs(ds, 2, workers=1, seed=2, sampler="chunk")
    theirs = JLD.BatchLoader(ds, 2, workers=1, shuffle=True, seed=2,
                             drop_last=True, shard=(0, 1), sampler="chunk",
                             equal_shards=True)
    ours.fast_forward(2)
    theirs.fast_forward(2)
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["tokens"], b["label"])
        np.testing.assert_array_equal(a["image"], b["image"])


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,seed", [((57, 91), 0), ((120, 40), 1),
                                       ((300, 3), 2), ((33, 33), 3)])
def test_pil_train_transform_matches_jax(size, seed):
    """One Generator each, seeded alike: the same array, bit for bit (the
    300 x 3 image takes the clamped-ratio fallback)."""
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 256, (*size[::-1], 3),
                                               dtype=np.uint8)
    img = Image.fromarray(arr).convert("L" if seed == 3 else "RGB")
    for _ in range(3):
        got = T.pil_train_transform(img, size=32,
                                    rng=np.random.default_rng(seed + 9))
        want = JT.pil_train_transform(img, size=32,
                                      rng=np.random.default_rng(seed + 9))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("box", [(0, 0, 20, 30), (5, 7, 3, 11), (10, 2, 1, 1),
                                 (0, 0, 40, 48), (13, 30, 27, 18)])
def test_bilinear_crop_resize_matches_jax(box):
    rng = np.random.default_rng(sum(box))
    img = rng.random((40, 48, 3)).astype(np.float32)
    want = JT.bilinear_crop_resize(jnp.asarray(img), *box, 24)
    got = T.bilinear_crop_resize(torch.from_numpy(img), *box, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 37, 60), (1, 224, 224), (2, 300, 80)])
def test_device_preprocess_matches_jax(shape):
    """``jax.image.resize``'s antialiased bicubic, up and down."""
    rng = np.random.default_rng(shape[1])
    u8 = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    want = JT.device_preprocess(jnp.asarray(u8), size=32)
    got = T.device_preprocess(torch.from_numpy(u8), size=32)
    assert got.shape == tuple(want.shape) == (shape[0], 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_random_resized_crop_params_semantics():
    """Every box inside the image, of RandomResizedCrop's areas and
    aspect ratios where an attempt fit; the fallback box otherwise."""
    gen = torch.Generator().manual_seed(0)
    y0, x0, ch, cw = T.random_resized_crop_params(gen, 4096, 40, 60)
    for v in (y0, x0, ch, cw):
        assert v.dtype == torch.int32 and v.shape == (4096,)
    assert (y0 >= 0).all() and (x0 >= 0).all()
    assert (y0 + ch <= 40).all() and (x0 + cw <= 60).all()
    area = (ch * cw).float() / (40 * 60)
    assert area.min() >= 0.07 and area.max() <= 1.0
    ar = cw.float() / ch.float()
    assert ar.min() > 0.7 and ar.max() < 1.45
    # a strip no attempt fits: every sample takes the center fallback
    y0, x0, ch, cw = T.random_resized_crop_params(gen, 8, 200, 2)
    assert (cw == 2).all() and (ch == 3).all() and (y0 == 98).all() \
        and (x0 == 0).all()


def test_train_augment_shapes_flips_and_stats():
    gen = torch.Generator().manual_seed(1)
    u8 = torch.full((64, 20, 30, 3), 128, dtype=torch.uint8)
    u8[:, :, :15] = 0  # left half dark: a flip moves it right
    out = T.train_augment(gen, u8, size=16)
    assert out.shape == (64, 16, 16, 3) and out.dtype == torch.float32
    left = out[:, :, :4, 0].mean(dim=(1, 2))
    right = out[:, :, -4:, 0].mean(dim=(1, 2))
    flipped = (left > right).float().mean().item()
    assert 0.25 < flipped < 0.75


def _jax_mixup(key, images, labels, **kw):
    return JT.mixup_cutmix(key, jnp.asarray(images), jnp.asarray(labels),
                           10, **kw)


@pytest.mark.parametrize("mode", ["mixup", "cutmix", "both"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixup_cutmix_blend_matches_jax(mode, seed):
    """JAX's draws read back from its output (lambda from the soft labels,
    the cutmix box from the pixels that changed), then the port's blend
    with those draws: the same images and soft labels."""
    rng = np.random.default_rng(seed)
    images = rng.random((6, 12, 14, 3)).astype(np.float32) + 1.0
    labels = rng.integers(0, 10, 6)
    kw = {"mixup": dict(mixup_alpha=0.8), "cutmix": dict(cutmix_alpha=1.0),
          "both": dict(mixup_alpha=0.8, cutmix_alpha=1.0)}[mode]
    mixed, soft = (np.asarray(v) for v in _jax_mixup(
        jax.random.PRNGKey(seed), images, labels, label_smoothing=0.1,
        **kw))
    changed = np.any(mixed != images, axis=(0, 3))
    # lambda at a sample whose label differs from the one it mixes with
    i = next(j for j in range(6) if labels[j] != labels[j - 1])
    lam = float((soft[i, labels[i]] - 0.01) / 0.9)
    cut = np.array_equal(mixed[:, ~changed], images[:, ~changed]) and \
        changed.any() and np.array_equal(
            mixed[:, changed], np.roll(images, 1, 0)[:, changed])
    if cut:
        ys, xs = np.nonzero(changed)
        params = {"cut": True, "lam": None, "box": (
            ys.min(), ys.max() + 1, xs.min(), xs.max() + 1)}
    else:
        params = {"cut": False, "lam": lam, "box": None}
    got, got_soft = T.mixup_cutmix_apply(
        torch.from_numpy(images), torch.from_numpy(labels), 10, params,
        label_smoothing=0.1)
    np.testing.assert_allclose(got.numpy(), mixed, atol=1e-6)
    np.testing.assert_allclose(got_soft.numpy(), soft, atol=1e-6)


def test_mixup_cutmix_draws_follow_their_distributions():
    gen = torch.Generator().manual_seed(0)
    draws = [T.mixup_cutmix_params(gen, (4, 32, 32, 3), 0.8, 1.0, 0.3)
             for _ in range(3000)]
    cuts = [d for d in draws if d["cut"]]
    assert abs(len(cuts) / 3000 - 0.3) < 0.03
    lams = np.array([d["lam"] for d in draws if not d["cut"]])
    assert abs(lams.mean() - 0.5) < 0.02  # Beta(0.8, 0.8)
    assert abs(lams.var() - 0.25 / 2.6) < 0.01
    for d in cuts:
        y0, y1, x0, x1 = d["box"]
        assert 0 <= y0 <= y1 <= 32 and 0 <= x0 <= x1 <= 32
    assert T.mixup_cutmix_params(gen, (4, 32, 32, 3)) is None
    images = torch.rand(4, 8, 8, 3)
    same, soft = T.mixup_cutmix(gen, images, torch.tensor([0, 1, 2, 3]), 5)
    assert same is images and torch.equal(soft, torch.eye(5)[:4])


# ---------------------------------------------------------------------------
# pair datasets
# ---------------------------------------------------------------------------

def _train_cfg():
    cfg = get_default_config()
    update_config(cfg, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "msclip_torch", "config", "b32-yfcc-msclips.json"))
    cfg.TRAIN.IMAGE_SIZE = [32, 32]
    return cfg


@pytest.fixture(scope="module")
def tokenizer():
    from msclip_tpu.data.tokenizer import ClipTokenizer as JaxTokenizer

    return ClipTokenizer(), JaxTokenizer()


@pytest.fixture(scope="module")
def pairs_on_disk(tmp_path_factory):
    root = tmp_path_factory.mktemp("pairs")
    return {"folder": write_folder(str(root / "folder"), 5, seed=1),
            "tsv": write_tsv(str(root / "tsv"), 5, seed=2),
            "shards": write_shards(str(root / "shards"), 2, 3, seed=3)}


def _datasets(kind, where, toks, ours_tf, theirs_tf):
    ours_tok, jax_tok = toks
    if kind == "folder":
        return (P.FolderPairDataset(where, ours_tok, 77, ours_tf),
                JP.FolderPairDataset(where, jax_tok, 77, theirs_tf))
    if kind == "tsv":
        return (P.TsvPairDataset([where], ours_tok, 77, ours_tf),
                JP.TsvPairDataset([where], jax_tok, 77, theirs_tf))
    return (S.TarShardPairDataset(where, ours_tok, 77, ours_tf),
            JS.TarShardPairDataset(where, jax_tok, 77, theirs_tf))


@pytest.mark.parametrize("kind", ["folder", "tsv", "shards"])
@pytest.mark.parametrize("transform", ["eval", "train"])
def test_pair_datasets_match_jax(pairs_on_disk, tokenizer, kind, transform):
    """The same samples in the same order: with the eval transform, and
    with the train transform drawn from one Generator a package in one
    thread (the driver's draws come from per-thread streams)."""
    if transform == "eval":
        ours_tf, theirs_tf = T.pil_eval_transform, JT.pil_eval_transform
    else:
        ours_tf = P.make_train_transform(_train_cfg(),
                                         rng=np.random.default_rng(5))
        theirs_tf = functools.partial(JT.pil_train_transform, size=32,
                                      rng=np.random.default_rng(5))
    ours, theirs = _datasets(kind, pairs_on_disk[kind], tokenizer, ours_tf,
                             theirs_tf)
    assert len(ours) == len(theirs) == (6 if kind == "shards" else 5)
    for i in range(len(ours)):
        (a_img, a_tok), (b_img, b_tok) = ours[i], theirs[i]
        assert a_img.dtype == b_img.dtype and a_tok.dtype == b_tok.dtype
        np.testing.assert_array_equal(a_img, b_img)
        np.testing.assert_array_equal(a_tok, b_tok)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shard_index_cache_is_shared_with_jax(tmp_path, tokenizer, writer):
    """The ``<shard>.idx.npz`` one package writes is the one the other
    reads (its records, not a rebuild: a planted record shows through)."""
    paths = write_shards(str(tmp_path), 2, 4, seed=4)
    first = (JS if writer == "jax" else S)._cached_index(paths[0])
    z = dict(np.load(paths[0] + ".idx.npz"))
    assert z["rec"].shape == (4, 4)
    np.testing.assert_array_equal(z["rec"], first)
    np.testing.assert_array_equal(S._index_shard(paths[0]),
                                  JS._index_shard(paths[0]))
    z["rec"] = z["rec"][::-1].copy()  # planted: the reader must return it
    np.savez(paths[0] + ".idx.npz", **z)
    reader = S if writer == "jax" else JS
    np.testing.assert_array_equal(reader._cached_index(paths[0]),
                                  z["rec"])
    ds = S.TarShardPairDataset([str(tmp_path / "shard-*.tar")], tokenizer[0])
    assert len(ds) == 8 and ds.chunk_starts == [0, 4]


def test_train_dataset_refuses_native_decode(pairs_on_disk, monkeypatch):
    """MSCLIP_NATIVE_DECODE=1 no longer raises: the shard and TSV train
    datasets decode their JPEGs with the native pipeline (fp32 crops of
    TRAIN.IMAGE_SIZE, normalized; a seeded bicubic crop, which the PIL
    transform's bilinear one does not reproduce), and with the library
    reported unavailable they take PIL: the TSV's sample is then the PIL
    transform's on the same stream of draws."""
    import threading

    from msclip_torch import native as N

    def first_sample(native, available=True):
        with monkeypatch.context() as m:
            m.setattr(P, "_RNG_LOCAL", threading.local())
            m.setattr(P, "_RNG_SS", np.random.SeedSequence(11))
            if not available:
                m.setattr(N, "_load", lambda: None)
            if native:
                m.setenv("MSCLIP_NATIVE_DECODE", "1")
            else:
                m.delenv("MSCLIP_NATIVE_DECODE", raising=False)
            return P.make_train_dataset(cfg)[0][0]

    cfg = _train_cfg()
    for key, value in (("TRAIN_SHARD_LIST", pairs_on_disk["shards"]),
                       ("TRAIN_TSV_LIST", [pairs_on_disk["tsv"]])):
        cfg.DATASET.TRAIN_SHARD_LIST, cfg.DATASET.TRAIN_TSV_LIST = [], []
        cfg.DATASET[key] = value
        plain = first_sample(False)
        fallback = first_sample(True, available=False)
        assert fallback.shape == (32, 32, 3) and fallback.dtype == np.float32
        if key == "TRAIN_TSV_LIST":  # no seed drawn without the library
            np.testing.assert_array_equal(fallback, plain)
        if N.native_available():
            native = first_sample(True)
            assert native.shape == (32, 32, 3) and native.dtype == np.float32
            assert not np.array_equal(native, plain)
    if not N.native_available():
        pytest.skip(f"the native pipeline did not build: {N.build_error()}")


def test_worker_rng_is_one_stream_per_thread():
    import io
    import threading

    from PIL import Image

    seen = []

    def draw():
        seen.append((P._worker_rng(), P._worker_rng()))

    threads = [threading.Thread(target=draw) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(a is b for a, b in seen)
    assert len({id(a) for a, _ in seen}) == 3
    # the train transform draws from the calling thread's stream
    data, _ = pair(np.random.default_rng(0))
    out = P.make_train_transform(_train_cfg())(Image.open(io.BytesIO(data)))
    assert out.shape == (32, 32, 3) and out.dtype == np.float32


def test_worker_rng_follows_msclip_seed():
    import subprocess
    import sys

    code = ("from msclip_torch.data.pairs import _worker_rng; "
            "print(_worker_rng().integers(0, 2 ** 62, 4).tolist())")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = [subprocess.run([sys.executable, "-c", code], cwd=repo,
                           env=dict(os.environ, MSCLIP_SEED=seed),
                           capture_output=True, text=True, check=True).stdout
            for seed in ("3", "3", "4")]
    assert runs[0] == runs[1] != runs[2]

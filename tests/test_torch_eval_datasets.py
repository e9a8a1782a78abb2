"""The port's eval datasets against the JAX package's, on the CPU.

For each of the 24 transfer-suite loaders (the 21 of
``data/probe_datasets.py`` and VOC2007, HatefulMemes, ChestXRay8 of
``data/datasets.py``), a fixture in the dataset's real on-disk layout goes
through both packages: the same length, classes, labels and split
membership, the same decoded pixels for every sample, and the eval
transform's output bit for bit for the first samples of each split. Then
``make_dataset``'s routing, as tests/test_eval.py holds the JAX one."""


import numpy as np
import pytest

import msclip_tpu.data.datasets as JD
import msclip_tpu.data.probe_datasets as JP
from msclip_torch.config import get_default_config
from msclip_torch.data import datasets as PD
from msclip_torch.data import probe_datasets as PP
from msclip_torch.eval.zero_shot import make_dataset

from torch_transfer_fixtures import FIXTURES, save_image

CUSTOM = {"voc2007classification": "Voc2007Classification",
          "hatefulmemes": "HatefulMemes", "chestxray8": "ChestXRay8"}


def _cheap(img):
    # the decoded pixels themselves, without the 224 px bicubic resize
    return np.asarray(img.convert("RGB"), np.float32)[:8, :8] / 255.0


def _build(datasets, probe, name, root, split, transform=None):
    if name in CUSTOM:
        return getattr(datasets, CUSTOM[name])(root, image_set=split,
                                               transform=transform)
    return probe.build_probe_dataset(name, root, split, transform=transform)


def _members(ds):
    """The split's sample identities (paths, ids or records), where the
    loader keeps them as a list."""
    for attr in ("samples", "images", "records"):
        got = getattr(ds, attr, None)
        if isinstance(got, list):
            return got
    return None


def test_every_loader_has_a_fixture():
    assert set(PP.PROBE_DATASETS) == set(JP.PROBE_DATASETS)
    assert set(FIXTURES) == set(JP.PROBE_DATASETS) | set(CUSTOM)
    assert len(FIXTURES) == 24


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_loader_matches_jax(name, tmp_path):
    root, splits = FIXTURES[name](str(tmp_path / "data"))
    for split in splits:
        port = _build(PD, PP, name, root, split, _cheap)
        jax_ds = _build(JD, JP, name, root, split, _cheap)
        assert len(port) == len(jax_ds) > 0, (name, split)
        assert getattr(port, "classes", None) == getattr(jax_ds, "classes",
                                                         None)
        assert _members(port) == _members(jax_ds)
        for i in range(len(port)):
            (pi, pl), (ji, jl) = port[i], jax_ds[i]
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_array_equal(pl, jl)
        # the eval transform of both packages, bit for bit
        port = _build(PD, PP, name, root, split)
        jax_ds = _build(JD, JP, name, root, split)
        for i in range(min(2, len(port))):
            got, want = port[i][0], jax_ds[i][0]
            assert got.dtype == want.dtype == np.float32
            assert got.shape == (224, 224, 3)
            np.testing.assert_array_equal(got, want)


def test_hash_split_is_the_jax_split(tmp_path):
    """The crc32 80/20 split of EuroSAT and KITTI: each file on the same
    side in both packages, both sides non-empty, nothing lost."""
    from torch_transfer_fixtures import eurosat, kitti_distance

    for build, name in ((eurosat, "eurosat"),
                        (kitti_distance, "kitti-distance")):
        root, _ = build(str(tmp_path / name))
        sides = {}
        for split in ("train", "test"):
            p = PP.build_probe_dataset(name, root, split, transform=_cheap)
            j = JP.build_probe_dataset(name, root, split, transform=_cheap)
            assert p.samples == j.samples
            sides[split] = {s for s, _ in p.samples}
        assert sides["train"] and sides["test"]
        assert not sides["train"] & sides["test"]
    for key in ("Forest/Forest_000.jpg", "000003", "abc"):
        assert PP._crc_split(key, 80) == JP._crc_split(key, 80)


def test_scan_image_folder_skip(tmp_path):
    for cls in ("a", "skipme", "b"):
        save_image(str(tmp_path / cls / "0.jpg"))
    got = PD.scan_image_folder(str(tmp_path), skip=("skipme",))
    assert got == JD.scan_image_folder(str(tmp_path), skip=("skipme",))
    assert got[1] == ["a", "b"]


def _cfg():
    cfg = get_default_config()
    cfg.TEST.IMAGE_SIZE = [32, 32]
    cfg.TRAIN.IMAGE_SIZE = [32, 32]
    return cfg


def test_make_dataset_image_set_routing(tmp_path):
    """ImageFolder TRAIN_SET/TEST_SET dirs, HatefulMemes' test -> val,
    the synthetic splits' seeds, the probe registry's image_set and the
    custom loaders, as the JAX package routes them."""
    from msclip_tpu.config import get_default_config as jax_default_config
    from msclip_tpu.eval.zero_shot import make_dataset as jax_make_dataset

    cfg = _cfg()
    for split, n in (("tr", 3), ("va", 2)):
        for i in range(n):
            save_image(str(tmp_path / "folder" / split / "classA" /
                           f"{i}.jpg"), i)
    cfg.DATASET.DATASET = "imagefolder"
    cfg.DATASET.ROOT = str(tmp_path / "folder")
    cfg.DATASET.TRAIN_SET, cfg.DATASET.TEST_SET = "tr", "va"
    assert len(make_dataset(cfg, image_set="train")) == 3
    assert len(make_dataset(cfg, image_set="test")) == 2

    cfg.DATASET.DATASET = "synthetic"
    ds_tr = make_dataset(cfg, image_set="train")
    ds_te = make_dataset(cfg, image_set="test")
    assert ds_te._rng_seed == 0 and ds_tr._rng_seed == 10_000
    jcfg = jax_default_config()
    jcfg.TEST.IMAGE_SIZE = [32, 32]
    jcfg.DATASET.DATASET = "synthetic"
    for split, ds in (("train", ds_tr), ("test", ds_te)):
        want = jax_make_dataset(jcfg, image_set=split)
        for i in (0, 5):
            np.testing.assert_array_equal(ds[i][0], want[i][0])
            assert ds[i][1] == want[i][1]

    for name in ("eurosat", "hatefulmemes", "voc2007classification",
                 "chestxray8", "caltech-101"):
        root, _ = FIXTURES[name](str(tmp_path / name))
        cfg.DATASET.DATASET = jcfg.DATASET.DATASET = name
        cfg.DATASET.ROOT = jcfg.DATASET.ROOT = root
        for split in ("train", "test"):
            if name == "voc2007classification" and split == "train":
                continue  # the fixture holds the test split only
            got = make_dataset(cfg, image_set=split)
            want = jax_make_dataset(jcfg, image_set=split)
            assert type(got).__name__ == type(want).__name__
            assert len(got) == len(want) > 0, (name, split)
            np.testing.assert_array_equal(got[0][0], want[0][0])
    # hatefulmemes' test split is its labeled dev split
    cfg.DATASET.DATASET = "hatefulmemes"
    cfg.DATASET.ROOT = str(tmp_path / "hatefulmemes")
    assert len(make_dataset(cfg, image_set="test")) == 8
    assert len(make_dataset(cfg, image_set="train")) == 4


def test_native_decode_raises(tmp_path, monkeypatch):
    """MSCLIP_NATIVE_DECODE=1 no longer raises: ``make_dataset`` gives the
    ImageFolder eval the native pipeline at the config's size, which
    serves its JPEG (uint8, normalized on the device), while a PNG, and
    every file where the library is reported unavailable, takes PIL in the
    same dtype."""
    from msclip_torch import native as N
    from msclip_torch.data.transforms import pil_eval_uint8

    save_image(str(tmp_path / "val" / "c" / "0.jpg"))
    save_image(str(tmp_path / "val" / "c" / "1.png"), seed=1)
    cfg = _cfg()
    cfg.DATASET.DATASET = "imagenet"
    cfg.DATASET.ROOT = str(tmp_path)
    monkeypatch.setenv("MSCLIP_NATIVE_DECODE", "1")
    with monkeypatch.context() as m:
        m.setattr(N, "_load", lambda: None)
        ds = make_dataset(cfg)
        assert ds.native and ds.emits_uint8 and ds.image_size == 32
        imgs = [ds[i][0] for i in range(2)]
        assert ds.served == {"native": 0, "pil": 2}
    for img, path in zip(imgs, (ds.samples[0][0], ds.samples[1][0])):
        assert img.dtype == np.uint8 and img.shape == (32, 32, 3)
        np.testing.assert_array_equal(img, pil_eval_uint8(
            PD._load_image(path), 32))
    if not N.native_available():
        pytest.skip(f"the native pipeline did not build: {N.build_error()}")
    ds = make_dataset(cfg)
    img = ds[0][0]
    assert img.dtype == np.uint8 and img.shape == (32, 32, 3)
    assert ds[1][0].dtype == np.uint8
    assert ds.served == {"native": 1, "pil": 1}
    monkeypatch.delenv("MSCLIP_NATIVE_DECODE")
    ds = make_dataset(cfg)
    assert not ds.native and ds[0][0].dtype == np.float32
    assert ds.served == {"native": 0, "pil": 1}


def test_karpathy_split_matches_jax(tmp_path):
    from msclip_tpu.data.retrieval_datasets import \
        load_karpathy_split as jax_load
    from msclip_torch.data.retrieval_datasets import load_karpathy_split

    from torch_transfer_fixtures import karpathy

    images, ann = karpathy(str(tmp_path))
    for split in ("test", "train"):
        got = load_karpathy_split(images, ann, split=split, transform=_cheap)
        want = jax_load(images, ann, split=split, transform=_cheap)
        assert got[0].paths == want[0].paths
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[0][0][0], want[0][0][0])
    assert len(load_karpathy_split(images, ann, "train")[0]) == 2
    with pytest.raises(ValueError, match="no images"):
        load_karpathy_split(images, ann, split="val")

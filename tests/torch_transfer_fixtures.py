"""On-disk fixtures of the 24 transfer-suite datasets, each in its public
distribution's layout (after the recipes of tests/test_probe_datasets.py
and tests/test_eval_datasets.py), and the tiny MS-CLIP-S checkpoint the
transfer tests of msclip_torch share with the JAX package.

``FIXTURES[name](root)`` writes dataset ``name`` under ``root`` and returns
``(data_root, splits)``: the root its loader takes and the splits it has.
"""

import csv
import gzip
import json
import os
import pickle
import struct

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_YAML = os.path.join(REPO, "experiments", "model",
                          "b32-yfcc-msclips.yaml")
# MS-CLIP-S cut to width 128 and 6 layers (tests/test_torch_zero_shot.py)
TINY_OPTS = [
    "TRAIN.IMAGE_SIZE", "[64,64]", "TEST.IMAGE_SIZE", "[64,64]",
    "TEST.BATCH_SIZE_PER_GPU", "4",
    "MODEL.SPEC.VISION.WIDTH", "128", "MODEL.SPEC.VISION.LAYERS", "6",
    "MODEL.SPEC.TEXT.WIDTH", "128", "MODEL.SPEC.TEXT.HEADS", "2",
    "MODEL.SPEC.TEXT.LAYERS", "6", "MODEL.SPEC.EMBED_DIM", "32",
    "WORKERS", "2",
]
# real class names: the loaders without a prompt set of their own fall back
# to their classes under the ImageNet templates, and numeric names refuse
CALTECH_CLASSES = ("accordion", "airplanes", "anchor")


def save_image(path, seed=0, size=(20, 24)):
    """A random RGB image of coarse colour blocks (they differ at the
    stem's scale), saved in the format the extension names."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = size
    arr = np.kron(rng.random((max(h // 8, 1), max(w // 8, 1), 3)),
                  np.ones((8, 8, 1)))[:h, :w]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)


def _sized(i):
    return (40 + 7 * (i % 9), 40 + 11 * (i % 7))


def cifar10(root, n_train=(4, 3, 2, 2, 2), n_test=5, seed=0):
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for name, n in zip(names, list(n_train) + [n_test]):
        data = {b"data": rng.integers(0, 256, (n, 3072), np.uint8),
                b"labels": [int(v) for v in rng.integers(0, 10, n)]}
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump(data, f)
    return str(root), ("train", "test")


def cifar100(root):
    rng = np.random.default_rng(1)
    d = os.path.join(root, "cifar-100-python")
    os.makedirs(d, exist_ok=True)
    for name, n in (("train", 6), ("test", 4)):
        data = {b"data": rng.integers(0, 256, (n, 3072), np.uint8),
                b"fine_labels": [int(v) for v in rng.integers(0, 100, n)]}
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump(data, f)
    return str(root), ("train", "test")


def _write_idx(path, arr, gz=False):
    body = struct.pack(">HBB", 0, 8, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape) + arr.tobytes()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(body)


def mnist(root):
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (5, 28, 28), np.uint8)
    labels = rng.integers(0, 10, 5).astype(np.uint8)
    os.makedirs(root, exist_ok=True)
    _write_idx(os.path.join(root, "train-images-idx3-ubyte"), imgs)
    _write_idx(os.path.join(root, "train-labels-idx1-ubyte"), labels)
    _write_idx(os.path.join(root, "t10k-images-idx3-ubyte.gz"), imgs[:3], True)
    _write_idx(os.path.join(root, "t10k-labels-idx1-ubyte.gz"), labels[:3],
               True)
    return str(root), ("train", "test")


def fer2013(root):
    rng = np.random.default_rng(3)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "fer2013.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, ["emotion", "pixels", "Usage"])
        w.writeheader()
        for usage, n in (("Training", 4), ("PublicTest", 2),
                         ("PrivateTest", 3)):
            for _ in range(n):
                w.writerow({"emotion": int(rng.integers(0, 7)),
                            "Usage": usage, "pixels": " ".join(
                                map(str, rng.integers(0, 256, 48 * 48)))})
    return str(root), ("train", "val", "test")


def stl10(root):
    rng = np.random.default_rng(4)
    d = os.path.join(root, "stl10_binary")
    os.makedirs(d, exist_ok=True)
    for split, n in (("train", 4), ("test", 3)):
        rng.integers(0, 256, (n, 3, 96, 96), np.uint8).tofile(
            os.path.join(d, f"{split}_X.bin"))
        rng.integers(1, 11, n).astype(np.uint8).tofile(
            os.path.join(d, f"{split}_y.bin"))
    return str(root), ("train", "test")


def food101(root):
    meta = os.path.join(root, "meta")
    os.makedirs(meta, exist_ok=True)
    with open(os.path.join(meta, "classes.txt"), "w") as f:
        f.write("apple_pie\nbaklava\n")
    with open(os.path.join(meta, "train.txt"), "w") as f:
        f.write("apple_pie/001\nbaklava/002\napple_pie/003\n")
    with open(os.path.join(meta, "test.txt"), "w") as f:
        f.write("baklava/004\n")
    for i, rel in enumerate(("apple_pie/001", "baklava/002", "apple_pie/003",
                             "baklava/004")):
        save_image(os.path.join(root, "images", rel + ".jpg"), i, _sized(i))
    return str(root), ("train", "test")


def dtd(root):
    for i, rel in enumerate(("banded/banded_0001.jpg",
                             "dotted/dotted_0001.jpg",
                             "dotted/dotted_0002.jpg")):
        save_image(os.path.join(root, "images", rel), i, _sized(i))
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    with open(os.path.join(root, "labels", "train1.txt"), "w") as f:
        f.write("banded/banded_0001.jpg\ndotted/dotted_0002.jpg\n")
    with open(os.path.join(root, "labels", "test1.txt"), "w") as f:
        f.write("dotted/dotted_0001.jpg\n")
    return str(root), ("train", "test")


def sun397(root):
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "ClassName.txt"), "w") as f:
        f.write("/a/abbey\n/b/bar\n")
    with open(os.path.join(root, "Training_01.txt"), "w") as f:
        f.write("/a/abbey/sun_0001.jpg\n/b/bar/sun_0002.jpg\n")
    with open(os.path.join(root, "Testing_01.txt"), "w") as f:
        f.write("/a/abbey/sun_0003.jpg\n")
    for i, rel in enumerate(("a/abbey/sun_0001.jpg", "b/bar/sun_0002.jpg",
                             "a/abbey/sun_0003.jpg")):
        save_image(os.path.join(root, rel), i, _sized(i))
    return str(root), ("train", "test")


def oxford_pets(root):
    ann = os.path.join(root, "annotations")
    os.makedirs(ann, exist_ok=True)
    with open(os.path.join(ann, "trainval.txt"), "w") as f:
        f.write("#comment line\nAbyssinian_1 1 1 1\nbeagle_2 5 2 1\n")
    with open(os.path.join(ann, "test.txt"), "w") as f:
        f.write("Abyssinian_3 1 1 1\n")
    for i, name in enumerate(("Abyssinian_1", "beagle_2", "Abyssinian_3")):
        save_image(os.path.join(root, "images", name + ".jpg"), i, _sized(i))
    return str(root), ("train", "test")


def gtsrb(root):
    base = os.path.join(root, "Final_Training", "Images", "00003")
    save_image(os.path.join(base, "00000_00000.ppm"), 0)
    with open(os.path.join(base, "GT-00003.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, ["Filename", "ClassId"], delimiter=";")
        w.writeheader()
        w.writerow({"Filename": "00000_00000.ppm", "ClassId": 3})
    tbase = os.path.join(root, "Final_Test", "Images")
    save_image(os.path.join(tbase, "00001.ppm"), 1)
    with open(os.path.join(tbase, "GT-final_test.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, ["Filename", "ClassId"], delimiter=";")
        w.writeheader()
        w.writerow({"Filename": "00001.ppm", "ClassId": 7})
    return str(root), ("train", "test")


def flowers102(root):
    from scipy.io import savemat

    os.makedirs(root, exist_ok=True)
    savemat(os.path.join(root, "imagelabels.mat"),
            {"labels": np.array([[5, 3, 5, 1]])})
    savemat(os.path.join(root, "setid.mat"),
            {"trnid": np.array([[1, 3]]), "valid": np.array([[2]]),
             "tstid": np.array([[4]])})
    for i in range(1, 5):
        save_image(os.path.join(root, "jpg", f"image_{i:05d}.jpg"), i,
                   _sized(i))
    return str(root), ("train", "val", "test")


def fgvc_aircraft(root):
    base = os.path.join(root, "data")
    os.makedirs(base, exist_ok=True)
    with open(os.path.join(base, "variants.txt"), "w") as f:
        f.write("707-320\nA310\n")
    with open(os.path.join(base, "images_variant_train.txt"), "w") as f:
        f.write("0034309 707-320\n0034958 A310\n")
    with open(os.path.join(base, "images_variant_test.txt"), "w") as f:
        f.write("1234567 A310\n")
    for i, img_id in enumerate(("0034309", "0034958", "1234567")):
        save_image(os.path.join(base, "images", img_id + ".jpg"), i, _sized(i))
    return str(root), ("train", "test")


def stanford_cars(root):
    from scipy.io import savemat

    os.makedirs(root, exist_ok=True)
    annos = np.zeros((1, 3), dtype=[("relative_im_path", "O"),
                                    ("class", "O"), ("test", "O")])
    annos[0, 0] = ("car_ims/000001.jpg", 3, 0)
    annos[0, 1] = ("car_ims/000002.jpg", 7, 1)
    annos[0, 2] = ("car_ims/000003.jpg", 1, 0)
    names = np.array([f"Make Model {2000 + i}" for i in range(8)],
                     dtype=object)
    savemat(os.path.join(root, "cars_annos.mat"),
            {"annotations": annos, "class_names": names})
    for i in range(1, 4):
        save_image(os.path.join(root, "car_ims", f"{i:06d}.jpg"), i, _sized(i))
    return str(root), ("train", "test")


def pcam(root):
    import h5py

    rng = np.random.default_rng(7)
    os.makedirs(root, exist_ok=True)
    for name, n in (("train", 4), ("valid", 2), ("test", 2)):
        with h5py.File(os.path.join(
                root, f"camelyonpatch_level_2_split_{name}_x.h5"), "w") as f:
            f.create_dataset(
                "x", data=rng.integers(0, 256, (n, 96, 96, 3), np.uint8))
        with h5py.File(os.path.join(
                root, f"camelyonpatch_level_2_split_{name}_y.h5"), "w") as f:
            f.create_dataset(
                "y", data=rng.integers(0, 2, (n, 1, 1, 1), np.uint8))
    return str(root), ("train", "val", "test")


def _hash_folder(root, sub, classes, n):
    for ci, cls in enumerate(classes):
        for i in range(n):
            save_image(os.path.join(root, sub, cls, f"{cls}_{i:03d}.jpg"),
                       100 * ci + i)
    return str(root), ("train", "test")


def eurosat(root):
    return _hash_folder(root, "2750", ("Forest", "River"), 10)


def resisc45(root):
    return _hash_folder(root, "NWPU-RESISC45", ("airport", "beach"), 8)


def caltech101(root, per_class=(33, 32, 31), classes=CALTECH_CLASSES,
               size=None):
    sub = os.path.join(root, "101_ObjectCategories")
    for ci, (cls, n) in enumerate(zip(classes, per_class)):
        for i in range(n):
            save_image(os.path.join(sub, cls, f"image_{i:04d}.jpg"),
                       1000 * ci + i, size or _sized(i))
    save_image(os.path.join(sub, "BACKGROUND_Google", "image_0001.jpg"), 9)
    return str(root), ("train", "test")


def _split_dirs(root, classes):
    for split, n in (("train", 3), ("valid", 2), ("test", 1)):
        for ci, cls in enumerate(classes):
            for i in range(n):
                save_image(os.path.join(root, split, cls, f"{i}.jpg"),
                           10 * ci + i)
    return str(root), ("train", "val", "test")


def country211(root):
    return _split_dirs(root, ("DE", "US"))


def rendered_sst2(root):
    return _split_dirs(root, ("negative", "positive"))


def birdsnap(root):
    for ci, (cls, names) in enumerate((
            ("Acadian_Flycatcher", ["a.jpg", "b.jpg"]),
            ("Blue_Jay", ["c.jpg", "d.jpg"]))):
        for i, n in enumerate(names):
            save_image(os.path.join(root, "images", cls, n), 10 * ci + i)
    with open(os.path.join(root, "test_images.txt"), "w") as f:
        f.write("fileName\nAcadian_Flycatcher/b.jpg\nBlue_Jay/c.jpg\n")
    return str(root), ("train", "test")


def kitti_distance(root):
    img_dir = os.path.join(root, "training", "image_2")
    lbl_dir = os.path.join(root, "training", "label_2")
    os.makedirs(lbl_dir, exist_ok=True)
    obj = "{typ} 0.0 0 0.0 100 100 200 200 1.5 1.6 3.9 1.0 1.7 {z} 0.0\n"
    texts = [obj.format(typ="Car", z=5.0) + obj.format(typ="Car", z=30.0),
             obj.format(typ="Van", z=12.0), obj.format(typ="Truck", z=45.0),
             obj.format(typ="Pedestrian", z=3.0), ""]
    for i, text in enumerate(texts * 3):
        stem = f"{i:06d}"
        save_image(os.path.join(img_dir, stem + ".png"), i)
        with open(os.path.join(lbl_dir, stem + ".txt"), "w") as f:
            f.write(text)
    return str(root), ("train", "test")


def voc2007(root, n=24, seed=3, size=None):
    """The VOC2007 test split under ``root/test/VOCdevkit 2/VOC2007`` (the
    loader's root is ``root/``, trailing slash included), labels drawn at
    30% with at least one positive an image."""
    from msclip_torch.data.datasets import Voc2007Classification

    base = os.path.join(root, "test", "VOCdevkit 2", "VOC2007")
    main = os.path.join(base, "ImageSets", "Main")
    os.makedirs(main, exist_ok=True)
    classes = Voc2007Classification.CATEGORIES
    rng = np.random.default_rng(seed)
    ids = [f"{i:06d}" for i in range(1, n + 1)]
    labels = rng.random((n, len(classes))) < 0.3
    labels[np.arange(n), rng.integers(0, len(classes), n)] = True
    for ci, cls in enumerate(classes):
        with open(os.path.join(main, f"{cls}_test.txt"), "w") as f:
            f.write("".join(f"{img_id} {1 if labels[i, ci] else -1}\n"
                            for i, img_id in enumerate(ids)))
    for i, img_id in enumerate(ids):
        save_image(os.path.join(base, "JPEGImages", img_id + ".jpg"), i,
                   size or _sized(i))
    return str(root) + "/", ("test",)


def hatefulmemes(root, n_val=8, n_train=4, size=None):
    """``train.jsonl`` and ``dev_seen.jsonl`` (the labeled ``val`` split),
    both classes in each."""
    os.makedirs(os.path.join(root, "img"), exist_ok=True)
    for split, fname, n in (("train", "train.jsonl", n_train),
                            ("val", "dev_seen.jsonl", n_val)):
        recs = []
        for i in range(n):
            rel = f"img/{split}_{i:05d}.png"
            save_image(os.path.join(root, rel), 500 * len(split) + i,
                       size or _sized(i))
            recs.append({"id": i, "img": rel, "text": f"meme {i}",
                         "label": i % 2})
        with open(os.path.join(root, fname), "w") as f:
            f.write("\n".join(json.dumps(r) for r in recs))
    return str(root), ("train", "val")


def chestxray8(root):
    rng = np.random.default_rng(8)
    names = [f"{i:08d}_000.png" for i in range(6)]
    for i, name in enumerate(names):
        save_image(os.path.join(root, "images", name), i, _sized(i))
    findings = ["Cardiomegaly|Edema", "No Finding", "Mass", "Hernia|Nodule",
                "Effusion", "Pneumonia|Pneumothorax|Mass"]
    rows = [",".join(["Image Index", "Finding Labels"] + ["c"] * 9)]
    rows += [f"{n},{f}" + ",x" * 9 for n, f in zip(names, findings)]
    with open(os.path.join(root, "Data_Entry_2017_v2020.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    order = rng.permutation(6)
    with open(os.path.join(root, "train_val_list.txt"), "w") as f:
        f.write("".join(names[i] + "\n" for i in order[:4]))
    with open(os.path.join(root, "test_list.txt"), "w") as f:
        f.write("".join(names[i] + "\n" for i in order[4:]))
    return str(root), ("train", "test")


def karpathy(root, n_images=6, per_image=2, split="test", size=None):
    """A Karpathy-split annotation (Flickr30k's flat layout) and its
    images: ``n_images`` of ``split`` with ``per_image`` captions each, one
    train and one restval image beside them."""
    records = []
    for i in range(n_images + 2):
        fname = f"{i:05d}.jpg"
        save_image(os.path.join(root, "images", fname), 300 + i,
                   size or _sized(i))
        sp = split if i < n_images else ("train", "restval")[i - n_images]
        records.append({"filename": fname, "split": sp, "sentences": [
            {"raw": f"a photo of thing {i} number {j}"}
            for j in range(per_image)]})
    ann = os.path.join(root, "dataset_flickr30k.json")
    with open(ann, "w") as f:
        json.dump({"images": records}, f)
    return os.path.join(root, "images"), ann


FIXTURES = {
    "cifar-10": cifar10,
    "cifar-100": cifar100,
    "mnist": mnist,
    "fer-2013": fer2013,
    "stl-10": stl10,
    "food-101": food101,
    "dtd": dtd,
    "sun397": sun397,
    "oxford-iiit-pets": oxford_pets,
    "gtsrb": gtsrb,
    "oxford-flower-102": flowers102,
    "fgvc-aircraft-2013b": fgvc_aircraft,
    "stanford-cars": stanford_cars,
    "pcam": pcam,
    "eurosat": eurosat,
    "resisc45": resisc45,
    "caltech-101": caltech101,
    "country211": country211,
    "rendered-sst2": rendered_sst2,
    "birdsnap": birdsnap,
    "kitti-distance": kitti_distance,
    "voc2007classification": voc2007,
    "hatefulmemes": hatefulmemes,
    "chestxray8": chestxray8,
}


def tiny_checkpoint(path, seed=0):
    """Random MS-CLIP-S weights at ``TINY_OPTS`` geometry, exported by the
    JAX package in the reference layout (aliased text keys included);
    returns the exported numpy ``state_dict``."""
    import torch

    from msclip_tpu.config import get_default_config, update_config
    from msclip_tpu.models import build_model
    from msclip_tpu.utils import export_torch_state_dict
    from torch_port_params import random_jax_params

    cfg = get_default_config()
    update_config(cfg, MODEL_YAML, opts=TINY_OPTS)
    jm = build_model(cfg)
    sd = export_torch_state_dict(random_jax_params(jm, seed=seed), jm.spec)
    torch.save({k: torch.tensor(np.array(v)) for k, v in sd.items()}, path)
    return sd

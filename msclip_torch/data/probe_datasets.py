"""Loaders for the linear-probe / zero-shot transfer suite, a copy of
``msclip_tpu/data/probe_datasets.py`` (pure Python with PIL decode; the
same parsing, class order and splits).

The reference README reports a 24-dataset transfer suite (its
``README.md:24-30``) but its release ships loaders for only three custom
datasets (``lib/evaluation/dataset.py``: Voc2007, HatefulMemes, ChestXRay8
— in ``datasets.py`` here). This module covers the remaining *on-disk
layout families* of that suite:

  pickle batches   CIFAR-10, CIFAR-100
  idx ubyte        MNIST
  csv pixels       FER2013
  binary planes    STL-10
  meta/class txt   Food-101, DTD, SUN397
  annotation txt   Oxford-IIIT Pets
  csv + ppm        GTSRB
  .mat index       Oxford Flowers-102, Stanford Cars (scipy)
  ImageFolder + hash split    EuroSAT, RESISC45 (no official split:
                              deterministic crc32 80/20)
  ImageFolder + protocol      Caltech-101 (30 train/class), Birdsnap
                              (test_images.txt)
  ImageFolder per split dir   Country211, Rendered-SST2
  detection labels -> bins    KITTI closest-vehicle-distance (VTAB task)
  h5 arrays                   PatchCamelyon (h5py)

Every dataset yields ``(transform(PIL image), int label)`` with the
standard eval transform by default, so all of them drop into
``BatchLoader`` / ``run_linear_probe`` / ``run_zero_shot`` unchanged.
``scipy`` and ``h5py`` are imported only by the classes that read their
formats.
"""

from __future__ import annotations

import csv
import gzip
import os
import pickle
import struct
from typing import Callable, Optional

import numpy as np

from .transforms import pil_eval_transform


def _pil(arr):
    from PIL import Image

    return Image.fromarray(arr)


class _ArrayDataset:
    """Common base: uint8 image arrays (HWC or HW) + int labels."""

    def __init__(self, images, labels, transform=None):
        assert len(images) == len(labels)
        self.images = images
        self.labels = np.asarray(labels, np.int64)
        self.transform = transform or pil_eval_transform

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.transform(_pil(self.images[i])), int(self.labels[i])


class Cifar10(_ArrayDataset):
    """CIFAR-10 python-pickle batches (``cifar-10-batches-py/``)."""

    BATCHES = {"train": [f"data_batch_{i}" for i in range(1, 6)],
               "test": ["test_batch"]}
    SUBDIR = "cifar-10-batches-py"
    DATA_KEY, LABEL_KEY = b"data", b"labels"

    def __init__(self, root: str, image_set: str = "train",
                 transform: Optional[Callable] = None):
        imgs, labels = [], []
        for name in self.BATCHES[image_set]:
            with open(os.path.join(root, self.SUBDIR, name), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            imgs.append(np.asarray(d[self.DATA_KEY], np.uint8))
            labels.extend(d[self.LABEL_KEY])
        imgs = np.concatenate(imgs).reshape(-1, 3, 32, 32)
        super().__init__(imgs.transpose(0, 2, 3, 1), labels, transform)


class Cifar100(Cifar10):
    """CIFAR-100 (``cifar-100-python/``; fine labels)."""

    BATCHES = {"train": ["train"], "test": ["test"]}
    SUBDIR = "cifar-100-python"
    LABEL_KEY = b"fine_labels"


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


class Mnist(_ArrayDataset):
    """MNIST idx-ubyte files (plain or .gz)."""

    FILES = {"train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
             "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")}

    def __init__(self, root: str, image_set: str = "train",
                 transform: Optional[Callable] = None):
        img_name, lbl_name = self.FILES[image_set]

        def find(name):
            for cand in (name, name + ".gz"):
                p = os.path.join(root, cand)
                if os.path.exists(p):
                    return p
            raise FileNotFoundError(f"{name}[.gz] not under {root}")

        super().__init__(_read_idx(find(img_name)),
                         _read_idx(find(lbl_name)).astype(np.int64),
                         transform)


class Fer2013(_ArrayDataset):
    """FER-2013 ``fer2013.csv`` (emotion, pixels, Usage); image_set
    'train' -> Training, 'val' -> PublicTest, 'test' -> PrivateTest."""

    USAGE = {"train": "Training", "val": "PublicTest",
             "test": "PrivateTest"}

    def __init__(self, root: str, image_set: str = "train",
                 transform: Optional[Callable] = None):
        want = self.USAGE[image_set]
        imgs, labels = [], []
        with open(os.path.join(root, "fer2013.csv")) as f:
            for row in csv.DictReader(f):
                if row["Usage"] != want:
                    continue
                px = np.asarray(row["pixels"].split(), np.uint8)
                imgs.append(px.reshape(48, 48))
                labels.append(int(row["emotion"]))
        super().__init__(np.stack(imgs), labels, transform)


class Stl10(_ArrayDataset):
    """STL-10 binary planes (``stl10_binary/{train,test}_{X,y}.bin``:
    column-major 96x96x3 uint8; labels 1-based)."""

    def __init__(self, root: str, image_set: str = "train",
                 transform: Optional[Callable] = None):
        sub = os.path.join(root, "stl10_binary")
        x = np.fromfile(os.path.join(sub, f"{image_set}_X.bin"), np.uint8)
        y = np.fromfile(os.path.join(sub, f"{image_set}_y.bin"), np.uint8)
        imgs = x.reshape(-1, 3, 96, 96).transpose(0, 3, 2, 1)
        super().__init__(imgs, y.astype(np.int64) - 1, transform)


class _PathDataset:
    """Common base: (path, label) samples decoded through PIL."""

    def __init__(self, samples, classes, transform=None):
        self.samples = samples
        self.classes = classes
        self.transform = transform or pil_eval_transform

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        from .datasets import _load_image

        path, label = self.samples[i]
        return self.transform(_load_image(path)), int(label)


class Food101(_PathDataset):
    """Food-101 (``images/<class>/<id>.jpg`` + ``meta/{train,test}.txt``
    lines ``<class>/<id>``)."""

    def __init__(self, root: str, image_set: str = "train",
                 transform: Optional[Callable] = None):
        with open(os.path.join(root, "meta", "classes.txt")) as f:
            classes = [l.strip() for l in f if l.strip()]
        idx = {c: i for i, c in enumerate(classes)}
        samples = []
        with open(os.path.join(root, "meta", f"{image_set}.txt")) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                cls = line.split("/")[0]
                samples.append((os.path.join(root, "images",
                                             line + ".jpg"), idx[cls]))
        super().__init__(samples, classes, transform)


class Dtd(_PathDataset):
    """Describable Textures (``images/<class>/x.jpg`` +
    ``labels/{train,val,test}<split>.txt``)."""

    def __init__(self, root: str, image_set: str = "train", split: int = 1,
                 transform: Optional[Callable] = None):
        img_root = os.path.join(root, "images")
        classes = sorted(
            d for d in os.listdir(img_root)
            if os.path.isdir(os.path.join(img_root, d))
        )
        idx = {c: i for i, c in enumerate(classes)}
        samples = []
        with open(os.path.join(root, "labels",
                               f"{image_set}{split}.txt")) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                samples.append((os.path.join(img_root, line),
                                idx[line.split("/")[0]]))
        super().__init__(samples, classes, transform)


class Sun397(_PathDataset):
    """SUN397 (``ClassName.txt`` + ``Training_01.txt``/``Testing_01.txt``
    partition lists of ``/c/class/sun_xxx.jpg`` paths)."""

    PARTS = {"train": "Training_{:02d}.txt", "test": "Testing_{:02d}.txt"}

    def __init__(self, root: str, image_set: str = "train",
                 partition: int = 1,
                 transform: Optional[Callable] = None):
        with open(os.path.join(root, "ClassName.txt")) as f:
            classes = [l.strip() for l in f if l.strip()]
        idx = {c: i for i, c in enumerate(classes)}
        samples = []
        with open(os.path.join(
            root, self.PARTS[image_set].format(partition)
        )) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                cls = "/".join(line.split("/")[:-1])
                samples.append((os.path.join(root, line.lstrip("/")),
                                idx[cls]))
        super().__init__(samples, classes, transform)


class OxfordPets(_PathDataset):
    """Oxford-IIIT Pets (``images/`` + ``annotations/{trainval,test}.txt``
    lines ``<Image> <ClassId 1-based> <Species> <BreedId>``)."""

    SPLITS = {"train": "trainval.txt", "trainval": "trainval.txt",
              "test": "test.txt"}

    def __init__(self, root: str, image_set: str = "train",
                 transform: Optional[Callable] = None):
        samples = []
        names = {}  # label -> breed, from the image stem ("Abyssinian_12")
        with open(os.path.join(root, "annotations",
                               self.SPLITS[image_set])) as f:
            for line in f:
                parts = line.split()
                if not parts or parts[0].startswith("#"):
                    continue
                label = int(parts[1]) - 1
                names[label] = parts[0].rsplit("_", 1)[0].replace("_", " ")
                samples.append((os.path.join(root, "images",
                                             parts[0] + ".jpg"), label))
        classes = [names.get(i, str(i)) for i in range(max(names) + 1)]
        super().__init__(samples, classes, transform)


class Gtsrb(_PathDataset):
    """GTSRB (train: ``Final_Training/Images/<class>/GT-*.csv`` + ppm;
    test: ``Final_Test/Images/GT-final_test.csv``)."""

    def __init__(self, root: str, image_set: str = "train",
                 transform: Optional[Callable] = None):
        samples = []
        if image_set == "train":
            base = os.path.join(root, "Final_Training", "Images")
            for cls_dir in sorted(os.listdir(base)):
                full = os.path.join(base, cls_dir)
                if not os.path.isdir(full):
                    continue
                label = int(cls_dir)
                gt = os.path.join(full, f"GT-{cls_dir}.csv")
                with open(gt) as f:
                    for row in csv.DictReader(f, delimiter=";"):
                        samples.append(
                            (os.path.join(full, row["Filename"]), label)
                        )
        else:
            base = os.path.join(root, "Final_Test", "Images")
            with open(os.path.join(base, "GT-final_test.csv")) as f:
                for row in csv.DictReader(f, delimiter=";"):
                    samples.append((os.path.join(base, row["Filename"]),
                                    int(row["ClassId"])))
        classes = [str(i) for i in range(43)]
        super().__init__(samples, classes, transform)


class Flowers102(_PathDataset):
    """Oxford Flowers-102 (``jpg/image_%05d.jpg`` + ``imagelabels.mat`` +
    ``setid.mat``; labels and ids 1-based)."""

    SETID = {"train": "trnid", "val": "valid", "test": "tstid"}

    def __init__(self, root: str, image_set: str = "train",
                 transform: Optional[Callable] = None):
        from scipy.io import loadmat

        labels = loadmat(os.path.join(root, "imagelabels.mat"))["labels"]
        ids = loadmat(os.path.join(root, "setid.mat"))[
            self.SETID[image_set]
        ].ravel()
        samples = [
            (os.path.join(root, "jpg", f"image_{i:05d}.jpg"),
             int(labels.ravel()[i - 1]) - 1)
            for i in ids
        ]
        super().__init__(samples, [str(i) for i in range(102)], transform)


class StanfordCars(_PathDataset):
    """Stanford Cars (``cars_annos.mat`` with relative paths, 1-based
    class, and a test flag per annotation)."""

    def __init__(self, root: str, image_set: str = "train",
                 transform: Optional[Callable] = None):
        from scipy.io import loadmat

        mat = loadmat(os.path.join(root, "cars_annos.mat"), squeeze_me=True)
        annos = mat["annotations"]
        want_test = image_set == "test"
        samples = []
        for a in np.atleast_1d(annos):
            if bool(int(a["test"])) != want_test:
                continue
            samples.append((os.path.join(root, str(a["relative_im_path"])),
                            int(a["class"]) - 1))
        # cars_annos.mat ships the real class names ("AM General Hummer
        # SUV 2000", ...); numeric placeholders only if the field is
        # absent (zero-shot then refuses — see eval.resolve_prompts)
        if "class_names" in mat:
            classes = [str(c) for c in np.atleast_1d(mat["class_names"])]
        else:
            classes = [str(i) for i in range(196)]
        super().__init__(samples, classes, transform)


class FgvcAircraft(_PathDataset):
    """FGVC-Aircraft (``data/images/`` + ``data/images_variant_train.txt``
    lines ``<id> <variant name...>``)."""

    def __init__(self, root: str, image_set: str = "train",
                 transform: Optional[Callable] = None):
        base = os.path.join(root, "data")
        with open(os.path.join(base, "variants.txt")) as f:
            classes = [l.strip() for l in f if l.strip()]
        idx = {c: i for i, c in enumerate(classes)}
        samples = []
        with open(os.path.join(
            base, f"images_variant_{image_set}.txt"
        )) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                img_id, variant = line.split(" ", 1)
                samples.append((os.path.join(base, "images",
                                             img_id + ".jpg"),
                                idx[variant]))
        super().__init__(samples, classes, transform)


class PatchCamelyon:
    """PatchCamelyon (``camelyonpatch_level_2_split_<set>_{x,y}.h5``:
    x [N, 96, 96, 3] uint8, y [N, 1, 1, 1]). Images are sliced from the
    h5 dataset per item — the real train split is ~7 GB uint8, far too
    large to materialize at init (labels are tiny and load eagerly)."""

    def __init__(self, root: str, image_set: str = "train",
                 transform: Optional[Callable] = None):
        import h5py

        name = {"train": "train", "val": "valid", "test": "test"}[image_set]
        self._x_path = os.path.join(
            root, f"camelyonpatch_level_2_split_{name}_x.h5"
        )
        self._h5 = None  # opened lazily per process/thread use
        with h5py.File(os.path.join(
            root, f"camelyonpatch_level_2_split_{name}_y.h5"
        ), "r") as f:
            self.labels = np.asarray(f["y"]).reshape(-1).astype(np.int64)
        self.transform = transform or pil_eval_transform

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        import h5py

        if self._h5 is None:
            self._h5 = h5py.File(self._x_path, "r")
        arr = np.asarray(self._h5["x"][i], np.uint8)
        return self.transform(_pil(arr)), int(self.labels[i])


def _scan_folder(root, skip=()):
    """Shared ImageFolder scan (raises loudly on an empty tree)."""
    from .datasets import scan_image_folder

    return scan_image_folder(root, skip=skip)


def _crc_split(key: str, train_pct: int) -> bool:
    """Deterministic, machine-independent membership test: True if the
    sample belongs to the train split. Hash-based (crc32 of the
    class-relative filename) so membership never shifts when files are
    added or the listing order changes."""
    import zlib

    return zlib.crc32(key.encode()) % 100 < train_pct


class _HashSplitFolder(_PathDataset):
    """ImageFolder tree with NO on-disk split (EuroSAT, RESISC45 ship as
    one directory per class). Deterministic 80/20 train/test split via
    :func:`_crc_split` on ``<class>/<filename>`` — the public
    distributions define no official split, so the convention is stated
    here and reproduced everywhere (the rule of docs/DATA.md)."""

    SUBDIR: Optional[str] = None
    TRAIN_PCT = 80

    def __init__(self, root: str, image_set: str = "train",
                 transform: Optional[Callable] = None):
        if self.SUBDIR and os.path.isdir(os.path.join(root, self.SUBDIR)):
            root = os.path.join(root, self.SUBDIR)
        samples, classes = _scan_folder(root)
        want_train = {"train": True, "test": False}[image_set]
        keep = []
        for path, label in samples:
            key = f"{classes[label]}/{os.path.basename(path)}"
            if _crc_split(key, self.TRAIN_PCT) == want_train:
                keep.append((path, label))
        super().__init__(keep, classes, transform)


class EuroSat(_HashSplitFolder):
    """EuroSAT RGB (``2750/<class>/*.jpg``, 10 classes, no official
    split; deterministic 80/20 hash split)."""

    SUBDIR = "2750"


class Resisc45(_HashSplitFolder):
    """NWPU-RESISC45 (``NWPU-RESISC45/<class>/*.jpg``, 45 classes, no
    official split; deterministic 80/20 hash split)."""

    SUBDIR = "NWPU-RESISC45"


class Caltech101(_PathDataset):
    """Caltech-101 (``101_ObjectCategories/<class>/image_*.jpg``).
    Standard protocol: ``BACKGROUND_Google`` excluded; per class the
    first 30 images (sorted) are train, the rest test."""

    TRAIN_PER_CLASS = 30

    def __init__(self, root: str, image_set: str = "train",
                 transform: Optional[Callable] = None):
        sub = os.path.join(root, "101_ObjectCategories")
        if os.path.isdir(sub):
            root = sub
        samples, classes = _scan_folder(root, skip=("BACKGROUND_Google",))
        per_class: dict = {}
        keep = []
        want_train = {"train": True, "test": False}[image_set]
        for path, label in samples:  # sorted within class by _scan_folder
            k = per_class.get(label, 0)
            per_class[label] = k + 1
            if (k < self.TRAIN_PER_CLASS) == want_train:
                keep.append((path, label))
        super().__init__(keep, classes, transform)


class _SubdirSplitFolder(_PathDataset):
    """ImageFolder tree with per-split subdirectories
    (``root/{train,valid,test}/<class>/...`` — the OpenAI release layout
    of Country211 and Rendered-SST2). Class indexing is derived from the
    UNION of classes across all split directories, so a class absent
    from one split (pruned subset, partial download) can never silently
    misalign train-vs-test labels."""

    SPLITS = {"train": "train", "val": "valid", "valid": "valid",
              "test": "test"}

    def __init__(self, root: str, image_set: str = "train",
                 transform: Optional[Callable] = None):
        split_dir = os.path.join(root, self.SPLITS[image_set])
        classes = sorted({
            d
            for split in set(self.SPLITS.values())
            if os.path.isdir(os.path.join(root, split))
            for d in os.listdir(os.path.join(root, split))
            if os.path.isdir(os.path.join(root, split, d))
        })
        raw, split_classes = _scan_folder(split_dir)
        idx = {c: i for i, c in enumerate(classes)}
        samples = [(p, idx[split_classes[lbl]]) for p, lbl in raw]
        super().__init__(samples, classes, transform)


class Country211(_SubdirSplitFolder):
    """Country211 (OpenAI release: ``country211/{train,valid,test}/<ISO
    code>/*.jpg``, 211 classes)."""


class RenderedSst2(_SubdirSplitFolder):
    """Rendered SST-2 (OpenAI release: ``rendered-sst2/{train,valid,
    test}/{negative,positive}/*.png``)."""


class Birdsnap(_PathDataset):
    """Birdsnap (``images/<Class_name>/<file>.jpg`` + the distribution's
    ``test_images.txt`` listing ``<Class_name>/<file>.jpg`` test rows;
    train = everything else)."""

    def __init__(self, root: str, image_set: str = "train",
                 transform: Optional[Callable] = None):
        with open(os.path.join(root, "test_images.txt")) as f:
            rows = [l.strip() for l in f if l.strip()]
        if rows and rows[0].lower().startswith("filename"):
            rows = rows[1:]  # distribution file has a "fileName" header
        test_set = set(rows)
        samples, classes = _scan_folder(os.path.join(root, "images"))
        img_root = os.path.join(root, "images")
        want_test = image_set == "test"
        keep = [
            (p, lbl) for p, lbl in samples
            if (os.path.relpath(p, img_root) in test_set) == want_test
        ]
        super().__init__(keep, classes, transform)


class KittiDistance(_PathDataset):
    """KITTI closest-vehicle-distance (VTAB task convention).

    Layout: ``training/image_2/<id>.png`` + ``training/label_2/<id>.txt``
    (KITTI object-detection labels; field 0 = type, field 13 = camera-z
    metres). Label = distance bin of the NEAREST vehicle
    (Car/Van/Truck): 0 → z < 8 m, 1 → 8-20 m, 2 → ≥ 20 m, 3 → no vehicle
    in frame. KITTI's official test set has no public labels, so the
    probe split is a deterministic 80/20 hash split of the training
    frames (:func:`_crc_split` on the frame id)."""

    VEHICLES = ("Car", "Van", "Truck")
    CLASSES = ["vehicle closer than 8m", "vehicle 8-20m away",
               "vehicle at least 20m away", "no vehicle"]
    TRAIN_PCT = 80

    def __init__(self, root: str, image_set: str = "train",
                 transform: Optional[Callable] = None):
        img_dir = os.path.join(root, "training", "image_2")
        lbl_dir = os.path.join(root, "training", "label_2")
        want_train = {"train": True, "test": False}[image_set]
        samples = []
        for fname in sorted(os.listdir(img_dir)):
            stem, ext = os.path.splitext(fname)
            if ext.lower() not in (".png", ".jpg", ".jpeg"):
                continue
            if _crc_split(stem, self.TRAIN_PCT) != want_train:
                continue
            z_min = None
            with open(os.path.join(lbl_dir, stem + ".txt")) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 14 and parts[0] in self.VEHICLES:
                        z = float(parts[13])
                        z_min = z if z_min is None else min(z_min, z)
            if z_min is None:
                label = 3
            elif z_min < 8.0:
                label = 0
            elif z_min < 20.0:
                label = 1
            else:
                label = 2
            samples.append((os.path.join(img_dir, fname), label))
        super().__init__(samples, self.CLASSES, transform)


# name -> loader class (defined after every class so no placeholders).
PROBE_DATASETS = {
    "cifar-10": Cifar10,
    "cifar-100": Cifar100,
    "mnist": Mnist,
    "fer-2013": Fer2013,
    "stl-10": Stl10,
    "food-101": Food101,
    "dtd": Dtd,
    "sun397": Sun397,
    "oxford-iiit-pets": OxfordPets,
    "gtsrb": Gtsrb,
    "oxford-flower-102": Flowers102,
    "fgvc-aircraft-2013b": FgvcAircraft,
    "stanford-cars": StanfordCars,
    "pcam": PatchCamelyon,
    "eurosat": EuroSat,
    "resisc45": Resisc45,
    "caltech-101": Caltech101,
    "country211": Country211,
    "rendered-sst2": RenderedSst2,
    "birdsnap": Birdsnap,
    "kitti-distance": KittiDistance,
}


def build_probe_dataset(name: str, root: str, image_set: str,
                        transform=None):
    """Factory for the transfer-suite loaders; raises KeyError for names
    handled elsewhere (voc/hateful/chestxray in ``datasets.py``,
    ImageFolder layouts via ``ImageFolderDataset``)."""
    cls = PROBE_DATASETS[name]
    return cls(root, image_set=image_set, transform=transform)

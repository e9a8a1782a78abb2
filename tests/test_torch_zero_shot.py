"""The port's zero-shot slice against the JAX package's, on the CPU.

The two CLIs run on the same tiny JPEG ImageFolder with the same
MS-CLIP-S weights (a reference-layout ``.pth`` exported from the JAX
package) and must give the same top-1 for every image (the pattern of
tests/test_cli.py:27-60)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from msclip_tpu.data.datasets import SyntheticImageDataset as JaxSynthetic
from msclip_tpu.data.loader import BatchLoader as JaxBatchLoader
from msclip_tpu.models import build_model as jax_build_model
from msclip_tpu.utils import export_torch_state_dict
from msclip_torch.config import get_default_config, update_config
from msclip_torch.data.datasets import SyntheticImageDataset
from msclip_torch.data.loader import BatchLoader
from msclip_torch.eval import zero_shot as ZS
from msclip_torch.utils import metrics as M

from torch_port_params import random_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_YAML = os.path.join(REPO, "experiments", "model",
                          "b32-yfcc-msclips.yaml")
DS_YAML = os.path.join(REPO, "experiments", "dataset", "imagenet.yaml")
# MS-CLIP-S cut to width 128 and 6 layers: the stem, branch stages 0-1
# and the lateral adapters at layers 2 and 4 all run
TINY_OPTS = [
    "TRAIN.IMAGE_SIZE", "[64,64]", "TEST.IMAGE_SIZE", "[64,64]",
    "TEST.BATCH_SIZE_PER_GPU", "4", "TEST.SUBSET_CLASSES", "10",
    "MODEL.SPEC.VISION.WIDTH", "128", "MODEL.SPEC.VISION.LAYERS", "6",
    "MODEL.SPEC.TEXT.WIDTH", "128", "MODEL.SPEC.TEXT.HEADS", "2",
    "MODEL.SPEC.TEXT.LAYERS", "6", "MODEL.SPEC.EMBED_DIM", "32",
    "WORKERS", "2",
]


@pytest.fixture(scope="module")
def imagefolder(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("val")
    rng = np.random.default_rng(0)
    for cls in ("n01440764", "n01443537"):
        (root / cls).mkdir()
        for i in range(3):
            # coarse colour blocks: images that differ at the stem's scale
            arr = np.kron(rng.random((4, 5, 3)), np.ones((20, 20, 1)))
            arr = (arr * 255).astype(np.uint8)
            Image.fromarray(arr).save(root / cls / f"{cls}_{i}.JPEG")
    return root


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """Random MS-CLIP-S weights at TINY_OPTS geometry, exported by the JAX
    package in the reference layout (aliased text keys included)."""
    from msclip_tpu.config import get_default_config as jax_default_config
    from msclip_tpu.config import update_config as jax_update_config

    cfg = jax_default_config()
    jax_update_config(cfg, MODEL_YAML, opts=TINY_OPTS)
    jm = jax_build_model(cfg)
    sd = export_torch_state_dict(random_jax_params(jm, seed=0), jm.spec)
    path = tmp_path_factory.mktemp("ckpt") / "model.pth"
    torch.save({k: torch.tensor(np.array(v)) for k, v in sd.items()}, path)
    return path


def test_cli_matches_jax_cli_per_image(imagefolder, checkpoint, tmp_path):
    common = ["--ds", DS_YAML, "--model", MODEL_YAML,
              "MODEL.PRETRAINED_MODEL", str(checkpoint),
              "DATASET.ROOT", str(imagefolder.parent),
              "DATASET.TEST_SET", imagefolder.name] + TINY_OPTS
    env = dict(os.environ, MSCLIP_PLATFORM="cpu")
    jax_cmd = [sys.executable, "tools/zero_shot.py"] + common + [
        "OUTPUT_DIR", str(tmp_path / "out"),
        "TEST.SAVE_PRED", str(tmp_path / "jax.npz")]
    port_cmd = [sys.executable, "-m", "msclip_torch.tools.zero_shot",
                "--device", "cpu"] + common + [
        "OUTPUT_DIR", str(tmp_path / "port_out"),
        "TEST.SAVE_PRED", str(tmp_path / "port.npz")]
    procs = [subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for cmd in (jax_cmd, port_cmd)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert "RESULT imagenet accuracy=" in out
    jax_res, port_res = (np.load(tmp_path / f"{n}.npz")
                         for n in ("jax", "port"))
    np.testing.assert_array_equal(port_res["label"], jax_res["label"])
    np.testing.assert_array_equal(port_res["pred"], jax_res["pred"])
    assert len(set(port_res["pred"].tolist())) > 1  # not a constant guess
    result = [ln for ln in outs[1][0].splitlines() if ln.startswith("RESULT")]
    want = [ln for ln in outs[0][0].splitlines() if ln.startswith("RESULT")]
    assert result[0].split()[2] == want[0].split()[2]  # accuracy=...


def test_loader_batches_match_jax():
    """Same synthetic images, same padding and validity mask."""
    ds, jds = SyntheticImageDataset(n=10, size=16), JaxSynthetic(n=10,
                                                                  size=16)
    got = list(BatchLoader(ds, batch_size=4, workers=2))
    want = list(JaxBatchLoader(jds, batch_size=4, workers=2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in ("image", "label", "mask"):
            np.testing.assert_array_equal(g[key], w[key])
    assert got[-1]["mask"].tolist() == [True, True, False, False]


def test_topk_accuracy_with_mask():
    logits = np.array([[0.1, 0.9], [0.8, 0.2], [0.3, 0.7], [0.0, 0.0]])
    labels = np.array([1, 1, 1, 0])
    mask = np.array([True, True, True, False])
    assert M.topk_accuracy(logits, labels, (1, 2), mask) == \
        [100.0 * 2 / 3, 100.0]
    meter = M.AverageMeter()
    meter.update(50.0, 2)
    meter.update(100.0, 2)
    assert meter.avg == 75.0 and meter.count == 4


def test_prompts_and_datasets(tmp_path):
    cfg = get_default_config()
    update_config(cfg, DS_YAML)
    classnames, templates = ZS.resolve_prompts("imagenet", None)
    assert len(classnames) == 1000 and len(templates) == 80

    class Numeric:
        classes = ["0", "1"]

    with pytest.raises(ValueError, match="placeholder"):
        ZS.resolve_prompts("no-such-set", Numeric())
    # the transfer datasets take their own loaders
    from torch_transfer_fixtures import voc2007

    cfg.DATASET.DATASET = "voc2007classification"
    cfg.DATASET.ROOT, _ = voc2007(str(tmp_path), n=3)
    ds = ZS.make_dataset(cfg)
    assert type(ds).__name__ == "Voc2007Classification" and len(ds) == 3


def test_entry_point_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_default_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ZS.run_zero_shot(cfg)
    assert ZS.resolve_device("cpu") == torch.device("cpu")


def test_unported_metric_is_rejected(imagefolder, checkpoint, caplog):
    """A metric outside accuracy and the logit metrics reports top-1 under
    its name, as the JAX package does (its value on the same config and
    weights), with one warning that names it."""
    from msclip_tpu.config import get_default_config as jax_default_config
    from msclip_tpu.config import update_config as jax_update_config
    from msclip_tpu.eval import zero_shot as JZ

    opts = ["TEST.METRIC", "top5", "MODEL.PRETRAINED_MODEL", str(checkpoint),
            "DATASET.ROOT", str(imagefolder.parent),
            "DATASET.TEST_SET", imagefolder.name] + TINY_OPTS
    cfg, jcfg = get_default_config(), jax_default_config()
    for c, update in ((cfg, update_config), (jcfg, jax_update_config)):
        update(c, DS_YAML)
        update(c, MODEL_YAML, opts=opts)
    with caplog.at_level("WARNING"):
        value, stats = ZS.run_zero_shot(cfg, device="cpu")
    want, jstats = JZ.run_zero_shot(jcfg)
    assert stats["metric"] == jstats["metric"] == "top5"
    assert stats["n_images"] == jstats["n_images"] == 6
    assert value == want
    warned = [r for r in caplog.records
              if r.levelname == "WARNING" and "'top5'" in r.getMessage()]
    assert len(warned) == 1
    assert set(ZS.LOGIT_METRICS) == {"11point_mAP", "mean-per-class",
                                     "roc_auc"}

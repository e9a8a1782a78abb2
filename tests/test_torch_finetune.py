"""The port's finetune tool against the JAX package's ``tools/finetune.py``
on the CPU: a linear head on the frozen tiny MS-CLIP-S image tower, trained
with label smoothing (mixup and cutmix off: their draws come from
``jax.random`` there), on a CIFAR-10 pickle fixture with a shared
JAX-exported checkpoint. The eval logits (the head through the same
features) agree within 1e-4 and give the same top-1."""

import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

from msclip_tpu.utils import metrics as JM
from msclip_torch.tools import finetune as FT

from torch_threads import one_torch_thread  # noqa: F401
from torch_transfer_fixtures import MODEL_YAML, TINY_OPTS, cifar10, \
    tiny_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DS_YAML = os.path.join(REPO, "experiments", "dataset", "cifar-10.yaml")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("ft")
    ckpt = root / "model.pth"
    tiny_checkpoint(ckpt)
    cifar10(str(root / "cifar"), n_test=7)
    opts = TINY_OPTS + [
        "MODEL.PRETRAINED_MODEL", str(ckpt), "DATASET.ROOT",
        str(root / "cifar"), "FINETUNE.BATCH_SIZE", "2",
        "FINETUNE.BASE_LR", "0.05", "TRAIN.END_EPOCH", "3",
        "LOSS.LABEL_SMOOTHING", "0.1", "OUTPUT_DIR", str(root / "out")]
    return root, opts


def test_finetune_head_matches_jax(setup, monkeypatch, capsys):
    from msclip_torch.config import get_default_config, update_config

    _, opts = setup
    cfg = get_default_config()
    update_config(cfg, DS_YAML)
    update_config(cfg, MODEL_YAML, opts=opts)
    top1, stats = FT.run_finetune(cfg, device="cpu")
    assert stats["head"]["w"].abs().max() > 0 and len(stats["losses"]) == 9

    seen = []
    topk = JM.topk_accuracy

    def recording(logits, target, topk_=(1,), mask=None):
        seen.append((np.asarray(logits)[mask], np.asarray(target)[mask]))
        return topk(logits, target, topk_, mask)

    monkeypatch.setattr(JM, "topk_accuracy", recording)
    monkeypatch.setenv("MSCLIP_PLATFORM", "cpu")
    monkeypatch.setattr(sys, "argv", ["finetune.py", "--ds", DS_YAML,
                                      "--model", MODEL_YAML, *opts])
    runpy.run_path(os.path.join(REPO, "tools", "finetune.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    want_top1 = float(out.split("RESULT finetune top1=")[1].split()[0])
    logits = np.concatenate([x for x, _ in seen])
    labels = np.concatenate([y for _, y in seen])
    np.testing.assert_array_equal(stats["labels"], labels)
    np.testing.assert_allclose(stats["logits"], logits, atol=1e-4)
    assert f"{top1:.3f}" == f"{want_top1:.3f}"
    assert len(set(stats["logits"].argmax(1).tolist())) > 1


def test_finetune_cli_with_mixup_and_cutmix(setup):
    _, opts = setup
    r = subprocess.run(
        [sys.executable, "-m", "msclip_torch.tools.finetune", "--ds", DS_YAML,
         "--model", MODEL_YAML, "--device", "cpu", *opts,
         "AUG.MIXUP", "0.8", "AUG.MIXCUT", "1.0", "TRAIN.END_EPOCH", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    top1 = float(r.stdout.split("RESULT finetune top1=")[1].split()[0])
    assert 0.0 <= top1 <= 100.0


def test_finetune_needs_a_card_or_the_cpu_flag(setup, monkeypatch):
    _, opts = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        FT.main(["--ds", DS_YAML, "--model", MODEL_YAML, *opts])

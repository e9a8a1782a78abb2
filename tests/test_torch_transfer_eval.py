"""The port's transfer eval against the JAX package's, on the CPU: zero-shot
on the transfer datasets with their metrics, feature extraction, the
linear probe, retrieval, and the CLIs, with the same weights (a tiny
MS-CLIP-S exported by the JAX package in the reference layout) and the
same on-disk fixtures.

Tolerances: saved logits 1e-4 (fp32 towers in two frameworks, logits
scaled by 100); metrics computed in process 1e-6; features 1e-5; probe
weights 1e-4."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from msclip_torch.config import get_default_config, update_config
from msclip_torch.eval import linear_probe as LP
from msclip_torch.eval import retrieval as R
from msclip_torch.eval import zero_shot as ZS
from msclip_torch.models.msclip import build_spec
from msclip_torch.utils import metrics as M

from torch_transfer_fixtures import (
    MODEL_YAML, REPO, TINY_OPTS, caltech101, cifar10, hatefulmemes, karpathy,
    tiny_checkpoint, voc2007)

DS_DIR = os.path.join(REPO, "experiments", "dataset")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "model.pth"
    return path, tiny_checkpoint(path)


def _configs(ckpt_path, ds_yaml, *opts):
    """The port's and the JAX package's config for one dataset at the tiny
    geometry with the shared checkpoint."""
    from msclip_tpu.config import get_default_config as jax_default_config
    from msclip_tpu.config import update_config as jax_update_config

    all_opts = TINY_OPTS + ["MODEL.PRETRAINED_MODEL", str(ckpt_path),
                            *map(str, opts)]
    cfg, jcfg = get_default_config(), jax_default_config()
    update_config(cfg, ds_yaml)
    update_config(cfg, MODEL_YAML, opts=all_opts)
    jax_update_config(jcfg, ds_yaml)
    jax_update_config(jcfg, MODEL_YAML, opts=all_opts)
    return cfg, jcfg


def _run(cmd, tmp_path):
    env = dict(os.environ, MSCLIP_PLATFORM="cpu")
    return subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _result(out, key):
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][0]
    return float(line.split(f"{key}=")[1].split()[0])


def test_voc_cli_matches_jax_cli(ckpt, tmp_path):
    """VOC2007 11-point mAP through both CLIs: saved logits within 1e-4,
    the same argmax for every image, the same printed mAP."""
    root, _ = voc2007(str(tmp_path / "voc"))
    common = ["--ds", os.path.join(DS_DIR, "voc2007.yaml"),
              "--model", MODEL_YAML, "MODEL.PRETRAINED_MODEL", str(ckpt[0]),
              "DATASET.ROOT", root, "OUTPUT_DIR", str(tmp_path / "out")
              ] + TINY_OPTS
    procs = [_run([sys.executable, "tools/zero_shot.py"] + common + [
                  "TEST.SAVE_PRED", str(tmp_path / "jax.npz")], tmp_path),
             _run([sys.executable, "-m", "msclip_torch.tools.zero_shot",
                   "--device", "cpu"] + common + [
                  "TEST.SAVE_PRED", str(tmp_path / "port.npz")], tmp_path)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    jax_res, port_res = (np.load(tmp_path / f"{n}.npz")
                         for n in ("jax", "port"))
    np.testing.assert_array_equal(port_res["label"], jax_res["label"])
    np.testing.assert_allclose(port_res["logits"], jax_res["logits"],
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(port_res["logits"].argmax(-1),
                                  jax_res["logits"].argmax(-1))
    np.testing.assert_array_equal(port_res["pred"], jax_res["pred"])
    assert port_res["logits"].shape == (24, 20)
    got, want = (_result(o[0], "11point_mAP") for o in outs[::-1])
    assert got == want
    assert abs(M.multilabel_map_11points(port_res["label"],
                                         port_res["logits"]) - got) < 5e-4


@pytest.mark.parametrize("name,metric", [("hatefulmemes", "roc_auc"),
                                         ("caltech-101", "mean-per-class")])
def test_logit_metric_matches_jax_in_process(name, metric, ckpt, tmp_path):
    from msclip_tpu.eval import run_zero_shot as jax_run_zero_shot

    build = {"hatefulmemes": hatefulmemes, "caltech-101": caltech101}[name]
    root, _ = build(str(tmp_path / name))
    cfg, jcfg = _configs(ckpt[0], os.path.join(DS_DIR, f"{name}.yaml"),
                         "DATASET.ROOT", root,
                         "TEST.SAVE_PRED", tmp_path / "port.npz")
    jcfg.TEST.SAVE_PRED = ""
    got, stats = ZS.run_zero_shot(cfg, device="cpu")
    want, _ = jax_run_zero_shot(jcfg)
    assert stats["metric"] == metric
    assert abs(got - want) <= 1e-6, (got, want)
    saved = np.load(tmp_path / "port.npz")
    assert len(saved["logits"]) == stats["n_images"] > 0
    assert ZS.LOGIT_METRICS[metric](saved["label"], saved["logits"]) == got


def _port_model(ckpt_path, fold_bn):
    cfg = get_default_config()
    update_config(cfg, MODEL_YAML, opts=TINY_OPTS + [
        "MODEL.PRETRAINED_MODEL", str(ckpt_path)])
    return cfg, ZS.load_eval_model(cfg, build_spec(cfg), "cpu",
                                   fold_bn=fold_bn, int8=False)


def _jax_model(ckpt_path, fold_bn):
    from msclip_tpu.config import get_default_config as jax_default_config
    from msclip_tpu.config import update_config as jax_update_config
    from msclip_tpu.eval.checkpoint_load import load_model_params
    from msclip_tpu.models import build_model
    from msclip_tpu.models.folding import fold_params_for_eval

    jcfg = jax_default_config()
    jax_update_config(jcfg, MODEL_YAML, opts=TINY_OPTS + [
        "MODEL.PRETRAINED_MODEL", str(ckpt_path)])
    jm = build_model(jcfg)
    params = load_model_params(jcfg, jm)
    if fold_bn:
        params = fold_params_for_eval(params, jm.spec)
    return jm, params


def test_extract_features_matches_jax(ckpt, tmp_path):
    """Unfolded BN in eval mode, as the probe runs it: features within
    1e-5, labels equal, for both splits of a CIFAR-10 fixture."""
    from msclip_tpu.data.probe_datasets import Cifar10 as JaxCifar10
    from msclip_tpu.eval.linear_probe import extract_features as jax_extract
    from msclip_torch.data.probe_datasets import Cifar10

    from msclip_torch.data.transforms import pil_eval_transform

    root, _ = cifar10(str(tmp_path / "c10"))
    _, model = _port_model(ckpt[0], fold_bn=False)
    jm, jp = _jax_model(ckpt[0], fold_bn=False)

    def tf(img):
        return pil_eval_transform(img, size=64)

    for split in ("train", "test"):
        got = LP.extract_features(model, Cifar10(root, split, tf),
                                  batch_size=4, workers=2)
        want = jax_extract(jm, jp, JaxCifar10(root, split, tf),
                           batch_size=4, workers=2)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-5,
                                   rtol=0)
        assert got[0].dtype == np.float32
        np.testing.assert_allclose(np.linalg.norm(got[0], axis=-1), 1.0,
                                   atol=1e-5)


def _jax_probe_weights(train_x, train_y, **kw):
    """``fit_linear_probe_jax``'s weights: it returns only an accuracy, so
    its test set is the identity (row i's logits are w[i] + b) and a zero
    row (its logits are b), read back from the logits it computes."""
    import msclip_tpu.eval.linear_probe as JLP

    d = train_x.shape[1]
    probe_x = np.concatenate([np.eye(d), np.zeros((1, d))]).astype(np.float32)
    seen = []

    class Recorder:
        def __getattr__(self, name):
            return getattr(np, name)

        def asarray(self, a, *args, **kwargs):
            out = np.asarray(a, *args, **kwargs)
            seen.append(out)
            return out

    real_np, JLP.np = JLP.np, Recorder()
    try:
        JLP.fit_linear_probe_jax(train_x, train_y, probe_x,
                                 np.zeros(d + 1, np.int64), **kw)
    finally:
        JLP.np = real_np
    logits = seen[-1]
    return logits[:d] - logits[d], logits[d]


@pytest.mark.parametrize("n,batch", [(300, 64), (40, 64)])
def test_fit_linear_probe_torch_matches_jax(n, batch):
    """Weights within 1e-4 of the JAX probe's and the same accuracy; with
    ``n < batch_size`` (the second case) no step runs in either, and the
    weights stay zero: the JAX loop's dropped remainder, kept."""
    from msclip_tpu.eval.linear_probe import fit_linear_probe_jax

    rng = np.random.default_rng(n)
    centers = rng.standard_normal((4, 16)).astype(np.float32)
    y = rng.integers(0, 4, n)
    x = (centers[y] + rng.standard_normal((n, 16))).astype(np.float32)
    ty = rng.integers(0, 4, 50)
    tx = (centers[ty] + rng.standard_normal((50, 16))).astype(np.float32)
    kw = dict(epochs=20, batch_size=batch, seed=3, n_classes=4)
    w, b = LP.train_linear_probe_torch(x, y, 4, epochs=20, batch_size=batch,
                                       seed=3, device="cpu")
    jw, jb = _jax_probe_weights(x, y, **kw)
    np.testing.assert_allclose(w.numpy(), jw, atol=1e-4, rtol=0)
    np.testing.assert_allclose(b.numpy(), jb, atol=1e-4, rtol=0)
    if n < batch:
        assert not w.any() and not b.any()
    else:
        assert np.abs(w.numpy()).max() > 1e-3
    got = LP.fit_linear_probe_torch(x, y, tx, ty, device="cpu", **kw)
    assert got == fit_linear_probe_jax(x, y, tx, ty, **kw)


def test_sklearn_probe_without_sklearn_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.linear_model", None)
    x = np.zeros((4, 2), np.float32)
    with pytest.raises(ImportError, match="--probe torch"):
        LP.fit_linear_probe_sklearn(x, np.arange(4) % 2, x, np.arange(4) % 2)


def test_run_linear_probe_matches_jax(ckpt, tmp_path):
    """The whole probe on a CIFAR-10 fixture (BN unfolded): the torch probe
    gives the JAX probe's accuracy, and the sklearn one the JAX sklearn
    one's."""
    from msclip_tpu.eval.linear_probe import \
        run_linear_probe as jax_run_linear_probe
    from msclip_tpu.eval.zero_shot import make_dataset as jax_make_dataset

    root, _ = cifar10(str(tmp_path / "c10"), n_train=(8, 8, 8, 8, 8),
                      n_test=12)
    cfg, jcfg = _configs(ckpt[0], os.path.join(DS_DIR, "cifar-10.yaml"),
                         "DATASET.ROOT", root)
    kw = dict(epochs=10, batch_size=16, seed=1)
    splits = [ZS.make_dataset(cfg, image_set=s) for s in ("train", "test")]
    jsplits = [jax_make_dataset(jcfg, image_set=s) for s in ("train", "test")]
    got = LP.run_linear_probe(cfg, *splits, probe="torch", device="cpu", **kw)
    want = jax_run_linear_probe(jcfg, *jsplits, probe="jax", **kw)
    assert got == want
    assert LP.run_linear_probe(cfg, *splits, probe="sklearn", device="cpu") \
        == jax_run_linear_probe(jcfg, *jsplits, probe="sklearn")


def test_recall_at_k_matches_jax():
    from msclip_tpu.eval.retrieval import recall_at_k as jax_recall

    rng = np.random.default_rng(0)
    sim = rng.standard_normal((30, 40))
    gt = rng.integers(0, 40, 30)
    assert R.recall_at_k(sim, gt) == jax_recall(sim, gt)
    assert R.recall_at_k(np.eye(5), np.arange(5), ks=(1,)) == {1: 100.0}


def test_run_retrieval_matches_jax(ckpt, tmp_path):
    """A Karpathy fixture, BN folded as the retrieval CLIs fold it: the
    JAX recalls, and features within 1e-5 (the caption chunks padded by
    repeating row 0 in both)."""
    from msclip_tpu.data.retrieval_datasets import \
        load_karpathy_split as jax_load
    from msclip_tpu.eval.retrieval import encode_corpus as jax_encode
    from msclip_tpu.eval.retrieval import run_retrieval as jax_run_retrieval
    from msclip_torch.data.retrieval_datasets import load_karpathy_split
    from msclip_torch.data.transforms import pil_eval_transform

    images, ann = karpathy(str(tmp_path), n_images=6, per_image=3)
    tf = lambda img: pil_eval_transform(img, size=64)  # noqa: E731
    ds, caps, cap2img = load_karpathy_split(images, ann, transform=tf)
    jds, jcaps, jcap2img = jax_load(images, ann, transform=tf)
    _, model = _port_model(ckpt[0], fold_bn=True)
    jm, jp = _jax_model(ckpt[0], fold_bn=True)
    got = R.encode_corpus(model, ds, caps, batch_size=4, workers=2)
    want = jax_encode(jm, jp, jds, jcaps, batch_size=4, workers=2)
    assert got[1].shape == (18, 32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0)
    out = R.run_retrieval(model, ds, caps, cap2img, batch_size=4, workers=2)
    assert out == jax_run_retrieval(jm, jp, jds, jcaps, jcap2img,
                                    batch_size=4, workers=2)


def _write_ds_yaml(path, base, root):
    import yaml

    with open(os.path.join(DS_DIR, base)) as f:
        d = yaml.safe_load(f)
    d["DATASET"]["ROOT"] = root
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return str(path)


def test_eval_zeroshot_runs_each_dataset(ckpt, tmp_path):
    """The dispatcher runs one port job per dataset with the forwarded
    device and overrides (each job prints its dataset's metric), and
    refuses an unknown name before any job."""
    from msclip_torch.tools import eval_zeroshot

    voc_root, _ = voc2007(str(tmp_path / "voc"), n=6)
    hm_root, _ = hatefulmemes(str(tmp_path / "hm"), n_val=4)
    ct_root, _ = caltech101(str(tmp_path / "ct"), per_class=(31, 32),
                            classes=("accordion", "anchor"))
    ds = ",".join([_write_ds_yaml(tmp_path / "voc.yaml", "voc2007.yaml",
                                  voc_root),
                   _write_ds_yaml(tmp_path / "hm.yaml", "hatefulmemes.yaml",
                                  hm_root),
                   _write_ds_yaml(tmp_path / "ct.yaml", "caltech-101.yaml",
                                  ct_root)])
    r = subprocess.run(
        [sys.executable, "-m", "msclip_torch.tools.eval_zeroshot",
         "--model", MODEL_YAML, "--ds", ds, "--device", "cpu",
         "MODEL.PRETRAINED_MODEL", str(ckpt[0]),
         "OUTPUT_DIR", str(tmp_path / "out")] + TINY_OPTS,
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    results = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT")]
    assert [ln.split()[1] for ln in results] == [
        "voc2007classification", "hatefulmemes", "caltech-101"]
    for line, metric in zip(results, ("11point_mAP=", "roc_auc=",
                                      "mean-per-class=")):
        assert metric in line
    assert "voc2007" in eval_zeroshot.registered_datasets()
    assert len(eval_zeroshot.registered_datasets()) == 25
    with pytest.raises(ValueError, match="unknown dataset 'no-such-set'"):
        eval_zeroshot.main(["--model", MODEL_YAML, "--ds",
                            "voc2007,no-such-set", "--device", "cpu"])


def test_export_checkpoint_round_trip(ckpt, tmp_path):
    """The export of the JAX-exported checkpoint: the same keys as
    ``export_torch_state_dict``, every tensor bit for bit."""
    from msclip_torch.tools import export_torch_checkpoint

    out = tmp_path / "export.pth"
    export_torch_checkpoint.main(["--model", MODEL_YAML, "--ckpt",
                                  str(ckpt[0]), "--out", str(out),
                                  "--device", "cpu"] + TINY_OPTS)
    got = torch.load(out, weights_only=True)
    want = ckpt[1]
    assert set(got) == set(want)
    assert any(k.startswith("transformer.resblocks.") and "in_proj" in k
               for k in got)  # the aliased shared keys
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_feature_probe_and_retrieval_clis(ckpt, tmp_path, capsys):
    """extract_features, linear_probe (the torch probe) and retrieval on
    the CPU through their mains, each printing its RESULT line."""
    from msclip_torch.tools import extract_features, linear_probe, retrieval

    root, _ = cifar10(str(tmp_path / "c10"))
    common = ["--ds", os.path.join(DS_DIR, "cifar-10.yaml"), "--model",
              MODEL_YAML, "--device", "cpu"]
    opts = TINY_OPTS + ["MODEL.PRETRAINED_MODEL", str(ckpt[0]),
                        "DATASET.ROOT", root,
                        "OUTPUT_DIR", str(tmp_path / "out")]
    out = tmp_path / "f.npz"
    extract_features.main(common + ["--out", str(out), "--image-set",
                                    "train"] + opts)
    saved = np.load(out)
    assert saved["features"].shape == (13, 32)
    assert saved["labels"].shape == (13,)
    acc = linear_probe.main(common + ["--probe", "torch"] + opts)
    assert 0.0 <= acc <= 100.0
    images, ann = karpathy(str(tmp_path / "k"))
    res = retrieval.main(["--model", MODEL_YAML, "--ann", ann, "--images",
                          images, "--device", "cpu"] + opts)
    assert set(res["i2t"]) == {1, 5, 10}
    printed = capsys.readouterr().out
    assert "RESULT saved (13, 32)" in printed
    assert "RESULT cifar-10 linear_probe=" in printed
    assert "RESULT retrieval i2t_r1=" in printed
    assert os.listdir(tmp_path / "out" / "cifar-10" / "b32-yfcc-msclips")


def test_eval_released_missing_ckpt_fails_loudly():
    from msclip_torch.tools import eval_released

    with pytest.raises(SystemExit, match="checkpoint not found"):
        eval_released.main(["--ckpt", "/nonexistent/b32.pth",
                            "--device", "cpu"])


def test_eval_released_tiers_at_tiny_width(ckpt, tmp_path, monkeypatch,
                                           capsys):
    """Both tiers with the model config cut to the tiny geometry: strict
    conversion and a finite unit-norm forward, then zero-shot on a
    synthetic ImageFolder, which fails as an incomplete val set."""
    from msclip_torch.tools import eval_released

    cfg = get_default_config()
    update_config(cfg, os.path.join(eval_released.CONFIG_DIR,
                                    "b32-yfcc-msclips.json"),
                  opts=TINY_OPTS + ["TEST.SUBSET_CLASSES", "4"])
    (tmp_path / "cfg").mkdir()
    with open(tmp_path / "cfg" / "b32-yfcc-msclips.json", "w") as f:
        json.dump(cfg.to_dict(), f)
    monkeypatch.setattr(eval_released, "CONFIG_DIR", str(tmp_path / "cfg"))
    argv = ["--ckpt", str(ckpt[0]), "--device", "cpu"]
    eval_released.main(argv)
    assert "[tier 1 OK]" in capsys.readouterr().out
    caltech101(str(tmp_path / "in"), per_class=(2, 2), classes=(
        "n01440764", "n01443537"))
    val = tmp_path / "in" / "101_ObjectCategories"
    with pytest.raises(SystemExit, match="val set incomplete: 5 images"):
        eval_released.main(argv + ["--imagenet", str(val), "--batch", "4"])
    assert "zero-shot IN-1K top-1" in capsys.readouterr().out


@pytest.mark.slow
def test_eval_released_tier1_full_width(tmp_path):
    """Full-width B/32: random weights -> ``export_state_dict`` -> the
    tier-1 gate as a subprocess on the CPU."""
    from msclip_torch.models.msclip import init_params, spec_from_config
    from msclip_torch.utils.convert import export_state_dict

    cfg = get_default_config()
    update_config(cfg, os.path.join(REPO, "msclip_torch", "config",
                                    "b32-yfcc-msclips.json"))
    spec = spec_from_config(cfg)
    ckpt = tmp_path / "b32-yfcc.pth"
    torch.save(export_state_dict(
        init_params(spec, torch.Generator().manual_seed(0)), spec), ckpt)
    r = subprocess.run(
        [sys.executable, "-m", "msclip_torch.tools.eval_released", "--ckpt",
         str(ckpt), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[tier 1 OK]" in r.stdout and "36.7" in r.stdout


@pytest.mark.parametrize("entry", ["eval_zeroshot", "extract_features",
                                   "linear_probe", "retrieval",
                                   "eval_released", "export_torch_checkpoint"])
def test_new_entry_points_default_to_the_card(monkeypatch, tmp_path, entry):
    """Every entry point of this eval surface runs on the card unless asked
    for the CPU, and raises where there is none, before any work."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"msclip_torch.tools.{entry}")
    cfg = os.path.join(REPO, "msclip_torch", "config", "b32-yfcc-msclips.json")
    argv = {"eval_zeroshot": ["--model", cfg, "--ds", "voc2007"],
            "extract_features": ["--ds", cfg, "--model", cfg],
            "linear_probe": ["--ds", cfg, "--model", cfg],
            "retrieval": ["--model", cfg, "--ann", "a.json", "--images", "i"],
            "eval_released": ["--ckpt", str(tmp_path / "x.pth")],
            "export_torch_checkpoint": ["--model", cfg, "--out",
                                        str(tmp_path / "o.pth")]}[entry]
    with pytest.raises(RuntimeError, match="CUDA device"):
        mod.main(argv)
    assert not os.listdir(tmp_path)

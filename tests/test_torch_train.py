"""The port's train slice against the JAX package's, fp32 on the CPU: BN in
training mode, the InfoNCE loss, the schedule, the param groups, the
optimizer, the loss and every gradient of the train step, four steps of
training, the synthetic pairs and the loader's order, and the train CLI.

The tiny MS-CLIP-S geometry of ``reference_oracle.tiny_msclips_config``
(width 128, 64-pixel images) with 6 layers, so that the lateral adapters
at layers 2 and 4 and the shared text blocks all run; weights drawn with
numpy (``torch_port_params``) and carried across with ``params_from_jax``.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from msclip_tpu.data.loader import BatchLoader as JaxBatchLoader
from msclip_tpu.data.pairs import SyntheticPairDataset as JaxPairs
from msclip_tpu.models import build_model as jax_build_model
from msclip_tpu.models import layers as JL
from msclip_tpu.parallel import infonce_loss as jax_infonce_loss
from msclip_tpu.train import optim as JO
from msclip_tpu.train.trainer import init_train_state as jax_init_state
from msclip_tpu.train.trainer import make_loss_fn as jax_make_loss_fn
from msclip_tpu.train.trainer import make_train_step as jax_make_train_step
from msclip_torch.data.loader import BatchLoaderPairs
from msclip_torch.data.pairs import SyntheticPairDataset, make_train_dataset
from msclip_torch.models import layers as TL
from msclip_torch.models import msclip as TM
from msclip_torch.models.stem import BNState
from msclip_torch.parallel.infonce import infonce_loss
from msclip_torch.train import optim as TO
from msclip_torch.train import trainer as TT
from msclip_torch.utils.convert import _from_jax, _get_path, build_key_map
from msclip_torch.utils.convert import params_from_jax

from reference_oracle import tiny_msclips_config
from torch_port_params import random_jax_params
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS_PER_EPOCH = 10


def _cfg():
    """Tiny MS-CLIP-S with the JAX train tests' optimizer recipe: warmup
    over one epoch, both weight-decay groups, a shared-tensor LR and WD."""
    cfg = tiny_msclips_config(layers=6)
    cfg.TRAIN.LR = 1e-3
    cfg.TRAIN.WD = 0.05
    cfg.TRAIN.WITHOUT_WD_LIST = ["bn", "bias", "ln"]
    cfg.TRAIN.END_EPOCH = 4
    cfg.TRAIN.LR_SCHEDULER.merge_from_dict(
        {"METHOD": "timm",
         "ARGS": {"warmup_epochs": 1, "warmup_lr": 1e-6, "min_lr": 1e-5}})
    cfg.CUSTOM.LR_SHARE = 2e-3
    cfg.CUSTOM.WD_SHARE = 0.2
    return cfg


@pytest.fixture(scope="module")
def tiny():
    cfg = _cfg()
    jm = jax_build_model(cfg)
    jp = random_jax_params(jm, seed=0)
    spec = TM.spec_from_config(cfg)
    return cfg, jm, jp, spec


def _batch(b=4, image=64, vocab=512, seed=7):
    ds = SyntheticPairDataset(n=b, size=image, vocab_size=vocab, seed=seed)
    images, tokens = zip(*(ds[i] for i in range(b)))
    return np.stack(images), np.stack(tokens)


def _jax_leaf(tree, spec, key):
    stored, _ = build_key_map(spec)
    path, kind = stored[key]
    return _from_jax(_get_path(tree, path), kind)


def _bn_paths(spec):
    """Reference BN prefix -> the JAX package's BNState update path."""
    stored, _ = build_key_map(spec)
    return {k[:-len(".running_mean")]:
            "/".join(str(p) for p in stored[k][0][:-1])
            for k in stored if k.endswith(".running_mean")}


# ---------------------------------------------------------------------------
# layers and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_batch_norm_training_matches_jax(eps):
    rng = np.random.default_rng(0)
    x = (3 + 2 * rng.standard_normal((4, 8, 5, 5))).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
         "bias": rng.standard_normal(8).astype(np.float32),
         "mean": rng.standard_normal(8).astype(np.float32),
         "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}
    want, stats = JL.batch_norm({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), eps=eps, training=True,
                                layout="NCHW")
    tp = {f"bn.{n}": torch.from_numpy(p[k]) for n, k in (
        ("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
        ("running_var", "var"))}
    got, (mean, var) = TL.batch_norm(torch.from_numpy(x), tp, "bn", eps,
                                     training=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(stats["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(stats["var"]),
                               rtol=1e-5)


def test_drop_path_keeps_or_drops_whole_samples():
    x = torch.ones(2000, 3, 4)
    gen = torch.Generator().manual_seed(0)
    y = TL.drop_path(x, 0.25, TL.drop_path_keep(x, 0.25, gen))
    per_sample = y.flatten(1)
    assert set(per_sample.unique().tolist()) == {0.0, float(
        torch.tensor(1.0) / 0.75)}
    assert (per_sample == per_sample[:, :1]).all()
    assert abs((per_sample[:, 0] > 0).float().mean().item() - 0.75) < 0.05


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_infonce_matches_jax(label_smoothing):
    rng = np.random.default_rng(1)
    fi, ft = (rng.standard_normal((6, 16)).astype(np.float32)
              for _ in range(2))
    fi /= np.linalg.norm(fi, axis=1, keepdims=True)
    ft /= np.linalg.norm(ft, axis=1, keepdims=True)
    scale = np.float32(math.log(1 / 0.07))
    want = jax_infonce_loss(jnp.asarray(fi), jnp.asarray(ft),
                            jnp.asarray(scale), label_smoothing)
    got = infonce_loss(torch.from_numpy(fi), torch.from_numpy(ft),
                       torch.tensor(scale), label_smoothing)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_training_logits_are_the_scaled_similarities(tiny):
    _, _, jp, spec = tiny
    tp = params_from_jax(jp, spec)
    images, tokens = (torch.from_numpy(a) for a in _batch())
    logits = TM.forward(tp, spec, images, tokens,
                        bn=BNState(training=True))
    fi = TM.encode_image(tp, spec, images, bn=BNState(training=True))
    ft = TM.encode_text(tp, spec, tokens)
    torch.testing.assert_close(
        logits, torch.exp(tp["logit_scale"]) * fi @ ft.t())


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["timm", "constant"])
def test_schedule_matches_optax_step_by_step(method):
    cfg = _cfg()
    cfg.TRAIN.END_EPOCH = 6
    cfg.TRAIN.LR_SCHEDULER.METHOD = method
    cfg.TRAIN.LR_SCHEDULER.ARGS.cooldown_epochs = 1
    want = JO.build_schedule(cfg, 3)
    got = TO.build_schedule(cfg, 3)
    # optax computes in fp32: warmup_lr comes out of (warmup_lr - lr) + lr,
    # so an fp32 ulp of TRAIN.LR is the absolute tolerance
    for step in range(22):  # warmup 0-2, cosine 3-14, cooldown 15-
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-7 * cfg.TRAIN.LR,
                                   err_msg=f"step {step}")
    assert got(0) == pytest.approx(1e-6 if method == "timm" else 1e-3)


def test_param_groups_and_wd_mask_match_jax(tiny):
    cfg, jm, jp, spec = tiny
    stored, _ = build_key_map(spec)
    tp = params_from_jax(jp, spec)
    labels = TO.param_labels(tp, spec)
    mask = TO.wd_mask(tp, list(cfg.TRAIN.WITHOUT_WD_LIST))
    jlabels = JO.param_labels(jp, jm.spec)
    jmask = JO.wd_mask(jp, list(cfg.TRAIN.WITHOUT_WD_LIST))
    for key, (path, _) in stored.items():
        if TM.is_bn_stat(key):
            assert _get_path(jlabels, path) == "state" and key not in labels
            continue
        assert labels[key] == _get_path(jlabels, path), key
        assert mask[key] == _get_path(jmask, path), key
    assert set(labels.values()) == {"regular", "shared"}
    assert set(mask.values()) == {True, False}


def test_optimizer_with_clipping_matches_optax(tiny):
    """Three AdamW steps, both LR groups and both WD groups, the same random
    gradients, clipped by their global norm (which is above the limit):
    the parameters agree to float rounding."""
    cfg, jm, jp, spec = tiny
    cfg = cfg.clone()
    cfg.TRAIN.CLIP_GRAD_NORM = 0.5
    stored, _ = build_key_map(spec)
    tx, _ = JO.build_optimizer(cfg, jp, jm.spec, STEPS_PER_EPOCH)
    jparams = jax.tree.map(jnp.asarray, jp)
    opt_state = tx.init(jparams)

    @jax.jit
    def jax_step(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    model = TM.MSClipModel(spec, params_from_jax(jp, spec), trainable=True)
    named = dict(model.named_parameters())
    optimizer, scheduler = TO.build_optimizer(cfg, model.params(), spec,
                                              STEPS_PER_EPOCH)
    rng = np.random.default_rng(3)
    for _ in range(3):
        def draw(path, leaf):
            if getattr(path[-1], "key", None) in ("mean", "var"):
                return np.zeros(leaf.shape, np.float32)  # BN state
            return rng.standard_normal(leaf.shape).astype(np.float32)

        grads = jax.tree_util.tree_map_with_path(draw, jp)
        jparams, opt_state = jax_step(jax.tree.map(jnp.asarray, grads),
                                      opt_state, jparams)
        for key, p in named.items():
            p.grad = _jax_leaf(grads, spec, key)
        norm = TO.global_norm([p.grad for p in named.values()])
        assert norm.item() > cfg.TRAIN.CLIP_GRAD_NORM
        TO.clip_by_global_norm_([p.grad for p in named.values()],
                                cfg.TRAIN.CLIP_GRAD_NORM, norm)
        optimizer.step()
        scheduler.step()
    for key, p in named.items():
        np.testing.assert_allclose(
            p.detach().numpy(), _jax_leaf(jparams, spec, key).numpy(),
            atol=2e-7, rtol=1e-6, err_msg=key)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_step(tiny):
    """The JAX loss, gradients and BN updates of one batch, and the port's,
    from the same weights."""
    _, jm, jp, spec = tiny
    images, tokens = _batch()
    (jloss, jbn), jgrads = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(jm.spec), has_aux=True))(
        jp, jnp.asarray(images), jnp.asarray(tokens))
    model = TM.MSClipModel(spec, params_from_jax(jp, spec), trainable=True)
    loss, bn = TT.make_loss_fn(spec)(model.params(),
                                     torch.from_numpy(images),
                                     torch.from_numpy(tokens))
    loss.backward()
    return (float(jloss), jbn, jgrads), (loss.item(), bn, model)


def test_train_step_loss_matches_jax(one_step):
    """fp32 through 5 trunk and 6 text blocks, sums in another order than
    XLA's (measured: 1.2e-7 on a loss of about ln(4))."""
    (jloss, _, _), (loss, _, _) = one_step
    assert math.isfinite(loss)
    assert abs(loss - jloss) <= 1e-5


def test_train_step_gradients_match_jax(one_step, tiny):
    """Every parameter gradient, mapped to the reference key, within
    1e-5 of the largest of its tensor (at least 1): the backward runs
    through the same fp32 graph, summed in another order (measured: at
    most 1.7e-7 on gradients of up to 3e-2)."""
    _, _, _, spec = tiny
    (_, _, jgrads), (_, _, model) = one_step
    n = 0
    for key, p in model.named_parameters():
        want = _jax_leaf(jgrads, spec, key)
        got = torch.zeros_like(p) if p.grad is None else p.grad
        bound = 1e-5 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= bound, key
        n += 1
    assert n == len(TO.param_labels(model.params(), spec))


def test_train_step_bn_running_stats_match_jax(one_step, tiny):
    _, _, _, spec = tiny
    (_, jbn, _), (_, bn, _) = one_step
    paths = _bn_paths(spec)
    assert set(bn) == {k for k, v in paths.items() if v in jbn}
    assert len(bn) > 10  # stem, branch stages 0-1, adapters 0-1
    for prefix, (mean, var) in bn.items():
        want = jbn[paths[prefix]]
        np.testing.assert_allclose(mean.numpy(), np.asarray(want["mean"]),
                                   atol=1e-5, err_msg=prefix)
        np.testing.assert_allclose(var.numpy(), np.asarray(want["var"]),
                                   rtol=1e-4, atol=1e-5, err_msg=prefix)


def test_four_train_steps_match_jax(tiny):
    """Four full steps (forward, backward, AdamW with both groups,
    schedule, BN write-back, logit_scale clamp) on four batches: the loss
    of each step within 1e-4 of the JAX step's, the BN running stats of
    the stem within 1e-4 after the last."""
    cfg, jm, jp, spec = tiny
    tx, _ = JO.build_optimizer(cfg, jp, jm.spec, STEPS_PER_EPOCH)
    jstate = jax_init_state(jm, tx, params=jax.tree.map(jnp.asarray, jp))
    jstep = jax_make_train_step(jm.spec, tx, donate=False)
    state = TT.init_train_state(cfg, spec, params_from_jax(jp, spec),
                                STEPS_PER_EPOCH, "cpu")
    step = TT.make_train_step(spec)
    for i in range(4):
        images, tokens = _batch(seed=10 + i)
        jstate, jmet = jstep(jstate, jnp.asarray(images), jnp.asarray(tokens))
        metrics = step(state, torch.from_numpy(images),
                       torch.from_numpy(tokens))
        assert abs(metrics["loss"].item() - float(jmet["loss"])) <= 1e-4, i
        np.testing.assert_allclose(metrics["grad_norm"].item(),
                                   float(jmet["grad_norm"]), rtol=1e-4)
    assert state.step == 4
    key = f"{spec.stem_prefix}.bn1.running_mean"
    np.testing.assert_allclose(
        state.model.params()[key].numpy(),
        _jax_leaf(jstate.params, spec, key).numpy(), atol=1e-4)


def test_train_step_clamps_logit_scale_and_tracks_the_ema(tiny):
    cfg, _, jp, spec = tiny
    cfg = cfg.clone()
    cfg.TRAIN.EMA_DECAY = 0.9
    params = params_from_jax(jp, spec)
    params["logit_scale"] = torch.tensor(TT.MAX_LOGIT_SCALE + 0.5)
    state = TT.init_train_state(cfg, spec, params, STEPS_PER_EPOCH, "cpu")
    before = {k: v.clone() for k, v in state.ema.items()}
    images, tokens = (torch.from_numpy(a) for a in _batch())
    metrics = TT.make_train_step(spec)(state, images, tokens)
    assert metrics["logit_scale"].item() == pytest.approx(TT.MAX_LOGIT_SCALE)
    now = state.model.params()
    for k in ("visual.proj", f"{spec.stem_prefix}.bn1.running_mean"):
        torch.testing.assert_close(state.ema[k],
                                   0.9 * before[k] + 0.1 * now[k])


def test_trainable_model_has_parameters_and_bn_buffers(tiny):
    _, _, jp, spec = tiny
    tp = params_from_jax(jp, spec)
    model = TM.MSClipModel(spec, tp, trainable=True)
    assert set(model.state_dict()) == set(tp)
    buffers = dict(model.named_buffers())
    assert buffers and all(TM.is_bn_stat(k) for k in buffers)
    assert set(dict(model.named_parameters())) | set(buffers) == set(tp)
    assert not any(b.requires_grad for b in buffers.values())


# ---------------------------------------------------------------------------
# data and CLI
# ---------------------------------------------------------------------------

def test_synthetic_pairs_match_jax():
    ours = SyntheticPairDataset(n=5, size=32, vocab_size=512, seed=3)
    theirs = JaxPairs(n=5, size=32, vocab_size=512, seed=3)
    for i in range(5):
        for a, b in zip(ours[i], theirs[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [5, 9])
def test_loader_order_matches_jax(seed):
    """Pinned epochs and the epoch a bare ``__iter__`` advances to."""
    ds = SyntheticPairDataset(n=10, size=8, vocab_size=64)
    ours = BatchLoaderPairs(ds, 3, workers=2, seed=seed)
    theirs = JaxBatchLoader(ds, 3, workers=2, shuffle=True, seed=seed,
                            drop_last=True)
    assert ours.num_batches == theirs.num_batches == 3
    for epoch in (0, 2, None):
        if epoch is not None:
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
        for a, b in zip(ours, theirs, strict=True):
            np.testing.assert_array_equal(a["tokens"], b["label"])
            np.testing.assert_array_equal(a["image"], b["image"])


def test_only_synthetic_pairs_are_ported(tmp_path):
    """Every training source the JAX package reads: the same dataset kind,
    length and samples (eval transform) as ``make_train_dataset`` of the
    JAX package, for synthetic pairs, a caption folder, a TSV list and tar
    shards (the order in which the config is read: shards, TSV,
    synthetic, folder)."""
    from msclip_tpu.data.pairs import make_train_dataset as jax_make
    from msclip_tpu.data.transforms import (
        pil_eval_transform as jax_pil_eval_transform)
    from msclip_torch.data.transforms import pil_eval_transform

    from torch_pair_fixtures import write_folder, write_shards, write_tsv

    cfg = _cfg()
    cfg.DATASET.DATASET = "synthetic"
    cfg.DATASET.NUM_SAMPLES = 6
    cases = {"SyntheticPairDataset": []}
    write_folder(str(tmp_path / "root" / "train"), 3)
    cases["FolderPairDataset"] = [("DATASET.DATASET", "yfcc"),
                                  ("DATASET.ROOT", str(tmp_path / "root"))]
    cases["TsvPairDataset"] = [("DATASET.TRAIN_TSV_LIST",
                                [write_tsv(str(tmp_path / "tsv"), 3)])]
    cases["TarShardPairDataset"] = cases["TsvPairDataset"] + [
        ("DATASET.TRAIN_SHARD_LIST",
         write_shards(str(tmp_path / "shards"), 2, 2))]
    for kind, opts in cases.items():
        c = cfg.clone()
        for key, value in opts:
            node, leaf = key.split(".")
            c[node][leaf] = value
        ours, theirs = make_train_dataset(c), jax_make(c)
        assert type(ours).__name__ == type(theirs).__name__ == kind
        assert len(ours) == len(theirs) > 0
        if kind != "SyntheticPairDataset":  # each package's eval transform
            ours.transform, theirs.transform = (pil_eval_transform,
                                                jax_pil_eval_transform)
        for i in range(len(ours)):
            for a, b in zip(ours[i], theirs[i]):
                np.testing.assert_array_equal(a, b)


def _tiny_cli_config(tmp_path):
    with open(os.path.join(REPO, "msclip_torch", "config",
                           "b32-yfcc-msclips.json")) as f:
        cfg = json.load(f)
    spec = cfg["MODEL"]["SPEC"]
    spec["EMBED_DIM"] = 64
    spec["VISION"]["WIDTH"] = 128
    spec["TEXT"].update(WIDTH=128, HEADS=2, VOCAB_SIZE=512)
    cfg["TRAIN"].update(IMAGE_SIZE=[64, 64], BATCH_SIZE_PER_GPU=4,
                        END_EPOCH=1)
    cfg["DATASET"] = {"DATASET": "synthetic", "NUM_SAMPLES": 8}
    cfg.update(PRINT_FREQ=1, WORKERS=2, OUTPUT_DIR=str(tmp_path / "out"))
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_train_cli_on_the_cpu(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "msclip_torch.tools.train", "--cfg",
         _tiny_cli_config(tmp_path), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    result = r.stdout.strip().splitlines()[-1].split()
    fields = dict(kv.split("=") for kv in result[1:])
    assert result[0] == "RESULT" and fields["steps"] == "2"
    assert math.isfinite(float(fields["final_loss"]))


@pytest.mark.parametrize("sampler", ["chunk", "default"])
def test_train_rejects_an_unported_sampler(tmp_path, sampler):
    """Every pair sampler trains: ``train`` with ``DATASET.SAMPLER`` runs
    its epoch, and its loader yields the batches of the JAX driver's
    (``BatchLoader`` with ``drop_last``, equal stripes, one process)."""
    from msclip_torch.config import get_default_config, update_config
    from msclip_torch.tools.train import train

    cfg = get_default_config()
    update_config(cfg, _tiny_cli_config(tmp_path),
                  opts=["DATASET.SAMPLER", sampler])
    _, stats = train(cfg, device="cpu")
    assert stats["steps"] == 2 and all(map(math.isfinite, stats["losses"]))
    assert len(stats["step_ms"]) == 2 and min(stats["step_ms"]) > 0
    ds = SyntheticPairDataset(n=10, size=8, vocab_size=64)
    ours = BatchLoaderPairs(ds, 3, workers=2, seed=4, sampler=sampler)
    theirs = JaxBatchLoader(ds, 3, workers=2, shuffle=True, seed=4,
                            drop_last=True, shard=(0, 1), sampler=sampler,
                            equal_shards=True)
    ours.chunk_size = theirs.chunk_size = 4
    for a, b in zip(ours, theirs, strict=True):
        np.testing.assert_array_equal(a["tokens"], b["label"])


def test_train_cli_needs_a_card_or_the_cpu_flag(tmp_path, monkeypatch):
    from msclip_torch.tools import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--cfg", _tiny_cli_config(tmp_path)])

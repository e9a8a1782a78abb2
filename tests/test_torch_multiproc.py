"""The port's multi-process layer in two gloo processes on the CPU, against
the JAX package on its 8-device CPU mesh (``data=2``) and against one
process fed the concatenated batch, fp32.

One launch of ``tests/torch_multiproc_worker.py`` (two processes, every
check in one process group) runs while this process computes the JAX
references; the tests read what the two ranks wrote. The tiny MS-CLIP-S
geometry and optimizer recipe of ``test_torch_train.py`` (width 128,
64-pixel images, 6 layers; warmup from 1e-6), weights drawn with numpy
(``torch_port_params``), a global batch of 8 pairs (4 a process).

The gradient convention (``msclip_torch/parallel/collectives.py``): each
process's backward is that of its own part of the loss, so the *mean* of
the processes' gradients, which the train step's all-reduce takes, is the
global gradient. A loss function's gradient of a process's features is
therefore ``world`` times the global loss's, and its ``logit_scale``
gradients average to the global one; the tests hold exactly that.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from msclip_tpu.models import build_model as jax_build_model
from msclip_tpu.parallel import create_mesh as jax_create_mesh
from msclip_tpu.parallel import infonce as JI
from msclip_tpu.train import optim as JO
from msclip_tpu.train.trainer import init_train_state as jax_init_state
from msclip_tpu.train.trainer import make_loss_fn as jax_make_loss_fn
from msclip_tpu.train.trainer import make_train_step as jax_make_train_step
from msclip_torch.config import get_default_config, update_config
from msclip_torch.models import msclip as TM
from msclip_torch.parallel.mesh import Mesh
from msclip_torch.tools.dryrun import free_port, run_steps
from msclip_torch.utils.convert import _from_jax, _get_path, build_key_map
from msclip_torch.utils.convert import params_from_jax

from reference_oracle import tiny_msclips_config
from torch_port_params import random_jax_params
from torch_threads import one_torch_thread  # noqa: F401
from torch_transfer_fixtures import (MODEL_YAML, REPO, TINY_OPTS,
                                     tiny_checkpoint, voc2007)

WORLD = 2
ROWS = 4  # a process
STEPS_PER_EPOCH = 10  # the optimizer schedule's (dryrun.run_steps)
LOSS_B, LOSS_E, LOSS_SCALE = 48, 16, 0.5
DS_DIR = os.path.join(REPO, "experiments", "dataset")


def _train_cfg():
    """``test_torch_train._cfg``: warmup over one epoch from 1e-6, both
    weight-decay groups, a shared-tensor LR and WD."""
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


def _feats(b, e, seed):
    f = np.random.default_rng(seed).standard_normal((b, e)).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


def _batch(b, seed=5):
    from msclip_torch.data.pairs import SyntheticPairDataset

    ds = SyntheticPairDataset(n=b, size=64, vocab_size=512, seed=seed)
    images, tokens = zip(*(ds[i] for i in range(b)))
    return np.stack(images), np.stack(tokens)


def _launch(indir, outdir):
    port = free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(WORLD),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "torch_multiproc_worker.py"),
             str(indir), str(outdir)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def _jax_losses(img, txt):
    """JAX's shard_map losses on ``data=2``: loss, d(img), d(txt),
    d(logit_scale), and the one-device loss's."""
    mesh = jax_create_mesh(data=WORLD, model=1, devices=jax.devices()[:WORLD])
    scale = jnp.asarray(LOSS_SCALE)
    fns = {"sharded": JI.sharded_infonce_loss,
           "chunked": lambda *a, **kw: JI.chunked_sharded_infonce_loss(
               *a, chunk=20, **kw),
           "ring": JI.ring_infonce_loss}
    out = {}
    for ls in (0.0, 0.1):
        def one(i, t, s, ls=ls):
            return JI.infonce_loss(i, t, s, label_smoothing=ls)
        out["single", ls] = (float(one(img, txt, scale)),) + tuple(
            np.asarray(g) for g in jax.grad(one, argnums=(0, 1, 2))(
                jnp.asarray(img), jnp.asarray(txt), scale))
        for name, fn in fns.items():
            def local(i, t, s, fn=fn, ls=ls):
                return fn(i, t, s, axis_name="data", label_smoothing=ls)
            value = shard_map(local, mesh=mesh,
                              in_specs=(P("data"), P("data"), P()),
                              out_specs=P())
            grad = shard_map(jax.grad(local, argnums=(0, 1, 2)), mesh=mesh,
                             in_specs=(P("data"), P("data"), P()),
                             out_specs=(P("data"), P("data"), P()))
            out[name, ls] = (float(value(img, txt, scale)),) + tuple(
                np.asarray(g) for g in grad(img, txt, scale))
    return out


def _jax_steps(jm, jp, images, tokens):
    """JAX's mesh steps on ``data=2``: the loss, gradients and BN updates
    of the global batch, and two steps of the gathered, the chunked and
    the GradCache step (losses, final params)."""
    mesh = jax_create_mesh(data=WORLD, model=1, devices=jax.devices()[:WORLD])
    batch = NamedSharding(mesh, P("data"))
    im = jax.device_put(jnp.asarray(images), batch)
    tk = jax.device_put(jnp.asarray(tokens), batch)
    out = {}
    (loss, bn), grads = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(jm.spec), has_aux=True))(jp, im, tk)
    out["grads"] = (float(loss), jax.device_get(bn), jax.device_get(grads))
    tx, _ = JO.build_optimizer(_train_cfg(), jp, jm.spec, STEPS_PER_EPOCH)
    for mode, kw in (("gathered", {}),
                     ("chunked", {"sharded_loss": True, "loss_chunk": 3}),
                     ("gradcache", {"accum_steps": 2})):
        state = jax_init_state(jm, tx, params=jax.tree.map(jnp.asarray, jp))
        step = jax_make_train_step(jm.spec, tx, mesh=mesh, donate=False, **kw)
        losses = []
        for _ in range(2):
            state, metrics = step(state, images, tokens)
            losses.append(float(metrics["loss"]))
        out[mode] = (losses, jax.device_get(state.params))
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Write the inputs, start the two ranks, compute the JAX references
    and the one-process runs meanwhile, and collect what the ranks
    wrote."""
    indir = tmp_path_factory.mktemp("inputs")
    outdir = tmp_path_factory.mktemp("outputs")
    cfg = _train_cfg()
    jm = jax_build_model(cfg)
    jp = random_jax_params(jm, seed=0)
    spec = TM.spec_from_config(cfg)
    params = params_from_jax(jp, spec)
    images, tokens = _batch(WORLD * ROWS)
    img, txt = _feats(LOSS_B, LOSS_E, 0), _feats(LOSS_B, LOSS_E, 1)
    (indir / "train.json").write_text(json.dumps(cfg))
    torch.save(params, indir / "params.pt")
    np.savez(indir / "batch.npz", images=images, tokens=tokens)
    np.savez(indir / "losses.npz", img=img, txt=txt, scale=LOSS_SCALE)
    ckpt = indir / "tiny.pth"
    tiny_checkpoint(str(ckpt))
    voc_root, _ = voc2007(str(indir / "voc"), n=7)
    common = TINY_OPTS + ["MODEL.PRETRAINED_MODEL", str(ckpt)]
    zero_shot = [
        {"name": "top1", "ds": os.path.join(DS_DIR, "cifar-10.yaml"),
         "model": MODEL_YAML,
         "opts": common + ["DATASET.DATASET", "synthetic",
                           "DATASET.NUM_SAMPLES", "5",
                           "DATASET.NUM_CLASSES", "10",
                           "TEST.SUBSET_CLASSES", "10"]},
        {"name": "map", "ds": os.path.join(DS_DIR, "voc2007.yaml"),
         "model": MODEL_YAML,
         "opts": common + ["DATASET.ROOT", voc_root, "TEST.SAVE_PRED",
                           str(outdir / "pred.npz")]},
    ]
    cli = _cli_config(indir)
    cases = {"zero_shot": zero_shot,
             "checkpoint": {"cfg": cli, "out": str(outdir / "run"),
                            "copy": str(outdir / "one_process"),
                            "tp_out": str(outdir / "tp")}}
    (indir / "cases.json").write_text(json.dumps(cases))

    procs = _launch(indir, outdir)
    try:
        ref = {"losses": _jax_losses(img, txt),
               "jax": _jax_steps(jm, jp, images, tokens),
               "one": {mode: run_steps(_port_cfg(indir, *opts), params,
                                       images, tokens, Mesh(), "cpu")
                       for mode, opts in ONE_PROCESS.items()}}
        for case in zero_shot:
            ref[case["name"]] = _one_process_zero_shot(case)
        logs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]
    ranks = [torch.load(outdir / f"rank{r}.pt", weights_only=True)
             for r in range(WORLD)]
    return {"ranks": ranks, "ref": ref, "spec": spec, "outdir": outdir,
            "cases": cases, "images": images, "tokens": tokens,
            "img": img, "txt": txt}


# the one-process runs on the concatenated batch (the modes of the
# worker's step_checks that have one)
ONE_PROCESS = {
    "gathered": (),
    "dropping": ("MODEL.SPEC.VISION.DROP_PATH", 0.5),
}


def _port_cfg(indir, *opts):
    cfg = get_default_config()
    update_config(cfg, str(indir / "train.json"), opts=[str(o) for o in opts])
    return cfg


def _cli_config(indir):
    """The train CLI's tiny config (``test_torch_train._tiny_cli_config``
    at 6 layers): 16 synthetic pairs, 4 rows a process, checkpoints every
    epoch."""
    with open(os.path.join(REPO, "msclip_torch", "config",
                           "b32-yfcc-msclips.json")) as f:
        cfg = json.load(f)
    spec = cfg["MODEL"]["SPEC"]
    spec["EMBED_DIM"] = 64
    spec["VISION"].update(WIDTH=128, LAYERS=6)
    spec["TEXT"].update(WIDTH=128, HEADS=2, VOCAB_SIZE=512, LAYERS=6)
    cfg["TRAIN"].update(IMAGE_SIZE=[64, 64], BATCH_SIZE_PER_GPU=ROWS,
                        END_EPOCH=2, LR=1e-3)
    cfg["DATASET"] = {"DATASET": "synthetic", "NUM_SAMPLES": 16}
    cfg.update(PRINT_FREQ=1, WORKERS=1)
    path = indir / "cli.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _one_process_zero_shot(case):
    from msclip_torch.eval.zero_shot import run_zero_shot

    cfg = get_default_config()
    update_config(cfg, case["ds"])
    opts = [o for o in case["opts"]]
    if "TEST.SAVE_PRED" in opts:  # keep the ranks' files apart
        i = opts.index("TEST.SAVE_PRED")
        opts[i + 1] = opts[i + 1].replace("pred.npz", "one.npz")
    update_config(cfg, case["model"], opts=opts)
    value, stats = run_zero_shot(cfg, device="cpu")
    return value, stats["n_images"]


def _jax_leaf(tree, spec, key):
    stored, _ = build_key_map(spec)
    path, kind = stored[key]
    return _from_jax(_get_path(tree, path), kind)


def _bn_paths(spec):
    stored, _ = build_key_map(spec)
    return {k[:-len(".running_mean")]:
            "/".join(str(p) for p in stored[k][0][:-1])
            for k in stored if k.endswith(".running_mean")}


# ---------------------------------------------------------------------------
# comm helpers
# ---------------------------------------------------------------------------

def test_comm_helpers_match_the_jax_semantics(world2):
    """``gather_arrays`` concatenates unequal stripes in rank order without
    their padding (3 and 2 rows here), ``reduce_dict`` sums or averages
    on every rank, ``all_gather_object`` lists every rank's object."""
    want = np.concatenate([np.arange(3, dtype=np.float32)[:, None] * 10,
                           np.arange(2, dtype=np.float32)[:, None] * 10 + 1])
    for r, out in enumerate(world2["ranks"]):
        c = out["comm"]
        assert (c["rank"], c["world"]) == (r, WORLD)
        np.testing.assert_array_equal(c["gathered"].numpy(), want)
        assert c["sum"] == {"a": 3.0, "b": 2.0}
        assert c["mean"] == {"a": 1.5, "b": 1.0}
        assert c["objects"] == [{"rank": 0, "tag": "x"},
                                {"rank": 1, "tag": "xx"}]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
@pytest.mark.parametrize("name", ["gathered", "sharded", "chunked", "ring"])
def test_losses_match_jax_and_one_process(world2, name, label_smoothing):
    """Every rank returns the global loss (rtol 1e-5); each rank's
    feature gradients are ``world`` times the global loss's (atol 1e-6,
    JAX's bounds in tests/test_parallel.py), and the ranks' mean
    ``logit_scale`` gradient is the global one, against JAX's shard_map
    loss on ``data=2`` (chunk 20 of 48 columns: a padded tail) and the
    one-device loss on the concatenated batch."""
    ref = world2["ref"]["losses"]
    want = [ref["single", label_smoothing]]
    if name != "gathered":  # no shard_map counterpart of the full matrix
        want.append(ref[name, label_smoothing])
    outs = [o[f"loss/{name}/{label_smoothing}"] for o in world2["ranks"]]
    b = LOSS_B // WORLD
    d_scale = np.mean([o["d_scale"] for o in outs])
    for loss, d_img, d_txt, d_ls in want:
        for r, o in enumerate(outs):
            np.testing.assert_allclose(o["loss"], loss, rtol=1e-5)
            rows = slice(r * b, (r + 1) * b)
            np.testing.assert_allclose(o["d_img"].numpy() / WORLD,
                                       d_img[rows], atol=1e-6)
            np.testing.assert_allclose(o["d_txt"].numpy() / WORLD,
                                       d_txt[rows], atol=1e-6)
        np.testing.assert_allclose(d_scale, float(d_ls), atol=1e-6)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _assert_grads(got, want_of, spec):
    """Every gradient within 1e-5 of the largest of its tensor (at least
    1), ``test_torch_train``'s bound."""
    for key, g in got.items():
        want = want_of(key)
        bound = 1e-5 * max(1.0, want.abs().max().item())
        assert (g - want).abs().max().item() <= bound, key


@pytest.mark.parametrize("mode", ["gathered", "chunked"])
def test_dp_step_matches_the_jax_mesh_step(world2, mode):
    """Two processes of the DP step (training BN) against JAX's
    ``make_train_step`` on a ``data=2`` mesh: the first loss within 1e-5,
    every averaged gradient and the BN running statistics against JAX's
    global-batch ones, the losses of two steps within 1e-5 and the
    parameters after them within 5e-5 (the bound of JAX's own
    mesh-against-single test)."""
    spec = world2["spec"]
    jloss, jbn, jgrads = world2["ref"]["jax"]["grads"]
    jlosses, jparams = world2["ref"]["jax"][mode]
    paths = _bn_paths(spec)
    for out in world2["ranks"]:
        o = out[f"step/{mode}"]
        assert abs(o["losses"][0] - jloss) <= 1e-5
        np.testing.assert_allclose(o["losses"], jlosses, atol=1e-5)
        _assert_grads(o["grads"], lambda k: _jax_leaf(jgrads, spec, k), spec)
        n_bn = 0
        for prefix, path in paths.items():
            if path not in jbn:
                continue
            n_bn += 1
            np.testing.assert_allclose(
                o["bn"][f"{prefix}.running_mean"].numpy(),
                np.asarray(jbn[path]["mean"]), atol=1e-5, err_msg=prefix)
            np.testing.assert_allclose(
                o["bn"][f"{prefix}.running_var"].numpy(),
                np.asarray(jbn[path]["var"]), rtol=1e-4, atol=1e-5,
                err_msg=prefix)
        assert n_bn > 10
        for key, p in o["params"].items():
            np.testing.assert_allclose(
                p.numpy(), _jax_leaf(jparams, spec, key).numpy(), atol=5e-5,
                err_msg=key)


@pytest.mark.parametrize("mode", ["gathered", "dropping"])
def test_dp_step_equals_one_process_on_the_concatenated_batch(world2, mode):
    """The global-batch BatchNorm, the gradient mean and DropPath's global
    masks: two processes of 4 rows give what one process gives on the 8
    rows (losses rtol 1e-5, gradients 1e-5 of their tensor's largest,
    BN statistics 1e-6, parameters after two steps 1e-5; sums in another
    order), and both ranks end with the same parameters."""
    one = world2["ref"]["one"][mode]
    outs = [o[f"step/{mode}"] for o in world2["ranks"]]
    for o in outs:
        np.testing.assert_allclose(o["losses"], one["losses"], rtol=1e-5)
        _assert_grads(o["grads"], lambda k: one["grads"][k],
                      world2["spec"])
        for k, v in o["bn"].items():
            np.testing.assert_allclose(v.numpy(), one["bn"][k].numpy(),
                                       atol=1e-6, err_msg=k)
        for k, p in o["params"].items():
            np.testing.assert_allclose(p.numpy(), one["params"][k].numpy(),
                                       atol=1e-5, err_msg=k)
    for k in outs[0]["params"]:
        assert torch.equal(outs[0]["params"][k], outs[1]["params"][k]), k


def test_sharded_losses_track_the_gathered_step(world2):
    """The chunked (3-column chunks of 8: a padded tail) and the ring
    step against the gathered one, two steps: losses rtol 1e-5,
    parameters atol 1e-5 (tests/test_parallel.py's ring-against-chunked
    bounds)."""
    base = world2["ranks"][0]["step/gathered"]
    for mode in ("chunked", "ring"):
        o = world2["ranks"][0][f"step/{mode}"]
        np.testing.assert_allclose(o["losses"], base["losses"], rtol=1e-5)
        for k, p in o["params"].items():
            np.testing.assert_allclose(p.numpy(), base["params"][k].numpy(),
                                       atol=1e-5, err_msg=f"{mode} {k}")


def test_gradcache_matches_the_jax_mesh_gradcache(world2):
    """``TPU.ACCUM_STEPS 2`` under two processes (microbatch ``i`` is each
    rank's ``i``-th block, BN statistics over the global microbatch)
    against JAX's mesh GradCache step: losses rtol 1e-5, parameters after
    two steps atol 2e-5 (tests/test_train.py's GradCache bounds)."""
    spec = world2["spec"]
    jlosses, jparams = world2["ref"]["jax"]["gradcache"]
    for out in world2["ranks"]:
        o = out["step/gradcache"]
        np.testing.assert_allclose(o["losses"], jlosses, rtol=1e-5)
        for key, p in o["params"].items():
            np.testing.assert_allclose(
                p.numpy(), _jax_leaf(jparams, spec, key).numpy(), atol=2e-5,
                err_msg=key)


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_sharded_optimizer_equals_the_replicated_step(world2, mode):
    """``TPU.ZERO1`` and ``TPU.FSDP`` (min size 128) against the
    replicated step: losses rtol 1e-5, parameters after two steps atol
    1e-5 (tests/test_train.py's bounds); and each rank keeps the bytes
    the rules say: AdamW's two moments of a split tensor halve, and under
    FSDP the split tensors themselves."""
    for out in world2["ranks"]:
        base, o = out["step/gathered"], out[f"step/{mode}"]
        np.testing.assert_allclose(o["losses"], base["losses"], rtol=1e-5)
        for k, p in o["params"].items():
            np.testing.assert_allclose(p.numpy(), base["params"][k].numpy(),
                                       atol=1e-5, err_msg=k)
        params = base["params"]
        trained = {k: v for k, v in params.items() if not TM.is_bn_stat(k)}
        assert o["split"] and set(o["split"]) <= set(trained)
        halved = sum(trained[k].numel() for k in o["split"]) * 4 // WORLD
        whole = sum(v.numel() * 4 for v in trained.values())
        scalars = base["bytes"]["optimizer"] - 2 * whole  # AdamW's steps
        assert base["bytes"]["params"] == whole
        assert o["bytes"]["optimizer"] == 2 * (whole - halved) + scalars
        if mode == "fsdp":
            assert o["bytes"]["params"] == whole - halved
        else:  # the whole tensors and the optimizer's splits
            assert o["bytes"]["params"] == whole + halved


# ---------------------------------------------------------------------------
# eval and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["top1", "map"])
def test_striped_zero_shot_matches_one_process(world2, name):
    """Two processes each evaluate their stripe (3 + 2 synthetic images
    of 10 classes, 4 + 3 VOC images): top-1 by sum and count, 11-point
    mAP over the gathered logits, equal to one process's;
    ``TEST.SAVE_PRED`` writes a ``.rank<r>`` file a process holding its
    stripe."""
    value, n = world2["ref"][name]
    for out in world2["ranks"]:
        got = out[f"zero_shot/{name}"]
        assert got["n_images"] == n
        np.testing.assert_allclose(got["value"], value, rtol=1e-6)
    if name == "map":
        files = [np.load(world2["outdir"] / f"pred.rank{r}.npz")
                 for r in range(WORLD)]
        one = np.load(world2["outdir"] / "one.npz")
        assert [len(f["pred"]) for f in files] == [4, 3]
        np.testing.assert_allclose(
            np.concatenate([f["logits"] for f in files])[[0, 4, 1, 5, 2, 6,
                                                          3]],
            one["logits"], atol=1e-5)


def test_zero1_checkpoint_resumes_in_one_process(world2, tmp_path):
    """A two-process ZeRO-1 run's epoch-end checkpoint (step 2; rank 0
    wrote the whole state) resumes in one process with the same global
    batch of 8: its next step's loss equals the two-process run's own
    resumed step within 1e-5 (the same pairs, another row order)."""
    from msclip_torch.tools.train import train

    ck = world2["ranks"][0]["checkpoint"]
    assert ck["second_first_step"] == 2 and len(ck["second"]) == 2
    assert world2["ranks"][1]["checkpoint"] == ck
    case = world2["cases"]["checkpoint"]
    cfg = get_default_config()
    update_config(cfg, case["cfg"], opts=[
        "TRAIN.BATCH_SIZE_PER_GPU", WORLD * ROWS, "TRAIN.END_EPOCH", 2])
    _, stats = train(cfg, device="cpu", out_dir=case["copy"])
    assert stats["first_step"] == 2
    np.testing.assert_allclose(stats["losses"], ck["second"], atol=1e-5)


def test_tensor_parallel_run_checkpoints_whole_tensors(world2):
    """``TPU.MESH_MODEL 2`` on two processes (one data rank of 8 rows,
    every block's heads and MLP split over both): its losses and its
    epoch-end checkpoint's whole tensors equal one process's run on the
    same 8 rows (losses rtol 1e-5, tensors atol 1e-5: the row-split
    products sum in two parts), and one process resumes from it."""
    from msclip_torch.tools.train import train
    from msclip_torch.train.checkpoint import CheckpointManager

    tp = world2["ranks"][0]["tensor_parallel"]
    assert tp == world2["ranks"][1]["tensor_parallel"]
    assert tp["global_batch"] == WORLD * ROWS and len(tp["losses"]) == 2
    case = world2["cases"]["checkpoint"]
    cfg = get_default_config()
    update_config(cfg, case["cfg"], opts=[
        "TRAIN.BATCH_SIZE_PER_GPU", WORLD * ROWS, "TRAIN.END_EPOCH", 1])
    state, stats = train(cfg, device="cpu")
    np.testing.assert_allclose(tp["losses"], stats["losses"], rtol=1e-5)
    ck = CheckpointManager(os.path.join(case["tp_out"], "checkpoints"))
    saved = ck.restore()
    assert saved["step"] == 2
    for k, v in state.model.params().items():
        np.testing.assert_allclose(saved["params"][k].numpy(),
                                   v.detach().numpy(), atol=1e-5, err_msg=k)
    update_config(cfg, case["cfg"], opts=[
        "TRAIN.BATCH_SIZE_PER_GPU", WORLD * ROWS, "TRAIN.END_EPOCH", 2])
    _, resumed = train(cfg, device="cpu", out_dir=case["tp_out"])
    assert resumed["first_step"] == 2 and len(resumed["losses"]) == 2

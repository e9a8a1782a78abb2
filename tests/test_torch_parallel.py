"""The port's multi-process layer in one process, fp32 on the CPU: the
sharding rules against the JAX package's on its 8-device CPU mesh, the
losses without a process group against the one-process loss, ZeRO-1 and
FSDP on one process against the replicated step bit for bit, DropPath's
global draw, the device rule, and the launchers (``torchrun`` of the train
CLI and the dry run, two gloo processes each).
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

from msclip_tpu.models import build_model as jax_build_model
from msclip_tpu.parallel import create_mesh as jax_create_mesh
from msclip_tpu.parallel import fsdp_param_shardings, optstate_shardings
from msclip_tpu.parallel import param_shardings
from msclip_torch.eval import device as D
from msclip_torch.models import layers as TL
from msclip_torch.models import msclip as TM
from msclip_torch.parallel import infonce as PI
from msclip_torch.parallel import mesh as PM
from msclip_torch.tools import dryrun
from msclip_torch.utils import comm as C
from msclip_torch.utils.convert import _get_path, build_key_map

from reference_oracle import tiny_msclips_config
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_msclips_config(layers=6)
    jm = jax_build_model(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    spec = TM.spec_from_config(cfg)
    params = TM.init_params(spec, torch.Generator().manual_seed(0))
    return jm, shapes, spec, params


def _port_dim_of(key, shape, j):
    return None if j is None else PM.jax_axes(key, len(shape))[j]


@pytest.mark.parametrize("n_data", [2, 4, 8])
@pytest.mark.parametrize("rule", ["fsdp", "zero1"])
def test_split_rules_pick_the_jax_dims(tiny, rule, n_data):
    """For every tensor of the tiny MS-CLIP-S, the port's rule splits the
    dim (in the port's layout) that JAX's ``fsdp_param_shardings``
    (``min_size`` 128, as the JAX tests) or ``optstate_shardings`` splits
    in the JAX layout, or none where JAX splits none."""
    _, shapes, spec, params = tiny
    mesh = jax_create_mesh(data=n_data, model=1,
                           devices=jax.devices()[:n_data])
    if rule == "fsdp":
        js = fsdp_param_shardings(mesh, shapes, min_size=128)
        got = PM.fsdp_dims(params, n_data, min_size=128)
    else:
        js = optstate_shardings(mesh, shapes)
        got = PM.zero1_dims(params, n_data)
    stored, _ = build_key_map(spec)
    split = 0
    for key, (path, _) in stored.items():
        pspec = tuple(_get_path(js, path).spec)
        j = next((d for d, a in enumerate(pspec) if a == "data"), None)
        want = _port_dim_of(key, tuple(params[key].shape), j)
        assert got[key] == want, key
        split += want is not None
    assert split > 20


def test_tensor_parallel_rule_picks_the_jax_dims(tiny):
    """``param_dim`` (the Megatron rule of ``_param_pspec``): qkv and
    ``c_fc`` split their output rows, ``out_proj`` and ``c_proj`` their
    input columns, in the port's ``[out, in]`` layout."""
    _, shapes, spec, params = tiny
    mesh = jax_create_mesh(data=4, model=2)
    js = param_shardings(mesh, shapes)
    stored, _ = build_key_map(spec)
    split = 0
    for key, (path, _) in stored.items():
        pspec = tuple(_get_path(js, path).spec)
        j = next((d for d, a in enumerate(pspec) if a == "model"), None)
        want = _port_dim_of(key, tuple(params[key].shape), j)
        assert PM.param_dim(key, tuple(params[key].shape)) == want, key
        split += want is not None
    # qkv w/b, out w, c_fc w/b, c_proj w of the 5 trunk blocks and of text
    # block 0, the one text block with tensors of its own
    assert split == 6 * 6
    assert PM.param_dim("x.attn.in_proj_weight", (384, 128)) == 0
    assert PM.param_dim("x.attn.out_proj.weight", (128, 128)) == 1
    assert PM.param_dim("x.mlp.c_fc.weight", (512, 128)) == 0
    assert PM.param_dim("x.mlp.c_proj.weight", (128, 512)) == 1


def test_fsdp_keeps_the_tensor_parallel_dim_free():
    """With ``model > 1`` the FSDP rule leaves the TP dim to ``model``
    (JAX: ``dims = list(spec)``), taking the largest other one."""
    key, shape = "x.mlp.c_fc.weight", (512, 256)  # JAX [256, 512]
    assert PM.fsdp_dim(key, shape, 2, model=1, min_size=1) == 0
    assert PM.fsdp_dim(key, shape, 2, model=2, min_size=1) == 1
    assert PM.fsdp_dim(key, (7,), 2, min_size=1) is None
    assert PM.fsdp_dim(key, (256, 128), 2) is None  # below 65536 elements
    assert PM.fsdp_dim(key, shape, 2) == 0


def test_mesh_without_a_process_group():
    mesh = PM.create_mesh()
    assert (mesh.data, mesh.model, mesh.data_rank, mesh.data_group) == \
        (1, 1, 0, None)
    with pytest.raises(ValueError, match="mesh 2x1 != 1 processes"):
        PM.create_mesh(data=2)


def _feats(b, e, seed):
    f = np.random.default_rng(seed).standard_normal((b, e)).astype(np.float32)
    return torch.from_numpy(f / np.linalg.norm(f, axis=-1, keepdims=True))


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
@pytest.mark.parametrize("name", ["gathered", "sharded", "chunked", "ring"])
def test_losses_without_a_group_equal_the_one_process_loss(name,
                                                           label_smoothing):
    """``group=None``: each loss is :func:`infonce_loss` of the batch in
    hand, value (rtol 1e-6) and gradients (atol 1e-6, JAX's bound; the
    text-to-image block is its own product, not the transpose, and the
    chunked logsumexp is the online one, so fp32 sums differ in order)."""
    fns = {"gathered": PI.gathered_infonce_loss,
           "sharded": PI.sharded_infonce_loss,
           "chunked": lambda *a, **kw: PI.chunked_sharded_infonce_loss(
               *a, chunk=5, **kw),
           "ring": PI.ring_infonce_loss}
    out = []
    for fn in (fns[name], PI.infonce_loss):
        fi, ft = _feats(12, 8, 0).requires_grad_(), \
            _feats(12, 8, 1).requires_grad_()
        scale = torch.tensor(0.7, requires_grad=True)
        loss = fn(fi, ft, scale, label_smoothing=label_smoothing)
        loss.backward()
        out.append((loss.item(), fi.grad, ft.grad, scale.grad))
    (got, *g_got), (want, *g_want) = out
    assert got == pytest.approx(want, rel=1e-6)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_chunked_direction_standalone_is_one_direction():
    """Ungathered, unpadded columns and ``labels = arange(B)``: one
    direction of the one-process loss (``chunked_direction``'s standalone
    mode, the JAX test of the same name)."""
    B, chunk = 13, 5
    img, txt = _feats(B, 8, 2), _feats(B, 8, 3)
    T = torch.exp(torch.tensor(0.5))
    labels = torch.arange(B)
    got = 0.5 * (PI.chunked_direction(img, txt, T, labels, B, chunk)
                 + PI.chunked_direction(txt, img, T, labels, B, chunk))
    want = PI.infonce_loss(img, txt, torch.tensor(0.5))
    assert got.item() == pytest.approx(want.item(), rel=1e-6)


def _one_process_run(*opts):
    cfg = dryrun.tiny_config(*opts)
    spec = TM.build_spec(cfg)
    params = TM.init_params(spec, torch.Generator().manual_seed(0))
    params["logit_scale"] = torch.tensor(math.log(1 / 0.07))
    images, tokens = dryrun.synthetic_batch(4)
    return dryrun.run_steps(cfg, params, images, tokens, PM.Mesh(), "cpu")


@pytest.mark.parametrize("opts", [
    ("TPU.ZERO1", True),
    ("TPU.FSDP", True),
], ids=["zero1", "fsdp"])
def test_one_process_options_equal_the_plain_step_bitwise(opts):
    """On one process every split is the whole tensor and every reduction
    a copy: ZeRO-1 and FSDP give the plain step's losses, gradients and
    parameters bit for bit over two steps (what ``chip_smoke.py`` phase
    18 holds on the card at world 1)."""
    base, got = _one_process_run(), _one_process_run(*opts)
    assert got["losses"] == base["losses"]
    for part in ("grads", "params", "bn"):
        for k, v in base[part].items():
            assert torch.equal(got[part][k], v), (part, k)
    assert got["state"].shards.dims


def test_fsdp_drops_the_whole_tensors_between_steps():
    r = _one_process_run("TPU.FSDP", True)
    state = r["state"]
    state.shards.release()
    named = dict(state.model.named_parameters())
    assert all(named[k].numel() == 0 for k in state.shards.dims)
    whole = state.full_params()
    for k, v in r["params"].items():
        assert torch.equal(whole[k], v), k


def test_drop_path_rows_take_the_global_draw():
    """``rows=(first, total)``: a process's mask is its rows of the mask
    one process draws for the whole batch from the same generator."""
    x = torch.zeros(3, 5, 2)
    whole = TL.drop_path_keep(torch.zeros(8, 5, 2), 0.5,
                              torch.Generator().manual_seed(4))
    part = TL.drop_path_keep(x, 0.5, torch.Generator().manual_seed(4),
                             rows=(2, 8))
    assert torch.equal(part, whole[2:5])
    assert whole.any() and not whole.all()


def test_batch_norm_without_a_group_is_the_one_process_norm():
    x = torch.randn(4, 6, 3, 3, generator=torch.Generator().manual_seed(0))
    p = {"bn.weight": torch.rand(6), "bn.bias": torch.rand(6),
         "bn.running_mean": torch.zeros(6), "bn.running_var": torch.ones(6)}
    y, (mean, var) = TL.batch_norm(x, p, "bn", training=True)
    torch.testing.assert_close(mean, 0.1 * x.mean(dim=(0, 2, 3)))
    torch.testing.assert_close(
        var, 0.9 + 0.1 * x.var(dim=(0, 2, 3), unbiased=True),
        rtol=1e-5, atol=1e-6)
    want = torch.nn.functional.batch_norm(
        x, None, None, p["bn.weight"], p["bn.bias"], training=True)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


def test_device_rule_takes_the_local_rank(monkeypatch):
    """A bare ``cuda`` is this process's card, ``cuda:LOCAL_RANK``; the
    CPU stays the CPU; no card raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert D.resolve_device("cuda") == torch.device("cuda", 3)
    assert D.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert D.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.resolve_device("cuda")


def test_comm_without_a_launcher_is_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not C.init_distributed("cpu")
    assert (C.comm.rank, C.comm.world_size, C.comm.is_main_process()) == \
        (0, 1, True)
    x = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(C.gather_arrays(x), x)
    assert C.reduce_dict({"a": 2.0}) == {"a": 2.0}
    assert C.all_gather_object({"k": 1}) == [{"k": 1}]
    C.comm.synchronize()


def _torchrun(args, tmp_path, nproc=2, timeout=600):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         str(nproc), "--master_addr", "localhost", "--master_port",
         str(dryrun.free_port())] + args, cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=timeout)


def _cli_config(tmp_path):
    with open(os.path.join(REPO, "msclip_torch", "config",
                           "b32-yfcc-msclips.json")) as f:
        cfg = json.load(f)
    spec = cfg["MODEL"]["SPEC"]
    spec["EMBED_DIM"] = 64
    spec["VISION"]["WIDTH"] = 128
    spec["TEXT"].update(WIDTH=128, HEADS=2, VOCAB_SIZE=512)
    cfg["TRAIN"].update(IMAGE_SIZE=[64, 64], BATCH_SIZE_PER_GPU=4,
                        END_EPOCH=1)
    cfg["DATASET"] = {"DATASET": "synthetic", "NUM_SAMPLES": 16}
    cfg.update(PRINT_FREQ=1, WORKERS=1, OUTPUT_DIR=str(tmp_path / "out"))
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _result(stdout):
    line = stdout.strip().splitlines()[-1].split()
    assert line[0] == "RESULT", stdout[-2000:]
    return {k: v for k, v in (kv.split("=", 1) for kv in line[1:])}


def test_train_cli_under_torchrun_matches_one_process(tmp_path):
    """``torchrun --nproc_per_node 2 -m msclip_torch.tools.train ...
    --device cpu TPU.SHARDED_LOSS True``: the global batch is 4 x 2, rank
    0 alone prints the result, each rank logs to its own file, and the
    losses are one process's at ``BATCH_SIZE_PER_GPU 8`` (within 1e-5:
    the same pairs in another row order)."""
    cfg = _cli_config(tmp_path)
    r = _torchrun(["-m", "msclip_torch.tools.train", "--cfg", cfg,
                   "--device", "cpu", "TPU.SHARDED_LOSS", "True",
                   "TPU.LOSS_CHUNK", "3"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("RESULT") == 1
    got = _result(r.stdout)
    assert (got["world"], got["global_batch"], got["steps"]) == \
        ("2", "8", "2")
    one = subprocess.run(
        [sys.executable, "-m", "msclip_torch.tools.train", "--cfg", cfg,
         "--device", "cpu", "TRAIN.BATCH_SIZE_PER_GPU", "8", "OUTPUT_DIR",
         str(tmp_path / "one")], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert one.returncode == 0, one.stderr[-3000:]
    want = _result(one.stdout)
    np.testing.assert_allclose(json.loads(got["losses"]),
                               json.loads(want["losses"]), atol=1e-5)
    logs = sorted(os.listdir(tmp_path / "out" / "synthetic" / "tiny"))
    assert any(n.endswith("_rank0.txt") for n in logs) and \
        any(n.endswith("_rank1.txt") for n in logs)


@pytest.mark.parametrize("nproc", [2, 4])
def test_dryrun_passes_on_cpu_processes(nproc):
    """``python -m msclip_torch.tools.dryrun --nproc N --device cpu``:
    every check within its bound, tensor parallelism too (``1 x 2``
    against ``2 x 1``, ``2 x 2`` against ``4 x 1``), one ``DRYRUN ok``
    line."""
    r = subprocess.run(
        [sys.executable, "-m", "msclip_torch.tools.dryrun", "--nproc",
         str(nproc), "--device", "cpu"], cwd=REPO, capture_output=True,
        text=True, timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("DRYRUN")]
    assert len(lines) == 1
    assert lines[0].startswith(f"DRYRUN ok world={nproc}")
    for check in ("dp", "ring", "gradcache", "zero1", "fsdp", "tp"):
        assert f" {check}=" in lines[0]


def test_tensor_parallel_parts_rebuild_the_tensor():
    """Each model rank's part: the qkv in-projection's rows of its heads
    (q, k and v of a head on one rank), ``c_fc``'s rows, ``out_proj``'s and
    ``c_proj``'s columns; the parts in rank order rebuild the tensor."""
    g = torch.Generator().manual_seed(0)
    e, m = 8, 2
    for key, shape, dim in (("b.attn.in_proj_weight", (3 * e, e), 0),
                            ("b.attn.in_proj_bias", (3 * e,), 0),
                            ("b.attn.out_proj.weight", (e, e), 1),
                            ("b.mlp.c_fc.weight", (4 * e, e), 0),
                            ("b.mlp.c_proj.weight", (e, 4 * e), 1)):
        t = torch.randn(shape, generator=g)
        parts = [PM.tp_split(key, t, m, r) for r in range(m)]
        if "in_proj" in key:  # q, k, v rows of heads 0..H/2 on rank 0
            assert torch.equal(parts[0][:e // 2], t[:e // 2])
            assert torch.equal(parts[0][e // 2:e], t[e:e + e // 2])
            assert torch.equal(parts[1][:e // 2], t[e // 2:e])
            order = torch.cat([PM._qkv_rows(3 * e, m, r) for r in range(m)])
            whole = torch.cat(parts)[torch.argsort(order)]
        else:
            whole = torch.cat(parts, dim=dim)
        assert torch.equal(whole, t), key
    bias = torch.randn(e, generator=g)
    assert PM.tp_split("b.attn.out_proj.bias", bias, m, 1) is bias


def test_finetune_cli_under_torchrun_matches_one_process(tmp_path):
    """``torchrun --nproc_per_node 2 -m msclip_torch.tools.finetune ...``:
    ``FINETUNE.BATCH_SIZE 4`` is the global batch (2 rows a process, the
    head's gradients averaged), the eval striped; without mixup the top-1
    is one process's (8 CIFAR-10 images, 2 epochs)."""
    from torch_transfer_fixtures import (MODEL_YAML, TINY_OPTS, cifar10,
                                         tiny_checkpoint)

    ckpt = tmp_path / "model.pth"
    tiny_checkpoint(ckpt)
    root, _ = cifar10(str(tmp_path / "cifar"), n_test=8)
    args = ["-m", "msclip_torch.tools.finetune", "--ds",
            os.path.join(REPO, "experiments", "dataset", "cifar-10.yaml"),
            "--model", MODEL_YAML, "--device", "cpu", *TINY_OPTS,
            "MODEL.PRETRAINED_MODEL", str(ckpt), "DATASET.ROOT", root,
            "FINETUNE.BATCH_SIZE", "4", "FINETUNE.BASE_LR", "0.05",
            "TRAIN.END_EPOCH", "2", "OUTPUT_DIR", str(tmp_path / "out")]
    r = _torchrun(args, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("RESULT finetune") == 1
    one = subprocess.run([sys.executable] + args, cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert one.returncode == 0, one.stderr[-3000:]

    def top1(out):
        return float(out.split("RESULT finetune top1=")[1].split()[0])

    assert top1(r.stdout) == top1(one.stdout)


def test_fsdp_resume_reanchors_the_ema_to_whole_tensors(tmp_path):
    """FSDP drops its split tensors between steps: a run resumed with
    ``TRAIN.EMA_DECAY`` from a checkpoint without an EMA shadow anchors
    the shadow to the restored, whole tensors and trains on."""
    from msclip_torch.config import get_default_config, update_config
    from msclip_torch.tools.train import train

    def cfg(*opts):
        c = get_default_config()
        update_config(c, _cli_config(tmp_path), opts=[
            "TPU.FSDP", True, *opts])
        return c

    out = str(tmp_path / "run")
    state, _ = train(cfg(), device="cpu", out_dir=out)
    want = {k: v.detach().clone() for k, v in state.full_params().items()}
    state, stats = train(cfg("TRAIN.EMA_DECAY", 0.5, "TRAIN.END_EPOCH", 2),
                         device="cpu", out_dir=out)
    assert stats["first_step"] == 4 and len(stats["losses"]) == 4
    assert all(state.ema[k].shape == v.shape for k, v in want.items())

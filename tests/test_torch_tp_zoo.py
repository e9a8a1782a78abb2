"""Tensor parallelism through the model zoo's plug-in blocks and the
Perceiver, in two gloo processes on the CPU, against one process, fp32.

``TPU.MESH_MODEL 2`` cuts every block's attention in- and out-projections
and MLP ``c_fc``/``c_proj`` to one process's heads and columns
(``parallel/mesh.split_for_model``; the Gumbel family's specific blocks
too, as JAX's rule cuts them) and leaves the plug-ins' own tensors whole.
One launch of ``tests/torch_tp_zoo_worker.py`` (two ranks, one model
group) runs every family while this process computes the one-process
references on the same weights and batch: the eval features of both
towers, and one train step's loss and gradients. The tiny geometry of
``tests/torch_zoo_configs.py`` (width 128, 2 heads: one a process, 64
px, 6 layers, adapters at 1-5) with ``test_torch_multiproc.py``'s
optimizer recipe, 4 pairs.

The bounds are fp32 sums in another order (the row-split products sum in
two parts, the split attention's context is gathered): each value within
``TOL`` of the larger of its tensor's largest value and the largest
value of the step's gradients (the sums behind a small gradient, such as
``logit_scale``'s, which cancels to 1e-5, or ConViT's positional bias,
which its softmax cancels to nought, carry terms of the larger size),
``TOL`` being ``ULPS`` units of fp32 roundoff times the square root of
the longest sum behind it (``SUM_LENGTH``: a row of the widest GEMM times
the batch's tokens, which the weight gradients sum over). Measured: at
most 1.2e-5 of a tensor's largest value (``text_projection``). A
collective planted without its backward exchange fails them: LoRA's cut
deltas by 1.0 of their tensors' largest value (30 bounds), Container's
input sum by 0.84.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from msclip_torch.models import msclip as TM
from msclip_torch.parallel.mesh import Mesh, param_dim
from msclip_torch.tools.dryrun import free_port, run_steps

from torch_threads import one_torch_thread  # noqa: F401
from torch_zoo_configs import family_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
ROWS = 4
FAMILIES = ["adapter", "lora_moe", "cvt", "cvt_inside", "convit",
            "container", "gumbel", "gumbel_addtwo", "perceiver"]
# a collective planted without its backward exchange, per family
FAULTS = {"lora_moe": "scatter_to_group", "container": "copy_to_group"}
FP32_EPS = 2.0 ** -24
# the longest sum: a row of c_proj (4 x 128) over the batch's 4 x 77 tokens
SUM_LENGTH = 4 * 128 * ROWS * 77
ULPS = 4.0
TOL = ULPS * FP32_EPS * math.sqrt(SUM_LENGTH)  # 9.5e-5


def _cfg(name):
    cfg = family_config(name)
    cfg.TRAIN.LR = 1e-3
    cfg.TRAIN.WD = 0.05
    cfg.TRAIN.WITHOUT_WD_LIST = ["bn", "bias", "ln"]
    cfg.TRAIN.END_EPOCH = 4
    cfg.TRAIN.LR_SCHEDULER.merge_from_dict(
        {"METHOD": "timm",
         "ARGS": {"warmup_epochs": 1, "warmup_lr": 1e-6, "min_lr": 1e-5}})
    return cfg


def _batch():
    from msclip_torch.data.pairs import SyntheticPairDataset

    ds = SyntheticPairDataset(n=ROWS, size=64, vocab_size=512, seed=5)
    images, tokens = zip(*(ds[i] for i in range(ROWS)))
    return np.stack(images), np.stack(tokens)


def _port_cfg(path):
    from msclip_torch.config import get_default_config, update_config

    cfg = get_default_config()
    update_config(cfg, str(path))
    return cfg


def _launch(indir, outdir):
    port = free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(WORLD),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "torch_tp_zoo_worker.py"),
             str(indir), str(outdir)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def _one_process(cfg, params, images, tokens):
    spec = TM.build_spec(cfg)
    with torch.no_grad():
        feats = {"image": TM.encode_image(params, spec,
                                          torch.from_numpy(images)),
                 "text": TM.encode_text(params, spec,
                                        torch.from_numpy(tokens))}
    r = run_steps(cfg, params, images, tokens, Mesh(), "cpu", steps=1)
    return {"features": feats,
            "step": {"loss": r["losses"][0], "grads": r["grads"],
                     "bn": r["bn"]}}


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """Write each family's config and weights, start the two ranks,
    compute the one-process references meanwhile, collect rank 0's
    results."""
    indir = tmp_path_factory.mktemp("inputs")
    outdir = tmp_path_factory.mktemp("outputs")
    images, tokens = _batch()
    np.savez(indir / "batch.npz", images=images, tokens=tokens)
    specs, params = {}, {}
    for name in FAMILIES:
        (indir / f"{name}.json").write_text(json.dumps(_cfg(name)))
        cfg = _port_cfg(indir / f"{name}.json")
        specs[name] = TM.build_spec(cfg)
        params[name] = TM.init_params(specs[name],
                                      torch.Generator().manual_seed(0))
        torch.save(params[name], indir / f"{name}.pt")
    (indir / "families.json").write_text(json.dumps(FAMILIES))
    (indir / "faults.json").write_text(json.dumps(FAULTS))
    procs = _launch(indir, outdir)
    try:
        ref = {name: _one_process(_port_cfg(indir / f"{name}.json"),
                                  params[name], images, tokens)
               for name in FAMILIES}
        logs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]
    got = torch.load(outdir / "results.pt", weights_only=True)
    return {"got": got, "ref": ref, "specs": specs, "params": params}


def _readings(got, want):
    """``{key: max |got - want| / bound}`` over the tensors of ``want``:
    the bound ``TOL`` of the larger of the tensor's largest value and
    the largest value of them all."""
    top = max(float(w.abs().max()) for w in want.values())
    return {k: float((got[k] - w).abs().max())
            / (TOL * max(float(w.abs().max()), top))
            for k, w in want.items()}


def _step_readings(got, want):
    loss = abs(got["loss"] - want["loss"]) / (TOL * abs(want["loss"]))
    return {"loss": loss, **_readings(got["grads"], want["grads"]),
            **{f"bn/{k}": v for k, v in _readings(
                got["bn"], {k: v for k, v in want["bn"].items()
                            if k.endswith(("running_mean", "running_var"))}
            ).items()}}


@pytest.mark.parametrize("name", FAMILIES)
def test_tensor_parallel_family_matches_one_process(tp2, name):
    """With ``TPU.MESH_MODEL 2`` on two processes the family's eval
    features of both towers, and one train step's loss, gradients (made
    whole) and BatchNorm statistics, equal one process's within the
    bounds; the split tensors are the four of JAX's rule in every block,
    the plug-ins' and Perceiver latents' whole."""
    got, want = tp2["got"][name], tp2["ref"][name]
    params = tp2["params"][name]
    split = {k for k, v in params.items()
             if param_dim(k, tuple(v.shape)) is not None}
    assert split and all(k.rsplit(".", 2)[-2] in (
        "attn", "specific_attn", "c_fc", "c_proj", "out_proj")
        or k.endswith(("in_proj_weight", "in_proj_bias")) for k in split)
    if name == "gumbel":
        assert any(".specific_attn." in k for k in split)
    feats = _readings(got["features"], want["features"])
    assert max(feats.values()) <= 1.0, feats
    step = _step_readings(got["step"], want["step"])
    worst = max(step, key=step.get)
    assert step[worst] <= 1.0, (worst, step[worst])
    assert set(got["step"]["grads"]) == set(want["step"]["grads"])
    assert all(math.isfinite(v) for v in step.values())


@pytest.mark.parametrize("name", FAMILIES)
def test_tensor_parallel_rule_picks_the_jax_dims_in_every_family(name):
    """``param_dim`` cuts, for every tensor of the family's model, the dim
    (in the port's layout) that JAX's ``param_shardings`` puts on
    ``model`` (``_param_pspec``) in the JAX layout, or none where JAX cuts
    none: the plug-ins' tensors whole, the Gumbel specific blocks' (JAX's
    ``specific/attn``, ``specific/mlp``) and the Perceiver blocks' cut."""
    import jax

    from msclip_tpu.models import build_model as jax_build_model
    from msclip_tpu.parallel import create_mesh as jax_create_mesh
    from msclip_tpu.parallel import param_shardings
    from msclip_torch.parallel.mesh import jax_axes
    from msclip_torch.utils.convert import _get_path, build_key_map

    cfg = family_config(name)
    shapes = jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0))
    js = param_shardings(jax_create_mesh(data=4, model=2), shapes)
    spec = TM.spec_from_config(cfg)
    params = TM.init_params(spec, torch.Generator().manual_seed(0))
    stored, _ = build_key_map(spec)
    cut = 0
    for key, (path, _) in stored.items():
        pspec = tuple(_get_path(js, path).spec)
        j = next((d for d, a in enumerate(pspec) if a == "model"), None)
        shape = tuple(params[key].shape)
        want = None if j is None else jax_axes(key, len(shape))[j]
        assert param_dim(key, shape) == want, key
        cut += want is not None
    # six cut tensors a block with tensors of its own
    assert cut % 6 == 0 and cut >= 36


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_planted_collective_fault_fails_the_bounds(tp2, name):
    """A collective of the plug-ins' arithmetic with its backward exchange
    left out (LoRA's cut deltas keep only this process's columns'
    gradient; Container's and the cut projections' inputs are not summed
    over the group) moves some gradient past its bound."""
    got, want = tp2["got"][name], tp2["ref"][name]
    step = _step_readings(got["fault"], want["step"])
    assert max(step.values()) > 1.0, max(step.values())


def test_dryrun_zoo_passes_on_cpu_processes():
    """``python -m msclip_torch.tools.dryrun --nproc 2 --device cpu --zoo``
    (the command the card runs under ``torchrun`` on two cards): every
    family's ``1 x 2`` step against the ``2 x 1`` one within the bounds,
    one ``DRYRUN ok`` line with a ``tp_<family>`` reading for each."""
    from msclip_torch.tools import dryrun

    r = subprocess.run(
        [sys.executable, "-m", "msclip_torch.tools.dryrun", "--nproc", "2",
         "--device", "cpu", "--zoo"], cwd=REPO, capture_output=True,
        text=True, timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("DRYRUN")]
    assert len(lines) == 1 and lines[0].startswith("DRYRUN ok world=2")
    for name in dryrun.ZOO:
        reading = json.loads(lines[0].split(f" tp_{name}=")[1].split()[0])
        assert reading["grad_rel"] <= dryrun.GRAD_TOL, (name, reading)

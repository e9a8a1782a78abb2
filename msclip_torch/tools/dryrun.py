"""Multi-process dry run of the train step, the port of
``__graft_entry__.dryrun_multichip``.

    python -m msclip_torch.tools.dryrun --nproc N [--device cpu|cuda] [--zoo]

Starts ``N`` processes with ``torchrun`` (gloo on the CPU, NCCL on the
cards, one card a process) on a tiny MS-CLIP-S (width 128, 64-pixel
images, 6 layers: the stem, the parallel branch, two lateral adapters and
the shared text blocks all run; random weights from a seed) and a global
batch of ``4 N`` synthetic pairs, and checks in every process, fp32:

* ``dp``: the ``N``-process step (global-batch BatchNorm, the gathered
  loss, the gradient mean) against one process fed the concatenated
  batch;
* ``ring``: the ring loss step (``TPU.RING_LOSS``) against the chunked
  one (``TPU.SHARDED_LOSS``, 3-column chunks with a padded tail);
* ``gradcache``: ``TPU.ACCUM_STEPS 2`` against the one-shot step, BN
  frozen;
* ``zero1``, ``fsdp``: ``TPU.ZERO1`` and ``TPU.FSDP`` against the
  replicated step;
* ``tp`` (an even ``N``): the ``N/2 x 2`` (data x model) step, every
  block split over two processes, against the ``N x 1`` one (``2 x 2``
  against ``4 x 1`` at ``--nproc 4``); with ``--zoo`` also ``tp_<family>``
  for each of the model zoo's plug-in families and the Perceiver
  (:data:`ZOO`, switched on over the same config), by the losses and the
  first step's gradients (:func:`check_grads`: AdamW's first steps move a
  parameter whose gradient is nought but rounding by up to the learning
  rate, as the Gumbel logits at their constant ``GUMBEL_LR``);

each over two steps, by the loss and the largest parameter difference.
Rank 0 prints one ``DRYRUN`` line; the exit status is non-zero if a check
failed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from ..config import get_default_config
from ..eval.device import resolve_device
from ..models.msclip import build_spec, init_params
from ..parallel.mesh import Mesh, create_mesh
from ..train.trainer import init_train_state, make_train_step_from_config
from ..utils.comm import comm, init_distributed, shutdown

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ROWS = 4  # per process
# (loss rtol, parameter atol) of each check: the JAX package's bounds
# for the same comparisons (tests/test_parallel.py, tests/test_train.py)
BOUNDS = {"dp": (1e-5, 1e-5), "ring": (1e-5, 1e-5),
          "gradcache": (1e-4, 5e-5), "zero1": (1e-5, 1e-5),
          "fsdp": (1e-5, 1e-5), "tp": (1e-5, 1e-5)}


# the model zoo's plug-in families and the Perceiver, each as overrides of
# the tiny config (``tests/torch_zoo_configs.py``'s), for ``--zoo``
ZOO = {
    "adapter": ("CUSTOM.ADAPTER_FLAG", True, "CUSTOM.ADAPTER_ATTN_DIM", 16,
                "CUSTOM.ADAPTER_LAYERS", [1, 3, 4]),
    "lora": ("CUSTOM.LORA_ATTN_DIM", 8, "CUSTOM.LORA_ATTN_ALPHA", 16,
             "CUSTOM.LORA_WHERE_ADD", "v2", "CUSTOM.LORA_MOE", 1,
             "CUSTOM.LORA_MOE_ACT", "sigmoid", "CUSTOM.LORA_MOE_GROUP", 2),
    "cvt": ("CUSTOM.CVT_IN_V", True, "CUSTOM.CVT_V_RES", True,
            "CUSTOM.CVT_LAYERS", [2, 3]),
    "cvt_inside": ("CUSTOM.CVT_IN_V", True, "CUSTOM.CVT_INSIDE", True,
                   "CUSTOM.CVT_INSIDE_Q", True, "CUSTOM.CVT_INSIDE_V", True),
    "convit": ("CUSTOM.CONVIT_IN_V", True, "CUSTOM.CONVIT_LAYERS", [1, 2]),
    "container": ("CUSTOM.CONTAINER_IN_V", True),
    "gumbel": ("CUSTOM.GUMBEL_SELECT", True),
    "perceiver": ("CUSTOM.PERCEIVER_IN_V", True, "CUSTOM.PERCEIVER_IN_T",
                  True, "CUSTOM.PERCEIVER_LAYER", [2, 4],
                  "CUSTOM.PERCEIVER_N_LATENT", 3),
}


def tiny_config(*opts):
    """The tiny MS-CLIP-S train config (the B/32 JSON cut to width 128)
    with ``opts`` (``KEY VALUE`` pairs) merged."""
    with open(os.path.join(REPO, "msclip_torch", "config",
                           "b32-yfcc-msclips.json")) as f:
        raw = json.load(f)
    spec = raw["MODEL"]["SPEC"]
    spec["EMBED_DIM"] = 64
    spec["VISION"].update(WIDTH=128, LAYERS=6)
    spec["TEXT"].update(WIDTH=128, HEADS=2, VOCAB_SIZE=512, LAYERS=6)
    # the JAX train tests' recipe: the warmup starts at 1e-6
    raw["TRAIN"].update(IMAGE_SIZE=[64, 64], LR=1e-3, WD=0.05,
                        END_EPOCH=4, BATCH_SIZE_PER_GPU=ROWS)
    raw["TRAIN"]["LR_SCHEDULER"] = {
        "METHOD": "timm", "ARGS": {"warmup_epochs": 1, "warmup_lr": 1e-6,
                                   "min_lr": 1e-5}}
    raw["DATASET"] = {"DATASET": "synthetic"}
    cfg = get_default_config()
    cfg.merge_from_dict(raw)
    cfg.merge_from_list(list(opts))
    return cfg


def synthetic_batch(n_rows, image=64, vocab=512, seed=0):
    """``n_rows`` images ``[n, image, image, 3]`` and token rows ``[n,
    77]`` (SOT, words, EOT at a random position) from ``seed``."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n_rows, image, image, 3)).astype(np.float32)
    tokens = np.zeros((n_rows, 77), np.int32)
    for i in range(n_rows):
        n = int(rng.integers(3, 20))
        tokens[i, 0] = vocab - 2
        tokens[i, 1:n] = rng.integers(1, vocab - 2, n - 1)
        tokens[i, n] = vocab - 1
    return images, tokens


def local_rows(x, mesh: Mesh):
    """This data rank's equal block of the global batch ``x``."""
    b = x.shape[0] // mesh.data
    return x[mesh.data_rank * b:(mesh.data_rank + 1) * b]


def run_steps(cfg, params, images, tokens, mesh: Mesh, device, steps=2,
              freeze_bn=False):
    """``steps`` train steps of ``cfg`` from ``params`` on the global
    batch ``images``/``tokens`` (numpy; this process takes its rows), the
    same batch each step (BatchNorm in eval mode with ``freeze_bn``).
    Returns ``{"losses", "params", "grads", "bn", "state"}``: the losses,
    the final parameters (whole, on the CPU), the first step's averaged
    gradients by name (split ones whole) and BatchNorm running statistics
    after it, and the final state."""
    spec = build_spec(cfg)
    state = init_train_state(cfg, spec, {k: v.clone() for k, v in
                                         params.items()}, 10, device, mesh)
    step = make_train_step_from_config(cfg, spec, freeze_bn, mesh)
    im = torch.from_numpy(local_rows(images, mesh)).to(device)
    tk = torch.from_numpy(local_rows(tokens, mesh)).to(device)
    out = {"losses": []}
    for i in range(steps):
        out["losses"].append(float(step(state, im, tk)["loss"]))
        if i == 0:
            out["grads"] = {k: g.cpu() for k, g in
                            state.shards.whole_grads().items()}
            out["bn"] = {k: v.detach().cpu().clone()
                         for k, v in state.model.named_buffers()}
    out["params"] = {k: v.detach().cpu().clone()
                     for k, v in state.whole_params().items()}
    out["state"] = state
    return out


def largest_difference(a: dict, b: dict) -> float:
    return max((a[k].float() - b[k].float()).abs().max().item() for k in a)


def check(name, got, want, failures):
    """Hold ``got`` to ``want`` (:func:`run_steps` results) at
    :data:`BOUNDS`; returns the readings."""
    rtol, atol = BOUNDS[name]
    loss_rel = max(abs(g - w) / max(abs(w), 1e-12)
                   for g, w in zip(got["losses"], want["losses"]))
    param_diff = largest_difference(got["params"], want["params"])
    if not (loss_rel <= rtol and param_diff <= atol
            and all(map(math.isfinite, got["losses"]))):
        failures.append(name)
    return {"loss_rel": loss_rel, "param_abs": param_diff}


# the zoo checks' gradient bound: each gradient within GRAD_TOL of the
# larger of its tensor's largest value and the step's largest gradient
# (tests/test_torch_tp_zoo.py's bound, fp32 sums in another order)
GRAD_TOL = 1e-4


def check_grads(name, got, want, failures):
    """Hold ``got``'s losses (the ``tp`` rtol) and first-step gradients
    (:data:`GRAD_TOL`) to ``want``'s; returns the readings."""
    rtol, _ = BOUNDS["tp"]
    loss_rel = max(abs(g - w) / max(abs(w), 1e-12)
                   for g, w in zip(got["losses"], want["losses"]))
    top = max(float(w.abs().max()) for w in want["grads"].values())
    grad = max(float((got["grads"][k] - w).abs().max())
               / max(float(w.abs().max()), top)
               for k, w in want["grads"].items())
    if not (loss_rel <= rtol and grad <= GRAD_TOL
            and all(map(math.isfinite, got["losses"]))):
        failures.append(name)
    return {"loss_rel": loss_rel, "grad_rel": grad}


def worker(device, zoo=False) -> int:
    """One process of the dry run (under ``torchrun``); ``zoo``: the
    ``tp_<family>`` checks too."""
    device = resolve_device(device)
    init_distributed(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = create_mesh()
    world = comm.world_size
    cfg = tiny_config()
    spec = build_spec(cfg)
    params = init_params(spec, torch.Generator().manual_seed(0))
    params["logit_scale"] = torch.tensor(math.log(1 / 0.07))
    images, tokens = synthetic_batch(ROWS * world)
    failures, readings = [], {}

    def run(*opts, on=mesh):
        return run_steps(tiny_config(*opts), params, images, tokens, on,
                         device)

    replicated = run()
    readings["dp"] = check("dp", replicated, run(on=Mesh()), failures)
    readings["ring"] = check(
        "ring", run("TPU.SHARDED_LOSS", True, "TPU.RING_LOSS", True),
        run("TPU.SHARDED_LOSS", True, "TPU.LOSS_CHUNK", 3), failures)
    readings["gradcache"] = check(
        "gradcache", run_steps(tiny_config("TPU.ACCUM_STEPS", 2), params,
                               images, tokens, mesh, device, freeze_bn=True),
        run_steps(tiny_config(), params, images, tokens, mesh, device,
                  freeze_bn=True), failures)
    readings["zero1"] = check("zero1", run("TPU.ZERO1", True), replicated,
                              failures)
    fsdp = run("TPU.FSDP", True)
    readings["fsdp"] = check("fsdp", fsdp, replicated, failures)
    if world % 2 == 0:
        split = create_mesh(world // 2, 2)
        readings["tp"] = check(
            "tp", run("TPU.MESH_MODEL", 2, on=split), replicated, failures)
        for name, opts in (ZOO.items() if zoo else ()):
            family = init_params(build_spec(tiny_config(*opts)),
                                 torch.Generator().manual_seed(0))

            def run_family(*more, on=mesh):
                return run_steps(tiny_config(*opts, *more), family, images,
                                 tokens, on, device)

            readings[f"tp_{name}"] = check_grads(
                f"tp_{name}", run_family("TPU.MESH_MODEL", 2, on=split),
                run_family(), failures)
    if comm.is_main_process():
        print("DRYRUN " + ("ok" if not failures else "FAILED "
                           + ",".join(failures))
              + f" world={world} device={device.type} "
              + " ".join(f"{k}={json.dumps(v, separators=(',', ':'))}"
                         for k, v in readings.items()), flush=True)
    comm.synchronize()
    shutdown()
    return 1 if failures else 0


def free_port() -> int:
    """A TCP port on ``localhost`` that no one listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(nproc: int, device: str, timeout: float = 900,
           zoo: bool = False) -> int:
    """Run the dry run's ``nproc`` processes under ``torchrun`` and wait
    for them; returns their exit status."""
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc_per_node", str(nproc), "--master_addr", "localhost",
           "--master_port", str(free_port()), "-m",
           "msclip_torch.tools.dryrun", "--device", device, "--worker"] \
        + (["--zoo"] if zoo else [])
    env = dict(os.environ)
    if device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    return subprocess.run(cmd, env=env, cwd=REPO, timeout=timeout).returncode


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Multi-process dry run of the train step (PyTorch).")
    p.add_argument("--nproc", type=int, default=2,
                   help="processes (one a card on CUDA)")
    p.add_argument("--device", default="cuda",
                   help="cuda (NCCL, default) or cpu (gloo)")
    p.add_argument("--zoo", action="store_true",
                   help="also check tensor parallelism through the model "
                        "zoo's plug-in families and the Perceiver")
    p.add_argument("--worker", action="store_true",
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.worker:
        sys.exit(worker(args.device, args.zoo))
    resolve_device(args.device)  # no card: raise before starting anything
    sys.exit(launch(args.nproc, args.device, zoo=args.zoo))


if __name__ == "__main__":
    main()

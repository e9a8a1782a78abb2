"""One process of the port's multi-process checks (JAX-free), started by
``tests/test_torch_multiproc.py`` once a rank with ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set
(gloo on the CPU):

    python tests/torch_multiproc_worker.py <inputs dir> <outputs dir>

It runs every check of the test file in one process group, in the same
order on every rank, and writes what it measured to
``<outputs dir>/rank<r>.pt`` (tensors, floats and lists only); the test
holds those against the JAX package and against one process fed the
concatenated batch. Inputs: ``losses.npz`` (global L2-normalized
features and a logit scale), ``train.json`` (the tiny MS-CLIP-S train
config), ``params.pt`` (its weights, the port's layout), ``batch.npz``
(the global batch), ``cases.json`` (the zero-shot and checkpoint runs).
"""

import json
import os
import shutil
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from msclip_torch.config import get_default_config, update_config  # noqa: E402
from msclip_torch.parallel import infonce as PI  # noqa: E402
from msclip_torch.parallel.mesh import create_mesh  # noqa: E402
from msclip_torch.tools.dryrun import run_steps  # noqa: E402
from msclip_torch.utils import comm as C  # noqa: E402

LOSSES = {
    "gathered": PI.gathered_infonce_loss,
    "sharded": PI.sharded_infonce_loss,
    "chunked": lambda *a, **kw: PI.chunked_sharded_infonce_loss(
        *a, chunk=20, **kw),
    "ring": PI.ring_infonce_loss,
}


def loss_checks(indir, group, out):
    """Each loss at label smoothing 0 and 0.1: its value and the
    gradients of this rank's rows and of ``logit_scale``."""
    z = np.load(os.path.join(indir, "losses.npz"))
    b = z["img"].shape[0] // C.comm.world_size
    r = C.comm.rank
    for name, fn in LOSSES.items():
        for ls in (0.0, 0.1):
            fi = torch.from_numpy(z["img"][r * b:(r + 1) * b]).requires_grad_()
            ft = torch.from_numpy(z["txt"][r * b:(r + 1) * b]).requires_grad_()
            scale = torch.tensor(float(z["scale"])).requires_grad_()
            loss = fn(fi, ft, scale, group=group, label_smoothing=ls)
            loss.backward()
            out[f"loss/{name}/{ls}"] = {
                "loss": loss.item(), "d_img": fi.grad, "d_txt": ft.grad,
                "d_scale": scale.grad.item()}


def train_config(indir, *opts):
    cfg = get_default_config()
    update_config(cfg, os.path.join(indir, "train.json"),
                  opts=[str(o) for o in opts])
    return cfg


def step_checks(indir, mesh, out):
    """Two train steps a mode on the global batch: the losses, the first
    step's averaged gradients and BN running statistics, the final
    parameters, and the bytes each mode keeps on this rank."""
    params = torch.load(os.path.join(indir, "params.pt"), weights_only=True)
    z = np.load(os.path.join(indir, "batch.npz"))
    modes = {
        "gathered": (),
        "chunked": ("TPU.SHARDED_LOSS", True, "TPU.LOSS_CHUNK", 3),
        "ring": ("TPU.SHARDED_LOSS", True, "TPU.RING_LOSS", True),
        "gradcache": ("TPU.ACCUM_STEPS", 2),
        "zero1": ("TPU.ZERO1", True),
        "fsdp": ("TPU.FSDP", True),
        "dropping": ("MODEL.SPEC.VISION.DROP_PATH", 0.5),
    }
    for mode, opts in modes.items():
        cfg = train_config(indir, *opts)
        r = run_steps(cfg, params, z["images"], z["tokens"], mesh,
                      torch.device("cpu"))
        shards = r["state"].shards
        out[f"step/{mode}"] = {
            "losses": r["losses"], "params": r["params"],
            "grads": r["grads"], "bn": r["bn"],
            "bytes": shards.stored_bytes(r["state"].optimizer),
            "split": {k: shards.dims[k] for k in sorted(shards.dims)}}


def comm_checks(out):
    """``gather_arrays`` of unequal lengths, ``reduce_dict`` and
    ``all_gather_object``."""
    r = C.comm.rank
    x = np.arange(3 - r, dtype=np.float32)[:, None] * 10 + r
    out["comm"] = {
        "gathered": torch.from_numpy(C.gather_arrays(x)),
        "sum": C.reduce_dict({"a": r + 1.0, "b": 2.0 * r}, average=False),
        "mean": C.reduce_dict({"a": r + 1.0, "b": 2.0 * r}),
        "objects": C.all_gather_object({"rank": r, "tag": "x" * (r + 1)}),
        "rank": r, "world": C.comm.world_size}


def zero_shot_checks(cases, out):
    from msclip_torch.eval.zero_shot import run_zero_shot

    for case in cases:
        cfg = get_default_config()
        update_config(cfg, case["ds"])
        update_config(cfg, case["model"], opts=case["opts"])
        value, stats = run_zero_shot(cfg, device="cpu")
        out[f"zero_shot/{case['name']}"] = {"value": float(value),
                                            "n_images": int(stats["n_images"])}


def checkpoint_checks(case, out):
    """A ZeRO-1 run of one epoch that checkpoints, a copy of its
    checkpoints for the one-process resume, and the run resumed on the
    same processes for a second epoch."""
    from msclip_torch.tools.train import train

    def cfg(epochs):
        c = get_default_config()
        update_config(c, case["cfg"], opts=["TRAIN.END_EPOCH", epochs,
                                            "TPU.ZERO1", True])
        return c

    _, first = train(cfg(1), device="cpu", out_dir=case["out"])
    if C.comm.is_main_process():
        shutil.copytree(os.path.join(case["out"], "checkpoints"),
                        os.path.join(case["copy"], "checkpoints"))
    C.comm.synchronize()
    _, second = train(cfg(2), device="cpu", out_dir=case["out"])
    out["checkpoint"] = {"first": first["losses"],
                         "second": second["losses"],
                         "second_first_step": second["first_step"]}


def tensor_parallel_checks(case, out):
    """One epoch with every block split over both processes (``1 x 2``:
    they share their rows); rank 0's checkpoint holds whole tensors."""
    from msclip_torch.tools.train import train

    cfg = get_default_config()
    update_config(cfg, case["cfg"], opts=["TRAIN.END_EPOCH", 1,
                                          "TPU.MESH_MODEL", 2])
    _, stats = train(cfg, device="cpu", out_dir=case["tp_out"])
    out["tensor_parallel"] = {"losses": stats["losses"],
                              "global_batch": stats["global_batch"]}


def main(indir, outdir):
    torch.set_num_threads(1)
    C.init_distributed("cpu")
    mesh = create_mesh()
    with open(os.path.join(indir, "cases.json")) as f:
        cases = json.load(f)
    out = {}
    comm_checks(out)
    loss_checks(indir, mesh.data_group, out)
    step_checks(indir, mesh, out)
    zero_shot_checks(cases["zero_shot"], out)
    checkpoint_checks(cases["checkpoint"], out)
    tensor_parallel_checks(cases["checkpoint"], out)
    torch.save(out, os.path.join(outdir, f"rank{C.comm.rank}.pt"))
    C.comm.synchronize()
    C.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:3])

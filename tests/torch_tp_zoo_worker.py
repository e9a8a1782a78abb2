"""One process of the zoo's tensor-parallel checks (JAX-free), started by
``tests/test_torch_tp_zoo.py`` once a rank with ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set (gloo on the CPU):

    python tests/torch_tp_zoo_worker.py <inputs dir> <outputs dir>

Both ranks form one model group (``TPU.MESH_MODEL 2``, a ``1 x 2`` mesh:
they share their rows). For each family in ``<inputs dir>/families.json``
(its config ``<family>.json`` and weights ``<family>.pt``, the port's
layout) it computes the image and text features of ``batch.npz`` in eval
mode with every block split over the group, and one train step's loss,
gradients (whole) and BatchNorm statistics; then the same step with a
planted fault (``faults.json``: a collective whose backward is left out).
Rank 0 writes ``<outputs dir>/results.pt``.
"""

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from msclip_torch.config import get_default_config, update_config  # noqa: E402
from msclip_torch.models import msclip as MM  # noqa: E402
from msclip_torch.parallel import collectives as PC  # noqa: E402
from msclip_torch.parallel.mesh import create_mesh, split_for_model  # noqa: E402
from msclip_torch.tools.dryrun import run_steps  # noqa: E402
from msclip_torch.utils import comm as C  # noqa: E402


def family_config(indir, name):
    cfg = get_default_config()
    update_config(cfg, os.path.join(indir, f"{name}.json"),
                  opts=["TPU.MESH_MODEL", "2"])
    return cfg


def features(cfg, params, batch, mesh):
    """Eval-mode image and text features with the blocks split over the
    model group (the deterministic Gumbel action)."""
    spec = MM.build_spec(cfg)
    split = split_for_model(params, mesh)
    images = torch.from_numpy(batch["images"])
    tokens = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        return {"image": MM.encode_image(split, spec, images,
                                         tp=mesh.model_group),
                "text": MM.encode_text(split, spec, tokens,
                                       tp=mesh.model_group)}


def step(cfg, params, batch, mesh):
    r = run_steps(cfg, params, batch["images"], batch["tokens"], mesh,
                  torch.device("cpu"), steps=1)
    return {"loss": r["losses"][0], "grads": r["grads"], "bn": r["bn"]}


def _without_backward(fn):
    """``fn``'s forward with an identity backward: the planted fault of a
    collective whose gradient exchange is left out."""
    class F(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group, *rest):
            return fn(x, group, *rest).detach()

        @staticmethod
        def backward(ctx, g):
            return (g,) + (None,) * 2

    def apply(x, group, *rest):
        if group is None:
            return fn(x, group, *rest)
        return F.apply(x, group, *rest)

    return apply


def faulted(name, run):
    """``run()`` with the collective ``name`` of ``parallel.collectives``
    planted without its backward exchange."""
    import msclip_torch.models.extensions as X

    kept = getattr(X, name)
    if name == "scatter_to_group":  # the gradient stays this rank's part
        def planted(x, group, dim=-1):
            if group is None:
                return x
            part = PC._part(x, group, dim % x.ndim)
            # the other ranks' columns get no gradient
            return part + 0 * x.sum()
    else:
        planted = _without_backward(kept)
    setattr(X, name, planted)
    try:
        return run()
    finally:
        setattr(X, name, kept)


def main(indir, outdir):
    torch.set_num_threads(1)
    C.init_distributed("cpu")
    mesh = create_mesh(1, 2)
    with open(os.path.join(indir, "families.json")) as f:
        families = json.load(f)
    with open(os.path.join(indir, "faults.json")) as f:
        faults = json.load(f)
    batch = dict(np.load(os.path.join(indir, "batch.npz")))
    out = {}
    for name in families:
        cfg = family_config(indir, name)
        params = torch.load(os.path.join(indir, f"{name}.pt"),
                            weights_only=True)
        out[name] = {"features": features(cfg, params, batch, mesh),
                     "step": step(cfg, params, batch, mesh)}
        if name in faults:
            out[name]["fault"] = faulted(
                faults[name], lambda: step(cfg, params, batch, mesh))
    if C.comm.rank == 0:
        torch.save(out, os.path.join(outdir, "results.pt"))
    C.comm.synchronize()
    C.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:3])

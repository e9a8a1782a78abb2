"""Export model parameters to a reference-layout torch ``.pth`` (the JAX
package's ``tools/export_torch_checkpoint.py``).

    python -m msclip_torch.tools.export_torch_checkpoint \\
        --model <model.yaml|json> [--ckpt <reference .pth>] --out model.pth \\
        [--device cuda|cpu] [KEY VALUE ...]

Reads what the port's eval loads (``MODEL.PRETRAINED_MODEL`` or ``--ckpt``:
a reference ``.pth``, or a directory of the port's train driver, a step
or an EMA/SWA shadow; none: random weights from ``TPU.SEED``) and writes
the reference ``state_dict``, aliased shared keys under both names, so it
loads into the reference PyTorch code. The conversion is host work;
``--device`` keeps the entry points' rule (cuda unless ``--device cpu``).
"""

from __future__ import annotations

import argparse

import torch

from ..config import get_default_config, update_config
from ..eval.checkpoint_load import load_model_params
from ..eval.zero_shot import resolve_device
from ..models.msclip import spec_from_config
from ..utils.convert import export_state_dict


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export torch checkpoint.")
    p.add_argument("--model", required=True)
    p.add_argument("--ckpt", default="",
                   help="overrides PRETRAINED_MODEL (.pth, or a checkpoint "
                        "directory of msclip_torch.tools.train)")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    resolve_device(args.device)
    config = get_default_config()
    update_config(config, args.model, opts=args.opts)
    if args.ckpt:
        config.MODEL.PRETRAINED_MODEL = args.ckpt
    spec = spec_from_config(config)
    sd = export_state_dict(load_model_params(config, spec), spec)
    torch.save(sd, args.out)
    print(f"RESULT exported {len(sd)} tensors to {args.out}")


if __name__ == "__main__":
    main()

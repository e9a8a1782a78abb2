"""Linear-probe evaluation CLI of the port (the JAX package's
``tools/linear_probe.py``; the reference's model-zoo "linear probing"
column, protocol per the CLIP paper).

    python -m msclip_torch.tools.linear_probe --ds <dataset.yaml> \\
        --model <model.yaml|json> [--probe sklearn|torch] [--sweep-c] \\
        [--device cuda|cpu] [KEY VALUE ...]

``--probe sklearn`` needs scikit-learn on the host; ``--probe torch`` fits
on the device.
"""

from __future__ import annotations

import argparse

from ..config import get_default_config, update_config
from ..eval.linear_probe import run_linear_probe
from ..eval.zero_shot import make_dataset, resolve_device
from ..utils.logging import create_logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Linear probe a CLIP model.")
    p.add_argument("--ds", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--probe", default="sklearn", choices=["sklearn", "torch"])
    p.add_argument("--sweep-c", action="store_true",
                   help="CLIP-paper protocol: validation sweep over the "
                        "regularization constant before the final fit "
                        "(sklearn probe only)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    config = get_default_config()
    update_config(config, args.ds)
    update_config(config, args.model, opts=args.opts)
    create_logger(config, args.model, "linear_probe")

    train_ds = make_dataset(config, image_set="train")
    test_ds = make_dataset(config, image_set="test")
    probe_kw = {"sweep_c": True} if (args.sweep_c
                                     and args.probe == "sklearn") else {}
    acc = run_linear_probe(config, train_ds, test_ds, probe=args.probe,
                           device=device, **probe_kw)
    print(f"RESULT {config.DATASET.DATASET} linear_probe={acc:.3f}")
    return acc


if __name__ == "__main__":
    main()

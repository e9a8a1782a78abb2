"""Zero-shot evaluation CLI of the port.

    python -m msclip_torch.tools.zero_shot --ds <dataset.yaml> \\
        --model <model.yaml> [--device cpu] [KEY VALUE ...]

The interface of the JAX package's ``tools/zero_shot.py``: the dataset
config is merged, then the model config with the overrides. Runs on the
CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..config import get_default_config, update_config
from ..eval.zero_shot import run_zero_shot


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Zero-shot evaluation of an MS-CLIP model (PyTorch).")
    parser.add_argument("--ds", required=True,
                        help="Evaluation dataset configure file name.")
    parser.add_argument("--model", required=True,
                        help="Evaluation model configure file name")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' for the "
                             "plain versions of the kernels)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="Modify config options using the command-line")
    return parser.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(message)s")
    args = parse_args(argv)
    config = get_default_config()
    update_config(config, args.ds)
    update_config(config, args.model, opts=args.opts)
    config.NAME = ""
    value, stats = run_zero_shot(config, device=args.device)
    print(f"RESULT {config.DATASET.DATASET} "
          f"{stats['metric']}={value:.3f} "
          f"images_per_sec={stats['images_per_sec']:.0f}")
    return value


if __name__ == "__main__":
    main()

"""Zero-shot evaluation CLI of the port.

    python -m msclip_torch.tools.zero_shot --ds <dataset.yaml> \\
        --model <model.yaml> [--device cpu] [KEY VALUE ...]

The interface of the JAX package's ``tools/zero_shot.py``: the dataset
config is merged, then the model config with the overrides; the log goes
under ``OUTPUT_DIR`` (``utils/logging.create_logger``). Runs on the CUDA
card unless ``--device cpu`` is given; under ``torchrun`` each process
evaluates its stripe on its own card and rank 0 prints the result.
"""

from __future__ import annotations

import argparse
import logging
import pprint

from ..config import get_default_config, update_config
from ..eval.zero_shot import resolve_device, run_zero_shot
from ..utils.comm import comm, init_distributed, shutdown
from ..utils.logging import create_logger
from ..utils.platform import apply_platform_override


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Zero-shot evaluation of an MS-CLIP model (PyTorch).")
    parser.add_argument("--ds", required=True,
                        help="Evaluation dataset configure file name.")
    parser.add_argument("--model", required=True,
                        help="Evaluation model configure file name")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda, or cpu under "
                             "MSCLIP_PLATFORM=cpu; 'cpu' for the plain "
                             "versions of the kernels)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="Modify config options using the command-line")
    return parser.parse_args(argv)


def main(argv=None):
    device = apply_platform_override()  # MSCLIP_PLATFORM, MSCLIP_DEBUG_NANS
    args = parse_args(argv)
    args.device = args.device or device
    device = resolve_device(args.device)
    init_distributed(device)
    config = get_default_config()
    update_config(config, args.ds)
    update_config(config, args.model, opts=args.opts)
    config.NAME = ""
    pretrained = config.MODEL.get("PRETRAINED_MODEL", "") or "scratch/none"
    tag = pretrained.split("/")[-2] if "/" in pretrained else "none"
    final_output_dir = create_logger(config, args.model, f"zero_shot_{tag}")
    logging.info(pprint.pformat(vars(args)))
    logging.info(f"=> saving logging info into: {final_output_dir}")
    value, stats = run_zero_shot(config, device=device)
    main_process = comm.is_main_process()
    shutdown()
    if main_process:
        print(f"RESULT {config.DATASET.DATASET} "
              f"{stats['metric']}={value:.3f} "
              f"images_per_sec={stats['images_per_sec']:.0f}")
    return value


if __name__ == "__main__":
    main()

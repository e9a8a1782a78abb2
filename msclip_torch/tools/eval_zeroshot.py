"""Zero-shot evaluation job dispatcher of the port (the JAX package's
``tools/eval_zeroshot.py``).

    python -m msclip_torch.tools.eval_zeroshot --model <model.yaml|json> \\
        [--ds name[,name2...]] [--device cuda|cpu] [KEY VALUE ...]

Maps dataset names to the dataset configs of ``experiments/dataset/``
(``--ds`` also takes config paths; default: every registered name) and
runs ``python -m msclip_torch.tools.zero_shot`` in a subprocess per
dataset, forwarding ``--device`` and the overrides. An unknown name fails
before any job starts; the exit status is non-zero when a job failed.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from ..eval.zero_shot import resolve_device

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_DS_DIR = os.path.join(REPO_ROOT, "experiments", "dataset")


def registered_datasets():
    """name -> dataset config path, from ``experiments/dataset/*.yaml``."""
    return {os.path.splitext(f)[0]: os.path.join(_DS_DIR, f)
            for f in sorted(os.listdir(_DS_DIR)) if f.endswith(".yaml")}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Dispatch zero-shot evaluation jobs (PyTorch).")
    parser.add_argument("--ds", type=str,
                        help="comma-separated dataset names (or dataset "
                             "config paths); default: all registered")
    parser.add_argument("--model", required=True, type=str,
                        help="model config for every job")
    parser.add_argument("--save-feature", default=False, type=str,
                        help="accepted for interface compatibility (use "
                             "msclip_torch.tools.extract_features to dump "
                             "features)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of every job (default cuda)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="KEY VALUE config overrides appended to each "
                             "job")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    resolve_device(args.device)
    registry = registered_datasets()
    names = list(registry) if args.ds is None else args.ds.split(",")
    for name in names:
        if not os.path.exists(name) and name not in registry:
            raise ValueError(f"unknown dataset {name!r}: neither a config "
                             f"path nor a registered name ({sorted(registry)})")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    failed = []
    for name in names:
        cmd = [sys.executable, "-m", "msclip_torch.tools.zero_shot",
               "--ds", name if os.path.exists(name) else registry[name],
               "--model", args.model, "--device", args.device] + (
                   args.opts or [])
        if subprocess.run(cmd, env=env, check=False).returncode != 0:
            failed.append(name)
    if failed:
        sys.exit(f"zero-shot jobs failed: {failed}")


if __name__ == "__main__":
    main()

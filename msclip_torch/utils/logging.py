"""Log files of the CLIs (port of ``msclip_tpu/utils/logging.py``).

The reference's layout (``lib/utils/utils.py:21-58``):
``{phase}_{timestamp}_rank{rank}.txt`` under
``OUTPUT_DIR/<dataset>/<config name>``, a file per process, each line
tagged ``Rank[r/w]`` from ``utils/comm.py`` (0 of 1 without a process
group). Rank 0 also copies its lines to the console, on stderr, leaving
stdout to the CLIs' ``RESULT`` lines.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from pathlib import Path

from .comm import comm


def setup_logger(final_output_dir, rank, phase, world_size=1):
    time_str = time.strftime("%Y-%m-%d-%H-%M")
    log_file = os.path.join(final_output_dir,
                            f"{phase}_{time_str}_rank{rank}.txt")
    fmt = f"[%(asctime)s] Rank[{rank}/{world_size}]: %(message)s"
    logging.basicConfig(filename=log_file, format=fmt, level=logging.INFO,
                        force=True)
    if rank == 0:
        console = logging.StreamHandler(sys.stderr)
        console.setFormatter(logging.Formatter(fmt))
        logging.getLogger("").addHandler(console)


def create_logger(config, cfg_name, phase="train"):
    """Start logging to a file under ``OUTPUT_DIR`` (``OUTPUT`` when
    unset) and return that directory."""
    root_output_dir = Path(config.OUTPUT_DIR or "OUTPUT")
    dataset = config.DATASET.DATASET
    cfg_name = os.path.splitext(os.path.basename(cfg_name))[0]
    final_output_dir = root_output_dir / dataset / cfg_name
    final_output_dir.mkdir(parents=True, exist_ok=True)
    setup_logger(final_output_dir, comm.rank, phase, comm.world_size)
    return str(final_output_dir)

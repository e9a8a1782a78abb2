"""Config output, the port of ``msclip_tpu/config/io.py``: the rank-0 dump
of a run's config (reference ``lib/config/default.py:330-333``) and the
DeepSpeed JSON export (``:322-327``; config-only in the reference, kept
for YAML compatibility and inert here)."""

from __future__ import annotations

import json


def save_config(cfg, path: str) -> None:
    """Write ``cfg.dump()`` to ``path`` on rank 0 only (``utils/comm``)."""
    from ..utils.comm import comm

    if comm.is_main_process():
        with open(path, "w") as f:
            f.write(cfg.dump())


def export_deepspeed_config(config, total_batch: int, path: str) -> None:
    """Set ``DEEPSPEED.train_batch_size`` and write the ``DEEPSPEED`` node
    as JSON to ``path``."""
    config.DEEPSPEED.train_batch_size = total_batch
    with open(path, "w") as f:
        json.dump(config.DEEPSPEED.to_dict(), f, indent=4)

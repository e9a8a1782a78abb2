"""The process's device, the port of ``msclip_tpu/eval/device.py``.

The reference binds one process to one GPU (``CUDA_VISIBLE_DEVICES`` a
rank); the port does the same through ``LOCAL_RANK``: a bare ``cuda``
means ``cuda:LOCAL_RANK``, so each process of a ``torchrun`` launch takes
its own card, and ``TEST.BATCH_SIZE_PER_GPU`` keeps its per-card meaning.
Several processes stripe an eval set over the cards (``utils/comm.py``);
the JAX package's split of one process's batch over its local chips has
no counterpart here.
"""

from __future__ import annotations

import torch

from ..utils.comm import comm


def resolve_device(device) -> torch.device:
    """The entry points' device rule: ``cuda`` unless the caller asks for
    the CPU, ``cuda`` without an index meaning this process's card
    (``cuda:LOCAL_RANK``), and no silent fall back when there is no
    card."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' (CLI: --device cpu) to run on "
                               "the CPU")
        if device.index is None:
            device = torch.device("cuda", comm.local_rank)
    return device

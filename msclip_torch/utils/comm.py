"""Process-group helpers, the port of ``msclip_tpu/utils/comm.py``.

One process drives one device, as the reference binds one process to one
GPU. ``torchrun`` (``python -m torch.distributed.run``) starts the
processes and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``; :func:`init_distributed` joins them
into the default process group, NCCL for a CUDA device and gloo for the
CPU. With no group initialized every helper is the single-process one:
rank 0 of 1, and each collective returns its input.

The helpers here are host-side (rank bookkeeping, barriers, object and
array gathers, metric reduction), as in the JAX package; the training
collectives live in ``parallel/``.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


class Comm:
    """Rank and world size of this process, single-process without a
    group (the reference's ``Comm`` guards, ``lib/utils/comm.py:12-65``)."""

    @property
    def rank(self) -> int:
        return dist.get_rank() if initialized() else 0

    @property
    def world_size(self) -> int:
        return dist.get_world_size() if initialized() else 1

    @property
    def local_rank(self) -> int:
        """This process's device index on its host (``LOCAL_RANK``)."""
        return int(os.environ.get("LOCAL_RANK", 0))

    def is_main_process(self) -> bool:
        return self.rank == 0

    def synchronize(self) -> None:
        """Barrier over every process (reference ``synchronize``,
        ``comm.py:54-65``)."""
        if self.world_size > 1:
            dist.barrier()


comm = Comm()


def requested() -> bool:
    """Was this process started by a launcher (``WORLD_SIZE`` set)?"""
    return "WORLD_SIZE" in os.environ


def init_distributed(device) -> bool:
    """Join the process group that ``torchrun`` describes in the
    environment (reference ``init_distributed``, ``lib/utils/utils.py:
    61-73``): NCCL when ``device`` is a CUDA device, gloo for the CPU. On
    CUDA the process's device, ``cuda:LOCAL_RANK``, is made current before
    anything is allocated. A NCCL group that fails to start raises; there
    is no fall back to gloo. Returns False, doing nothing, when no
    launcher set ``WORLD_SIZE`` or the group exists already."""
    if not requested() or initialized():
        return False
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(comm.local_rank)
        dist.init_process_group(
            "nccl", device_id=torch.device("cuda", comm.local_rank))
    else:
        dist.init_process_group("gloo")
    return True


def shutdown() -> None:
    """Leave the process group, if this process joined one (the CLIs'
    last step under ``torchrun``)."""
    if initialized():
        dist.destroy_process_group()


def all_gather_object(data):
    """Every process's picklable ``data``, in rank order (reference
    ``all_gather``, ``comm.py:68-108``). The payloads are this program's
    own, written by its processes."""
    if comm.world_size == 1:
        return [data]
    out = [None] * comm.world_size
    dist.all_gather_object(out, data)
    return out


def _collective_device():
    """The device a collective's tensors live on: the current CUDA device
    under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_arrays(x) -> np.ndarray:
    """Concatenate a per-process array along axis 0 over every process,
    in rank order. Leading dims may differ (an eval stripe
    ``order[rank::world]`` is one sample shorter on some ranks): the
    lengths are gathered first, each array padded to the longest, and the
    padding sliced off again (``msclip_tpu/utils/comm.py:94-119``)."""
    x = np.asarray(x)
    if comm.world_size == 1:
        return x
    device = _collective_device()
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=device)
    lengths = torch.empty(comm.world_size, dtype=torch.int64, device=device)
    dist.all_gather_into_tensor(lengths, n)
    lengths = lengths.tolist()
    longest = max(lengths)
    padded = np.zeros((longest,) + x.shape[1:], x.dtype)
    padded[:x.shape[0]] = x
    t = torch.from_numpy(padded).to(device)
    out = torch.empty((comm.world_size * longest,) + x.shape[1:],
                      dtype=t.dtype, device=device)
    dist.all_gather_into_tensor(out, t)
    out = out.cpu().numpy().reshape((comm.world_size, longest) + x.shape[1:])
    return np.concatenate([out[i, :m] for i, m in enumerate(lengths)])


def reduce_dict(d: Dict[str, float], average: bool = True
                ) -> Dict[str, float]:
    """Scalar metrics summed (or averaged) over every process; every
    process gets the result (reference ``reduce_dict``, ``comm.py:
    111-137``, which reduces to rank 0 only). Summed in float64, so
    counts stay exact."""
    if comm.world_size == 1:
        return dict(d)
    keys = sorted(d)
    vec = torch.tensor([float(d[k]) for k in keys], dtype=torch.float64,
                       device=_collective_device())
    dist.all_reduce(vec)
    if average:
        vec /= comm.world_size
    return dict(zip(keys, vec.tolist()))


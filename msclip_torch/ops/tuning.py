"""Per-device kernel tuning: the gates and packings the kernels' callers read.

Port of ``msclip_tpu/ops/tuning.py``. The JAX package keys its table on the
TPU generation; the port keys it on the CUDA device's compute capability
(``"sm_90"`` for Hopper), with a default row for the CPU and for any device
the table does not name. The default row holds the JAX package's v5e
values, its own default.

* ``int8_min_seq``: the shortest sequence whose int8 block takes the fused
  quantizers K3/K4 (``models/layers.transformer_block``); shorter ones
  quantize each GEMM input on the fly.
* ``attn_lane_pack``: how many maskless short rows K1 packs into one
  attention row under a block-diagonal mask (``ops/attention.py``; 1 is
  off).

The ``sm_90`` row is set from measurements on an H100
(``chip_smoke.py`` ``measure_tuning``): a value moves from the default
only where the card showed a win.

Environment overrides, read at each call as the JAX package reads them
(``int(os.environ[...])``):

* ``MSCLIP_INT8_MIN_SEQ``: ``int8_min_seq``;
* ``MSCLIP_ATTN_PACK``: ``attn_lane_pack``.

The JAX package's two VMEM budgets (``MSCLIP_ATTN_VMEM``,
``MSCLIP_QUANT_VMEM``) size the Pallas kernels' batch tiles. The port's
kernels plan their own groups from the card's shared memory and SM count,
so those budgets have no counterpart here: setting either logs one warning
that says so, and changes nothing.
"""

from __future__ import annotations

import functools
import logging
import os
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class KernelTuning:
    # the fused int8 block's gate (models/layers.transformer_block)
    int8_min_seq: int
    # maskless rows of L <= 128 / pack packed into one K1 row; 1 = off
    attn_lane_pack: int


# the JAX package's v5e row (msclip_tpu/ops/tuning.py), its default
DEFAULT = KernelTuning(int8_min_seq=96, attn_lane_pack=1)
_TABLE = {
    # Hopper, from chip_smoke.py's measure_tuning on an NVIDIA H100 80GB
    # HBM3 (700 W), device time in turns: B/16's int8 text tower (1024
    # prompts, L = 77) took 141.6 ms with the fused quantizers (gate 77)
    # against 269.3 ms quantizing each GEMM input in torch (gate 96); K1
    # and K2 at 256 x 50 (bf16, heads of 64) took 2.06x and 2.04x as long
    # packed two rows to one (a row of 100 pads to 128: twice the score
    # work of two rows of 50, each padded to 64), so the pack stays 1
    "sm_90": KernelTuning(int8_min_seq=77, attn_lane_pack=1),
}
_NO_COUNTERPART = ("MSCLIP_ATTN_VMEM", "MSCLIP_QUANT_VMEM")


def device_key(device=None) -> str:
    """The table's key of ``device``: ``"sm_<major><minor>"`` for a CUDA
    device, ``"cpu"`` for the CPU or None."""
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return device.type
    major, minor = torch.cuda.get_device_capability(device)
    return f"sm_{major}{minor}"


@functools.lru_cache(maxsize=None)
def _warn_no_counterpart(var: str) -> None:
    logging.warning(
        "%s is set: it sizes the JAX package's Pallas batch tiles, which "
        "have no counterpart in msclip_torch (its kernels plan their own "
        "groups); it is ignored", var)


def get_tuning(device=None) -> KernelTuning:
    """The tuning of ``device`` (a CUDA device, or the CPU for None): its
    row of the table, or :data:`DEFAULT`, with the environment's
    overrides."""
    base = _TABLE.get(device_key(device), DEFAULT)
    for var in _NO_COUNTERPART:
        if var in os.environ:
            _warn_no_counterpart(var)
    return KernelTuning(
        int(os.environ.get("MSCLIP_INT8_MIN_SEQ", base.int8_min_seq)),
        int(os.environ.get("MSCLIP_ATTN_PACK", base.attn_lane_pack)))

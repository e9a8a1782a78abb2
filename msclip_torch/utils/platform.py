"""The CLIs' platform switches, the port of ``msclip_tpu/utils/platform.py``.

Every CLI of the port whose JAX twin calls ``apply_platform_override``
calls :func:`apply_platform_override` first thing:

* ``MSCLIP_PLATFORM=cpu`` is a caller's explicit request for the CPU, so
  it becomes the CLI's default device (the plain versions of the kernels);
  ``--device`` still wins. ``MSCLIP_PLATFORM=cuda`` (or unset) keeps the
  entry points' default, the card.
* ``MSCLIP_DEBUG_NANS=1`` turns on autograd's anomaly detection
  (``utils/summary.debug_nans``), the variable twin of
  ``TRAIN.DETECT_ANOMALY``.

The JAX package's persistent compile cache (``MSCLIP_COMPILE_CACHE``) and
its per-compile XLA options (``xla_compiler_options``,
``MSCLIP_XLA_VMEM_KIB``) have no counterpart: PyTorch runs eagerly and
the port compiles nothing at run time but its CUDA kernels, which
``ops/cuda_build.py`` already keeps in ``msclip_torch/_build/`` across
processes.
"""

from __future__ import annotations

import os

PLATFORMS = ("cpu", "cuda")


def apply_platform_override() -> str:
    """Apply ``MSCLIP_DEBUG_NANS`` and return the CLI's default device:
    ``"cpu"`` under ``MSCLIP_PLATFORM=cpu``, else ``"cuda"``. Raises for a
    platform the port does not have."""
    plat = os.environ.get("MSCLIP_PLATFORM", "").strip().lower()
    if plat and plat not in PLATFORMS:
        raise ValueError(f"MSCLIP_PLATFORM={plat!r}: the port runs on "
                         f"{' or '.join(PLATFORMS)}")
    if os.environ.get("MSCLIP_DEBUG_NANS") == "1":
        from .summary import debug_nans

        debug_nans(True)
    return plat or "cuda"

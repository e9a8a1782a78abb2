"""Model summary, profiling and debug switches, the port of
``msclip_tpu/utils/summary.py``.

* :func:`param_tree_summary`: parameter counts grouped by key prefix;
* :func:`flops_estimate` and :func:`model_summary`: the operations of a
  forward, counted by ``torch.utils.flop_counter.FlopCounterMode``;
* :func:`profile_trace`: a ``torch.profiler`` Chrome trace around a
  region, and :class:`TraceWindow`, the ``MSCLIP_TRACE`` hook of
  zero-shot (batches 3-6) and of the train loop (steps 4-7);
* :func:`span`: the named ranges the port opens at its layer boundaries,
  recorded only while a profiler runs;
* :func:`debug_nans` and :func:`deterministic`: the
  ``TRAIN.DETECT_ANOMALY`` and ``CUDNN.DETERMINISTIC`` switches.

The JAX package counts FLOPs with XLA's cost analysis of the compiled
program, which also counts elementwise operations; ``FlopCounterMode``
counts the matrix products and convolutions only (``2 m n k`` each), so
its totals are a little below JAX's for the same model.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import time
from typing import Dict

import torch


def param_tree_summary(params: Dict[str, torch.Tensor],
                       depth: int = 2) -> Dict[str, int]:
    """Parameter counts of the port's flat parameter dict, grouped by the
    first ``depth`` parts of each dotted key, and ``TOTAL``, the count of
    every tensor (the same total as JAX's over the same model)."""
    counts: Dict[str, int] = {}
    for key, t in params.items():
        prefix = ".".join(key.split(".")[:depth])
        counts[prefix] = counts.get(prefix, 0) + t.numel()
    counts["TOTAL"] = sum(t.numel() for t in params.values())
    return counts


def flops_estimate(fn, *example_args) -> float:
    """The floating-point operations of ``fn(*example_args)``: its matrix
    products and convolutions as ``FlopCounterMode`` counts them. Run it
    on CPU tensors: the count sees torch operators, and a kernel the port
    launches through ``ctypes`` on the card is invisible to it, so on the
    CPU the plain versions stand in for the kernels."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter, torch.inference_mode():
        fn(*example_args)
    return float(counter.get_total_flops())


def model_summary(params: Dict[str, torch.Tensor], spec) -> str:
    """Printable summary: parameter counts by prefix and each tower's
    FLOPs at batch 1 (``encode_image`` at the spec's resolution,
    ``encode_text`` at its context length), counted on the CPU in fp32
    through the plain versions (:func:`flops_estimate`)."""
    from ..models import msclip as M

    counts = param_tree_summary(params)
    lines = ["Parameter counts:"]
    for k in sorted(counts):
        lines.append(f"  {k:40s} {counts[k]:>14,d}")
    cpu = {k: v.detach().to("cpu", torch.float32)
           if v.is_floating_point() else v.detach().cpu()
           for k, v in params.items()}
    size = spec.image_resolution
    images = torch.zeros(1, size, size, 3)
    tokens = torch.zeros(1, spec.context_length, dtype=torch.long)
    tokens[0, 1] = spec.vocab_size - 1  # an end token for the pooled row
    img = flops_estimate(lambda: M.encode_image(cpu, spec, images))
    txt = flops_estimate(lambda: M.encode_text(cpu, spec, tokens))
    lines.append(f"encode_image GFLOPs/img: {img / 1e9:.2f}")
    lines.append(f"encode_text GFLOPs/seq: {txt / 1e9:.2f}")
    return "\n".join(lines)


_TRACES = itertools.count()
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler`` range named ``name`` while a profiler runs,
    else a shared null context: with no profiler a span costs one check of
    torch's enabled flag.

    The port opens these at its layer boundaries (``msclip.image.stem``,
    ``.branch``, ``.block``, ``msclip.attention.fwd``, ``.bwd``,
    ``msclip.train.forward``, ``.backward``, ``.optimizer``); the
    profiler charges each range the device time of the kernels its thread
    launches inside it, on the clock of the device's own records. The
    range is a plain function range (``_RecordFunctionFast``), not a user
    annotation: the profiler gives a user annotation a device-side twin
    that spans its first to its last kernel, and that twin would fill the
    device's idle gaps inside the range in any timeline made of the
    trace's device events."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A ``torch.profiler`` trace of the region (host activity, and the
    card's where CUDA is available), written as a Chrome trace
    ``<log_dir>/trace_<pid>_<n>.json`` when the region ends. Yields the
    path the trace goes to."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{next(_TRACES)}"
                        f"_{int(time.time())}.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


class TraceWindow:
    """The ``MSCLIP_TRACE=<dir>`` hook of a loop: a :func:`profile_trace`
    over iterations ``first .. last`` (0-based, past the first iterations'
    set-up), opened by :meth:`before` and closed by :meth:`after`, or by
    :meth:`close` where the loop ends inside the window. The device is
    synchronised before the trace stops, so that it holds the window's
    work; ``log_dir`` None (the variable unset, or another rank than 0)
    traces nothing. ``path`` is the trace written, once it is."""

    def __init__(self, log_dir, first: int, last: int, device, what: str):
        self.log_dir, self.first, self.last = log_dir, first, last
        self.device, self.what = torch.device(device), what
        self.path = None
        self._stack = None

    def before(self, i: int) -> None:
        if self.log_dir and self._stack is None and self.path is None \
                and i == self.first:
            self._stack = contextlib.ExitStack()
            self.path = self._stack.enter_context(profile_trace(self.log_dir))

    def after(self, i: int) -> None:
        if self._stack is not None and i >= self.last:
            self.close()

    def close(self) -> None:
        if self._stack is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._stack.close()
        self._stack = None
        logging.info(f"=> profiler trace of {self.what} written to "
                     f"{self.path} (MSCLIP_TRACE)")


def debug_nans(enable: bool = True) -> None:
    """Autograd's anomaly detection (``TRAIN.DETECT_ANOMALY``; JAX's
    ``jax_debug_nans``): a backward that makes a NaN raises where the
    forward made the operation."""
    torch.autograd.set_detect_anomaly(enable)


def deterministic(enable: bool = True) -> None:
    """Deterministic kernels (``CUDNN.DETERMINISTIC``; JAX's deterministic
    reductions): cuDNN's deterministic algorithms, no benchmarking, and
    ``torch.use_deterministic_algorithms`` (an operator without a
    deterministic form warns). cuBLAS takes the fixed workspace that it
    needs for it (``CUBLAS_WORKSPACE_CONFIG``, unless set)."""
    torch.backends.cudnn.deterministic = enable
    torch.backends.cudnn.benchmark = not enable
    if enable:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(enable, warn_only=True)

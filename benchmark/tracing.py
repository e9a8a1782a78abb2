"""Traced spans of the window: ``torch.profiler`` over a few steps, read
into what the per-layer readers take (:class:`Span`).

A trace counts only when the profiler kept every record: its device time
is at most the span's CUDA-event time and 5% more, and each kernel whose
launches the program counts (``counters``) shows as many records as
launches. Otherwise the caller traces again, later in the window.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

RUNTIME_PREFIXES = ("cuda", "cu", "Memcpy", "Memset")
PASSES = 2  # traces a span takes, each over the span's steps
NAME_CHARS = 160  # a kernel's name in the breakdown, cut to this


@dataclass
class Span:
    steps: int
    window_s: float  # host clock, from a synchronised start to the end
    event_s: float  # CUDA events over the same steps
    busy_s: float  # union of device records
    kernels: dict = field(default_factory=dict)  # name -> [count, seconds]
    ops: dict = field(default_factory=dict)  # host op -> device seconds
    gaps: list = field(default_factory=list)  # [label, seconds], longest
    # kernels, busy and window seconds: the device-only trace; ops and
    # gaps: the second trace, with the host's ops


def _device_time_us(e, total):
    if total:
        t = getattr(e, "device_time_total", None)
        return e.cuda_time_total if t is None else t
    t = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if t is None else t


def _union(intervals):
    busy, end = 0.0, float("-inf")
    merged = []
    for a, b in sorted(intervals):
        if a > end:
            merged.append([a, b])
        else:
            merged[-1][1] = max(merged[-1][1], b)
        end = max(end, b)
    for a, b in merged:
        busy += b - a
    return busy, merged


def _label(cpu_events, t):
    """What the host was doing at ``t``: the outermost and the innermost
    host op (runtime calls left out) that cover it."""
    covering = [e for e in cpu_events
                if e.time_range.start <= t <= e.time_range.end]
    if not covering:
        return "host outside any op"
    covering.sort(key=lambda e: e.time_range.end - e.time_range.start)
    inner, outer = covering[0].name, covering[-1].name
    return outer if inner == outer else f"{outer} > {inner}"


def _profile(run_steps, steps, activities):
    """Profile ``run_steps(steps)`` from a synchronised start; returns the
    profiler, the host seconds and the CUDA-event seconds of the steps."""
    from torch.profiler import profile

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        run_steps(steps)
        stop.record()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return prof, window_s, start.elapsed_time(stop) / 1e3


def _kernels(prof):
    from torch.autograd import DeviceType

    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            k = kernels.setdefault(e.key, [0, 0.0])
            k[0] += e.count
            k[1] += _device_time_us(e, False) / 1e6
    return kernels


def _full(kernels, counters, launched):
    return all(sum(n for name, (n, _) in kernels.items() if part in name)
               == count for (part, _), count in zip(counters, launched))


def trace_span(run_steps, steps, counters=()):
    """Two traced spans of ``run_steps(steps)`` each. The first traces the
    device alone, so that the host runs at its untraced pace: busy and
    window seconds, the kernels. The second adds the host's ops, which
    slows the host: each op's device time, and the labels of the longest
    idle gaps. Both run whatever the first shows (``PASSES``), so that
    other processes can step with this one. ``counters``: ``(kernel name
    part, launches())`` pairs, each a program counter of one kernel's
    launches. Returns a :class:`Span`, or None when a trace lost
    records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    before = [read() for _, read in counters]
    prof, window_s, event_s = _profile(run_steps, steps,
                                       [ProfilerActivity.CUDA])
    launched = [read() - b for (_, read), b in zip(counters, before)]
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, _ = _union([(e.time_range.start, e.time_range.end)
                         for e in device])
    kernels = _kernels(prof)
    kept = 0 < busy_us / 1e6 <= 1.05 * event_s \
        and _full(kernels, counters, launched)

    before = [read() for _, read in counters]
    prof, _, event2_s = _profile(run_steps, steps, [ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA])
    launched = [read() - b for (_, read), b in zip(counters, before)]
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    cpu = [e for e in events if e.device_type == DeviceType.CPU
           and not e.name.startswith(RUNTIME_PREFIXES)]
    busy2_us, merged = _union([(e.time_range.start, e.time_range.end)
                               for e in device])
    if not kept or not 0 < busy2_us / 1e6 <= 1.05 * event2_s \
            or not _full(_kernels(prof), counters, launched):
        return None
    ops = {e.key: _device_time_us(e, True) / 1e6
           for e in prof.key_averages() if e.device_type == DeviceType.CPU}
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:])),
                  reverse=True)[:10]
    return Span(steps=steps, window_s=window_s, event_s=event_s,
                busy_s=busy_us / 1e6, kernels=kernels, ops=ops,
                gaps=[[_label(cpu, at + gap / 2), gap / 1e6]
                      for gap, at in gaps])


def breakdown(span: Span):
    """The device ops that took most time and the longest idle gaps."""
    top = sorted(span.kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_ops": [[name[:NAME_CHARS], s] for name, (_, s) in top],
            "idle_gaps": span.gaps}

"""What the kinds of cell share (``kinds/<kind>.py``): the seeded inputs,
the closed loop over a ring of resident batches, the clock, the outcome
of a run, and the readings a train step is compared by.

Each run draws its weights and inputs on the device from the seed, hands
them to the program (``msclip_torch``), warms up the cell's shapes, runs
the loop for the window, and then, with the program's state freed, holds
what the window produced against the plain reference (``reference.py``)
on the same weights and inputs.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from . import manifest
from . import reference as R
from . import tracing

INPUT_STREAM = 1 << 62  # the inputs' generator seed is seed ^ this
TRACE_AT = (0.3, 0.5, 0.7)  # shares of the window where a span is traced


@dataclass
class Outcome:
    setup_s: float
    window_s: float
    steps: int
    items: int
    step_s: list
    memory_peak_bytes: int
    attempted: int
    failed: int
    checks: dict = field(default_factory=dict)  # name -> (value, limit)
    span: object = None
    info: dict = field(default_factory=dict)  # readings beside the checks

    @property
    def correct(self):
        return self.attempted > 0 and self.failed == 0 and all(
            v == v and v <= limit for v, limit in self.checks.values())


@contextlib.contextmanager
def full_precision():
    """float32 products and convolutions (no TF32) inside, as the
    reference needs; the settings are restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    R.set_full_precision()
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def port_config(path, opts=()):
    """The program's config and spec from the configuration file."""
    from msclip_torch.config import get_default_config, update_config
    from msclip_torch.models.msclip import build_spec

    cfg = get_default_config()
    update_config(cfg, path, opts=list(opts))
    return cfg, build_spec(cfg)


def input_generator(seed, device):
    return torch.Generator(device=device).manual_seed(seed ^ INPUT_STREAM)


def make_images(a, traffic, gen, device):
    """``[ring, batch, H, W, 3]`` uint8 images, uniform noise."""
    shape = (traffic["ring"], traffic["batch"], a.resolution, a.resolution, 3)
    return torch.randint(0, 256, shape, generator=gen, device=device,
                         dtype=torch.uint8)


def make_tokens(a, traffic, gen, device):
    """``[ring, batch, context]`` caption rows: start token, a seeded
    number of ids in ``traffic["caption_tokens"]``, end token, zeros."""
    ring, batch, ctx = traffic["ring"], traffic["batch"], a.context
    lo, hi = traffic["caption_tokens"]
    lengths = torch.randint(lo, hi + 1, (ring, batch, 1), generator=gen,
                            device=device)
    body = torch.randint(1, a.vocab - 2, (ring, batch, ctx), generator=gen,
                         device=device)
    pos = torch.arange(ctx, device=device)
    tokens = torch.where(pos <= lengths, body, torch.zeros_like(body))
    tokens = torch.where(pos == lengths + 1, a.vocab - 1, tokens)
    tokens[..., 0] = a.vocab - 2
    return tokens.to(torch.int32)


def make_classifier(a, traffic, gen, device):
    """``[classes, embed]`` unit rows, in bfloat16 as the program holds a
    classifier."""
    w = torch.randn(traffic["classes"], a.embed, generator=gen, device=device)
    return (w / w.norm(dim=-1, keepdim=True)).to(torch.bfloat16)


def normalizer(device):
    from msclip_torch.data.transforms import normalize_uint8

    mean = torch.tensor(R.IMAGE_MEAN, device=device)
    std = torch.tensor(R.IMAGE_STD, device=device)
    return lambda images: normalize_uint8(images, mean, std)


class Clock:
    """Marks at step ends: CUDA events on the card, the host clock on the
    CPU (tests). ``intervals()`` gives each step's seconds."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def intervals(self):
        if self.cuda:
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Processes:
    """This process's place among the run's processes: one, or those of
    the default process group, which every step's collectives span. The
    host's choices (how many steps, whether a trace counts) are made over
    a gloo group, so that they never wait on a card."""

    def __init__(self):
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = dist.get_rank() if self.world > 1 else 0
        self.host = (dist.new_group(backend="gloo") if self.world > 1
                     else None)

    @property
    def first(self):
        return self.rank == 0

    def largest(self, *values):
        """Each whole number the largest over the processes."""
        if self.world == 1:
            return values
        t = torch.tensor([int(v) for v in values], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host)
        return tuple(t.tolist())

    def agree(self, *flags):
        """Each flag true where any process's is."""
        return tuple(bool(v) for v in self.largest(*flags))

    def barrier(self):
        if self.world > 1:
            dist.barrier(group=self.host)

    def worst(self, numbers, device):
        """``numbers`` (a dict of floats), each the largest over the
        processes."""
        if self.world == 1 or not numbers:
            return numbers
        names = sorted(numbers)
        t = torch.tensor([float(numbers[k]) for k in names],
                         dtype=torch.float64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return dict(zip(names, t.tolist()))

    def mean(self, value, device):
        if self.world == 1:
            return value
        t = torch.tensor([value], dtype=torch.float64, device=device)
        dist.all_reduce(t)
        return t.item() / self.world

    def total(self, value, device):
        if self.world == 1:
            return value
        t = torch.tensor([value], dtype=torch.int64, device=device)
        dist.all_reduce(t)
        return int(t.item())


def run_window(step, on_output, first_slot, ring, seconds, device, trace,
               trace_steps=0, counters=(), procs=None, pace=None):
    """The closed loop: step after step round the ring from
    ``first_slot``, then a synchronise. One process steps until
    ``seconds`` have passed on the host clock; several take the same
    number of steps, those that ``seconds`` holds at the slowest
    process's ``pace`` (seconds a step, from set-up), so that no step
    waits on the others' hosts. With ``trace``, ``trace_steps`` steps at a
    share of the window (``TRACE_AT``) run under the profiler in every
    process, again later if a process's trace lost records; the span's
    busy seconds are the processes' mean. Returns ``(window_s, steps,
    step_seconds, span)`` with the first process's span."""
    procs = procs or Processes()
    clock = Clock(device)
    i = 0

    def one():
        nonlocal i
        slot = (first_slot + i) % ring
        on_output(i, slot, step(slot))
        clock.mark()
        i += 1

    def many(n):
        for _ in range(n):
            one()

    if procs.world > 1:
        total, = procs.largest(max(1, round(seconds / pace)))
        due = [int(share * total) for share in TRACE_AT]
    span, tries = None, 0
    sync(device)
    procs.barrier()
    t0 = time.perf_counter()
    clock.mark()
    while True:
        one()
        if procs.world == 1:
            now = time.perf_counter() - t0
            stop, at = now >= seconds, now / seconds
            traced = tries < len(TRACE_AT) and at >= TRACE_AT[tries]
        else:
            stop = i >= total
            traced = tries < len(due) and i >= due[tries]
        if trace and span is None and traced:
            tries += 1
            span = tracing.trace_span(many, trace_steps, counters)
            if procs.agree(span is None)[0]:
                span = None
            elif span is not None:
                span.busy_s = procs.mean(span.busy_s, device)
        elif stop:
            break
    sync(device)
    return time.perf_counter() - t0, i, clock.intervals(), span


def step_readings(step_s, top=5):
    """The window's median step and its slowest steps (index, ms)."""
    ms = [1e3 * s for s in step_s]
    slow = sorted(range(len(ms)), key=lambda j: -ms[j])[:top]
    return {"step_ms_median": statistics.median(ms) if ms else 0.0,
            "slowest_steps_ms": [[j, ms[j]] for j in slow]}


def memory_peak(device):
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)


def free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def attention_counters():
    """The program's launch counters of the attention kernels:
    ``(kernel name part, launches())``."""
    from msclip_torch.ops.attention import (
        fused_attention_qkv,
        fused_attention_qkv_bwd,
    )

    return [("attention_fwd", lambda: fused_attention_qkv.launches),
            ("attention_bwd", lambda: fused_attention_qkv_bwd.launches)]


def held(numbers, limits):
    """``{name: (value, limit)}`` of the numbers that have a limit."""
    return {k: (v, limits[k]) for k, v in numbers.items() if k in limits}


# ---------------------------------------------------------------------------
# the readings of a train step
# ---------------------------------------------------------------------------

PACKED = ("attn.in_proj_weight", "attn.in_proj_bias")


def leaves(tensors):
    """The tensors as the comparison's leaves: a packed in-projection is
    three, its query, key and value rows (``<name>.q``, ``.k``, ``.v``),
    as a model that stores them apart holds them; so the key's bias,
    whose gradient softmax cancels, is a leaf of its own."""
    out = {}
    for k, t in tensors.items():
        if k.endswith(PACKED):
            for part, piece in zip("qkv", t.chunk(3, dim=0)):
                out[f"{k}.{part}"] = piece
        else:
            out[k] = t
    return out


def leaf_norms(tensors):
    """``{leaf: norm}`` (:func:`leaves`) as floats, in one device round
    trip."""
    parts = leaves(tensors)
    names = list(parts)
    norms = torch.stack(torch._foreach_norm([parts[k].float()
                                             for k in names]))
    return dict(zip(names, norms.tolist()))


def program_first_grads(state):
    """``{name: gradient}`` of the first step as AdamW holds it: its first
    moment after one step is ``(1 - beta1) g``."""
    opt = state.optimizer
    names = state.shards.opt_names(opt)
    params = [p for g in opt.param_groups for p in g["params"]]
    betas = [g["betas"][0] for g in opt.param_groups for _ in g["params"]]
    return {k: opt.state[p]["exp_avg"] / (1 - b1)
            for k, p, b1 in zip(names, params, betas)}


@dataclass
class TrainReadings:
    losses: list  # each checked step's loss
    grads: dict  # first step's gradient norm a tensor
    changes: dict  # each trained tensor's change over the checked steps
    stats: dict  # each BatchNorm running statistic's change over them


def changes_of(now, start):
    """``(changes, stats)``: the norms of each trained tensor's and each
    running statistic's change from ``start`` to ``now``."""
    diff = {k: now[k].detach().float() - start[k] for k in start}
    return (leaf_norms({k: v for k, v in diff.items()
                        if not R.is_bn_stat(k)}),
            leaf_norms({k: v for k, v in diff.items() if R.is_bn_stat(k)}))


def reference_readings(cell, a, images, tokens, seed, device, prec=R.FP32,
                       fault=None, rows=None):
    """The reference's checked steps from the seed's weights, on this
    process's ``rows`` (a slice) of each global batch: with more than one
    process the reference's step spans them all
    (the layout's ``train_reference``). ``fault``: one planted in the
    reference (``half_batch``, ``no_exchange``)."""
    layout = manifest.layout(cell.config_path)
    rows = rows or slice(None)
    with full_precision():
        params = R.draw_params(layout.param_layout(a), seed, device)
        p0 = {k: v.clone() for k, v in params.items()}
        ref = layout.train_reference(params, a, cell.config_path,
                                     cell.traffic["steps_per_epoch"], prec,
                                     fault)
        losses, grads = [], None
        for s in range(cell.traffic["check_steps"]):
            loss, g = ref.step(images[s][rows], tokens[s][rows])
            losses.append(loss.item())
            if s == 0:
                grads = leaf_norms(g)
            del g
        changes, stats = changes_of(params, p0)
    del ref, params, p0
    free(device)
    return TrainReadings(losses, grads, changes, stats)


def leaf_gaps(prog, ref, keep):
    """Each tensor's gap of norms, ``|prog - ref|``, over the reference's
    norm of that tensor or of the median tensor, whichever is larger."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


def moving(ref: TrainReadings):
    """The tensors whose reference gradient is above a thousandth of the
    median tensor's: the others move by round-off alone under Adam."""
    med = statistics.median(ref.grads.values())
    return [k for k, g in ref.grads.items() if g >= 1e-3 * med]


def train_numbers(prog: TrainReadings, ref: TrainReadings):
    """``loss_gap``: the worst checked step's loss gap over the
    reference's loss. ``grad_gap``: the median tensor's gap of the first
    gradient (:func:`leaf_gaps`). ``change_gap``: the median moving
    tensor's gap of its change over the checked steps. ``bn_stat_gap``:
    the worst running statistic's gap of its change, and
    ``bn_stat_median_gap`` the median one's. The worst trained tensor's
    gap is no steady number: it reads the round-off of BatchNorm gradients
    summed over a whole map, and of elements whose gradient is nought,
    which Adam moves a whole step in the program and not in the reference;
    it is reported beside (:func:`train_readings_info`)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog.losses, ref.losses))
    grads = leaf_gaps(prog.grads, ref.grads, list(ref.grads))
    changes = leaf_gaps(prog.changes, ref.changes, moving(ref))
    stats = leaf_gaps(prog.stats, ref.stats, list(ref.stats))
    return {"loss_gap": loss,
            "grad_gap": statistics.median(grads.values()),
            "change_gap": statistics.median(changes.values()),
            "bn_stat_gap": max(stats.values()),
            "bn_stat_median_gap": statistics.median(stats.values())}


def train_readings_info(prog: TrainReadings, ref: TrainReadings, top=3):
    """Readings beside the compared ones: the worst tensors' gaps with
    their names, and the losses."""
    def worst(gaps):
        return sorted(((g, k) for k, g in gaps.items()), reverse=True)[:top]

    return {"grad_worst": worst(leaf_gaps(prog.grads, ref.grads,
                                          list(ref.grads))),
            "change_worst": worst(leaf_gaps(prog.changes, ref.changes,
                                            moving(ref))),
            "stat_worst": worst(leaf_gaps(prog.stats, ref.stats,
                                          list(ref.stats))),
            "losses": [prog.losses, ref.losses]}

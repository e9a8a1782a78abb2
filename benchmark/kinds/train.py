"""The contrastive train step: ``init_train_state`` and
``make_train_step_from_config`` on one process or, under a process group,
data parallel over its processes with the gathered InfoNCE. The first
``check_steps`` steps, in set-up, go through the window's own step on
distinct batches, and the window goes on with the same state; once it has
closed, their losses, the first gradient as AdamW holds it, each tensor's
change and each BatchNorm running statistic's change are compared with
the reference's steps, on every process (the worst process's numbers
count)."""

import time

import torch

from benchmark import cells, manifest
from benchmark import reference as R


def run(cell, seed, seconds, trace, device, t_start, opts=()):
    layout = manifest.layout(cell.config_path)
    if not hasattr(layout, "train_reference"):
        raise ValueError(f"{cell.config_path}: the {layout.__name__} layout "
                         "has no train reference; the train kind cannot "
                         "check it")
    from msclip_torch.parallel.mesh import mesh_from_config
    from msclip_torch.train.trainer import (
        init_train_state,
        make_train_step_from_config,
    )

    procs = cells.Processes()
    a = manifest.arch(cell.config_path)
    tr = cell.traffic
    if procs.world != tr.get("cards", 1):
        raise ValueError(f"{cell.traffic_name} runs on {tr.get('cards', 1)} "
                         f"process(es), not {procs.world}")
    ring, batch, checked = tr["ring"], tr["batch"], tr["check_steps"]
    rows = slice(procs.rank * batch, (procs.rank + 1) * batch)
    whole = {**tr, "batch": batch * procs.world}  # the global batches
    cfg, spec = cells.port_config(cell.config_path, opts)
    gen = cells.input_generator(seed, device)
    images = cells.make_images(a, whole, gen, device)
    tokens = cells.make_tokens(a, whole, gen, device)
    params = R.draw_params(layout.param_layout(a), seed, device)
    p0 = {k: v.clone() for k, v in params.items()}
    cells.sync(device)
    parts = {"setup_imports_and_draw_s": time.perf_counter() - t_start}
    mesh = mesh_from_config(cfg) if procs.world > 1 else None
    state = init_train_state(cfg, spec, params, tr["steps_per_epoch"],
                             device, mesh)
    del params
    step_fn = make_train_step_from_config(cfg, spec, mesh=mesh)
    cells.sync(device)
    parts["setup_load_s"] = time.perf_counter() - t_start - sum(
        parts.values())
    normalize = cells.normalizer(device)

    def step(slot):
        return step_fn(state, normalize(images[slot][rows]),
                       tokens[slot][rows])

    first_losses, grads = [], None
    for s in range(checked):  # set-up: the checked steps warm up too
        if s == 1:  # the pace: the steps after the first, back to back
            cells.sync(device)
            t0 = time.perf_counter()
        first_losses.append(step(s)["loss"])
        if s == 0:
            grads = cells.leaf_norms(cells.program_first_grads(state))
    cells.sync(device)
    pace = (time.perf_counter() - t0) / (checked - 1)
    changes, stats = cells.changes_of(state.full_params(), p0)
    del p0
    prog = cells.TrainReadings([x.item() for x in first_losses], grads,
                               changes, stats)
    losses = []
    cells.sync(device)
    setup_s = time.perf_counter() - t_start
    parts["setup_checked_steps_s"] = setup_s - sum(parts.values())
    parts["setup_pace_s"] = pace
    window_s, steps, step_s, span = cells.run_window(
        step, lambda i, slot, m: losses.append(m["loss"]), checked % ring,
        ring, seconds, device, trace, tr.get("trace_steps", 0),
        cells.attention_counters(), procs, pace)
    peak = int(procs.worst({"peak": cells.memory_peak(device)},
                           device)["peak"])
    bad = int((~torch.isfinite(torch.stack(losses))).sum().item())
    failed = batch * procs.total(bad, device)
    del state, step_fn, step, losses
    cells.free(device)

    ref = cells.reference_readings(cell, a, images, tokens, seed, device,
                                   rows=rows)
    numbers = procs.worst(cells.train_numbers(prog, ref), device)
    checks = cells.held(numbers, cell.limits)
    info = {k: v for k, v in numbers.items() if k not in cell.limits}
    return cells.Outcome(
        setup_s=setup_s, window_s=window_s, steps=steps,
        items=steps * batch * procs.world, step_s=step_s,
        memory_peak_bytes=peak, attempted=steps * batch * procs.world,
        failed=failed, checks=checks, span=span,
        info={**parts, **info, **cells.step_readings(step_s),
              **cells.train_readings_info(prog, ref)})

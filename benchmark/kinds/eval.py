"""Zero-shot eval: ``load_eval_model`` (BN folded, cast), then each step
``100 * encode_image(normalize(images)) @ classifier.T``; every window
step's logits are kept and compared with the reference's logits of its
batch once the window has closed."""

import time

import torch

from benchmark import cells, manifest
from benchmark import reference as R

KEPT_MARGIN = 1.5  # kept steps over those the warm-up's pace predicts


def load_program_eval(cfg, spec, params, device):
    """The program's ``load_eval_model`` on the benchmark's weights: its
    checkpoint read hands back ``params`` (float32, on the device), and it
    folds, casts and places them as it does a checkpoint's."""
    from msclip_torch.eval import checkpoint_load, zero_shot

    read = checkpoint_load.load_model_params
    checkpoint_load.load_model_params = lambda config, spec: params
    try:
        return zero_shot.load_eval_model(cfg, spec, device)
    finally:
        checkpoint_load.load_model_params = read


def reference_logits(layout, a, images, classifier, seed, device):
    """The reference's logits of every ring slot, float32, by the
    configuration's ``layout`` module."""
    with torch.no_grad(), cells.full_precision():
        params = R.draw_params(layout.param_layout(a), seed, device)
        return torch.stack([layout.zero_shot_logits(params, a, batch,
                                                    classifier)
                            for batch in images])


def run(cell, seed, seconds, trace, device, t_start, opts=()):
    """One eval run. ``opts``: config overrides (the int8 control)."""
    layout = manifest.layout(cell.config_path)
    a = manifest.arch(cell.config_path)
    tr = cell.traffic
    ring, batch = tr["ring"], tr["batch"]
    cfg, spec = cells.port_config(cell.config_path, opts)
    gen = cells.input_generator(seed, device)
    images = cells.make_images(a, tr, gen, device)
    classifier = cells.make_classifier(a, tr, gen, device)
    params = R.draw_params(layout.param_layout(a), seed, device)
    cells.sync(device)
    parts = {"setup_imports_and_draw_s": time.perf_counter() - t_start}
    model = load_program_eval(cfg, spec, params, device)
    del params
    cells.sync(device)
    parts["setup_load_s"] = time.perf_counter() - t_start - sum(
        parts.values())
    normalize = cells.normalizer(device)
    weights = classifier.to(spec.dtype).t()
    kept, slots = [], []

    def step(slot):
        return 100.0 * model.encode_image(normalize(images[slot])) @ weights

    def keep(i, slot, logits):
        kept[i % len(kept)].copy_(logits)
        slots.append(slot)

    with torch.inference_mode():
        for slot in range(ring):  # warm-up: every shape and kernel
            step(slot)
        cells.sync(device)
        t0 = time.perf_counter()
        for slot in range(ring):  # the pace, which sizes the kept logits
            step(slot)
        cells.sync(device)
        pace = (time.perf_counter() - t0) / ring
        cap = int(KEPT_MARGIN * seconds / pace) + ring
        kept = torch.empty(cap, batch, tr["classes"], dtype=spec.dtype,
                           device=device)
        cells.sync(device)
        setup_s = time.perf_counter() - t_start
        parts["setup_warmup_s"] = setup_s - sum(parts.values())
        window_s, steps, step_s, span = cells.run_window(
            step, keep, 0, ring, seconds, device, trace,
            tr.get("trace_steps", 0), cells.attention_counters())
    peak = cells.memory_peak(device)
    del model, step
    cells.free(device)

    ref = reference_logits(layout, a, images, classifier, seed, device)
    with torch.no_grad():
        first = max(0, steps - cap)
        worst = torch.zeros((), device=device)
        worst_row = torch.zeros((), device=device)
        sq = torch.zeros((), dtype=torch.float64, device=device)
        bad = torch.zeros((), dtype=torch.int64, device=device)
        for i in range(first, steps):
            got = kept[i % cap].float()
            d = got - ref[slots[i]]
            worst = torch.maximum(worst, d.abs().amax())
            worst_row = torch.maximum(worst_row,
                                      d.square().mean(dim=-1).amax())
            sq += d.double().square().sum()
            bad += (~torch.isfinite(got)).any(dim=-1).sum()
        n = (steps - first) * batch * tr["classes"]
        rms = (sq / max(n, 1)).sqrt().item()
    numbers = {"logit_rms_gap": rms, "row_rms_gap": worst_row.sqrt().item()}
    info = {"logit_max_gap": worst.item(), "compared_steps": steps - first,
            **cells.step_readings(step_s),
            **{k: v for k, v in numbers.items() if k not in cell.limits}}
    return cells.Outcome(
        setup_s=setup_s, window_s=window_s, steps=steps, items=steps * batch,
        step_s=step_s, memory_peak_bytes=peak, attempted=steps * batch,
        failed=int(bad.item()), checks=cells.held(numbers, cell.limits),
        span=span, info={**parts, **info})

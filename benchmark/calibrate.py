"""The readings that the correctness limits are set from, many seeds in
one process (one a card, under ``torch.distributed.run``, for a cell on
several cards).

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \
        --variant <variant>[,<variant>...] [--seconds 2]

``program``: the cell's own run (a short window), its numbers against the
reference. ``int8``: an eval cell with the program's int8 path
(``TPU.INT8_EVAL``), the control of a bfloat16 configuration. ``fp8``: a
train cell's control, the reference in the program's place with the
operands of every product rounded to float8 e4m3. ``half_batch`` and
``no_exchange``: a train cell's faults (``reference.FAULTS``) planted in
the reference in the program's place. ``rolled`` and ``stale``: an eval
cell's run with each image given its neighbour's answer, or each step
given the previous step's answers. ``image_gap``: an eval cell's
reference logits of one ring slot against the next, all rows and row by
row. One JSON line a seed, from the first process.
"""

import argparse
import json
import os
import statistics
import sys
import time

import torch

from benchmark import cells, manifest
from benchmark import reference as R

VARIANTS = ("program", "int8", "fp8", "half_batch", "no_exchange", "rolled",
            "stale", "image_gap")


def planted(variant):
    """Patches ``MSClipModel.encode_image`` for an eval fault; returns the
    undo."""
    from msclip_torch.models import msclip

    encode = msclip.MSClipModel.encode_image
    last = []

    def rolled(self, images, **kw):
        return encode(self, images, **kw).roll(1, dims=0)

    def stale(self, images, **kw):
        out = encode(self, images, **kw)
        last.append(out)
        return last.pop(0) if len(last) > 1 else out

    msclip.MSClipModel.encode_image = {"rolled": rolled,
                                       "stale": stale}[variant]
    return lambda: setattr(msclip.MSClipModel, "encode_image", encode)


def image_gaps(cell, seed, device):
    from benchmark.kinds import eval as eval_kind

    a = manifest.arch(cell.config_path)
    gen = cells.input_generator(seed, device)
    images = cells.make_images(a, cell.traffic, gen, device)
    classifier = cells.make_classifier(a, cell.traffic, gen, device)
    ref = eval_kind.reference_logits(manifest.layout(cell.config_path), a,
                                     images, classifier, seed, device)
    slot = (ref - ref.roll(1, dims=0)).square()
    row = (ref - ref.roll(1, dims=1)).square().mean(dim=-1).sqrt().flatten()
    return {"slot_rms_gap": slot.mean().sqrt().item(),
            "row_gap_min": row.min().item(),
            "row_gap_median": row.median().item()}, {}


def readings(cell, seed, variant, seconds, device, procs):
    kind = cell.traffic["kind"]
    if variant == "image_gap":
        return image_gaps(cell, seed, device)
    if variant in ("program", "int8", "rolled", "stale"):
        opts = ["TPU.INT8_EVAL", "True"] if variant == "int8" else []
        undo = planted(variant) if variant in ("rolled", "stale") else None
        try:
            out = manifest.kind(kind)(cell, seed, seconds, False, device,
                                      time.perf_counter(), opts)
        finally:
            if undo:
                undo()
        numbers = {k: v for k, (v, _) in out.checks.items()}
        info = {k: v for k, v in out.info.items() if not k.startswith(
            "setup")}
        return {**numbers, **{k: v for k, v in info.items()
                              if isinstance(v, float)}}, info
    a = manifest.arch(cell.config_path)
    batch = cell.traffic["batch"]
    whole = {**cell.traffic, "batch": batch * procs.world}
    rows = slice(procs.rank * batch, (procs.rank + 1) * batch)
    gen = cells.input_generator(seed, device)
    images = cells.make_images(a, whole, gen, device)
    tokens = cells.make_tokens(a, whole, gen, device)
    prec = R.Precision("fp8") if variant == "fp8" else R.FP32
    fault = variant if variant in R.FAULTS else None
    prog = cells.reference_readings(cell, a, images, tokens, seed, device,
                                    prec, fault, rows)
    ref = cells.reference_readings(cell, a, images, tokens, seed, device,
                                   rows=rows)
    numbers = procs.worst(cells.train_numbers(prog, ref), device)
    return numbers, cells.train_readings_info(prog, ref)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variant", default="program")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    device = "cuda"
    if "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        local = int(os.environ["LOCAL_RANK"])
        torch.cuda.set_device(local)
        dist.init_process_group("nccl",
                                device_id=torch.device("cuda", local))
        device = f"cuda:{local}"
    procs = cells.Processes()
    cell = manifest.find_cell(manifest.load_benchmark(), args.workload)
    variants = args.variant.split(",")
    if not set(variants) <= set(VARIANTS):
        p.error(f"variants are {', '.join(VARIANTS)}")
    for variant in variants:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            numbers, info = readings(cell, seed, variant, args.seconds,
                                     device, procs)
            if procs.first:
                print(json.dumps({"cell": cell.name, "variant": variant,
                                  "seed": seed, "readings": numbers,
                                  "info": info,
                                  "seconds": time.perf_counter() - t0}),
                      flush=True)
            cells.free(device)
    if procs.world > 1:
        torch.distributed.destroy_process_group()
    return 0


def summary(lines):
    """Per variant and number, the least and the most over the seeds."""
    out = {}
    for line in lines:
        for k, v in line["readings"].items():
            out.setdefault((line["cell"], line["variant"], k), []).append(v)
    return {f"{c} {var} {k}": (min(v), statistics.median(v), max(v), len(v))
            for (c, var, k), v in out.items()}


if __name__ == "__main__":
    sys.exit(main())

"""One run of one benchmark cell of ``msclip_torch`` on the card(s).

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic, limits and metrics come from
``BENCHMARK.json`` and the files it names (``benchmark/manifest.py``). The
run loads and warms up (``setup_s``), measures for ``--seconds``, checks the
window's outputs against the plain reference, and prints one JSON line as
the last line of standard output: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics from a traced span of the
window, with the device's busy and window seconds and a breakdown. The
numbers compared with the reference, each beside its limit, are the last
lines of standard error and the last key of the JSON line.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):  # run as a file: the checkout's root first
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from benchmark import manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "msclip_tpu")
CACHE_DIR = os.path.join(manifest.ROOT, ".bench_cache")
STARTED_AT = "BENCHMARK_STARTED_AT"  # the launcher's start, wall clock


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def card_power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.split("\n")[0].strip()
        return out or None
    except (OSError, subprocess.TimeoutExpired):
        return None


def read_metrics(metrics, ctx):
    """``{name: {value, unit}}`` of the metrics whose readers find
    something to read."""
    out = {}
    for m in metrics:
        value = manifest.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def launch(cell, argv):
    """A cell on several cards: one process a card under
    ``torch.distributed.run`` (rendezvous on a free port picked at run
    time), each running this module; the first prints the result. Waits
    for all of them."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(cell.chips), "-m", "benchmark.run",
           *argv]
    env = {"OMP_NUM_THREADS": "1", **os.environ,
           STARTED_AT: repr(time.time() - (time.perf_counter() - T_START))}
    return subprocess.run(cmd, cwd=manifest.ROOT, env=env).returncode


def join_group():
    """This process's card and the NCCL group of a launched cell; the
    process's start is the launcher's. Returns ``(device, t_start)``."""
    import torch
    import torch.distributed as dist

    local = int(os.environ["LOCAL_RANK"])
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", device_id=torch.device("cuda", local))
    started = float(os.environ[STARTED_AT])
    return f"cuda:{local}", time.perf_counter() - (time.time() - started)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = manifest.find_cell(manifest.load_benchmark(), args.workload)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    worker = "WORLD_SIZE" in os.environ
    if cell.chips > 1 and not worker:
        return launch(cell, sys.argv[1:] if argv is None else argv)
    device, t_start = join_group() if worker else ("cuda", T_START)

    from benchmark import cells, peaks, tracing

    out = manifest.kind(cell.traffic["kind"])(
        cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    if worker:
        import torch.distributed as dist

        first = dist.get_rank() == 0
        dist.destroy_process_group()
        if not first:
            return 0
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    if args.trace and out.span is None:
        print("benchmark: no traced span kept every record "
              f"({len(cells.TRACE_AT)} tries)", file=sys.stderr)
        return 4

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes,
              "power_limit": card_power_limit()}
    result = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.failed}
    ctx = peaks.Context(kind=cell.traffic["kind"],
                        arch=manifest.arch(cell.config_path),
                        traffic=cell.traffic, chips=cell.chips, outcome=out)
    if args.trace:
        result["metrics"] = read_metrics(cell.per_layer, ctx)
        device["busy_s"] = out.span.busy_s
        device["window_s"] = out.span.window_s
        result["device"] = device
        result["breakdown"] = tracing.breakdown(out.span)
    else:
        result["metrics"] = read_metrics(cell.end_to_end, ctx)
        result["device"] = device
    result["steps"] = out.steps
    result["checks"] = {name: {"value": v, "limit": limit}
                        for name, (v, limit) in out.checks.items()}
    for name, v in out.info.items():
        if isinstance(v, (float, list)):
            print(f"reading {name} {v!r} (not compared)", file=sys.stderr)
    for name, (v, limit) in out.checks.items():
        print(f"check {name} {v!r} limit {limit!r} "
              f"{'ok' if v <= limit else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

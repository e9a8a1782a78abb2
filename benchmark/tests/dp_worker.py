"""One process of a data-parallel train run at the small size on the CPU
(gloo), for ``test_bench_data_parallel.py``.

    python -m benchmark.tests.dp_worker <mode> <port> <rank> <world>

``mode``: ``sound``, a program fault (``no_exchange``, ``half_batch``,
``unchanged``, ``frozen_stats``) planted under the train step, or
``reference``: the reference's step over the processes against one
process's step over the whole global batch. The first process prints one
JSON line.
"""

import json
import sys
import time

import torch
import torch.distributed as dist

from benchmark import cells, manifest
from benchmark.kinds import train as train_kind
from benchmark.tests import helpers


def plant(mode):
    from msclip_torch.parallel import infonce
    from msclip_torch.train import optim, trainer

    if mode == "no_exchange":  # the gradients' all-reduce left out
        optim.DataShards.reduce_grads = lambda self: None
    elif mode == "half_batch":
        loss = infonce.infonce_loss

        def half(fi, ft, scale, label_smoothing=0.0):
            h = fi.shape[0] // 2
            return loss(fi[:h], ft[:h], scale, label_smoothing)

        infonce.infonce_loss = half
    elif mode == "unchanged":
        make = trainer.make_train_step_from_config

        def unchanged(*args, **kw):
            step = make(*args, **kw)

            def run(state, images, tokens):
                saved = {k: v.detach().clone()
                         for k, v in state.model.params().items()}
                out = step(state, images, tokens)
                with torch.no_grad():
                    for k, v in state.model.params().items():
                        v.copy_(saved[k])
                return out

            return run

        trainer.make_train_step_from_config = unchanged
    elif mode == "frozen_stats":
        trainer.apply_bn_updates = lambda params, updates: None


def readings(cell, seed, rows=None):
    a = manifest.arch(cell.config_path)
    world = dist.get_world_size() if dist.is_initialized() else 1
    whole = {**cell.traffic, "batch": cell.traffic["batch"] * world}
    gen = cells.input_generator(seed, "cpu")
    images = cells.make_images(a, whole, gen, "cpu")
    tokens = cells.make_tokens(a, whole, gen, "cpu")
    return cells.reference_readings(cell, a, images, tokens, seed, "cpu",
                                    rows=rows)


def rel(a, b, keep=None):
    """The worst leaf's gap (``cells.leaf_gaps``) of those in ``keep``."""
    return max(cells.leaf_gaps(a, b, keep or list(b)).values())


def main(mode, port, rank, world):
    torch.set_num_threads(2)
    cell = helpers.train_cell(cards=world)
    single = None
    if mode == "reference" and rank == 0:
        one = helpers.train_cell()  # the same global batch, one process
        single = readings(one, helpers.SEED)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    if mode == "reference":
        batch = cell.traffic["batch"]
        many = readings(cell, helpers.SEED,
                        slice(rank * batch, (rank + 1) * batch))
        result = single and {
            "loss": rel(dict(enumerate(many.losses)),
                        dict(enumerate(single.losses))),
            "grads": rel(many.grads, single.grads),
            "changes": rel(many.changes, single.changes,
                           cells.moving(single)),
            "stats": rel(many.stats, single.stats)}
    else:
        if mode != "sound":
            plant(mode)
        out = train_kind.run(cell, helpers.SEED, 0.2, False, "cpu",
                             time.perf_counter())
        result = {"correct": out.correct, "steps": out.steps,
                  "items": out.items,
                  "checks": {k: v for k, (v, _) in out.checks.items()}}
    if rank == 0:
        print(json.dumps(result), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))

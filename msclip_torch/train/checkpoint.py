"""Training checkpoints with auto-resume, the port of
``msclip_tpu/train/checkpoint.py`` in a format of the port's own (Orbax
needs JAX).

A checkpoint is one directory a step, ``<directory>/<step>/``, holding
``state.pt`` (read by ``torch.load(weights_only=True)``: the model's
tensors by reference key, the optimizer's state by parameter name, and the
EMA/SWA shadows when given) and ``extra.json`` (the epoch, the SWA count).
Each is written to a temporary directory beside it and moved into place
with ``os.replace``, so a process killed mid-save leaves the last finished
checkpoint and never a partial one. ``save_params`` writes a params-only
directory (``params.pt``; the ``checkpoints/{ema,swa}`` shadows), which
``eval/checkpoint_load.py`` reads like a step directory.

Several processes share one checkpoint directory: the caller gathers the
whole state on every process (``DataShards.full_optimizer_state``, the
whole parameters), rank 0 writes it in the one-process format, and every
process waits at a barrier until the directory swap is done; each process
restores the whole state and cuts its own splits from it
(:func:`auto_resume`), and under tensor parallelism its part of each
split tensor. So a ZeRO-1, FSDP or tensor-parallel run resumes in one
process and the other way round.

A JAX-trained checkpoint reaches the port as a reference ``.pth`` through
``msclip_tpu.utils.export_torch_state_dict``.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Optional

import torch

from ..parallel.mesh import split_for_model
from ..utils.comm import comm

STATE_FILE = "state.pt"
EXTRA_FILE = "extra.json"
PARAMS_FILE = "params.pt"


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def _replace_dir(tmp: str, final: str) -> None:
    """Move the finished ``tmp`` to ``final``, replacing a directory there
    (moved aside to ``<final>.old-<pid>`` first, then removed; a process
    killed between the two moves leaves only the ``.old-`` copy, which
    :func:`_clear_leftovers` moves back)."""
    old = None
    if os.path.exists(final):
        old = f"{final}.old-{os.getpid()}"
        os.replace(final, old)
    os.replace(tmp, final)
    if old:
        shutil.rmtree(old)


def _clear_leftovers(directory: str) -> None:
    """Undo a killed save in ``directory``: remove its staging directories
    (``.tmp-*``), and move an ``<name>.old-<pid>`` copy back to ``<name>``
    when the replacement never arrived (else remove it)."""
    for d in os.listdir(directory):
        path = os.path.join(directory, d)
        if d.startswith(".tmp-"):
            shutil.rmtree(path)
        elif ".old-" in d:
            final = os.path.join(directory, d.split(".old-")[0])
            if os.path.exists(final):
                shutil.rmtree(path)
            else:
                os.replace(path, final)


def optimizer_state_by_name(optimizer, names) -> dict:
    """``{name: {"step", "exp_avg", ...}}`` of ``optimizer.state``, keyed
    by ``names[id(param)]`` instead of by position."""
    return {names[id(p)]: dict(s) for p, s in optimizer.state.items()
            if id(p) in names}


def load_optimizer_state(optimizer, state: dict, params_by_name) -> None:
    """Put :func:`optimizer_state_by_name`'s ``state`` back: each moment
    onto its parameter's device and dtype, ``step`` as saved (torch keeps
    it on the CPU)."""
    for name, s in state.items():
        p = params_by_name[name]
        optimizer.state[p] = {
            k: v if k == "step" or not isinstance(v, torch.Tensor)
            else v.to(p.device, p.dtype) for k, v in s.items()}


def restore_schedule(scheduler, step: int) -> None:
    """Set a ``LambdaLR`` to the LR of step ``step`` (the count of steps
    already taken): each group's LR is its lambda at ``step``."""
    scheduler.last_epoch = step
    for group, fn in zip(scheduler.optimizer.param_groups,
                         scheduler.lr_lambdas):
        group["lr"] = group["initial_lr"] * fn(step)
    scheduler._last_lr = [g["lr"] for g in scheduler.optimizer.param_groups]


class CheckpointManager:
    """Save and restore ``{params, optimizer, shadows, extra}`` a step,
    keeping the newest ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        if comm.is_main_process():
            os.makedirs(self.directory, exist_ok=True)
            _clear_leftovers(self.directory)
        comm.synchronize()

    def all_steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, EXTRA_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, params, optimizer_state=None,
             extra: Optional[dict] = None, force: bool = False,
             shadows: Optional[dict] = None) -> None:
        """``force=True`` replaces a checkpoint already at ``step`` (the
        epoch-end save when ``TRAIN.SAVE_EVERY_STEPS`` lands on the
        epoch's last step: its metadata must win, so that a resume starts
        the next epoch); without it, an existing step raises.
        ``shadows``: ``{"ema": dict or None, "swa": dict or None}``.
        Every process calls it with the whole state; rank 0 writes, the
        others wait for it."""
        if comm.is_main_process():
            self._write(step, params, optimizer_state, extra, force,
                        shadows)
        comm.synchronize()

    def _write(self, step, params, optimizer_state, extra, force, shadows):
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final) and not force:
            raise FileExistsError(f"checkpoint at step {step} exists: "
                                  f"{final}")
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"params": _cpu(params),
                    "optimizer": _cpu(optimizer_state or {}),
                    "shadows": {k: _cpu(v) for k, v in (shadows or {}).items()
                                if v is not None}},
                   os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, EXTRA_FILE), "w") as f:
            json.dump(extra or {}, f)
        _replace_dir(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, step: Optional[int] = None) -> Optional[dict]:
        """``{"params", "optimizer", "shadows", "extra", "step"}`` of
        ``step`` (the latest when None), tensors on the CPU; None when no
        checkpoint exists."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.directory, str(step))
        out = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                         weights_only=True)
        with open(os.path.join(path, EXTRA_FILE)) as f:
            out["extra"] = json.load(f)
        out["step"] = step
        return out


def save_params(path: str, params) -> None:
    """A params-only checkpoint (model export; the EMA/SWA shadows), staged
    as ``.tmp-<name>-<pid>`` beside ``path``, a name the manager's cleanup
    takes. One process writes: the train loop calls it on rank 0."""
    path = os.path.abspath(path)
    tmp = os.path.join(os.path.dirname(path),
                       f".tmp-{os.path.basename(path)}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(_cpu(params), os.path.join(tmp, PARAMS_FILE))
    _replace_dir(tmp, path)


def restore_params(path: str) -> dict:
    """The reference-layout tensors of a :func:`save_params` directory or
    of a :class:`CheckpointManager` step directory, on the CPU."""
    if os.path.exists(os.path.join(path, PARAMS_FILE)):
        return torch.load(os.path.join(path, PARAMS_FILE),
                          map_location="cpu", weights_only=True)
    if os.path.exists(os.path.join(path, STATE_FILE)):
        return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                          weights_only=True)["params"]
    raise FileNotFoundError(f"{path}: neither a params directory "
                            f"({PARAMS_FILE}) nor a checkpoint step "
                            f"({STATE_FILE})")


def auto_resume(manager: CheckpointManager, state):
    """``TRAIN.AUTO_RESUME`` (``lib/utils/utils.py:117-127``): load the
    latest checkpoint into ``state`` (a ``TrainState``: the model's
    tensors, the optimizer's moments and step counts by parameter name,
    the schedule and the step count) if there is one. Returns ``(step,
    extra)``, ``(0, {})`` without a checkpoint; the restored shadows, on
    the model's device, come back under ``extra["shadows"]``. Every
    process of a run calls it and reads the same whole checkpoint; the
    splits of ``state.shards`` are cut from it, whatever split the run
    that wrote it had."""
    step = manager.latest_step()
    if step is None:
        return 0, {}
    ck = manager.restore(step)
    params = state.full_params()
    with torch.no_grad():
        for k, v in split_for_model(ck["params"], state.mesh).items():
            params[k].copy_(v)
    state.shards.resplit()
    load_optimizer_state(state.optimizer,
                         state.shards.split_optimizer_state(ck["optimizer"]),
                         state.shards.opt_params())
    state.shards.release()
    restore_schedule(state.scheduler, step)
    state.step = step
    logging.info(f"=> auto-resumed from step {step}")
    extra = dict(ck["extra"])
    device = params["logit_scale"].device
    if ck["shadows"]:
        extra["shadows"] = {
            name: {k: v.to(device) for k, v in
                   split_for_model(tree, state.mesh).items()}
            for name, tree in ck["shadows"].items()}
    return step, extra

"""Checkpoints, auto-resume and the train CLI on real data, on the CPU:
the checkpoint round trip (model, optimizer moments by name, schedule,
shadows), force-replace, ``max_to_keep``, a killed save, a SIGKILLed run
that resumes to the uninterrupted run's loss trace (after
``tests/test_preemption.py``), the CLI on tar shards, a TSV list and a
caption folder, and native checkpoints in the eval and export tools."""

import json
import math
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from msclip_torch.config import get_default_config, update_config
from msclip_torch.eval.checkpoint_load import load_model_params
from msclip_torch.models import msclip as TM
from msclip_torch.train import checkpoint as C
from msclip_torch.train import trainer as TT
from msclip_torch.utils.convert import load_state_dict

from test_torch_train import _batch, _tiny_cli_config
from torch_pair_fixtures import write_folder, write_shards, write_tsv
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one thread a run: runs started together do not fight over the cores,
# and a single-threaded CPU run sums in one order, so two runs agree bit
# for bit
ENV = dict(os.environ, OMP_NUM_THREADS="1")


def _config(tmp_path, *opts):
    cfg = get_default_config()
    update_config(cfg, _tiny_cli_config(tmp_path), opts=list(opts))
    return cfg


def _state(cfg, seed=0):
    spec = TM.build_spec(cfg)
    params = TM.init_params(spec, torch.Generator().manual_seed(seed))
    return spec, TT.init_train_state(cfg, spec, params, 4, "cpu")


def _names(state):
    return {id(p): k for k, p in state.model.named_parameters()}


def _run_steps(state, spec, n, seed=0):
    step = TT.make_train_step(spec)
    return [step(state, *(torch.from_numpy(a) for a in _batch(
        image=64, vocab=512, seed=seed + i)))["loss"].item()
        for i in range(n)]


def test_checkpoint_round_trip_resumes_exactly(tmp_path):
    """Two steps, a save, a fresh state auto-resumed from it: the same
    tensors, moments, step counts and LR, and the next two steps equal the
    uninterrupted run's bit for bit; the EMA shadow comes back."""
    cfg = _config(tmp_path, "TRAIN.EMA_DECAY", "0.9")
    spec, state = _state(cfg)
    _run_steps(state, spec, 2)
    mgr = C.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state.step, state.model.params(),
             C.optimizer_state_by_name(state.optimizer, _names(state)),
             extra={"epoch": 0, "swa_n": 0},
             shadows={"ema": state.ema, "swa": None})
    assert mgr.all_steps() == [2] and mgr.latest_step() == 2
    spec, resumed = _state(cfg, seed=1)  # other weights: all overwritten
    step, extra = C.auto_resume(C.CheckpointManager(str(tmp_path / "ck")),
                                resumed)
    assert step == resumed.step == 2 and extra["epoch"] == 0
    assert set(extra["shadows"]) == {"ema"}
    for k, v in state.model.params().items():
        assert torch.equal(resumed.model.params()[k], v), k
        assert torch.equal(extra["shadows"]["ema"][k], state.ema[k]), k
    for g, h in zip(state.optimizer.param_groups,
                    resumed.optimizer.param_groups):
        assert g["lr"] == h["lr"] and g["name"] == h["name"]
    ours = _run_steps(state, spec, 2, seed=5)
    theirs = _run_steps(resumed, spec, 2, seed=5)
    assert ours == theirs
    for k, v in state.model.params().items():
        assert torch.equal(resumed.model.params()[k], v), k


def test_checkpoint_force_replace_max_to_keep_and_killed_saves(tmp_path):
    mgr = C.CheckpointManager(str(tmp_path), max_to_keep=2)
    p = {"w": torch.arange(3.0)}
    mgr.save(1, p, extra={"epoch": 0})
    with pytest.raises(FileExistsError):
        mgr.save(1, p, extra={"epoch": 0})
    mgr.save(1, {"w": torch.ones(3)}, extra={"epoch": 1}, force=True)
    restored = mgr.restore(1)
    assert restored["extra"] == {"epoch": 1}
    assert torch.equal(restored["params"]["w"], torch.ones(3))
    assert restored["shadows"] == {} and restored["optimizer"] == {}
    mgr.save(2, p, extra={}, shadows={"swa": p, "ema": None})
    mgr.save(3, p, extra={})
    assert mgr.all_steps() == [2, 3]
    assert set(mgr.restore(2)["shadows"]) == {"swa"}
    # a save killed before its rename leaves a temporary directory and a
    # step directory without metadata: neither counts, and a new manager
    # clears the leftovers
    os.makedirs(tmp_path / ".tmp-4-123")
    os.makedirs(tmp_path / "5")
    mgr = C.CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() == 3
    assert not (tmp_path / ".tmp-4-123").exists()
    assert C.CheckpointManager(str(tmp_path / "empty")).restore() is None


class _Killed(BaseException):
    pass


@pytest.mark.parametrize("kind", ["step", "shadow"])
def test_a_save_killed_between_its_moves_keeps_the_last_checkpoint(
        tmp_path, monkeypatch, kind):
    """A force-replacing save (a step) or a shadow save killed after the
    old copy was moved aside and before the new one was moved in: a new
    manager moves the old copy back and clears the staging directory."""
    old, new = {"w": torch.arange(3.0)}, {"w": torch.ones(3)}
    mgr = C.CheckpointManager(str(tmp_path))

    def save(params):
        if kind == "step":
            mgr.save(1, params, extra={"epoch": 0}, force=True)
        else:
            C.save_params(str(tmp_path / "ema"), params)

    save(old)
    real, calls = os.replace, []

    def replace(src, dst):
        calls.append(src)
        if len(calls) == 2:  # the move of the finished copy into place
            raise _Killed
        real(src, dst)

    monkeypatch.setattr(C.os, "replace", replace)
    with pytest.raises(_Killed):
        save(new)
    monkeypatch.setattr(C.os, "replace", real)
    left = sorted(os.listdir(tmp_path))
    assert len(left) == 2 and any(".old-" in d for d in left)
    assert any(d.startswith(".tmp-") for d in left), left
    mgr = C.CheckpointManager(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == (["1"] if kind == "step"
                                            else ["ema"])
    got = (mgr.restore()["params"] if kind == "step"
           else C.restore_params(str(tmp_path / "ema")))
    assert torch.equal(got["w"], old["w"])


def test_native_checkpoints_load_for_eval_and_export(tmp_path):
    """A step directory and a params directory (the EMA/SWA shadows) load
    through ``checkpoint_load``; ``export_torch_checkpoint --ckpt <dir>``
    writes the reference ``state_dict``, which loads back to the same
    tensors."""
    cfg = _config(tmp_path)
    spec, state = _state(cfg)
    _run_steps(state, spec, 1)
    want = {k: v.detach() for k, v in state.model.params().items()}
    mgr = C.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, want, extra={})
    C.save_params(str(tmp_path / "ck" / "ema"), want)
    model_json = _tiny_cli_config(tmp_path)
    for path in (tmp_path / "ck" / "1", tmp_path / "ck" / "ema"):
        cfg.MODEL.PRETRAINED_MODEL = str(path)
        got = load_model_params(cfg, spec)
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    out = tmp_path / "exported.pth"
    r = subprocess.run(
        [sys.executable, "-m", "msclip_torch.tools.export_torch_checkpoint",
         "--model", model_json, "--ckpt", str(tmp_path / "ck" / "ema"),
         "--out", str(out), "--device", "cpu"],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    sd = torch.load(out, weights_only=True)
    back = load_state_dict(sd, spec, {k: v.shape for k, v in want.items()})
    assert all(torch.equal(back[k], want[k]) for k in want)
    cfg.MODEL.PRETRAINED_MODEL = str(tmp_path / "ck")  # not a checkpoint
    with pytest.raises(FileNotFoundError):
        load_model_params(cfg, spec)


RESUME_OPTS = ["DATASET.NUM_SAMPLES", "24", "TRAIN.END_EPOCH", "2",
               "TRAIN.SAVE_EVERY_STEPS", "2", "TRAIN.EMA_DECAY", "0.9",
               "SWA.ENABLED", "True", "SWA.BEGIN_EPOCH", "1",
               "MODEL.SPEC.VISION.DROP_PATH", "0.2"]
RESUME_STEPS = 12  # 6 a epoch at batch 4


def _train_cmd(cfg_path, out_dir):
    return [sys.executable, "-u", "-m", "msclip_torch.tools.train", "--cfg",
            cfg_path, "--device", "cpu", "OUTPUT_DIR", str(out_dir),
            *RESUME_OPTS]


def _result(stdout):
    line = [ln for ln in stdout.splitlines() if ln.startswith("RESULT")][-1]
    fields = dict(kv.split("=", 1) for kv in line.split()[1:])
    return int(fields["first_step"]), json.loads(fields["losses"])


def _checkpoints(out_dir):
    for root, dirs, _ in os.walk(out_dir):
        if "checkpoints" in dirs:
            return os.path.join(root, "checkpoints")
    return None


def test_kill_and_resume_matches_the_uninterrupted_run(tmp_path):
    """A run SIGKILLed once a mid-epoch checkpoint exists, then rerun:
    it resumes from a finished checkpoint, fast-forwards the loader,
    finishes at the full step count, and its losses, weights and EMA/SWA
    shadows equal the uninterrupted run's (drop path on)."""
    cfg_path = _tiny_cli_config(tmp_path)
    full = subprocess.Popen(_train_cmd(cfg_path, tmp_path / "full"),
                            cwd=REPO, env=ENV, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    killed = subprocess.Popen(_train_cmd(cfg_path, tmp_path / "run"),
                              cwd=REPO, env=ENV, text=True,
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
    deadline = time.time() + 300
    while True:  # (a manager here would clear the run's save in flight)
        ck = _checkpoints(tmp_path / "run")
        if ck and any(os.path.exists(os.path.join(ck, s, C.EXTRA_FILE))
                      for s in ("2", "4")):
            killed.send_signal(signal.SIGKILL)
            break
        assert killed.poll() is None and time.time() < deadline
        time.sleep(0.02)
    killed.wait(timeout=60)
    saved = C.CheckpointManager(ck).latest_step()
    assert saved in (2, 4)
    r = subprocess.run(_train_cmd(cfg_path, tmp_path / "run"), cwd=REPO,
                       env=ENV, text=True, capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    m = re.search(r"auto-resumed from step (\d+)", r.stderr)
    assert m and int(m.group(1)) == saved, r.stderr[-3000:]
    m = re.search(r"skipping (\d+) already-seen batches", r.stderr)
    assert m and int(m.group(1)) == saved % 6
    first, losses = _result(r.stdout)
    out, err = full.communicate(timeout=300)
    assert full.returncode == 0, err[-3000:]
    first_full, losses_full = _result(out)
    assert first == saved and first_full == 0
    assert len(losses_full) == RESUME_STEPS
    assert losses == losses_full[saved:]
    assert "training complete" in r.stderr
    ck_full = _checkpoints(tmp_path / "full")
    for mgr in (C.CheckpointManager(ck), C.CheckpointManager(ck_full)):
        assert mgr.latest_step() == RESUME_STEPS
        assert mgr.restore()["extra"]["epoch"] == 2
    a, b = (C.CheckpointManager(d).restore() for d in (ck, ck_full))
    for name in ("params", "shadows"):
        flat = [(k, v) for k, v in a[name].items()] if name == "params" \
            else [(f"{s}.{k}", v) for s in a[name] for k, v in
                  a[name][s].items()]
        other = b[name] if name == "params" else {
            f"{s}.{k}": v for s in b[name] for k, v in b[name][s].items()}
        assert len(flat) == len(other) > 0
        for k, v in flat:
            assert torch.equal(v, other[k]), k
    for shadow in ("ema", "swa"):  # the SWA one after its BN refresh
        x, y = (C.restore_params(os.path.join(d, shadow))
                for d in (ck, ck_full))
        assert all(torch.equal(x[k], y[k]) for k in x)


def test_train_cli_trains_on_shards_tsv_and_folders(tmp_path):
    """``python -m msclip_torch.tools.train --device cpu`` from a tar-shard
    list (``chunk`` sampler), a TSV list and a caption folder."""
    cfg_path = _tiny_cli_config(tmp_path)
    shards = write_shards(str(tmp_path / "shards"), 2, 4, seed=1)
    tsv = write_tsv(str(tmp_path / "tsv"), 8, seed=2)
    write_folder(str(tmp_path / "root" / "train"), 8, seed=3)
    runs = {
        "shards": ["DATASET.TRAIN_SHARD_LIST", json.dumps(shards),
                   "DATASET.SAMPLER", "chunk"],
        "tsv": ["DATASET.TRAIN_TSV_LIST", json.dumps([tsv])],
        "folder": ["DATASET.DATASET", "yfcc", "DATASET.ROOT",
                   str(tmp_path / "root")]}
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "msclip_torch.tools.train", "--cfg", cfg_path,
         "--device", "cpu", "OUTPUT_DIR", str(tmp_path / name),
         "MODEL.SPEC.TEXT.VOCAB_SIZE", "49408", *opts],
        cwd=REPO, env=ENV, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
        for name, opts in runs.items()}
    for name, p in procs.items():
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, (name, err[-3000:])
        first, losses = _result(out)
        assert first == 0 and len(losses) == 2, name
        assert all(math.isfinite(x) for x in losses), name
        assert _checkpoints(tmp_path / name), name
    assert np.isfinite(losses).all()


def test_frozen_bn_epochs_and_anomaly_mode(tmp_path):
    """``SWA.FROZEN_BN`` from epoch 1: BN statistics move in epoch 0 and
    stay through epoch 1, and no refresh runs at the end (the SWA shadow
    keeps the statistics it averaged); ``TRAIN.DETECT_ANOMALY`` turns on
    autograd's anomaly mode."""
    from msclip_torch.tools.train import train

    cfg = _config(tmp_path, "DATASET.NUM_SAMPLES", "8", "TRAIN.END_EPOCH",
                  "2", "SWA.ENABLED", "True", "SWA.BEGIN_EPOCH", "1",
                  "SWA.FROZEN_BN", "True", "TRAIN.DETECT_ANOMALY", "True")
    try:
        state, stats = train(cfg, device="cpu", out_dir=str(tmp_path / "o"))
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    mgr = C.CheckpointManager(str(tmp_path / "o" / "checkpoints"))
    assert mgr.all_steps() == [2, 4] and stats["steps"] == 4
    after0, after1 = (mgr.restore(s)["params"] for s in (2, 4))
    init = TM.init_params(TM.build_spec(cfg), torch.Generator().manual_seed(
        cfg.TPU.SEED))
    stats_keys = [k for k in after0 if k.endswith(".running_mean")]
    assert stats_keys
    assert any(not torch.equal(after0[k], init[k]) for k in stats_keys)
    assert all(torch.equal(after1[k], after0[k]) for k in stats_keys)
    swa = C.restore_params(str(tmp_path / "o" / "checkpoints" / "swa"))
    assert all(torch.equal(swa[k], after1[k]) for k in stats_keys)


def test_train_refuses_the_unported_trace_hook(tmp_path, monkeypatch):
    from msclip_torch.tools.train import train

    monkeypatch.setenv("MSCLIP_TRACE", str(tmp_path / "trace"))
    with pytest.raises(NotImplementedError, match="ROADMAP M13"):
        train(_config(tmp_path), device="cpu")
    assert not (tmp_path / "trace").exists()

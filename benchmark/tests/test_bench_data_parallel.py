"""The train kind over four processes (gloo, the CPU, the small size):
the reference's step over the processes equals one process's step over
the whole global batch, a sound run is correct, and each fault of a step
across cards, planted in the program, makes ``correct`` false."""

import json
import os
import socket
import subprocess
import sys

import pytest

from benchmark import manifest

WORLD = 4


def run_group(mode):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "benchmark.tests.dp_worker", mode, str(port),
         str(rank), str(WORLD)], cwd=manifest.ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(WORLD)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


def test_the_reference_over_processes_is_the_whole_batch_step():
    gaps = run_group("reference")
    assert gaps["loss"] < 1e-5
    assert gaps["grads"] < 1e-3
    assert gaps["changes"] < 5e-3  # Adam: round-off of small gradients
    assert gaps["stats"] < 1e-4


def test_a_sound_run_over_processes_is_correct():
    out = run_group("sound")
    assert out["correct"], out
    assert out["items"] == out["steps"] * 16


@pytest.mark.parametrize("fault", ["no_exchange", "half_batch", "unchanged",
                                   "frozen_stats"])
def test_a_fault_across_processes_fails(fault):
    out = run_group(fault)
    assert not out["correct"], out

"""The command without a card, and what a run imports."""

import os
import subprocess
import sys

import pytest

from benchmark import manifest, peaks, run

ROOT = manifest.ROOT
PROBE = """
import sys, time
import benchmark.run
from benchmark.kinds import eval as eval_kind
from benchmark.kinds import train as train_kind
from benchmark.tests import helpers
eval_kind.run(helpers.eval_cell(), 1, 0.1, False, "cpu", time.perf_counter())
train_kind.run(helpers.train_cell(), 1, 0.1, False, "cpu",
                 time.perf_counter())
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")


def env():
    return {**os.environ, "OMP_NUM_THREADS": "4"}


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load_benchmark()["workloads"]])
def test_without_a_card_the_run_fails_and_prints_no_result(no_card, cell):
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        cell, "--seed", str(2 ** 31 + 5), "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, env=env(), timeout=300)
    assert r.returncode != 0
    assert "{" not in r.stdout


def test_a_cell_never_falls_back_to_the_cpu(no_card):
    from benchmark.kinds import eval as eval_kind

    with pytest.raises((RuntimeError, AssertionError)):
        eval_kind.run(manifest.find_cell(manifest.load_benchmark(),
                                           "b32.eval.bs256"),
                        1, 1.0, False, "cuda", 0.0)


def test_the_cells_import_neither_jax_nor_the_jax_package():
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                       capture_output=True, text=True, env=env(),
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    loaded = set(r.stdout.split())
    assert "msclip_torch" in loaded and "benchmark" in loaded
    assert not loaded & set(run.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "msclip_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", sys)
    assert not {"msclip_torch", "msclip_torch_probe", "jaxtyping_probe"} \
        & set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "msclip_tpu.probe", sys)
    assert "msclip_tpu" in run.forbidden_modules()


def test_percentile_is_the_linear_one():
    assert peaks.percentile(list(range(101)), 90) == 90
    assert peaks.percentile([1.0, 2.0], 90) == pytest.approx(1.9)

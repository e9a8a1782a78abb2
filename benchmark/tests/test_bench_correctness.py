"""``correct`` comes out false for the control and for each fault a cell
can have, the run driven on the CPU at the small size (``helpers.py``)
with the timed path broken underneath: an answer altered where it is
produced (eval), a step that returns its state unchanged, running
statistics left unchanged and a loss over half of the batch (train); the
int8 path of the program and the float8 reference fail the limits too.
On the card (``gpu``), at the cells' own size, the controls fail the
cells' limits, and so do wrong answers in the eval cells and, on four
cards, the exchange between the cards left out. The faults of a step
across processes on the CPU: ``test_bench_data_parallel.py``."""

import time

import pytest
import torch

from benchmark import cells, manifest
from benchmark.kinds import eval as eval_kind
from benchmark.kinds import train as train_kind
from benchmark import reference as R
from benchmark.tests import helpers

SEED = helpers.SEED


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(saved)


def eval_run(opts=()):
    return eval_kind.run(helpers.eval_cell(), SEED, 0.2, False, "cpu",
                           time.perf_counter(), opts)


def train_run():
    return train_kind.run(helpers.train_cell(), SEED, 0.2, False, "cpu",
                            time.perf_counter())


def test_sound_runs_are_correct():
    assert eval_run().correct
    assert train_run().correct


def test_an_altered_answer_fails(monkeypatch):
    from msclip_torch.models import msclip

    encode = msclip.MSClipModel.encode_image

    def swapped(self, images, **kw):
        feats = encode(self, images, **kw)
        return torch.cat([feats[1:2], feats[1:]])  # image 0 gets 1's answer

    monkeypatch.setattr(msclip.MSClipModel, "encode_image", swapped)
    assert not eval_run().correct


def test_the_int8_control_fails():
    assert not eval_run(["TPU.INT8_EVAL", "True"]).correct


def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch):
    from msclip_torch.train import trainer

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

    monkeypatch.setattr(trainer, "make_train_step_from_config", unchanged)
    out = train_run()
    assert out.checks["change_gap"][0] == pytest.approx(1.0)
    assert not out.correct


def test_running_statistics_left_unchanged_fail(monkeypatch):
    from msclip_torch.train import trainer

    monkeypatch.setattr(trainer, "apply_bn_updates",
                        lambda params, updates: None)
    out = train_run()
    assert out.checks["bn_stat_gap"][0] == pytest.approx(1.0)
    assert not out.correct


def test_a_loss_over_half_the_batch_fails(monkeypatch):
    from msclip_torch.parallel import infonce

    loss = infonce.infonce_loss

    def half(fi, ft, scale, label_smoothing=0.0):
        h = fi.shape[0] // 2
        return loss(fi[:h], ft[:h], scale, label_smoothing)

    monkeypatch.setattr(infonce, "infonce_loss", half)
    assert not train_run().correct


def control_numbers(cell, seed, device, **kw):
    a = manifest.arch(cell.config_path)
    gen = cells.input_generator(seed, device)
    images = cells.make_images(a, cell.traffic, gen, device)
    tokens = cells.make_tokens(a, cell.traffic, gen, device)
    ref = cells.reference_readings(cell, a, images, tokens, seed, device)
    prog = cells.reference_readings(cell, a, images, tokens, seed, device,
                                    **kw)
    return cells.held(cells.train_numbers(prog, ref), cell.limits)


def fails(checks):
    return any(v > limit for v, limit in checks.values())


def test_the_float8_reference_fails():
    assert fails(control_numbers(helpers.train_cell(), SEED, "cpu",
                                 prec=R.Precision("fp8")))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")


CARD_SEEDS = [2300001001, 2300002003, 2300003005]


def one_card_cells():
    bench = manifest.load_benchmark()
    return [manifest.find_cell(bench, w["name"]) for w in bench["workloads"]
            if w["chips"] == 1]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", CARD_SEEDS)
def test_the_controls_fail_the_cells_on_the_card(card, seed):
    for cell in one_card_cells():
        if cell.traffic["kind"] == "eval":
            out = eval_kind.run(cell, seed, 1.0, False, "cuda",
                                time.perf_counter(),
                                ["TPU.INT8_EVAL", "True"])
            assert not out.correct, cell.name
        else:
            assert fails(control_numbers(cell, seed, "cuda",
                                         prec=R.Precision("fp8"))), cell.name


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["rolled", "stale"])
def test_wrong_answers_fail_the_eval_cells_on_the_card(card, fault):
    """Each image given its neighbour's answer, or each step the previous
    step's answers, at the cells' own size."""
    from benchmark import calibrate

    for cell in one_card_cells():
        if cell.traffic["kind"] != "eval":
            continue
        undo = calibrate.planted(fault)
        try:
            out = eval_kind.run(cell, CARD_SEEDS[0], 1.0, False, "cuda",
                                time.perf_counter())
        finally:
            undo()
        assert not out.correct, cell.name


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["fp8", "no_exchange"])
def test_the_control_and_the_lost_exchange_fail_on_four_cards(four_cards,
                                                               variant):
    """The four-card cell's control and its fault of an exchange left out
    (each in the reference, in the program's place), on three seeds."""
    import json
    import subprocess
    import sys

    bench = manifest.load_benchmark()
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    if not four:
        pytest.skip("BENCHMARK.json names no four-card cell")
    for w in four:
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "4", "-m", "benchmark.calibrate",
             "--workload", w["name"], "--variant", variant, "--seeds",
             ",".join(map(str, CARD_SEEDS))], cwd=manifest.ROOT,
            capture_output=True, text=True, timeout=1800)
        assert r.returncode == 0, r.stderr[-3000:]
        cell = manifest.find_cell(bench, w["name"])
        lines = [json.loads(x) for x in r.stdout.splitlines()
                 if x.startswith("{")]
        assert len(lines) == len(CARD_SEEDS)
        for line in lines:
            assert fails(cells.held(line["readings"], cell.limits)), line

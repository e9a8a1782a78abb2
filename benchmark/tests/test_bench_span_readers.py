"""The readers of the program's spans: each returns the device
milliseconds a step under its span, and nothing in a cell of the other
kind or in a trace without its span (the parent of the spans, say)."""

import pytest

from benchmark import cells, manifest, peaks, tracing
from benchmark import reference as R
from benchmark.tests import helpers

STEPS = 4
OPS = {
    "msclip.attention.fwd": 0.002,
    "msclip.attention.bwd": 0.006,
    "msclip.train.forward": 0.4,
    "msclip.train.backward": 0.0,  # the calling thread launches nothing
    "autograd::engine::evaluate_function: FusedAttentionQKVBackward": 0.5,
    "autograd::engine::evaluate_function: ConvolutionBackward0": 0.3,
    "aten::convolution": 0.1,
    "Optimizer.step#AdamW.step": 0.016,
}
# metric -> (kind, the span keys it reads, milliseconds a step of OPS)
READERS = {
    "forward_ms.train": ("train", ["msclip.train.forward"], 100.0),
    "backward_ms.train": (
        "train", [k for k in OPS if k.startswith("autograd::engine::")],
        200.0),
    "attention_ms.train": (
        "train", ["msclip.attention.fwd", "msclip.attention.bwd"], 2.0),
}


def context(kind, ops):
    cell = helpers.eval_cell() if kind == "eval" else helpers.train_cell()
    span = tracing.Span(steps=STEPS, window_s=1.2, event_s=1.2, busy_s=1.1,
                        ops=dict(ops))
    out = cells.Outcome(setup_s=1.0, window_s=1.0, steps=10, items=80,
                        step_s=[0.1] * 10, memory_peak_bytes=1,
                        attempted=80, failed=0, span=span)
    return peaks.Context(kind=kind, arch=R.arch_from_file(cell.config_path),
                         traffic=cell.traffic, chips=1, outcome=out)


def test_every_span_reader_is_a_per_layer_metric():
    named = {m["name"] for m in manifest.load_benchmark()["per_layer"]}
    assert set(READERS) <= named


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reads_the_milliseconds_a_step_under_its_span(metric):
    kind, _, ms = READERS[metric]
    assert manifest.reader(metric)(context(kind, OPS)) == pytest.approx(ms)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reads_nothing_in_a_cell_of_the_other_kind(metric):
    kind, _, _ = READERS[metric]
    other = "train" if kind == "eval" else "eval"
    assert manifest.reader(metric)(context(other, OPS)) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reads_nothing_without_its_span(metric):
    kind, keys, _ = READERS[metric]
    for key in keys:
        ops = {k: v for k, v in OPS.items() if k != key}
        if metric == "backward_ms.train":  # one node range left still reads
            ops = {k: v for k, v in OPS.items() if k not in keys}
        assert manifest.reader(metric)(context(kind, ops)) is None

"""``BENCHMARK.json`` and the files it names: every configuration,
traffic mix, limits file, layout and per-layer reader is found and well
formed, and the file keeps to the contract's shapes and names; on one
synthetic traced span every reader of a cell reads a number, the value it
read before the layouts were looked up by ``MODEL.NAME``."""

import json
import os
import re

import pytest

from benchmark import cells, manifest, peaks, tracing
from benchmark.tests import helpers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmark"]
    assert all(one_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entries():
    names = {"configs": set(), "workloads": set(), "metrics": set()}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert os.path.exists(os.path.join(manifest.ROOT, c["file"]))
        names["configs"].add(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names["configs"] and w["chips"] in (1, 4)
        assert one_line(w["why"])
        names["workloads"].add(w["name"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= names["workloads"]
        assert m["name"] not in names["metrics"]
        names["metrics"].add(m["name"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and one_line(m["layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_metrics(cell):
    c = manifest.find_cell(BENCH, cell)
    assert callable(manifest.kind(c.traffic["kind"]))
    assert c.limits and all(isinstance(v, float) and v > 0
                            for v in c.limits.values())
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert m.get("moves", m["name"]) in reported
        assert callable(manifest.reader(m["name"]))


def test_every_metric_file_is_named():
    files = {f[:-3] for f in os.listdir(os.path.join(manifest.BENCH_DIR,
                                                     "metrics"))
             if f.endswith(".py")}
    assert files == {m["name"] for m in BENCH["end_to_end"]
                     + BENCH["per_layer"]}


def test_every_config_has_a_layout():
    for c in BENCH["configs"]:
        path = os.path.join(manifest.ROOT, c["file"])
        assert manifest.arch(path).attention_blocks > 0


# every kind of record the readers look for
OPS = {"aten::convolution": 0.1, "aten::convolution_backward": 0.1,
       "Optimizer.step#AdamW.step": 0.01, "msclip.train.forward": 0.08,
       "msclip.attention.fwd": 0.004, "msclip.attention.bwd": 0.012,
       "autograd::engine::evaluate_function: FusedAttentionQKVBackward": 0.2}
CLIP_EVAL = "small_clip.eval"  # the plain ViT layout under the eval metrics


def cell_of(name):
    """A cell of ``BENCHMARK.json``, or the small plain-ViT eval cell with
    the metrics of ``b32.eval.bs256``."""
    if name != CLIP_EVAL:
        return manifest.find_cell(BENCH, name)
    c = helpers.clip_eval_cell()
    like = manifest.find_cell(BENCH, "b32.eval.bs256")
    c.end_to_end, c.per_layer = like.end_to_end, like.per_layer
    return c


def synthetic_readings(c, monkeypatch):
    """``{metric: value}`` of every metric of cell ``c`` on one fixed run
    outcome and traced span, through the layout lookup."""
    monkeypatch.setattr(peaks, "card_peaks",
                        lambda: peaks.PEAKS["NVIDIA H100 80GB HBM3"])
    span = tracing.Span(
        steps=4, window_s=1.2, event_s=1.2, busy_s=1.1,
        kernels={"attention_fwd_kernel": [44, 0.01],
                 "attention_bwd_kernel": [92, 0.02],
                 "ncclDevKernel_AllReduce": [8, 0.03]},
        ops=dict(OPS))
    out = cells.Outcome(setup_s=10.0, window_s=30.0, steps=100, items=25600,
                        step_s=[0.3] * 100, memory_peak_bytes=1,
                        attempted=25600, failed=0, span=span)
    ctx = peaks.Context(kind=c.traffic["kind"],
                        arch=manifest.arch(c.config_path),
                        traffic=c.traffic, chips=c.chips, outcome=out)
    return {m["name"]: manifest.reader(m["name"])(ctx)
            for m in c.end_to_end + c.per_layer}


@pytest.mark.parametrize("cell", CELLS + [CLIP_EVAL])
def test_every_metric_of_a_cell_reads_a_number(cell, monkeypatch):
    """Each metric a cell reports reads a number from a run's outcome and
    a traced span with every kind of record the readers look for."""
    for name, value in synthetic_readings(cell_of(cell),
                                          monkeypatch).items():
        assert isinstance(value, float) and value > 0, name


# what each reader read on the synthetic span when the shapes came from
# ``reference.arch_from_file`` and MS-CLIP-S's counts were hard-wired
PARENT_READINGS = {
    "b32.eval.bs256": {
        "images_per_s": 853.3333333333334, "step_ms_p90": 300.0,
        "setup_s": 10.0, "device_idle.eval": 8.333333333333325,
        "mfu.eval": 0.8844996551398719,
        "attn_fwd_roofline.eval": 10.329256119402986},
    "b32.train.bs256": {
        "samples_per_s": 853.3333333333334, "step_ms_p90": 300.0,
        "setup_s": 10.0, "device_idle.train": 8.333333333333325,
        "mfu.train": 6.095787371421638,
        "attn_bwd_roofline.train": 24.223804656716418,
        "conv_ms.train": 50.0, "optimizer_ms.train": 2.5,
        "forward_ms.train": 20.0, "backward_ms.train": 50.0,
        "attention_ms.train": 4.0},
    "b16.eval.bs256": {
        "images_per_s": 853.3333333333334, "step_ms_p90": 300.0,
        "setup_s": 10.0, "device_idle.eval": 8.333333333333325,
        "mfu.eval": 3.1336442836858778,
        "attn_fwd_roofline.eval": 40.697269110447756},
}


@pytest.mark.parametrize("cell", sorted(PARENT_READINGS))
def test_the_readers_read_what_they_read_before(cell, monkeypatch):
    assert synthetic_readings(cell_of(cell), monkeypatch) \
        == PARENT_READINGS[cell]

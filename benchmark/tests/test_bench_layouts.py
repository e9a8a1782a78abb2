"""A configuration's layout, found by its ``MODEL.NAME``
(``manifest.layout``): each layout module's interface and imports, a
configuration with no layout, and the plain CLIP ViT layout driven through
the eval kind on the CPU at the small size (``helpers.py``): a sound run
is correct; each image given its neighbour's answer, each step the
previous step's answers, and the program's int8 path are not. The train
kind refuses a layout without a train reference."""

import ast
import json
import os
import time

import pytest
import torch

from benchmark import calibrate, manifest
from benchmark.kinds import eval as eval_kind
from benchmark.kinds import train as train_kind
from benchmark.tests import helpers

LAYOUTS = sorted(f[:-3] for f in os.listdir(os.path.join(
    manifest.BENCH_DIR, "layouts")) if f.endswith(".py")
    and not f.startswith("_"))
SMALL_CONFIG = {"clip_openai_pe_res_v1": helpers.SMALL,
                "clip_openai": helpers.SMALL_CLIP}


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(saved)


def clip_run(opts=()):
    return eval_kind.run(helpers.clip_eval_cell(), helpers.SEED, 0.2, False,
                         "cpu", time.perf_counter(), opts)


@pytest.mark.parametrize("name", LAYOUTS)
def test_each_layout_is_found_by_model_name_and_gives_the_interface(name):
    module = manifest.layout(SMALL_CONFIG[name])
    assert module.__name__ == f"benchmark.layouts.{name}"
    a = manifest.arch(SMALL_CONFIG[name])
    for key in ("embed", "resolution", "context", "vocab", "text_width",
                "text_heads", "text_layers", "width", "heads", "seq",
                "attention_blocks"):
        assert getattr(a, key) > 0, key
    assert a.image_flops() > 0
    assert callable(module.param_layout) and callable(module.zero_shot_logits)


@pytest.mark.parametrize("name", LAYOUTS)
def test_the_layouts_import_nothing_of_the_port(name):
    with open(os.path.join(manifest.BENCH_DIR, "layouts", name + ".py")) as f:
        tree = ast.parse(f.read())
    names = {n.names[0].name for n in ast.walk(tree)
             if isinstance(n, ast.Import)}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"json", "dataclasses", "torch", "benchmark"}


@pytest.mark.parametrize("name", ["clip_unknown", "../reference", None])
def test_a_config_without_a_layout_fails_naming_it(tmp_path, name):
    with open(helpers.SMALL_CLIP) as f:
        cfg = json.load(f)
    cfg["MODEL"]["NAME"] = name
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match=f"MODEL.NAME {name!r}"):
        manifest.layout(str(path))


def test_the_msclips_layout_refuses_another_layout():
    with pytest.raises(ValueError, match="MS-CLIP-S layout only"):
        manifest.layout(helpers.SMALL).arch_from_file(helpers.SMALL_CLIP)


def test_the_clip_layout_refuses_msclips_keys():
    with pytest.raises(ValueError, match="plain ViT only"):
        manifest.layout(helpers.SMALL_CLIP).arch_from_file(helpers.SMALL)


def test_the_train_kind_refuses_a_layout_without_a_train_reference():
    cell = helpers.train_cell()
    cell.config_path = helpers.SMALL_CLIP
    with pytest.raises(ValueError, match="clip_openai layout has no train "
                                         "reference"):
        train_kind.run(cell, helpers.SEED, 0.2, False, "cpu",
                       time.perf_counter())


def test_a_sound_clip_run_is_correct():
    out = clip_run()
    assert out.correct and out.steps > 0


@pytest.mark.parametrize("fault", ["rolled", "stale"])
def test_wrong_answers_fail_the_clip_layout(fault):
    undo = calibrate.planted(fault)
    try:
        out = clip_run()
    finally:
        undo()
    assert not out.correct


def test_the_int8_control_fails_the_clip_layout():
    assert not clip_run(["TPU.INT8_EVAL", "True"]).correct

"""The frozen reference against ``msclip_torch``'s path in float32 on the
CPU at the small size: both towers, the folded eval model's logits and
the train step's losses, first gradients and changes. This test imports
both; the reference imports nothing of the port."""

import ast
import os
import time

import pytest
import torch

from benchmark import cells, manifest
from benchmark.kinds import eval as eval_kind
from benchmark.kinds import train as train_kind
from benchmark import reference as R
from benchmark.tests import helpers

FP32 = ["TPU.COMPUTE_DTYPE", "float32"]


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(saved)


def test_the_reference_imports_only_torch():
    with open(R.__file__) as f:
        tree = ast.parse(f.read())
    names = {n.names[0].name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import)}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "json", "math", "dataclasses", "torch"}


def test_towers_match_the_port():
    from msclip_torch.data.transforms import normalize_uint8
    from msclip_torch.models.folding import fold_params_for_eval
    from msclip_torch.models.msclip import MSClipModel

    cfg, spec = cells.port_config(helpers.SMALL, FP32)
    a = manifest.arch(helpers.SMALL)
    p = R.draw_params(R.param_layout(a), 11, "cpu")
    gen = cells.input_generator(11, "cpu")
    traffic = {"ring": 1, "batch": 4, "caption_tokens": [5, 40]}
    images = cells.make_images(a, traffic, gen, "cpu")[0]
    tokens = cells.make_tokens(a, traffic, gen, "cpu")[0]
    with torch.no_grad():
        for params in (p, fold_params_for_eval(p, spec)):
            model = MSClipModel(spec, params)
            got = model.encode_image(normalize_uint8(images))
            assert torch.allclose(got, R.encode_image(p, a, images),
                                  atol=2e-6)
            got = model.encode_text(tokens)
            assert torch.allclose(got, R.encode_text(p, a, tokens),
                                  atol=2e-6)


def test_the_clip_image_tower_matches_the_port():
    """The plain ViT layout's reference against the port's
    ``encode_image``, unfolded and folded (nothing to fold), float32."""
    from msclip_torch.data.transforms import normalize_uint8
    from msclip_torch.models.folding import fold_params_for_eval
    from msclip_torch.models.msclip import MSClipModel

    cfg, spec = cells.port_config(helpers.SMALL_CLIP, FP32)
    layout = manifest.layout(helpers.SMALL_CLIP)
    a = manifest.arch(helpers.SMALL_CLIP)
    p = R.draw_params(layout.param_layout(a), 11, "cpu")
    images = cells.make_images(a, {"ring": 1, "batch": 4},
                               cells.input_generator(11, "cpu"), "cpu")[0]
    with torch.no_grad():
        want = layout.encode_image(p, a, images)
        for params in (p, fold_params_for_eval(p, spec)):
            got = MSClipModel(spec, params).encode_image(
                normalize_uint8(images))
            assert torch.allclose(got, want, atol=2e-6)


def test_eval_cell_matches_the_reference_in_float32():
    out = eval_kind.run(helpers.eval_cell(), 5, 0.2, False, "cpu",
                          time.perf_counter(), FP32)
    assert out.correct and out.checks["logit_rms_gap"][0] < 1e-4


def test_train_step_matches_the_reference_in_float32():
    out = train_kind.run(helpers.train_cell(), 5, 0.2, False, "cpu",
                           time.perf_counter(), FP32)
    numbers = {k: v for k, (v, _) in out.checks.items()}
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4
    assert numbers["change_gap"] < 1e-4


def test_lower_precision_reference_departs():
    """The rounding hook changes the numbers, by more in float8."""
    a = manifest.arch(helpers.SMALL)
    p = R.draw_params(R.param_layout(a), 2, "cpu")
    images = torch.randint(0, 256, (2, a.resolution, a.resolution, 3),
                           dtype=torch.uint8)
    with torch.no_grad():
        ref = R.encode_image(p, a, images)
        bf16 = R.encode_image(p, a, images, prec=R.Precision(torch.bfloat16))
        fp8 = R.encode_image(p, a, images, prec=R.Precision("fp8"))
    assert 0 < (bf16 - ref).norm() < (fp8 - ref).norm()


def test_config_files_are_the_releases():
    """The cells' configurations are the port's copies of the released
    configs with the compute precision set and no checkpoint."""
    import json

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for name in ("b32", "b16"):
        with open(os.path.join(root, "benchmark", "configs",
                               f"msclips-{name}.json")) as f:
            ours = json.load(f)
        with open(os.path.join(root, "msclip_torch", "config",
                               f"{name}-yfcc-msclips.json")) as f:
            release = json.load(f)
        assert ours.pop("TPU") == {"COMPUTE_DTYPE": "bfloat16"}
        assert ours["MODEL"].pop("PRETRAINED_MODEL") == ""
        release["MODEL"].pop("PRETRAINED_MODEL")
        assert ours == release

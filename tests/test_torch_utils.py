"""The port's last utility modules against the JAX package's, on the CPU:
``utils/summary.py`` (parameter counts, FLOPs, the profiler trace and the
``MSCLIP_TRACE`` hooks of zero-shot and the train loop, the debug
switches), ``utils/partial_load.py``, ``utils/platform.py`` and the CLIs
that call it first, and ``config/io.py``, ``config/names.py`` with
``CfgNode.dump``."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msclip_tpu.config import get_default_config as jax_default_config
from msclip_tpu.config import io as JIO
from msclip_tpu.config import names as JN
from msclip_tpu.config import update_config as jax_update_config
from msclip_tpu.models import build_model as jax_build_model
from msclip_tpu.utils import partial_load as JPL
from msclip_tpu.utils import summary as JS
from msclip_torch.config import (
    get_config_name,
    get_default_config,
    get_lr_scheduler_name,
    get_model_name,
    get_train_name,
    save_config,
    update_config,
)
from msclip_torch.config import io as TIO
from msclip_torch.eval.zero_shot import run_zero_shot
from msclip_torch.models import msclip as TM
from msclip_torch.tools.train import train
from msclip_torch.utils import partial_load as TPL
from msclip_torch.utils import platform as TP
from msclip_torch.utils import summary as TS
from msclip_torch.utils.comm import comm
from msclip_torch.utils.convert import params_from_jax

from reference_oracle import tiny_msclips_config
from test_torch_train import _tiny_cli_config
from torch_port_params import random_jax_params
from torch_threads import one_torch_thread  # noqa: F401
from torch_zoo_configs import build, vit_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "experiments", "model")


# ---------------------------------------------------------------------------
# summary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["vit", "msclips"])
def test_param_tree_summary_totals_match_jax(name):
    """The same model's parameters counted in both packages: the same
    total, and the prefixes of the port's keys sum to it."""
    cfg = vit_config() if name == "vit" else tiny_msclips_config(layers=4)
    jm, jp, spec, tp = build(cfg)
    mine, theirs = TS.param_tree_summary(tp), JS.param_tree_summary(jp)
    assert mine["TOTAL"] == theirs["TOTAL"] > 0
    assert sum(v for k, v in mine.items() if k != "TOTAL") == mine["TOTAL"]
    assert TS.param_tree_summary(tp, depth=1)["TOTAL"] == mine["TOTAL"]


def _analytic_vit_flops(spec):
    """Matrix-product and convolution FLOPs (``2 m n k``) of one image and
    one prompt through plain CLIP at the spec's widths: the patchify
    convolution, each block's four projections (``24 L E^2``) and its
    scores and weighted sum (``4 L^2 E``), the one pooled row's final
    projection."""
    g = spec.image_resolution // spec.vision_patch_size
    W, T, P = spec.vision_width, spec.text_width, spec.vision_patch_size
    Li, Lt = g * g + 1, spec.context_length

    def block(L, E):
        return 24 * L * E * E + 4 * L * L * E

    image = 2 * W * g * g * 3 * P * P + spec.vision_layers * block(Li, W) \
        + 2 * W * spec.embed_dim
    text = spec.text_layers * block(Lt, T) + 2 * T * spec.embed_dim
    return image, text


# |XLA's count / FlopCounterMode's - 1| measured on these two tiny models:
# image 1.2% and 1.4%, text 4.3% and 2.0% (XLA also counts elementwise
# operations, and the two count the stems' convolutions differently)
XLA_GAP = 0.06


@pytest.mark.parametrize("name", ["vit", "msclips"])
def test_flops_count_matrix_products_and_convolutions(name):
    """``flops_estimate`` equals the analytic count of plain CLIP's matrix
    products and convolutions exactly, and lies within ``XLA_GAP`` of the
    JAX package's XLA cost analysis of the same towers (MS-CLIP-S too);
    ``model_summary`` prints both towers' counts and the totals."""
    cfg = vit_config() if name == "vit" else tiny_msclips_config(layers=4)
    jm, jp, spec, tp = build(cfg)
    size = spec.image_resolution
    images = torch.zeros(1, size, size, 3)
    tokens = torch.zeros(1, spec.context_length, dtype=torch.long)
    tokens[0, 1] = spec.vocab_size - 1
    img = TS.flops_estimate(lambda: TM.encode_image(tp, spec, images))
    txt = TS.flops_estimate(lambda: TM.encode_text(tp, spec, tokens))
    if name == "vit":
        assert (img, txt) == _analytic_vit_flops(spec)
    jimg = JS.flops_estimate(lambda p, x: jm.encode_image(p, x), jp,
                             jnp.zeros((1, size, size, 3)))
    jtxt = JS.flops_estimate(lambda p, t: jm.encode_text(p, t), jp,
                             jnp.asarray(tokens.numpy().astype(np.int32)))
    assert abs(jimg / img - 1) < XLA_GAP and abs(jtxt / txt - 1) < XLA_GAP
    text = TS.model_summary(tp, spec)
    assert f"{TS.param_tree_summary(tp)['TOTAL']:,d}" in text
    assert f"encode_image GFLOPs/img: {img / 1e9:.2f}" in text
    assert f"encode_text GFLOPs/seq: {txt / 1e9:.2f}" in text


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with TS.profile_trace(str(tmp_path / "t")) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(path) as f:
        trace = json.load(f)
    assert os.path.dirname(path) == str(tmp_path / "t")
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_debug_switches(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    kept = (torch.is_anomaly_enabled(), torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled())
    try:
        TS.debug_nans(True)
        assert torch.is_anomaly_enabled()
        TS.deterministic(True)
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        assert torch.are_deterministic_algorithms_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
        TS.debug_nans(False)
        TS.deterministic(False)
        assert not torch.is_anomaly_enabled()
        assert not torch.are_deterministic_algorithms_enabled()
    finally:
        torch.autograd.set_detect_anomaly(kept[0])
        torch.backends.cudnn.deterministic = kept[1]
        torch.backends.cudnn.benchmark = kept[2]
        torch.use_deterministic_algorithms(kept[3])


# ---------------------------------------------------------------------------
# MSCLIP_TRACE
# ---------------------------------------------------------------------------

def _traces(d):
    return sorted(glob.glob(os.path.join(d, "trace_*.json")))


@pytest.mark.parametrize("n_batches", [7, 5])
def test_zero_shot_traces_batches_3_to_6(tmp_path, monkeypatch, n_batches):
    """``MSCLIP_TRACE``: one trace of batches 3-6 after a 7-batch run, and
    one closed at the end of a run shorter than the window, as JAX's."""
    spans = []
    real = TS.profile_trace

    def spy(log_dir):
        spans.append("start")
        return real(log_dir)

    monkeypatch.setattr(TS, "profile_trace", spy)
    monkeypatch.setenv("MSCLIP_TRACE", str(tmp_path / "trace"))
    cfg = tiny_msclips_config(layers=2, vocab_size=49408)
    cfg.merge_from_list([
        "DATASET.DATASET", "synthetic", "DATASET.NUM_SAMPLES", 2 * n_batches,
        "TEST.BATCH_SIZE_PER_GPU", 2, "TEST.SUBSET_CLASSES", 2, "WORKERS", 1,
        "MODEL.PRETRAINED_MODEL", ""])
    _, stats = run_zero_shot(cfg, device="cpu")
    assert stats["n_image_batches"] == n_batches
    assert spans == ["start"] and len(_traces(tmp_path / "trace")) == 1
    with open(_traces(tmp_path / "trace")[0]) as f:
        assert json.load(f)["traceEvents"]


def test_train_traces_steps_4_to_7(tmp_path, monkeypatch):
    """``MSCLIP_TRACE`` on the train loop (the port refused it before):
    a 7-step run writes one trace, of steps 4-7, and trains as without."""
    monkeypatch.setenv("MSCLIP_TRACE", str(tmp_path / "trace"))
    cfg = get_default_config()
    update_config(cfg, _tiny_cli_config(tmp_path),
                  opts=["TRAIN.BATCH_SIZE_PER_GPU", 2,
                        "DATASET.NUM_SAMPLES", 14])
    _, stats = train(cfg, device="cpu")
    assert stats["steps"] == 7 and all(np.isfinite(stats["losses"]))
    assert len(_traces(tmp_path / "trace")) == 1


def test_no_trace_without_the_variable(tmp_path, monkeypatch):
    monkeypatch.delenv("MSCLIP_TRACE", raising=False)
    window = TS.TraceWindow(None, 3, 6, "cpu", "nothing")
    for i in range(8):
        window.before(i)
        window.after(i)
    window.close()
    assert window.path is None


# ---------------------------------------------------------------------------
# partial_load
# ---------------------------------------------------------------------------

def _gpt2_state(E, layers, seed=0):
    """GPT-2 names and Conv1D layouts (``[in, out]``) for ``layers``."""
    rng = np.random.default_rng(seed)
    sd = {}
    for l in layers:
        for name, shape in (("attn.c_attn.weight", (E, 3 * E)),
                            ("attn.c_attn.bias", (3 * E,)),
                            ("attn.c_proj.weight", (E, E)),
                            ("attn.c_proj.bias", (E,)),
                            ("mlp.c_fc.weight", (E, 4 * E)),
                            ("mlp.c_fc.bias", (4 * E,)),
                            ("mlp.c_proj.weight", (4 * E, E)),
                            ("mlp.c_proj.bias", (E,)),
                            ("ln_1.weight", (E,)), ("ln_1.bias", (E,)),
                            ("ln_2.weight", (E,)), ("ln_2.bias", (E,))):
            sd[f"h.{l}.{name}"] = rng.standard_normal(shape).astype(
                np.float32)
    return sd


def _shared_model(n_layers=1):
    cfg = tiny_msclips_config(layers=3)
    cfg.CUSTOM.N_LAYERS = n_layers
    jm = jax_build_model(cfg)
    jp = random_jax_params(jm, seed=0)
    spec = TM.spec_from_config(cfg)
    return jm, jp, spec, params_from_jax(jp, spec)


def test_partial_load_gpt2_matches_jax():
    """GPT-2 block weights for the range ``N_LAYERS`` implies (layers 1-2
    of 3) land in the shared trunk blocks as JAX's loader puts them, the
    four matrices transposed to the port's ``[out, in]``; the text tower
    reads them through sharing, and the features agree with JAX's."""
    jm, jp, spec, tp = _shared_model()
    assert TPL.load_layer_range(spec) == JPL.load_layer_range(jm.spec) \
        == [1, 2]
    sd = _gpt2_state(spec.text_width, [1, 2])
    want = params_from_jax(JPL.partial_load_gpt2(jp, jm.spec, sd), spec)
    got = TPL.partial_load_gpt2(tp, spec, sd)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0, msg=k)
    np.testing.assert_array_equal(
        got["visual.transformer.resblocks.1.attn.in_proj_weight"].numpy(),
        sd["h.1.attn.c_attn.weight"].T)
    assert got is not tp and torch.equal(
        tp["visual.transformer.resblocks.1.ln_1.weight"],
        params_from_jax(jp, spec)["visual.transformer.resblocks.1.ln_1.weight"])
    blk = TM.resolve_text_block(got, spec, 1)
    np.testing.assert_array_equal(blk["mlp.c_fc.weight"].numpy(),
                                  sd["h.1.mlp.c_fc.weight"].T)


def test_partial_load_gpt2_shape_errors_and_unmatched(caplog):
    jm, jp, spec, tp = _shared_model()
    sd = _gpt2_state(spec.text_width, [1])  # layer 2 unmatched: logged
    import logging
    with caplog.at_level(logging.INFO):
        TPL.partial_load_gpt2(tp, spec, sd)
    assert "matched 12 tensors into layers [1, 2]; unmatched patterns: 12" \
        in caplog.text
    sd["h.1.attn.c_proj.weight"] = sd["h.1.attn.c_proj.weight"][:, :-1]
    with pytest.raises(ValueError, match="shape mismatch h.1.attn.c_proj"):
        TPL.partial_load_gpt2(tp, spec, sd)
    with pytest.raises(ValueError, match="shape mismatch h.1.attn.c_proj"):
        JPL.partial_load_gpt2(jp, jm.spec, sd)


# ---------------------------------------------------------------------------
# platform
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,device", [(None, "cuda"), ("cpu", "cpu"),
                                          ("cuda", "cuda"), ("CPU", "cpu")])
def test_platform_default_device(monkeypatch, value, device):
    if value is None:
        monkeypatch.delenv("MSCLIP_PLATFORM", raising=False)
    else:
        monkeypatch.setenv("MSCLIP_PLATFORM", value)
    assert TP.apply_platform_override() == device


def test_platform_refuses_other_platforms_and_sets_debug_nans(monkeypatch):
    monkeypatch.setenv("MSCLIP_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="MSCLIP_PLATFORM"):
        TP.apply_platform_override()
    monkeypatch.delenv("MSCLIP_PLATFORM")
    monkeypatch.setenv("MSCLIP_DEBUG_NANS", "1")
    kept = torch.is_anomaly_enabled()
    try:
        TP.apply_platform_override()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(kept)


class _Stop(Exception):
    pass


B32 = os.path.join(REPO, "msclip_torch", "config", "b32-yfcc-msclips.json")
DS = os.path.join(REPO, "experiments", "dataset", "imagenet.yaml")
CLI_ARGS = {
    "zero_shot": ["--ds", DS, "--model", B32],
    "train": ["--cfg", B32],
    "finetune": ["--ds", DS, "--model", B32],
    "serve": ["--model", B32],
    "export_serving": ["--model", B32, "--out", "unused"],
    "extract_features": ["--ds", DS, "--model", B32],
    "linear_probe": ["--ds", DS, "--model", B32],
}


@pytest.mark.parametrize("cli", sorted(CLI_ARGS))
def test_clis_take_the_platform_default(monkeypatch, cli):
    """Each CLI whose JAX twin applies the platform override calls it
    first: ``MSCLIP_PLATFORM=cpu`` makes the CPU its default device, and
    ``--device`` still wins."""
    import importlib

    mod = importlib.import_module(f"msclip_torch.tools.{cli}")

    def stop(device):
        raise _Stop(str(device))

    monkeypatch.setattr(mod, "resolve_device", stop)
    monkeypatch.setenv("MSCLIP_PLATFORM", "cpu")
    for extra, want in (([], "cpu"), (["--device", "cuda:1"], "cuda:1")):
        with pytest.raises(_Stop, match=f"^{want}$"):
            mod.main(CLI_ARGS[cli] + extra)


# ---------------------------------------------------------------------------
# config: names, io
# ---------------------------------------------------------------------------

NAMED = {
    "b32": ("b32-yfcc-msclips.yaml", []),
    "b16": ("b16-yfcc-msclips.yaml", []),
    "rn50": ("b32.yaml", ["MODEL.SPEC.VISION.WIDTH", "64",
                          "MODEL.SPEC.EMBED_DIM", "1024"]),
    "multistep": ("b32.yaml", ["TRAIN.LR_SCHEDULER.METHOD", "MultiStep",
                               "TRAIN.LR_SCHEDULER.MILESTONES", "[10,20]",
                               "TRAIN.LR_SCHEDULER.GAMMA", "0.5",
                               "AUG.MIXUP", "0.2"]),
}


@pytest.mark.parametrize("name", sorted(NAMED))
def test_names_equal_jax_s(name):
    base, opts = NAMED[name]
    cfg, jcfg = get_default_config(), jax_default_config()
    update_config(cfg, os.path.join(MODELS, base), opts=opts)
    jax_update_config(jcfg, os.path.join(MODELS, base), opts=opts)
    if name == "rn50":  # the JAX config takes the list as an attribute
        cfg.MODEL.SPEC.VISION.LAYERS = [3, 4, 6, 3]
        jcfg.MODEL.SPEC.VISION.LAYERS = [3, 4, 6, 3]
    for fn, jfn in ((get_model_name, JN.get_model_name),
                    (get_lr_scheduler_name, JN.get_lr_scheduler_name)):
        assert fn(cfg) == jfn(jcfg)
    for ws in (1, 8):
        assert get_train_name(cfg, ws) == JN.get_train_name(jcfg, ws)
        assert get_config_name(cfg, ws) == JN.get_config_name(jcfg, ws)
    if name == "rn50":
        assert get_model_name(cfg).endswith("-rn16")
    if name == "multistep":
        assert "MultiStep10_20factor0.5" in get_train_name(cfg)


def test_save_config_round_trips_on_rank_0_only(tmp_path, monkeypatch):
    cfg = get_default_config()
    update_config(cfg, os.path.join(MODELS, "b32-yfcc-msclips.yaml"),
                  opts=["TRAIN.LR", "0.25", "TPU.USE_FUSED_BLOCK", "True"])
    path = str(tmp_path / "config.yaml")
    save_config(cfg, path)
    back = get_default_config()
    update_config(back, path)
    # update_config names a run after the file it read (NAME)
    assert {**back.to_dict(), "NAME": None} == {**cfg.to_dict(), "NAME": None}
    monkeypatch.setattr(type(comm), "is_main_process", lambda self: False)
    save_config(cfg, str(tmp_path / "rank1.yaml"))
    assert not (tmp_path / "rank1.yaml").exists()


def test_export_deepspeed_config_equals_jax_s(tmp_path):
    cfg, jcfg = get_default_config(), jax_default_config()
    TIO.export_deepspeed_config(cfg, 512, str(tmp_path / "port.json"))
    JIO.export_deepspeed_config(jcfg, 512, str(tmp_path / "jax.json"))
    with open(tmp_path / "port.json") as f, open(tmp_path / "jax.json") as g:
        assert json.load(f) == json.load(g) == {"train_batch_size": 512}

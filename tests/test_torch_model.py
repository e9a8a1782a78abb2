"""The port's MS-CLIP-S towers, key maps and spec against the JAX package's,
fp32 on the CPU, on shared weights made with numpy from a seed."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msclip_tpu.config import get_default_config as jax_default_config
from msclip_tpu.config import update_config as jax_update_config
from msclip_tpu.models import build_model as jax_build_model
from msclip_tpu.models.folding import fold_params_for_eval as jax_fold
from msclip_tpu.utils import build_key_map as jax_build_key_map
from msclip_tpu.utils import export_torch_state_dict
from msclip_torch.config import get_default_config, update_config
from msclip_torch.models import msclip as TM
from msclip_torch.models.folding import fold_params_for_eval
from msclip_torch.utils.convert import (
    build_key_map,
    derived_keys,
    load_state_dict,
    params_from_jax,
)

from reference_oracle import tiny_msclips_config
from torch_port_params import random_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RELEASED = ["b32-yfcc-msclips", "b32-laion-msclips", "b16-yfcc-msclips"]
ATOL = 1e-4  # fp32 through 12 blocks, sums in another order than XLA's


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_msclips_config()
    jm = jax_build_model(cfg)
    jp = random_jax_params(jm, seed=0)
    spec = TM.spec_from_config(cfg)
    return cfg, jm, jp, spec, params_from_jax(jp, spec)


def _inputs(image=64, vocab=512, batch=3):
    rng = np.random.default_rng(42)
    images = rng.standard_normal((batch, image, image, 3)).astype(np.float32)
    tokens = np.zeros((batch, 77), dtype=np.int32)
    for i in range(batch):
        n = int(rng.integers(5, 20))
        tokens[i, 0] = vocab - 2  # sot
        tokens[i, 1:n] = rng.integers(1, vocab - 2, n - 1)
        tokens[i, n] = vocab - 1  # eot: the highest id, found by argmax
    return images, tokens


@pytest.mark.parametrize("folded", [False, True])
def test_towers_match_jax(tiny, folded):
    _, jm, jp, spec, tp = tiny
    if folded:
        jp = jax.jit(lambda p: jax_fold(p, jm.spec))(jp)
        tp = fold_params_for_eval(tp, spec)
    images, tokens = _inputs()
    want_i = jax.jit(jm.encode_image)(jp, jnp.asarray(images))
    want_t = jax.jit(jm.encode_text)(jp, jnp.asarray(tokens))
    got_i = TM.encode_image(tp, spec, torch.from_numpy(images))
    got_t = TM.encode_text(tp, spec, torch.from_numpy(tokens))
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=ATOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=ATOL)


def test_variant_towers_match_jax():
    """VISUAL_LAYER_MINUS1 (one resblock fewer, text sharing shifted by
    one) with average pooling over the non-CLS tokens."""
    cfg = tiny_msclips_config(layers=6)
    cfg.merge_from_dict({"CUSTOM": {"VISUAL_LAYER_MINUS1": True},
                         "MODEL": {"SPEC": {"POOL_TYPE": "average",
                                            "SKIP_CLS": True}}})
    jm = jax_build_model(cfg)
    jp = random_jax_params(jm, seed=2)
    spec = TM.spec_from_config(cfg)
    stored, aliases = build_key_map(spec)
    assert set(stored) | set(aliases) == set(jax_build_key_map(jm.spec))
    tp = params_from_jax(jp, spec)
    images, tokens = _inputs()
    np.testing.assert_allclose(
        TM.encode_image(tp, spec, torch.from_numpy(images)).numpy(),
        np.asarray(jax.jit(jm.encode_image)(jp, jnp.asarray(images))),
        atol=ATOL)
    np.testing.assert_allclose(
        TM.encode_text(tp, spec, torch.from_numpy(tokens)).numpy(),
        np.asarray(jax.jit(jm.encode_text)(jp, jnp.asarray(tokens))),
        atol=ATOL)


def test_folding_keeps_the_features(tiny):
    _, _, _, spec, tp = tiny
    images, _ = _inputs()
    x = torch.from_numpy(images)
    torch.testing.assert_close(
        TM.encode_image(fold_params_for_eval(tp, spec), spec, x),
        TM.encode_image(tp, spec, x), atol=ATOL, rtol=0)


def test_params_from_jax_equals_loading_the_exported_state_dict(tiny):
    """Both key maps agree: the JAX tree carried across directly, and the
    reference-layout state_dict the JAX package exports, loaded."""
    _, jm, jp, spec, tp = tiny
    sd = export_torch_state_dict(jp, jm.spec)
    loaded = load_state_dict(sd, spec)
    assert set(loaded) == set(tp)
    for k in tp:
        torch.testing.assert_close(loaded[k], tp[k], atol=0, rtol=0)


def test_init_params_has_the_key_map_layout(tiny):
    _, _, _, spec, tp = tiny
    p = TM.init_params(spec, torch.Generator().manual_seed(0))
    stored, _ = build_key_map(spec)
    assert set(p) == set(stored) == set(tp)
    assert all(p[k].shape == tp[k].shape and p[k].dtype == torch.float32
               for k in p)


@pytest.mark.parametrize("case", ["alias", "missing", "unknown"])
def test_loading_rejects_a_bad_state_dict(tiny, case):
    _, jm, jp, spec, _ = tiny
    sd = {k: torch.as_tensor(np.asarray(v))
          for k, v in export_torch_state_dict(jp, jm.spec).items()}
    sd["visual.transformer.resblocks.0.bn1.num_batches_tracked"] = \
        torch.tensor(3)  # bookkeeping, ignored
    if case == "alias":
        key = "transformer.resblocks.5.mlp.c_fc.weight"
        sd[key] = sd[key] + 1e-2
    elif case == "missing":
        del sd["visual.transformer.resblocks.7.ln_1.bias"]
    else:
        sd["visual.extra.weight"] = torch.zeros(1)
    with pytest.raises((KeyError, ValueError)):
        load_state_dict(sd, spec)


def test_text_block_takes_the_trunk_block_of_the_same_reference_index(tiny):
    """Text block i shares visual resblock i, i.e. visual transformer block
    i - 1: resblock 0 is the stem (msclip.py:670-694)."""
    _, _, _, spec, tp = tiny
    blk = TM.resolve_text_block(tp, spec, 3)
    assert blk["mlp.c_fc.weight"] is \
        tp["visual.transformer.resblocks.3.mlp.c_fc.weight"]
    assert blk["ln_1.weight"] is tp["transformer.resblocks.3.ln_1.weight"]
    assert TM.resolve_text_block(tp, spec, 0)["attn.in_proj_weight"] is \
        tp["transformer.resblocks.0.attn.in_proj_weight"]


def test_cast_params_keeps_bn_statistics_fp32(tiny):
    _, _, _, spec, tp = tiny
    cast = TM.cast_params(tp, torch.bfloat16)
    for k, v in cast.items():
        want = torch.float32 if k.endswith(("running_mean", "running_var")) \
            else torch.bfloat16
        assert v.dtype == want, k


def test_model_module_state_dict_has_reference_keys(tiny):
    _, _, _, spec, tp = tiny
    model = TM.MSClipModel(spec, tp)
    assert set(model.state_dict()) == set(tp)
    images, _ = _inputs()
    torch.testing.assert_close(
        model.encode_image(torch.from_numpy(images)),
        TM.encode_image(tp, spec, torch.from_numpy(images)))


@pytest.mark.parametrize("name", RELEASED)
def test_released_configs_build_with_the_reference_key_set(name):
    """Each released MS-CLIP-S config builds a spec whose key map covers
    exactly the JAX package's (stored + aliased keys: 485 at B/32)."""
    path = os.path.join(REPO, "experiments", "model", f"{name}.yaml")
    cfg, jcfg = get_default_config(), jax_default_config()
    update_config(cfg, path)
    jax_update_config(jcfg, path)
    spec = TM.spec_from_config(cfg)
    stored, aliases = build_key_map(spec)
    jkeys = set(jax_build_key_map(jax_build_model(jcfg).spec))
    assert set(stored) | set(aliases) == jkeys
    assert not set(stored) & set(aliases)
    assert len(jkeys) == 485 and len(stored) == 397
    assert spec.vision_seq_len == jax_build_model(jcfg).spec.vision_seq_len


def _set(cfg, key, value):
    *path, leaf = key.split(".")
    node = cfg
    for part in path:
        node = node[part]
    node[leaf] = value


# the model-zoo switches (ROADMAP M10), each over b32-yfcc-msclips.yaml
ZOO_CASES = [
    ("CUSTOM.ADAPTER_FLAG", True),
    ("CUSTOM.LORA_ATTN_DIM", 4),
    ("CUSTOM.PERCEIVER_IN_V", True),
    ("CUSTOM.PARALLEL_B2T", True),
    ("CUSTOM.PARALLEL_T2B_WINDOWATTN", True),
    ("MODEL.SPEC.VISION.LAYERS", [3, 4, 6, 3]),
    ("CUSTOM.EARLY_CONV_RES", False),
    ("CUSTOM.EARLY_CONV_NEW_IMPLEMENT", False),
    ("MODEL.SPEC.POOL_TYPE", "linear"),
    ("CUSTOM.GUMBEL_SELECT", True),
]


@pytest.mark.parametrize("key,value", ZOO_CASES)
def test_zoo_features_build_the_jax_spec(key, value):
    """Each model-zoo switch builds the spec JAX's ``spec_from_config``
    builds: the same sequence length, layer counts and sharing, and a key
    map with JAX's keys (stored, aliased and derived)."""
    path = os.path.join(REPO, "experiments", "model", "b32-yfcc-msclips.yaml")
    cfg, jcfg = get_default_config(), jax_default_config()
    update_config(cfg, path)
    jax_update_config(jcfg, path)
    _set(cfg, key, value)
    _set(jcfg, key, value)
    spec, jspec = TM.spec_from_config(cfg), jax_build_model(jcfg).spec
    assert spec.vision_seq_len == jspec.vision_seq_len
    assert spec.vision_resnet_layers == jspec.vision_resnet_layers
    assert spec.effective_vision_layers - spec.first_block == \
        (jspec.n_trunk_blocks if not jspec.vision_resnet_layers else 0) \
        or spec.vision_resnet_layers
    assert spec.text_layers == jspec.text_layers
    assert [spec.text_layer_is_shared(i) for i in range(spec.text_layers)] \
        == [jspec.text_layer_is_shared(i) and not jspec.vision_resnet_layers
            for i in range(jspec.text_layers)]
    assert dataclasses.asdict(spec.ext) == dataclasses.asdict(jspec.ext)
    stored, aliases = build_key_map(spec)
    assert set(stored) | set(aliases) | set(derived_keys(spec)) == \
        set(jax_build_key_map(jspec))


# b32.yaml, OpenAI CLIP's RN50 over it, and b32.yaml with a 512-wide
# image tower
K5_BASES = {"b32": "experiments/model/b32.yaml",
            "rn50": "msclip_torch/config/rn50.json",
            "b32_512": "experiments/model/b32.yaml"}


@pytest.mark.parametrize("base,key,value,item", [
    ("b32", "TPU.USE_FUSED_BLOCK", True, "Queue 2a.3"),
    ("rn50", "TPU.USE_FUSED_BLOCK", True, "Queue 2a.3"),
    ("b32_512", "TPU.USE_FUSED_BLOCK", True, "Queue 2a.3"),
])
def test_unported_features_are_rejected(base, key, value, item):
    """What the port still refuses: K5 on a tower it does not take. Towers
    of two widths (b32.yaml's 512-wide text tower) or a ResNet tower
    (RN50) raise at spec time; towers of one width other than 768 build
    (the CPU runs K5's plain version at any width) and the fused block
    raises off the CPU."""
    cfg = get_default_config()
    update_config(cfg, os.path.join(REPO, K5_BASES[base]))
    _set(cfg, key, value)
    if base != "b32_512":
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            TM.spec_from_config(cfg)
        return
    _set(cfg, "MODEL.SPEC.VISION.WIDTH", 512)
    spec = TM.spec_from_config(cfg)
    assert spec.use_fused_block and spec.vision_width == spec.text_width
    x = torch.empty(2, 50, 512, device="meta")
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        TM._block_fn(spec)({}, x, 8, None)


# TPU.MESH_MODEL 2 with each of these: the ones that need whole blocks
TP_REFUSED = {"TPU.INT8_EVAL": "True", "TPU.USE_FUSED_BLOCK": "True",
              "CUSTOM.ADAPTER_FLAG": "True", "CUSTOM.LORA_ATTN_DIM": "4",
              "CUSTOM.CVT_IN_V": "True", "CUSTOM.CONVIT_IN_V": "True",
              "CUSTOM.CONTAINER_IN_V": "True", "CUSTOM.GUMBEL_SELECT": "True",
              "CUSTOM.PERCEIVER_IN_V": "True",
              "CUSTOM.PERCEIVER_IN_T": "True"}


@pytest.mark.parametrize("key", list(TP_REFUSED))
def test_tensor_parallelism_refuses_whole_block_kernels(key):
    """``TPU.MESH_MODEL > 1`` splits every block's heads over processes;
    int8 eval, the fused half-blocks, the zoo's plug-in blocks and the
    Perceiver blocks need whole blocks, so each raises, naming the
    reason."""
    cfg = get_default_config()
    update_config(cfg, os.path.join(REPO, "experiments", "model",
                                    "b32-yfcc-msclips.yaml"),
                  opts=["TPU.MESH_MODEL", "2", key, TP_REFUSED[key]])
    with pytest.raises(ValueError, match="tensor parallelism"):
        TM.spec_from_config(cfg)


@pytest.mark.parametrize("key", ["TPU.SHARDED_LOSS", "TPU.RING_LOSS",
                                 "TPU.ZERO1", "TPU.FSDP", "TPU.MESH_MODEL"])
def test_multi_process_training_features_build_a_spec(key):
    """The multi-process train step's options are ported: a config with
    one of them on builds the same spec as without it."""
    path = os.path.join(REPO, "experiments", "model", "b32-yfcc-msclips.yaml")
    cfg = get_default_config()
    update_config(cfg, path, opts=[key, "2" if key == "TPU.MESH_MODEL"
                                   else "True"])
    plain = get_default_config()
    update_config(plain, path)
    assert TM.spec_from_config(cfg) == TM.spec_from_config(plain)


@pytest.mark.parametrize("how", ["attribute", "override", "unset"])
def test_fused_block_switch_is_read_for_eval(how):
    """``TPU.USE_FUSED_BLOCK`` has no default in either package's tree; set
    as an attribute (``bench.py``) or as an override of the open ``TPU``
    node, it turns the spec's ``use_fused_block`` on, as in the JAX
    package."""
    path = os.path.join(REPO, "experiments", "model", "b32-yfcc-msclips.yaml")
    cfg, jcfg = get_default_config(), jax_default_config()
    opts = ["TPU.USE_FUSED_BLOCK", "True"] if how == "override" else []
    update_config(cfg, path, opts=opts)
    jax_update_config(jcfg, path, opts=opts)
    if how == "attribute":
        cfg.TPU.USE_FUSED_BLOCK = jcfg.TPU.USE_FUSED_BLOCK = True
    assert TM.spec_from_config(cfg).use_fused_block == \
        jax_build_model(jcfg).spec.use_fused_block == (how != "unset")


@pytest.mark.parametrize("entry", ["make_train_step", "train"])
def test_train_step_refuses_fused_blocks(entry):
    """K5 has no backward: the train step refuses the switch before any
    step (the JAX train step fails inside its backward instead)."""
    from msclip_torch.tools.train import train
    from msclip_torch.train.trainer import make_train_step

    cfg = tiny_msclips_config(layers=4)
    cfg.TPU.USE_FUSED_BLOCK = True
    with pytest.raises(ValueError, match="USE_FUSED_BLOCK is for eval only"):
        if entry == "train":
            train(cfg, device="cpu")
        else:
            make_train_step(TM.spec_from_config(cfg))


def test_spec_reads_the_drop_path_rate():
    path = os.path.join(REPO, "experiments", "model", "b32-yfcc-msclips.yaml")
    cfg, jcfg = get_default_config(), jax_default_config()
    opts = ["MODEL.SPEC.VISION.DROP_PATH", 0.1]
    update_config(cfg, path, opts=opts)
    jax_update_config(jcfg, path, opts=opts)
    assert TM.spec_from_config(cfg).vision_drop_path == \
        jax_build_model(jcfg).spec.vision_drop_path == 0.1


def test_compute_dtype_the_kernel_does_not_take_is_rejected():
    cfg = get_default_config()
    update_config(cfg, os.path.join(REPO, "experiments", "model",
                                    "b32-yfcc-msclips.yaml"),
                  opts=["TPU.COMPUTE_DTYPE", "float16"])
    with pytest.raises(ValueError, match="COMPUTE_DTYPE"):
        TM.spec_from_config(cfg)


def test_unread_custom_key_warns():
    cfg = get_default_config()
    update_config(cfg, os.path.join(REPO, "experiments", "model",
                                    "b32-yfcc-msclips.yaml"))
    cfg.merge_from_list(["CUSTOM.PARALEL_IN_V", True])  # misspelled
    with pytest.warns(UserWarning, match="PARALEL_IN_V"):
        TM.spec_from_config(cfg)


def test_port_imports_neither_jax_nor_msclip_tpu():
    """Every msclip_torch module imports without pulling in jax or any
    module of msclip_tpu."""
    code = (
        "import pkgutil, sys, importlib, msclip_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "msclip_torch.__path__, 'msclip_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'msclip_tpu')))\n"
        "assert len(names) > 15 and not bad, (len(names), bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.slow
def test_full_width_b32_towers_match_jax():
    """Full-width MS-CLIP-S B/32, folded, fp32."""
    path = os.path.join(REPO, "experiments", "model", "b32-yfcc-msclips.yaml")
    cfg, jcfg = get_default_config(), jax_default_config()
    update_config(cfg, path)
    jax_update_config(jcfg, path)
    jm = jax_build_model(jcfg)
    jp = jax.jit(lambda p: jax_fold(p, jm.spec))(random_jax_params(jm, 1))
    spec = TM.spec_from_config(cfg)
    tp = fold_params_for_eval(
        params_from_jax(random_jax_params(jm, 1), spec), spec)
    images, tokens = _inputs(image=224, vocab=49408, batch=2)
    np.testing.assert_allclose(
        TM.encode_image(tp, spec, torch.from_numpy(images)).numpy(),
        np.asarray(jax.jit(jm.encode_image)(jp, jnp.asarray(images))),
        atol=ATOL)
    np.testing.assert_allclose(
        TM.encode_text(tp, spec, torch.from_numpy(tokens)).numpy(),
        np.asarray(jax.jit(jm.encode_text)(jp, jnp.asarray(tokens))),
        atol=ATOL)


@pytest.mark.slow
@pytest.mark.parametrize("folded", [True, False])
def test_full_width_b16_towers_match_jax(folded):
    """Full-width MS-CLIP-S B/16 (L=197 in the image tower), fp32, with BN
    folded and unfolded (eval mode on the running statistics)."""
    path = os.path.join(REPO, "experiments", "model", "b16-yfcc-msclips.yaml")
    cfg, jcfg = get_default_config(), jax_default_config()
    update_config(cfg, path)
    jax_update_config(jcfg, path)
    jm = jax_build_model(jcfg)
    jp = random_jax_params(jm, 2)
    spec = TM.spec_from_config(cfg)
    tp = params_from_jax(jp, spec)
    if folded:
        jp = jax.jit(lambda p: jax_fold(p, jm.spec))(jp)
        tp = fold_params_for_eval(tp, spec)
    images, tokens = _inputs(image=224, vocab=49408, batch=2)
    np.testing.assert_allclose(
        TM.encode_image(tp, spec, torch.from_numpy(images)).numpy(),
        np.asarray(jax.jit(jm.encode_image)(jp, jnp.asarray(images))),
        atol=ATOL)
    np.testing.assert_allclose(
        TM.encode_text(tp, spec, torch.from_numpy(tokens)).numpy(),
        np.asarray(jax.jit(jm.encode_text)(jp, jnp.asarray(tokens))),
        atol=ATOL)

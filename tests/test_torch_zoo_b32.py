"""Plain CLIP (``experiments/model/b32.yaml``: the patchify ViT and a
separate 512-wide text tower; the RN50 geometry over it) and the zoo's
surfaces in the port against the JAX package's, fp32 on the CPU: the key
map both ways for every zoo parameter, zero-shot through ``run_zero_shot``
and a train step at b32.yaml's geometry cut to size, a Gumbel step on a
given action, the introspection taps, and int8 eval, which runs or raises
as the JAX package's does."""

import dataclasses
import functools
import json
import math
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msclip_tpu.config import get_default_config as jax_default_config
from msclip_tpu.config import update_config as jax_update_config
from msclip_tpu.eval import zero_shot as JZ
from msclip_tpu.models import build_model as jax_build_model
from msclip_tpu.models import introspect as JI
from msclip_tpu.models import msclip as JM
from msclip_tpu.models.quantize import quantize_params_for_eval as jax_quant
from msclip_tpu.train import optim as JO
from msclip_tpu.train.trainer import init_train_state as jax_init_state
from msclip_tpu.train.trainer import make_loss_fn as jax_make_loss_fn
from msclip_tpu.train.trainer import make_train_step as jax_make_train_step
from msclip_tpu.utils import build_key_map as jax_build_key_map
from msclip_tpu.utils import export_torch_state_dict
from msclip_tpu.utils.convert import convert_torch_state_dict
from msclip_torch.config import get_default_config, update_config
from msclip_torch.eval import zero_shot as ZS
from msclip_torch.models import introspect as TI
from msclip_torch.models import msclip as TM
from msclip_torch.models.quantize import quantize_params_for_eval
from msclip_torch.parallel.mesh import param_dim
from msclip_torch.serve.export import spec_from_json
from msclip_torch.train import optim as TO
from msclip_torch.train import trainer as TT
from msclip_torch.utils.convert import (
    _from_jax,
    _get_path,
    build_key_map,
    derived_keys,
    export_state_dict,
    load_state_dict,
    params_from_jax,
)

from reference_oracle import tiny_msclips_config
from torch_port_params import random_jax_params
from torch_threads import one_torch_thread  # noqa: F401
from torch_zoo_configs import (
    FAMILIES,
    action,
    build,
    family_config,
    inputs,
    resnet_config,
    vit_config,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B32_YAML = os.path.join(REPO, "experiments", "model", "b32.yaml")
DS_YAML = os.path.join(REPO, "experiments", "dataset", "imagenet.yaml")
# b32.yaml cut to width 128 / 64 (text), 2 layers, 64 px: a grid of 2
TINY_B32 = [
    "TRAIN.IMAGE_SIZE", "[64,64]", "TEST.IMAGE_SIZE", "[64,64]",
    "TEST.BATCH_SIZE_PER_GPU", "4", "TEST.SUBSET_CLASSES", "10",
    "MODEL.SPEC.VISION.WIDTH", "128", "MODEL.SPEC.VISION.LAYERS", "2",
    "MODEL.SPEC.TEXT.WIDTH", "64", "MODEL.SPEC.TEXT.HEADS", "1",
    "MODEL.SPEC.TEXT.LAYERS", "2", "MODEL.SPEC.EMBED_DIM", "32",
    "WORKERS", "2",
]
ATOL = 1e-4  # whole towers in fp32 (tests/test_torch_model.py)
STEPS_PER_EPOCH = 10


def _b32(opts=()):
    cfg, jcfg = get_default_config(), jax_default_config()
    update_config(cfg, B32_YAML, opts=TINY_B32 + list(opts))
    jax_update_config(jcfg, B32_YAML, opts=TINY_B32 + list(opts))
    return cfg, jcfg


@functools.lru_cache(maxsize=None)
def _built(name):
    if name == "vit":
        return build(vit_config())
    if name == "resnet":
        return build(resnet_config())
    return build(family_config(name))


# ---------------------------------------------------------------------------
# the key map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["vit", "resnet"] + sorted(FAMILIES))
def test_key_map_round_trips_every_zoo_parameter(name):
    """The JAX tree carried across equals the JAX package's exported
    reference ``state_dict`` loaded; the port's export holds the same
    keys and tensors, and the JAX converter reads it back into the same
    tree. A derived buffer (the window adapters' relative-position index)
    is accepted and dropped."""
    jm, jp, spec, tp = _built(name)
    try:
        sd = export_torch_state_dict(jp, jm.spec)
    except KeyError:  # the JAX exporter has no inverse for the pool's Conv1d
        assert spec.pool_type == "linear"
        sd = {k: v.numpy() for k, v in export_state_dict(tp, spec).items()}
    for k in derived_keys(spec):
        sd[k] = np.zeros((1, 256), np.int64)
    loaded = load_state_dict(sd, spec)
    assert set(loaded) == set(tp)
    for k in tp:
        torch.testing.assert_close(loaded[k], tp[k], atol=0, rtol=0)
    back = export_state_dict(tp, spec)
    assert set(back) == set(sd) - set(derived_keys(spec))
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(sd[k]), err_msg=k)
    again = convert_torch_state_dict({k: v.numpy() for k, v in back.items()},
                                     jm.spec, template=jp)
    stored, _ = build_key_map(spec)
    for k, (path, kind) in stored.items():
        np.testing.assert_array_equal(np.asarray(_get_path(again, path)),
                                      np.asarray(_get_path(jp, path)),
                                      err_msg=k)


def test_init_params_has_the_key_map_layout():
    """The port's own init draws every zoo parameter, shaped as the key
    map's (the JAX tree's) for the ViT, the ResNet and every family."""
    for name in ["vit", "resnet"] + sorted(FAMILIES):
        jm, jp, spec, tp = _built(name)
        mine = TM.init_params(spec, torch.Generator().manual_seed(0))
        assert set(mine) == set(tp), name
        for k, v in mine.items():
            assert v.shape == tp[k].shape, (name, k)


# ---------------------------------------------------------------------------
# b32.yaml and the RN50 geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["vit", "resnet"])
def test_plain_clip_towers_match_jax(name):
    """The patchify ViT and the ModifiedResNet, each with its own text
    tower of another width (nothing shared)."""
    jm, jp, spec, tp = _built(name)
    assert not any(spec.text_layer_is_shared(i)
                   for i in range(spec.text_layers))
    images, tokens = inputs()
    for encode, port, x in ((jm.encode_image, TM.encode_image, images),
                            (jm.encode_text, TM.encode_text, tokens)):
        want = jax.jit(encode)(jp, jnp.asarray(x))
        got = port(tp, spec, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_rn50_config_builds_jax_s_spec():
    """``msclip_torch/config/rn50.json`` and the overrides over b32.yaml
    (the port's config lets ``VISION.LAYERS`` turn into a list) give the
    spec JAX builds from b32.yaml with the list set as an attribute."""
    cfg = get_default_config()
    update_config(cfg, os.path.join(REPO, "msclip_torch", "config",
                                    "rn50.json"))
    over = get_default_config()
    update_config(over, B32_YAML, opts=[
        "MODEL.SPEC.VISION.LAYERS", "[3,4,6,3]", "MODEL.SPEC.VISION.WIDTH",
        "64", "MODEL.SPEC.EMBED_DIM", "1024"])
    jcfg = jax_default_config()
    jax_update_config(jcfg, B32_YAML)
    jcfg.MODEL.SPEC.VISION.LAYERS = [3, 4, 6, 3]
    jcfg.MODEL.SPEC.VISION.WIDTH = 64
    jcfg.MODEL.SPEC.EMBED_DIM = 1024
    jspec = jax_build_model(jcfg).spec
    for c in (cfg, over):
        spec = TM.spec_from_config(c)
        assert (spec.vision_resnet_layers, spec.vision_heads, spec.embed_dim,
                spec.text_width, spec.text_heads) == \
            (jspec.vision_resnet_layers, jspec.vision_heads, jspec.embed_dim,
             jspec.text_width, jspec.text_heads) == ((3, 4, 6, 3), 32, 1024,
                                                     512, 8)
        stored, aliases = build_key_map(spec)
        assert set(stored) | set(aliases) == set(jax_build_key_map(jspec))


@pytest.mark.parametrize("name", ["gumbel", "window", "resnet", "vit"])
def test_bundle_manifest_spec_round_trips(name):
    """A bundle's manifest carries the zoo spec, the nested switches of
    the extension families too."""
    spec = _built(name)[2]
    back = spec_from_json(json.loads(json.dumps(dataclasses.asdict(spec))))
    assert back == spec


def _takes_model_group(spec, key):
    """Is ``key`` in a block that ``encode_image``/``encode_text`` run
    with the tensor-parallel model group (a plain transformer block)?"""
    m = re.match(r"(visual\.)?transformer\.resblocks\.(\d+)\.", key)
    return m is not None and not spec.ext.block_has_any(
        "visual" if m.group(1) else "text", int(m.group(2)))


@pytest.mark.parametrize("name", ["vit", "resnet"] + sorted(FAMILIES))
def test_tensor_parallelism_builds_only_where_every_cut_block_takes_it(name):
    """``TPU.MESH_MODEL 2`` cuts every tensor ``param_dim`` names to one
    process's part. A config builds with it only if each cut tensor lies
    in a block that gets the model group and all-reduces; a config with a
    cut tensor anywhere else is refused."""
    cfg = {"vit": vit_config, "resnet": resnet_config}.get(
        name, functools.partial(family_config, name))()
    spec = TM.spec_from_config(cfg)
    params = TM.init_params(spec, torch.Generator().manual_seed(0))
    elsewhere = sorted(k for k, v in params.items()
                       if param_dim(k, tuple(v.shape)) is not None
                       and not _takes_model_group(spec, k))
    cfg.TPU.MESH_MODEL = 2
    if elsewhere:
        with pytest.raises(ValueError, match="tensor parallelism"):
            TM.spec_from_config(cfg)
    else:
        assert TM.spec_from_config(cfg) == spec
    # the refused families are the plug-in blocks and the Perceiver
    assert bool(elsewhere) == (spec.ext.any_active or spec.perceiver_in_v
                               or spec.perceiver_in_t)


@pytest.fixture(scope="module")
def b32_checkpoint(tmp_path_factory):
    """Random weights at the tiny b32.yaml geometry, exported by the JAX
    package in the reference layout."""
    _, jcfg = _b32()
    jm = jax_build_model(jcfg)
    sd = export_torch_state_dict(random_jax_params(jm, seed=0), jm.spec)
    path = tmp_path_factory.mktemp("b32") / "model.pth"
    torch.save({k: torch.tensor(np.array(v)) for k, v in sd.items()}, path)
    return path


def test_b32_zero_shot_matches_jax(b32_checkpoint, tmp_path):
    """``run_zero_shot`` on b32.yaml cut to size, both packages in
    process on the same synthetic images and checkpoint: the same top-1,
    image by image."""
    opts = ["MODEL.PRETRAINED_MODEL", str(b32_checkpoint),
            "DATASET.DATASET", "synthetic", "DATASET.NUM_SAMPLES", "10",
            "DATASET.NUM_CLASSES", "10"]
    cfg, jcfg = get_default_config(), jax_default_config()
    for c, update, out in ((cfg, update_config, "port"),
                           (jcfg, jax_update_config, "jax")):
        update(c, DS_YAML)
        update(c, B32_YAML, opts=TINY_B32 + opts + [
            "TEST.SAVE_PRED", str(tmp_path / f"{out}.npz")])
    value, stats = ZS.run_zero_shot(cfg, device="cpu")
    want, jstats = JZ.run_zero_shot(jcfg)
    assert stats["n_images"] == jstats["n_images"] == 10
    assert value == want
    port, jax_res = (np.load(tmp_path / f"{n}.npz") for n in ("port", "jax"))
    np.testing.assert_array_equal(port["pred"], jax_res["pred"])


def test_b32_train_step_matches_jax():
    """One step's loss and every gradient at the tiny b32.yaml geometry
    (fp32: loss within 1e-5, gradients within 1e-5 of their tensor's
    largest, ``test_torch_train``'s bounds)."""
    cfg, jcfg = _b32()
    jm = jax_build_model(jcfg)
    jp = random_jax_params(jm, seed=1)
    spec = TM.spec_from_config(cfg)
    rng = np.random.default_rng(4)
    images = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    tokens = rng.integers(1, 49407, (4, 77)).astype(np.int32)
    tokens[:, 20] = 49407
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(jm.spec), has_aux=True))(
        jp, jnp.asarray(images), jnp.asarray(tokens))
    model = TM.MSClipModel(spec, params_from_jax(jp, spec), trainable=True)
    loss, _ = TT.make_loss_fn(spec)(model.params(), torch.from_numpy(images),
                                    torch.from_numpy(tokens))
    loss.backward()
    assert math.isfinite(loss.item())
    assert abs(loss.item() - float(jloss)) <= 1e-5
    stored, _ = build_key_map(spec)
    for key, p in model.named_parameters():
        path, kind = stored[key]
        want = _from_jax(_get_path(jgrads, path), kind)
        bound = 1e-5 * max(1.0, want.abs().max().item())
        assert (p.grad - want).abs().max().item() <= bound, key


# ---------------------------------------------------------------------------
# Gumbel NAS
# ---------------------------------------------------------------------------

def _given(a):
    """``gumbel_action`` stand-ins for both packages that return the hard
    action ``a`` with the straight-through gradient of ``softmax(logits /
    tau)``."""
    def jax_fn(logits, rng=None, tau=5.0):
        y = jax.nn.softmax(logits.astype(jnp.float32) / tau, axis=-1)
        return jax.lax.stop_gradient(jnp.asarray(a) - y) + y

    def port_fn(logits, generator=None, tau=5.0):
        y = (logits.float() / tau).softmax(dim=-1)
        return (torch.from_numpy(a).to(y.device) - y).detach() + y

    return jax_fn, port_fn


def test_gumbel_steps_on_a_given_action_match_jax(monkeypatch):
    """Two full train steps of the Gumbel config on one given action (the
    shared branch in some blocks, the specific one in others): the
    losses, the gradient norms, the Gumbel logits after the ``arch``
    group's AdamW at ``GUMBEL_LR`` and a trunk tensor after the steps
    (1e-5: gradients that agree to 2e-5 of themselves, through two AdamW
    steps of 5e-2)."""
    cfg = family_config("gumbel")
    cfg.TRAIN.LR = 1e-3
    cfg.CUSTOM.GUMBEL_LR = 5e-2
    jm = jax_build_model(cfg)
    jp = random_jax_params(jm, seed=2)
    spec = TM.spec_from_config(cfg)
    jax_fn, port_fn = _given(action(spec.vision_layers))
    monkeypatch.setattr(JM, "gumbel_action", jax_fn)
    monkeypatch.setattr(TT, "gumbel_action", port_fn)
    tx, _ = JO.build_optimizer(cfg, jp, jm.spec, STEPS_PER_EPOCH)
    jstate = jax_init_state(jm, tx, params=jax.tree.map(jnp.asarray, jp))
    jstep = jax_make_train_step(jm.spec, tx, donate=False)
    state = TT.init_train_state(cfg, spec, params_from_jax(jp, spec),
                                STEPS_PER_EPOCH, "cpu")
    assert "arch" in {g["name"] for g in state.optimizer.param_groups}
    labels = TO.param_labels(state.model.params(), spec)
    assert [k for k, v in labels.items() if v == "arch"] == ["gumbel_logit"]
    step = TT.make_train_step(spec)
    for i in range(2):
        images, tokens = inputs(seed=20 + i, batch=4)
        jstate, jmet = jstep(jstate, jnp.asarray(images), jnp.asarray(tokens))
        metrics = step(state, torch.from_numpy(images),
                       torch.from_numpy(tokens))
        assert abs(metrics["loss"].item() - float(jmet["loss"])) <= 1e-4, i
        np.testing.assert_allclose(metrics["grad_norm"].item(),
                                   float(jmet["grad_norm"]), rtol=1e-4)
    # the last layer's action scales the tokens that ln_post / ln_final
    # normalize: its gradient is zero but for rounding (1e-10 here), which
    # AdamW's 1 / (|g| + 1e-8) blows up, so it is left out
    params = state.model.params()
    got = params["gumbel_logit"].detach().numpy()[:-1]
    np.testing.assert_allclose(
        got, np.asarray(jstate.params["gumbel_logit"])[:-1], atol=1e-5)
    assert np.abs(got - jp["gumbel_logit"][:-1]).min() > 1e-2
    stored, _ = build_key_map(spec)
    for key in ("visual.transformer.resblocks.2.specific_mlp.c_fc.weight",
                "visual.transformer.resblocks.3.attn.in_proj_weight"):
        path, kind = stored[key]
        np.testing.assert_allclose(
            params[key].detach().numpy(),
            _from_jax(_get_path(jstate.params, path), kind).numpy(),
            atol=1e-5, err_msg=key)


def test_gumbel_train_step_draws_one_action_a_step(monkeypatch):
    """The train step draws the action from the step's own generator (one
    a step, the same under GradCache's two passes and every microbatch),
    and the same seed and step draw the same action."""
    cfg = family_config("gumbel")
    jm, jp, spec, tp = _built("gumbel")
    seen = []
    real = TT.gumbel_action

    def spy(logits, generator=None, tau=5.0):
        out = real(logits, generator, tau)
        seen.append(out.detach().clone())
        return out

    monkeypatch.setattr(TT, "gumbel_action", spy)
    images, tokens = inputs(batch=4)
    for accum in (1, 2):
        state = TT.init_train_state(cfg, spec, dict(tp), STEPS_PER_EPOCH,
                                    "cpu")
        TT.make_train_step(spec, accum_steps=accum, seed=7)(
            state, torch.from_numpy(images), torch.from_numpy(tokens))
    assert len(seen) == 1 + 2 * 2  # one step; two passes of two microbatches
    for a in seen[1:]:
        assert torch.equal(a, seen[0])
    assert set(seen[0].round().sum(dim=1).tolist()) == {1.0}


# ---------------------------------------------------------------------------
# introspection taps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("name", ["msclips", "vit"])
def test_taps_match_jax(name, raw):
    """Every block's output and attention maps (softmax or raw scores),
    and the features, of both towers."""
    if name == "vit":
        jm, jp, spec, tp = _built("vit")
    else:
        jm, jp, spec, tp = build(tiny_msclips_config(layers=4))
    images, tokens = inputs()
    for jfn, tfn, x in ((JI.encode_image_with_taps, TI.encode_image_with_taps,
                         images),
                        (JI.encode_text_with_taps, TI.encode_text_with_taps,
                         tokens)):
        want, wtaps = jax.jit(lambda p, v: jfn(p, jm.spec, v, raw_attn=raw))(
            jp, jnp.asarray(x))
        got, taps = tfn(tp, spec, torch.from_numpy(x), raw_attn=raw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        for key in ("layer_features", "attn_maps"):
            w = np.asarray(wtaps[key])
            assert taps[key].shape == w.shape
            np.testing.assert_allclose(
                taps[key].numpy(), w,
                atol=ATOL * max(1.0, float(np.abs(w).max())), err_msg=key)


def test_taps_refuse_the_resnet_tower():
    _, _, spec, tp = _built("resnet")
    with pytest.raises(NotImplementedError, match="transformer"):
        TI.encode_image_with_taps(tp, spec, torch.zeros(1, 64, 64, 3))


# ---------------------------------------------------------------------------
# int8 eval on the zoo
# ---------------------------------------------------------------------------

def test_int8_b32_quantizes_as_jax_and_runs():
    """b32.yaml's towers quantize to the JAX package's int8 tensors and
    run; their features stay within int8's reach of the fp32 ones."""
    jm, jp, spec, tp = _built("vit")
    mine = quantize_params_for_eval(tp, spec)
    theirs = params_from_jax(jax.tree.map(np.asarray, jax_quant(jp, jm.spec)),
                             spec)
    assert set(mine) == set(theirs)
    assert sum(v.dtype == torch.int8 for v in mine.values()) == 4 * (
        spec.vision_layers + spec.text_layers)
    for k in mine:
        torch.testing.assert_close(mine[k], theirs[k], atol=0, rtol=0)
    images, tokens = inputs()
    for fn, x in ((TM.encode_image, images), (TM.encode_text, tokens)):
        q, f = (fn(p, spec, torch.from_numpy(x)) for p in (mine, tp))
        assert torch.isfinite(q).all()
        assert (q - f).abs().max().item() < 0.05


@pytest.mark.parametrize("name", ["resnet", "adapter", "gumbel"])
def test_int8_refuses_where_jax_does(name):
    """The ResNet tower has no trunk blocks and the extension families
    keep full precision: the JAX package's quantizer fails on both, and
    the port's raises."""
    jm, jp, spec, tp = _built(name)
    with pytest.raises((ValueError, KeyError)):
        jax_quant(jp, jm.spec)
    with pytest.raises(ValueError, match="INT8_EVAL"):
        quantize_params_for_eval(tp, spec)


# ---------------------------------------------------------------------------
# full width
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_full_width_b32_yaml_towers_match_jax():
    """b32.yaml at its published widths: ViT-B/32 (12 blocks at 768, L =
    50) and the 512-wide, 8-head text tower, fp32."""
    cfg, jcfg = get_default_config(), jax_default_config()
    update_config(cfg, B32_YAML)
    jax_update_config(jcfg, B32_YAML)
    jm = jax_build_model(jcfg)
    jp = random_jax_params(jm, seed=0)
    spec = TM.spec_from_config(cfg)
    tp = params_from_jax(jp, spec)
    images, tokens = inputs(image=224, vocab=49408, batch=2)
    for encode, port, x in ((jm.encode_image, TM.encode_image, images),
                            (jm.encode_text, TM.encode_text, tokens)):
        want = jax.jit(encode)(jp, jnp.asarray(x))
        got = port(tp, spec, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

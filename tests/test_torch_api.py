"""The port's public API that the JAX package exports beside its models:
the tokenizer's word-position and decode methods, the prompt registries,
the config node's yacs methods, ``build_model``/``param_count`` and the
package exports, each against its JAX counterpart on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

import jax

import msclip_tpu.config as jax_config
import msclip_tpu.data as jax_data
import msclip_tpu.models as jax_models
from msclip_torch import config as port_config
from msclip_torch import data as port_data
from msclip_torch import models as port_models

from reference_oracle import tiny_msclips_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(os.path.dirname(__file__), "golden_tokens.json")
B32 = os.path.join(REPO, "experiments", "model", "b32-yfcc-msclips.yaml")


@pytest.fixture(scope="module")
def toks():
    return jax_data.ClipTokenizer(), port_data.ClipTokenizer()


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

def test_vocab_size_and_the_simple_tokenizer_alias(toks):
    jt, pt = toks
    assert pt.vocab_size == jt.vocab_size == 49408
    assert port_data.SimpleTokenizer is port_data.ClipTokenizer
    from msclip_torch.data.tokenizer import SimpleTokenizer

    assert SimpleTokenizer is port_data.ClipTokenizer


def test_decode_round_trips_golden_ids(toks):
    """Every golden text's ids (the reference tokenizer's) decode to the
    same string in both packages, and that string encodes back to the
    same ids."""
    jt, pt = toks
    with open(GOLDEN) as f:
        golden = json.load(f)
    for text, ids in golden.items():
        body = [i for i in ids if i not in (0, pt.sot_token, pt.eot_token)]
        got = pt.decode(body)
        assert got == jt.decode(body), text
        assert pt.encode(got) == body, text  # the round trip
        # with the frame tokens kept: the same string on both sides
        framed = [i for i in ids if i]
        assert pt.decode(np.asarray(framed)) == jt.decode(framed)


def test_decode_replaces_bytes_it_cannot_read(toks):
    """A lone continuation byte decodes to U+FFFD in both packages."""
    jt, pt = toks
    lone = pt.encoder[pt.byte_encoder[0x80]]
    assert pt.decode([lone]) == jt.decode([lone]) == "�"


# (text, word indices): multi-token words before and after the indices,
# a hyphenated word, a repeated word (the nearest hit wins), cleaning
# that changes the word count (doubled and edge spaces, punctuation
# split off, an HTML entity), and a text past the 77-token context
IDX_CASES = [
    ("a photograph of a dog", [1, 4]),
    ("an extraordinarily photogenic dog beside a skateboard", [0, 3, 6]),
    ("the dog chased the other dog in the park", [1, 5]),
    ("a well-known dog sat on a mat", [1, 2]),
    ("a  photo   of the cat  ", [1, 4]),
    ("the cat, the dog, and the cat.", [1, 6]),
    ("the  dog chased the other dog", [2, 6]),
    ("rock &amp; roll dogs", [0, 3]),
    ("a dog-friendly cafe near a dog park", [1, 5]),
    (" ".join(["photograph"] * 40) + " of a dog", [2, 43]),
]


@pytest.mark.parametrize("text,idxs", IDX_CASES)
def test_encode_with_idx_matches_jax(toks, text, idxs):
    jt, pt = toks
    assert pt.encode_with_idx(text, idxs) == jt.encode_with_idx(text, idxs)


@pytest.mark.parametrize("text,idxs", IDX_CASES)
def test_tokenize_with_idx_matches_jax(toks, text, idxs):
    jt, pt = toks
    got, got_idx = pt.tokenize_with_idx(text, input_idxs=idxs)
    want, want_idx = jt.tokenize_with_idx([text], input_idxs=idxs)
    assert got.shape == (1, 77) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got_idx == want_idx
    # the positions index the tokens of their words (where in the context)
    ids, _ = pt.encode_with_idx(text, idxs)
    if len(ids) + 2 <= 77:
        assert got[0, len(ids) + 1] == pt.eot_token
    else:  # truncated at 77: the EOT is cut off
        assert pt.eot_token not in got[0]


def test_tokenize_with_idx_without_indices(toks):
    jt, pt = toks
    got, idx = pt.tokenize_with_idx(["a photo of a cat."])
    want, want_idx = jt.tokenize_with_idx(["a photo of a cat."])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pt.tokenize("a photo of a cat."))
    assert idx == want_idx == []


# ---------------------------------------------------------------------------
# prompt registries
# ---------------------------------------------------------------------------

def test_available_datasets_match_jax():
    from msclip_tpu.data.prompts import available_datasets

    got = port_data.available_datasets()
    assert got == available_datasets() and "imagenet" in got


@pytest.mark.parametrize("kind", ["ALL_CLASSES_DICT", "ALL_TEMPLATES_DICT"])
def test_lazy_registries_match_jax(kind):
    mine, theirs = getattr(port_data, kind), getattr(jax_data, kind)
    assert sorted(mine.keys()) == sorted(theirs.keys())
    for name in theirs.keys():
        assert name in mine
        assert mine[name] == theirs[name]
    assert "no such dataset" not in mine
    with pytest.raises(KeyError):
        mine["no such dataset"]


# ---------------------------------------------------------------------------
# config node
# ---------------------------------------------------------------------------

def _open_flags(node, path=""):
    return {path: node.is_open, **{
        k: v for key, sub in node.items() if hasattr(sub, "is_open")
        for k, v in _open_flags(sub, f"{path}.{key}").items()}}


def test_clone_is_deep():
    """Both packages' clones hold the same values and share no mutable
    part with the original. The port's keeps every node's open flag;
    JAX's (``copy.deepcopy``, which rebuilds the dict from the ``items``
    that hide the flag) closes every node."""
    clones = {}
    for name, pkg in (("port", port_config), ("jax", jax_config)):
        cfg = pkg.get_default_config()
        copy = cfg.clone()
        assert copy.to_dict() == cfg.to_dict() and copy is not cfg
        copy.TRAIN.LR = 1.0
        copy.MODEL.NAME = "another"
        copy.TEST.IMAGE_SIZE.append(7)
        assert cfg.TRAIN.LR != 1.0
        assert cfg.MODEL.NAME != "another"
        assert 7 not in cfg.TEST.IMAGE_SIZE
        clones[name] = (cfg, copy)
    cfg, copy = clones["port"]
    assert _open_flags(copy) == _open_flags(cfg)
    assert copy.MODEL.is_open and not copy.TRAIN.is_open
    copy.merge_from_list(["MODEL.SPEC.NEW_KEY", "1"])  # still open
    assert not any(_open_flags(clones["jax"][1]).values())


def test_set_open_returns_the_node_and_admits_new_keys():
    from msclip_torch.config.node import CfgNode
    from msclip_tpu.config.node import CfgNode as JaxNode

    for cls in (CfgNode, JaxNode):
        node = cls({"A": 1})
        with pytest.raises(KeyError):
            node.merge_from_list(["B", "2"])
        assert node.set_open() is node and node.is_open
        node.merge_from_list(["B", "2", "C.D", "x"])
        node.merge_from_dict({"E": {"F": 1}})
        assert node.to_dict() == {"A": 1, "B": 2, "C": {"D": "x"},
                                  "E": {"F": 1}}
        assert node.set_open(False) is node and not node.is_open
        with pytest.raises(KeyError):
            node.merge_from_list(["G", "3"])


def test_freeze_and_defrost_change_nothing():
    for pkg in (port_config, jax_config):
        cfg = pkg.get_default_config()
        before = cfg.clone().to_dict()
        assert cfg.freeze() is None
        assert cfg.to_dict() == before
        cfg.TRAIN.LR = 0.5  # configs stay mutable, as in the JAX package
        assert cfg.defrost() is None
        assert cfg.TRAIN.LR == 0.5
        cfg.TRAIN.LR = before["TRAIN"]["LR"]
        assert cfg.to_dict() == before


# ---------------------------------------------------------------------------
# build_model and param_count
# ---------------------------------------------------------------------------

def _jax_count(cfg):
    """JAX's ``param_count`` of ``cfg``'s model, from the shapes of
    ``init_params`` alone (``jax.eval_shape``: no weights drawn)."""
    jm = jax_models.build_model(cfg)
    return jax_models.param_count(jax.eval_shape(jm.init,
                                                 jax.random.PRNGKey(0)))


def _b32_configs():
    jcfg = jax_config.get_default_config()
    jax_config.update_config(jcfg, B32)
    cfg = port_config.get_default_config()
    port_config.update_config(cfg, B32)
    return cfg, jcfg


def test_param_count_matches_jax_tiny():
    cfg = tiny_msclips_config()
    model = port_models.build_model(cfg, device="cpu")
    assert isinstance(model, port_models.MSClipModel)
    assert model.spec == port_models.spec_from_config(cfg)
    assert port_models.param_count(model) == _jax_count(cfg)
    assert port_models.param_count(model.params()) == _jax_count(cfg)


def test_param_count_matches_jax_full_b32():
    cfg, jcfg = _b32_configs()
    model = port_models.build_model(cfg, device="cpu")
    want = _jax_count(jcfg)
    assert port_models.param_count(model) == want
    assert 100e6 < want < 200e6


def test_build_model_draws_from_the_generator():
    cfg = tiny_msclips_config()
    a = port_models.build_model(cfg, torch.Generator().manual_seed(3), "cpu")
    b = port_models.build_model(cfg, torch.Generator().manual_seed(3), "cpu")
    c = port_models.build_model(cfg, torch.Generator().manual_seed(4), "cpu")
    seeded = port_models.build_model(cfg, device="cpu")  # TPU.SEED 0
    zero = port_models.init_params(seeded.spec,
                                   torch.Generator().manual_seed(0))
    for k, v in a.params().items():
        assert torch.equal(v, b.params()[k])
        assert torch.equal(seeded.params()[k], zero[k])
    assert any(not torch.equal(v, c.params()[k])
               for k, v in a.params().items())
    assert all(v.device.type == "cpu" for v in a.params().values())


def test_build_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        port_models.build_model(tiny_msclips_config())


def test_forward_is_exported_and_matches_jax():
    """``models.forward``, the training logits, against JAX's on the same
    tiny weights (fp32)."""
    import jax.numpy as jnp

    from msclip_torch.utils.convert import params_from_jax

    from torch_port_params import random_jax_params

    cfg = tiny_msclips_config(layers=4)
    jm = jax_models.build_model(cfg)
    jp = random_jax_params(jm, seed=5)
    spec = port_models.spec_from_config(cfg)
    tp = params_from_jax(jp, spec)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((3, 64, 64, 3)).astype(np.float32)
    tokens = np.zeros((3, 77), np.int32)
    tokens[:, 0], tokens[:, 1:4], tokens[:, 4] = 510, 7, 511
    tokens[1, 2] = 9
    with torch.no_grad():
        got = port_models.forward(tp, spec, torch.from_numpy(images),
                                  torch.from_numpy(tokens))
    want = jax_models.forward(jp, jm.spec, jnp.asarray(images),
                              jnp.asarray(tokens))
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------------------
# package exports
# ---------------------------------------------------------------------------

EXPORTS = {
    "msclip_torch.data": ["SimpleTokenizer", "ClipTokenizer",
                          "ALL_CLASSES_DICT", "ALL_TEMPLATES_DICT",
                          "available_datasets", "get_classnames",
                          "get_templates"],
    "msclip_torch.models": ["build_model", "param_count", "forward",
                            "MSClipModel", "spec_from_config"],
    "msclip_torch.parallel": ["infonce_loss", "sharded_infonce_loss",
                              "chunked_sharded_infonce_loss",
                              "ring_infonce_loss", "create_mesh",
                              "mesh_from_config", "split_for_model",
                              "gather_over_model", "fsdp_dims",
                              "zero1_dims"],
    "msclip_torch.train": ["CheckpointManager", "auto_resume",
                           "restore_params", "save_params"],
    "msclip_torch.utils": ["build_key_map", "load_state_dict",
                           "export_state_dict"],
    "msclip_torch.serve": ["live_serving_model"],
    "msclip_torch.serve.live": ["local_devices"],
    "msclip_torch.config.node": ["CfgNode"],
}


@pytest.mark.parametrize("module", sorted(EXPORTS))
def test_every_new_name_imports_from_its_package(module):
    """Each name imports from its package, in a process that imported
    nothing else of the port first (the lazy exports of ``parallel`` and
    ``utils`` break the model modules' import cycle), and is the module
    function of the same name."""
    import subprocess
    import sys

    names = EXPORTS[module]
    code = (f"from {module} import {', '.join(names)}\n"
            "import sys\n"
            "assert not [m for m in sys.modules if m.startswith("
            "('jax', 'msclip_tpu'))]\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_parallel_exports_are_the_jax_names():
    import msclip_torch.parallel as P
    from msclip_torch.parallel import infonce, mesh

    from msclip_tpu import parallel as JP

    for name in ("infonce_loss", "sharded_infonce_loss",
                 "chunked_sharded_infonce_loss", "ring_infonce_loss",
                 "create_mesh", "mesh_from_config"):
        assert name in JP.__all__ and name in P.__all__
    assert P.ring_infonce_loss is infonce.ring_infonce_loss
    assert P.zero1_dims is mesh.zero1_dims
    with pytest.raises(AttributeError):
        P.batch_sharding  # a NamedSharding: no torch counterpart


def test_infonce_export_matches_jax():
    """``parallel.infonce_loss`` against JAX's on the same features."""
    import jax.numpy as jnp

    from msclip_torch.parallel import infonce_loss
    from msclip_tpu.parallel import infonce_loss as jax_infonce

    rng = np.random.default_rng(1)
    fi = rng.standard_normal((6, 16)).astype(np.float32)
    ft = rng.standard_normal((6, 16)).astype(np.float32)
    fi /= np.linalg.norm(fi, axis=-1, keepdims=True)
    ft /= np.linalg.norm(ft, axis=-1, keepdims=True)
    got = infonce_loss(torch.from_numpy(fi), torch.from_numpy(ft),
                       torch.tensor(2.5))
    want = jax_infonce(jnp.asarray(fi), jnp.asarray(ft), jnp.float32(2.5))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

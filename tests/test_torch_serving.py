"""The port's serving (``msclip_torch.serve`` and its CLIs) against the JAX
package's (``msclip_tpu.serve``) on the same parameters, fp32 on the CPU:
bundle export and load, bucket padding, the host crop, the batcher, every
HTTP route, live serving, a concurrent burst, and both CLIs as
subprocesses."""

import base64
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from msclip_tpu.models import build_model as jax_build_model
from msclip_tpu.models.folding import fold_params_for_eval as jax_fold
from msclip_tpu.serve import export_bundle as jax_export_bundle
from msclip_tpu.serve import load_bundle as jax_load_bundle
from msclip_tpu.serve import pil_to_uint8 as jax_pil_to_uint8
from msclip_tpu.serve.server import InferenceServer as JaxInferenceServer
from msclip_torch.data.transforms import normalize_uint8
from msclip_torch.models import msclip as TM
from msclip_torch.serve import (
    DynamicBatcher,
    export_bundle,
    live_serving_model,
    load_bundle,
    pil_to_uint8,
)
from msclip_torch.serve.export import serving_params
from msclip_torch.serve.server import InferenceServer, _decode_image
from msclip_torch.utils.convert import params_from_jax

from reference_oracle import tiny_msclips_config
from torch_port_params import random_jax_params
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64  # tiny_msclips_config's image size
BUCKETS = (2, 4)
ATOL = 1e-5  # fp32 features, as tests/test_serving.py
HTTP_ATOL = 1e-4  # JSON floats, as tests/test_serving.py
N_CLASSES = 7
# the tiny geometry of the JAX CLI test (tests/test_serving.py), on the
# port's B/32 config
CLI_TINY = [
    "TRAIN.IMAGE_SIZE", "[64,64]", "TEST.IMAGE_SIZE", "[64,64]",
    "MODEL.SPEC.VISION.WIDTH", "128", "MODEL.SPEC.VISION.LAYERS", "2",
    "MODEL.SPEC.TEXT.WIDTH", "128", "MODEL.SPEC.TEXT.HEADS", "2",
    "MODEL.SPEC.TEXT.LAYERS", "2", "MODEL.SPEC.EMBED_DIM", "32",
]
B32_JSON = os.path.join(REPO, "msclip_torch", "config",
                        "b32-yfcc-msclips.json")


@pytest.fixture(scope="module")
def tiny():
    """``(jax model, folded jax params, port spec, port params)``: the
    same numpy weights behind both packages (the full vocabulary, so raw
    strings tokenize)."""
    cfg = tiny_msclips_config(layers=4, vocab_size=49408)
    jm = jax_build_model(cfg)
    jp = random_jax_params(jm, seed=0)
    spec = TM.spec_from_config(cfg)
    tp = params_from_jax(jp, spec)
    jp = jax.jit(lambda p: jax_fold(p, jm.spec))(jp)
    return jm, jp, spec, tp


@pytest.fixture(scope="module")
def classifier(tiny):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((tiny[0].spec.embed_dim, N_CLASSES)).astype(
        np.float32)
    return w / np.linalg.norm(w, axis=0, keepdims=True)


@pytest.fixture(scope="module")
def bundles(tiny, classifier, tmp_path_factory):
    """The port's and the JAX package's bundles of the same weights."""
    jm, jp, spec, tp = tiny
    out = tmp_path_factory.mktemp("bundles")
    names = [f"class {i}" for i in range(N_CLASSES)]
    export_bundle(spec, tp, str(out / "torch"), buckets=BUCKETS,
                  image_size=SIZE, classifier=classifier, classnames=names)
    jax_export_bundle(jm, jp, str(out / "jax"), buckets=BUCKETS,
                      image_size=SIZE, classifier=classifier,
                      classnames=names)
    return str(out / "torch"), str(out / "jax")


@pytest.fixture(scope="module")
def served(bundles):
    return load_bundle(bundles[0], device="cpu"), jax_load_bundle(bundles[1])


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)


def _tokens(n, seed, vocab=49408):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((n, 77), np.int32)
    for i in range(n):
        k = int(rng.integers(5, 20))
        tokens[i, 0] = vocab - 2
        tokens[i, 1:k] = rng.integers(1, vocab - 2, k - 1)
        tokens[i, k] = vocab - 1
    return tokens


def _jpeg(seed, shape=(40, 56, 3)):
    from PIL import Image

    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(
        buf, format="JPEG", quality=95)
    return buf.getvalue()


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def test_export_load_roundtrip_matches_jax(tiny, served):
    """Image features, text features from token ids and from raw strings,
    and classify logits: the port's bundle against the JAX package's on the
    same uint8 crops and tokens, fp32."""
    _, _, spec, _ = tiny
    port, ref = served
    assert port.buckets == ref.buckets == list(BUCKETS)
    assert port.embed_dim == ref.embed_dim == spec.embed_dim
    assert port.classnames == ref.classnames
    images = _images(4, 1)
    np.testing.assert_allclose(port.encode_image(images),
                               ref.encode_image(images), atol=ATOL, rtol=ATOL)
    tokens = _tokens(2, 2)
    np.testing.assert_allclose(port.encode_text(tokens),
                               ref.encode_text(tokens), atol=ATOL, rtol=ATOL)
    texts = ["a photo of a cat", "a dog", "a red square"]
    np.testing.assert_allclose(port.encode_text(texts),
                               ref.encode_text(texts), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(port.encode_text(texts[0]),
                               ref.encode_text(texts[0]), atol=ATOL,
                               rtol=ATOL)
    # logits are 100 x feats @ W: held on the features' scale, and their
    # ranking (argmax and top 5) to JAX's, which a transposed or misordered
    # classifier cannot meet within that limit
    got, want = port.classify(images), ref.classify(images)
    np.testing.assert_allclose(got / 100, want / 100, atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_array_equal(np.argsort(-got, 1)[:, :5],
                                  np.argsort(-want, 1)[:, :5])


def test_bucket_padding_equivalence(tiny, served):
    """N = 1, 3 (2 + padded 1) and 7 (4 + padded 3) equal the towers called
    on the unpadded batch: padding rows never leak into real rows; and
    the JAX bundle's rows."""
    _, _, spec, tp = tiny
    params = serving_params(spec, tp)
    port, ref = served
    for n in (1, 3, 7):
        images = _images(n, 10 + n)
        got = port.encode_image(images)
        assert got.shape == (n, spec.embed_dim) and got.dtype == np.float32
        want = TM.encode_image(params, spec,
                               normalize_uint8(torch.from_numpy(images)))
        np.testing.assert_allclose(got, want.numpy(), atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(got, ref.encode_image(images), atol=ATOL,
                                   rtol=ATOL)
        tokens = _tokens(n, 20 + n)
        np.testing.assert_allclose(port.encode_text(tokens),
                                   ref.encode_text(tokens), atol=ATOL,
                                   rtol=ATOL)
    assert port.encode_image(np.zeros((0, SIZE, SIZE, 3), np.uint8)).shape \
        == (0, spec.embed_dim)


@pytest.mark.parametrize("shape", [(50, 41), (41, 50), (31, 97), (300, 7),
                                   (64, 64), (17, 17)])
def test_pil_to_uint8_matches_jax_bitwise(shape):
    from PIL import Image

    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    img = Image.fromarray(rng.integers(0, 256, shape + (3,), dtype=np.uint8))
    for size in (SIZE, 33):
        got = pil_to_uint8(img, size)
        assert got.shape == (size, size, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jax_pil_to_uint8(img, size))


def test_each_package_refuses_the_others_bundle(bundles):
    port_dir, jax_dir = bundles
    with pytest.raises(ValueError, match="msclip_tpu"):
        load_bundle(jax_dir, device="cpu")
    with pytest.raises(ValueError, match="unsupported bundle format"):
        jax_load_bundle(port_dir)
    manifest = json.load(open(os.path.join(port_dir, "MANIFEST.json")))
    for key in ("buckets", "image_size", "context_length", "embed_dim",
                "mean", "std", "files", "classifier", "classnames"):
        assert key in manifest, key


def test_bundle_holds_folded_fp32_weights_and_the_fused_switch(tiny,
                                                                tmp_path):
    """Unfolded parameters are folded at export, stored in fp32, and cast to
    the spec's compute dtype at load; ``use_fused_block`` rides in the spec
    (its plain K5 on the CPU, the same rows as the towers run fused);
    int8-quantized weights are refused."""
    import dataclasses

    from msclip_torch.models.quantize import quantize_params_for_eval

    _, _, spec, tp = tiny
    fused = dataclasses.replace(spec, use_fused_block=True)
    export_bundle(fused, tp, str(tmp_path / "b"), buckets=(2,),
                  image_size=SIZE)
    with np.load(tmp_path / "b" / "params.npz") as z:
        assert all(z[k].dtype == np.float32 for k in z.files)
        assert not any(TM.is_bn_stat(k) for k in z.files)
    served = load_bundle(str(tmp_path / "b"), device="cpu")
    images = _images(2, 3)
    params = serving_params(spec, tp)
    want = TM.encode_image(params, fused,
                           normalize_uint8(torch.from_numpy(images)))
    np.testing.assert_array_equal(served.encode_image(images), want.numpy())
    with pytest.raises(ValueError, match="INT8_EVAL"):
        export_bundle(spec, quantize_params_for_eval(params, spec),
                      str(tmp_path / "q"))
    # an MSClipModel exports its own parameters
    export_bundle(TM.MSClipModel(fused, tp), None, str(tmp_path / "m"),
                  buckets=(2,), image_size=SIZE)
    with np.load(tmp_path / "b" / "params.npz") as a, \
            np.load(tmp_path / "m" / "params.npz") as m:
        assert sorted(a.files) == sorted(m.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], m[k])


def test_export_from_a_config_ignores_int8_eval(tmp_path):
    """A config with ``TPU.INT8_EVAL True`` exports the same full-precision
    bundle as without it, as the JAX export tool does."""
    from msclip_torch.config import get_default_config, update_config

    dirs = []
    for int8 in (False, True):
        cfg = get_default_config()
        update_config(cfg, B32_JSON, opts=CLI_TINY + [
            "MODEL.PRETRAINED_MODEL", "", "TPU.INT8_EVAL", str(int8)])
        dirs.append(str(tmp_path / str(int8)))
        export_bundle(cfg, None, dirs[-1], buckets=(1,))
    with np.load(os.path.join(dirs[0], "params.npz")) as a, \
            np.load(os.path.join(dirs[1], "params.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert not any(k.endswith("_int8") for k in b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_dynamic_batcher_coalesces_and_routes():
    calls = []

    def fn(batch):
        calls.append(batch.shape[0])
        time.sleep(0.02)  # let concurrent submitters queue up
        return batch.sum(axis=1, keepdims=True)

    b = DynamicBatcher(fn, max_batch=8, max_wait_ms=100.0)
    try:
        futs = [b.submit(np.full((3,), i, np.float32)) for i in range(16)]
        for i, f in enumerate(futs):
            r = f.result(timeout=10)
            assert r.shape == (1,) and r[0] == 3.0 * i
        stats = b.stats
        assert stats["requests"] == 16 and stats["samples"] == 16
        assert stats["batches"] <= 8 and stats["batches"] == len(calls)
        assert max(calls) <= 8
    finally:
        b.close()


def test_dynamic_batcher_propagates_errors():
    def fn(batch):
        raise RuntimeError("device exploded")

    b = DynamicBatcher(fn, max_batch=4, max_wait_ms=1.0)
    try:
        futs = [b.submit(np.zeros((2,), np.float32)) for _ in range(3)]
        for fut in futs:
            with pytest.raises(RuntimeError, match="device exploded"):
                fut.result(timeout=10)
        # the worker survives a failed batch
        with pytest.raises(RuntimeError):
            b.submit(np.zeros((2,), np.float32)).result(timeout=10)
    finally:
        b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(np.zeros((2,), np.float32))


def test_decode_image_rejects_bad_npy_shapes():
    ok = _decode_image(_npy(np.zeros((SIZE, SIZE, 3), np.uint8)), "npy",
                       SIZE)
    assert ok.shape == (SIZE, SIZE, 3)
    resized = _decode_image(_npy(np.zeros((20, 30, 3), np.uint8)),
                            "application/npy", SIZE)
    assert resized.shape == (SIZE, SIZE, 3)
    for bad in [np.zeros((SIZE, SIZE, 4), np.uint8),
                np.zeros((SIZE, SIZE, 1), np.uint8),
                np.zeros((SIZE, SIZE), np.uint8),
                np.zeros((SIZE, SIZE, 3), np.float32)]:
        with pytest.raises(ValueError):
            _decode_image(_npy(bad), "npy", SIZE)


def _request(url, body=None, content_type="application/json"):
    """``(status, json)`` of a GET (no body) or POST."""
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _assert_json_close(got, want, path="$"):
    """Same structure; numbers within HTTP_ATOL, everything else equal."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_json_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_json_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= HTTP_ATOL * (1 + abs(want)), (path, got,
                                                                  want)
    else:
        assert got == want, (path, got, want)


def _route_requests():
    """``(method path, body, content type)`` for every route, the 400s and
    the 404s."""
    jpeg = _jpeg(4)
    rank = json.dumps({"texts": ["a photo of a cat", "a photo of a dog",
                                 "a red square"],
                       "image": base64.b64encode(jpeg).decode(),
                       "content_type": "image/jpeg"}).encode()
    return [
        ("/healthz", None, ""),
        ("/v1/embed/image", jpeg, "image/jpeg"),
        ("/v1/embed/image", _npy(_images(1, 5)[0]), "application/npy"),
        ("/v1/embed/image", _npy(np.zeros((SIZE, SIZE, 4), np.uint8)),
         "application/npy"),
        ("/v1/embed/text",
         json.dumps({"texts": ["a photo of a cat", "a dog"]}).encode(),
         "application/json"),
        ("/v1/embed/text", json.dumps({"text": "one"}).encode(),
         "application/json"),
        ("/v1/embed/text", json.dumps({"texts": [3]}).encode(),
         "application/json"),
        ("/v1/embed/text", b"{not json", "application/json"),
        ("/v1/classify?topk=3", jpeg, "image/jpeg"),
        ("/v1/classify", jpeg, "image/jpeg"),
        ("/v1/rank", rank, "application/json"),
        ("/v1/nothing", b"{}", "application/json"),
        ("/nothing", None, ""),
    ]


def test_http_routes_match_jax(served):
    """Every route of the port's server against the JAX server over the
    same weights: status codes equal, JSON within 1e-4; then /stats."""
    port, ref = served
    servers = [InferenceServer(port, max_wait_ms=2.0).start(),
               JaxInferenceServer(ref, port=0, max_wait_ms=2.0).start()]
    bases = [f"http://{s.address[0]}:{s.address[1]}" for s in servers]
    try:
        codes = []
        for path, body, ctype in _route_requests():
            got, want = (_request(b + path, body, ctype) for b in bases)
            assert got[0] == want[0], (path, got, want)
            codes.append(got[0])
            if got[0] == 200:
                _assert_json_close(got[1], want[1])
            else:
                assert "error" in got[1]
        assert codes.count(400) == 3 and codes.count(404) == 2
        stats = [_request(b + "/stats")[1] for b in bases]
        _assert_json_close(stats[0], stats[1])
        assert stats[0]["image"]["requests"] == 5
    finally:
        for s in servers:
            s.close()


def test_http_image_embedding_equals_the_decoded_crop(served):
    """The served embedding equals a direct call on the same decoded crop,
    alone and under 6 concurrent clients."""
    from PIL import Image

    port, _ = served
    server = InferenceServer(port, max_wait_ms=2.0).start()
    base = f"http://{server.address[0]}:{server.address[1]}"
    try:
        jpeg = _jpeg(6, (70, 90, 3))
        crop = pil_to_uint8(Image.open(io.BytesIO(jpeg)), SIZE)
        want = port.encode_image(crop[None])[0]
        results = [None] * 6

        def hit(i):
            results[i] = _request(base + "/v1/embed/image", jpeg,
                                  "image/jpeg")

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        for status, out in results:
            assert status == 200 and out["dim"] == port.embed_dim
            np.testing.assert_allclose(np.asarray(out["embedding"]), want,
                                       atol=HTTP_ATOL, rtol=HTTP_ATOL)
    finally:
        server.close()


def test_http_keep_alive_connection(served):
    """Several requests over one kept-alive HTTP/1.1 connection each get
    their answer (the handler sets TCP_NODELAY, so a response's body does
    not wait on the client's delayed ACK of its headers)."""
    import http.client

    port, _ = served
    server = InferenceServer(port, max_wait_ms=2.0).start()
    conn = http.client.HTTPConnection(*server.address, timeout=60)
    try:
        arr = _images(1, 9)[0]
        want = port.encode_image(arr[None])[0]
        for _ in range(3):
            conn.request("POST", "/v1/embed/image", _npy(arr),
                         {"Content-Type": "application/npy"})
            r = conn.getresponse()
            assert r.status == 200
            np.testing.assert_allclose(
                np.asarray(json.loads(r.read())["embedding"]), want,
                atol=HTTP_ATOL, rtol=HTTP_ATOL)
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read())["status"] == "ok"
    finally:
        conn.close()
        server.close()


def test_live_serving_http(tiny, served):
    """The live model (one CPU device, no bundle) behind the server: the
    same rows as the bundle, and /v1/classify against its classifier."""
    _, _, spec, tp = tiny
    port, _ = served
    rng = np.random.default_rng(7)
    clf = rng.standard_normal((spec.embed_dim, 3)).astype(np.float32)
    live = live_serving_model(spec, tp, buckets=(3,), image_size=SIZE,
                              classifier=clf, classnames=["a", "b", "c"],
                              devices=["cpu"])
    assert live.buckets == [3] and live.manifest["live"]
    server = InferenceServer(live, max_wait_ms=2.0).start()
    base = f"http://{server.address[0]}:{server.address[1]}"
    try:
        arr = _images(1, 8)[0]
        status, out = _request(base + "/v1/embed/image", _npy(arr),
                               "application/npy")
        assert status == 200
        want = port.encode_image(arr[None])[0]
        np.testing.assert_allclose(np.asarray(out["embedding"]), want,
                                   atol=HTTP_ATOL, rtol=HTTP_ATOL)
        status, cls = _request(base + "/v1/classify?topk=2", _npy(arr),
                               "application/npy")
        assert status == 200 and len(cls["topk"]) == 2
        assert cls["topk"][0]["index"] == int(np.argmax(100.0 * want @ clf))
        assert cls["topk"][0]["label"] in ("a", "b", "c")
    finally:
        server.close()


def test_live_serving_over_two_devices_names_m7(tiny):
    """Over two devices (ROADMAP M7, now ported) the buckets round up to
    multiples of the device count, as the JAX function's over two of its
    devices, and the manifest records both devices."""
    from msclip_tpu.serve.live import live_serving_model as jax_live

    jm, jp, spec, tp = tiny
    live = live_serving_model(spec, tp, buckets=(1, 3, 4), image_size=SIZE,
                              devices=["cpu", "cpu"])
    theirs = jax_live(jm, jp, buckets=(1, 3, 4), image_size=SIZE,
                      devices=jax.devices()[:2])
    assert live.buckets == theirs.buckets == [2, 4]
    assert live.manifest["devices"] == 2


def test_live_serving_splits_each_batch_over_the_devices(tiny):
    """Each bucket's rows split into one block a device, the outputs
    concatenated in order: 5 images and 7 prompts through two CPU
    replicas equal one device's rows (fp32, atol 1e-6: the blocks' GEMMs
    sum over other batch sizes)."""
    _, _, spec, tp = tiny
    two = live_serving_model(spec, tp, buckets=(4,), image_size=SIZE,
                             devices=["cpu", "cpu"])
    one = live_serving_model(spec, tp, buckets=(4,), image_size=SIZE,
                             devices=["cpu"])
    images, tokens = _images(5, 11), _tokens(7, 12)
    np.testing.assert_allclose(two.encode_image(images),
                               one.encode_image(images), atol=1e-6)
    np.testing.assert_allclose(two.encode_text(tokens),
                               one.encode_text(tokens), atol=1e-6)


def test_live_serving_defaults_to_the_card(tiny, monkeypatch):
    _, _, spec, tp = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        live_serving_model(spec, tp)


@pytest.mark.parametrize("cards", [1, 2, 3])
def test_live_serving_defaults_to_every_visible_card(tiny, monkeypatch,
                                                     cards):
    """With no devices given, live serving builds over every visible card
    in order, ``cuda:0`` ... ``cuda:n-1``, as the JAX function over
    ``jax.local_devices()``: one card takes one model, several a replica
    a card with the buckets rounded up to multiples of their count. The
    card and the graphs are patched out; what each device is given is
    recorded."""
    from msclip_torch.serve import live

    _, _, spec, tp = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    built = []

    def one_model(spec, params, manifest, classifier, device):
        built.append((device, manifest["buckets"]))
        return "model"

    def replica(spec, params, manifest, device, buckets):
        built.append((device, list(buckets)))
        return ({b: device for b in buckets}, {b: device for b in buckets})

    monkeypatch.setattr(live, "build_serving_model", one_model)
    monkeypatch.setattr(live, "device_buckets", replica)
    want = [torch.device("cuda", i) for i in range(cards)]
    assert live.local_devices() == want
    served = live.live_serving_model(spec, tp, buckets=(1, 4),
                                     image_size=SIZE)
    assert [d for d, _ in built] == want
    if cards == 1:
        assert served == "model" and built[0][1] == [1, 4]
    else:
        rounded = sorted({-(-b // cards) * cards for b in (1, 4)})
        assert served.buckets == rounded
        assert all(b == [r // cards for r in rounded] for _, b in built)
        assert [p for p in served.image_fns[rounded[0]].parts] == want


class _Stop(Exception):
    pass


@pytest.mark.parametrize("argv,platform,want", [
    (["--model", B32_JSON], None, ["cuda:0", "cuda:1"]),
    (["--model", B32_JSON, "--device", "cuda:1"], None, ["cuda:1"]),
    (["--model", B32_JSON, "--device", "cuda:1,cuda:0"], None,
     ["cuda:1", "cuda:0"]),
    (["--model", B32_JSON], "cpu", ["cpu"]),
    (["--bundle", "b"], None, ["cuda:0"]),
])
def test_serve_cli_live_mode_takes_every_visible_card(monkeypatch, argv,
                                                      platform, want):
    """``tools.serve``: live mode (``--model``) without ``--device`` takes
    every visible card (two here, patched); ``--device`` pins its list;
    ``MSCLIP_PLATFORM=cpu`` asks for the CPU; a bundle stays on one card.
    The model loaders are patched to record their devices and stop."""
    import msclip_torch.serve as serve_pkg
    from msclip_torch.tools import serve as serve_tool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    if platform:
        monkeypatch.setenv("MSCLIP_PLATFORM", platform)
    else:
        monkeypatch.delenv("MSCLIP_PLATFORM", raising=False)
    seen = []

    def load_live(args, devices):
        seen.extend(devices)
        raise _Stop

    def load_bundle(path, device):
        seen.append(device)
        raise _Stop

    monkeypatch.setattr(serve_tool, "load_live", load_live)
    monkeypatch.setattr(serve_pkg, "load_bundle", load_bundle)
    with pytest.raises(_Stop):
        serve_tool.main(argv)
    assert seen == [torch.device(d) for d in want]


def test_concurrent_burst_no_resets(tiny):
    """2 x 192 requests at 24-way concurrency: no connection is reset
    (the deep listen backlog) and the batcher coalesces (mean batch > 1)."""
    _, _, spec, tp = tiny
    live = live_serving_model(spec, tp, buckets=(8,), image_size=SIZE,
                              devices=["cpu"])
    server = InferenceServer(live, max_wait_ms=2.0).start()
    url = f"http://{server.address[0]}:{server.address[1]}/v1/embed/image"
    body = _npy(_images(1, 3)[0])

    def one(_):
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/npy"})
        urllib.request.urlopen(req, timeout=60).read()
        return 1

    try:
        for _ in range(2):
            with ThreadPoolExecutor(24) as ex:
                assert sum(ex.map(one, range(192))) == 192
        stats = server._stats()["image"]
        assert stats["requests"] == 384
        assert stats["mean_batch"] > 1.0, stats
    finally:
        server.close()


def _read_serving_line(proc, deadline_s=300):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            return None
        if line.startswith("SERVING "):
            return line.split()[1].strip()
    return None


def _serve(args):
    return subprocess.Popen(
        [sys.executable, "-m", "msclip_torch.tools.serve", "--port", "0",
         "--device", "cpu"] + args,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_serving_cli_end_to_end(tmp_path):
    """``export_serving`` then ``serve --bundle`` as subprocesses on the
    CPU: a tiny random-weight bundle with a baked VOC classifier, the
    server's announced address, and one image through /v1/classify."""
    bundle_dir = str(tmp_path / "bundle")
    r = subprocess.run(
        [sys.executable, "-m", "msclip_torch.tools.export_serving",
         "--model", B32_JSON, "--out", bundle_dir, "--buckets", "1,2",
         "--classify-prompts", "voc2007classification", "--device", "cpu",
         "MODEL.PRETRAINED_MODEL", ""] + CLI_TINY,
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"EXPORTED {bundle_dir} buckets=[1, 2] bytes=" in r.stdout
    manifest = json.load(open(os.path.join(bundle_dir, "MANIFEST.json")))
    assert len(manifest["classnames"]) == 20
    proc = _serve(["--bundle", bundle_dir])
    try:
        base = _read_serving_line(proc)
        assert base, "server never announced its address"
        status, out = _request(base + "/v1/classify", _jpeg(5, (70, 90, 3)),
                               "image/jpeg")
        assert status == 200 and len(out["topk"]) == 5
        probs = [t["prob"] for t in out["topk"]]
        assert probs == sorted(probs, reverse=True)
        assert all(t["label"] in manifest["classnames"] for t in out["topk"])
    finally:
        proc.terminate()
        proc.wait(30)


def test_live_serving_cli(tmp_path):
    """``serve --model`` (live mode) as a subprocess on the CPU: its
    buckets in /healthz and one text embedding."""
    proc = _serve(["--model", B32_JSON, "--buckets", "1,3",
                   "MODEL.PRETRAINED_MODEL", ""] + CLI_TINY)
    try:
        base = _read_serving_line(proc)
        assert base, "live server never announced its address"
        status, health = _request(base + "/healthz")
        assert status == 200 and health["buckets"] == [1, 3]
        assert not health["has_classifier"]
        status, out = _request(
            base + "/v1/embed/text",
            json.dumps({"text": "a photo of a dog"}).encode())
        emb = np.asarray(out["embeddings"], np.float32)
        assert status == 200 and emb.shape == (1, 32)
        assert np.isfinite(emb).all()
    finally:
        proc.terminate()
        proc.wait(30)

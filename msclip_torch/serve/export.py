"""Serving bundles of the port (the counterpart of
``msclip_tpu/serve/export.py``).

A *bundle* is a directory that describes a deployable model:

```
bundle/
  MANIFEST.json    # format tag, buckets, image size, context length,
                   # embed dim, normalize stats, files, the resolved model
                   # spec, optional classnames
  params.npz       # the parameters in fp32, BN folded, keyed by the port's
                   # (reference state_dict) names
  classifier.npy   # optional [E, C] prompt-ensemble classifier
```

What takes the place of the JAX bundle's ``.jaxexp`` graphs:
``torch.export`` cannot trace the port's kernels, which are ctypes launches
on raw pointers (``ops/attention.py``, ``ops/block_fused.py``). So the
bundle stores the model spec, and :func:`load_bundle` builds the towers from
it. On a CUDA device it then captures one ``torch.cuda.CUDAGraph`` per
tower and batch bucket: static input buffers (uint8 images, normalized
inside the graph by ``normalize_uint8``; int32 tokens) and a static fp32
output; a call copies the padded chunk in, replays and copies the rows out.
On the CPU the same buckets run eagerly through the kernels' plain
versions. A port bundle therefore needs ``msclip_torch`` on the serving
host, where a JAX bundle needs no model code. Each package refuses the
other's bundle by its format tag.

Semantics kept from the JAX package: bundles ignore ``TPU.INT8_EVAL`` (its
export tool folds BN and never quantizes) and honour
``TPU.USE_FUSED_BLOCK`` (the spec carries it, so every block of a fused
bundle runs the half-block kernel K5); the parameters are cast to the
spec's compute dtype at load; bucketing chunks by the top bucket and pads
the remainder up to the smallest bucket that fits.

Capture rules (each a way a graph goes wrong):

* every bucket runs eagerly twice before its capture: a kernel's first
  launch builds its library with ``nvcc`` and sets its shared-memory
  attribute, and cuBLAS/cuDNN settle their algorithms; none of that may
  happen inside a capture;
* the kernels' launchers read ``torch.cuda.current_stream()`` on every
  call, so they record into the capture stream; the towers make no host
  sync;
* each graph has a private memory pool (the image and text batchers replay
  on two threads at once) and each tower its own stream; K5's TMA maps are
  kernel parameters that hold the addresses of its workspace, which the
  capture allocates from the graph's pool, so the pool lives as long as the
  graph;
* each tower's calls are serialized by a lock: a replay reuses the static
  buffers;
* a capture or replay that fails raises; nothing runs eagerly on the card
  in its place.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD, normalize_uint8
from ..models.extensions import ExtSpec
from ..models.msclip import (
    MSClipModel,
    MSClipSpec,
    cast_params,
    is_bn_stat,
    set_fp32_precision,
)
from ..ops import attention as A
from ..ops import block_chain as K7
from ..ops import block_fused as BF

DEFAULT_BUCKETS = (1, 4, 16, 64)
MANIFEST_NAME = "MANIFEST.json"
# the JAX package's manifests carry the integer 1
FORMAT = "msclip_torch/1"
JAX_FORMAT = 1
PARAMS_NAME = "params.npz"
CLASSIFIER_NAME = "classifier.npy"
# the wrappers of the kernels a served tower launches (K1 and the block
# chain K7; K5 in a fused bundle), whose launch counters a capture reads
KERNEL_COUNTERS = {
    "attention_fwd": A.fused_attention_qkv,
    "attention_halfblock": BF.fused_attention_halfblock,
    **{f"block_{fn.__name__}": fn for fn in K7.KERNELS},
}


# ---------------------------------------------------------------------------
# the model spec as JSON
# ---------------------------------------------------------------------------

def spec_from_json(d: dict) -> MSClipSpec:
    """The spec back from its ``dataclasses.asdict`` in a manifest (JSON
    lists -> tuples, the nested ``ExtSpec`` rebuilt)."""
    def fields(cls, src):
        return {f.name: tuple(src[f.name]) if isinstance(src[f.name], list)
                else src[f.name]
                for f in dataclasses.fields(cls) if f.name in src}

    kw = fields(MSClipSpec, d)
    if isinstance(kw.get("ext"), dict):  # the extension families' switches
        kw["ext"] = ExtSpec(**fields(ExtSpec, kw["ext"]))
    return MSClipSpec(**kw)


# ---------------------------------------------------------------------------
# host-side preprocessing (decode -> uint8 crop; normalize is in-graph)
# ---------------------------------------------------------------------------

def pil_to_uint8(image, size: int = 224) -> np.ndarray:
    """PIL image -> uint8 ``[size, size, 3]`` center crop: the resize/crop
    stages of ``pil_eval_transform`` (torchvision Resize-short-side +
    CenterCrop semantics, PIL bicubic), with /255 + normalize left to the
    served graph. An alias of ``data.transforms.pil_eval_uint8``."""
    from ..data.transforms import pil_eval_uint8

    return pil_eval_uint8(image, size)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def serving_params(spec: MSClipSpec, params) -> dict:
    """fp32 CPU copies of the flat reference-layout ``params`` with BN
    folded (unfolded BN is folded here). Int8-quantized weights are
    refused: a bundle holds full-precision weights and ignores
    ``TPU.INT8_EVAL``, as the JAX package's bundles do."""
    from ..models.folding import fold_params_for_eval

    if any(k.endswith("_int8") for k in params):
        raise ValueError("serving takes full-precision weights: bundles "
                         "ignore TPU.INT8_EVAL, as the JAX package's do")
    out = {k: v.detach().to("cpu", torch.float32)
           for k, v in params.items()}
    if any(is_bn_stat(k) for k in out):
        out = fold_params_for_eval(out, spec)
    return out


def spec_and_params(model_or_config, params):
    """``(spec, fp32 folded params)`` from an ``MSClipModel`` (its own
    parameters unless ``params`` is given), an ``MSClipSpec`` with
    ``params``, or a config tree (its checkpoint, ``MODEL.PRETRAINED_MODEL``,
    or random parameters from ``TPU.SEED``, unless ``params`` is given)."""
    from ..models.msclip import spec_from_config

    if isinstance(model_or_config, MSClipModel):
        spec = model_or_config.spec
        params = model_or_config.params() if params is None else params
    elif isinstance(model_or_config, MSClipSpec):
        spec = model_or_config
        if params is None:
            raise ValueError("an MSClipSpec needs its params")
    else:
        from ..eval.checkpoint_load import load_model_params

        spec = spec_from_config(model_or_config)
        if params is None:
            params = load_model_params(model_or_config, spec)
    return spec, serving_params(spec, params)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def serving_manifest(spec: MSClipSpec, buckets: Sequence[int],
                     image_size: Optional[int], mean, std) -> dict:
    """The manifest keys a bundle and a live model share: the sorted
    buckets, the served crop (by default the spec's resolution), the text
    context, the embedding width and the normalize stats (ImageNet's by
    default)."""
    mean = tuple(mean) if mean is not None else IMAGENET_MEAN
    std = tuple(std) if std is not None else IMAGENET_STD
    return {
        "buckets": sorted({int(b) for b in buckets}),
        "image_size": int(image_size or spec.image_resolution),
        "context_length": int(spec.context_length),
        "embed_dim": int(spec.embed_dim),
        "mean": [float(v) for v in mean],
        "std": [float(v) for v in std],
    }


def export_bundle(
    model_or_config,
    params,
    out_dir: str,
    *,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    image_size: Optional[int] = None,
    classifier: Optional[np.ndarray] = None,
    classnames: Optional[Sequence[str]] = None,
    mean=None,
    std=None,
) -> dict:
    """Write a serving bundle of ``model_or_config`` (see
    :func:`spec_and_params`) to ``out_dir``; returns the manifest.

    ``image_size``: the served crop, by default the spec's resolution.
    ``classifier``: optional ``[E, C]`` zero-shot classifier (already
    prompt-ensembled and L2-normalized), stored for ``/v1/classify``.
    """
    spec, params = spec_and_params(model_or_config, params)
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, PARAMS_NAME),
             **{k: v.numpy() for k, v in params.items()})
    manifest = {"format": FORMAT,
                **serving_manifest(spec, buckets, image_size, mean, std),
                "files": {"params": PARAMS_NAME},
                "model": dataclasses.asdict(spec)}
    if classifier is not None:
        np.save(os.path.join(out_dir, CLASSIFIER_NAME),
                np.asarray(classifier, np.float32))
        manifest["classifier"] = CLASSIFIER_NAME
        manifest["files"]["classifier"] = CLASSIFIER_NAME
        if classnames is not None:
            manifest["classnames"] = list(classnames)
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


# ---------------------------------------------------------------------------
# bucket runners
# ---------------------------------------------------------------------------

def kernel_launches() -> dict:
    """Every counted kernel's launches so far."""
    return {name: fn.launches for name, fn in KERNEL_COUNTERS.items()}


def _tensor(chunk: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``chunk``, copied first if it is read-only (a
    decoded image's array) or not contiguous."""
    return torch.from_numpy(np.require(chunk, requirements=["C", "W"]))


class EagerBucket:
    """One tower at one bucket, run eagerly on the tensor's device (the CPU
    path: the kernels' plain versions)."""

    def __init__(self, fn, device):
        self._fn = fn
        self._device = device

    @torch.inference_mode()
    def __call__(self, chunk: np.ndarray) -> np.ndarray:
        return self._fn(_tensor(chunk).to(self._device)).cpu().numpy()

    def launch(self, chunk: np.ndarray) -> None:
        self._out = self(chunk)

    def collect(self) -> np.ndarray:
        return self._out


class GraphBucket:
    """One tower at one bucket on a CUDA device: static buffers and a CUDA
    graph captured over them on the tower's stream, in a private pool.

    ``capture_s``: the capture's seconds (after the eager warm-up);
    ``pool_bytes``: the device memory the capture reserved;
    ``launches``: each counted kernel's launches recorded into the graph,
    which every replay runs once; ``replays``: the replays so far;
    ``stream``: the tower's stream, on which replays run."""

    def __init__(self, fn, shape, dtype, device, stream):
        self._fn = fn
        self.stream = stream
        self.input = torch.zeros(shape, dtype=dtype, device=device)
        self.replays = 0
        with torch.inference_mode(), torch.cuda.stream(stream):
            for _ in range(2):
                fn(self.input)
        stream.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        before = kernel_launches()
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.inference_mode(), torch.cuda.graph(self.graph,
                                                      stream=stream):
            self.output = fn(self.input)
        stream.synchronize()
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        after = kernel_launches()
        self.launches = {k: after[k] - before[k] for k in after}

    def __call__(self, chunk: np.ndarray) -> np.ndarray:
        """Copy ``chunk`` in, replay, copy the rows out."""
        self.launch(chunk)
        return self.collect()

    def launch(self, chunk: np.ndarray) -> None:
        """Copy ``chunk`` in and queue the replay on the tower's stream."""
        with torch.cuda.stream(self.stream):
            self.input.copy_(_tensor(chunk))
            self.graph.replay()

    def collect(self) -> np.ndarray:
        """The last replay's rows, once it has run."""
        with torch.cuda.stream(self.stream):
            out = self.output.cpu().numpy()
        self.replays += 1
        return out

    @torch.inference_mode()
    def eager(self, chunk: np.ndarray) -> np.ndarray:
        """The same tower run eagerly on the same stream (the graph's
        yardstick; not a serving path)."""
        with torch.cuda.stream(self.stream):
            x = _tensor(chunk).to(self.input.device)
            return self._fn(x).cpu().numpy()


class SplitBucket:
    """One bucket over several devices: the chunk's rows cut into equal
    blocks, one a device, every block launched before any is read back,
    the outputs concatenated in order."""

    def __init__(self, parts):
        self.parts = parts

    def __call__(self, chunk: np.ndarray) -> np.ndarray:
        for part, block in zip(self.parts, np.split(chunk, len(self.parts))):
            part.launch(block)
        return np.concatenate([part.collect() for part in self.parts])


def build_serving_model(spec: MSClipSpec, params: dict, manifest: dict,
                        classifier: Optional[np.ndarray],
                        device: torch.device) -> "ServingModel":
    """The :class:`ServingModel` of ``spec`` over the fp32 folded
    ``params``, cast to the spec's compute dtype on ``device``: a CUDA
    graph per tower and bucket on a card, eager buckets on the CPU."""
    image_fns, text_fns = device_buckets(spec, params, manifest, device,
                                         manifest["buckets"])
    return ServingModel(manifest, image_fns, text_fns, classifier)


def device_buckets(spec: MSClipSpec, params: dict, manifest: dict,
                   device: torch.device, buckets):
    """``(image_fns, text_fns)``, ``{bucket: runner}`` for each tower on
    ``device`` (a CUDA graph a bucket on a card, eager on the CPU)."""
    set_fp32_precision(spec)
    model = MSClipModel(spec, cast_params(params, spec.dtype)).to(device)
    mean = torch.tensor(manifest["mean"], dtype=torch.float32, device=device)
    std = torch.tensor(manifest["std"], dtype=torch.float32, device=device)
    S, T = manifest["image_size"], manifest["context_length"]

    def image_fn(images_u8):
        return model.encode_image(normalize_uint8(images_u8, mean, std)
                                  ).float()

    def text_fn(tokens):
        return model.encode_text(tokens).float()

    buckets = sorted(buckets)
    if device.type == "cuda":
        streams = {"image": torch.cuda.Stream(device),
                   "text": torch.cuda.Stream(device)}
        image_fns = {b: GraphBucket(image_fn, (b, S, S, 3), torch.uint8,
                                    device, streams["image"])
                     for b in buckets}
        text_fns = {b: GraphBucket(text_fn, (b, T), torch.int32, device,
                                   streams["text"])
                    for b in buckets}
    else:
        image_fns = {b: EagerBucket(image_fn, device) for b in buckets}
        text_fns = {b: EagerBucket(text_fn, device) for b in buckets}
    return image_fns, text_fns


# ---------------------------------------------------------------------------
# the serving model
# ---------------------------------------------------------------------------

class ServingModel:
    """A loaded bundle (or a live model): a runner per tower and bucket.

    ``encode_image`` takes uint8 ``[N, S, S, 3]`` (any N; chunked into the
    largest bucket, remainder padded up to the smallest fitting bucket)
    and returns fp32 ``[N, E]``; ``encode_text`` the same over token ids
    or raw strings. ``classify`` returns the reference-convention logits
    ``100 * feats @ W`` against the bundled classifier. Each tower's calls
    hold its lock.
    """

    def __init__(self, manifest: dict, image_fns, text_fns,
                 classifier: Optional[np.ndarray] = None):
        self.manifest = manifest
        self.buckets = sorted(manifest["buckets"])
        self.image_size = manifest["image_size"]
        self.context_length = manifest["context_length"]
        self.embed_dim = manifest["embed_dim"]
        self.image_fns = image_fns  # {bucket: callable(np chunk) -> np}
        self.text_fns = text_fns
        self.classifier = classifier
        self.classnames = manifest.get("classnames")
        self._locks = {"image": threading.Lock(), "text": threading.Lock()}
        self._tokenizer = None

    # -- batching over buckets ------------------------------------------
    def _run_bucketed(self, fns: dict, x: np.ndarray, pad_value,
                      lock) -> np.ndarray:
        n = x.shape[0]
        if n == 0:
            return np.zeros((0, self.embed_dim), np.float32)
        out = []
        top = self.buckets[-1]
        i = 0
        with lock:
            while i < n:
                rem = n - i
                b = next((b for b in self.buckets if b >= rem), top)
                take = min(rem, b)
                chunk = x[i:i + take]
                if take < b:
                    pad = np.full((b - take,) + x.shape[1:], pad_value,
                                  x.dtype)
                    chunk = np.concatenate([chunk, pad], axis=0)
                out.append(fns[b](chunk)[:take])
                i += take
        return np.concatenate(out, axis=0)

    def encode_image(self, images_u8: np.ndarray) -> np.ndarray:
        images_u8 = np.asarray(images_u8, np.uint8)
        if images_u8.ndim == 3:
            images_u8 = images_u8[None]
        return self._run_bucketed(self.image_fns, images_u8, 0,
                                  self._locks["image"])

    def tokenize(self, texts) -> np.ndarray:
        if self._tokenizer is None:
            from ..data.tokenizer import ClipTokenizer

            self._tokenizer = ClipTokenizer()
        return self._tokenizer.tokenize(
            texts, context_length=self.context_length).astype(np.int32)

    def encode_text(self, texts_or_tokens) -> np.ndarray:
        if isinstance(texts_or_tokens, str) or (
                isinstance(texts_or_tokens, (list, tuple)) and texts_or_tokens
                and isinstance(texts_or_tokens[0], str)):
            tokens = self.tokenize(texts_or_tokens)
        else:
            tokens = np.asarray(texts_or_tokens, np.int32)
            if tokens.ndim == 1:
                tokens = tokens[None]
        return self._run_bucketed(self.text_fns, tokens, 0,
                                  self._locks["text"])

    def classify(self, images_u8: np.ndarray) -> np.ndarray:
        if self.classifier is None:
            raise ValueError("bundle was exported without a classifier")
        feats = self.encode_image(images_u8)
        return 100.0 * feats @ self.classifier


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

def load_bundle(bundle_dir: str, device="cuda") -> ServingModel:
    """Load a bundle onto ``device`` (``cuda`` unless the caller asks for
    the CPU): the towers built from the manifest's spec, their parameters
    cast to its compute dtype, and on a card a CUDA graph captured per
    tower and bucket. A JAX package's bundle, or another format, is
    refused."""
    from ..eval.zero_shot import resolve_device

    device = resolve_device(device)
    with open(os.path.join(bundle_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    fmt = manifest.get("format")
    if fmt == JAX_FORMAT:
        raise ValueError(
            f"{bundle_dir} is a msclip_tpu (JAX) bundle: load it with "
            "msclip_tpu.serve.load_bundle, or export a port bundle with "
            "python -m msclip_torch.tools.export_serving")
    if fmt != FORMAT:
        raise ValueError(f"unsupported bundle format {fmt!r} (msclip_torch "
                         f"reads {FORMAT!r})")
    with np.load(os.path.join(bundle_dir, manifest["files"]["params"])) as z:
        params = {k: torch.from_numpy(z[k]) for k in z.files}
    classifier = None
    if "classifier" in manifest:
        classifier = np.load(os.path.join(bundle_dir, manifest["classifier"]))
    return build_serving_model(spec_from_json(manifest["model"]), params,
                               manifest, classifier, device)

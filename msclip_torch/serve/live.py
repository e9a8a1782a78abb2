"""Live (in-process) serving: the counterpart of ``msclip_tpu/serve/live.py``.

Builds the same :class:`~.export.ServingModel` as a bundle gives, directly
from a model and its parameters, with no bundle on disk: BN folded, the
parameters cast to the spec's compute dtype, and on a card one CUDA graph
captured per tower and bucket (``export.device_buckets``). The batcher and
HTTP layers are unchanged: ``InferenceServer`` takes either model.

With no devices given it serves over every visible card, ``cuda:0`` to
``cuda:n-1`` (:func:`local_devices`), as the JAX function serves over
``jax.local_devices()``. Over several devices, as the JAX function shards
each bucket's batch over every local device: one replica of the towers a
device (a CUDA graph a device, tower and bucket on cards), the buckets
rounded up to multiples of the device count (JAX's ``:52-55``), and each
batch cut into equal blocks, one a device, launched on every device
before any is read back, the outputs concatenated in order
(``export.SplitBucket``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .export import (
    DEFAULT_BUCKETS,
    ServingModel,
    SplitBucket,
    build_serving_model,
    device_buckets,
    serving_manifest,
    spec_and_params,
)


def local_devices():
    """Every visible card in order, ``cuda:0`` ... ``cuda:n-1``: the
    counterpart of ``jax.local_devices()``. Raises without a card."""
    from ..eval.device import resolve_device

    resolve_device("cuda")  # no silent fall back to the CPU
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def live_serving_model(
    model_or_spec,
    params=None,
    *,
    buckets: Optional[Sequence[int]] = None,
    image_size: Optional[int] = None,
    classifier: Optional[np.ndarray] = None,
    classnames: Optional[Sequence[str]] = None,
    mean=None,
    std=None,
    devices=None,
) -> ServingModel:
    """A :class:`ServingModel` over ``model_or_spec`` (an ``MSClipModel``,
    or an ``MSClipSpec`` with ``params``) on ``devices``: every visible
    card (:func:`local_devices`) unless the caller passes others
    (``["cpu"]``, one card, or several: ``["cuda:0", "cuda:1"]``,
    ``["cpu", "cpu"]``)."""
    from ..eval.device import resolve_device

    devices = ([resolve_device(d) for d in devices] if devices
               else local_devices())
    n = len(devices)
    spec, params = spec_and_params(model_or_spec, params)
    # every bucket a multiple of the device count, so each splits evenly
    rounded = sorted({-(-int(b) // n) * n
                      for b in (buckets or DEFAULT_BUCKETS)})
    manifest = {**serving_manifest(spec, rounded, image_size, mean, std),
                "live": True, "devices": n}
    if classnames is not None:
        manifest["classnames"] = list(classnames)
    clf = np.asarray(classifier, np.float32) if classifier is not None \
        else None
    if n == 1:
        return build_serving_model(spec, params, manifest, clf, devices[0])
    replicas = [device_buckets(spec, params, manifest, d,
                               [b // n for b in rounded]) for d in devices]
    image_fns, text_fns = (
        {b: SplitBucket([r[t][b // n] for r in replicas]) for b in rounded}
        for t in (0, 1))
    return ServingModel(manifest, image_fns, text_fns, clf)

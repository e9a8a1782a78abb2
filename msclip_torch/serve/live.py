"""Live (in-process) serving: the counterpart of ``msclip_tpu/serve/live.py``.

Builds the same :class:`~.export.ServingModel` as a bundle gives, directly
from a model and its parameters, with no bundle on disk: BN folded, the
parameters cast to the spec's compute dtype, and on a card one CUDA graph
captured per tower and bucket (``export.build_serving_model``). The
batcher and HTTP layers are unchanged: ``InferenceServer`` takes either
model.

The JAX function shards each bucket's batch over every local device, its
buckets rounded up to multiples of the device count. Here one device
serves, so every bucket is such a multiple already: batch sharding across
cards is multi-card work (ROADMAP M7), and more than one device raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .export import (
    DEFAULT_BUCKETS,
    ServingModel,
    build_serving_model,
    serving_manifest,
    spec_and_params,
)


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
    or an ``MSClipSpec`` with ``params``) on ``devices``: one device,
    ``cuda`` unless the caller passes another (``["cpu"]``)."""
    from ..eval.zero_shot import resolve_device

    devices = list(devices) if devices is not None else ["cuda"]
    if len(devices) != 1:
        raise NotImplementedError(
            f"live serving over {len(devices)} devices shards each batch "
            "across cards, which is not ported to msclip_torch yet "
            "(ROADMAP M7); serve on one device, or run one server per card")
    device = resolve_device(devices[0])
    spec, params = spec_and_params(model_or_spec, params)
    manifest = {**serving_manifest(spec, buckets or DEFAULT_BUCKETS,
                                   image_size, mean, std),
                "live": True, "devices": 1}
    if classnames is not None:
        manifest["classnames"] = list(classnames)
    clf = np.asarray(classifier, np.float32) if classifier is not None \
        else None
    return build_serving_model(spec, params, manifest, clf, device)

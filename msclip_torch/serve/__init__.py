"""Serving: bundles, a dynamic batcher and an HTTP server (the
counterpart of ``msclip_tpu/serve``, the JAX package's deployment path).

* :mod:`.export`: a *bundle* on disk (the model spec, fp32 parameters with
  BN folded, an optional prompt-ensemble classifier) and its loader, which
  builds the towers and, on a card, captures one CUDA graph per tower and
  static batch bucket; requests pad up to the nearest bucket.
* :mod:`.batcher`: a dynamic micro-batcher that coalesces concurrent
  single-image/text requests into device batches.
* :mod:`.server`: a threaded HTTP server (stdlib only) exposing
  ``/v1/embed/image``, ``/v1/embed/text``, ``/v1/classify``, ``/v1/rank``,
  ``/healthz`` and ``/stats`` over a loaded bundle.
* :mod:`.live`: the same ``ServingModel`` built in process from a model
  and its parameters, with no bundle, on one device or split over several.

Recipe: ``python -m msclip_torch.tools.export_serving`` then
``python -m msclip_torch.tools.serve --bundle <dir>`` (README).
"""

from .batcher import DynamicBatcher
from .export import ServingModel, export_bundle, load_bundle, pil_to_uint8
from .live import live_serving_model

__all__ = [
    "DynamicBatcher",
    "ServingModel",
    "export_bundle",
    "live_serving_model",
    "load_bundle",
    "pil_to_uint8",
]

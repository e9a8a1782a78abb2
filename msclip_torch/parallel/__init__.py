"""The InfoNCE losses and the process mesh, as ``msclip_tpu.parallel``
exports them. Resolved at first access: the model modules import
``parallel.collectives``, which the mesh and the losses import in turn."""

import importlib

_EXPORTS = {
    "infonce_loss": "infonce",
    "sharded_infonce_loss": "infonce",
    "chunked_sharded_infonce_loss": "infonce",
    "ring_infonce_loss": "infonce",
    "create_mesh": "mesh",
    "mesh_from_config": "mesh",
    "split_for_model": "mesh",
    "gather_over_model": "mesh",
    "fsdp_dims": "mesh",
    "zero1_dims": "mesh",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)

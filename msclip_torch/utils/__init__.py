"""The weight bridge, as ``msclip_tpu.utils`` exports it. Resolved at
first access: ``utils.convert`` imports the model, whose modules import
``utils.comm``."""

import importlib

_EXPORTS = {
    "build_key_map": "convert",
    "load_state_dict": "convert",
    "export_state_dict": "convert",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)

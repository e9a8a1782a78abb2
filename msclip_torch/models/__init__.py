from .msclip import (
    MSClipModel,
    MSClipSpec,
    build_model,
    build_spec,
    cast_params,
    encode_image,
    encode_text,
    forward,
    init_params,
    param_count,
    resolve_text_block,
    spec_from_config,
)

__all__ = [
    "MSClipModel",
    "MSClipSpec",
    "build_model",
    "build_spec",
    "cast_params",
    "encode_image",
    "encode_text",
    "forward",
    "init_params",
    "param_count",
    "resolve_text_block",
    "spec_from_config",
]

from .msclip import (
    MSClipModel,
    MSClipSpec,
    build_spec,
    cast_params,
    encode_image,
    encode_text,
    init_params,
    resolve_text_block,
    spec_from_config,
)

__all__ = [
    "MSClipModel",
    "MSClipSpec",
    "build_spec",
    "cast_params",
    "encode_image",
    "encode_text",
    "init_params",
    "resolve_text_block",
    "spec_from_config",
]

from .prompts import (
    ALL_CLASSES_DICT,
    ALL_TEMPLATES_DICT,
    available_datasets,
    get_classnames,
    get_templates,
)
from .tokenizer import ClipTokenizer, SimpleTokenizer

__all__ = [
    "ClipTokenizer",
    "SimpleTokenizer",
    "ALL_CLASSES_DICT",
    "ALL_TEMPLATES_DICT",
    "available_datasets",
    "get_classnames",
    "get_templates",
]

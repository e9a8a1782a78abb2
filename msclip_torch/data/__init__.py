from .prompts import get_classnames, get_templates
from .tokenizer import ClipTokenizer

__all__ = ["ClipTokenizer", "get_classnames", "get_templates"]

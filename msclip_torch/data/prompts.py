"""Zero-shot prompt registries (port of ``msclip_tpu/data/prompts.py``).

Loads the public CLIP prompt data (1,000 ImageNet class names and the 80
prompt-ensemble templates) from a JSON asset, a byte copy of the JAX
package's; ``ALL_CLASSES_DICT`` / ``ALL_TEMPLATES_DICT`` mirror the
reference registries (``lib/dataset/prompts/constants.py:86-92``).
"""

from __future__ import annotations

import functools
import json
import os

_ASSET = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "assets", "prompts.json"
)


@functools.lru_cache()
def _load():
    with open(_ASSET) as f:
        return json.load(f)


def get_classnames(dataset: str):
    classes = _load()["classes"]
    if dataset not in classes:
        raise ValueError(f"No prompt classes for dataset: {dataset}")
    return classes[dataset]


def get_templates(dataset: str):
    templates = _load()["templates"]
    if dataset not in templates:
        raise ValueError(f"No prompt templates for dataset: {dataset}")
    return templates[dataset]


def available_datasets():
    return sorted(_load()["classes"].keys())


class _LazyDict:
    """Dict-like view matching the reference's ALL_*_DICT access pattern."""

    def __init__(self, kind):
        self._kind = kind

    def __contains__(self, key):
        return key in _load()[self._kind]

    def __getitem__(self, key):
        return _load()[self._kind][key]

    def keys(self):
        return _load()[self._kind].keys()


ALL_CLASSES_DICT = _LazyDict("classes")
ALL_TEMPLATES_DICT = _LazyDict("templates")

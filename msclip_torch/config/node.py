"""Hierarchical configuration node with YAML ``BASE:`` inheritance.

Port of ``msclip_tpu/config/node.py``. ``yaml`` is imported only when a
YAML file is read, so a resolved ``.json`` config (read with the
standard library) needs no third-party package. The node is a
dependency-free replacement for the yacs ``CfgNode`` tree the
reference MS-CLIP uses (``lib/config/default.py:14-192``). Semantics
preserved:

* attribute-style access (``cfg.MODEL.SPEC.EMBED_DIM``),
* ``dump()`` to YAML (``config/io.save_config``),
* recursive ``BASE: [other.yaml]`` inheritance resolved relative to the
  including file (reference ``default.py:279-291``),
* ``merge_from_list`` CLI-override semantics with type coercion
  (reference ``default.py:298``),
* "open" nodes that accept keys not present in the defaults (yacs
  ``new_allowed=True``; reference marks MODEL, MODEL.SPEC, DATASET, TEST,
  DEEPSPEED, CUSTOM, AUG.TIMM_AUG, TRAIN.LR_SCHEDULER, TRAIN.OPTIMIZER_ARGS,
  DATASET.COCO as open), while closed nodes reject unknown keys to catch
  typos.
"""

from __future__ import annotations

import ast
import copy
import json
from typing import Any, Iterable, Optional


class CfgNode(dict):
    """A dict with attribute access, strict/open merge, and YAML input."""

    _OPEN_KEY = "__is_open__"

    def __init__(self, init: Optional[dict] = None, open_node: bool = False):
        super().__init__()
        # Store meta-state inside the dict under a reserved key so copies /
        # pickling stay trivial; it is stripped from dumps and iteration.
        dict.__setitem__(self, CfgNode._OPEN_KEY, bool(open_node))
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute <-> item bridging ------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            value = CfgNode(value)
        dict.__setitem__(self, key, value)

    # -- meta ------------------------------------------------------------
    @property
    def is_open(self) -> bool:
        return dict.get(self, CfgNode._OPEN_KEY, False)

    def set_open(self, flag: bool = True) -> "CfgNode":
        dict.__setitem__(self, CfgNode._OPEN_KEY, bool(flag))
        return self

    def keys(self):  # hide the meta key
        return [k for k in dict.keys(self) if k != CfgNode._OPEN_KEY]

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def values(self):
        return [self[k] for k in self.keys()]

    def __iter__(self):
        return iter(self.keys())

    def __len__(self):
        return len(self.keys())

    def __contains__(self, key):
        return key != CfgNode._OPEN_KEY and dict.__contains__(self, key)

    # -- merging ----------------------------------------------------------
    def merge_from_dict(self, other: dict, path: str = "") -> None:
        for key, value in other.items():
            if key == "BASE":
                continue
            full = f"{path}.{key}" if path else key
            if key not in self:
                if not self.is_open:
                    raise KeyError(f"Unknown config key: {full}")
                self[key] = (
                    CfgNode(value, open_node=True)
                    if isinstance(value, dict)
                    else value
                )
                continue
            current = self[key]
            if isinstance(current, CfgNode):
                if not isinstance(value, dict):
                    raise TypeError(
                        f"Cannot overwrite config node {full} with scalar "
                        f"{value!r}"
                    )
                current.merge_from_dict(value, full)
            else:
                self[key] = _coerce(value, current, full)

    def merge_from_file(self, cfg_file: str) -> None:
        """Merge a YAML (or ``.json``) file, first recursively merging its
        BASE files (resolved relative to the including file's directory),
        matching the reference's ``_update_config_from_file``."""
        import os.path as op

        with open(cfg_file, "r") as f:
            if cfg_file.endswith(".json"):
                yaml_cfg = json.load(f)
            else:
                import yaml

                yaml_cfg = yaml.safe_load(f) or {}
        for base in yaml_cfg.get("BASE", []) or []:
            if base:
                self.merge_from_file(op.join(op.dirname(cfg_file), base))
        self.merge_from_dict(yaml_cfg)

    def merge_from_list(self, opts: Optional[Iterable[Any]]) -> None:
        """Merge ``[KEY, value, KEY, value, ...]`` CLI overrides."""
        opts = list(opts or [])
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list has odd length: {opts}")
        for full_key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = full_key.split(".")
            for part in parts[:-1]:
                if part not in node:
                    if not node.is_open:
                        raise KeyError(f"Unknown config key: {full_key}")
                    node[part] = CfgNode(open_node=True)
                node = node[part]
                if not isinstance(node, CfgNode):
                    raise KeyError(f"{full_key}: {part} is not a config node")
            leaf = parts[-1]
            if leaf in node and not isinstance(node[leaf], CfgNode):
                node[leaf] = _coerce(_parse_literal(value), node[leaf], full_key)
            elif node.is_open:
                node[leaf] = _parse_literal(value)
            else:
                raise KeyError(f"Unknown config key: {full_key}")

    # -- misc --------------------------------------------------------------
    def clone(self) -> "CfgNode":
        """A deep copy that keeps every node's open flag (``copy.deepcopy``
        rebuilds a dict subclass from :meth:`items`, which hides it)."""
        out = CfgNode(open_node=self.is_open)
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, CfgNode) else v)
            for k, v in self.items()
        }

    def dump(self) -> str:
        """The node as YAML (``yaml`` imported here, as for reading), the
        form ``merge_from_file`` reads back."""
        import yaml

        return yaml.safe_dump(self.to_dict(), default_flow_style=None)

    def __repr__(self) -> str:
        return f"CfgNode({self.to_dict()!r})"

    # yacs API compatibility no-ops (the reference calls freeze/defrost
    # around merges; configs stay mutable).
    def freeze(self) -> None:
        pass

    def defrost(self) -> None:
        pass


def _parse_literal(value: Any) -> Any:
    """Parse a CLI string into a Python literal when possible."""
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


# a vision tower's depth: an int (the ViT's blocks) or a list of four
# (the ModifiedResNet's stages, which the reference selects by the list,
# clip_openai_pe_res_v1.py:2748-2756)
_LAYER_COUNTS = ("VISION.LAYERS",)


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Coerce ``value`` to be type-compatible with the existing ``old``."""
    if old is None or value is None:
        return value
    if isinstance(old, bool):
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            low = value.lower()
            if low in ("true", "1", "yes"):
                return True
            if low in ("false", "0", "no"):
                return False
        if isinstance(value, int) and value in (0, 1):
            return bool(value)
        raise TypeError(f"{key}: cannot coerce {value!r} to bool")
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if isinstance(old, int) and isinstance(value, float) and value.is_integer():
        return int(value)
    if isinstance(old, (list, tuple)) and isinstance(value, (list, tuple)):
        return type(old)(value)
    if key.endswith(_LAYER_COUNTS) and isinstance(old, (int, list, tuple)) \
            and isinstance(value, (int, list, tuple)):
        return list(value) if isinstance(value, tuple) else value
    if type(old) is not type(value) and not (
        isinstance(old, (int, float)) and isinstance(value, (int, float))
    ):
        raise TypeError(
            f"{key}: type mismatch, existing {type(old).__name__} "
            f"vs new {type(value).__name__} ({value!r})"
        )
    return value

"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``configs/<name>.json`` (named by its ``file``), a
traffic mix ``workloads/<traffic>.json``, whose ``kind`` names the
module that runs it, ``kinds/<kind>.py``, a cell's correctness limits
``limits/<cell>.json``, a metric's reader ``metrics/<metric>.py``, end
to end or per layer (a ``read(ctx)`` that returns a number or None), and a
configuration's model layout ``layouts/<MODEL.NAME>.py``: its shapes,
parameters, work counts and plain reference (``layouts/__init__.py``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
MODULE_NAME = re.compile(r"^[A-Za-z][A-Za-z0-9_]*$")


@dataclass
class Cell:
    name: str
    config: str
    config_path: str
    traffic_name: str
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root=ROOT):
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def find_cell(bench, name, root=ROOT, bench_dir=BENCH_DIR):
    """The cell ``name`` with its configuration, traffic, limits and the
    metrics it reports."""
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    return Cell(
        name=name, config=config["name"],
        config_path=os.path.join(root, config["file"]),
        traffic_name=entry["traffic"],
        traffic=_load_json(os.path.join(bench_dir, "workloads",
                                        entry["traffic"] + ".json")),
        limits=_load_json(os.path.join(bench_dir, "limits",
                                       name + ".json")),
        chips=entry["chips"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def kind(name):
    """The ``run`` of ``kinds/<name>.py``."""
    return importlib.import_module(f"benchmark.kinds.{name}").run


def reader(metric_name, bench_dir=BENCH_DIR):
    """The ``read(ctx)`` of ``metrics/<metric_name>.py``."""
    path = os.path.join(bench_dir, "metrics", metric_name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric_name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def layout(config_path):
    """The module ``layouts/<MODEL.NAME>.py`` of a configuration file;
    a ``ValueError`` naming the ``MODEL.NAME`` where there is none."""
    name = _load_json(config_path).get("MODEL", {}).get("NAME")
    if not isinstance(name, str) or not MODULE_NAME.match(name) or \
            not os.path.exists(os.path.join(BENCH_DIR, "layouts",
                                            name + ".py")):
        raise ValueError(f"{config_path}: no layout for MODEL.NAME {name!r} "
                         "(benchmark/layouts/<MODEL.NAME>.py)")
    return importlib.import_module(f"benchmark.layouts.{name}")


def arch(config_path):
    """The configuration's shapes, by its layout."""
    return layout(config_path).arch_from_file(config_path)

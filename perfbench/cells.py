"""Finding a cell's files by name.

* `workloads/<cell>.json`: the cell's config, traffic, chips and why, and
  the names of the metrics it reports (`end_to_end` with --trace 0,
  `per_layer` with --trace 1);
* `configs/<config>.json`: the configuration as it is run, and the limits
  of the numbers that decide `correct`;
* `traffic/<mix>.json`: the mix's parameters for the one generator
  (`inputs.Pool`) and the loop that drives the program (`loops.py`);
* `metrics/<metric>.py`: the reader of one metric, `read(run)`, with
  `UNIT`.

A later cell, mix or metric is a new file here; nothing is edited.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from types import ModuleType

ROOT = pathlib.Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _path(kind: str, name: str, suffix: str) -> pathlib.Path:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = ROOT / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return path


def load_json(kind: str, name: str) -> dict:
    return json.loads(_path(kind, name, ".json").read_text())


def load_cell(name: str):
    """(cell, config, traffic) dicts of a workload."""
    cell = load_json("workloads", name)
    return cell, load_json("configs", cell["config"]), \
        load_json("traffic", cell["traffic"])


def load_metric(name: str) -> ModuleType:
    path = _path("metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def names(kind: str, suffix: str = ".json"):
    return sorted(p.name[:-len(suffix)] for p in (ROOT / kind).glob(
        f"*{suffix}"))

"""Finding a cell, its configuration, its traffic, its plain reference and
the per-layer metric readers by name, from their own files under the benchmark's folder (or
under ``root``, a copy of it)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = __package__ or "seaice_bench"


def _json(root, kind, name):
    path = Path(root) / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def _module(root, kind, name):
    """The module of file ``<root>/<kind>/<name>.py``, imported as
    ``seaice_bench.<kind>.<name>`` (so that its relative imports resolve)."""
    qual = f"{PACKAGE}.{kind}.{name}"
    spec = importlib.util.spec_from_file_location(qual, Path(root) / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_names(root=ROOT):
    return sorted(p.stem for p in (Path(root) / "cells").glob("*.json"))


def load_cell(name, root=ROOT):
    """The cell ``name``: its own file's entries, with ``cfg`` (the
    configuration's file), ``traffic_params`` (the traffic's file),
    ``module`` (the configuration's module) and ``reference`` (its plain
    reference, ``reference/<config>.py``) beside them."""
    cell = dict(_json(root, "cells", name), name=name)
    cell["cfg"] = _json(root, "configs", cell["config"])
    cell["traffic_params"] = _json(root, "traffic", cell["traffic"])
    cell["module"] = _module(root, "configs", cell["config"])
    cell["reference"] = _module(root, "reference", cell["config"])
    return cell


def metric_readers(root=ROOT):
    """Every per-layer metric reader: name → its module (``UNIT``,
    ``read``)."""
    return {p.stem: _module(root, "metrics", p.stem)
            for p in sorted((Path(root) / "metrics").glob("*.py"))
            if not p.stem.startswith("_")}

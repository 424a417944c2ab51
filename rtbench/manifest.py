"""Finding a cell's files by name: `configs/<config>.json`,
`workloads/<cell>.json`, `traffic/<traffic>.json`, `metrics/<metric>.py`,
and the table of peaks. A later cell, configuration, traffic mix or
per-layer metric is a new file here; nothing in the code lists them."""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import re

ROOT = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
METRIC_FIELDS = ("NAME", "LAYER", "UNIT", "BETTER", "SOURCE", "MOVES",
                 "read")


def _json(root: str, folder: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a name")
    path = os.path.join(root, folder, f"{name}.json")
    with open(path) as f:
        return json.load(f)


def config(name: str, root: str = ROOT) -> dict:
    return _json(root, "configs", name)


def workload(name: str, root: str = ROOT) -> dict:
    return _json(root, "workloads", name)


def traffic(name: str, root: str = ROOT) -> dict:
    return _json(root, "traffic", name)


def peaks(root: str = ROOT) -> dict:
    with open(os.path.join(root, "peaks.json")) as f:
        return json.load(f)


def names(folder: str, ext: str, root: str = ROOT) -> list:
    """The names of the files of a folder with extension `ext`."""
    return sorted(os.path.basename(p)[:-len(ext)]
                  for p in glob.glob(os.path.join(root, folder, "*" + ext))
                  if not os.path.basename(p).startswith("_"))


def metric(name: str, root: str = ROOT):
    """The reader module of a per-layer metric (`metrics/<name>.py`)."""
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a name")
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"rtbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [f for f in METRIC_FIELDS if not hasattr(mod, f)]
    if missing or mod.NAME != name:
        raise ValueError(f"metric file {path}: missing {missing} or NAME "
                         f"{getattr(mod, 'NAME', None)!r} != {name!r}")
    return mod


def readers(root: str = ROOT) -> list:
    """The reader modules of every per-layer metric. Each reads what its
    cell's run recorded, and returns None where that is nothing, so the
    cells a metric covers are BENCHMARK.json's alone."""
    return [metric(name, root) for name in names("metrics", ".py", root)]

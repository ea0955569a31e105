"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the ``file`` of its ``configs`` entry, and its
``kind`` names the module that knows its model,
``portbench/kinds/<kind>.py`` (weights, FLOPs, the judge of ``correct``;
see ``kinds/unet.py``); the traffic mix is
``portbench/traffic/<traffic>.json``, which states the length of a traced
run's window (``trace_seconds``); each metric, end to end or per layer, is
read by ``portbench/metrics/<name>.py``'s ``read(run)``; a cell's limits
for ``correct`` are ``portbench/limits/<cell>.json``, one number each
besides ``readings``. A new cell, mix, configuration, kind or metric is a
new file and an entry, and no edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Callable, Dict, List

__all__ = [
    "NAME", "UNIT", "load_benchmark", "cell", "config_of", "traffic_of", "limits_of",
    "metrics_of", "reader", "kind_of", "check_names",
]

# the benchmark's folder, relative to the checkout's root
FOLDER = "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_benchmark(root: str) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json: {[w['name'] for w in bench['workloads']]}")


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def config_of(bench: Dict, root: str, name: str) -> Dict:
    """A configuration's file (its weights are drawn from the run's seed,
    ``portbench/weights.py``)."""
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return _json(os.path.join(root, entry["file"]))


def traffic_of(root: str, name: str) -> Dict:
    """A traffic mix, refused without a positive ``trace_seconds``."""
    traffic = _json(os.path.join(root, FOLDER, "traffic", f"{name}.json"))
    cap = traffic.get("trace_seconds")
    if isinstance(cap, bool) or not isinstance(cap, (int, float)) or cap <= 0:
        raise ValueError(f"traffic mix {name!r}: 'trace_seconds' (the length of a traced "
                         f"run's window, in seconds) must be a positive number, not {cap!r}")
    return traffic


def limits_of(root: str, cell_name: str) -> Dict:
    return _json(os.path.join(root, FOLDER, "limits", f"{cell_name}.json"))


def metrics_of(bench: Dict, cell_name: str, trace: bool) -> List[Dict]:
    """The metrics a cell reports: its end-to-end metrics (``trace`` off)
    or its per-layer metrics (``trace`` on). A metric without a
    ``workloads`` list belongs to every cell that reports what it moves."""
    e2e = [
        m for m in bench["end_to_end"]
        if "workloads" not in m or cell_name in m["workloads"]
    ]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}

    def belongs(m: Dict) -> bool:
        return cell_name in m["workloads"] if "workloads" in m else m["moves"] in names

    return [m for m in bench["per_layer"] if belongs(m)]


def _module(root: str, folder: str, name: str) -> ModuleType:
    path = os.path.join(root, FOLDER, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: str, name: str) -> Callable:
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    return _module(root, "metrics", name).read


def kind_of(root: str, name: str) -> ModuleType:
    """The module ``kinds/<name>.py`` of a configuration's ``kind``."""
    if not NAME.match(name):
        raise ValueError(f"kind {name!r} is not a name")
    return _module(root, "kinds", name)


def check_names(bench: Dict) -> List[str]:
    """Every name, unit and name-like field that breaks the benchmark's
    character rules."""
    bad = []
    names = [c["name"] for c in bench["configs"]]
    for w in bench["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    for c in bench["configs"]:
        names += list(c["reduced"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        names.append(m["name"])
        if not UNIT.match(m["unit"]):
            bad.append(m["unit"])
    bad += [n for n in names if not NAME.match(n)]
    return bad

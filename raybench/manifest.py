"""Everything a cell needs, found by name from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names its configuration and its
traffic mix; each is a file of its own under ``raybench/``:

  configs/<config>.json    the scene, camera, sun and render settings
  traffic/<traffic>.json   the loop's parameters (``loops.py`` reads them)
  cells/<workload>.json    the limits of the numbers that decide
                           ``correct``, and how many frames to compare
  metrics/<metric>.py      each metric's reader: ``read(ctx)``, and
                           ``UNIT`` (per-layer metrics also ``LAYER`` and
                           ``MOVES``)
  kinds/<kind>.py          a traffic kind of its own (``loops.kind``)

A metric belongs to a cell when its ``workloads`` list names the cell,
or when it has no such list.
"""

from __future__ import annotations

import importlib.util
import json
import os

HOME = "raybench"


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(root: str, kind: str, name: str) -> dict:
    with open(os.path.join(root, HOME, kind, f"{name}.json")) as fh:
        return json.load(fh)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(root: str, workload: str) -> dict:
    """The cell ``workload``: its manifest entry, configuration, traffic
    mix, limits and the metrics it reports (end-to-end and per-layer,
    in the manifest's order)."""
    bench = load(root)
    entry = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if entry is None:
        raise ValueError(f"no cell {workload!r} in BENCHMARK.json")
    return {"entry": entry,
            "config": _json(root, "configs", entry["config"]),
            "traffic": _json(root, "traffic", entry["traffic"]),
            "cell": _json(root, "cells", workload),
            "end_to_end": [m for m in bench["end_to_end"]
                           if _applies(m, workload)],
            "per_layer": [m for m in bench["per_layer"]
                          if _applies(m, workload)]}


def metric(root: str, name: str):
    """The reader module of metric ``name``."""
    return module(root, "metrics", name)


def module(root: str, sub: str, name: str):
    """The module ``raybench/<sub>/<name>.py`` under ``root``, loaded by
    its path."""
    path = os.path.join(root, HOME, sub, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"raybench_{sub}_{name.replace('.', '_')}", path)
    loaded = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loaded)
    return loaded

"""Fixtures of the benchmark's CPU tests: a checkout root in a temporary
folder that holds the benchmark at a tiny size (the same cells, traffic,
limits and metric readers; the configurations cut to 64 x 48 pixels of
the unsubdivided bunny)."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
HOME = os.path.dirname(HERE)
ROOT = os.path.dirname(HOME)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
TINY = {"width": 64, "height": 48}


def make_root(path, tiny=True):
    """A copy of the benchmark's files under ``path``; with ``tiny`` its
    configurations cut to TINY."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), path)
    for sub in ("configs", "traffic", "cells", "metrics", "kinds", "scenes"):
        shutil.copytree(os.path.join(HOME, sub),
                        os.path.join(path, "raybench", sub))
    if tiny:
        cdir = os.path.join(path, "raybench", "configs")
        for name in os.listdir(cdir):
            with open(os.path.join(cdir, name)) as fh:
                cfg = json.load(fh)
            cfg.update(TINY, subdivide=0)
            with open(os.path.join(cdir, name), "w") as fh:
                json.dump(cfg, fh)
    return str(path)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)

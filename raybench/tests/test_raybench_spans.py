"""The readers of the port's spans (``raybench/spans.py`` and the metrics
that read it) on made-up span rows, and the helper on a checkout whose
port has no spans."""

from __future__ import annotations

import sys
import types

import pytest
import torch

from conftest import ROOT
from raybench import manifest, spans


def _ctx(kind, rows, nodes=None, geometry="static"):
    traffic = {"kind": kind, "geometry": geometry}
    cache = {"spans": {"span_ms": rows, "nodes": nodes or [0] * len(rows),
                       "latency_ms": [1.0] * len(rows),
                       "latency_off_ms": [1.0] * len(rows)}}
    return types.SimpleNamespace(root=ROOT, cell={"traffic": traffic},
                                 cache=cache, dev=torch.device("cuda"),
                                 trace=object(), note=lambda *a: None)


def _ms(**totals):
    return {name.replace("_", "."): {"total": t, "self": t}
            for name, t in totals.items()}


def _read(name, ctx):
    return manifest.metric(ROOT, name).read(ctx)


FRAMES = [_ms(frame=10.0, walk=2.0, build=3.0),
          _ms(frame=12.0, walk=2.5, build=3.5),
          _ms(frame=11.0, walk=2.2, build=3.2)]


def test_frame_metrics():
    ctx = _ctx("frames", FRAMES, nodes=[1500, 1500, 1500],
               geometry="deforming")
    assert _read("walk_ms.frame", ctx) == pytest.approx(2.2)
    assert _read("walk_ms.bunny", ctx) == pytest.approx(2.2)
    assert _read("render_span_ms.static", ctx) == pytest.approx(5.6)
    assert _read("render_span_ms.bunny", ctx) == pytest.approx(5.6)
    assert _read("build_span_ms.deform", ctx) == pytest.approx(3.2)
    assert _read("graph_nodes.bunny", ctx) == 1500
    assert _read("bwd_fwd_span.fit", ctx) is None


def test_static_frames_read_no_build():
    rows = [_ms(frame=6.0, walk=0.6), _ms(frame=6.2, walk=0.5)]
    ctx = _ctx("frames", rows)
    assert _read("render_span_ms.static", ctx) == pytest.approx(5.55)
    assert _read("build_span_ms.deform", ctx) is None
    # Spans off at the capture: no nodes counted.
    assert _read("graph_nodes.bunny", ctx) is None


def test_fit_metric():
    rows = [_ms(step_forward=7.0, step_loss=1.0, step_backward=6.0,
                frame=6.5, walk=1.0),
            _ms(step_forward=7.5, step_loss=0.5, step_backward=7.2,
                frame=7.0, walk=1.0),
            _ms(step_forward=7.0, step_loss=1.0, step_backward=8.0,
                frame=6.5, walk=1.0)]
    ctx = _ctx("fit", rows)
    assert _read("bwd_fwd_span.fit", ctx) == pytest.approx(0.9)
    assert _read("walk_ms.frame", ctx) is None


def test_no_spans_in_the_port_reads_nothing(monkeypatch):
    import ceres_tpu_torch.utils

    monkeypatch.delattr(ceres_tpu_torch.utils, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "ceres_tpu_torch.utils.spans", None)
    ctx = _ctx("frames", [])
    ctx.cache = {}
    assert spans.read(ctx) is None
    for name in ("walk_ms.frame", "render_span_ms.static",
                 "build_span_ms.deform", "graph_nodes.bunny"):
        assert _read(name, ctx) is None

"""CUDA graphs: one call of a function captured and replayed, the port's
counterpart of ``jax.jit`` over the JAX package's frame and train step.

``capture(fn, inputs)`` warms ``fn`` up on a side stream (an eager call
that does its work and allocates what persists, such as Adam's state),
captures one more call with ``torch.cuda.graph`` and returns a
:class:`Graph`. ``Graph.replay()`` runs the captured kernels again on
the same memory: ``fn``'s inputs are read where they lay at capture, so
a caller changes them by copying into those tensors, and the outputs
are the captured call's tensors, overwritten by every replay. Nothing
on the host runs during a replay, so ``fn`` must not wait on the device
(no ``.item()``, no host copy, no shape that depends on data); a
capture that hits such a call raises.

The port's counters (``utils.spans.counters``: the walk kernels'
launches, ``ops.walk.launches``, among them) count in Python, which a
replay does not run: the capture records how far each counter rose and
every replay adds that, so the counts stay those of eager calls. The
warm-up call's counts are real and count as such.

With spans on (``utils.spans.enable``) the capture owns a span record
(``Graph.record``): the spans that ``fn`` opens stamp the card's clock
as nodes of the graph, so every replay times its phases (the record's
``span_ms()`` after a synchronise). The graph is then kept past its
capture long enough to count its nodes by type, less the stamps, which
each replay adds to the counter ``graph.nodes``. With spans off the
capture is the plain one.

Everything is on the card: a CPU tensor among the inputs or outputs
raises, and a failed capture or replay raises; there is no eager
fallback.
"""

from __future__ import annotations

import dataclasses

import torch

from ceres_tpu_torch.utils import spans


def tensors(x):
    """The tensors inside ``x``: nested tuples, lists, dict values and
    dataclass fields."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in tensors(v)]
    return []


def _on_card(x, what: str) -> None:
    for t in tensors(x):
        if t.device.type != "cuda":
            raise ValueError(f"a CUDA graph takes tensors on the card: "
                             f"{what} holds one on {t.device}")


class Graph:
    """A captured call: ``replay()`` reruns it and returns ``outputs``,
    the captured call's tensors, overwritten by each replay. ``first``
    is what the warm-up call returned; ``counts`` what a replay adds to
    each counter, by key (``launches``: the walk launches, by variant);
    ``record`` the span record (None: captured with spans off)."""

    def __init__(self, graph: torch.cuda.CUDAGraph, outputs, first,
                 counts: dict, record=None):
        self._graph = graph
        self.outputs = outputs
        self.first = first
        self.counts = counts
        self.launches = counts.get("walk.launches", {})
        self.record = record

    def replay(self):
        self._graph.replay()
        spans.add(self.counts)
        return self.outputs


def capture(fn, inputs=()) -> Graph:
    """Capture ``fn()`` as a CUDA graph after one eager call on a side
    stream. ``inputs`` are the tensors ``fn`` reads that a caller may
    change between replays (checked to lie on the card)."""
    _on_card(inputs, "the inputs")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        first = fn()
    torch.cuda.current_stream().wait_stream(side)
    before = spans.snapshot()
    traced = spans.enabled()
    graph = (torch.cuda.CUDAGraph(keep_graph=True) if traced
             else torch.cuda.CUDAGraph())
    try:
        with spans.recording("cuda") as record, torch.cuda.graph(graph):
            outputs = fn()
    finally:
        # The capture recorded its counts; it ran nothing.
        counts = spans.rose_since(before)
    _on_card(outputs, "the outputs")
    if traced:
        counts["graph.nodes"] = spans.graph_nodes(graph.raw_cuda_graph(),
                                                  record.stamps)
        graph.instantiate()
    return Graph(graph, outputs, first, counts, record)

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

The walk kernels count their launches in Python (``ops.walk.launches``),
which a replay does not run: the capture records how far each count
rose and every replay adds that, so the counts stay those of eager
calls. The warm-up call's launches are real and count as such.

Everything is on the card: a CPU tensor among the inputs or outputs
raises, and a failed capture or replay raises; there is no eager
fallback.
"""

from __future__ import annotations

import dataclasses

import torch

from ceres_tpu_torch.ops import walk


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
    is what the warm-up call returned; ``launches`` the walk
    launches a replay makes, by variant."""

    def __init__(self, graph: torch.cuda.CUDAGraph, outputs, first,
                 launches: dict):
        self._graph = graph
        self.outputs = outputs
        self.first = first
        self.launches = launches

    def replay(self):
        self._graph.replay()
        for name, n in self.launches.items():
            walk.launches[name] += n
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
    before = dict(walk.launches)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            outputs = fn()
    finally:
        # The capture recorded its launches; it ran none.
        launched = {k: walk.launches[k] - n for k, n in before.items()
                    if walk.launches[k] != n}
        walk.launches.update(before)
    _on_card(outputs, "the outputs")
    return Graph(graph, outputs, first, launched)

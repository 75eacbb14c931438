"""Spans and counters of the port: where a frame's or a train step's
time goes, timed on the device inside the CUDA graph that runs it.

Counters. ``counters`` maps a counter's name to its counts by key:
``walk.launches`` (walk kernel launches by variant, ``ops.walk``),
``lbvh.launches`` (the LBVH build's kernel launches, ``hierarchy`` and
``boxes``, ``accel.lbvh``), ``walk_f64.launches`` (the float64 walk
kernel's launches by mode, ``closest``, ``any`` and ``any_dest``,
``ops.walk_f64``; none on the CPU), ``walk_f64.clustered`` (those of
its launches that took the cluster form, by the same modes),
``prepass_f64.launches`` (the float64 prepass kernel's, by the same
modes) and ``graph.nodes`` (the nodes a replayed CUDA graph runs, by
type: kernel, memcpy, memset, other). A capture (``utils.graphs``)
records how far each counter rose and every replay adds that, so
replayed calls count as eager ones do; a capture made with spans on also
counts its graph's nodes, less its stamps, into ``graph.nodes`` at each
replay.

Spans. Off by default: ``enable(True)`` turns them on for the graphs
captured and the eager calls run after it (a graph keeps what it was
captured with). With spans off, ``span``, ``host`` and ``recording``
return one shared no-op context and nothing reaches the card. With them
on:

  * ``recording(device)`` opens a :class:`Record` (or joins the one
    open), the spans of one frame or step: each a name, its parent and
    two stamp slots;
  * ``span(name)`` stamps the open record at entry and at exit: on the
    card a one-thread kernel (``ceres_span_stamp`` in ``ops/csrc/walk.cu``)
    writes the card's global timer (ns) into the record's slot on the
    current stream, inside a graph as one of its nodes, so each replay
    writes its own times; on the CPU the host clock. It also opens a
    ``torch.profiler.record_function("ceres.<name>")`` host span, so a
    profiler trace shows the phase on the host beside its stamp kernels;
  * ``host(name)`` is the host span alone (``FrameGraph``'s input copies
    and replay launch).

The port's spans: ``frame``, ``primary``, ``shade``, ``build``,
``closest.prep``, ``closest.gather``, ``shadow.prep`` and ``walk`` (the
float32 walk kernels) in a frame, and inside each prep the float32
prepass, ``prepass.flat`` or ``prepass.hier`` by the form of the walk
(``ops.megakernel._walk_inputs``); ``prepass.f64`` and ``walk.f64`` in
each float64-exact search (``ops.walk_f64``: its prepass and its walk);
``step.refit``, ``step.forward``, ``step.loss``, ``step.backward`` and
``step.optim`` in a train step.

``Record.span_ms()``, after a synchronise, gives the milliseconds of the
last call (or replay) by span name: ``total`` (summed over the spans of
that name) and ``self`` (each span's duration less the union of its
children's intervals).
"""

from __future__ import annotations

import contextlib
import time

import torch

from ceres_tpu_torch.utils import native

# Stamp slots a record holds: two a span.
MAX_SLOTS = 1024
# cudaGraphNodeType values counted apart under graph.nodes; any other
# type counts as "other".
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}

counters: dict = {}
_NULL = contextlib.nullcontext()
_on = False
_open = None    # the record that spans stamp into, if any


def counter(name: str, keys) -> dict:
    """The counts of counter ``name`` by key (registered at zero on first
    use; every replay of a graph adds what its capture counted)."""
    return counters.setdefault(name, dict.fromkeys(keys, 0))


counter("graph.nodes", [*NODE_TYPES.values(), "other"])


def enable(on: bool = True) -> None:
    """Turn spans on or off for the captures and eager calls after it."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def snapshot() -> dict:
    """Every counter's counts, copied."""
    return {name: dict(c) for name, c in counters.items()}


def rose_since(before: dict) -> dict:
    """{counter: {key: rise}} of the counts that rose since ``before``
    (a ``snapshot``), each put back to its value there."""
    rose = {}
    for name, c in counters.items():
        was = before.get(name, {})
        up = {k: n - was.get(k, 0) for k, n in c.items()
              if n != was.get(k, 0)}
        if up:
            rose[name] = up
        c.update({k: was.get(k, 0) for k in c})
    return rose


def add(rose: dict) -> None:
    """Add a capture's rises (``rose_since``) to the counters."""
    for name, up in rose.items():
        c = counters[name]
        for k, n in up.items():
            c[k] += n


class Record:
    """The spans of one frame or step on ``device``: ``spans`` holds
    (name, parent index or -1, start slot, end slot) in the order they
    opened. On the card the stamps lie in ``slots`` (int64 ns of the
    global timer), on the CPU in a list of host-clock ns."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.spans = []
        self.stamps = 0
        self._stack = []
        self._host = []
        self.slots = None
        if self.device.type == "cuda":
            self.slots = torch.zeros(MAX_SLOTS, dtype=torch.int64,
                                     device=self.device)

    def stamp(self) -> int:
        k = self.stamps
        if k >= MAX_SLOTS:
            raise RuntimeError(f"spans: a record holds {MAX_SLOTS} stamps")
        self.stamps += 1
        if self.slots is None:
            self._host.append(time.perf_counter_ns())
            return k
        native.launch("walk", "ceres_span_stamp",
                      [("slots", self.slots, torch.int64, (MAX_SLOTS,))], [k])
        return k

    @contextlib.contextmanager
    def span(self, name: str):
        i = len(self.spans)
        parent = self._stack[-1] if self._stack else -1
        self.spans.append([name, parent, self.stamp(), None])
        self._stack.append(i)
        try:
            yield
        finally:
            self._stack.pop()
            self.spans[i][3] = self.stamp()

    def times_ns(self) -> list:
        """The stamps (ns) of the last call or replay; on the card this
        waits for the device."""
        if self.slots is None:
            return list(self._host)
        return self.slots[:self.stamps].tolist()

    def span_ms(self) -> dict:
        """{name: {"total": ms, "self": ms}} of the last call or replay
        (see :func:`span_ms`)."""
        return span_ms(self.spans, self.times_ns())


def span_ms(spans, stamps) -> dict:
    """Milliseconds by span name of (name, parent, start slot, end slot)
    rows over ``stamps`` (ns by slot): ``total`` the summed durations,
    ``self`` the summed durations less the union of each span's
    children's intervals."""
    kids = {}
    for name, parent, a, b in spans:
        kids.setdefault(parent, []).append((stamps[a], stamps[b]))
    out = {}
    for i, (name, _, a, b) in enumerate(spans):
        total = stamps[b] - stamps[a]
        covered, end = 0, None
        for s, e in sorted(kids.get(i, ())):
            s = s if end is None else max(s, end)
            if e > s:
                covered += e - s
                end = e
        row = out.setdefault(name, {"total": 0.0, "self": 0.0})
        row["total"] += total / 1e6
        row["self"] += (total - covered) / 1e6
    return out


@contextlib.contextmanager
def _recording(device):
    global _open
    if _open is not None:
        yield _open
        return
    _open = Record(device)
    try:
        yield _open
    finally:
        _open = None


def recording(device):
    """A context that collects the spans opened inside it into one
    :class:`Record` on ``device`` (the one open, if any), given by its
    ``as``; with spans off, the shared no-op context (``as`` None)."""
    return _recording(device) if _on else _NULL


@contextlib.contextmanager
def _span(name):
    with torch.profiler.record_function(f"ceres.{name}"):
        if _open is None:
            yield
        else:
            with _open.span(name):
                yield


def span(name: str):
    """A span of the open record (device stamps at entry and exit) and a
    ``ceres.<name>`` host span; with spans off, the shared no-op
    context."""
    return _span(name) if _on else _NULL


def host(name: str):
    """A ``ceres.<name>`` host span alone; with spans off, the shared
    no-op context."""
    return torch.profiler.record_function(f"ceres.{name}") if _on else _NULL


def graph_nodes(raw_graph, stamps: int) -> dict:
    """The nodes of a captured CUDA graph (``CUDAGraph.raw_cuda_graph()``
    of a graph captured with ``keep_graph=True``) by type, less
    ``stamps`` stamp kernels."""
    import ctypes

    lib = native.load("walk")
    counts = (ctypes.c_longlong * (len(NODE_TYPES) + 1))()
    err = lib.ceres_graph_nodes(raw_graph, counts)
    if err != 0:
        raise RuntimeError(f"ceres_graph_nodes failed: "
                           f"{native.error_text(lib, err)}")
    out = dict(zip([*NODE_TYPES.values(), "other"], counts))
    out["kernel"] -= stamps
    return out

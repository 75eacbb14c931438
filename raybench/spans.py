"""The port's own spans and counters (``ceres_tpu_torch.utils.spans``),
read in a ``--trace 1`` run for the per-layer metrics that time a
frame's or a step's phases on the card: ``walk_ms.*``,
``render_span_ms.*``, ``build_span_ms.deform``, ``bwd_fwd_span.fit`` and
``graph_nodes.bunny``.

``read(ctx)``, once a run (``ctx.cache``), turns the port's spans on and
makes a second loop of the cell with ``loops.make`` (the same
configuration, traffic and seed: ``ctx.seed``), whose frame or step is
captured with the spans on. It runs that loop for WARM_SECONDS, then on
until the card launches a graph's kernels in its fast mode, as the
harness waits before its window (``harness.await_fast_launches``), since
the slow mode lengthens the gaps between a graph's kernels and so its
spans (after a trace, a bunny frame's ``frame`` span once read 6.47
against 6.00 ms, NVIDIA H100). Standard error gets the probe's
readings: the launch mode the spans were read in. Then it makes as
many calls as the trace took, each synchronised, and after each reads
the span milliseconds of its replay (``FrameGraph.span_ms()``, the
step's ``span_ms()``) and how far the counter ``graph.nodes`` rose.
Before each it makes one call of the cell's own loop (captured with the
spans off), timed alike. Then it turns the spans off and frees the loop.
Standard error gets the median host latency of the spanned calls against
the window's and against the own loop's calls made in turn with them:
what the spans cost when on. The second is the like-for-like comparison:
a ``torch.profiler`` session leaves each later graph launch of the
process ~0.35 ms slower on the host (a bunny frame, NVIDIA H100), and
the trace precedes these calls but not the window. The trace, the window
and every reader before this one ran with the spans off.

It returns None off the card, without a trace, or where the port has no
spans (a checkout from before them).
"""

from __future__ import annotations

import statistics
import time

import torch

from raybench import harness, loops

WARM_SECONDS = 2.0


def read(ctx):
    """{"span_ms": [each call's {name: {"total", "self"}}], "nodes":
    [each call's graph nodes], "latency_ms": [each call's host ms],
    "latency_off_ms": [the host ms of the own loop's call before it]},
    or None."""
    if "spans" not in ctx.cache:
        ctx.cache["spans"] = _measure(ctx)
    return ctx.cache["spans"]


def _measure(ctx):
    if ctx.trace is None or ctx.dev.type != "cuda":
        return None
    try:
        from ceres_tpu_torch.utils import spans
    except ImportError:
        ctx.note("spans: the port has no spans; their metrics read nothing")
        return None
    cfg, traffic = ctx.cell["config"], ctx.cell["traffic"]
    kind = traffic["kind"]
    spans.enable(True)
    try:
        loop = loops.make(cfg, traffic, ctx.seed, ctx.root, ctx.dev,
                          lambda label: ctx.note(f"spans loop: {label}"))
        span_ms = (loop.step.span_ms if kind == "fit"
                   else loop.graph.span_ms)
        i = traffic["held_steps"] if kind == "fit" else 0
        until = time.perf_counter() + WARM_SECONDS
        while time.perf_counter() < until:
            loop.call(i)
            torch.cuda.synchronize()
            i += 1
        i, waited, readings = harness.await_fast_launches(
            loop, i, harness.LaunchProbe(ctx.dev))
        ctx.note(f"spans: waited {waited:.6f} s for the card's fast "
                 f"launches: the probe's us a kernel "
                 f"{[round(x, 4) for x in readings]}")
        nodes = spans.counters["graph.nodes"]
        out = {"span_ms": [], "nodes": [], "latency_ms": [],
               "latency_off_ms": []}
        for k in range(ctx.trace.calls):
            spans.enable(False)
            out["latency_off_ms"].append(
                _timed(ctx.loop.call, ctx.next_call + k))
            spans.enable(True)
            before = sum(nodes.values())
            out["latency_ms"].append(_timed(loop.call, i + k))
            out["nodes"].append(sum(nodes.values()) - before)
            out["span_ms"].append(span_ms())
    finally:
        spans.enable(False)
    loop.free()
    del loop, span_ms
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    on = statistics.median(out["latency_ms"])
    window = statistics.median(ctx.window["latencies"]) * 1e3
    off = statistics.median(out["latency_off_ms"])
    ctx.note(f"spans on: {len(out['latency_ms'])} calls, host ms a call "
             f"median {on:.6f} against the window's {window:.6f} "
             f"({100.0 * (on / window - 1.0):+.3f}%) and the own loop's in "
             f"turn {off:.6f} ({100.0 * (on / off - 1.0):+.3f}%); graph "
             f"nodes a call {sorted(set(out['nodes']))}")
    for name in out["span_ms"][-1]:
        rows = [ms[name] for ms in out["span_ms"]]
        ctx.note(f"spans ms a call, median: {name} total "
                 f"{statistics.median(r['total'] for r in rows):.6f} self "
                 f"{statistics.median(r['self'] for r in rows):.6f}")
    return out


def _timed(call, i) -> float:
    """Host ms of ``call(i)`` to the end of its synchronise."""
    t0 = time.perf_counter()
    call(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def median_of(ctx, value):
    """The median over the spanned calls of ``value(span_ms)``, or None
    (no spans, or ``value`` None for a call)."""
    got = read(ctx)
    if got is None:
        return None
    values = [value(ms) for ms in got["span_ms"]]
    if not values or any(v is None for v in values):
        return None
    return statistics.median(values)


def total(ms: dict, name: str) -> float:
    """A call's total milliseconds of the spans named ``name`` (0 when it
    has none)."""
    return ms.get(name, {}).get("total", 0.0)

"""The device trace of a few frames or steps of a cell's loop, and what
the per-layer metrics read from it.

``record(fn, n)`` runs ``fn(i)`` n + 1 times under ``torch.profiler``
(CPU and CUDA activities), each call inside a ``raybench.frame`` span.
The traced window runs from the second span's start to the last one's
end: the first call takes the profiler's own start-up.
``busy`` is the union of the device operations' intervals (kernels,
copies, fills) inside it: a frozen copy of ``frame_profile.py``'s
``_union``. Idle gaps are named by the innermost host-side event (a
harness span or a CUDA runtime call) that covers the gap's midpoint.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
import time

import torch

FRAME_SPAN = "raybench.frame"


def union(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def merged(intervals):
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclasses.dataclass
class Trace:
    """Times in microseconds on the profiler's clock."""

    device: list        # (name, start, end) of each device operation
    host: list          # (name, start, end) of each host-side event
    start: float        # the traced window
    end: float
    calls: int          # frames or steps traced

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def clipped(self):
        return [(a, b) for _, a, b in self.clipped_named()]

    @property
    def busy_s(self) -> float:
        return union(self.clipped()) / 1e6

    def device_ms_per_call(self, keep=lambda name: True) -> float:
        """Device milliseconds a call of the operations whose name
        ``keep`` accepts (their summed durations in the window)."""
        return sum(b - a for n, a, b in self.clipped_named()
                   if keep(n)) / 1e3 / self.calls

    def clipped_named(self):
        return [(n, max(a, self.start), min(b, self.end))
                for n, a, b in self.device if b > self.start and a < self.end]

    def top_ops(self, k=10):
        """[name, seconds] of the k operations that took most device time
        in the window, summed by name."""
        by = collections.Counter()
        for n, a, b in self.clipped_named():
            by[n] += (b - a) / 1e6
        return [[n, s] for n, s in by.most_common(k)]

    def idle_gaps(self, k=10):
        """[name, seconds] of the k longest idle gaps of the device in
        the window, each named by what the host was doing."""
        busy = merged(self.clipped())
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        gaps = [(b - a, a, b) for a, b in zip(edges[::2], edges[1::2])
                if b > a]
        out = []
        for length, a, b in sorted(gaps, reverse=True)[:k]:
            mid = 0.5 * (a + b)
            inside = [(e - s, n) for n, s, e in self.host if s <= mid <= e]
            out.append([min(inside)[1] if inside else "host (no event)",
                        length / 1e6])
        return out


def host_share(launch, n: int) -> float:
    """The median over n calls of the share of a call's host latency
    (from the call to the end of the synchronise after it) that its CUDA
    events (recorded before and after ``launch(i)`` on the current
    stream) do not span: the time the card waits on the host to launch,
    copy and synchronise. Untraced."""
    shares = []
    for i in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        launch(i)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        shares.append(1.0 - start.elapsed_time(end) / host_ms)
    return statistics.median(shares)


def activities(cuda: bool = True):
    """The profiler's activities: CPU, and CUDA on the card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def spanned(call, cuda: bool = True):
    """``call()`` inside a FRAME_SPAN span, synchronised on the card."""
    with torch.profiler.record_function(FRAME_SPAN):
        out = call()
        if cuda:
            torch.cuda.synchronize()
    return out


def record(fn, n: int, cuda: bool = True) -> Trace:
    """Trace n calls of ``fn(i)``, each synchronised, as the cell's loop
    runs them (``cuda`` False: host events only, for the CPU tests)."""
    if cuda:
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities(cuda)) as prof:
        for i in range(n + 1):
            spanned(lambda: fn(i), cuda)
    return reduce(prof, n)


def reduce(prof, n: int) -> Trace:
    """The Trace of a finished profiler session ``prof`` that made n + 1
    spanned calls (``spanned``)."""
    device, host, spans = [], [], []
    for e in prof.events():
        iv = (e.name, e.time_range.start, e.time_range.end)
        if e.name == FRAME_SPAN:
            # The span's own range on the device's timeline is no work.
            if e.device_type != torch.autograd.DeviceType.CUDA:
                spans.append(iv)
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(iv)
        else:
            host.append(iv)
    spans.sort(key=lambda iv: iv[1])
    host += spans
    return Trace(device=device, host=host, start=spans[1][1],
                 end=max(e for _, _, e in spans), calls=n)

"""One run of one cell: set-up, the measured window, the traced frames
(``--trace 1``), the reference check, and the result line.

``run_cell`` takes the device it runs on, so that the CPU tests can
drive a whole run at a tiny size; ``run.py`` refuses to run without a
card, or with fewer cards than the cell's ``chips``.

A loop of a kind found by file (``loops.kind``) may also define:

  * ``returns``: what its calls return, as the built-in kinds do:
    ``"frames"`` ((image, stats): the window sums ``stats["rays"]`` and
    keeps the compared outputs) or ``"fit"`` (a loss);
  * ``check(window)``: the numbers that decide ``correct``, in place of
    the built-in kinds' ``_check``;
  * for a cell over several cards (its ``chips``, which the harness
    reports as ``device.count``; the loop runs the other ranks,
    ``ranks.py``): ``announce(i)``, which the window calls before call
    i's clock starts (the hand-off to the other ranks),
    ``over_ranks(device)``, which gives the ``device`` object the peak
    memory of the fullest card and the busy seconds averaged over the
    cards, and ``abandon()``, which ends the other ranks where the run
    raises.
"""

from __future__ import annotations

import dataclasses
import math
import random
import statistics
import sys
import time

import torch

from raybench import compare, loops, manifest, trace

# Seconds of the loop run before the window, after its capture.
WARM_SECONDS = 2.0
# The card's launch mode. On the H100 machines this benchmark was built
# on, each kernel that a CUDA graph launches costs ~0.35 us more for the
# first 15-45 s of a process, in every graph of the process at once, and
# then less for good: a bunny frame of ~1,390 kernels replays in 6.55
# against 6.05 ms, and a graph of 1,000 one-element adds, replayed three
# times after a second of frames or steps, in 1.16-1.25 against
# 1.00-1.04 us a kernel (the median of the three).
# Before the window the loop runs on until the harness's own such graph
# (PROBE_NODES adds) replays at FAST_US_PER_NODE or less a kernel, or
# DROP below the slow level (the median of its first three readings, so
# that one spiked reading sets no level), on CONFIRM readings in a row,
# or for MODE_WAIT_S at most. On those machines the slow mode lasted
# 50 s in 1 of 15 processes of the deforming 4x bunny's frames, and over
# 60 s in 2 of 12 of the static bunny's: a mode that ends early in the
# window sets a frame cell's p95.
# The wait is the machine's, not the program's set-up: setup_s leaves
# it out.
PROBE_NODES = 1000
FAST_US_PER_NODE = 1.1
DROP = 0.08
CONFIRM = 2
MODE_WAIT_S = 180.0
PROBE_EVERY_S = 0.25
# Seconds of the loop that a trace covers, and its least number of calls.
TRACE_SECONDS = 0.5
TRACE_CALLS = 5


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Context:
    """What a metric's reader sees."""

    root: str
    dev: torch.device
    cell: dict
    loop: object
    window: dict
    seed: int
    trace: object = None
    next_call: int = 0
    note: object = log
    # What readers compute once a run and share (``walks`` of the
    # frame's walk inputs).
    cache: dict = dataclasses.field(default_factory=dict)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _window(loop, kind, dev, seconds, first, keep):
    """Run the loop for ``seconds``: each call from the moment it hands
    the frame its inputs to the end of the synchronise that makes its
    result ready. Frames' rays are summed on the device and read once.
    ``keep``: window-relative indices whose outputs are cloned."""
    lat, kept, i, failed = [], {}, 0, 0
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    announce = getattr(loop, "announce", None)
    start = time.perf_counter()
    while True:
        if announce is not None:
            announce(first + i)
        t0 = time.perf_counter()
        out = loop.call(first + i)
        if kind == "frames":
            image, stats = out
            rays += stats["rays"]
            if i in keep:
                kept[i] = (image.clone(), {k: stats[k].clone()
                                           for k in ("rays", "hits")})
        _sync(dev)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        i += 1
        if kind == "fit" and not math.isfinite(out):
            failed += 1
        if t1 - start >= seconds:
            break
    if kind == "frames":
        kept[i - 1] = (out[0].clone(), {k: out[1][k].clone()
                                        for k in ("rays", "hits")})
    return {"latencies": lat, "seconds": t1 - start, "calls": i,
            "first": first, "failed": failed,
            "rays": int(rays) if kind == "frames" else 0,
            "kept": kept}


class LaunchProbe:
    """The harness's graph of PROBE_NODES one-element adds; ``us()`` is
    the median over three replays of its CUDA-event span a kernel, in
    microseconds."""

    def __init__(self, dev):
        self.x = torch.zeros(1, device=dev)
        self.x.add_(1.0)
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(PROBE_NODES):
                self.x.add_(1.0)
        torch.cuda.synchronize()

    def us(self) -> float:
        spans = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            self.graph.replay()
            end.record()
            torch.cuda.synchronize()
            spans.append(start.elapsed_time(end) * 1e3 / PROBE_NODES)
        return statistics.median(spans)


def _fast(readings) -> bool:
    """Whether the probe's newest reading is the fast mode's."""
    r = readings[-1]
    return r <= FAST_US_PER_NODE or (
        len(readings) > 3
        and r <= (1.0 - DROP) * statistics.median(readings[:3]))


def await_fast_launches(loop, first, probe, sync=torch.cuda.synchronize):
    """Run the loop from call ``first`` until the card launches a graph's
    kernels in its fast mode (see FAST_US_PER_NODE); returns (the next
    call, the seconds waited, the probe's readings)."""
    t0 = time.perf_counter()
    readings, fast = [probe.us()], 0
    while True:
        fast = fast + 1 if _fast(readings) else 0
        if fast >= CONFIRM or time.perf_counter() - t0 >= MODE_WAIT_S:
            break
        until = time.perf_counter() + PROBE_EVERY_S
        while time.perf_counter() < until:
            loop.call(first)
            sync()
            first += 1
        readings.append(probe.us())
    return first, time.perf_counter() - t0, readings


def _clocks() -> str:
    """The card's SM clock, power draw and temperature (nvidia-smi)."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"


def _device(dev, tr, loop=None, count=1):
    if dev.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
               "count": count,
               "memory_peak_bytes": torch.cuda.max_memory_allocated(dev)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": count,
               "memory_peak_bytes": 0}
    if tr is not None:
        out["busy_s"] = tr.busy_s
        out["window_s"] = tr.window_s
    over_ranks = getattr(loop, "over_ranks", None)
    return out if over_ranks is None else over_ranks(out)


def run_cell(root: str, workload: str, seed: int, seconds: float,
             traced: bool, dev, t_start: float) -> dict:
    """One run; returns the result line's object (``compared`` last)."""
    dev = torch.device(dev)
    spec = manifest.cell(root, workload)
    cfg, traffic = spec["config"], spec["traffic"]
    probe = None
    if dev.type == "cuda":
        probe = LaunchProbe(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    def mark(label):
        _sync(dev)
        log(f"set-up: {label} at {time.perf_counter() - t_start:.6f} s")

    mark("imports and the card's context")
    loop = loops.make(cfg, traffic, seed, root, dev, mark,
                      spec["entry"]["chips"])
    try:
        return _run(loop, root, workload, seed, seconds, traced, dev,
                    t_start, spec, probe, mark)
    except BaseException:
        abandon = getattr(loop, "abandon", None)
        if abandon is not None:
            abandon()
        raise


def _run(loop, root, workload, seed, seconds, traced, dev, t_start, spec,
         probe, mark) -> dict:
    """``run_cell`` once its loop is set up."""
    traffic, limits = spec["traffic"], spec["cell"]
    kind = traffic["kind"]
    returns = getattr(loop, "returns", kind)
    # Calls are numbered from the first of the loop: the fit's held
    # steps were its first.
    first = traffic["held_steps"] if kind == "fit" else 0
    warm_until = time.perf_counter() + WARM_SECONDS
    while time.perf_counter() < warm_until:
        loop.call(first)
        _sync(dev)
        first += 1
    mark("warm-up by time")
    waited = 0.0
    if probe is not None:
        first, waited, readings = await_fast_launches(loop, first, probe)
        log(f"waited {waited:.6f} s for the card's fast launches: the "
            f"probe's us a kernel {[round(x, 4) for x in readings]}")
    log(f"card before the window: {_clocks()}")
    keep = set()
    if returns == "frames":
        keep = {random.Random(seed).randrange(limits["draw_from"])}
    # Neither the reference's seconds in set-up (the fit's target frame)
    # nor the wait for the card's launch mode are the program's.
    setup_s = time.perf_counter() - t_start - loop.reference_s - waited
    window = _window(loop, returns, dev, seconds, first, keep)
    window["setup_s"] = setup_s
    log(f"card after the window: {_clocks()}")
    first += window["calls"]
    ctx = Context(root=root, dev=dev, cell=spec, loop=loop,
                  window=window, seed=seed, next_call=first)
    lat_ms = sorted(x * 1e3 for x in window["latencies"])
    tenth = max(1, len(lat_ms) // 10)
    by_tenth = [statistics.median(window["latencies"][k:k + tenth]) * 1e3
                for k in range(0, min(tenth * 10, len(lat_ms)), tenth)]
    log(f"raybench {workload} seed {seed}: {window['calls']} calls in "
        f"{window['seconds']:.6f} s; ms a call: median "
        f"{statistics.median(lat_ms):.6f}, min {lat_ms[0]:.6f}, max "
        f"{lat_ms[-1]:.6f}; medians by tenth of the window "
        f"{[round(x, 3) for x in by_tenth]}; set-up {setup_s:.6f} s")

    tr = None
    if traced:
        med = statistics.median(window["latencies"])
        n = max(TRACE_CALLS, int(TRACE_SECONDS / med) + 1)
        tr = ctx.trace = trace.record(lambda i: loop.call(first + i), n,
                                      dev.type == "cuda")
        ctx.next_call = first + n + 1   # the traced calls, the first dropped
    device = _device(dev, tr, loop, spec["entry"]["chips"])

    metrics = {}
    wanted = spec["per_layer"] if traced else spec["end_to_end"]
    for m in wanted:
        value = manifest.metric(root, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": False, "attempted": window["calls"],
              "failed": window["failed"],
              "metrics": metrics, "device": device}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}

    check = getattr(loop, "check", None)
    numbers = (_check(loop, kind, window, traffic, dev) if check is None
               else check(window))
    ok, rows = compare.judge(numbers, limits["limits"])
    result["correct"] = ok and result["failed"] == 0
    result["compared"] = {k: {"value": x, "limit": lim} for k, x, lim in rows}
    for k, x, lim in rows:
        log(f"compared {k} {x!r} limit {lim!r}")
    return result


def _check(loop, kind, window, traffic, dev) -> dict:
    """Free the port's state, then hold what the timed path produced to
    the reference."""
    sc = loop.scene
    if kind == "frames":
        kept = [(img, st, *loop.inputs(window["first"] + i))
                for i, (img, st) in sorted(window.pop("kept").items())]
        loop.free()
        _free(dev)
        return compare.frames(kept, sc)
    held, start, target = loop.held, loop.start, loop.target
    loop.free()
    _free(dev)
    ref = compare.reference_fit(start, sc, target, traffic["held_steps"],
                                traffic["lr"])
    return compare.fit_numbers(held, start, *ref)


def _free(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

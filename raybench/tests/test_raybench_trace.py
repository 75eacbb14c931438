"""The trace reduction on a made-up timeline: busy share, per-call
device time, and the named gaps."""

from __future__ import annotations

import pytest

from raybench import trace


def _trace():
    device = [("walk_tile<0>", 1, 3), ("mul", 4, 6), ("mul", 5, 7),
              ("walk_tile<0>", 12, 13), ("add", 15, 16)]
    host = [("cudaGraphLaunch", 0, 1), ("cudaGraphLaunch", 10, 12),
            ("cudaDeviceSynchronize", 7, 10), (trace.FRAME_SPAN, 0, 9),
            (trace.FRAME_SPAN, 10, 17)]
    return trace.Trace(device=device, host=host, start=0, end=17, calls=2)


def test_union_and_busy():
    assert trace.union([(1, 3), (2, 5), (7, 8)]) == 5
    assert _trace().busy_s == pytest.approx(7e-6)
    assert _trace().window_s == pytest.approx(17e-6)


def test_device_time_per_call():
    tr = _trace()
    assert tr.device_ms_per_call() == pytest.approx(8e-3 / 2)
    assert tr.device_ms_per_call(lambda n: "walk" in n) == pytest.approx(
        3e-3 / 2)


def test_gaps_are_named_by_the_host():
    gaps = _trace().idle_gaps()
    assert gaps[0] == ["cudaDeviceSynchronize", pytest.approx(5e-6)]
    assert gaps[1] == [trace.FRAME_SPAN, pytest.approx(2e-6)]
    assert [round(s * 1e6) for _, s in gaps] == [5, 2, 1, 1, 1]

"""The wait for the card's fast graph launches before the window ends on
the probe's absolute reading or on a drop from the slow level (the
median of its first three readings), seen on CONFIRM readings in a row,
or at the cap, and runs the cell's loop meanwhile."""

from __future__ import annotations

import pytest

from raybench import harness


class _Probe:
    def __init__(self, readings):
        self.readings = list(readings)

    def us(self):
        return self.readings.pop(0) if len(self.readings) > 1 \
            else self.readings[0]


class _Loop:
    def __init__(self):
        self.calls = []

    def call(self, i):
        self.calls.append(i)


@pytest.fixture(autouse=True)
def _short(monkeypatch):
    monkeypatch.setattr(harness, "PROBE_EVERY_S", 0.001)
    monkeypatch.setattr(harness, "MODE_WAIT_S", 0.2)


@pytest.mark.parametrize("readings, n", [
    ([1.02, 1.02], 2),                          # fast from the start
    ([1.37, 1.37, 1.36, 1.03, 1.02], 5),        # the switch, under the bound
    ([1.60, 1.61, 1.59, 1.35, 1.36], 5),        # a drop of DROP from the level
    ([1.37, 1.03, 1.37, 1.36, 1.02, 1.03], 6),  # one fast reading alone
    ([2.00, 1.37, 1.37, 1.36, 1.37, 1.03, 1.02], 7),  # a spiked first reading
])
def test_the_wait_ends_at_the_fast_mode(readings, n):
    loop = _Loop()
    nxt, waited, got = harness.await_fast_launches(loop, 7, _Probe(readings),
                                                   sync=lambda: None)
    assert got == readings[:n]
    assert loop.calls == list(range(7, nxt))
    assert len(loop.calls) > 0
    assert waited < harness.MODE_WAIT_S + 0.1


def test_the_wait_ends_at_the_cap():
    loop = _Loop()
    _, waited, got = harness.await_fast_launches(loop, 0, _Probe([1.37]),
                                                 sync=lambda: None)
    assert harness.MODE_WAIT_S <= waited < harness.MODE_WAIT_S + 0.1
    assert set(got) == {1.37} and len(loop.calls) > 0

"""``correct`` comes out false when the timed path is broken underneath
a whole run (on the CPU, at a tiny size, past the look for a card), and
for the control: the reference in bfloat16 put in the port's place.

Faults, each planted in the port where its answer is produced: an
altered frame (a block of pixels inverted); a deforming frame that keeps
its old vertices (its state unchanged); a train step that returns its
state unchanged; a loss over half the image (the mean over that half);
steps after the first (on the card, the replays of the captured step)
whose gradient is halved while their loss is not.
The four-rank cell's faults (one rank's rows altered, a rank that
raises) are in ``test_raybench_ranks.py``."""

from __future__ import annotations

import time

import pytest
import torch

from raybench import compare, control, harness, manifest

SEED = 2**33 + 5


def _run(root, cell, seconds=0.2):
    return harness.run_cell(root, cell, SEED, seconds, False, "cpu",
                            time.perf_counter())


def _values(out):
    return {k: v["value"] for k, v in out["compared"].items()}


def test_a_sound_frame_is_correct(tiny_root):
    out = _run(tiny_root, "bunny-1080p.static")
    assert out["correct"], out["compared"]


def test_an_altered_frame_is_not_correct(tiny_root, monkeypatch):
    from ceres_tpu_torch.render import renderer

    real = renderer.render_pipeline

    def altered(*args, **kwargs):
        image, stats = real(*args, **kwargs)
        image = image.clone()
        image[:8, :8] = 1.0 - image[:8, :8]
        return image, stats

    monkeypatch.setattr(renderer, "render_pipeline", altered)
    out = _run(tiny_root, "bunny-1080p.static")
    assert not out["correct"]
    assert _values(out)["px_off_pct"] > 1.0


def test_a_deforming_frame_that_keeps_its_vertices(tiny_root, monkeypatch):
    from ceres_tpu_torch.render import renderer

    real = renderer.FrameGraph.__call__

    def stale(self, sun_position=None, camera=None, vertices=None):
        return real(self, sun_position=sun_position, camera=camera)

    assert _run(tiny_root, "bunny4x-1080p.deform")["correct"]
    monkeypatch.setattr(renderer.FrameGraph, "__call__", stale)
    out = _run(tiny_root, "bunny4x-1080p.deform")
    assert not out["correct"]
    assert _values(out)["px_off_pct"] > 1.0


@pytest.fixture(scope="module")
def sound_fit(tmp_path_factory):
    from conftest import make_root

    root = make_root(tmp_path_factory.mktemp("fit"))
    return root, _values(_run(root, "bunny-1080p.fit"))


def test_a_step_that_returns_its_state_unchanged(sound_fit, monkeypatch):
    from ceres_tpu_torch.diff import inverse

    root, sound = sound_fit
    real = inverse.make_train_step

    def unchanged(*args, **kwargs):
        step = real(*args, **kwargs)

        def call(state, target):
            before = [p.detach().clone() for p in state.params.values()]
            out = step(state, target)
            with torch.no_grad():
                for p, b in zip(state.params.values(), before):
                    p.copy_(b)
            return out
        return call

    monkeypatch.setattr(inverse, "make_train_step", unchanged)
    out = _run(root, "bunny-1080p.fit")
    assert not out["correct"]
    assert _values(out)["change_gap"] == pytest.approx(1.0)
    assert sound["change_gap"] < 0.3


def test_a_loss_over_half_the_image(sound_fit, monkeypatch):
    from ceres_tpu_torch.diff import inverse

    root, sound = sound_fit

    def half(rendered, target):
        rows = rendered.shape[0] // 2
        return torch.mean((rendered[:rows] - target[:rows]) ** 2)

    monkeypatch.setattr(inverse, "image_loss", half)
    out = _run(root, "bunny-1080p.fit")
    assert not out["correct"]
    got = _values(out)
    assert max(got[k] / max(sound[k], 1e-12) for k in got) > 3


class _HalvedGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return 0.5 * grad


def test_later_steps_with_a_wrong_gradient(sound_fit, monkeypatch):
    from ceres_tpu_torch.diff import inverse

    root, sound = sound_fit
    real, calls = inverse.image_loss, []

    def halved_after_the_first(rendered, target):
        calls.append(1)
        value = real(rendered, target)
        return value if len(calls) == 1 else _HalvedGradient.apply(value)

    monkeypatch.setattr(inverse, "image_loss", halved_after_the_first)
    out = _run(root, "bunny-1080p.fit")
    assert not out["correct"]
    got = _values(out)
    assert got["last_grad_gap"] == pytest.approx(0.5, abs=0.05)
    assert got["grad_gap"] == pytest.approx(sound["grad_gap"])
    assert sound["last_grad_gap"] < 0.05


@pytest.mark.parametrize("cell", ["bunny-1080p.static",
                                  "bunny4x-1080p.deform", "bunny-1080p.fit",
                                  "bunny-1080p.frames4"])
def test_the_control_is_not_correct(tiny_root, cell):
    limits = manifest.cell(tiny_root, cell)["cell"]["limits"]
    readings = control.readings(tiny_root, cell, SEED, "cpu")
    ok, _ = compare.judge(readings["control"], limits)
    assert not ok, readings

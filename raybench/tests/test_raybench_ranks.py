"""Traffic kinds found by file, and a cell over several ranks: on the CPU,
at a tiny size, with gloo ranks (``bunny-1080p.frames4``'s four).

A made-up kind, with its traffic mix, cell and metrics, is found by name
and runs through ``run_cell``. The four-rank turntable is correct; it
is not when one rank's rows are altered where they are rendered, when
the exchange between the ranks is left out (each rank keeps its own
block and stats), when every frame keeps frame 0's camera, or when half
of the batch is left out; a rank that raises ends the run at once with
its traceback, no result and no process left. Ranks started before rank
0 loads torch are the group's; a rank that holds JAX refuses the run.
The spans loop takes the run's seed from the Context, and the kind's
plain turntable is the port's."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import textwrap
import time
import types

import pytest
import torch

from conftest import ROOT
from raybench import harness, loops, manifest, ranks, spans

SEED = 2**33 + 11
CELL = "bunny-1080p.frames4"

KIND = '''"""tick: a made-up kind whose call i returns a 2 x 2 image of i."""

import torch


class Loop:
    returns = "frames"
    reference_s = 0.0

    def __init__(self, cfg, traffic, seed, root, dev, mark=print, chips=1):
        self.dev, self.pixels = dev, traffic["pixels"]

    def call(self, i):
        image = torch.full((2, 2, 3), float(i), device=self.dev)
        return image, {"rays": torch.tensor(self.pixels),
                       "hits": torch.tensor(0)}

    def check(self, window):
        gap = max(float((image - (window["first"] + j)).abs().max())
                  for j, (image, _) in window["kept"].items())
        return {"image_gap": gap}
'''

TICKS = '''"""ticks_per_s: calls a second in the window."""

UNIT = "calls/s"


def read(ctx):
    return ctx.window["calls"] / ctx.window["seconds"]
'''

KEPT = '''"""kept_calls: the window's calls whose outputs were kept."""

UNIT = "calls"
LAYER = "device"
MOVES = "ticks_per_s"


def read(ctx):
    return float(len(ctx.window["kept"]))
'''


def _write(root, files):
    for path, text in files.items():
        with open(os.path.join(root, "raybench", *path.split("/")), "w") as fh:
            fh.write(text)


def _manifest(root, edit):
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    edit(bench)
    with open(path, "w") as fh:
        json.dump(bench, fh)


def _add_tick(root):
    _write(root, {
        "kinds/tick.py": KIND,
        "traffic/ticks.json": json.dumps({"kind": "tick", "pixels": 4}),
        "cells/bunny-1080p.ticks.json": json.dumps(
            {"draw_from": 3, "limits": {"image_gap": 0.0}}),
        "metrics/ticks_per_s.py": TICKS,
        "metrics/kept_calls.py": KEPT})

    def edit(bench):
        cell = "bunny-1080p.ticks"
        bench["workloads"].append({"name": cell, "config": "bunny-1080p",
                                   "traffic": "ticks", "chips": 1,
                                   "why": "a made-up kind"})
        bench["end_to_end"].append({"name": "ticks_per_s", "unit": "calls/s",
                                    "better": "higher", "bound": 0.05,
                                    "source": "host_clock",
                                    "workloads": [cell]})
        bench["per_layer"].append({"name": "kept_calls", "unit": "calls",
                                   "better": "higher", "source": "host_clock",
                                   "layer": "device", "moves": "ticks_per_s",
                                   "workloads": [cell]})
    _manifest(root, edit)


def test_a_kind_found_by_file_runs(tiny_root):
    _add_tick(tiny_root)
    assert loops.kind(tiny_root, "tick").Loop.returns == "frames"
    for traced, want in ((False, {"ticks_per_s", "setup_s"}),
                         (True, {"kept_calls"})):
        out = harness.run_cell(tiny_root, "bunny-1080p.ticks", 5, 0.2,
                               traced, "cpu", time.perf_counter())
        assert out["correct"], out["compared"]
        assert set(out["metrics"]) == want
        assert out["device"]["count"] == 1
        assert out["attempted"] > 1
    assert out["metrics"]["kept_calls"]["value"] == 2.0


def _variant(root, name, body):
    """A kind ``name`` whose Loop is ``sharded_frames``'s with ``body``,
    and a four-rank cell ``bunny-1080p.<name>`` of it."""
    text = textwrap.dedent('''
        import os
        import sys

        from raybench import loops

        BASE = loops.kind(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "sharded_frames").Loop


        class Loop(BASE):
        ''') + textwrap.indent(textwrap.dedent(body), "    ")
    with open(os.path.join(root, "raybench", "traffic", "frames4.json")) as fh:
        traffic = dict(json.load(fh), kind=name)
    with open(os.path.join(root, "raybench", "cells",
                           f"{CELL}.json")) as fh:
        cell = fh.read()
    _write(root, {f"kinds/{name}.py": text,
                  f"traffic/{name}.json": json.dumps(traffic),
                  f"cells/bunny-1080p.{name}.json": cell})

    def edit(bench):
        bench["workloads"].append({"name": f"bunny-1080p.{name}",
                                   "config": "bunny-1080p", "traffic": name,
                                   "chips": 4, "why": "a planted fault"})
        for m in bench["end_to_end"]:
            if m.get("workloads") == [CELL]:
                m["workloads"].append(f"bunny-1080p.{name}")
    _manifest(root, edit)
    return f"bunny-1080p.{name}"


@pytest.fixture(autouse=True)
def port_restored():
    """The port's names that a planted fault replaces, restored after
    each test: rank 0 runs in the test's own process."""
    from ceres_tpu_torch.parallel import sharded

    names = ("_assemble", "_reduce_stats", "_render_rows", "_frame_block")
    saved = {name: getattr(sharded, name) for name in names}
    frame = sharded.Transform.frame
    yield
    for name, value in saved.items():
        setattr(sharded, name, value)
    sharded.Transform.frame = frame


@pytest.fixture
def groups(monkeypatch):
    """Every ``ranks.Group`` the test starts."""
    made, real = [], ranks.Group.__init__

    def init(self, *args, **kwargs):
        made.append(self)
        real(self, *args, **kwargs)

    monkeypatch.setattr(ranks.Group, "__init__", init)
    return made


@pytest.fixture(autouse=True)
def reports_cleared():
    """What the other ranks reported, cleared before each test: rank 0
    runs in the test's own process."""
    ranks.REPORTED.clear()
    ranks.FOUND.clear()


def _values(out):
    return {k: v["value"] for k, v in out["compared"].items()}


def test_four_gloo_ranks_are_correct(tiny_root, groups):
    out = harness.run_cell(tiny_root, CELL, SEED, 0.5, False, "cpu",
                           time.perf_counter())
    assert out["correct"], out["compared"]
    assert out["device"]["count"] == 4
    assert set(out["metrics"]) == {"rays_per_s.frames4", "setup_s"}
    # Every batch counts every rank's rows: 4 frames of 64 x 48 pixels
    # and their primary hits.
    assert out["metrics"]["rays_per_s.frames4"]["value"] > 0
    (group,) = groups
    assert [p.returncode for p in group.procs] == [0, 0, 0]


def test_four_gloo_ranks_traced(tiny_root, groups):
    # A turntable of 8 frames: 2 batches a turn for the scaling's rank 0
    # alone.
    path = os.path.join(tiny_root, "raybench", "traffic", "frames4.json")
    with open(path) as fh:
        traffic = dict(json.load(fh), frames=8)
    with open(path, "w") as fh:
        json.dump(traffic, fh)
    out = harness.run_cell(tiny_root, CELL, SEED, 0.2, True, "cpu",
                           time.perf_counter())
    assert out["correct"], out["compared"]
    # The CPU trace has no device operation: only the host clock's.
    assert set(out["metrics"]) == {"scaling_eff.frames4",
                                   "batch_ms_p95.frames4"}
    assert out["metrics"]["scaling_eff.frames4"]["value"] > 0
    assert out["device"]["count"] == 4 and "busy_s" in out["device"]
    (group,) = groups
    assert [p.returncode for p in group.procs] == [0, 0, 0]


def test_one_ranks_altered_rows_are_not_correct(tiny_root, groups):
    cell = _variant(tiny_root, "altered_rows", '''
        def __init__(self, *args, rank=0, **kwargs):
            super().__init__(*args, rank=rank, **kwargs)
            if rank == 2:
                from ceres_tpu_torch.parallel import sharded

                real = sharded._render_rows

                def altered(*a, **kw):
                    color, stats = real(*a, **kw)
                    return 1.0 - color, stats

                sharded._render_rows = altered
        ''')
    out = harness.run_cell(tiny_root, cell, SEED, 0.2, False, "cpu",
                           time.perf_counter())
    assert not out["correct"]
    # A quarter of every frame's rows is rank 2's.
    assert _values(out)["px_off_pct"] > 20.0
    (group,) = groups
    assert [p.returncode for p in group.procs] == [0, 0, 0]


def test_the_exchange_left_out_is_not_correct(tiny_root, groups):
    cell = _variant(tiny_root, "no_exchange", '''
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            from ceres_tpu_torch.parallel import sharded

            def own_block(block, full_shape, index, owner, mesh):
                full = block.new_zeros(full_shape)
                if owner:
                    full[index] = block
                return full

            sharded._assemble = own_block
            sharded._reduce_stats = lambda stats, mesh, owner=True: stats
        ''')
    out = harness.run_cell(tiny_root, cell, SEED, 0.2, False, "cpu",
                           time.perf_counter())
    assert not out["correct"]
    got = _values(out)
    # Rank 0 holds its own quarter of the rows and of the rays alone.
    assert got["rays_gap"] > 0.5 and got["px_off_pct"] > 1.0
    (group,) = groups
    assert [p.returncode for p in group.procs] == [0, 0, 0]


FAULTS = {
    # Every frame rendered with frame 0's camera and sun: a state left
    # unchanged.
    "stale_camera": '''
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            from ceres_tpu_torch.parallel import sharded

            real = sharded.Transform.frame
            sharded.Transform.frame = lambda track, k: real(
                track, 0 if isinstance(k, int) else k)
        ''',
    # Half of each rank's frames of the batch left out.
    "half_batch": '''
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            from ceres_tpu_torch.parallel import sharded

            real = sharded._frame_block

            def half(num_frames, mesh):
                first, count = real(num_frames, mesh)
                return first, count // 2

            sharded._frame_block = half
        ''',
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(tiny_root, groups, fault):
    cell = _variant(tiny_root, fault, FAULTS[fault])
    out = harness.run_cell(tiny_root, cell, SEED, 0.2, False, "cpu",
                           time.perf_counter())
    assert not out["correct"], out["compared"]
    assert _values(out)["px_off_pct"] > 1.0
    (group,) = groups
    assert [p.returncode for p in group.procs] == [0, 0, 0]


def test_prestarted_ranks_are_taken_over(tiny_root, groups):
    ranks.prestart(4, "cpu")
    started = [p.pid for p in ranks._PRESTARTED]
    out = harness.run_cell(tiny_root, CELL, SEED, 0.2, False, "cpu",
                           time.perf_counter())
    assert out["correct"], out["compared"]
    (group,) = groups
    assert [p.pid for p in group.procs] == started
    assert [p.returncode for p in group.procs] == [0, 0, 0]
    assert ranks._PRESTARTED == [] and ranks.REPORTED == [1, 2, 3]


def test_a_rank_holding_jax_refuses_the_run(tiny_root, groups, monkeypatch,
                                            capsys):
    from raybench import run

    cell = _variant(tiny_root, "jax_rank", '''
        def __init__(self, *args, rank=0, **kwargs):
            super().__init__(*args, rank=rank, **kwargs)
            if rank == 2:
                import types

                sys.modules["jax.numpy"] = types.ModuleType("jax.numpy")
        ''')
    real = harness.run_cell
    monkeypatch.setattr(run, "ROOT", tiny_root)
    monkeypatch.setattr(ranks, "prestart", lambda world: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(run, "card_line", lambda: "none")
    monkeypatch.setattr(harness, "run_cell", lambda *a: real(
        *a[:5], "cpu", *a[6:]))
    code = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                     "0.2", "--trace", "0"])
    assert code == 3
    out = capsys.readouterr()
    assert out.out.strip() == ""
    assert "rank 2 of the run loaded jax" in out.err
    assert ranks.REPORTED == [1, 2, 3] and ranks.FOUND == {2: ["jax"]}
    (group,) = groups
    assert [p.returncode for p in group.procs] == [0, 0, 0]


def test_a_rank_that_raises_ends_the_run(tiny_root):
    cell = _variant(tiny_root, "failing_rank", '''
        def __init__(self, *args, rank=0, **kwargs):
            super().__init__(*args, rank=rank, **kwargs)
            sys.stderr.write(f"rank {rank} pid {os.getpid()};\\n")
            sys.stderr.flush()

        def call(self, i):
            if self.rank == 2 and i >= 2:
                raise RuntimeError("a planted failure on rank 2")
            return super().call(i)
        ''')
    code = f"""
        import sys, time
        sys.path.insert(0, {ROOT!r})
        from raybench import harness
        print(harness.run_cell({tiny_root!r}, {cell!r}, {SEED}, 30.0,
                               False, "cpu", time.perf_counter()))
        """
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert time.perf_counter() - t0 < 120
    assert proc.stdout.strip() == ""
    assert "a planted failure on rank 2" in proc.stderr
    pids = [int(pid) for rank, pid in
            re.findall(r"rank (\d+) pid (\d+);", proc.stderr) if rank != "0"]
    assert len(pids) == 3
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_the_spans_loop_takes_its_seed_from_the_context(monkeypatch):
    seen = []

    def make(cfg, traffic, seed, *args, **kwargs):
        seen.append(seed)
        raise RuntimeError("stop here")

    monkeypatch.setattr(loops, "make", make)
    monkeypatch.setattr(sys, "argv", ["run.py", "--seed", "1"])
    ctx = types.SimpleNamespace(
        root=ROOT, cell={"config": {}, "traffic": {"kind": "frames"}},
        cache={}, dev=torch.device("cuda"), trace=object(), seed=2**40 + 3,
        note=lambda *a: None)
    with pytest.raises(RuntimeError, match="stop here"):
        spans.read(ctx)
    assert seen == [2**40 + 3]


def test_the_kinds_turntable_is_the_ports():
    from ceres_tpu_torch.models.camera import Camera
    from ceres_tpu_torch.parallel.sharded import turntable_transforms

    kind = loops.kind(ROOT, "sharded_frames")
    traffic = manifest.cell(ROOT, CELL)["traffic"]
    cfg = manifest.cell(ROOT, CELL)["config"]
    from raybench import scene

    v, _ = scene.mesh(cfg, ROOT)
    cam = scene.camera(cfg, v)
    n = traffic["frames"]
    tracks = turntable_transforms(n, axis=traffic["axis"])
    camera = Camera.make(cam["eye"], cam["dir"], cam["up"], cam["fov"])
    sun = torch.as_tensor(cfg["sun"], dtype=torch.float32)
    for k in range(n):
        tf = tracks.frame(k)
        eye, cam_k, sun_k = kind.turned(cam, cfg["sun"], k, traffic)
        torch.testing.assert_close(kind.turntable(k, n, traffic["axis"]),
                                   tf.a, rtol=0, atol=2e-7)
        torch.testing.assert_close(eye, tf(camera.eye), rtol=0, atol=1e-7)
        torch.testing.assert_close(cam_k["dir"], tf.a @ camera.dir, rtol=0,
                                   atol=1e-7)
        torch.testing.assert_close(sun_k, tf(sun), rtol=0, atol=2e-5)
    assert list(kind.batch_frames(16, traffic)) == [4, 5, 6, 7]
    assert list(kind.batch_frames(14, traffic)) == [56, 57, 58, 59]


"""A configuration, a traffic mix, a cell and a per-layer metric are
added by adding files and manifest entries alone: the harness finds each
by its name and runs the new cell (on the CPU, at a tiny size)."""

from __future__ import annotations

import json
import os
import time

from raybench import harness, manifest

METRIC = '''"""calls_in_window: frames completed in the window."""

UNIT = "calls"
LAYER = "device"
MOVES = "rays_per_s"


def read(ctx):
    return float(ctx.window["calls"])
'''


def _add(root):
    home = os.path.join(root, "raybench")
    with open(os.path.join(home, "configs", "bunny-1080p.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="bunny-side", eye=[0.3, 0.1, 0.0], sun=[50.0, 100.0, 0.0])
    files = {
        ("configs", "bunny-side.json"): json.dumps(cfg),
        ("traffic", "turntable.json"): json.dumps(
            {"kind": "frames", "geometry": "static", "sun_step": 0.01,
             "sun_path": 64}),
        ("cells", "bunny-side.turntable.json"): json.dumps(
            {"draw_from": 2, "limits": {"px_off_pct": 1.0, "rays_gap": 1e-2,
                                        "hits_gap": 1e-2}}),
        ("metrics", "calls_in_window.py"): METRIC,
    }
    for (sub, name), text in files.items():
        with open(os.path.join(home, sub, name), "w") as fh:
            fh.write(text)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "bunny-side", "source": cfg["source"],
                             "file": "raybench/configs/bunny-side.json",
                             "reduced": [], "why": "a second camera"})
    bench["workloads"].append({"name": "bunny-side.turntable",
                               "config": "bunny-side", "traffic": "turntable",
                               "chips": 1, "why": "a faster sun"})
    for m in bench["end_to_end"]:
        if m["name"] in ("rays_per_s", "frame_ms_p95"):
            m["workloads"].append("bunny-side.turntable")
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "rays_per_s",
                               "workloads": ["bunny-side.turntable"]})
    with open(path, "w") as fh:
        json.dump(bench, fh)


def test_new_files_are_found_by_name(tiny_root):
    _add(tiny_root)
    spec = manifest.cell(tiny_root, "bunny-side.turntable")
    assert spec["config"]["eye"] == [0.3, 0.1, 0.0]
    assert spec["traffic"]["sun_step"] == 0.01
    assert [m["name"] for m in spec["per_layer"]] == ["calls_in_window"]
    assert manifest.metric(tiny_root, "calls_in_window").UNIT == "calls"


def test_the_new_cell_runs(tiny_root):
    _add(tiny_root)
    for traced, want in ((False, {"rays_per_s", "frame_ms_p95", "setup_s"}),
                         (True, {"calls_in_window"})):
        out = harness.run_cell(tiny_root, "bunny-side.turntable", 3, 0.3,
                               traced, "cpu", time.perf_counter())
        assert out["correct"], out["compared"]
        assert set(out["metrics"]) == want
        assert list(out)[-1] == "compared"

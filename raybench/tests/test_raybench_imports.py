"""No JAX on the benchmark's run path, and nothing of the port in the
reference: module names compared by their whole top-level name
(``ceres_tpu_torch`` begins with ``ceres_tpu`` and is not it)."""

from __future__ import annotations

import subprocess
import sys
import textwrap

from conftest import HERE, ROOT
from raybench import run


def test_names_are_compared_whole():
    assert run.forbidden_modules(["ceres_tpu_torch", "ceres_tpu_torch.ops",
                                  "jaxtyping", "flaxen.x", "torch"]) == []
    assert run.forbidden_modules(["ceres_tpu.render", "jax.numpy", "jaxlib",
                                  "flax"]) == ["ceres_tpu", "flax", "jax",
                                               "jaxlib"]


def _python(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    out = _python(f"""
        import sys, tempfile, time
        sys.path[:0] = [{ROOT!r}, {HERE!r}]
        import conftest
        from raybench import harness, ranks, run
        root = conftest.make_root(tempfile.mkdtemp())
        for cell in ("bunny-1080p.static", "bunny-1080p.fit",
                     "bunny-1080p.frames4"):
            harness.run_cell(root, cell, 7, 0.2, False, "cpu",
                             time.perf_counter())
        print(sorted({{m.split(".")[0] for m in sys.modules}}
                     & {{"ceres_tpu_torch"}}), run.forbidden_modules(),
              ranks.REPORTED, ranks.FOUND)
        """)
    # Every other rank of frames4 reported its modules, and none held one.
    assert out == "['ceres_tpu_torch'] [] [1, 2, 3] {}"


def test_the_reference_loads_nothing_of_the_port():
    out = _python(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        import torch
        from raybench import compare, control, reference, roofline, scene
        from raybench import trace, walkcount
        cfg = {{"mesh": "raybench/scenes/bunny.obj", "eye": [0, .1, -.3],
               "look_at": "centroid", "up": [0, 1, 0], "fov": 60.0}}
        v, f = scene.mesh(cfg, {ROOT!r})
        reference.frame(torch.as_tensor(v), torch.as_tensor(f).long(),
                        torch.tensor([0, .1, -.3]), scene.camera(cfg, v),
                        torch.tensor([-50.0, 100.0, 0.0]), 32, 24)
        print(sorted({{m.split(".")[0] for m in sys.modules}}
                     & {{"ceres_tpu_torch", "ceres_tpu", "jax", "jaxlib",
                        "flax"}}))
        """)
    assert out == "[]"

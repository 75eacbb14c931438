"""The readings that the limits of ``correct`` are set from, above the
sound runs: the control and, for the fit, its fault.

    python3 raybench/control.py --cells A,B --seeds 11,12,13 \\
        [--out raybench/out/control.jsonl]

For each cell and seed it builds the cell's own inputs at the cell's own
size, as a run does (mesh, camera, the seeded sun path or moved meshes,
the fit's start and target), and compares with the float32 reference,
as a run compares the port:

  * control: the reference put in the port's place, computed in
    bfloat16, the next precision below the configuration's float32;
  * half_batch (fit cells): the reference put in the port's place with
    its loss taken over the image's top half only, the mean over that
    half.

A kind found by file (``raybench/kinds/<kind>.py``) gives its own
readings: its ``control(spec, seed, root, dev)``.

A state left unchanged reads 1 on ``change_gap`` by its definition and
needs no run. Needs no part of the port: it runs only the reference.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import types

import numpy as np
import torch

HOME = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HOME)


def scene_of(cfg, root, dev):
    from raybench import scene

    v, f = scene.mesh(cfg, root)
    return types.SimpleNamespace(
        v=v, f=f, cam=scene.camera(cfg, v), width=cfg["width"],
        height=cfg["height"], vt=torch.as_tensor(v, device=dev),
        sun_t=torch.as_tensor(np.asarray(cfg["sun"], np.float32),
                              device=dev))


def frame_readings(spec, seed, root, dev):
    from raybench import compare, reference, scene

    cfg, traffic, cell = spec["config"], spec["traffic"], spec["cell"]
    sc = scene_of(cfg, root, dev)
    k = random.Random(seed).randrange(cell["draw_from"])
    if traffic["geometry"] == "static":
        vertices = sc.vt
        sun = scene.sun_path(cfg, traffic, seed, dev)[k]
    else:
        vertices = scene.noise_pool(sc.vt, traffic["noise"], traffic["pool"],
                                    seed)[k % traffic["pool"]]
        sun = sc.sun_t
    faces = torch.as_tensor(sc.f, device=dev).long()
    eye = torch.as_tensor(sc.cam["eye"], device=dev)
    images = {name: reference.frame(vertices, faces, eye, sc.cam, sun,
                                    sc.width, sc.height, dtype)
              for name, dtype in (("float32", torch.float32),
                                  ("control", torch.bfloat16))}
    return {"control": compare.frame_numbers(*images["control"],
                                             *images["float32"])}


def fit_readings(spec, seed, root, dev):
    from raybench import compare, reference, scene

    cfg, traffic = spec["config"], spec["traffic"]
    sc = scene_of(cfg, root, dev)
    faces = torch.as_tensor(sc.f, device=dev).long()
    eye = torch.as_tensor(sc.cam["eye"], device=dev)
    target = reference.frame(sc.vt, faces, eye, sc.cam, sc.sun_t, sc.width,
                             sc.height)[0]
    start = {"vertices": scene.noise_pool(sc.vt, traffic["noise"], 1,
                                          seed)[0], "eye": eye.clone()}
    steps, lr = traffic["held_steps"], traffic["lr"]
    ref = compare.reference_fit(start, sc, target, steps, lr)
    out = {}
    held = compare.reference_fit(start, sc, target, steps, lr,
                                 torch.bfloat16)
    out["control"] = compare.fit_numbers(
        dict(zip(("losses", "first", "params", "last"), held)), start, *ref)
    whole = reference.loss
    half = sc.height // 2
    try:
        reference.loss = lambda image, tgt: whole(image[:half], tgt[:half])
        held = compare.reference_fit(start, sc, target, steps, lr)
    finally:
        reference.loss = whole
    out["half_batch"] = compare.fit_numbers(
        dict(zip(("losses", "first", "params", "last"), held)), start, *ref)
    return out


def readings(root, cell, seed, dev):
    from raybench import loops, manifest

    spec = manifest.cell(root, cell)
    kind = spec["traffic"]["kind"]
    if kind == "fit":
        return fit_readings(spec, seed, root, dev)
    if kind == "frames":
        return frame_readings(spec, seed, root, dev)
    return loops.kind(root, kind).control(spec, seed, root, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=os.path.join(HOME, "out",
                                                  "control.jsonl"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for cell in args.cells.split(","):
        for seed in args.seeds.split(","):
            row = {"cell": cell, "seed": int(seed),
                   "card": torch.cuda.get_device_name(0),
                   "readings": readings(ROOT, cell, int(seed), "cuda")}
            torch.cuda.empty_cache()
            print(json.dumps(row), flush=True)
            with open(args.out, "a") as fh:
                fh.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

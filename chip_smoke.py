"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives ``ceres_tpu_torch`` through its main path, the frame that
``bench.py`` renders with the JAX package (bunny at 1920 x 1080, smooth
shading, shadows from the sun), and holds it to what is known to be
right. Phases, each printed on its own line:

  1. device: require CUDA; print the card and its power limit;
  2. build: compile the walk kernels from ``ceres_tpu_torch/ops/csrc``;
  3. kernel vs plain: each kernel against its plain PyTorch version on
     the main path's inputs (bunny 1920 x 1080: 4,080 tiles over 61
     clusters) and on dragon at 960 x 540 (268 clusters, which exercises
     cluster-id masking past 256): slot ids, flags and executed visits
     must be equal; CUDA-event times of both;
  4. main path: render the frame through ``render_pipeline`` with a
     prebuilt SweepSAH cut and winner table; both kernels' launch counts
     must rise; image finite and not black; rays = pixels + primary
     hits; ms/frame (median of CUDA-event frame times) and rays/s;
  5. JAX reference: render bunny at 128 x 128 and compare with
     ``tests/fixtures/torch_port_bunny_128.npz``, made by the JAX package.

Any failed check exits non-zero. The line before last is the kernels'
JSON record; the last line is the device record. Needs no network and
no JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
EYE = (0.0, 0.1, -0.3)       # bench.py's camera and sun
SUN = (-50.0, 100.0, 0.0)
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_bunny_128.npz")
KERNEL_SOURCE = "ceres_tpu_torch/ops/csrc/walk.cu"
REPLACES = {"walk_closest": "ceres_tpu/ops/megakernel.py:776",
            "walk_any_dest": "ceres_tpu/ops/megakernel.py:703"}
FRAMES = 10


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scene(name, dev):
    """Mesh, camera and the port's SweepSAH cut on ``dev``."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel.cuts import build_clusters_quality

    v, f = ct.load_obj(os.path.join(ROOT, "data", f"{name}.obj"))
    eye = np.asarray(EYE if name == "bunny" else (0.0, 2.5, -12.0), np.float32)
    cam = ct.Camera.make(eye=eye, dir=v.mean(axis=0) - eye, up=(0, 1, 0),
                         fov=60.0, device=dev)
    vt, ft = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
    cs = build_clusters_quality(ct.triangle_soup(vt, ft, with_normals=False))
    return vt, ft, cam, cs


def walk_inputs(name, width, height, dev):
    """The two kernels' inputs as the main path builds them."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.models.camera import camera_ray_columns
    from ceres_tpu_torch.ops import megakernel as mk
    from ceres_tpu_torch.render import renderer
    from ceres_tpu_torch.utils import tiling

    vt, ft, cam, cs = scene(name, dev)
    soup = ct.triangle_soup(vt, ft, with_normals=True)
    dirs = tuple(tiling.swizzle_plane(p)
                 for p in camera_ray_columns(cam, width, height))
    closest = mk._closest_inputs(cs, cam.eye, dirs)
    hit, pay = mk.closest_hit_common_origin(soup, cam.eye, dirs, clusters=cs,
                                            normal_cols=True)
    points = renderer._hit_points(cam.eye, dirs, hit, pay)
    sun = torch.as_tensor(SUN, device=dev)
    shadow = mk._any_dest_inputs(cs, sun, points, ~hit.mask)
    return cs.num_clusters, closest, shadow


def compare(kernel, plain, inputs, positive, reps):
    """Kernel against plain version on the same inputs; ``positive`` of
    the plain output counts its hits, so an empty comparison shows."""
    out_k, steps_k = kernel(*inputs)
    out_p, steps_p = plain(*inputs)
    torch.cuda.synchronize()
    diff = (out_k.long() - out_p.long()).abs()
    return {"mismatches": int((diff > 0).sum()), "max_abs_err": int(diff.max()),
            "steps": int(steps_k), "plain_steps": int(steps_p),
            "positives": int(positive(out_p, inputs).sum()),
            "ms": cuda_ms(lambda: kernel(*inputs), reps),
            "plain_ms": cuda_ms(lambda: plain(*inputs), 2)}


def main():
    # Phase 1: device.
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port's smoke test "
             "needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(ROOT, "ceres_tpu_torch")):
        fail(f"no ceres_tpu_torch package beside {__file__}")
    sys.path.insert(0, ROOT)
    from ceres_tpu_torch.ops import _build, walk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"phase 1 device: {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; count {torch.cuda.device_count()}", flush=True)
    print(card, flush=True)

    # Phase 2: build.
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    with open(_build.library_path()[:-3] + ".log") as fh:
        ptxas = " | ".join(line.strip() for line in fh if "registers" in line)
    print(f"phase 2 build: {build_s:.1f} s ({ptxas})", flush=True)

    # Phase 3: each kernel against its plain version.
    results = {}
    for name, w, h in (("bunny", 1920, 1080), ("dragon", 960, 540)):
        n_c, closest, shadow = walk_inputs(name, w, h, dev)
        for kname, kernel, plain, inputs, positive in (
                ("walk_closest", walk.walk_closest,
                 walk._walk_closest_plain, closest,
                 lambda out, inp: out >= 0),
                ("walk_any_dest", walk.walk_any_dest,
                 walk._walk_any_dest_plain, shadow,
                 lambda out, inp: (out == 1) & (inp[4] == 0))):
            r = compare(kernel, plain, inputs, positive, reps=20)
            print(f"phase 3 {kname} {name} {w}x{h} ({inputs[1].shape[0]} "
                  f"tiles, {n_c} clusters): mismatches {r['mismatches']} "
                  f"max_abs_err {r['max_abs_err']} steps {r['steps']}/"
                  f"{r['plain_steps']} positives {r['positives']} kernel "
                  f"{r['ms']:.4f} ms plain {r['plain_ms']:.2f} ms [{card}]",
                  flush=True)
            check(r["mismatches"] == 0 and r["steps"] == r["plain_steps"],
                  f"{kname} disagrees with its plain version on {name}")
            check(r["positives"] > 0, f"{kname} found nothing on {name}")
            if name == "bunny":
                results[kname] = r

    # Phase 4: the main path.
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.render.renderer import prepare_winner_table

    W, H = 1920, 1080
    vt, ft, cam, cs = scene("bunny", dev)
    config = ct.RenderConfig(width=W, height=H)
    table = prepare_winner_table(ct.triangle_soup(vt, ft), cs, config)
    sun = torch.as_tensor(SUN, device=dev)
    walk.reset_launches()
    image, stats = ct.render_pipeline(
        vt, ft, cam, sun, ct.RenderConfig(width=W, height=H,
                                          traversal_stats=True),
        clusters=cs, table_cols=table)
    torch.cuda.synchronize()
    launches = dict(walk.launches)
    stats = {k: int(v) for k, v in stats.items()}
    check(all(n > 0 for n in launches.values()),
          f"main path did not launch every kernel: {launches}")
    check(tuple(image.shape) == (H, W, 3), f"image shape {tuple(image.shape)}")
    check(bool(torch.isfinite(image).all()), "image has non-finite values")
    check(float(image.max()) > 0, "image is black")
    check(stats["rays"] == W * H + stats["primary_hits"],
          f"rays {stats['rays']} != pixels + primary hits")

    def frame(i):
        return ct.render_pipeline(vt, ft, cam, sun + i * 1e-3, config,
                                  clusters=cs, table_cols=table)

    for i in range(2):
        frame(i)
    times, walls = [], []
    for i in range(FRAMES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        start.record()
        frame(i)
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - w0) * 1e3)
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    print(f"phase 4 main path: bunny {W}x{H} smooth+shadows; launches "
          f"{launches}; rays {stats['rays']} hits {stats['hits']} "
          f"primary_hits {stats['primary_hits']} shadow_hits "
          f"{stats['shadow_hits']} steps {stats['traversal_steps']}; "
          f"ms/frame median {ms:.3f} (min {min(times):.3f} max "
          f"{max(times):.3f}, host wall median {statistics.median(walls):.3f})"
          f"; rays/s {stats['rays'] / (ms / 1e3):.4e} [{card}]", flush=True)

    # Phase 5: against the JAX package's render of the same scene.
    with np.load(FIXTURE) as ref:
        ref = dict(ref)
    size = ref["image"].shape[0]
    img, st = ct.render_pipeline(vt, ft, cam, sun,
                                 ct.RenderConfig(width=size, height=size),
                                 clusters=cs)
    diff = np.abs(img.cpu().numpy() - ref["image"]).max(axis=-1)
    frac = float((diff > 1e-4).mean())
    counts = {k: (int(st[k]), int(ref[k]))
              for k in ("rays", "hits", "primary_hits", "shadow_hits")}
    print(f"phase 5 JAX reference: bunny {size}x{size}: pixels off by "
          f">1e-4 {frac:.4%} (limit 0.5%); port/JAX counts {counts}",
          flush=True)
    check(frac < 0.005, "image differs from the JAX render")
    check(all(abs(a - b) <= 0.002 * b for a, b in counts.values()),
          "counts differ from the JAX render by more than 0.2%")

    kernels = [{"name": k, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": results[k]["max_abs_err"],
                "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"]}
               for k in ("walk_closest", "walk_any_dest")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

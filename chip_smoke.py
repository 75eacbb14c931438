"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives ``ceres_tpu_torch`` through its paths, each at the size a user
renders, and holds them to what is known to be right. The bunny path is
the frame that ``bench.py`` renders with the JAX package (bunny at
1920 x 1080, smooth shading, shadows from the sun); the large-scene path
is ``benchmarks/large_scene.py``'s: the 3x and 4x midpoint-subdivided
bunny (317,952 and 1,271,808 triangles) on the device-built LBVH
treelet cut, same camera, sun and resolution. Phases, each printed on
its own line:

  1. device: require CUDA; print the card and its power limit;
  2. build: compile the walk kernels from ``ceres_tpu_torch/ops/csrc``;
  3. kernel vs plain (bunny): K1 and K2 against their plain PyTorch
     versions on the bunny path's inputs (1920 x 1080: 4,080 tiles over
     61 clusters) and on dragon at 960 x 540 (268 clusters: cluster-id
     masking past 256): slot ids, flags and executed visits must be
     equal; CUDA-event times of both;
  4. bunny path: render the frame through ``render_pipeline`` with a
     prebuilt SweepSAH cut and winner table; both kernels' launch counts
     must rise; image finite and not black; rays = pixels + primary
     hits; ms/frame (median of CUDA-event frame times) and rays/s;
  5. JAX reference: render bunny at 128 x 128 and compare with
     ``tests/fixtures/torch_port_bunny_128.npz``, made by the JAX package;
  6. kernel vs plain (large scenes), on each scene's 1080p inputs: the
     flat streamed variants (K5) on the 3x bunny (4,968 blocks), the
     two-level variants (K6, K7a) streamed and resident on the 4x bunny
     (19,872 blocks in 1,242 supers of S = 32); 0 mismatches and equal
     visits; CUDA-event times of kernel and plain;
  7. large-scene path: render both scenes at 1080p through
     ``render_pipeline`` with the prebuilt treelet cut and winner table;
     device treelet build time; each scene's own variants must launch;
     rays = pixels + primary hits; ms/frame median (min/max), rays/s,
     executed visits;
  8. JAX reference, large scene: ``render()`` of the 4x bunny at 64 x 64
     (the treelet cut built on the card) against
     ``tests/fixtures/torch_port_bunny_subdiv4_64.npz``.

Each path runs with the launch counts set to 0 just before it and read
just after. Any failed check exits non-zero. The line before last is the
kernels' JSON record; the last line is the device record. Needs no
network and no JAX.
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
LARGE_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                             "torch_port_bunny_subdiv4_64.npz")
KERNEL_SOURCE = "ceres_tpu_torch/ops/csrc/walk.cu"
REPLACES = {"walk_closest": "ceres_tpu/ops/megakernel.py:776",
            "walk_any_dest": "ceres_tpu/ops/megakernel.py:703",
            "walk_closest_stream": "ceres_tpu/ops/megakernel.py:477",
            "walk_any_dest_stream": "ceres_tpu/ops/megakernel.py:477",
            "walk_closest_hier_stream": "ceres_tpu/ops/megakernel.py:723",
            "walk_any_dest_hier_stream": "ceres_tpu/ops/megakernel.py:657"}
W, H = 1920, 1080
FRAMES = 10
LARGE_FRAMES = 5
# Each large scene's path and the variants it must launch.
LARGE = {3: ("walk_closest_stream", "walk_any_dest_stream"),
         4: ("walk_closest_hier_stream", "walk_any_dest_hier_stream")}


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


def timed_once(fn):
    """(fn(), its CUDA-event time in ms) for one call."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def camera(v, eye, dev):
    import ceres_tpu_torch as ct

    eye = np.asarray(eye, np.float32)
    return ct.Camera.make(eye=eye, dir=v.mean(axis=0) - eye, up=(0, 1, 0),
                          fov=60.0, device=dev)


def scene(name, dev):
    """Mesh, camera and the port's SweepSAH cut on ``dev``."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel.cuts import build_clusters_quality

    v, f = ct.load_obj(os.path.join(ROOT, "data", f"{name}.obj"))
    cam = camera(v, EYE if name == "bunny" else (0.0, 2.5, -12.0), dev)
    vt, ft = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
    cs = build_clusters_quality(ct.triangle_soup(vt, ft, with_normals=False))
    return vt, ft, cam, cs


def walk_inputs(vt, ft, cam, cs, width, height):
    """The two walks' (args, opts) as the path builds them."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.models.camera import camera_ray_columns
    from ceres_tpu_torch.ops import megakernel as mk
    from ceres_tpu_torch.render import renderer
    from ceres_tpu_torch.utils import tiling

    soup = ct.triangle_soup(vt, ft, with_normals=True)
    dirs = tuple(tiling.swizzle_plane(p)
                 for p in camera_ray_columns(cam, width, height))
    closest = mk._closest_inputs(cs, cam.eye, dirs)
    hit, pay = mk.closest_hit_common_origin(soup, cam.eye, dirs, clusters=cs,
                                            normal_cols=True)
    points = renderer._hit_points(cam.eye, dirs, hit, pay)
    sun = torch.as_tensor(SUN, device=vt.device)
    shadow = mk._any_dest_inputs(cs, sun, points, ~hit.mask)
    return closest, shadow


def positives(mode, out, args):
    """Hits of a plain output, so that an empty comparison shows."""
    if mode == "closest":
        return int((out >= 0).sum())
    return int(((out == 1) & (args[4] == 0)).sum())


def compare(mode, args, opts, reps, plain_ref=None):
    """Kernel against plain version on the same inputs. ``plain_ref``
    (out, steps, ms) reuses a plain run of the same inputs."""
    from ceres_tpu_torch.ops import walk

    kernel = walk.walk_closest if mode == "closest" else walk.walk_any_dest
    plain = (walk._walk_closest_plain if mode == "closest"
             else walk._walk_any_dest_plain)
    if plain_ref is None:
        (out_p, steps_p), plain_ms = timed_once(lambda: plain(*args, **opts))
        plain_ref = (out_p, int(steps_p), plain_ms)
    out_p, steps_p, plain_ms = plain_ref
    out_k, steps_k = kernel(*args, **opts)
    torch.cuda.synchronize()
    diff = (out_k.long() - out_p.long()).abs()
    return {"mismatches": int((diff > 0).sum()), "max_abs_err": int(diff.max()),
            "steps": int(steps_k), "plain_steps": steps_p,
            "positives": positives(mode, out_p, args),
            "ms": cuda_ms(lambda: kernel(*args, **opts), reps),
            "plain_ms": plain_ms}, plain_ref


def report(phase, kname, label, r, card):
    print(f"phase {phase} {kname} {label}: mismatches {r['mismatches']} "
          f"max_abs_err {r['max_abs_err']} steps {r['steps']}/"
          f"{r['plain_steps']} positives {r['positives']} kernel "
          f"{r['ms']:.4f} ms plain {r['plain_ms']:.2f} ms [{card}]",
          flush=True)
    check(r["mismatches"] == 0 and r["steps"] == r["plain_steps"],
          f"{kname} disagrees with its plain version on {label}")
    check(r["positives"] > 0, f"{kname} found nothing on {label}")


def frame_times(frame, n):
    """CUDA-event and host-wall times (ms) of n calls of frame(i), after
    two warm-up calls."""
    for i in range(2):
        frame(i)
    times, walls = [], []
    for i in range(n):
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
    return times, walls


def render_path(vt, ft, cam, cs, sun, label, frames, card):
    """One path's run: launches and stats of one frame with the counts
    reset just before it, then the timed frames. Returns (launches,
    stats, median ms)."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.ops import walk
    from ceres_tpu_torch.render.renderer import prepare_winner_table

    config = ct.RenderConfig(width=W, height=H)
    table = prepare_winner_table(ct.triangle_soup(vt, ft), cs, config)
    walk.reset_launches()
    image, stats = ct.render_pipeline(
        vt, ft, cam, sun, ct.RenderConfig(width=W, height=H,
                                          traversal_stats=True),
        clusters=cs, table_cols=table)
    torch.cuda.synchronize()
    launches = {k: n for k, n in walk.launches.items() if n}
    stats = {k: int(v) for k, v in stats.items()}
    check(tuple(image.shape) == (H, W, 3), f"{label}: image shape "
          f"{tuple(image.shape)}")
    check(bool(torch.isfinite(image).all()), f"{label}: non-finite image")
    check(float(image.max()) > 0, f"{label}: image is black")
    check(stats["rays"] == W * H + stats["primary_hits"],
          f"{label}: rays {stats['rays']} != pixels + primary hits")

    def frame(i):
        return ct.render_pipeline(vt, ft, cam, sun + i * 1e-3, config,
                                  clusters=cs, table_cols=table)

    times, walls = frame_times(frame, frames)
    ms = statistics.median(times)
    print(f"{label} {W}x{H} smooth+shadows; launches {launches}; rays "
          f"{stats['rays']} hits {stats['hits']} primary_hits "
          f"{stats['primary_hits']} shadow_hits {stats['shadow_hits']} "
          f"executed visits {stats['traversal_steps']}; ms/frame median "
          f"{ms:.3f} (min {min(times):.3f} max {max(times):.3f}, host wall "
          f"median {statistics.median(walls):.3f}); rays/s "
          f"{stats['rays'] / (ms / 1e3):.4e} [{card}]", flush=True)
    return launches, stats, ms


def against_fixture(img, st, path, label):
    with np.load(path) as ref:
        ref = dict(ref)
    diff = np.abs(img.cpu().numpy() - ref["image"]).max(axis=-1)
    frac = float((diff > 1e-4).mean())
    keys = ["rays", "hits", "primary_hits", "shadow_hits"]
    counts = {k: (int(st[k]), int(ref[k])) for k in keys}
    if "traversal_steps" in ref and "traversal_steps" in st:
        counts["traversal_steps"] = (int(st["traversal_steps"]),
                                     int(ref["traversal_steps"]))
    print(f"{label}: pixels off by >1e-4 {frac:.4%} (limit 0.5%); port/JAX "
          f"counts {counts}", flush=True)
    check(frac < 0.005, f"{label}: image differs from the JAX render")
    check(all(abs(counts[k][0] - counts[k][1]) <= 0.002 * counts[k][1]
              for k in ("rays", "hits")),
          f"{label}: rays/hits differ from the JAX render by more than 0.2%")


def main():
    # Phase 1: device.
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port's smoke test "
             "needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(ROOT, "ceres_tpu_torch")):
        fail(f"no ceres_tpu_torch package beside {__file__}")
    sys.path.insert(0, ROOT)
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel.clusters import build_clusters_treelet
    from ceres_tpu_torch.models.mesh import subdivide
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

    # Phase 3: K1 and K2 against their plain versions.
    results = {}
    for name, w, h in (("bunny", W, H), ("dragon", 960, 540)):
        vt, ft, cam, cs = scene(name, dev)
        for mode, (args, opts) in zip(("closest", "any_dest"),
                                      walk_inputs(vt, ft, cam, cs, w, h)):
            kname = f"walk_{mode}"
            r, _ = compare(mode, args, opts, reps=20)
            report(3, kname, f"{name} {w}x{h} ({args[1].shape[0]} tiles, "
                   f"{cs.num_clusters} clusters)", r, card)
            if name == "bunny":
                results[kname] = r

    # Phase 4: the bunny path.
    vt, ft, cam, cs = scene("bunny", dev)
    sun = torch.as_tensor(SUN, device=dev)
    launches, _, _ = render_path(vt, ft, cam, cs, sun, "phase 4 bunny path:",
                                 FRAMES, card)
    check(set(launches) == {"walk_closest", "walk_any_dest"},
          f"bunny path did not launch exactly K1 and K2: {launches}")
    path_launches = dict(launches)

    # Phase 5: against the JAX package's render of the same scene.
    with np.load(FIXTURE) as ref:
        size = ref["image"].shape[0]
    img, st = ct.render_pipeline(vt, ft, cam, sun,
                                 ct.RenderConfig(width=size, height=size),
                                 clusters=cs)
    against_fixture(img, st, FIXTURE,
                    f"phase 5 JAX reference: bunny {size}x{size}")

    # Phase 6: the large scenes' variants against their plain versions.
    v0, f0 = ct.load_obj(os.path.join(ROOT, "data", "bunny.obj"))
    meshes = {3: subdivide(v0, f0, 3)}
    meshes[4] = subdivide(*meshes[3], 1)
    large = {}
    for levels, (v, f) in meshes.items():
        cam = camera(v, EYE, dev)
        vt, ft = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
        soup = ct.triangle_soup(vt, ft, with_normals=False)
        cs, build_ms = timed_once(lambda: build_clusters_treelet(soup))
        large[levels] = (vt, ft, cam, cs, build_ms)
        label = (f"bunny x{levels} {W}x{H} ({f.shape[0]} triangles, "
                 f"{cs.num_clusters} blocks")
        for mode, (args, opts) in zip(("closest", "any_dest"),
                                      walk_inputs(vt, ft, cam, cs, W, H)):
            check(opts["stream"], f"{label}: the walk is not streamed")
            check((opts["S"] > 1) == (levels == 4),
                  f"{label}: walk S = {opts['S']}")
            forms = (True,) if levels == 3 else (True, False)
            plain_ref = None
            for stream in forms:
                kname = walk._variant(mode, opts["S"], stream)
                r, plain_ref = compare(mode, args, dict(opts, stream=stream),
                                       reps=5, plain_ref=plain_ref)
                report(6, kname, f"{label}, S = {opts['S']}, "
                       f"{args[1].shape[1]} candidates per tile)", r, card)
                if stream:
                    results[kname] = r

    # Phase 7: the large-scene path, both scenes.
    for levels, (vt, ft, cam, cs, build_ms) in large.items():
        label = (f"phase 7 large-scene path: bunny x{levels} "
                 f"({ft.shape[0]} triangles, device treelet build "
                 f"{build_ms:.1f} ms, {cs.num_clusters} blocks, S "
                 f"{cs.super_S}):")
        launches, _, _ = render_path(vt, ft, cam, cs, sun, label,
                                     LARGE_FRAMES, card)
        check(set(launches) == set(LARGE[levels]),
              f"bunny x{levels} path did not launch exactly "
              f"{LARGE[levels]}: {launches}")
        path_launches.update(launches)

    # Phase 8: against the JAX package's render of the 4x bunny.
    v, f = meshes[4]
    with np.load(LARGE_FIXTURE) as ref:
        size = ref["image"].shape[0]
    img, st = ct.render(v, f, camera(v, EYE, "cpu"), SUN, width=size,
                        height=size, device=dev, traversal_stats=True)
    against_fixture(img, st, LARGE_FIXTURE,
                    f"phase 8 JAX reference: bunny x4 {size}x{size}")

    kernels = [{"name": k, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": REPLACES[k], "launches": path_launches[k],
                "max_abs_err": results[k]["max_abs_err"],
                "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"]}
               for k in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

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
  2. build: compile the walk kernels from ``ceres_tpu_torch/ops/csrc``
     and the LBVH kernels from ``ceres_tpu_torch/accel/csrc``; the tiles
     each walk holds on the card at once;
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
     ``tests/fixtures/torch_port_bunny_subdiv4_64.npz``;
  9. kernel vs plain (the reference-exact path and the ray window), on
     each path's full-size inputs: the generic shadow walk (K3) on the
     bunny compat frame at 1080p (61 blocks, resident) and streamed on
     dragon at 960 x 540 (268 blocks: past the 256-block budget of
     generic weights), its two-level form (K7b) streamed and resident on
     the 4x bunny at 1080p, and the windowed closest walk (K4) flat on
     bunny 1080p and two-level streamed and resident on the 4x bunny
     1080p, with
     per-ray windows a user asks for: the second surface behind each
     first hit (depth peeling) and a near/far clip for the rest; the
     4x bunny's windowed search runs as a path through
     ``closest_hit_common_origin(tmin=, tmax=)``;
 10. reference-exact path: ``render_pipeline`` with
     ``reference_compat=True`` on the bunny 1080p frame (SweepSAH cut,
     winner table) and on the 4x bunny 1080p (treelet cut): exactly the
     closest and generic shadow variants of each scene must launch; image
     finite and not black; ms/frame median (min/max), rays/s, visits;
 11. C++ reference: the ``bunny_scene()`` and ``dragon_scene()`` presets
     at 64 x 64, reference-exact, on both backends, against the PPMs the
     C++ reference rendered (``tests/fixtures/*_ref.ppm``): >= 99.5% of
     pixels within 2.5/255 and the rays/hits it printed, exactly; and the
     windowed entry point on two parallel triangles;
 12. training, config 4b: K1 and K2 against their plain versions on the
     step's 1080p inputs (the bunny's treelet cut as the step builds it,
     and refitted); then the bunny frame's forward and backward step
     (gradients w.r.t. the vertices and the eye of ``image_loss`` against
     the unperturbed frame, the sun moved 1e-3 a step, the treelet cut
     built inside the step): ms/step and forward-only ms (medians of
     CUDA-event times of steps and forwards alternated), the ratio
     step_ms / forward_ms - 1 where the two sets of times do not overlap
     between their quartiles (else "unresolved"), the same with the cut
     refitted instead of rebuilt, peak memory, K1 and K2 launches a step
     (each >= 1); gradients finite, and at 128 x 128 equal to the CPU's
     on the same inputs;
 13. training, config 4: ``fit_vertices`` on the bunny preset at 512 x
     512 with the refitted treelet cut, from seeded vertex noise: the
     loss history, which must fall, and the fit's host time; its step
     alone (``make_train_step`` as the fit builds it): ms/step median of
     CUDA events after two warm-up steps, and the cut's one build; K1 and
     K2 against their plain versions on the fitted vertices' refitted
     cut at 512 x 512; ``refit_clusters`` against
     ``build_clusters_treelet`` (synchronised ms) on bunny, dragon and the
     4x bunny;
 14. training on the 4x bunny: its cut refitted after seeded vertex noise
     renders the image of a fresh build of the moved mesh at 256 x 256;
     K6 and K7a against their plain versions on the refitted cut at
     1080p; train steps at 1080p with the refit (``make_train_step``):
     ms/step, peak memory, K6 and K7a launches a step (each >= 1);
 15. the render CLI (``ceres_tpu_torch.cli.render.main``) at its
     defaults: bunny 1920 x 1080, the LBVH treelet cut built on the card,
     smooth shading and shadows: K1 and K2 launched once each, the image
     within one level of ``render()``'s of the same inputs and its
     Rays/Hits equal, K1 and K2 against
     their plain versions on that frame's inputs, and the frame's ms with
     the cut built in it (median of CUDA-event times); then ``--sphere``
     with a sphere between the bunny and the sun (seen, and shadowing
     it): K1 and K2 once each, and the card's image equal to the CPU's
     at 128 x 128;
 16. float64 at 1080p through the CLI: ``-d`` launches K1 and K2 once
     each and its image on the card equals the CPU's at 128 x 128;
     ``--d-exact`` launches no float32 walk kernel, the float64 walk
     kernel (``ops/csrc/walk_f64.cu``) once for the closest search and
     once for the shadows (``walk_f64.launches``, and the float64 prepass
     kernel as often, ``prepass_f64.launches``), its image is within
     0.5% of pixels of ``-d``'s and equals the CPU's at 128 x 128;
     ``render()``'s float64 image, and the ms of a frame of each (median
     of a few, the cut built in each); the float64 prepass kernel
     against its plain passes on the same card tensors (counts, and rows
     bit-equal up to them; each way's ms; survivors a tile: mean, p99,
     max, tiles past the kernel's shared-memory sort), then the float64
     walk kernel against the plain frontier loop (closest, shadow
     segments, generic shadow rays; bit-equal, the same visits, each
     way's ms) on the bunny's and the 4x bunny's 1080p rays; the 4x
     bunny's frame of each as a CUDA graph (float64 cut and winner table
     built before it), replayed and timed, each replay bit-equal to the
     eager frame (image, rays, hits, visits), the launches of a replay,
     peak memory, and what ``--d-exact`` costs over ``-d``;
 17. the anim CLI's frame loop (``cli.anim.render_frames``) at its
     default 621 x 1344: 8 turntable frames in batches of 4 with
     ``--save-frames``: the cut built once a batch, K1 and K2 launched
     once a frame, the PNGs written, frames/s and rays/s; frame 3's walks
     against their plain versions on its own inputs, and the frame equal
     to ``render_pipeline`` with its camera and sun;
     ``render_deforming_frames`` on 2 bunny frames with the cut refitted
     equal to the cut rebuilt;
 18. the quality builders: the two g++ libraries (``accel/csrc``,
     ``io/csrc``, built beside nvcc in phase 2) available and used;
     every cut of the bunny (sweep, binned, sbvh, ploc, reinsert), the
     dragon (sweep, binned, ploc) and the 3x and 4x bunny (binned) held
     to the JAX package's fingerprints
     (``tests/fixtures/torch_port_builders.json``: cluster count,
     ``super_S``, supers, sha256 of ``perm``, ``lo``, ``hi``,
     ``super_first``; PLOC, built on the card, also its tree), with each
     build's host seconds and PLOC's rounds; native binned equal to NumPy
     binned on the bunny node for node; each bunny and dragon cut's
     1080p frame (the dragon with ``benchmarks/builder_ab.py``'s camera)
     after the LBVH cut's: K1 and K2 once each and held to their plain
     versions, visits beside ``builder_ab.json``'s, primary hits equal to
     the sweep cut's frame and >= 99.9% of its pixels within 1e-4; the 3x
     bunny's binned cut on K5 and the 4x bunny's (S = 16) on K6 and K7a,
     held to their plain versions, each frame beside the LBVH cut's; the
     render CLI at 1080p with ``--builder binned`` and ``ploc``: K1 and K2
     once each, Rays/Hits those of ``render()`` on the same cut;
 19. several ranks on the one card (``parallel.distributed.run_ranks``:
     two gloo ranks, spawned, each with its own CUDA context and the
     kernels built in phase 2): ``render_sharded`` of the bunny frame
     at 1920 x 1080 (megakernel, smooth, shadows), each rank's K1 and K2
     launch counts rising and each walk held to its plain version on
     that rank's rows, the image within one level of the one-rank
     card render after quantisation and rays/hits equal;
     ``render_primitive_sharded`` of the 4x bunny at 1080p, the variants
     each rank launched, each walk held to its plain version on that
     rank's own inputs, the image against the one-rank frame under the
     primitive-sharding rule (at most 1% of pixels off by more than
     2e-3, primary hits within 1%); a config-4b train step (bunny 1080p,
     d/d vertices and eye) over the two ranks, each rank's walks of its
     first step held to their plain versions: loss and gradients equal
     to the one-rank step's under phase 12's rule, parameters bit-equal
     on both ranks; then one NCCL group of one rank through
     ``render_sharded``. ms a frame and a step of one rank and of two,
     which share the card (no scaling figure);
 20. the shadow wavefront regrouped by receiver
     (``megakernel.any_hit_to_point(regroup=True)``: morton order of the
     receiving points, 128-ray tiles), at 1920 x 1080 on each frame's
     receiving points and skip as ``render_pipeline`` forms them: the
     bunny (SweepSAH cut, resident flat: K2-128), the dragon at 960 x 540
     (SweepSAH cut of 268 blocks, rows longer than a segment of the split
     walk: K2-128), the 3x bunny (treelet cut, streamed flat: K5-128) and
     the 4x bunny (two-level: K7a-128, streamed and resident): the call
     launches its 128-ray variant once and the 512-ray walk not at all,
     and its flags equal ``regroup=False``'s ray for ray; each 128-ray
     kernel and the 512-ray walk on the unregrouped inputs held to their
     plain versions tile by tile, with visits, lane-visits (visits x tile
     width), heaviest tile, ms, bound and share; each 128-ray kernel on
     its heaviest tile alone (that tile's own chain), on every tile but
     that one, with that tile moved to the front of the grid and with no
     candidates at all (its grid's own cost), with the tile's place in
     the grid and how many tiles have candidates; the 5 heaviest
     regrouped tiles: visits, live rays and those never occluded, first
     and last morton code and their highest differing bit, and the
     receivers' bounding box against the scene root's; the whole
     regrouped and unregrouped calls' ms, alternated;
 21. the golden oracle on the card's host: ``render()`` of
     ``scenes.bunny_scene()`` at 64 x 64 on the card, smooth and flat,
     megakernel and bruteforce, against
     ``ceres_tpu_torch.utils.golden.render_golden`` (NumPy float64, no
     JAX): at most 1% of pixels off by more than 2e-3, primary hits within
     1% of W x H (``tests/test_render_golden.py``'s rule);
 22. CUDA graphs (``render.renderer.render_graph``, and
     ``diff.make_train_step``'s captured refitted step), each against its
     eager run: the bench frame (bunny 1080p, SweepSAH cut and winner
     table: K1 + K2), the reference-exact bunny (K1 + K3), the 3x bunny
     (K5 closest + any_dest), the 4x bunny (K6 + K7a) and the
     reference-exact 4x bunny (K6 + K7b), each captured once and replayed
     with the sun moved: one replay with the counts set to 0 just before
     it launches each variant once; stats equal to ``render_pipeline``'s
     on the same inputs, the image within one level (vertex normals are
     summed with ``index_add_`` atomics), each graph-launched walk's ids
     or flags and visits equal to the eager frame's same launch and to a
     launch on the graph's own inputs; CUDA-event ms/frame of eager and
     graph frames alternated (median, min/max), rays/s, and frames/s of
     each back to back on the host clock; every frame config (smooth,
     flat, normal; default and reference-exact; shadows on and off) at
     256 x 256 replayed against its eager frame; the config 4b refitted
     step (bunny 1080p, Adam over the vertices and the eye) and the 4x
     bunny's (vertices) from seeded vertex noise, captured against eager
     (each with a capturable Adam): losses of 3 steps and the parameters
     after them within phase 12's rule, a replayed step's launches, peak
     memory, ms/step alternated;
 23. the LBVH treelet build inside CUDA graphs, each against its eager
     run: the LBVH kernels (``accel/csrc/lbvh.cu``: the hierarchy, one
     thread a node, and the boxes, one thread a leaf) against the plain
     version on the same card tensors, every ``Lbvh`` array bit-equal,
     one launch of each a build, and each kernel's CUDA-event ms (mean
     of LBVH_REPS) beside its bound and its plain part's ms, on the
     bunny, the dragon and the 4x bunny; ``lbvh.build_lbvh`` and
     ``build_clusters_treelet`` captured on those scenes and replayed on
     the vertices moved by seeded noise, every array bit-equal to an
     eager build of them, the treelet build captured again through the
     plain version, bit-equal, and the build's CUDA-event ms, eager,
     plain graph and kernel graph alternated;
     the frame of a deforming scene (``render_graph`` without a prebuilt
     cut or winner table, both built in the graph) at 1080p on the bunny
     (K1 + K2) and the 4x bunny (K6 + K7a), each frame's vertices moved
     by seeded noise (LARGE_NOISE) and every frame held to the eager
     ``render_pipeline`` that builds its cut as phase 22 holds a frame;
     the rebuilt train steps (``make_train_step`` without
     ``clusters0``: config 4b at 1080p, with the forward under
     ``torch.no_grad()`` captured and eager for bwd/fwd, and the 4x
     bunny's), held and timed as phase 22 holds the refitted ones.

``python3 chip_smoke.py --phases 20`` runs phases 1, 2 and the phases
listed (of 16, 20, 21, 22 and 23) and prints no JSON record: the
cluster-size sweep of the 128-ray walk (``hier_sweep.py --k128s``) runs
it.

Every kernel-vs-plain check holds each tile's executed visits, not only
their sum, and prints the kernel's bound: the larger of its fp32
operations (the ray-triangle pairs this run's data needs x
FLOPS_PER_PAIR) over the card's fp32 peak and the bytes it must move
over the memory rate, with the share of it the kernel reached. The
closest walks test every ray against every lane of every executed
visit (visits x 512 x 128 pairs); the shadow walks skip rays already
occluded and stop a ray at its first occluder, so their pairs are the
plain walk's count of exactly those. Each kernel also gets a line of its
own: its form (two-level or flat streamed, with the cluster size K of
``walk.cu``; flat resident: one CTA a tile, with its registers; at 128
rays the split walk's ray groups and segment), its
visits, the heaviest tile's visits
and the time per visit of that tile they imply, kernel ms, bound and
share.

Each path runs with the launch counts set to 0 just before it and read
just after (a train step counts as one run). Before the JSON records,
no process that the script started may be left (``child_processes``).
Any failed check exits non-zero. The line before last is the
kernels' JSON record (every variant a path launches); the last line is
the device record. Needs no network and no JAX.
"""

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
EYE = (0.0, 0.1, -0.3)       # bench.py's camera and sun
SUN = (-50.0, 100.0, 0.0)
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_bunny_128.npz")
BUNNY = os.path.join(ROOT, "data", "bunny.obj")
LARGE_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                             "torch_port_bunny_subdiv4_64.npz")
KERNEL_SOURCE = "ceres_tpu_torch/ops/csrc/walk.cu"
REPLACES = {"walk_closest": "ceres_tpu/ops/megakernel.py:776",
            "walk_any_dest": "ceres_tpu/ops/megakernel.py:703",
            "walk_closest_stream": "ceres_tpu/ops/megakernel.py:477",
            "walk_any_dest_stream": "ceres_tpu/ops/megakernel.py:477",
            "walk_closest_hier_stream": "ceres_tpu/ops/megakernel.py:723",
            "walk_any_dest_hier_stream": "ceres_tpu/ops/megakernel.py:657",
            "walk_any": "ceres_tpu/ops/megakernel.py:604",
            "walk_any_stream": "ceres_tpu/ops/megakernel.py:477",
            "walk_any_hier_stream": "ceres_tpu/ops/megakernel.py:657",
            "walk_closest_window": "ceres_tpu/ops/megakernel.py:645",
            "walk_closest_window_hier_stream":
                "ceres_tpu/ops/megakernel.py:471",
            # The regrouped shadow wavefront's 128-ray tiles
            # (ceres_tpu/ops/megakernel.py:1442), in each form.
            "walk_any_dest_t128": "ceres_tpu/ops/megakernel.py:703",
            "walk_any_dest_stream_t128": "ceres_tpu/ops/megakernel.py:477",
            "walk_any_dest_hier_stream_t128":
                "ceres_tpu/ops/megakernel.py:657"}
W, H = 1920, 1080
FRAMES = 10
LARGE_FRAMES = 5
# Each large scene's path and the variants it must launch.
LARGE = {3: ("walk_closest_stream", "walk_any_dest_stream"),
         4: ("walk_closest_hier_stream", "walk_any_dest_hier_stream")}
# The C++ reference's fixtures: (PPM, rays, hits) it printed.
CPP = {"bunny": ("bunny_64_smooth_ref.ppm", 4645, 804),
       "dragon": ("dragon_64_static_ref.ppm", 4415, 492)}
# Training: steps timed (phase 12), fit steps (13), 4x bunny steps (14),
# the size at which the card's gradients are held to the CPU's, and the
# seeded vertex noise of the fits (a share of the mesh's extent).
STEPS = 20
FIT_SIZE = 512
FIT_STEPS = 24
LARGE_STEPS = 3
GRAD_SIZE = 128
REFIT_SIZE = 256
FIT_NOISE = 0.02
LARGE_NOISE = 0.002
# Phase 18: the quality builders of each scene (the 3x and 4x bunny take
# binned), the JAX package's fingerprints of their cuts, and the dragon's
# camera of benchmarks/builder_ab.py.
QUALITY = {"bunny": ("sweep", "binned", "sbvh", "ploc", "reinsert"),
           "dragon": ("sweep", "binned", "ploc")}
BUILDER_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                               "torch_port_builders.json")
DRAGON_EYE = (0.0, 2.0, -8.0)
# The CLIs (phases 15-17): float64 frames timed, the CPU comparison size,
# and the anim app's default size, frames and batch.
F64_FRAMES = 3
# The float64 walk kernel's ms in phase 16 when it walked each tile on one
# CTA (NVIDIA H100 80GB HBM3, 700 W), beside which the phase prints its
# own: closest, any_dest, any.
F64_ONE_CTA_MS = {"bunny": (1.340, 1.644, 2.171),
                  "bunny x4": (70.830, 49.813, 54.207)}
CLI_CHECK = 128
ANIM_W, ANIM_H = 621, 1344
ANIM_FRAMES, ANIM_BATCH = 8, 4
# Phase 19: frames and steps timed over the ranks, and its seed.
RANK_FRAMES = 5
RANK_STEPS = 3
RANK_SEED = 19
# Phase 20: whole calls timed, regrouped and not, alternated (bunny; the
# large scenes); phase 21: the golden oracle's size.
REGROUP_CALLS = 10
LARGE_REGROUP_CALLS = 5
GOLDEN_SIZE = 64
# Phase 22: frames of the bench frame timed, eager and captured
# alternated; of the large and reference-exact frames; steps compared
# and the 4b step's timed; the size of the config matrix's frames.
GRAPH_FRAMES = 20
GRAPH_LARGE_FRAMES = 5
GRAPH_STEPS = 3
GRAPH_STEP_TIMES = 10
MATRIX_SIZE = 256
# Phase 23: builds timed, graph and eager alternated, a scene; deforming
# frames held and timed (bunny; the 4x bunny); the rebuilt 4b step's
# steps and forwards timed; the seed of the frames' vertex noise.
BUILD_TIMES = 5
LBVH_REPS = 20
DEFORM_FRAMES = 10
DEFORM_LARGE_FRAMES = 3
REBUILT_STEP_TIMES = 20
DEFORM_SEED = 23
# Modes of the walk and their wrappers in ops.walk.
WALKS = {"closest": "walk_closest", "closest_window": "walk_closest",
         "any_dest": "walk_any_dest", "any": "walk_any"}
# fp32 operations per ray-triangle pair of a visit, counted from walk.cu
# (every multiply, add, min and comparison on every pair): the
# numerators, 15 (33 for generic rays), the sign test, 8, and the mode's
# accept, 4 (closest, any) or 8 (any_dest). The reciprocal and window
# tests of the few accepted pairs are left out.
FLOPS_PER_PAIR = {"closest": 27, "closest_window": 27, "any_dest": 31,
                  "any": 45}
# One H100 SXM at its 700 W limit (NVIDIA's data sheet): fp32 outside the
# tensor cores, and HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def child_processes():
    """Pid and command line of each process whose parent is this one."""
    kids = {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as fh:
                ppid = int(fh.read().rsplit(")", 1)[1].split()[1])
            if ppid != os.getpid():
                continue
            with open(f"/proc/{pid}/cmdline") as fh:
                kids[int(pid)] = fh.read().replace("\0", " ").strip()[:120]
        except (OSError, IndexError, ValueError):
            continue
    return kids


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


def shadow_wavefront(vt, ft, cam, cs, width, height, sun=SUN, dirs=None):
    """(primary directions, sun, receiving points, skip): the shadow
    wavefront as ``render_pipeline`` forms it; ``dirs`` the swizzled
    primary directions (default: the column pipeline's)."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.models.camera import camera_ray_columns
    from ceres_tpu_torch.ops import megakernel as mk
    from ceres_tpu_torch.render import renderer
    from ceres_tpu_torch.utils import tiling

    soup = ct.triangle_soup(vt, ft, with_normals=True)
    if dirs is None:
        dirs = tuple(tiling.swizzle_plane(p)
                     for p in camera_ray_columns(cam, width, height))
    hit, pay = mk.closest_hit_common_origin(soup, cam.eye, dirs, clusters=cs,
                                            normal_cols=True)
    points = renderer._hit_points(cam.eye, dirs, hit, pay)
    sun = torch.as_tensor(sun, dtype=torch.float32, device=vt.device)
    return dirs, sun, points, ~hit.mask


def walk_inputs(vt, ft, cam, cs, width, height, sun=SUN, dirs=None):
    """The two walks' (args, opts) as the path builds them; ``dirs`` the
    swizzled primary directions (default: the column pipeline's)."""
    from ceres_tpu_torch.ops import megakernel as mk

    dirs, sun, points, skip = shadow_wavefront(vt, ft, cam, cs, width,
                                               height, sun, dirs)
    return (mk._closest_inputs(cs, cam.eye, dirs),
            mk._any_dest_inputs(cs, sun, points, skip))


def compat_inputs(vt, ft, cam, cs, width, height, windows=False):
    """The reference-exact path's generic shadow-walk (args, opts): rays
    from each compat hit point toward the sun, as ``render_wavefront_cols``
    casts them. With ``windows``, also the windowed closest walk's inputs:
    tmin a little past each ray's first hit (the second surface) and a
    near/far clip of [0.1, 1.0] for the rays that missed."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.models.camera import camera_ray_columns
    from ceres_tpu_torch.ops import megakernel as mk
    from ceres_tpu_torch.render import renderer
    from ceres_tpu_torch.utils import tiling

    soup = ct.triangle_soup(vt, ft, with_normals=True)
    dirs = tuple(tiling.swizzle_plane(p)
                 for p in camera_ray_columns(cam, width, height))
    config = ct.RenderConfig(width=width, height=height, backend="megakernel",
                             reference_compat=True)
    payload, n_pay = renderer._payload_cols(soup, config)
    hit, pay = mk.closest_hit_common_origin(soup, cam.eye, dirs, clusters=cs,
                                            payload=payload, normal_cols=True)
    point = renderer._compat_points(hit, pay, n_pay)
    sun = torch.as_tensor(SUN, device=vt.device)
    sl = tuple(sun[a] - point[a] for a in range(3))
    inv = torch.rsqrt(sl[0] * sl[0] + sl[1] * sl[1] + sl[2] * sl[2])
    generic = mk._any_inputs(cs, renderer._scene_center(soup), point,
                             tuple(c * inv for c in sl), ~hit.mask)
    if not windows:
        return generic
    tmin = torch.where(hit.mask, hit.t * 1.0001, 0.1)
    tmax = torch.where(hit.mask, 1e30, 1.0)
    return generic, (soup, dirs, tmin, tmax)


def positives(mode, out, args):
    """Hits of a plain output, so that an empty comparison shows."""
    if mode.startswith("closest"):
        return int((out >= 0).sum())
    return int(((out == 1) & (args[4] == 0)).sum())


def build_log(name="walk"):
    """nvcc's -Xptxas=-v report of a source's build (``native.SOURCES``)."""
    from ceres_tpu_torch.utils import native

    with open(native.library_path(native.SOURCES[name])[:-3] + ".log") as fh:
        return fh.read()


def resident_registers():
    """Registers a thread of each resident flat walk takes, from the
    build's report, by variant name without ``walk_``: walk_solo<M, 512>,
    and at 128 rays the flat split walk's first pass (split_walk<kAnyDest,
    *, K, false, 128>, which the flat form takes on resident weights too)."""
    from ceres_tpu_torch.ops import walk

    regs, fn = {}, ""
    for line in build_log().splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        used = re.search(r"Used (\d+) registers", line)
        if entry:
            fn = entry.group(1)
            continue
        solo = re.search(r"walk_soloILi(\d+)ELi(\d+)EE", fn)
        split = re.search(r"split_walkILi(\d+)ELb\dELi\d+ELb0ELi(\d+)EE", fn)
        if used and (solo or split):
            mode, tile = map(int, (solo or split).groups())
            name = walk._variant(list(walk.RAY_ROWS)[mode], 1, False, tile)
            regs[name[5:]] = int(used.group(1))
    return regs


def cluster_ctas(name):
    """A constant of walk.cu: K, the CTAs of the cluster that walks one
    tile (kK, the two-level kernels; kKFlat, the streamed flat kernels),
    or the split walk's ray groups a tile (kK128) and block visits a
    segment (kSeg128)."""
    with open(os.path.join(ROOT, KERNEL_SOURCE)) as fh:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             fh.read()).group(1))


def plain_run(mode, args, opts):
    """The plain version on the kernel's inputs: (out, visits per tile,
    pairs), ``pairs`` the ray-triangle pairs the walk had to test: every
    ray against every lane of every visit (closest modes), or each ray
    not yet occluded up to its first occluder (occlusion modes, counted
    by the plain walk)."""
    from ceres_tpu_torch.ops import walk

    if mode.startswith("closest"):
        out, tiles = walk._walk_closest_plain(*args, **opts)
        return out, tiles, int(tiles.sum()) * walk.TILE * walk.CLUSTER_SIZE
    out, tiles, pairs = walk._occlusion_plain(
        mode, *args, *(opts.get(k) for k in ("hull", "bbox", "first")),
        opts["S"])
    return out, tiles, int(pairs)


def bound(mode, args, opts, steps, pairs):
    """(ms, "operations" or "bytes"): the least time the card could take
    for a walk of ``steps`` executed visits that tests ``pairs``
    ray-triangle pairs. Operations: pairs at FLOPS_PER_PAIR over
    PEAK_FLOPS. Bytes: the ray rows, counts, keys, start flags and
    two-level inputs read once, each visit's weight block, and the
    outputs written once, over PEAK_BYTES."""
    counts, keys, rays, w = args[:4]
    inputs = [counts, keys, rays, *args[4:]]
    inputs += [opts[k] for k in ("hull", "bbox", "first")
               if opts.get(k) is not None]
    nbytes = (sum(x.numel() * x.element_size() for x in inputs)
              + steps * w[0].numel() * 4 + rays.shape[1] * 4 + counts.numel() * 4)
    ops = pairs * FLOPS_PER_PAIR[mode]
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(mode, args, opts, reps, plain_ref=None):
    """Kernel against plain version on the same inputs, executed visits
    held tile by tile. ``plain_ref`` (out, per-tile visits, pairs, ms)
    reuses a plain run of the same inputs."""
    from ceres_tpu_torch.ops import walk

    kernel = getattr(walk, WALKS[mode])
    if plain_ref is None:
        plain_ref, plain_ms = timed_once(lambda: plain_run(mode, args, opts))
        plain_ref = (*plain_ref, plain_ms)
    out_p, tiles_p, pairs, plain_ms = plain_ref
    out_k, tiles_k = kernel(*args, **opts)
    torch.cuda.synchronize()
    diff = (out_k.long() - out_p.long()).abs()
    steps = int(tiles_k.sum())
    bound_ms, bound_by = bound(mode, args, opts, steps, pairs)
    ms = cuda_ms(lambda: kernel(*args, **opts), reps)
    return {"mismatches": int((diff > 0).sum()), "max_abs_err": int(diff.max()),
            "steps": steps, "plain_steps": int(tiles_p.sum()), "pairs": pairs,
            "tiles_off": int((tiles_k != tiles_p).sum()),
            "max_tile": int(tiles_k.max()),
            "positives": positives(mode, out_p, args), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "S": opts["S"], "stream": opts["stream"], "mode": mode,
            "tile": args[2].shape[1] // args[0].numel()}, plain_ref


def report(phase, kname, label, r, card):
    print(f"phase {phase} {kname} {label}: mismatches {r['mismatches']} "
          f"max_abs_err {r['max_abs_err']} steps {r['steps']}/"
          f"{r['plain_steps']} tiles with other visits {r['tiles_off']} "
          f"pairs tested {r['pairs']} positives {r['positives']} kernel {r['ms']:.4f} ms plain "
          f"{r['plain_ms']:.2f} ms bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}, share {r['bound_ms'] / r['ms']:.2%}) [{card}]",
          flush=True)
    from ceres_tpu_torch.ops import walk

    tile = r["tile"]
    if tile != walk.TILE:
        kind = ("two-level" if r["S"] > 1 else
                "flat streamed" if r["stream"] else "flat resident")
        form = (f"{kind} split walk: {cluster_ctas('kK128')} ray groups a "
                f"tile of {tile} rays, segments of {cluster_ctas('kSeg128')} "
                f"block visits")
    elif r["S"] > 1:
        form = f"two-level: K {cluster_ctas('kK')}, {tile} rays a tile"
    elif r["stream"]:
        form = f"flat streamed: K {cluster_ctas('kKFlat')}, {tile} rays a tile"
    else:
        regs = resident_registers()[walk._variant(r["mode"], 1, False,
                                                  tile)[5:]]
        form = (f"flat resident: one CTA a tile (walk_solo, {tile} rays, "
                f"{regs} registers)")
    print(f"phase {phase} {kname} {form}; executed visits {r['steps']}; "
          f"heaviest tile {r['max_tile']} visits, "
          f"{r['ms'] * 1e3 / max(r['max_tile'], 1):.3f} us per visit of it; "
          f"kernel {r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}); share {r['bound_ms'] / r['ms']:.2%} [{card}]",
          flush=True)
    check(r["mismatches"] == 0 and r["steps"] == r["plain_steps"]
          and r["tiles_off"] == 0,
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


def render_path(vt, ft, cam, cs, sun, label, frames, card, compat=False):
    """One path's run: launches and stats of one frame with the counts
    reset just before it, then the timed frames. Returns (launches,
    stats, median ms, that frame's image)."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.ops import walk
    from ceres_tpu_torch.render.renderer import prepare_winner_table

    config = ct.RenderConfig(width=W, height=H, backend="megakernel",
                             reference_compat=compat)
    table = prepare_winner_table(ct.triangle_soup(vt, ft), cs, config)
    walk.reset_launches()
    image, stats = ct.render_pipeline(
        vt, ft, cam, sun, dataclasses.replace(config, traversal_stats=True),
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
    mode = "reference-exact smooth+shadows" if compat else "smooth+shadows"
    print(f"{label} {W}x{H} {mode}; launches {launches}; rays "
          f"{stats['rays']} hits {stats['hits']} primary_hits "
          f"{stats['primary_hits']} shadow_hits {stats['shadow_hits']} "
          f"executed visits {stats['traversal_steps']}; ms/frame median "
          f"{ms:.3f} (min {min(times):.3f} max {max(times):.3f}, host wall "
          f"median {statistics.median(walls):.3f}); rays/s "
          f"{stats['rays'] / (ms / 1e3):.4e} [{card}]", flush=True)
    return launches, stats, ms, image


def merge(counts, more):
    """Launch counts of two path runs, summed per variant."""
    return {k: counts.get(k, 0) + more.get(k, 0) for k in {*counts, *more}}


def read_ppm(path):
    """A binary PPM as (H, W, 3) floats in [0, 1] (the header's fields on
    one line or several)."""
    with open(path, "rb") as fh:
        data = fh.read()
    magic, w, h = data.split(maxsplit=3)[:3]
    check(magic == b"P6", f"{path}: not a P6 PPM")
    w, h = int(w), int(h)
    pixels = np.frombuffer(data[len(data) - w * h * 3:], np.uint8)
    return pixels.reshape(h, w, 3).astype(np.float64) / 255.0


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


def launches_of(fn):
    """(fn(), the walk launches it made, by variant)."""
    from ceres_tpu_torch.ops import walk

    walk.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n for k, n in walk.launches.items() if n}


def grad_step(vt, ft, cam, sun, config, target, clusters0=None):
    """Config 4b's step: (step(i), forward(i), leaves). ``step`` takes
    the gradients of ``image_loss`` against ``target`` w.r.t. the leaves
    (vertices, eye) with the sun moved by i * 1e-3, as
    ``benchmarks/run_all.py`` does; ``forward`` is the same loss under
    ``torch.no_grad()``. Without ``clusters0`` the treelet cut is built
    inside the step; with it, refitted to the vertices."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel.clusters import refit_clusters
    from ceres_tpu_torch.diff import image_loss

    leaves = {"vertices": vt.detach().clone().requires_grad_(),
              "eye": cam.eye.detach().clone().requires_grad_()}

    def loss(i):
        clusters = None
        if clusters0 is not None:
            clusters = refit_clusters(clusters0, ct.triangle_soup(
                leaves["vertices"].detach(), ft, with_normals=False))
        c = ct.Camera(eye=leaves["eye"], dir=cam.dir, up=cam.up, fov=cam.fov)
        image, _ = ct.render_pipeline(leaves["vertices"], ft, c,
                                      sun + i * 1e-3, config,
                                      clusters=clusters)
        return image_loss(image, target)

    def step(i):
        for x in leaves.values():
            x.grad = None
        out = loss(i)
        out.backward()
        return out.detach()

    def forward(i):
        with torch.no_grad():
            return loss(i)

    return step, forward, leaves


def grads_on(dev, v, f, weights, size):
    """Image and gradients (vertices, eye) of sum(weights * image) for the
    bunny frame at size x size on ``dev``; ``weights`` None: the image
    alone."""
    import ceres_tpu_torch as ct

    cam = camera(v, EYE, dev)
    vt = torch.tensor(v, device=dev, requires_grad=True)
    eye = cam.eye.clone().requires_grad_()
    config = ct.RenderConfig(width=size, height=size, backend="megakernel")
    image, _ = ct.render_pipeline(
        vt, torch.as_tensor(f, device=dev),
        ct.Camera(eye=eye, dir=cam.dir, up=cam.up, fov=cam.fov),
        torch.as_tensor(SUN, device=dev), config)
    if weights is None:
        return image.detach().cpu(), None
    (image * torch.as_tensor(weights, device=dev)).sum().backward()
    return image.detach().cpu(), {"vertices": vt.grad.cpu(),
                                  "eye": eye.grad.cpu()}


def alternated_times(fns, n):
    """CUDA-event times (ms) of n calls of each fns[k](i), alternated
    (fns[0](0), fns[1](0), fns[0](1), ...) after one warm-up call of
    each, so that a drift of the shared host shows in all of them alike.
    Each call is timed alone, synchronised before and after."""
    for fn in fns:
        fn(0)
    times = [[] for _ in fns]
    for i in range(n):
        for fn, t in zip(fns, times):
            t.append(timed_once(lambda: fn(i))[1])
    return times


def ratio_line(step_t, fwd_t):
    """bwd/fwd = step_ms / forward_ms - 1 of the medians, where the
    interquartile ranges of the step's and the forward's times do not
    overlap; else the word that it is unresolved, with both ranges."""
    (s1, _, s3), (f1, _, f3) = (statistics.quantiles(t, n=4)
                                for t in (step_t, fwd_t))
    spread = (f"step quartiles [{s1:.3f}, {s3:.3f}], forward [{f1:.3f}, "
              f"{f3:.3f}]")
    if s1 > f3 or f1 > s3:
        ratio = statistics.median(step_t) / statistics.median(fwd_t) - 1
        return f"bwd/fwd = step_ms / forward_ms - 1 = {ratio:.3f} ({spread})"
    return f"bwd/fwd unresolved: the quartiles overlap ({spread})"


def hold_walks(phase, vt, ft, cam, cs, width, height, label, card, sun=SUN,
               reps=20, dirs=None):
    """The path's two walks on ``cs`` against their plain versions, as
    phase 3 holds them; returns their wrappers' names."""
    from ceres_tpu_torch.ops import walk

    names = []
    for mode, (args, opts) in zip(("closest", "any_dest"),
                                  walk_inputs(vt, ft, cam, cs, width, height,
                                              sun, dirs)):
        kname = walk._variant(mode, opts["S"], opts["stream"])
        r, _ = compare(mode, args, opts, reps=reps)
        report(phase, kname, f"{label} {width}x{height} ({args[1].shape[0]} "
               f"tiles, {cs.num_clusters} blocks, S = {opts['S']})", r, card)
        names.append(kname)
    return names


def phase12(dev, card):
    """Config 4b on the card; returns the launches of one step."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel.clusters import (build_clusters_treelet,
                                                refit_clusters)

    v, f = ct.load_obj(os.path.join(ROOT, "data", "bunny.obj"))
    cam = camera(v, EYE, dev)
    vt, ft = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
    sun = torch.as_tensor(SUN, device=dev)
    config = ct.RenderConfig(width=W, height=H, backend="megakernel")
    target, _ = ct.render_pipeline(vt, ft, cam, sun, config)
    soup = ct.triangle_soup(vt, ft, with_normals=False)
    clusters0 = build_clusters_treelet(soup)
    # The step's walks on the cuts it walks: the treelet cut it builds
    # from these vertices, and that cut refitted.
    for label, cs in (("treelet cut", clusters0),
                      ("refitted treelet cut", refit_clusters(clusters0,
                                                              soup))):
        check(hold_walks(12, vt, ft, cam, cs, W, H, f"bunny, {label},", card)
              == ["walk_closest", "walk_any_dest"],
              f"phase 12: the {label} is not walked by K1 and K2")
    launches = None
    for label, cs0 in (("treelet cut built in the step", None),
                       ("treelet cut refitted in the step", clusters0)):
        step, forward, leaves = grad_step(vt, ft, cam, sun, config, target,
                                          cs0)
        # Step 1: the sun has moved, so the image and its gradients
        # differ from the target's.
        loss, counted = launches_of(lambda: step(1))
        check(set(counted) == {"walk_closest", "walk_any_dest"},
              f"phase 12 ({label}): a step launched {counted}, not K1 "
              f"and K2")
        check(all(bool(torch.isfinite(x.grad).all()) for x in leaves.values())
              and bool(torch.isfinite(loss)),
              f"phase 12 ({label}): non-finite loss or gradients")
        check(float(leaves["vertices"].grad.abs().max()) > 0,
              f"phase 12 ({label}): zero vertex gradient")
        launches = launches or counted
        torch.cuda.reset_peak_memory_stats()
        step_t, fwd_t = alternated_times((step, forward), STEPS)
        peak = torch.cuda.max_memory_allocated()
        print(f"phase 12 config 4b step, bunny {W}x{H} smooth+shadows, "
              f"d/d(vertices, eye), {label}: ms/step median "
              f"{statistics.median(step_t):.3f} (min {min(step_t):.3f} max "
              f"{max(step_t):.3f}); forward-only ms median "
              f"{statistics.median(fwd_t):.3f} (min {min(fwd_t):.3f} max "
              f"{max(fwd_t):.3f}); CUDA events, {STEPS} of each alternated; "
              f"{ratio_line(step_t, fwd_t)}; peak memory "
              f"{peak / 2**20:.1f} MiB; launches a step {counted}; loss "
              f"{float(loss):.6e} [{card}]", flush=True)

    # The card's gradients against the CPU's on the same inputs; pixels
    # whose colour differs (a silhouette or shadow ray flipped by the
    # card's rsqrt) leave the loss.
    images = {d: grads_on(d, v, f, None, GRAD_SIZE)[0] for d in ("cpu", dev)}
    agree = ((images["cpu"] - images[dev]).abs().amax(-1) <= 1e-4).numpy()
    off = int((~agree).sum())
    check(off <= 0.005 * GRAD_SIZE ** 2,
          f"phase 12: {off} pixels differ between the card and the CPU")
    weights = (np.random.default_rng(12).uniform(
        size=(GRAD_SIZE, GRAD_SIZE, 1)) * agree[..., None]).astype(np.float32)
    grads = {d: grads_on(d, v, f, weights, GRAD_SIZE)[1] for d in ("cpu", dev)}
    for k in ("vertices", "eye"):
        want, got = grads["cpu"][k].double(), grads[dev][k].double()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        ok = scale > 0 and bool(((got - want).abs()
                                 <= 1e-5 * scale + 1e-4 * want.abs()).all())
        print(f"phase 12 gradients card vs CPU, bunny {GRAD_SIZE}x"
              f"{GRAD_SIZE}, d/d{k}: max |g| {scale:.6e}, max abs diff "
              f"{err:.3e} (rtol 1e-4, atol 1e-5 max|g|); pixels left out "
              f"{off}", flush=True)
        check(ok, f"phase 12: the card's d/d{k} differs from the CPU's")
    return launches


def fit_problem(dev):
    """Config 4's fit as phase 13 runs it: (scene, config, target on
    ``dev``, the noisy start vertices): the bunny preset at FIT_SIZE, its
    vertices moved by seeded noise of FIT_NOISE of the mesh's extent."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.render import scenes

    sc = scenes.bunny_scene()
    config = ct.RenderConfig(width=FIT_SIZE, height=FIT_SIZE,
                             backend="megakernel")
    target, st = ct.render(sc.vertices, sc.faces, sc.camera, sc.sun,
                           config=config, device=dev)
    check(int(st["primary_hits"]) > 0.05 * FIT_SIZE ** 2,
          "the bunny preset is not seen")
    v0 = sc.vertices
    scale = float(np.abs(v0 - v0.mean(0)).max())
    noise = np.random.default_rng(3).standard_normal(v0.shape)
    return sc, config, target, (v0 + FIT_NOISE * scale * noise).astype(
        np.float32)


def fit_step(dev, sc, config, target, noisy):
    """The step of ``fit_vertices(refit=True)`` on its own: (step(i),
    the treelet cut of the start vertices, the synchronised ms of its one
    build). ``step`` takes one Adam step (lr 2e-4) of the vertices and
    reads the loss, as the fit does."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel.clusters import build_clusters_treelet
    from ceres_tpu_torch.diff import TrainState, make_train_step

    ft = torch.as_tensor(sc.faces, device=dev)
    cam = ct.Camera.make(sc.camera.eye, sc.camera.dir, sc.camera.up,
                         sc.camera.fov, device=dev)
    v0 = torch.as_tensor(noisy, device=dev)
    cs0, build_ms = timed_once(lambda: build_clusters_treelet(
        ct.triangle_soup(v0, ft, with_normals=False)))
    params = {"vertices": v0.clone().requires_grad_()}
    train = make_train_step(ft, cam, torch.as_tensor(sc.sun, device=dev),
                            config, torch.optim.Adam(params.values(),
                                                     lr=2e-4,
                                                     capturable=True),
                            clusters0=cs0)
    state = [TrainState(params, {"vertices": {}})]

    def step(i):
        state[0], loss = train(state[0], target)
        return float(loss)

    return step, cs0, build_ms


def phase13(dev, card, meshes):
    """Config 4: the inverse-rendering fit; refit against rebuild."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel.clusters import (build_clusters_treelet,
                                                refit_clusters)
    from ceres_tpu_torch.diff import fit_vertices

    sc, config, target, noisy = fit_problem(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (params, history), launches = launches_of(lambda: fit_vertices(
        noisy, sc.faces, sc.camera, sc.sun, target, config=config,
        steps=FIT_STEPS, learning_rate=2e-4, refit=True, device=dev))
    wall_s = time.perf_counter() - t0
    print(f"phase 13 config 4 fit, bunny preset {FIT_SIZE}x{FIT_SIZE}, refit, "
          f"lr 2e-4, {FIT_STEPS} steps through fit_vertices: {wall_s:.3f} s "
          f"on the host clock (the process's first fit, the cut's build "
          f"included); launches {launches}; losses "
          f"{[float(f'{x:.6e}') for x in history]} [{card}]", flush=True)
    check(np.isfinite(history).all() and history[-1] < history[0],
          "phase 13: the fit's loss did not fall")
    check(set(launches) == {"walk_closest", "walk_any_dest"},
          f"phase 13: the fit launched {launches}")

    step, cs0, build_ms = fit_step(dev, sc, config, target, noisy)
    times, _ = frame_times(step, FIT_STEPS)
    print(f"phase 13 config 4 fit step, bunny preset {FIT_SIZE}x{FIT_SIZE}, "
          f"refitted cut: ms/step median {statistics.median(times):.3f} (min "
          f"{min(times):.3f} max {max(times):.3f}; CUDA events over "
          f"{FIT_STEPS} steps after two warm-up steps, the loss read each "
          f"step); the cut's one build {build_ms:.3f} ms [{card}]",
          flush=True)
    # The fit's walks on the cut its last step walked: the start cut
    # refitted to the fitted vertices.
    cam = ct.Camera.make(sc.camera.eye, sc.camera.dir, sc.camera.up,
                         sc.camera.fov, device=dev)
    ft = torch.as_tensor(sc.faces, device=dev)
    fitted = params["vertices"]
    cs = refit_clusters(cs0, ct.triangle_soup(fitted, ft,
                                              with_normals=False))
    check(hold_walks(13, fitted, ft, cam, cs, FIT_SIZE, FIT_SIZE,
                     "bunny preset fitted, refitted treelet cut,", card,
                     sun=sc.sun) == ["walk_closest", "walk_any_dest"],
          "phase 13: the fit's cut is not walked by K1 and K2")

    rng = np.random.default_rng(13)
    for name, (v, f) in meshes.items():
        vt = torch.as_tensor(v, device=dev)
        ft = torch.as_tensor(f, device=dev)
        cs0 = build_clusters_treelet(ct.triangle_soup(vt, ft,
                                                      with_normals=False))
        moved = ct.triangle_soup(
            vt + torch.as_tensor(1e-3 * rng.standard_normal(v.shape),
                                 dtype=torch.float32, device=dev), ft,
            with_normals=False)
        refit_ms = cuda_ms(lambda: refit_clusters(cs0, moved), 5)
        build_ms = cuda_ms(lambda: build_clusters_treelet(moved), 5)
        print(f"phase 13 {name} ({f.shape[0]} triangles, {cs0.num_clusters} "
              f"blocks): refit_clusters {refit_ms:.3f} ms, "
              f"build_clusters_treelet {build_ms:.3f} ms (CUDA events, mean "
              f"of 5) [{card}]", flush=True)
    return launches


def phase14(dev, card, v, f, cs0):
    """The 4x bunny: refit against a fresh build, then train steps."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel.clusters import (build_clusters_treelet,
                                                refit_clusters)
    from ceres_tpu_torch.diff import TrainState, make_train_step

    cam = camera(v, EYE, dev)
    vt, ft = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
    sun = torch.as_tensor(SUN, device=dev)
    scale = float(np.abs(v - v.mean(0)).max())
    noise = np.random.default_rng(14).standard_normal(v.shape)
    moved = vt + torch.as_tensor(LARGE_NOISE * scale * noise,
                                 dtype=torch.float32, device=dev)
    soup = ct.triangle_soup(moved, ft, with_normals=False)
    small = ct.RenderConfig(width=REFIT_SIZE, height=REFIT_SIZE,
                            backend="megakernel")
    images = [ct.render_pipeline(moved, ft, cam, sun, small, clusters=cs)[0]
              for cs in (refit_clusters(cs0, soup),
                         build_clusters_treelet(soup))]
    frac = float(((images[0] - images[1]).abs().amax(-1) > 1e-4)
                 .float().mean())
    print(f"phase 14 bunny x4 ({f.shape[0]} triangles) moved by seeded "
          f"noise: refitted cut against a fresh treelet build, {REFIT_SIZE}x"
          f"{REFIT_SIZE}: "
          f"pixels off by >1e-4 {frac:.4%} (limit 0.5%)", flush=True)
    check(frac < 0.005 and float(images[1].max()) > 0,
          "phase 14: the refitted cut renders another image")
    # The train steps' walks on the cut they start from.
    check(tuple(hold_walks(14, moved, ft, cam, refit_clusters(cs0, soup), W,
                           H, "bunny x4 moved, refitted treelet cut,", card,
                           reps=3)) == LARGE[4],
          "phase 14: the refitted cut is not walked by K6 and K7a")

    config = ct.RenderConfig(width=W, height=H, backend="megakernel")
    target, _ = ct.render_pipeline(vt, ft, cam, sun, config, clusters=cs0)
    params = {"vertices": moved.clone().requires_grad_()}
    step = make_train_step(ft, cam, sun, config,
                           torch.optim.Adam(params.values(), lr=1e-5,
                                            capturable=True),
                           clusters0=cs0)
    state = TrainState(params, {"vertices": {}})
    torch.cuda.reset_peak_memory_stats()
    (state, loss), launches = launches_of(lambda: step(state, target))
    check(set(launches) == set(LARGE[4]),
          f"phase 14: a step launched {launches}, not K6 and K7a")
    times, losses = [], [float(loss)]
    for _ in range(LARGE_STEPS):
        (state, loss), ms = timed_once(lambda: step(state, target))
        times.append(ms)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(params["vertices"].grad).all())
          and np.isfinite(losses).all(),
          "phase 14: non-finite loss or gradients")
    check(not torch.equal(params["vertices"].detach(), moved),
          "phase 14: the steps did not move the vertices")
    print(f"phase 14 train step, bunny x4 {W}x{H}, refitted cut, Adam over "
          f"the vertices: ms/step median {statistics.median(times):.3f} "
          f"(CUDA events, {LARGE_STEPS} steps after one counted step: "
          f"{[round(t, 3) for t in times]}); peak memory "
          f"{peak / 2**20:.1f} MiB; launches a step {launches}; losses "
          f"{losses} [{card}]", flush=True)
    return launches


def run_cli(fn, *args):
    """(fn(*args), what it printed): a CLI function, its output kept."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def cli_counts(text):
    """The Rays/Hits lines a render CLI printed."""
    return {k: int(n) for k, n in re.findall(r"^(Rays|Hits): (\d+)$", text,
                                             re.M)}


def ppm_off(a, b):
    """Share of pixels of two PPM files more than one level of 255 apart."""
    return float((np.abs(read_ppm(a) - read_ppm(b)).max(-1)
                  > 1.5 / 255).mean())


def render_cli(tmp, name, flags, dev):
    """``cli.render.main`` writing tmp/name.ppm on ``dev``: (path, its
    Rays/Hits, the walk launches it made)."""
    from ceres_tpu_torch.cli import render as cli

    path = os.path.join(tmp, f"{name}.ppm")
    (rc, text), launches = launches_of(
        lambda: run_cli(cli.main, [BUNNY, "-o", path, *flags], dev))
    check(rc == 0 and os.path.exists(path), f"ceres-torch-render {flags} "
          f"failed: {text}")
    return path, cli_counts(text), launches


def against_cpu(tmp, name, flags, dev, label):
    """The render CLI at CLI_CHECK x CLI_CHECK on the card and on the CPU:
    fewer than 0.5% of pixels more than one level apart."""
    size = ["--width", str(CLI_CHECK), "--height", str(CLI_CHECK)]
    card, counts, _ = render_cli(tmp, f"{name}_card", [*flags, *size], dev)
    cpu, cpu_counts, _ = render_cli(tmp, f"{name}_cpu", [*flags, *size],
                                    "cpu")
    off = ppm_off(card, cpu)
    print(f"{label} card vs CPU {CLI_CHECK}x{CLI_CHECK}: pixels more than "
          f"one level apart {off:.4%} (limit 0.5%); Rays/Hits card "
          f"{counts} CPU {cpu_counts}", flush=True)
    check(off < 0.005, f"{label}: the card's image differs from the CPU's")


K1_K2_ONCE = {"walk_closest": 1, "walk_any_dest": 1}


def phase15(dev, card, tmp):
    """The render CLI at its defaults, then with a sphere."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel.clusters import build_clusters_treelet
    from ceres_tpu_torch.utils.image import write_ppm

    path, counts, launches = render_cli(tmp, "cli", [], dev)
    check(launches == K1_K2_ONCE,
          f"phase 15: the CLI frame launched {launches}, not K1 and K2 once")
    v, f = ct.load_obj(BUNNY)
    cam = camera(v, EYE, dev)
    config = ct.RenderConfig(width=W, height=H, backend="megakernel")
    img, st = ct.render(v, f, cam, SUN, config=config, device=dev)
    ref = os.path.join(tmp, "render.ppm")
    write_ppm(ref, img.cpu().numpy())
    # Vertex normals are summed with atomics (index_add_) on the card, so
    # two renders differ in the last bits of their shading: a level at
    # most after quantisation, never a hit or a shadow.
    levels = np.abs(read_ppm(path) - read_ppm(ref)).max(-1) * 255.0
    print(f"phase 15 render CLI, bunny {W}x{H} at its defaults (lbvh "
          f"treelet cut, smooth, shadows): launches {launches}; "
          f"Rays/Hits {counts}; against render()'s image: "
          f"{int((levels > 0.5).sum())} pixels one level apart, "
          f"{int((levels > 1.5).sum())} more (limit 0)", flush=True)
    check(int((levels > 1.5).sum()) == 0
          and counts == {"Rays": int(st["rays"]), "Hits": int(st["hits"])},
          "phase 15: the CLI's frame differs from render()'s")
    vt, ft = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
    cs = build_clusters_treelet(ct.triangle_soup(vt, ft, with_normals=False))
    check(hold_walks(15, vt, ft, cam, cs, W, H, "bunny CLI frame, treelet "
                     "cut,", card) == ["walk_closest", "walk_any_dest"],
          "phase 15: the CLI frame is not walked by K1 and K2")
    sun = np.asarray(SUN, np.float32)
    times, walls = frame_times(lambda i: ct.render(
        v, f, cam, sun + i * 1e-3, config=config, device=dev), FRAMES)
    ms = statistics.median(times)
    print(f"phase 15 CLI frame through render(), bunny {W}x{H}, the treelet "
          f"cut built in each frame: ms/frame median {ms:.3f} (min "
          f"{min(times):.3f} max {max(times):.3f}, host wall median "
          f"{statistics.median(walls):.3f}); rays/s "
          f"{int(st['rays']) / (ms / 1e3):.4e} [{card}]", flush=True)

    # A sphere between the bunny and the sun: seen, and shadowing it.
    center = v.mean(0)
    up = (sun - center) / np.linalg.norm(sun - center)
    sphere = [float(x) for x in center + 0.06 * up] + [0.02]
    flags = ["--sphere", *(repr(float(x)) for x in sphere)]
    _, counts, slaunch = render_cli(tmp, "sphere", flags, dev)
    check(slaunch == K1_K2_ONCE,
          f"phase 15: the sphere frame launched {slaunch}")
    small = ct.RenderConfig(width=CLI_CHECK, height=CLI_CHECK,
                            backend="megakernel")
    st0 = ct.render(v, f, cam, SUN, config=small, device=dev)[1]
    st1 = ct.render(v, f, cam, SUN, config=small, device=dev,
                    spheres=(sphere[:3], sphere[3:]))[1]
    print(f"phase 15 render CLI --sphere {sphere}: launches {slaunch}; "
          f"Rays/Hits {counts}; at {CLI_CHECK}x{CLI_CHECK} primary hits "
          f"{int(st0['primary_hits'])} -> {int(st1['primary_hits'])}, shadow "
          f"hits {int(st0['shadow_hits'])} -> {int(st1['shadow_hits'])}",
          flush=True)
    check(int(st1["primary_hits"]) > int(st0["primary_hits"])
          and int(st1["shadow_hits"]) > int(st0["shadow_hits"]),
          "phase 15: the sphere is not seen or casts no shadow")
    against_cpu(tmp, "sphere", flags, dev, "phase 15 render CLI --sphere")
    return merge(launches, slaunch)


def f64_prepass_both_ways(w, args, opts, label):
    """The float64 prepass kernel against the plain passes on the same
    card tensors, the arguments an entry point gave ``_prepass`` (``w``
    its walk inputs, from the kernel): counts equal, order and ent_sorted
    bit-equal up to them, the tail at least _VALID_CUT; each way's
    CUDA-event ms (median of 3 after one), and the kernel's launch
    alone on the same hulls; survivors a tile (mean, p99, max) and the
    tiles past the kernel's shared-memory sort."""
    from ceres_tpu_torch.ops import prepass, walk_f64

    def ms(fn):
        return statistics.median([timed_once(fn)[1] for _ in range(4)][1:])

    cs, shift, dir_cols, *rest = args
    dirs_tiled, orig_tiled, alive = walk_f64._tile_rays(dir_cols, *rest)
    hulls = (*prepass._hull(dirs_tiled, alive),
             *(prepass._hull(orig_tiled, alive) if orig_tiled is not None
               else (None, None)))
    lo, hi, live = cs.lo - shift, cs.hi - shift, alive.any(dim=1)
    launch_ms = ms(lambda: walk_f64._prepass_kernel(lo, hi, *hulls, live,
                                                    opts["mode"]))
    kernel_ms = ms(lambda: walk_f64._prepass(*args, **opts))
    plain_ms = ms(lambda: walk_f64._prepass_plain(*args))
    order, ent, counts = walk_f64._prepass_plain(*args)[:3]
    n_t, n_c = ent.shape
    head = torch.arange(n_c, device=ent.device)[None, :] < counts[:, None]
    same = (torch.equal(counts, w["counts"])
            and torch.equal(order[head], w["order"][head])
            and torch.equal(ent.view(torch.int64)[head],
                            w["ent"].view(torch.int64)[head])
            and bool((w["ent"][~head] >= prepass._VALID_CUT).all()))
    with open(os.path.join(ROOT, "ceres_tpu_torch", "ops", "csrc",
                           "walk_f64.cu")) as fh:
        cap = int(re.search(r"constexpr int kSortCap = (\d+);",
                            fh.read()).group(1))
    c = counts.double()
    print(f"phase 16 float64 prepass {opts['mode']}, {label} ({n_t} tiles x "
          f"{n_c} clusters): with the kernel {kernel_ms:.3f} ms (its launch "
          f"alone {launch_ms:.3f}), plain passes {plain_ms:.3f} ms; bit-equal "
          f"up to the counts {same}; "
          f"survivors {int(counts.sum())}, a tile mean {float(c.mean()):.2f}"
          f", p99 {float(torch.quantile(c, 0.99)):.0f}, max "
          f"{int(counts.max())}, tiles past the shared sort's {cap}: "
          f"{int((counts > cap).sum())}", flush=True)
    check(same, f"phase 16: the float64 {opts['mode']} prepass kernel "
          f"differs from the plain passes on {label}")


MODE_ORDER = ("closest", "any_dest", "any")


def f64_walks_both_ways(cs, eye, dirs, sun, label, chunk=None):
    """The float64 walk kernel against the plain frontier loop (``chunk``
    tiles a chunk) on the same card tensors, the inputs of the entry
    points' prepasses: the closest search from ``eye`` along ``dirs``,
    then the shadow segments from ``sun`` to the hit points (misses
    skipped) and generic shadow rays from them toward it. Slots and flags
    bit-equal, visits equal, one kernel launch a walk, in the cluster
    form where the rows are longer than ``walk_f64._SOLO_ROW``; each
    way's CUDA-event ms of the walk alone, the kernel's beside its
    one-CTA-a-tile ms (``F64_ONE_CTA_MS``); the heaviest tile's visits and
    rounds (of kK candidates in the cluster form, else 1), and the most
    visits made and dropped past the stop (a tile whose last round holds
    n < kK of its visits drops at most kK - n, and no more than the
    candidates left). Each prepass first, against its plain passes
    (``f64_prepass_both_ways``)."""
    from ceres_tpu_torch.ops import walk_f64

    pts = skip = sl = None
    rows = []
    real, calls = walk_f64._prepass, []
    with open(os.path.join(ROOT, "ceres_tpu_torch", "ops", "csrc",
                           "walk_f64.cu")) as fh:
        K = int(re.search(r"constexpr int kK = (\d+);", fh.read()).group(1))

    def recorder(*args, **opts):
        calls.append((args, opts))
        return real(*args, **opts)

    for mode in MODE_ORDER:
        walk_f64._prepass = recorder
        try:
            if mode == "closest":
                w = walk_f64._closest_inputs(cs, eye, dirs)
            elif mode == "any_dest":
                w = walk_f64._any_dest_inputs(cs, sun, pts, skip)
            else:
                w = walk_f64._any_inputs(cs, cs.p0.mean((0, 1)), pts, sl,
                                         skip)
        finally:
            walk_f64._prepass = real
        f64_prepass_both_ways(w, *calls.pop(), label)
        walk_f64.reset_launches()
        (got, tiles), ms = timed_once(lambda: walk_f64._walk_card(
            w["cs"], w["weights"], w["order"], w["ent"], w["counts"],
            w["d3"], w["o3"], w["alive"], w["tcap"], w.get("tmin"),
            w.get("tmax"), w.get("occ0"), mode))
        launched = {k: n for k, n in walk_f64.launches.items() if n}
        clustered = {k: n for k, n in walk_f64.clustered.items() if n}
        (want, wvisits), plain_ms = timed_once(
            lambda: walk_f64._walk_plain(**w, chunk=chunk))
        same = torch.equal(got, want)
        visits, wvisits = int(tiles.sum()), int(wvisits)
        form = (launched if w["ent"].shape[1] > walk_f64._SOLO_ROW
                else {})
        k = K if form else 1
        last = tiles % k
        dropped = int(torch.where(last > 0, torch.minimum(
            k - last, w["counts"] - tiles), 0).sum())
        before = F64_ONE_CTA_MS.get(label.split(" 1920")[0])
        before = "" if before is None else (
            f" (one CTA a tile: {before[MODE_ORDER.index(mode)]:.3f} ms)")
        print(f"phase 16 float64 walk {mode}, {label}: kernel {ms:.3f} ms"
              f"{before}, plain loop {plain_ms:.3f} ms; visits {visits} "
              f"(plain {wvisits}); heaviest tile {int(tiles.max())} visits, "
              f"{-(-int(tiles.max()) // k)} rounds of {k}; visits dropped "
              f"past the stop at most {dropped}; bit-equal {same}; launches "
              f"{launched}, clustered {clustered}", flush=True)
        check(same and visits == wvisits and launched == {mode: 1}
              and clustered == form,
              f"phase 16: the float64 {mode} kernel differs from the plain "
              f"loop on {label}")
        rows.append((mode, visits, ms, plain_ms))
        if mode == "closest":
            # Points a little short of each hit (its t from the winning
            # slot's records), the receivers of both shadow walks.
            got = got.reshape(-1)[:dirs[0].shape[0]]
            hit = got >= 0
            idx = got.clamp(min=0).long()
            p0 = cs.p0.reshape(-1, 3)[idx]
            n = cs.n.reshape(-1, 3)[idx]
            d = torch.stack(dirs, -1)
            t = ((n * (p0 - eye)).sum(-1) / (n * d).sum(-1))
            t = torch.where(hit, t, 0.0)
            pts = tuple(eye[a] + 0.999 * t * dirs[a] for a in range(3))
            skip = ~hit
            s = tuple(sun[a] - pts[a] for a in range(3))
            inv = torch.rsqrt(s[0] * s[0] + s[1] * s[1] + s[2] * s[2])
            sl = tuple(x * inv for x in s)
    return rows


def phase16(dev, card, tmp, meshes=None):
    """Float64: -d and --d-exact through the CLI at 1080p; the float64 walk
    kernel against the plain loop; the 4x bunny's float64-exact frame as
    a CUDA graph against the eager frame."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel.clusters import build_clusters_treelet
    from ceres_tpu_torch.models.camera import camera_ray_columns
    from ceres_tpu_torch.ops import walk, walk_f64
    from ceres_tpu_torch.render.renderer import (prepare_winner_table,
                                                 render_graph)
    from ceres_tpu_torch.utils import tiling

    d_path, d_counts, d_launch = render_cli(tmp, "d", ["-d"], dev)
    check(d_launch == K1_K2_ONCE,
          f"phase 16: -d launched {d_launch}, not K1 and K2 once")
    walk_f64.reset_launches()
    x_path, x_counts, x_launch = render_cli(tmp, "d_exact", ["--d-exact"],
                                            dev)
    x_f64 = {k: n for k, n in walk_f64.launches.items() if n}
    check(not x_launch, f"phase 16: --d-exact launched {x_launch}")
    check(x_f64 == {"closest": 1, "any_dest": 1},
          f"phase 16: --d-exact launched the float64 walk {x_f64}, not "
          f"closest and any_dest once")
    off = ppm_off(d_path, x_path)
    print(f"phase 16 render CLI -d {W}x{H}: launches {d_launch}, Rays/Hits "
          f"{d_counts}; --d-exact: launches {x_launch}, float64 walk "
          f"launches {x_f64}, Rays/Hits {x_counts}; pixels more than one "
          f"level apart {off:.4%} (limit 0.5%)", flush=True)
    check(off < 0.005, "phase 16: --d-exact's image differs from -d's")
    against_cpu(tmp, "d", ["-d"], dev, "phase 16 render CLI -d")
    against_cpu(tmp, "d_exact", ["--d-exact"], dev,
                "phase 16 render CLI --d-exact")

    v, f = ct.load_obj(BUNNY)
    v64 = v.astype(np.float64)
    eye = np.asarray(EYE)
    cam = ct.Camera.make(eye=eye, dir=v64.mean(0) - eye, up=(0, 1, 0),
                         fov=60.0, dtype=torch.float64, device=dev)
    sun = np.asarray(SUN)
    line = []
    for label, exact in (("-d", False), ("--d-exact", True)):
        config = ct.RenderConfig(width=W, height=H, backend="megakernel",
                                 f64_exact=exact, traversal_stats=True)

        def frame(i):
            return ct.render(v64, f, cam, sun + i * 1e-3, config=config,
                             device=dev)

        (img, st), _ = timed_once(lambda: frame(0))
        times = [timed_once(lambda: frame(i + 1))[1]
                 for i in range(F64_FRAMES)]
        check(img.dtype == torch.float64 and bool(torch.isfinite(img).all()),
              f"phase 16 {label}: not a finite float64 image")
        line.append(f"{label}: ms/frame median {statistics.median(times):.3f} "
                    f"({[round(t, 3) for t in times]}), executed visits "
                    f"{int(st['traversal_steps'])}")
    print(f"phase 16 float64 bunny {W}x{H} through render(), the treelet cut "
          f"built in each frame, CUDA events, {F64_FRAMES} frames after one: "
          f"{'; '.join(line)} [{card}]", flush=True)

    # The kernel against the plain loop on the bunny's 1080p rays.
    vt, ft = torch.as_tensor(v64, device=dev), torch.as_tensor(f, device=dev)
    cs = build_clusters_treelet(ct.triangle_soup(vt, ft, with_normals=False))
    dirs = tuple(tiling.swizzle_plane(p) for p in camera_ray_columns(cam, W,
                                                                     H))
    sun_t = torch.as_tensor(sun, device=dev)
    f64_walks_both_ways(cs, cam.eye, dirs, sun_t, f"bunny {W}x{H}")

    # The 4x bunny: the float64-exact frame as a graph, and its walks.
    v4, f4 = (meshes or bunny_meshes())[4]
    vt = torch.as_tensor(v4.astype(np.float64), device=dev)
    ft = torch.as_tensor(f4, device=dev)
    cam4 = ct.Camera.make(eye=eye, dir=v4.astype(np.float64).mean(0) - eye,
                          up=(0, 1, 0), fov=60.0, dtype=torch.float64,
                          device=dev)
    frames = []
    for label, exact in (("-d", False), ("--d-exact", True)):
        config = ct.RenderConfig(width=W, height=H, backend="megakernel",
                                 f64_exact=exact, traversal_stats=True)
        cs = build_clusters_treelet(ct.triangle_soup(vt, ft,
                                                     with_normals=False))
        table = prepare_winner_table(ct.triangle_soup(vt, ft), cs, config)
        torch.cuda.reset_peak_memory_stats()
        fg = render_graph(vt, ft, cam4, sun_t, config, cs, table)
        times, same = [], True
        for i in range(F64_FRAMES + 1):
            s_i = sun_t + i * 1e-3
            walk.reset_launches()
            walk_f64.reset_launches()
            (img, st), ms = timed_once(lambda: fg(sun_position=s_i))
            f32 = {k: n for k, n in walk.launches.items() if n}
            f64 = {k: n for k, n in walk_f64.launches.items() if n}
            p64 = {k: n for k, n in walk_f64.prepass_launches.items() if n}
            times.append(ms)
            img_e, st_e = ct.render_pipeline(vt, ft, cam4, s_i, config,
                                             clusters=cs, table_cols=table)
            same = same and torch.equal(img.view(torch.int64),
                                        img_e.view(torch.int64)) and {
                k: int(x) for k, x in st.items()} == {
                k: int(x) for k, x in st_e.items()}
        peak = torch.cuda.max_memory_allocated()
        want = ({"closest": 1, "any_dest": 1}, {}) if exact else (
            {}, {"walk_closest_hier_stream": 1,
                 "walk_any_dest_hier_stream": 1})
        print(f"phase 16 bunny x4 {W}x{H} float64 {label} as a CUDA graph "
              f"(float64 treelet cut, {cs.num_clusters} blocks): replayed "
              f"ms {[round(t, 3) for t in times]}, median of the last "
              f"{F64_FRAMES} {statistics.median(times[1:]):.3f}; launches a "
              f"replay float64 {f64}, float32 {f32}; image, rays, hits and "
              f"visits == the eager frame's {same}; visits "
              f"{int(st['traversal_steps'])}; peak memory {peak} bytes "
              f"[{card}]", flush=True)
        check(same, f"phase 16: the bunny x4 {label} graph differs from the "
              f"eager frame")
        check((f64, f32) == want and p64 == f64, f"phase 16: the bunny x4 "
              f"{label} graph launched {f64} {f32}, prepass {p64}")
        frames.append(statistics.median(times[1:]))
        del fg, img, img_e
    print(f"phase 16 bunny x4 {W}x{H}: --d-exact costs "
          f"{frames[1] / frames[0]:.2f}x the -d frame ({frames[1]:.3f} "
          f"against {frames[0]:.3f} ms) [{card}]", flush=True)
    dirs = tuple(tiling.swizzle_plane(p) for p in camera_ray_columns(cam4, W,
                                                                     H))
    f64_walks_both_ways(cs, cam4.eye, dirs, sun_t, f"bunny x4 {W}x{H}",
                        chunk=512)
    return d_launch


def phase17(dev, card, tmp):
    """The anim CLI's frame loop at its default size; deforming frames."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel import clusters as cl
    from ceres_tpu_torch.cli import anim
    from ceres_tpu_torch.models.camera import camera_rays_rows
    from ceres_tpu_torch.ops.intersect import full_fp32_matmul
    from ceres_tpu_torch.parallel.sharded import (render_deforming_frames,
                                                  turntable_transforms)
    from ceres_tpu_torch.utils import tiling
    from ceres_tpu_torch.utils.image import to_uint8

    frames_dir = os.path.join(tmp, "frames")
    args = anim.build_parser().parse_args(
        [BUNNY, "-o", os.path.join(tmp, "anim.mp4"), "--frames",
         str(ANIM_FRAMES), "--batch", str(ANIM_BATCH), "--save-frames",
         frames_dir])
    builds = []
    real_build = cl.build_clusters_treelet

    def counted_build(*a, **k):
        builds.append(1)
        return real_build(*a, **k)

    cl.build_clusters_treelet = counted_build
    try:
        torch.cuda.synchronize()
        ((u8, rays, secs), _), launches = launches_of(
            lambda: run_cli(anim.render_frames, args, dev))
    finally:
        cl.build_clusters_treelet = real_build
    batches = -(-ANIM_FRAMES // ANIM_BATCH)
    written = sum(os.path.exists(anim.frame_path(args, k))
                  for k in range(ANIM_FRAMES))
    per_frame = {"walk_closest": ANIM_FRAMES, "walk_any_dest": ANIM_FRAMES}
    print(f"phase 17 anim CLI frame loop, bunny {ANIM_W}x{ANIM_H}, "
          f"{ANIM_FRAMES} turntable frames in batches of {ANIM_BATCH}, "
          f"--save-frames: {secs:.3f} s on the host clock (PNG writes "
          f"included), {ANIM_FRAMES / secs:.3f} frames/s, {rays} rays, "
          f"{rays / secs:.4e} rays/s; cut builds {len(builds)} ({batches} "
          f"batches); launches {launches}; PNGs written {written} [{card}]",
          flush=True)
    check(len(builds) == batches, f"phase 17: {len(builds)} cut builds for "
          f"{batches} batches")
    check(launches == per_frame, f"phase 17: launches {launches}, not K1 "
          f"and K2 once a frame")
    check(written == ANIM_FRAMES and all(x is not None for x in u8),
          "phase 17: frames missing")

    # Frame 3 on its own inputs: its walks, and render_pipeline's image.
    k = 3
    v, f = ct.load_obj(BUNNY)
    center = v.mean(axis=0)
    eye = center + np.asarray(
        [0, 0, -2.5 * float(np.linalg.norm(v - center, axis=1).max())],
        np.float32)
    cam = ct.Camera.make(eye=eye, dir=center - eye, up=(0, 1, 0), fov=60.0,
                         device=dev)
    tf = turntable_transforms(ANIM_FRAMES, device=dev).frame(k)
    with full_fp32_matmul():
        cam_k = ct.Camera(eye=tf(cam.eye), dir=tf.a @ cam.dir, up=cam.up,
                          fov=cam.fov)
    sun_k = tf(torch.as_tensor(SUN, device=dev))
    vt, ft = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
    cs = cl.build_clusters_treelet(ct.triangle_soup(vt, ft,
                                                    with_normals=False))
    dirs = tuple(tiling.swizzle(camera_rays_rows(
        cam_k, ANIM_W, ANIM_H, 0, ANIM_H)).unbind(-1))
    check(hold_walks(17, vt, ft, cam_k, cs, ANIM_W, ANIM_H,
                     f"bunny anim frame {k}, treelet cut,", card, sun=sun_k,
                     dirs=dirs) == ["walk_closest", "walk_any_dest"],
          "phase 17: the anim frame is not walked by K1 and K2")
    config = ct.RenderConfig(width=ANIM_W, height=ANIM_H,
                             backend="megakernel")
    img, _ = ct.render_pipeline(vt, ft, cam_k, sun_k, config)
    ref = to_uint8(img.cpu().numpy())[::-1].astype(int)
    off = float((np.abs(u8[k].astype(int) - ref).max(-1) > 1).mean())
    print(f"phase 17 anim frame {k} against render_pipeline with its camera "
          f"and sun: pixels more than one level apart {off:.4%} (limit "
          f"0.5%)", flush=True)
    check(off < 0.005, "phase 17: the anim frame differs from "
          "render_pipeline's")

    scale = float(np.abs(v - center).max())
    noise = np.random.default_rng(17).standard_normal(v.shape)
    vf = np.stack([v, v + LARGE_NOISE * scale * noise]).astype(np.float32)
    opts = dict(width=ANIM_W, height=ANIM_H, backend="megakernel",
                device=dev)
    (refit, st), dlaunch = launches_of(lambda: render_deforming_frames(
        vf, f, cam, SUN, **opts))
    rebuilt, _ = render_deforming_frames(vf, f, cam, SUN, refit=False, **opts)
    fracs = [float(((refit[i] - rebuilt[i]).abs().amax(-1) > 1e-4)
                   .float().mean()) for i in range(2)]
    print(f"phase 17 render_deforming_frames, 2 bunny frames (seeded noise "
          f"{LARGE_NOISE} of the extent), refitted cut against rebuilt: "
          f"pixels off by >1e-4 {[f'{x:.4%}' for x in fracs]} (limit 0.5%); "
          f"launches {dlaunch}; rays {int(st['rays'])}", flush=True)
    check(max(fracs) < 0.005 and float(refit.max()) > 0,
          "phase 17: the refitted frames differ from the rebuilt ones")
    return merge(launches, dlaunch)


def cut_of(builder, soup):
    """(ClusterSet, PLOC tree or None, host build seconds, cut seconds) of
    ``builder`` on ``soup``, through the port's own builders. PLOC builds
    on the soup's device (synchronised)."""
    from ceres_tpu_torch.accel import cuts, ploc

    t0 = time.perf_counter()
    if builder == "ploc":
        tree = ploc.build_ploc(soup)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cs = cuts.clusters_from_ploc(soup, tree)
    else:
        tree = None
        bvh = cuts.build_flatbvh(soup, builder)
        t1 = time.perf_counter()
        cs = cuts.clusters_from_flatbvh(soup, bvh)
    torch.cuda.synchronize()
    return cs, tree, t1 - t0, time.perf_counter() - t1


def held_to_fixture(key, cs, tree, build_s, cut_s, want):
    """Phase 18 (b): one cut's fingerprint against the JAX-made one."""
    from ceres_tpu_torch.accel import cuts

    got = cuts.cut_record(cs, tree)
    extra = (f"; PLOC on the card: {tree.rounds} rounds, root {tree.root}"
             if tree is not None else "")
    print(f"phase 18 cut {key}: {got['num_clusters']} clusters, super_S "
          f"{got['super_S']}, {got['n_super_first']} supers; host build "
          f"{build_s:.3f} s, cut {cut_s:.3f} s{extra}; fingerprint == JAX "
          f"fixture: {got == want}", flush=True)
    check(got == want, f"phase 18: the {key} cut differs from the JAX "
          f"package's: {got} against {want}")


def phase18(dev, card, builds, meshes, large):
    """The quality builders: native toolchain, cuts held to the JAX
    package's, the walks on each cut, the large scenes' binned cuts and
    the render CLI with --builder."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel import golden_builders as gb
    from ceres_tpu_torch.accel import native as bvh_native
    from ceres_tpu_torch.accel.clusters import build_clusters_treelet
    from ceres_tpu_torch.io import native as obj_native
    from ceres_tpu_torch.io.obj import parse_obj
    from ceres_tpu_torch.ops import walk

    # (a) The native toolchain: both libraries built (phase 2) and used.
    check(bvh_native.available() and obj_native.available(),
          "phase 18: a native library is not available (no g++?)")
    with open(BUNNY) as fh:
        v_py, f_py = parse_obj(fh.read())
    v0, f0 = ct.load_obj(BUNNY)
    check(np.array_equal(v0, v_py) and np.array_equal(f0, f_py),
          "phase 18: the native OBJ parser differs from the Python one")
    print(f"phase 18 native toolchain: bvh_build.cpp built in "
          f"{builds['bvh_build.cpp'][1]:.2f} s, objparse.cpp in "
          f"{builds['objparse.cpp'][1]:.2f} s (g++, alongside nvcc); "
          f"load_obj took the native parser, equal to the Python parser",
          flush=True)
    with open(BUILDER_FIXTURE) as fh:
        want = json.load(fh)

    # (b) and (c): bunny and dragon, every builder, against the fixture,
    # then each cut's 1080p frame.
    launches_all = {}
    with open(os.path.join(ROOT, "benchmarks", "builder_ab.json")) as fh:
        ab = {(r["scene"], r["builder"]): r["mt_block_visits"]
              for r in json.load(fh)}
    sun = torch.as_tensor(SUN, device=dev)
    for name, builders in QUALITY.items():
        v, f = (v0, f0) if name == "bunny" else ct.load_obj(
            os.path.join(ROOT, "data", f"{name}.obj"))
        cam = camera(v, EYE if name == "bunny" else DRAGON_EYE, dev)
        vt, ft = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
        soup = ct.triangle_soup(vt, ft, with_normals=False)
        if name == "bunny":
            pts = v[f]
            lo, hi, centers = pts.min(1), pts.max(1), pts.mean(1)
            t0 = time.perf_counter()
            nat = bvh_native.build_binned_sah_native(lo, hi, centers)
            t1 = time.perf_counter()
            ref = gb.build_binned_sah(lo, hi, centers)
            t2 = time.perf_counter()
            same = nat.node_count == ref.node_count and all(
                np.array_equal(getattr(nat, k), getattr(ref, k))
                for k in ("bounds", "prim_count", "first_child",
                          "prim_indices"))
            print(f"phase 18 native binned == NumPy binned on the bunny, "
                  f"node for node: {same} ({nat.node_count} nodes; native "
                  f"{t1 - t0:.4f} s, NumPy {t2 - t1:.3f} s)", flush=True)
            check(same, "phase 18: native binned differs from NumPy binned")
        frames = {}
        cs_l = build_clusters_treelet(soup)

        def lbvh_frame(turn):
            launches, *_ = render_path(
                vt, ft, cam, cs_l, sun, f"phase 18 {name} lbvh cut, {turn} "
                f"({cs_l.num_clusters} blocks; builder_ab.json "
                f"mt_block_visits {ab[(name, 'lbvh')]}):", FRAMES, card)
            check(launches == K1_K2_ONCE, f"phase 18: the {name} lbvh "
                  f"frame launched {launches}, not K1 and K2 once")
            return launches

        launches_all = merge(launches_all, lbvh_frame("first"))
        hold_walks(18, vt, ft, cam, cs_l, W, H, f"{name}/lbvh cut", card,
                   reps=5)
        for builder in builders:
            key = f"{name}/{builder}"
            cs, tree, build_s, cut_s = cut_of(builder, soup)
            held_to_fixture(key, cs, tree, build_s, cut_s, want[key])
            launches, st, ms, img = render_path(
                vt, ft, cam, cs, sun, f"phase 18 {key} cut "
                f"({cs.num_clusters} blocks; builder_ab.json "
                f"mt_block_visits {ab[(name, builder)]}):", FRAMES, card)
            check(launches == K1_K2_ONCE, f"phase 18: the {key} frame "
                  f"launched {launches}, not K1 and K2 once")
            launches_all = merge(launches_all, launches)
            frames[builder] = (st, img)
            hold_walks(18, vt, ft, cam, cs, W, H, f"{key} cut", card,
                       reps=5)
            st0, img0 = frames["sweep"]
            off = float(((img - img0).abs().amax(-1) > 1e-4).double().mean())
            print(f"phase 18 {key} frame against the sweep cut's: primary "
                  f"hits {st['primary_hits']} / {st0['primary_hits']}, "
                  f"pixels off by >1e-4 {off:.4%} (limit 0.1%)", flush=True)
            check(st["primary_hits"] == st0["primary_hits"] and off <= 1e-3,
                  f"phase 18: the {key} frame differs from the sweep cut's")
        # The LBVH cut's frame again: the spread of a host-bound frame
        # within this process, beside which the cuts' frames are read.
        launches_all = merge(launches_all, lbvh_frame("last"))

    # (d) The large scenes on the binned cut: build and cut on the host,
    # the streamed (3x) and two-level (4x) walks held to their plain
    # versions, and the frame beside the LBVH cut's.
    for levels, names in LARGE.items():
        v, f = meshes[levels]
        vt, ft, cam, cs_l, _ = large[levels]
        soup = ct.triangle_soup(vt, ft, with_normals=False)
        key = f"bunny{levels}/binned"
        cs, _, build_s, cut_s = cut_of("binned", soup)
        held_to_fixture(key, cs, None, build_s, cut_s, want[key])
        label = (f"bunny x{levels} {W}x{H} binned cut ({f.shape[0]} "
                 f"triangles, {cs.num_clusters} blocks")
        for mode, (args, opts) in zip(("closest", "any_dest"),
                                      walk_inputs(vt, ft, cam, cs, W, H)):
            kname = walk._variant(mode, opts["S"], opts["stream"])
            check(kname in names and (opts["S"] == cs.super_S
                                      if levels == 4 else opts["S"] == 1),
                  f"{label}: walk {kname}, S {opts['S']}")
            r, _ = compare(mode, args, opts, reps=5)
            report(18, kname, f"{label}, S = {opts['S']}, "
                   f"{args[1].shape[1]} candidates per tile)", r, card)
        for cut, c in (("lbvh", cs_l), ("binned", cs)):
            launches, *_ = render_path(
                vt, ft, cam, c, sun, f"phase 18 large-scene frame, bunny "
                f"x{levels} {cut} cut ({c.num_clusters} blocks, S "
                f"{c.super_S}):", LARGE_FRAMES, card)
            check(set(launches) == set(names), f"phase 18: bunny x{levels} "
                  f"{cut} launched {launches}, not {names}")
            launches_all = merge(launches_all, launches)

    # (e) The render CLI with --builder binned and ploc.
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        cam = camera(v0, EYE, dev)
        soup = ct.triangle_soup(torch.as_tensor(v0, device=dev),
                                torch.as_tensor(f0, device=dev),
                                with_normals=False)
        config = ct.RenderConfig(width=W, height=H, backend="megakernel")
        for builder in ("binned", "ploc"):
            _, counts, launches = render_cli(
                tmp, f"cli_{builder}", ["--builder", builder, "--width",
                                        str(W), "--height", str(H)], dev)
            cs, *_ = cut_of(builder, soup)
            _, st = ct.render(v0, f0, cam, SUN, config=config, clusters=cs,
                              device=dev)
            want_counts = {"Rays": int(st["rays"]), "Hits": int(st["hits"])}
            print(f"phase 18 render CLI --builder {builder} {W}x{H}: "
                  f"launches {launches}; Rays/Hits {counts} (render() on "
                  f"the same cut: {want_counts})", flush=True)
            check(launches == K1_K2_ONCE and counts == want_counts,
                  f"phase 18: the CLI with --builder {builder} differs")
            launches_all = merge(launches_all, launches)
    return launches_all


@contextlib.contextmanager
def recorded_walks():
    """The walks a path launches, with their inputs and outputs: (wrapper
    name, args, opts, (out, visits)) in launch order. Inside a CUDA graph's
    capture the tensors recorded are the graph's own, which each replay
    overwrites."""
    from ceres_tpu_torch.ops import walk

    seen = []
    real = {name: getattr(walk, name) for name in set(WALKS.values())}

    def recorder(name, fn):
        def record(*args, **opts):
            out = fn(*args, **opts)
            seen.append((name, args, opts, out))
            return out
        return record

    for name, fn in real.items():
        setattr(walk, name, recorder(name, fn))
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(walk, name, fn)


def hold_recorded(phase, seen, label, card, reps=3):
    """Each recorded walk against its plain version on its own inputs;
    returns the variants' names."""
    from ceres_tpu_torch.ops import walk

    names = []
    for name, args, opts, _ in seen:
        mode = {"walk_closest": "closest", "walk_any_dest": "any_dest",
                "walk_any": "any"}[name]
        if opts.get("window"):
            mode = "closest_window"
        kname = walk._variant(mode, opts["S"], opts["stream"])
        r, _ = compare(mode, args, opts, reps=reps)
        report(phase, kname, f"{label} ({args[1].shape[0]} tiles, "
               f"{args[3].shape[0]} blocks, S = {opts['S']})", r, card)
        names.append(kname)
    return names


def step_problem(dev, v, f, mesh):
    """Config 4b's step over ``mesh``: (step(), the leaves): Adam (lr
    1e-5) over the vertices and the eye, ``image_loss`` against the frame
    at the sun, rendered through ``render_sharded`` with the sun moved
    1e-3, the cut built in the step."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.diff import TrainState, make_train_step
    from ceres_tpu_torch.parallel.sharded import render_sharded

    cam = camera(v, EYE, dev)
    config = ct.RenderConfig(width=W, height=H, backend="megakernel")
    ft = torch.as_tensor(f, device=dev)
    target, _ = render_sharded(v, f, cam, SUN, config, mesh=mesh)
    params = {"vertices": torch.tensor(v, device=dev, requires_grad=True),
              "eye": cam.eye.clone().requires_grad_()}
    step = make_train_step(ft, cam, torch.as_tensor(SUN, device=dev) + 1e-3,
                           config, torch.optim.Adam(params.values(),
                                                    lr=1e-5), mesh=mesh)
    state = [TrainState(params, {k: {} for k in params})]

    def one(i=0):
        state[0], loss = step(state[0], target)
        return loss

    return one, params


def masked_grads(dev, v, f, mesh, agree):
    """Phase 12's gradient check over ``mesh``: d/d(vertices, eye) of
    sum(w * image) at the moved sun, ``w`` seeded weights that leave out
    the pixels outside ``agree``."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.parallel.selfcheck import _grads

    weights = (np.random.default_rng(RANK_SEED).uniform(size=(H, W, 1))
               * agree[..., None]).astype(np.float32)
    g = _grads(torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev),
               camera(v, EYE, dev), torch.as_tensor(SUN, device=dev) + 1e-3,
               ct.RenderConfig(width=W, height=H, backend="megakernel"),
               mesh, weights)
    return {k: g[k].cpu() for k in ("vertices", "eye")}


def _ranks_phase19(card, v4, f4, one_moved):
    """One of phase 19's gloo ranks on the card: render_sharded, the
    primitive-sharded 4x bunny, the train step; what each launched, its
    results (images on rank 0) and its times."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.parallel import distributed
    from ceres_tpu_torch.parallel.sharded import (render_primitive_sharded,
                                                  render_sharded)

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = distributed.global_mesh()
    dev, rank = mesh.device, mesh.rank
    out = {}
    v, f = ct.load_obj(BUNNY)
    config = ct.RenderConfig(width=W, height=H, backend="megakernel")
    cam = camera(v, EYE, dev)
    sun = np.asarray(SUN, np.float32)

    with recorded_walks() as seen:
        (img, st), launches = launches_of(lambda: render_sharded(
            v, f, cam, SUN, config, mesh=mesh))
    held = hold_recorded(19, seen, f"rank {rank} of 2, bunny render_sharded "
                         f"rows {W}x{H // 2}", card)
    times, walls = frame_times(lambda i: render_sharded(
        v, f, cam, sun + i * 1e-3, config, mesh=mesh), RANK_FRAMES)
    out["sharded"] = {"launches": launches, "held": held, "times": times,
                      "walls": walls,
                      "stats": {k: int(x) for k, x in st.items()},
                      "image": img.cpu().numpy() if rank == 0 else None}

    cam4 = camera(v4, EYE, dev)
    with recorded_walks() as seen:
        (img, st), launches = launches_of(lambda: render_primitive_sharded(
            v4, f4, cam4, SUN, config, mesh=mesh))
    held = hold_recorded(19, seen, f"rank {rank} of 2, bunny x4 primitive "
                         f"shard {W}x{H}", card)
    times, walls = frame_times(lambda i: render_primitive_sharded(
        v4, f4, cam4, sun + i * 1e-3, config, mesh=mesh), 2)
    out["primitive"] = {"launches": launches, "held": held, "times": times,
                        "walls": walls,
                        "stats": {k: int(x) for k, x in st.items()},
                        "image": img.cpu().numpy() if rank == 0 else None}

    step, params = step_problem(dev, v, f, mesh)
    with recorded_walks() as seen:
        loss, launches = launches_of(step)
    held = hold_recorded(19, seen, f"rank {rank} of 2, config 4b train step "
                         f"rows {W}x{H // 2}", card)
    out["train"] = {"launches": launches, "held": held, "loss": float(loss),
                    **{f"grad_{k}": p.grad.cpu() for k, p in params.items()},
                    **{k: p.detach().cpu() for k, p in params.items()}}
    times, walls = frame_times(lambda i: step(), RANK_STEPS)
    out["train"].update(times=times, walls=walls)
    with torch.no_grad():
        moved, _ = render_sharded(v, f, cam, sun + 1e-3, config, mesh=mesh)
    agree = (np.abs(moved.cpu().numpy() - one_moved).max(-1)
             <= 1e-4)
    out["train"]["agree"] = agree
    out["train"]["masked"] = masked_grads(dev, v, f, mesh, agree)
    return out


def _nccl_rank():
    """A group of one rank on the NCCL backend: render_sharded's frame,
    its launches and the backend."""
    import ceres_tpu_torch as ct
    import torch.distributed as dist
    from ceres_tpu_torch.parallel import distributed
    from ceres_tpu_torch.parallel.sharded import render_sharded

    mesh = distributed.global_mesh()
    v, f = ct.load_obj(BUNNY)
    config = ct.RenderConfig(width=W, height=H, backend="megakernel")
    (img, st), launches = launches_of(lambda: render_sharded(
        v, f, camera(v, EYE, mesh.device), SUN, config, mesh=mesh))
    return {"backend": dist.get_backend(), "launches": launches,
            "group": mesh.group is not None,
            "stats": {k: int(x) for k, x in st.items()},
            "image": img.cpu().numpy()}


def levels_apart(a, b):
    """Pixels of two images whose 8-bit values differ by one level, and
    by more (utils.image.to_uint8's quantisation)."""
    from ceres_tpu_torch.utils.image import to_uint8

    d = np.abs(to_uint8(a).astype(int) - to_uint8(b).astype(int)).max(-1)
    return int((d == 1).sum()), int((d > 1).sum())


def phase19(dev, card, meshes):
    """Two gloo ranks on the one card, then one NCCL rank."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.parallel import distributed
    from ceres_tpu_torch.parallel.sharded import (Mesh,
                                                  render_primitive_sharded,
                                                  render_sharded)

    v, f = ct.load_obj(BUNNY)
    v4, f4 = meshes[4]
    config = ct.RenderConfig(width=W, height=H, backend="megakernel")
    sun = np.asarray(SUN, np.float32)
    one = Mesh(dev)
    # One rank on the card: the references and their times.
    cam = camera(v, EYE, dev)
    img1, st1 = render_sharded(v, f, cam, SUN, config, mesh=one)
    t1, w1 = frame_times(lambda i: render_sharded(
        v, f, cam, sun + i * 1e-3, config, mesh=one), RANK_FRAMES)
    cam4 = camera(v4, EYE, dev)
    (pimg1, pst1), plaunch1 = launches_of(lambda: render_primitive_sharded(
        v4, f4, cam4, SUN, config, mesh=one))
    pt1, pw1 = frame_times(lambda i: render_primitive_sharded(
        v4, f4, cam4, sun + i * 1e-3, config, mesh=one), 2)
    step, params = step_problem(dev, v, f, one)
    loss1 = float(step())
    grads1 = {k: p.grad.cpu() for k, p in params.items()}
    st_t1, st_w1 = frame_times(lambda i: step(), RANK_STEPS)
    with torch.no_grad():
        moved1, _ = render_sharded(v, f, cam, sun + 1e-3, config, mesh=one)
    moved1 = moved1.cpu().numpy()
    img1, pimg1 = img1.cpu().numpy(), pimg1.cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = distributed.run_ranks(_ranks_phase19, 2, card, v4, f4, moved1,
                                  device="cuda", timeout=600)
    spawn_s = time.perf_counter() - t0
    launches = {}
    for rank, r in enumerate(ranks):
        for part in ("sharded", "primitive", "train"):
            launches = merge(launches, r[part]["launches"])
            # Every walk the part launched was held to its plain version
            # on this rank's inputs.
            check(r[part]["launches"]
                  and set(r[part]["held"]) == set(r[part]["launches"]),
                  f"phase 19: rank {rank}'s {part} launched "
                  f"{r[part]['launches']}, held {r[part]['held']}")
        for part in ("sharded", "train"):
            check(r[part]["launches"].get("walk_closest", 0) > 0
                  and r[part]["launches"].get("walk_any_dest", 0) > 0,
                  f"phase 19: rank {rank}'s {part} launched "
                  f"{r[part]['launches']}, not K1 and K2")
    r0 = ranks[0]

    # render_sharded: one level at most after quantisation, counts equal.
    one_level, more = levels_apart(r0["sharded"]["image"], img1)
    st2 = r0["sharded"]["stats"]
    same = all(r["sharded"]["stats"] == st2 for r in ranks)
    want = {k: int(x) for k, x in st1.items()}
    ms1, ms2 = statistics.median(t1), statistics.median(r0["sharded"]["times"])
    print(f"phase 19 render_sharded, bunny {W}x{H} smooth+shadows, 2 gloo "
          f"ranks on the one card: launches by rank "
          f"{[r['sharded']['launches'] for r in ranks]}; against one rank: "
          f"{one_level} pixels one level apart, {more} more (limit 0); "
          f"rays/hits {st2['rays']}/{st2['hits']} (one rank "
          f"{want['rays']}/{want['hits']}); ms a frame, the treelet cut "
          f"built in each: one rank {ms1:.3f} (host wall "
          f"{statistics.median(w1):.3f}), two ranks {ms2:.3f} (host wall "
          f"{statistics.median(r0['sharded']['walls']):.3f}; ranks share the "
          f"card: no scaling figure) [{card}]", flush=True)
    check(more == 0 and same and st2["rays"] == want["rays"]
          and st2["hits"] == want["hits"],
          "phase 19: render_sharded over two ranks differs from one rank")

    # The primitive-sharded 4x bunny.
    pimg2, pst2 = r0["primitive"]["image"], r0["primitive"]["stats"]
    off = float((np.abs(pimg2 - pimg1).max(-1) > 2e-3).mean())
    pwant = {k: int(x) for k, x in pst1.items()}
    print(f"phase 19 render_primitive_sharded, bunny x4 ({f4.shape[0]} "
          f"triangles) {W}x{H}: variants by rank "
          f"{[r['primitive']['launches'] for r in ranks]} (one rank: "
          f"{plaunch1}); against one rank: pixels off by >2e-3 {off:.4%} "
          f"(limit 1%), primary hits {pst2['primary_hits']} (one rank "
          f"{pwant['primary_hits']}, limit 1% of pixels), rays/hits "
          f"{pst2['rays']}/{pst2['hits']}; ms a frame (its shard's cut "
          f"built in it): one rank {statistics.median(pt1):.3f} (host wall "
          f"{statistics.median(pw1):.3f}), two ranks "
          f"{statistics.median(r0['primitive']['times']):.3f} (host wall "
          f"{statistics.median(r0['primitive']['walls']):.3f}) [{card}]",
          flush=True)
    check(off <= 0.01 and abs(pst2["primary_hits"] - pwant["primary_hits"])
          <= 0.01 * W * H and all(r["primitive"]["stats"] == pst2
                                  for r in ranks),
          "phase 19: the primitive-sharded frame differs from one rank's")

    # The train step: loss and gradients against one rank's, parameters
    # bit-equal on both ranks.
    tr = [r["train"] for r in ranks]
    equal = all(torch.equal(tr[0][k], t[k]) for t in tr[1:]
                for k in ("vertices", "eye"))
    agree = tr[0]["agree"]
    masked1 = masked_grads(dev, v, f, one, agree)
    ok = abs(tr[0]["loss"] - loss1) <= 1e-4 * abs(loss1)
    lines = []
    for k in ("vertices", "eye"):
        got, ref = tr[0]["masked"][k].double(), masked1[k].double()
        scale = float(ref.abs().max())
        ok = ok and scale > 0 and bool(((got - ref).abs() <= 1e-5 * scale
                                        + 1e-4 * ref.abs()).all())
        step_err = float((tr[0][f"grad_{k}"].double()
                          - grads1[k].double()).abs().max())
        lines.append(f"d/d{k} max |g| {scale:.6e} max abs diff "
                     f"{float((got - ref).abs().max()):.3e}; the step's own "
                     f"d/d{k} max |g| {float(grads1[k].abs().max()):.6e}, "
                     f"max abs diff {step_err:.3e}")
    print(f"phase 19 config 4b train step over 2 ranks, bunny {W}x{H}, "
          f"d/d(vertices, eye), the cut built in the step: loss "
          f"{tr[0]['loss']:.9e} (one rank {loss1:.9e}); launches by rank "
          f"{[t['launches'] for t in tr]}; pixels left out "
          f"{int((~agree).sum())}; {'; '.join(lines)} (rule: rtol 1e-4, "
          f"atol 1e-5 max|g| on sum(w * image); the step's own loss, "
          f"(image - target)^2 with the sun moved 1e-3, weighs the last "
          f"bits of the shading, so its gradients are shown, not held); "
          f"parameters "
          f"bit-equal on both ranks: {equal}; ms a step: one rank "
          f"{statistics.median(st_t1):.3f} (host wall "
          f"{statistics.median(st_w1):.3f}), two ranks "
          f"{statistics.median(tr[0]['times']):.3f} (host wall "
          f"{statistics.median(tr[0]['walls']):.3f}); spawn to results "
          f"{spawn_s:.1f} s [{card}]", flush=True)
    check(ok and equal and (~agree).mean() <= 0.005,
          "phase 19: the train step over two ranks differs from one rank's")

    # One NCCL rank: the backend's path through render_sharded.
    (nc,) = distributed.run_ranks(_nccl_rank, 1, device="cuda", timeout=300)
    n_one, n_more = levels_apart(nc["image"], img1)
    print(f"phase 19 one NCCL rank, render_sharded bunny {W}x{H}: backend "
          f"{nc['backend']}, process group {nc['group']}, launches "
          f"{nc['launches']}; against one rank without a group: {n_one} "
          f"pixels one level apart, {n_more} more, rays/hits "
          f"{nc['stats']['rays']}/{nc['stats']['hits']}", flush=True)
    check(nc["backend"] == "nccl" and nc["group"] and n_more == 0
          and nc["stats"] == want and nc["launches"].get("walk_closest"),
          "phase 19: the NCCL rank's frame differs")
    return merge(launches, nc["launches"])


def large_scenes(dev, meshes):
    """Each large mesh on the card with its device treelet cut, built and
    timed: {levels: (vt, ft, cam, cs, build ms)}."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel.clusters import build_clusters_treelet

    large = {}
    for levels, (v, f) in meshes.items():
        vt, ft = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
        soup = ct.triangle_soup(vt, ft, with_normals=False)
        cs, build_ms = timed_once(lambda: build_clusters_treelet(soup))
        large[levels] = (vt, ft, camera(v, EYE, dev), cs, build_ms)
    return large


def bunny_meshes():
    """The 3x and 4x subdivided bunny: {levels: (vertices, faces)}."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.models.mesh import subdivide

    meshes = {3: subdivide(*ct.load_obj(BUNNY), 3)}
    meshes[4] = subdivide(*meshes[3], 1)
    return meshes


def regrouped_inputs(cs, sun, points, skip):
    """The regrouped shadow walk's (args, opts), as
    ``any_hit_to_point(regroup=True)`` builds them: the rays in the
    receivers' morton order, tiles of 128."""
    from ceres_tpu_torch.ops import megakernel as mk

    perm = mk._receiver_order(cs, points, skip)
    return mk._any_dest_inputs(cs, sun, tuple(c[perm] for c in points),
                               skip[perm], tile=mk._REGROUP_TILE)


# Phase 20's scenes and the variant each one's regrouped call launches.
REGROUPED = {"bunny": "walk_any_dest_t128", "dragon": "walk_any_dest_t128",
             3: "walk_any_dest_stream_t128",
             4: "walk_any_dest_hier_stream_t128"}
HEAVY_TILES = 5   # the regrouped tiles phase 20 describes


def tiles_in_order(args, opts, order):
    """A walk's (args, opts) with its tiles taken in ``order`` (a
    permutation of them): each tile's flags and visits move with it."""
    counts, keys, rays, w, occ0 = args
    width = rays.shape[1] // counts.numel()
    ids = (order[:, None] * width
           + torch.arange(width, device=order.device)).reshape(-1)
    moved = (counts[order].contiguous(), keys[order].contiguous(),
             rays[:, ids].contiguous(), w, occ0[ids].contiguous())
    if opts["S"] > 1:
        opts = dict(opts, hull=opts["hull"][order].contiguous())
    return moved, opts


def heaviest_tile(kname, name, args, opts, tiles_p, ms, reps, card):
    """Where a 128-ray kernel's time goes, from its heaviest tile ``t``
    (the plain walk's visits ``tiles_p``): the kernel on t alone (its own
    chain), on every tile but t, with t moved to the front of the grid,
    and with no candidates at all (the cost of the grid's CTAs)."""
    from ceres_tpu_torch.ops import walk

    counts = args[0]
    t = int(tiles_p.argmax())
    v = int(tiles_p[t])

    def timed(c, a=args, o=opts):
        return cuda_ms(lambda: walk.walk_any_dest(c, *a[1:], **o), reps)

    only = torch.zeros_like(counts)
    only[t] = counts[t]
    rest = counts.clone()
    rest[t] = 0
    idx = torch.arange(counts.numel(), device=counts.device)
    order = torch.cat([idx[t:t + 1], idx[:t], idx[t + 1:]])
    front, fopts = tiles_in_order(args, opts, order)
    alone, without = timed(only), timed(rest)
    first, empty = timed(front[0], front, fopts), timed(torch.zeros_like(
        counts))
    live = counts > 0
    print(f"phase 20 {kname} {name}: heaviest tile {t} of {counts.numel()} "
          f"({int(live[:t].sum())} of the {int(live.sum())} tiles with "
          f"candidates before it; {int((tiles_p > 0).sum())} tiles visit): "
          f"alone {alone:.4f} ms = {v} visits x {alone * 1e3 / v:.3f} us; "
          f"every other tile {without:.4f} ms; it first in the grid "
          f"{first:.4f} ms; no candidates at all {empty:.4f} ms; whole "
          f"kernel {ms:.4f} ms [{card}]", flush=True)


def heavy_tiles(cs, points, skip, out, tiles, n=HEAVY_TILES):
    """What the n heaviest regrouped tiles hold, from the plain walk's
    flags ``out`` and visits ``tiles``: one line each with its visits, its
    live rays and how many of them no block occludes, the first and last
    morton code of its live receivers with the highest bit in which they
    differ, and its receivers' bounding-box diagonal against the scene
    root's."""
    from ceres_tpu_torch.accel import morton
    from ceres_tpu_torch.ops import megakernel as mk
    from ceres_tpu_torch.ops import prepass

    perm = mk._receiver_order(cs, points, skip)
    pts = torch.stack([c[perm] for c in mk._cols(points)], dim=-1)
    lo, hi = prepass._scene_root(cs)
    code = morton.morton_codes(pts, lo, hi)
    live = ~skip[perm]
    lines = []
    for t in tiles.argsort(descending=True)[:n].tolist():
        rays = slice(t * mk._REGROUP_TILE, (t + 1) * mk._REGROUP_TILE)
        lv = live[rays]
        if not bool(lv.any()):
            continue
        c = code[rays][lv]
        first, last = int(c[0]), int(c[-1])
        p = pts[rays][lv]
        diag = float((p.amax(0) - p.amin(0)).norm())
        lines.append(
            f"tile {t}: {int(tiles[t])} visits, {int(lv.sum())} live rays, "
            f"{int((out[:pts.shape[0]][rays][lv] == 0).sum())} never "
            f"occluded; morton {first:#010x}..{last:#010x}, highest "
            f"differing bit {(first ^ last).bit_length() - 1}; receivers' "
            f"bbox diagonal {diag:.5f} = {diag / float((hi - lo).norm()):.4f}"
            f" of the root's")
    return lines


def phase20(dev, card, large):
    """The shadow wavefront regrouped by receiver at 1080p on the bunny
    and the 3x and 4x bunny, and on the dragon at 960 x 540. Returns the
    regrouped calls' launches and the 128-ray kernels' results on the
    forms the calls take (the bunny's for the resident flat form)."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.ops import megakernel as mk
    from ceres_tpu_torch.ops import walk

    scenes = {key: (*scene(key, dev), size)
              for key, size in (("bunny", (W, H)), ("dragon", (960, 540)))}
    scenes.update({levels: (*large[levels][:4], (W, H)) for levels in (3, 4)})
    path_launches, results = {}, {}
    for key, (vt, ft, cam, cs, (w, h)) in scenes.items():
        name = key if isinstance(key, str) else f"bunny x{key}"
        label = (f"{name} {w}x{h} ({ft.shape[0]} triangles, "
                 f"{cs.num_clusters} blocks")
        soup = ct.triangle_soup(vt, ft, with_normals=False)
        _, sun, points, skip = shadow_wavefront(vt, ft, cam, cs, w, h)

        def call(regroup):
            return mk.any_hit_to_point(soup, sun, points, skip=skip,
                                       clusters=cs, regroup=regroup,
                                       with_counts=True)

        (got, counts), launches = launches_of(lambda: call(True))
        (base, base_counts), base_launches = launches_of(lambda: call(False))
        check(launches == {REGROUPED[key]: 1},
              f"phase 20 {name}: the regrouped call launched {launches}")
        check(len(base_launches) == 1 and not any(
            k.endswith("_t128") for k in base_launches),
              f"phase 20 {name}: the unregrouped call launched "
              f"{base_launches}")
        path_launches = merge(path_launches, launches)
        off = int((got != base).sum())
        steps = int(counts["traversal_steps"])
        base_steps = int(base_counts["traversal_steps"])
        n = REGROUP_CALLS if isinstance(key, str) else LARGE_REGROUP_CALLS
        t_g, t_u = alternated_times([lambda i: call(True),
                                     lambda i: call(False)], n)
        print(f"phase 20 regrouped shadow wavefront, {label}): launches "
              f"regrouped {launches}, unregrouped {base_launches}; "
              f"{points[0].numel()} rays, {int((~skip).sum())} live, "
              f"{int(base.sum())} occluded, flags differing {off}; visits "
              f"regrouped {steps} x 128 = {steps * 128} lane-visits, "
              f"unregrouped {base_steps} x 512 = {base_steps * 512}; whole "
              f"call ms (CUDA events, {n} each, alternated) regrouped median "
              f"{statistics.median(t_g):.3f} (min {min(t_g):.3f} max "
              f"{max(t_g):.3f}), unregrouped median "
              f"{statistics.median(t_u):.3f} (min {min(t_u):.3f} max "
              f"{max(t_u):.3f}) [{card}]", flush=True)
        check(off == 0 and int(base.sum()) > 0,
              f"phase 20 {name}: regrouped flags differ on {off} rays")
        reps = 20 if isinstance(key, str) else 5
        for tile, (args, opts) in (
                (128, regrouped_inputs(cs, sun, points, skip)),
                (512, mk._any_dest_inputs(cs, sun, points, skip))):
            forms = ((opts["stream"], not opts["stream"])
                     if opts["S"] > 1 and tile == 128 else (opts["stream"],))
            plain_ref = None
            for stream in forms:
                kname = walk._variant("any_dest", opts["S"], stream, tile)
                r, plain_ref = compare("any_dest", args,
                                       dict(opts, stream=stream), reps,
                                       plain_ref)
                report(20, kname, f"{label}, "
                       f"{'regrouped' if tile == 128 else 'screen'} tiles: "
                       f"{args[0].numel()} of {tile} rays, {r['steps']} "
                       f"visits = {r['steps'] * tile} lane-visits, S = "
                       f"{opts['S']})", r, card)
                if tile == 128 and stream == opts["stream"]:
                    check(kname == REGROUPED[key],
                          f"phase 20 {name}: regrouped inputs walk {kname}")
                    results.setdefault(kname, r)   # the bunny's
                if tile == 128:
                    heaviest_tile(kname, name, args,
                                  dict(opts, stream=stream), plain_ref[1],
                                  r["ms"], reps, card)
            if tile == 128:
                for line in heavy_tiles(cs, points, skip, plain_ref[0],
                                        plain_ref[1]):
                    print(f"phase 20 heavy regrouped tile, {name}: {line}",
                          flush=True)
    return path_launches, results


def phase21(dev, card):
    """The golden oracle on the card's host (no JAX): the bunny preset
    rendered on the card, held to ``render_golden``. Returns the renders'
    launches."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.render import scenes
    from ceres_tpu_torch.utils import golden

    sc = scenes.bunny_scene()
    n = GOLDEN_SIZE
    launches = {}
    for mode in ("smooth", "flat"):
        t0 = time.perf_counter()
        gold, gst = golden.render_golden(
            sc.vertices, sc.faces, *(np.asarray(x, np.float64) for x in (
                sc.camera.eye, sc.camera.dir, sc.camera.up)),
            float(sc.camera.fov), np.asarray(sc.sun, np.float64), n, n,
            mode=mode)
        host_s = time.perf_counter() - t0
        for backend in ("megakernel", "bruteforce"):
            (img, st), launched = launches_of(lambda: ct.render(
                sc.vertices, sc.faces, sc.camera, sc.sun, width=n, height=n,
                mode=mode, backend=backend, device=dev))
            want = ({"walk_closest": 1, "walk_any_dest": 1}
                    if backend == "megakernel" else {})
            check(launched == want,
                  f"phase 21 {mode} {backend}: launches {launched}")
            launches = merge(launches, launched)
            check(img.device.type == dev.type and tuple(img.shape) == (n, n, 3)
                  and bool(torch.isfinite(img).all()),
                  f"phase 21 {mode} {backend}: not a finite image on the card")
            bad = float((np.abs(img.cpu().numpy() - gold).max(axis=-1)
                         > 2e-3).mean())
            hits = int(st["primary_hits"])
            print(f"phase 21 golden oracle: bunny preset {n}x{n} {mode} "
                  f"{backend} on the card against render_golden (NumPy "
                  f"float64 on the host, {host_s:.1f} s): pixels off by "
                  f">2e-3 {bad:.4%} (limit 1%); primary hits {hits}, oracle "
                  f"{gst['hits']} (limit {0.01 * n * n:.0f} apart); "
                  f"launches {launched} [{card}]", flush=True)
            check(bad <= 0.01 and abs(hits - gst["hits"]) <= 0.01 * n * n
                  and gold.max() > 0.1 and float(img.max()) > 0.1,
                  f"phase 21 {mode} {backend}: the card's render differs "
                  f"from the golden oracle")
    jax_like = [m for m in sys.modules
                if m.split(".")[0] in ("jax", "ceres_tpu")]
    check(not jax_like, f"phase 21: JAX or the JAX package loaded: "
          f"{jax_like[:5]}")
    return launches


def deformed(vt, i):
    """The vertices of frame i of a deforming scene: ``vt`` moved by
    seeded noise, LARGE_NOISE of the mesh's extent (as phase 14)."""
    gen = torch.Generator(device=vt.device).manual_seed(DEFORM_SEED + i)
    scale = float((vt - vt.mean(0)).abs().max())
    return vt + LARGE_NOISE * scale * torch.randn(
        vt.shape, generator=gen, device=vt.device, dtype=vt.dtype)


def graph_frame(label, vt, ft, cam, cs, config, frames, card, phase=22):
    """A frame captured by ``render_graph`` against ``render_pipeline``.
    With ``cs``, a static scene's frame on that cut and its winner table,
    the sun moved 1e-3 a frame; with ``cs`` None, a deforming scene's:
    the graph builds the treelet cut and the winner table, and frame i
    moves the vertices (``deformed``), as does the eager frame, which
    builds its cut too. Held (one frame of a static scene, every frame
    of a deforming one): the path's run (the counts set to 0 just before
    the first held replay and read just after: one launch a variant),
    stats equal, images within one level, each graph-launched walk's ids
    or flags and visits equal to the eager frame's same launch, and on
    the first also to a relaunch on the graph's own inputs; then
    ``frames`` of each alternated (CUDA events) and back to back (host
    clock). Returns the path's launches."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel import lbvh
    from ceres_tpu_torch.ops import walk
    from ceres_tpu_torch.render.renderer import (prepare_winner_table,
                                                 render_graph)
    from ceres_tpu_torch.utils.graphs import tensors

    sun = torch.as_tensor(SUN, device=vt.device)
    # A frame that builds its cut launches each LBVH kernel once.
    builds = {"hierarchy": int(cs is None), "boxes": int(cs is None)}
    if cs is None:
        table, held = None, range(frames)
        moved = [deformed(vt, i) for i in range(frames)]

        def graph(i):
            return fg(vertices=moved[i % frames])

        def eager(i):
            return ct.render_pipeline(moved[i % frames], ft, cam, sun, config)
    else:
        table, held = prepare_winner_table(ct.triangle_soup(vt, ft), cs,
                                           config), (1,)

        def graph(i):
            return fg(sun_position=sun + i * 1e-3)

        def eager(i):
            return ct.render_pipeline(vt, ft, cam, sun + i * 1e-3, config,
                                      clusters=cs, table_cols=table)

    with recorded_walks() as seen:
        fg = render_graph(vt, ft, cam, sun, config, cs, table)
    captured = seen[len(seen) - sum(fg.launches.values()):]
    visits, inputs_equal, one = 0, True, 0
    for k, i in enumerate(held):
        walk.reset_launches()
        lbvh.reset_launches()
        image, stats = graph(i)
        torch.cuda.synchronize()
        launched = {n: c for n, c in walk.launches.items() if c}
        check(lbvh.launches == builds, f"phase {phase} {label} frame {i}: "
              f"a replay launched the LBVH kernels {lbvh.launches}")
        image, stats = image.clone(), {n: int(x) for n, x in stats.items()}
        with recorded_walks() as eager_seen:
            (img_e, st_e), eager_launches = launches_of(lambda: eager(i))
        st_e = {n: int(x) for n, x in st_e.items()}
        check(launched == fg.launches == eager_launches
              and set(launched.values()) == {1},
              f"phase {phase} {label} frame {i}: a replay launched "
              f"{launched}, the capture {fg.launches}, the eager frame "
              f"{eager_launches}")
        check(stats == st_e, f"phase {phase} {label} frame {i}: stats "
              f"{stats}, eager {st_e}")
        apart, more = levels_apart(image.cpu(), img_e.cpu())
        check(more == 0 and bool(torch.isfinite(image).all())
              and float(image.max()) > 0,
              f"phase {phase} {label} frame {i}: {more} pixels more than "
              f"one level from the eager frame's")
        one = max(one, apart)
        if k == 0:
            launches = launched
        for (name, args, opts, (out, vis)), (e_name, e_args, e_opts,
                                             (e_out, e_vis)) in zip(
                                                 captured, eager_seen):
            same_in = name == e_name and all(
                torch.equal(a, b) for a, b in zip(tensors((args, opts)),
                                                  tensors((e_args, e_opts))))
            inputs_equal &= same_in
            check(torch.equal(out, e_out) and torch.equal(vis, e_vis),
                  f"phase {phase} {label} frame {i}: the graph's {name} "
                  f"differs from the eager frame's (inputs equal: "
                  f"{same_in})")
            if k == 0:
                r_out, r_vis = getattr(walk, name)(*args, **opts)
                check(torch.equal(r_out, out) and torch.equal(r_vis, vis),
                      f"phase {phase} {label}: the graph's {name} differs "
                      f"from a launch on its own inputs")
                visits += int(vis.sum())

    e_t, g_t = alternated_times((eager, graph), frames)
    walls = {}
    for name, fn in (("eager", eager), ("graph", graph)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(frames):
            fn(i)
        torch.cuda.synchronize()
        walls[name] = frames / (time.perf_counter() - t0)
    e_ms, g_ms = statistics.median(e_t), statistics.median(g_t)
    what = ("the cut and winner table built in each frame, the vertices "
            f"moved by seeded noise; {len(held)} frames held"
            if cs is None else "the sun moved")
    print(f"phase {phase} {label} {config.width}x{config.height} ({what}): "
          f"launches a replay {launches}, LBVH kernels {builds}; rays {stats['rays']} hits "
          f"{stats['hits']} shadow_hits {stats['shadow_hits']} executed "
          f"visits {visits}, equal to eager (walk inputs equal: "
          f"{inputs_equal}); pixels one level apart {one}; ms/frame eager "
          f"median {e_ms:.3f} (min {min(e_t):.3f} max {max(e_t):.3f}), "
          f"graph median {g_ms:.3f} (min {min(g_t):.3f} max "
          f"{max(g_t):.3f}), CUDA events, {frames} of each alternated; "
          f"rays/s eager {stats['rays'] / e_ms * 1e3:.4e}, graph "
          f"{stats['rays'] / g_ms * 1e3:.4e}; host clock, {frames} frames "
          f"back to back: eager {walls['eager']:.2f} frames/s, graph "
          f"{walls['graph']:.2f} frames/s [{card}]", flush=True)
    return launches


def graph_matrix(vt, ft, cam, cs, card):
    """Every frame config captured at MATRIX_SIZE on the bunny: default
    and reference-exact, smooth, flat and normal, shadows on and off,
    with the traversal counters; each replay against the eager frame
    (stats equal, images within one level, the same launches). Returns
    the replays' launches."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.ops import walk
    from ceres_tpu_torch.render.renderer import (MODES, prepare_winner_table,
                                                 render_graph)

    sun = torch.as_tensor(SUN, device=vt.device)
    launches, worst, n = {}, 0, 0
    for compat in (False, True):
        for mode in MODES:
            for shadows in (True, False):
                config = ct.RenderConfig(
                    width=MATRIX_SIZE, height=MATRIX_SIZE, mode=mode,
                    backend="megakernel", shadows=shadows,
                    traversal_stats=True, reference_compat=compat)
                label = (f"phase 22 {mode} shadows={shadows} "
                         f"reference_compat={compat}")
                table = prepare_winner_table(ct.triangle_soup(vt, ft), cs,
                                             config)
                fg = render_graph(vt, ft, cam, sun, config, cs, table)
                walk.reset_launches()
                img, st = fg(sun_position=sun + 1e-3)
                torch.cuda.synchronize()
                launched = {k: c for k, c in walk.launches.items() if c}
                (img_e, st_e), eager_l = launches_of(
                    lambda: ct.render_pipeline(vt, ft, cam, sun + 1e-3,
                                               config, clusters=cs,
                                               table_cols=table))
                one, more = levels_apart(img.cpu(), img_e.cpu())
                check(launched == eager_l and more == 0
                      and {k: int(x) for k, x in st.items()}
                      == {k: int(x) for k, x in st_e.items()},
                      f"{label}: the replay differs from the eager frame "
                      f"(launches {launched} / {eager_l}, {more} pixels "
                      f"off by more than a level)")
                launches = merge(launches, launched)
                worst, n = max(worst, one), n + 1
    print(f"phase 22 config matrix, bunny {MATRIX_SIZE}x{MATRIX_SIZE}: {n} "
          f"configs captured and replayed, each equal to its eager frame "
          f"(stats with visits exact, at most {worst} pixels one level "
          f"apart); launches {launches} [{card}]", flush=True)
    return launches


def refit_steps(vt, ft, cam, cs0, eye):
    """A train step at 1080p as ``make_train_step`` captures it on the
    card and as ``inverse._make_eager_step`` runs it, each with its own
    capturable Adam (lr 1e-5) over the same start: the vertices moved by
    seeded noise (LARGE_NOISE of the mesh's extent, as phase 14), and
    the eye with ``eye`` (config 4b); ``image_loss`` against the unmoved
    mesh's frame, ``cs0`` (the unmoved mesh's cut) refitted in the step,
    or with ``cs0`` None the cut built in the step: ({"eager": (one(i),
    state), "graph": ...}, the target), ``state`` a one-item list
    holding the step's current TrainState."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.diff import TrainState, inverse

    sun = torch.as_tensor(SUN, device=vt.device)
    config = ct.RenderConfig(width=W, height=H, backend="megakernel")
    target, _ = ct.render_pipeline(vt, ft, cam, sun, config, clusters=cs0)
    scale = float((vt - vt.mean(0)).abs().max())
    noise = np.random.default_rng(22).standard_normal(tuple(vt.shape))
    start = vt + torch.as_tensor(LARGE_NOISE * scale * noise,
                                 dtype=vt.dtype, device=vt.device)
    steps = {}
    for name, make in (("eager", inverse._make_eager_step),
                       ("graph", inverse.make_train_step)):
        params = {"vertices": start.clone().requires_grad_()}
        if eye:
            params["eye"] = cam.eye.detach().clone().requires_grad_()
        opt = torch.optim.Adam(params.values(), lr=1e-5, capturable=True)
        step = make(ft, cam, sun, config, opt, clusters0=cs0)
        state = [TrainState(params, {k: {} for k in params})]

        def one(i=0, step=step, state=state):
            state[0], loss = step(state[0], target)
            return loss

        steps[name] = (one, state)
    return steps, target


def within(got, want):
    """Phase 12's rule: |got - want| <= 1e-5 max|want| + 1e-4 |want|."""
    want, got = torch.as_tensor(want).double(), torch.as_tensor(got).double()
    tol = 1e-5 * float(want.abs().max()) + 1e-4 * want.abs()
    return bool(((got - want).abs() <= tol).all())


def graph_step(label, vt, ft, cam, cs0, eye, times, want, card, phase=22,
               ratio=False):
    """``refit_steps``' captured step against its eager one over
    GRAPH_STEPS steps, each taken by both from the eager step's state
    (parameters and Adam's; the captured step's first call is its
    capture): loss, gradients and the parameters after the step under
    phase 12's rule. Chained runs are not compared: a silhouette pixel
    that one run's last bits flip moves the loss and the next steps'
    gradients. Then peak memory of a few steps of each, the path's run
    (one replay with the counts set to 0 just before it: one launch of
    each of ``want``) and ``times`` steps of each alternated; with
    ``ratio`` also the same loss's forward under ``torch.no_grad()``,
    eager and captured, alternated with them, and bwd/fwd of each
    (``ratio_line``). Returns the replay's launches."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.diff import TrainState, inverse
    from ceres_tpu_torch.ops import walk
    from ceres_tpu_torch.utils.graphs import capture

    dev = vt.device
    steps, target = refit_steps(vt, ft, cam, cs0, eye)
    (eager, e_state), (graph, g_state) = steps["eager"], steps["graph"]
    worst = {}
    for i in range(GRAPH_STEPS):
        params = {k: x.detach().clone() for k, x in e_state[0].params.items()}
        opt = {k: {kk: x.clone() for kk, x in st.items()}
               for k, st in e_state[0].opt_state.items()}
        got = {}
        for name, one, state in (("eager", eager, e_state),
                                 ("graph", graph, g_state)):
            if name == "graph":
                with torch.no_grad():
                    for k, x in state[0].params.items():
                        x.copy_(params[k])
                state[0] = TrainState(state[0].params, opt)
            loss = float(one(i))
            got[name] = (loss, {k: x.grad.detach().clone()
                                for k, x in state[0].params.items()},
                         {k: x.detach().clone()
                          for k, x in state[0].params.items()})
        (le, ge, pe), (lg, gg, pg) = got["eager"], got["graph"]
        check(np.isfinite(lg) and within(lg, le),
              f"phase {phase} {label} step {i + 1}: loss {lg}, eager {le}")
        for k in pe:
            for what, a, b in (("gradient", gg[k], ge[k]),
                               ("parameters", pg[k], pe[k])):
                diff = float((a - b).abs().max())
                worst[k, what] = max(worst.get((k, what), 0.0), diff)
                check(within(a, b), f"phase {phase} {label} step {i + 1}: the "
                      f"{what} of {k} outside phase 12's rule (max diff "
                      f"{diff:.3e}, max |eager| "
                      f"{float(b.abs().max()):.3e})")
    peaks = {}
    for name, one, _ in (("eager", eager, None), ("graph", graph, None)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(GRAPH_STEPS):
            one(i)
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() / 2**20,
                       torch.cuda.max_memory_reserved() / 2**20)
    walk.reset_launches()
    graph()
    torch.cuda.synchronize()
    launches = {k: n for k, n in walk.launches.items() if n}
    check(launches == {k: 1 for k in want},
          f"phase {phase} {label}: a replayed step launched {launches}")
    fns = [eager, graph]
    if ratio:
        config = ct.RenderConfig(width=W, height=H, backend="megakernel")
        loss = inverse._loss_fn(ft, cam, torch.as_tensor(SUN, device=dev),
                                config, None, cs0)

        def forward(state):
            with torch.no_grad():
                return loss(state[0].params, target)

        fwd_graph = capture(lambda: forward(g_state), g_state[0].params)
        fns += [lambda i: forward(e_state), lambda i: fwd_graph.replay()]
    e_t, g_t, *fwd_t = alternated_times(fns, times)
    diffs = ", ".join(f"{what} of {k} {d:.3e}"
                      for (k, what), d in worst.items())
    ratios = ""
    if ratio:
        ratios = (f"; forward (no_grad) median eager "
                  f"{statistics.median(fwd_t[0]):.3f}, graph "
                  f"{statistics.median(fwd_t[1]):.3f} ms; eager "
                  f"{ratio_line(e_t, fwd_t[0])}; graph "
                  f"{ratio_line(g_t, fwd_t[1])}")
    cut = "refitted" if cs0 is not None else "rebuilt"
    print(f"phase {phase} {label} {cut} train step {W}x{H}, Adam lr 1e-5 "
          f"over {'the vertices and the eye' if eye else 'the vertices'}: "
          f"{GRAPH_STEPS} steps each from the eager step's state, loss, "
          f"gradients and parameters within phase 12's rule (max diffs "
          f"{diffs}; last loss {le:.6e}, graph {lg:.6e}); launches a "
          f"replay {launches}; ms/step eager median "
          f"{statistics.median(e_t):.3f} (min {min(e_t):.3f} max "
          f"{max(e_t):.3f}), graph median {statistics.median(g_t):.3f} (min "
          f"{min(g_t):.3f} max {max(g_t):.3f}), CUDA events, {times} of "
          f"each alternated{ratios}; peak memory allocated/reserved over "
          f"{GRAPH_STEPS} steps eager {peaks['eager'][0]:.1f}/"
          f"{peaks['eager'][1]:.1f} MiB, graph {peaks['graph'][0]:.1f}/"
          f"{peaks['graph'][1]:.1f} MiB (the capture's pool reserved) "
          f"[{card}]", flush=True)
    return launches


def phase22(dev, card, large):
    """CUDA graphs of the frame and the refitted train step, each against
    its eager run. Returns the replays' launches."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel.clusters import build_clusters_treelet

    vt, ft, cam, cs = scene("bunny", dev)
    base = ct.RenderConfig(width=W, height=H, backend="megakernel")
    compat = dataclasses.replace(base, reference_compat=True)
    cases = [("bunny", (vt, ft, cam, cs), base, GRAPH_FRAMES),
             ("reference-exact bunny", (vt, ft, cam, cs), compat,
              GRAPH_LARGE_FRAMES),
             ("bunny x3", large[3][:4], base, GRAPH_LARGE_FRAMES),
             ("bunny x4", large[4][:4], base, GRAPH_LARGE_FRAMES),
             ("reference-exact bunny x4", large[4][:4], compat,
              GRAPH_STEPS)]
    wants = [("walk_closest", "walk_any_dest"), ("walk_closest", "walk_any"),
             LARGE[3], LARGE[4],
             ("walk_closest_hier_stream", "walk_any_hier_stream")]
    launches = {}
    for (label, sc, config, frames), want in zip(cases, wants):
        launched = graph_frame(label, *sc, config, frames, card)
        check(set(launched) == set(want),
              f"phase 22 {label}: launched {launched}, not {want}")
        launches = merge(launches, launched)
        torch.cuda.empty_cache()
    launches = merge(launches, graph_matrix(vt, ft, cam, cs, card))

    cs0 = build_clusters_treelet(ct.triangle_soup(vt, ft, with_normals=False))
    launches = merge(launches, graph_step(
        "config 4b, bunny", vt, ft, cam, cs0, True, GRAPH_STEP_TIMES,
        ("walk_closest", "walk_any_dest"), card))
    launches = merge(launches, graph_step(
        "bunny x4", *large[4][:4], False, LARGE_STEPS, LARGE[4], card))
    torch.cuda.empty_cache()
    return launches


def same_bits(a, b):
    """Equal tensors of one dtype, floats compared as bit patterns (the
    sign of a zero included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = torch.int32 if a.dtype == torch.float32 else torch.int64
        return torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


def lbvh_kernels(label, vt, ft, card, reps=LBVH_REPS):
    """The LBVH kernels (``accel/csrc/lbvh.cu``) against the plain
    version run on the same card tensors: every ``Lbvh`` array bit-equal
    and one launch of each kernel a build; then each kernel's CUDA-event
    ms (mean of ``reps`` launches) beside its bound, bytes over
    PEAK_BYTES (each input read once and each output written once), and
    the ms of the plain version's part that it replaces."""
    import dataclasses

    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel import lbvh

    soup = ct.triangle_soup(vt, ft, with_normals=False)
    before = dict(lbvh.launches)
    got = lbvh.build_lbvh(soup)
    rose = {k: n - before[k] for k, n in lbvh.launches.items()}
    want = lbvh._build_lbvh_plain(soup)
    torch.cuda.synchronize()
    fields = [f.name for f in dataclasses.fields(got)]
    differ = [f for f in fields
              if not same_bits(getattr(got, f), getattr(want, f))]
    check(not differ, f"phase 23 {label}: the LBVH kernels' {differ} differ "
          f"from the plain version's")
    check(rose == {"hierarchy": 1, "boxes": 1},
          f"phase 23 {label}: a build launched {rose}")
    keys, order = lbvh._sorted_keys(soup)
    corners = lbvh._corners(soup)
    topo = (got.left, got.right, got.parent, got.leaf_parent)
    T = keys.shape[0]
    size = corners[0].element_size()
    times = {
        "hierarchy": (cuda_ms(lambda: lbvh._hierarchy_card(keys), reps),
                      cuda_ms(lambda: lbvh._hierarchy_plain(keys), reps),
                      8 * T + 4 * (5 * (T - 1) + T)),
        "boxes": (cuda_ms(lambda: lbvh._boxes_card(got.order, *topo,
                                                    *corners), reps),
                  cuda_ms(lambda: lbvh._boxes_plain(order, got.left,
                                                    got.right, *corners),
                          reps),
                  # order, topology, arrivals (zeroed, counted), corners;
                  # leaf and node boxes written
                  4 * T + 4 * (3 * (T - 1) + T) + 4 * (T - 1)
                  + 9 * size * T + 6 * size * (2 * T - 1))}
    parts = []
    for name, (ms, plain_ms, nbytes) in times.items():
        bound = nbytes / PEAK_BYTES * 1e3
        parts.append(f"{name} {ms:.4f} ms (bound {bound:.4f} ms by bytes, "
                     f"{100 * bound / ms:.1f}%; plain {plain_ms:.3f} ms)")
    print(f"phase 23 lbvh kernels {label} ({T} triangles, "
          f"{corners[0].dtype}): {len(fields)} arrays bit-equal to the "
          f"plain version's, one launch of each a build; "
          f"{'; '.join(parts)}; CUDA events, mean of {reps} [{card}]",
          flush=True)


def graph_build(label, vt, ft, times, card):
    """The LBVH and the treelet cut (``lbvh.build_lbvh``,
    ``build_clusters_treelet``) each captured as a CUDA graph on the
    mesh and replayed on its vertices moved by seeded noise
    (``deformed``): every array bit-equal to an eager build of the moved
    vertices; the treelet cut captured again with the LBVH's plain
    version (``lbvh._build_lbvh_plain``, the build before the kernels),
    bit-equal to the kernels' graph; then ``times`` treelet builds of
    each, eager, plain graph and kernel graph, alternated (CUDA
    events)."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel import lbvh
    from ceres_tpu_torch.accel.clusters import build_clusters_treelet
    from ceres_tpu_torch.utils.graphs import capture, tensors

    buf = vt.clone()
    builds = {"build_lbvh": lbvh.build_lbvh,
              "build_clusters_treelet": build_clusters_treelet}
    graphs = {name: capture(lambda fn=fn: fn(ct.triangle_soup(
        buf, ft, with_normals=False)), (buf,)) for name, fn in builds.items()}
    kernel_build = lbvh.build_lbvh
    lbvh.build_lbvh = lbvh._build_lbvh_plain
    try:
        plain_graph = capture(lambda: build_clusters_treelet(
            ct.triangle_soup(buf, ft, with_normals=False)), (buf,))
    finally:
        lbvh.build_lbvh = kernel_build
    moved = deformed(vt, 0)
    buf.copy_(moved)
    arrays = 0
    for name, fn in builds.items():
        got = graphs[name].replay()
        want = fn(ct.triangle_soup(moved, ft, with_normals=False))
        torch.cuda.synchronize()
        pairs = list(zip(tensors(got), tensors(want)))
        check(len(tensors(got)) == len(tensors(want)) and all(
            same_bits(a, b) for a, b in pairs),
              f"phase 23 {label}: the captured {name} differs from the "
              f"eager one")
        arrays += len(pairs)
    cs = got
    plain = plain_graph.replay()
    torch.cuda.synchronize()
    check(all(same_bits(a, b) for a, b in zip(tensors(plain), tensors(cs))),
          f"phase 23 {label}: the treelet build's graph through the plain "
          f"LBVH differs from the kernels'")
    launched = plain_graph.counts.get("lbvh.launches", {})
    check(not any(launched.values()),
          f"phase 23 {label}: the plain graph launched {launched}")

    def eager(i):
        return build_clusters_treelet(ct.triangle_soup(buf, ft,
                                                       with_normals=False))

    e_t, p_t, g_t = alternated_times(
        (eager, lambda i: plain_graph.replay(),
         lambda i: graphs["build_clusters_treelet"].replay()), times)
    print(f"phase 23 build {label} ({ft.shape[0]} triangles, "
          f"{cs.num_clusters} blocks, S {cs.super_S}): build_lbvh and "
          f"build_clusters_treelet replayed on moved vertices, {arrays} "
          f"arrays bit-equal to the eager build's, the plain LBVH's graph "
          f"bit-equal; treelet build ms eager "
          f"median {statistics.median(e_t):.3f} (min {min(e_t):.3f} max "
          f"{max(e_t):.3f}), plain graph median {statistics.median(p_t):.3f} "
          f"(min {min(p_t):.3f} max {max(p_t):.3f}), graph median "
          f"{statistics.median(g_t):.3f} (min {min(g_t):.3f} max "
          f"{max(g_t):.3f}), CUDA events, {times} of each alternated "
          f"[{card}]", flush=True)


def phase23(dev, card, large):
    """The LBVH treelet build inside CUDA graphs, each against its eager
    run: the build alone, the frame of a deforming scene that builds its
    cut (``render_graph`` without a prebuilt cut), and the rebuilt train
    steps (``make_train_step`` without ``clusters0``). Returns the
    paths' launches."""
    import ceres_tpu_torch as ct

    v, f = ct.load_obj(BUNNY)
    vt, ft = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
    dv, df = ct.load_obj(os.path.join(ROOT, "data", "dragon.obj"))
    for label, mesh in (("bunny", (vt, ft)),
                        ("dragon", (torch.as_tensor(dv, device=dev),
                                    torch.as_tensor(df, device=dev))),
                        ("bunny x4", large[4][:2])):
        lbvh_kernels(label, *mesh, card)
        graph_build(label, *mesh, BUILD_TIMES, card)
        torch.cuda.empty_cache()
    cam = camera(v, EYE, dev)
    config = ct.RenderConfig(width=W, height=H, backend="megakernel")
    launches = {}
    for label, sc, frames, want in (
            ("deforming bunny", (vt, ft, cam), DEFORM_FRAMES,
             ("walk_closest", "walk_any_dest")),
            ("deforming bunny x4", large[4][:3], DEFORM_LARGE_FRAMES,
             LARGE[4])):
        launched = graph_frame(label, *sc, None, config, frames, card,
                               phase=23)
        check(set(launched) == set(want),
              f"phase 23 {label}: launched {launched}, not {want}")
        launches = merge(launches, launched)
        torch.cuda.empty_cache()
    launches = merge(launches, graph_step(
        "config 4b, bunny", vt, ft, cam, None, True, REBUILT_STEP_TIMES,
        ("walk_closest", "walk_any_dest"), card, phase=23, ratio=True))
    torch.cuda.empty_cache()
    launches = merge(launches, graph_step(
        "bunny x4", *large[4][:3], None, False, LARGE_STEPS, LARGE[4], card,
        phase=23))
    torch.cuda.empty_cache()
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", help="run phases 1, 2 and these only "
                    "(comma-separated, of 16, 20, 21, 22 and 23), with no "
                    "JSON record")
    only = ap.parse_args(argv).phases
    only = [int(x) for x in only.split(",")] if only else None
    check(only is None or set(only) <= {16, 20, 21, 22, 23},
          f"--phases takes 16, 20, 21, 22 and 23, not {only}")
    # Phase 1: device.
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port's smoke test "
             "needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(ROOT, "ceres_tpu_torch")):
        fail(f"no ceres_tpu_torch package beside {__file__}")
    sys.path.insert(0, ROOT)
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.ops import walk
    from ceres_tpu_torch.utils import native

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

    # Phase 2: build: nvcc and the two g++ libraries, started together.
    from ceres_tpu_torch.accel import native as bvh_native
    from ceres_tpu_torch.io import native as obj_native

    def seconds(fn):
        t0 = time.perf_counter()
        ok = fn()
        return ok, time.perf_counter() - t0

    with ThreadPoolExecutor(4) as pool:
        jobs = {name: pool.submit(seconds, fn) for name, fn in (
            ("walk.cu", lambda: native.load("walk")),
            ("lbvh.cu", lambda: native.load("lbvh")),
            ("bvh_build.cpp", bvh_native.available),
            ("objparse.cpp", obj_native.available))}
        builds = {name: job.result() for name, job in jobs.items()}
    build_s = builds["walk.cu"][1]
    ptxas = " | ".join(line.strip() for line in build_log().splitlines()
                       if "registers" in line)
    lbvh_ptxas = " | ".join(line.strip() for line in
                            build_log("lbvh").splitlines()
                            if "registers" in line)
    print(f"phase 2 build: {build_s:.1f} s ({ptxas}); lbvh.cu alongside "
          f"{builds['lbvh.cu'][1]:.1f} s ({lbvh_ptxas}); g++ alongside: "
          f"bvh_build.cpp {builds['bvh_build.cpp'][1]:.1f} s (built "
          f"{builds['bvh_build.cpp'][0]}), objparse.cpp "
          f"{builds['objparse.cpp'][1]:.1f} s (built "
          f"{builds['objparse.cpp'][0]})", flush=True)
    regs = resident_registers()
    check(set(regs) == set(walk.RAY_ROWS) | {"any_dest_t128"},
          f"no register report for every resident flat walk: {regs}")
    fit = {walk._variant(mode, S, stream, tile)[5:]:
           walk.resident_clusters(mode, S, stream, dev, tile)
           for mode in walk.RAY_ROWS for tile in walk.TILES[mode]
           for S, stream in ((1, False), (1, True), (2, True))}
    print(f"phase 2 tiles the card holds at once (clusters of K CTAs, kK "
          f"{cluster_ctas('kK')}, kKFlat {cluster_ctas('kKFlat')}, at 128 "
          f"rays a tile kK128 {cluster_ctas('kK128')}; resident flat: CTAs "
          f"of walk_solo, tiles of the split walk at 128 rays; their "
          f"registers {regs}): {fit}", flush=True)
    check(min(fit.values()) > 0, "a walk does not fit the card")
    if only:
        large = (large_scenes(dev, bunny_meshes())
                 if {20, 22, 23} & set(only) else None)
        if 16 in only:
            with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
                phase16(dev, card, tmp)
        if 20 in only:
            phase20(dev, card, large)
        if 21 in only:
            phase21(dev, card)
        if 22 in only:
            phase22(dev, card, large)
        if 23 in only:
            phase23(dev, card, large)
        print(f"phases 1, 2, {', '.join(map(str, only))} done", flush=True)
        return

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
    launches, *_ = render_path(vt, ft, cam, cs, sun, "phase 4 bunny path:",
                                 FRAMES, card)
    check(set(launches) == {"walk_closest", "walk_any_dest"},
          f"bunny path did not launch exactly K1 and K2: {launches}")
    path_launches = dict(launches)

    # Phase 5: against the JAX package's render of the same scene.
    with np.load(FIXTURE) as ref:
        size = ref["image"].shape[0]
    img, st = ct.render_pipeline(vt, ft, cam, sun,
                                 ct.RenderConfig(width=size, height=size,
                                                 backend="megakernel"),
                                 clusters=cs)
    against_fixture(img, st, FIXTURE,
                    f"phase 5 JAX reference: bunny {size}x{size}")

    # Phase 6: the large scenes' variants against their plain versions.
    v0, f0 = ct.load_obj(BUNNY)
    meshes = bunny_meshes()
    large = large_scenes(dev, meshes)
    for levels, (vt, ft, cam, cs, _) in large.items():
        label = (f"bunny x{levels} {W}x{H} ({ft.shape[0]} triangles, "
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
        launches, *_ = render_path(vt, ft, cam, cs, sun, label,
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
                        height=size, device=dev, backend="megakernel",
                        traversal_stats=True)
    against_fixture(img, st, LARGE_FIXTURE,
                    f"phase 8 JAX reference: bunny x4 {size}x{size}")

    # Phase 9: the reference-exact path's kernels and the window.
    from ceres_tpu_torch.ops import megakernel as mk

    for name, w, h in (("bunny", W, H), ("dragon", 960, 540)):
        vt, ft, cam, cs = scene(name, dev)
        (args, opts) = compat_inputs(vt, ft, cam, cs, w, h)
        check(opts["S"] == 1 and opts["stream"] == (name == "dragon"),
              f"{name}: generic walk S {opts['S']} stream {opts['stream']}")
        kname = walk._variant("any", 1, opts["stream"])
        r, _ = compare("any", args, opts, reps=20 if name == "bunny" else 5)
        report(9, kname, f"{name} {w}x{h} compat shadow rays "
               f"({args[1].shape[0]} tiles, {cs.num_clusters} clusters)", r,
               card)
        results[kname] = r
    vt, ft, cam, cs = scene("bunny", dev)
    _, (soup, dirs, tmin, tmax) = compat_inputs(vt, ft, cam, cs, W, H,
                                                windows=True)
    args, opts = mk._closest_inputs(cs, cam.eye, dirs, tmin, tmax)
    check(opts.get("window") and opts["S"] == 1 and not opts["stream"],
          f"bunny window: {opts}")
    r, _ = compare("closest_window", args, opts, reps=20)
    report(9, "walk_closest_window", f"bunny {W}x{H} second surface / clip "
           f"({args[1].shape[0]} tiles, {cs.num_clusters} clusters)", r, card)
    results["walk_closest_window"] = r

    vt, ft, cam, cs, _ = large[4]
    generic, (soup, dirs, tmin, tmax) = compat_inputs(vt, ft, cam, cs, W, H,
                                                      windows=True)
    label = (f"bunny x4 {W}x{H} ({ft.shape[0]} triangles, {cs.num_clusters} "
             f"blocks")
    args, opts = generic
    check(opts["S"] == 32 and opts["stream"], f"{label}: generic {opts}")
    plain_ref = None
    for stream in (True, False):
        kname = walk._variant("any", opts["S"], stream)
        r, plain_ref = compare("any", args, dict(opts, stream=stream), reps=5,
                               plain_ref=plain_ref)
        report(9, kname, f"{label}, compat shadow rays, S = {opts['S']})", r,
               card)
        if stream:
            results[kname] = r
    # The windowed entry point on the 4x bunny, as a path.
    walk.reset_launches()
    whit = mk.closest_hit_common_origin(soup, cam.eye, dirs, clusters=cs,
                                        tmin=tmin, tmax=tmax)
    torch.cuda.synchronize()
    launches = {k: n for k, n in walk.launches.items() if n}
    check(set(launches) == {"walk_closest_window_hier_stream"},
          f"bunny x4 windowed search launched {launches}")
    check(bool((whit.t[whit.mask] >= tmin[whit.mask] * (1 - 1e-6)).all()),
          "bunny x4 windowed search: a hit before its tmin")
    print(f"phase 9 windowed entry point, bunny x4 {W}x{H}: launches "
          f"{launches}; second-surface hits {int(whit.mask.sum())}",
          flush=True)
    path_launches.update(launches)
    args, opts = mk._closest_inputs(cs, cam.eye, dirs, tmin, tmax)
    check(opts.get("window") and opts["S"] == 32 and opts["stream"],
          f"{label}: window {opts}")
    plain_ref = None
    for stream in (True, False):
        kname = walk._variant("closest_window", opts["S"], stream)
        r, plain_ref = compare("closest_window", args,
                               dict(opts, stream=stream), reps=5,
                               plain_ref=plain_ref)
        report(9, kname, f"{label}, second surface / clip, S = {opts['S']})",
               r, card)
        if stream:
            results[kname] = r

    # Phase 10: the reference-exact path at full width.
    vt, ft, cam, cs = scene("bunny", dev)
    launches, *_ = render_path(vt, ft, cam, cs, sun,
                                 "phase 10 reference-exact bunny path:",
                                 FRAMES, card, compat=True)
    check(set(launches) == {"walk_closest", "walk_any"},
          f"compat bunny path did not launch exactly K1 and K3: {launches}")
    path_launches = merge(path_launches, launches)
    vt, ft, cam, cs, build_ms = large[4]
    launches, *_ = render_path(
        vt, ft, cam, cs, sun, f"phase 10 reference-exact bunny x4 path "
        f"({ft.shape[0]} triangles, {cs.num_clusters} blocks, S "
        f"{cs.super_S}):", LARGE_FRAMES, card, compat=True)
    check(set(launches) == {"walk_closest_hier_stream",
                            "walk_any_hier_stream"},
          f"compat bunny x4 path did not launch exactly K6 and K7b "
          f"(streamed): {launches}")
    path_launches = merge(path_launches, launches)

    # Phase 11: against the C++ reference's own renders.
    from ceres_tpu_torch.render import scenes

    walk.reset_launches()
    for name in ("bunny", "dragon"):
        sc = scenes.bunny_scene() if name == "bunny" else scenes.dragon_scene()
        ppm, rays, hits = CPP[name]
        ref = read_ppm(os.path.join(ROOT, "tests", "fixtures", ppm))
        for backend in ("megakernel", "bruteforce"):
            img, st = ct.render(sc.vertices, sc.faces, sc.camera, sc.sun,
                                width=64, height=64, backend=backend,
                                reference_compat=True, device=dev)
            diff = np.abs(img.cpu().numpy() - ref).max(axis=-1)
            within = float((diff <= 2.5 / 255.0).mean())
            got = (int(st["rays"]), int(st["hits"]))
            print(f"phase 11 C++ reference: {name} 64x64 {backend}: pixels "
                  f"within 2.5/255 {within:.4%} (limit 99.5%); rays/hits "
                  f"{got} (C++ {rays}/{hits})", flush=True)
            check(within >= 0.995 and got == (rays, hits),
                  f"{name} {backend} differs from the C++ reference")
    soup = ct.triangle_soup(
        torch.as_tensor([[-2, -2, 2], [2, -2, 2], [0, 2, 2], [-2, -2, 5],
                         [2, -2, 5], [0, 2, 5]], dtype=torch.float32,
                        device=dev),
        torch.as_tensor([[0, 1, 2], [3, 4, 5]], device=dev),
        with_normals=False)
    eye = torch.zeros(3, device=dev)
    d = torch.as_tensor([[0.0, 0.0, 1.0]], device=dev)
    near = mk.closest_hit_common_origin(soup, eye, d, tmin=3.0)
    gone = [mk.closest_hit_common_origin(soup, eye, d, **kw).mask[0]
            for kw in ({"tmax": 1.0}, {"tmin": 3.0, "tmax": 4.0})]
    ok = (bool(near.mask[0]) and int(near.prim_id[0]) == 1
          and abs(float(near.t[0]) - 5.0) <= 5e-5 and not any(map(bool, gone)))
    print(f"phase 11 window: two planes at t = 2 and 5, tmin 3 -> prim "
          f"{int(near.prim_id[0])} t {float(near.t[0]):.6f}; tmax 1 and "
          f"[3, 4] -> {[bool(g) for g in gone]}", flush=True)
    check(ok, "the windowed entry point is wrong on two planes")
    torch.cuda.synchronize()
    path_launches = merge(path_launches,
                          {k: n for k, n in walk.launches.items() if n})

    # Phases 12-14: the training path.
    path_launches = merge(path_launches, phase12(dev, card))
    dragon = ct.load_obj(os.path.join(ROOT, "data", "dragon.obj"))
    path_launches = merge(path_launches, phase13(
        dev, card, {"bunny": (v0, f0), "dragon": dragon,
                    "bunny x4": meshes[4]}))
    path_launches = merge(path_launches,
                          phase14(dev, card, *meshes[4], large[4][3]))

    # Phases 15-17: the command-line apps.
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        for phase in (phase15, functools.partial(phase16, meshes=meshes),
                      phase17):
            path_launches = merge(path_launches, phase(dev, card, tmp))
    # Phase 18: the quality builders and their cuts.
    path_launches = merge(path_launches,
                          phase18(dev, card, builds, meshes, large))
    # Phase 19: several ranks on the one card.
    path_launches = merge(path_launches, phase19(dev, card, meshes))
    # Phase 20: the shadow wavefront regrouped by receiver.
    launches, regrouped = phase20(dev, card, large)
    path_launches = merge(path_launches, launches)
    results.update(regrouped)
    # Phase 21: the golden oracle on the card's host.
    path_launches = merge(path_launches, phase21(dev, card))
    # Phase 22: the frame and the refitted step as CUDA graphs.
    path_launches = merge(path_launches, phase22(dev, card, large))
    # Phase 23: the build inside the graphs: deforming frames, rebuilt steps.
    path_launches = merge(path_launches, phase23(dev, card, large))

    missing = [k for k in REPLACES if not path_launches.get(k)]
    check(not missing, f"no path launched {missing}")
    # Every process the phases started (compilers, ranks, the resource
    # tracker that spawning ranks starts) has ended and been reaped.
    left = child_processes()
    check(not left, f"processes left running: {left}")

    # No PyTorch call computes a front-to-back walk with early exit:
    # library_ms is null for every variant.
    kernels = [{"name": k, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": REPLACES[k], "launches": path_launches[k],
                "max_abs_err": results[k]["max_abs_err"],
                "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"],
                "bound_ms": results[k]["bound_ms"],
                "bound_by": results[k]["bound_by"], "library_ms": None}
               for k in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

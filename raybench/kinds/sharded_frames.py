"""Traffic kind ``sharded_frames``: the anim app's turntable
(``ceres-torch-anim``, ``ceres_tpu_torch/cli/anim.py``) rendered over
the cell's ranks, one card a rank: the app run with ``--builder sweep``
and the configuration's frame (for ``bunny-1080p``: ``--width 1920
--height 1080 --eye 0 0.1 -0.3``; its other flags at their defaults),
not its default per-batch LBVH build.

Each rank builds the configuration's scene and its static cut once in
set-up (``cut``: ``sweep``, the host SweepSAH cut, as the app builds its
``--builder`` cut once before its frames) and meshes every rank as the
app does (``device_mesh``: ``frames_axis`` frame indices, the rest on
"rays", so that each rank renders its band of rows of every frame).
Call i renders the batch of ``batch`` frames from ``batch`` (i mod
``frames`` / ``batch``) of a turntable of ``frames`` frames about
``axis`` through ``render_frames_sharded(vertices, faces, camera, sun,
turntable_transforms(frames)[batch frames], mesh=, clusters=)``, with the
app's host inputs (the mesh's arrays, a host camera and sun, the track
on the host), and returns the assembled batch and its stats, summed over
the frames and the ranks, which every rank holds. One batch in flight.

Rank 0 is the run's process; it starts the other ranks (``ranks.Group``)
and names each call to them before it makes it (``announce``, ``call``).
Each rank runs its CPU operators on one thread, as under ``torchrun``,
which starts the app's ranks with OMP_NUM_THREADS=1.

``check(window)`` stops the ranks, frees the port's state and holds the
compared batches (rank 0's assembled output, which holds every rank's
rows) to the plain reference (``reference.frame``, exhaustive
Moller-Trumbore), frame by frame: frame k's eye, view direction and sun
are the configuration's turned by ``turntable(k, frames, axis)``, this
file's own rotation. ``px_off_pct`` over the batch's pixels,
``rays_gap`` and ``hits_gap`` over its summed stats, the worst batch.
``control(spec, seed, root, dev)`` gives ``control.py`` the reference in
bfloat16 in the port's place, on the batch a run draws first.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time

import numpy as np
import torch

from raybench import compare, loops, ranks, reference


def turntable(k: int, n: int, axis) -> torch.Tensor:
    """The (3, 3) float32 rotation of frame ``k`` of a turntable of ``n``
    frames: k 360 / n degrees about ``axis``, as the direction-cosine
    matrix c I + (1 - c) a a^T - s [a]x (a the unit axis, [a]x its cross
    product matrix), applied to a point p as R p. The angle is taken as
    the app takes it, in float32: k times 2 pi / n."""
    a = torch.as_tensor(axis, dtype=torch.float32)
    a = a / torch.linalg.vector_norm(a)
    angle = torch.arange(n, dtype=torch.float32)[k] * (2.0 * math.pi / n)
    c, s = torch.cos(angle), torch.sin(angle)
    x, y, z = a
    cross = torch.stack([torch.stack([0 * x, -z, y]),
                         torch.stack([z, 0 * x, -x]),
                         torch.stack([-y, x, 0 * x])])
    return c * torch.eye(3) + (1.0 - c) * torch.outer(a, a) - s * cross


def turned(cam: dict, sun, k: int, traffic: dict):
    """(eye, camera dict, sun) of frame ``k``: the configuration's eye,
    view direction and sun turned by ``turntable``; up and fov as they
    are."""
    rot = turntable(k, traffic["frames"], traffic["axis"]).double()

    def turn(p):
        return (rot @ torch.as_tensor(np.asarray(p), dtype=torch.float64)
                ).float()

    return turn(cam["eye"]), dict(cam, dir=turn(cam["dir"])), turn(sun)


def batch_frames(i: int, traffic: dict) -> range:
    """The frames of call i's batch."""
    n = traffic["batch"]
    first = n * (i % (traffic["frames"] // n))
    return range(first, first + n)


def reference_batch(sc, sun, frames, traffic: dict, dtype=torch.float32):
    """The reference's ((F, H, W, 3) images, {"rays", "hits"} summed) of
    ``frames``; ``sc`` holds the mesh (``vt``, ``f``), ``cam``, ``width``
    and ``height``."""
    faces = torch.as_tensor(sc.f, device=sc.vt.device).long()
    images, rays, hits = [], 0, 0
    for k in frames:
        eye, cam, sun_k = turned(sc.cam, sun, k, traffic)
        image, stats = reference.frame(
            sc.vt, faces, eye.to(sc.vt.device), cam,
            sun_k.to(sc.vt.device), sc.width, sc.height, dtype)
        images.append(image)
        rays += stats["rays"]
        hits += stats["hits"]
    return torch.stack(images), {"rays": rays, "hits": hits}


class Loop:
    """The sharded turntable on one rank (``rank`` 0 leads and starts the
    others; ``address`` is the group's, which rank 0 picks)."""

    returns = "frames"
    reference_s = 0.0

    def __init__(self, cfg: dict, traffic: dict, seed: int, root: str, dev,
                 mark=print, chips: int = 1, rank: int = 0,
                 address: str = None):
        import ceres_tpu_torch as ct
        from ceres_tpu_torch.parallel import sharded

        self.chips, self.rank, self.dev = chips, rank, dev
        self.traffic, self.group, self._told = traffic, None, None
        if chips > 1:
            # One host thread a rank's CPU operators, as torchrun sets
            # OMP_NUM_THREADS=1 for the ranks it starts.
            torch.set_num_threads(1)
        if chips > 1 and rank == 0:
            self.group = ranks.Group(chips, {
                "kind": traffic["kind"], "cfg": cfg, "traffic": traffic,
                "seed": seed, "root": root, "device": dev.type,
                "chips": chips})
            address = self.group.address
            mark(f"{chips - 1} ranks started")
        sc = self.scene = loops.Scene(cfg, root, dev)
        self.config = dataclasses.replace(sc.config, shadows=cfg["shadows"],
                                          backend=cfg["backend"])
        # The app's inputs: host arrays, camera and sun, and the track on
        # the host; the port moves them to the rank's device each batch.
        self.camera = ct.Camera.make(sc.cam["eye"], sc.cam["dir"],
                                     sc.cam["up"], sc.cam["fov"])
        self.sun = np.asarray(cfg["sun"], np.float32)
        self.tracks = sharded.turntable_transforms(traffic["frames"],
                                                   axis=traffic["axis"])
        mark("mesh, camera and track")
        self.cs = loops._cut(cfg["cut"], ct.triangle_soup(
            sc.vt, sc.ft, with_normals=False))
        mark(f"{cfg['cut']} cut")
        if chips > 1:
            backend = ranks.join(address, chips, rank, dev)
            mark(f"rank {rank} of {chips} joined ({backend})")
        self.mesh = sharded.device_mesh(traffic["frames_axis"],
                                        devices=[dev])

    def _render(self, i: int, mesh):
        from ceres_tpu_torch.parallel.sharded import render_frames_sharded

        k = batch_frames(i, self.traffic)
        sc = self.scene
        return render_frames_sharded(
            sc.v, sc.f, self.camera, self.sun,
            self.tracks.frame(slice(k.start, k.stop)), self.config,
            mesh=mesh, clusters=self.cs)

    def announce(self, i: int):
        """Name call i to the other ranks."""
        if self.group is not None:
            self.group.tell("call", i)
        self._told = i

    def call(self, i: int):
        """Batch i over every rank: (the (F, H, W, 3) batch, its stats)."""
        if self.group is not None and self._told != i:
            self.group.tell("call", i)
        self._told = None
        return self._render(i, self.mesh)

    def alone(self, i: int):
        """Batch i through the same call on this rank alone, a mesh of
        one; the other ranks wait."""
        from ceres_tpu_torch.parallel.sharded import Mesh

        return self._render(i, Mesh(self.dev))

    def over_ranks(self, device: dict) -> dict:
        """``device`` with the fullest card's peak memory and the busy
        seconds averaged over the cards (each rank's own trace)."""
        if self.group is None:
            return device
        others = self.group.report()
        device["memory_peak_bytes"] = max(
            [device["memory_peak_bytes"]]
            + [r["memory_peak_bytes"] for r in others])
        if "busy_s" in device:
            busy = [device["busy_s"]] + [r["busy_s"] for r in others]
            window = [device["window_s"]] + [r["window_s"] for r in others]
            ranks.log(f"busy seconds by rank {busy}; window seconds by "
                      f"rank {window}")
            if None not in busy:
                device["busy_s"] = sum(busy) / len(busy)
        return device

    def stop(self):
        """Stop and join the other ranks; every rank leaves the group."""
        if self.group is not None:
            t0 = time.perf_counter()
            codes = self.group.stop(then=ranks.leave)
            ranks.log(f"ranks stopped and joined in "
                      f"{time.perf_counter() - t0:.6f} s")
            if any(codes):
                raise RuntimeError(f"ranks 1-{self.chips - 1} exited with "
                                   f"codes {codes} when stopped")

    def abandon(self):
        if self.group is not None:
            self.group.abandon()

    def free(self):
        for name in ("cs", "mesh", "tracks"):
            self.__dict__.pop(name, None)

    def check(self, window: dict) -> dict:
        kept = sorted(window.pop("kept").items())
        self.stop()
        self.free()
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        parts, t0 = [], time.perf_counter()
        for j, (image, stats) in kept:
            refs, ref_stats = reference_batch(
                self.scene, self.sun,
                batch_frames(window["first"] + j, self.traffic),
                self.traffic)
            parts.append(compare.frame_numbers(image, stats, refs, ref_stats))
            del refs
        ranks.log(f"reference: {len(kept)} batches in "
                  f"{time.perf_counter() - t0:.6f} s")
        return compare.worst(parts)


def control(spec: dict, seed: int, root: str, dev) -> dict:
    """{"control": the numbers of the reference in bfloat16 against the
    float32 reference} on batch i, i drawn from the seed as a run draws
    its compared batch among the window's first ``draw_from`` calls
    (``control.py``)."""
    from raybench import control as ctl

    cfg, traffic = spec["config"], spec["traffic"]
    sc = ctl.scene_of(cfg, root, dev)
    i = random.Random(seed).randrange(spec["cell"]["draw_from"])
    frames = batch_frames(i, traffic)
    sun = np.asarray(cfg["sun"], np.float32)
    got = {dtype: reference_batch(sc, sun, frames, traffic, dtype)
           for dtype in (torch.float32, torch.bfloat16)}
    return {"control": compare.frame_numbers(*got[torch.bfloat16],
                                             *got[torch.float32])}

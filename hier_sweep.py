"""The cluster walk kernels at each cluster size K, on one NVIDIA card.

    python3 hier_sweep.py [--ks 2,4,8] [--flat-ks 2,4,8] [--k128s 2,4,8]
                          [--out ceres_tpu_torch/_build/sweep]
    python3 hier_sweep.py --turns _checkout/parent

``ceres_tpu_torch/ops/csrc/walk.cu`` has three cluster sizes: the
constant kK (the two-level kernels), kKFlat (the streamed flat kernels)
and kK128 (both cluster walks at 128 rays a tile, the regrouped shadow
wavefront). For each K of ``--ks`` (the others as committed), each of
``--flat-ks`` and each of ``--k128s``, copies what ``chip_smoke.py`` reads (itself, the package
without built kernels, ``data/`` and ``tests/fixtures/``) into
OUT/<constant><k>, sets the constant there, builds every copy's kernels
in parallel (one nvcc each) and then runs each copy's ``chip_smoke.py``
in turn: it holds every variant to its plain version (outputs and every
tile's executed visits) and times it with CUDA events, on the 3x and 4x
bunny at 1920 x 1080 among the other paths. Each log goes to
OUT/smoke_<constant><k>.log. Prints, per copy, every kernel's line
(form and K, visits, the heaviest tile, us per visit of it, ms, bound,
share) and the frames' lines, beside the card's name and power limit.
A kK128 copy runs ``chip_smoke.py --phases 20`` only: the regrouped
calls and their kernels on the bunny and the 3x and 4x bunny at 1080p.
Exits non-zero if a copy fails. Another commit is timed the same way by
running its own ``chip_smoke.py`` (``git archive`` it into a directory
that .gitignore lists), or in turns with this one: ``--turns DIR`` builds
both checkouts' kernels in parallel and runs ``chip_smoke.py`` in DIR,
here, here and in DIR (parent, change, change, parent), printing the same
lines of each run and its training phases' times, and does nothing else.

Then, with the kernels as committed, where the flat kernels' time goes
on 1080p inputs (``--ks "" --flat-ks ""`` runs this alone): each of K5
closest and any_dest on the 3x bunny, and of the resident K1 and K2 on
the bunny, timed on all tiles, on its heaviest tile alone, without the
heaviest 1% of its tiles, and with every key row cut to no candidate
(the cost of starting 4,080 tiles that visit nothing).
"""

import argparse
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join("ceres_tpu_torch", "ops", "csrc", "walk.cu")
SKIP = shutil.ignore_patterns("_build", "__pycache__")
LINES = re.compile(r"(two-level|flat streamed|flat resident): |"
                   r"^phase 20 regrouped |"
                   r"^phase (4|7|10) .*path|^phase 1[234] .*(ms|MiB)")


def copy_with(name, k, dst):
    """A copy of the smoke test's inputs in dst with constant ``name`` of
    walk.cu set to k."""
    shutil.rmtree(dst, ignore_errors=True)
    for part in ("ceres_tpu_torch", "data", os.path.join("tests", "fixtures")):
        shutil.copytree(os.path.join(ROOT, part), os.path.join(dst, part),
                        ignore=SKIP)
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    path = os.path.join(dst, SOURCE)
    with open(path) as fh:
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {k};", fh.read())
    if n != 1:
        sys.exit(f"{SOURCE} has no single {name} constant")
    with open(path, "w") as fh:
        fh.write(text)


def flat_floor(card):
    """Time the flat kernels on 1080p inputs with the key rows of some
    tiles cut to no candidate: K5 closest and any_dest on the 3x bunny,
    and the resident K1 and K2 on the bunny."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel.clusters import build_clusters_treelet
    from ceres_tpu_torch.models.mesh import subdivide

    dev = torch.device("cuda", 0)
    v, f = subdivide(*ct.load_obj(os.path.join(ROOT, "data", "bunny.obj")), 3)
    vt, ft = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
    cs = build_clusters_treelet(ct.triangle_soup(vt, ft, with_normals=False))
    cut_tiles(card, smoke.walk_inputs(vt, ft, smoke.camera(v, smoke.EYE, dev),
                                      cs, smoke.W, smoke.H))
    cut_tiles(card, smoke.walk_inputs(*smoke.scene("bunny", dev), smoke.W,
                                      smoke.H))


def cut_tiles(card, inputs):
    """Each walk of ``inputs`` (closest, any_dest) timed on all tiles, on
    its heaviest tile alone, without the heaviest 1% of its tiles, and
    with no candidates at all."""
    import torch

    import chip_smoke as smoke
    from ceres_tpu_torch.ops import walk

    for mode, (args, opts) in zip(("closest", "any_dest"), inputs):
        kernel = getattr(walk, smoke.WALKS[mode])
        counts = args[0]
        visits = kernel(*args, **opts)[1]
        order = visits.argsort(descending=True)
        top = order[:max(1, counts.numel() // 100)]
        only = torch.zeros_like(counts)
        only[order[0]] = counts[order[0]]
        rest = counts.clone()
        rest[top] = 0
        cuts = {"all tiles": counts, "the heaviest tile alone": only,
                f"without the heaviest {top.numel()} tiles": rest,
                "no candidates": torch.zeros_like(counts)}
        for label, c in cuts.items():
            run = (c, *args[1:])
            n = int(kernel(*run, **opts)[1].sum())
            ms = smoke.cuda_ms(lambda: kernel(*run, **opts), 10)
            print(f"floor {walk._variant(mode, 1, opts['stream'])} {label}: "
                  f"visits {n} "
                  f"(heaviest tile {int(visits[order[0]])}, "
                  f"{int((visits > 0).sum())} of {counts.numel()} tiles "
                  f"visit); kernel {ms:.4f} ms [{card}]", flush=True)


def build_all(dirs):
    """Build each checkout's kernels, one nvcc each, all at once. Returns
    the tags whose build failed."""
    build = "from ceres_tpu_torch.ops import _build; _build.build()"
    procs = {tag: subprocess.Popen([sys.executable, "-c", build], cwd=d,
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
             for tag, d in dirs.items()}
    failed = []
    for tag, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{tag}: build failed\n{log[-2000:]}", flush=True)
            failed.append(tag)
    return failed


def smoke(tag, d, out, extra=()):
    """Run d's chip_smoke.py (with arguments ``extra``), its log in out;
    print its kernel and frame lines. Returns the exit code."""
    t0 = time.perf_counter()
    log = os.path.join(out, f"smoke_{tag}.log")
    with open(log, "w") as fh:
        rc = subprocess.run([sys.executable, "chip_smoke.py", *extra], cwd=d,
                            stdout=fh, stderr=subprocess.STDOUT).returncode
    print(f"{tag}: chip_smoke.py rc={rc} "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    with open(log) as fh:
        for line in fh:
            if LINES.search(line):
                print(f"{tag}: {line.strip()[:420]}", flush=True)
    return rc


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ks", default="2,4,8")
    ap.add_argument("--flat-ks", default="2,4,8")
    ap.add_argument("--k128s", default="2,4,8")
    ap.add_argument("--turns", metavar="DIR",
                    help="time DIR's chip_smoke.py against this one's in "
                    "turns (DIR, here, here, DIR), and nothing else")
    ap.add_argument("--out", default=os.path.join(ROOT, "ceres_tpu_torch",
                                                  "_build", "sweep"))
    args = ap.parse_args()
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    if args.turns:
        dirs = {"parent": os.path.abspath(args.turns), "change": ROOT}
        failed = build_all(dirs)
        turns = ("parent", "change", "change", "parent")
        for i, tag in enumerate(turns):
            if tag not in failed and smoke(f"{tag}{i}", dirs[tag], out) != 0:
                failed.append(tag)
        if failed:
            sys.exit(f"failed: {failed}")
        return
    copies = [(name, int(k)) for name, ks in (("kK", args.ks),
                                               ("kKFlat", args.flat_ks),
                                               ("kK128", args.k128s))
              for k in ks.split(",") if k]
    dirs = {f"{name}{k}": os.path.join(out, f"{name}{k}")
            for name, k in copies}
    for (name, k), d in zip(copies, dirs.values()):
        copy_with(name, k, d)
    failed = build_all(dirs)
    for tag, d in dirs.items():
        if tag in failed:
            continue
        extra = ("--phases", "20") if tag.startswith("kK128") else ()
        if smoke(tag, d, out, extra) != 0:
            failed.append(tag)
        shutil.rmtree(d, ignore_errors=True)
    if failed:
        sys.exit(f"failed: {failed}")
    flat_floor(card.splitlines()[0])


if __name__ == "__main__":
    main()

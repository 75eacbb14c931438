"""The cluster walk kernels at each cluster size K, on one NVIDIA card.

    python3 hier_sweep.py [--ks 2,4,8] [--flat-ks 2,4,8] [--k128s 2,4,8]
                          [--segs 64,256,1024]
                          [--out ceres_tpu_torch/_build/sweep]
    python3 hier_sweep.py --turns _checkout/parent[,DIR...] [--phases 20]
    python3 hier_sweep.py --probe [DIR]
    python3 hier_sweep.py --sass DIR

``ceres_tpu_torch/ops/csrc/walk.cu`` has two cluster sizes: the
constant kK (the two-level kernels) and kKFlat (the streamed flat
kernels); and the split walk of 128-ray tiles (the regrouped shadow
wavefront's streamed flat and two-level forms) has kK128 ray groups a
tile and segments of kSeg128 block visits. For each K of ``--ks`` (the
others as committed), each of ``--flat-ks``, each of ``--k128s`` and each
of ``--segs``, copies what ``chip_smoke.py`` reads (itself, the package
without built kernels, ``data/`` and ``tests/fixtures/``) into
OUT/<constant><k>, sets the constant there, builds every copy's kernels
in parallel (one nvcc each) and then runs each copy's ``chip_smoke.py``
in turn: it holds every variant to its plain version (outputs and every
tile's executed visits) and times it with CUDA events, on the 3x and 4x
bunny at 1920 x 1080 among the other paths. Each log goes to
OUT/smoke_<constant><k>.log. Prints, per copy, every kernel's line
(form and K, visits, the heaviest tile, us per visit of it, ms, bound,
share) and the frames' lines, beside the card's name and power limit.
A kK128 or kSeg128 copy runs ``chip_smoke.py --phases 20`` only: the
regrouped calls and their kernels on the bunny and the 3x and 4x bunny at
1080p.
Exits non-zero if a copy fails. Another commit is timed the same way by
running its own ``chip_smoke.py`` (``git archive`` it into a directory
that .gitignore lists), or in turns with this one: ``--turns DIR`` builds
both checkouts' kernels in parallel and runs ``chip_smoke.py`` in DIR,
here, here and in DIR (parent, change, change, parent), printing the same
lines of each run and its training phases' times, and does nothing else
(``--phases 20`` passes on to each run: the regrouped walks alone).
``--turns DIR,DIR2`` puts another checkout (an alternative design)
between them: DIR, DIR2, here, here, DIR2, DIR (tags parent, the
directory's name, change).

``--probe [DIR]`` (DIR a checkout, this one by default) times the steps
of one visit of the 128-ray cluster walk as DIR's walk.cu has it
(``walk_tile<kAnyDest, true, 8, *, 128>``, whose loop is
``TileWalk::run``): a copy of walk.cu with clock64 stamps after each
step of that loop, built apart with the same nvcc flags, runs on the
heaviest regrouped tile alone of the 3x bunny (flat) and the 4x bunny
(two-level) at 1920 x 1080, and prints the cycles a visit spends in each
step, counted in the CTA of cluster rank 0, thread 0. Exits non-zero if
an anchor line of the loop is missing.

``--sass DIR`` builds DIR's kernels and this checkout's (in parallel)
and compares their SASS (``cuobjdump -sass``) kernel by kernel, names
taken without the anonymous namespace's (it hashes the source): it
prints how many of DIR's kernels are this checkout's instruction for
instruction, lists the others (a 128-ray kernel this checkout lacks as
replaced), and exits non-zero if a kernel of 512-ray tiles (``walk_solo``
among them) differs or is missing.

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
# Python that builds a checkout's walk library into ``path``.
BUILD_WALK = ("from ceres_tpu_torch.utils import native\n"
              "path = native.build(native.SOURCES['walk'])")
LINES = re.compile(r"(two-level|flat streamed|flat resident|split walk): |"
                   r"^phase 20 (regrouped |heavy |walk_\S+ .*alone)|"
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


# The probe's stamps: (anchor line of TileWalk::run, the slot of the
# stamp put before it, the step it times). Each stamp adds the cycles
# since the last one to its slot: the step is the code between the two.
PROBE_STEPS = (
    ("      const int part = block_max<R>(prune_part<M>(best, occ, "
     "r.tcap), sh.red[red]);", 0, "take the visit, copy wait"),
    ("      const int p = nvis & 1;", 1, "block max (barrier)"),
    ("      // Meanwhile: prefetch the block after nxt, and visit nxt, both",
     2, "st.async sends"),
    ("      int x2 = 0;", 3, "pop, stage the block after"),
    ("      {  // the other CTAs' parts are in; re-arm", 4,
     "visit nxt (speculative)"),
    ("      const int v = lane < K && lane != rank ? sh.part[p][lane] : "
     "part;", 5, "mbarrier wait, re-arm"),
    ("      if (m2 > prune) break;  // nxt's visit, if made, is dropped",
     6, "prune max, loop"),
)
PROBE_HEAD = r"""
namespace {
__device__ unsigned long long g_probe[9];
__device__ __forceinline__ unsigned long long probe_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");
  return t;
}
}  // namespace
#define PROBE(i) { const unsigned long long c_ = probe_clock(); \
  if (threadIdx.x == 0 && rank == 0) atomicAdd(&g_probe[i], c_ - probe_t); \
  probe_t = c_; }
"""
PROBE_ENTRY = r"""
extern "C" int ceres_probe_t128(int hier, const int* counts, const int* keys,
    const float* rays, const float* w, const int* occ0, const float* hull,
    const float* bbox, const int* first, int* out, int* visits, int n_tiles,
    int n_k, int cmask, int S, unsigned long long* probe, void* stream) {
  unsigned long long zero[9] = {};
  cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = tile_launch(
      n_tiles, 8, kR128, static_cast<cudaStream_t>(stream), &attr);
  cudaError_t err = hier
      ? cudaLaunchKernelEx(&cfg, walk_tile<kAnyDest, true, 8, true, kR128>,
                           counts, keys, rays, w, occ0, hull, bbox, first,
                           out, visits, n_tiles * kR128, n_k, cmask, S)
      : cudaLaunchKernelEx(&cfg, walk_tile<kAnyDest, true, 8, false, kR128>,
                           counts, keys, rays, w, occ0, hull, bbox, first,
                           out, visits, n_tiles * kR128, n_k, cmask, S);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(probe, g_probe, sizeof(zero));
  }
  return (int)err;
}
"""


def probe_source(text):
    """walk.cu's text with the probe's stamps in TileWalk::run and its
    entry point, or None if an anchor is missing."""
    start = "    bool ahead = false;  // a prefetch is in flight\n"
    end = ("    if (kStream && ahead) wait_async<0>();  // drain a prefetch "
           "left behind\n")
    for anchor in [start, end] + [a + "\n" for a, _, _ in PROBE_STEPS]:
        if text.count(anchor) != 1:
            print(f"probe: anchor not found once: {anchor.strip()}")
            return None
    text = text.replace(start, start + "    unsigned long long probe_t = "
                        "probe_clock(), probe_run = probe_t;\n")
    for anchor, slot, _ in PROBE_STEPS:
        text = text.replace(anchor + "\n", f"      PROBE({slot})\n" + anchor
                            + "\n")
    text = text.replace(end, end + (
        "    if (threadIdx.x == 0 && rank == 0) {\n"
        "      atomicAdd(&g_probe[7], probe_clock() - probe_run);\n"
        "      atomicAdd(&g_probe[8], 1ull);\n    }\n"))
    head = "namespace cg = cooperative_groups;\n"
    return text.replace(head, head + PROBE_HEAD, 1) + PROBE_ENTRY


def probe(src_dir, out, card):
    """Build the stamped copy of src_dir's walk.cu and time the steps of
    a visit on the heaviest regrouped tile of the 3x and 4x bunny."""
    import ctypes

    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from ceres_tpu_torch.ops import prepass, walk
    from ceres_tpu_torch.utils import native

    with open(os.path.join(src_dir, SOURCE)) as fh:
        text = probe_source(fh.read())
    if text is None:
        sys.exit("probe: walk.cu has not the loop the probe stamps")
    d = os.path.join(out, "probe")
    os.makedirs(d, exist_ok=True)
    cu, lib = os.path.join(d, "walk_probe.cu"), os.path.join(d, "probe.so")
    with open(cu, "w") as fh:
        fh.write(text)
    proc = subprocess.run([native.compiler(cu), *native.NVCC_FLAGS, "-o",
                           lib, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"probe build failed:\n{proc.stderr[-3000:]}")
    fn = ctypes.CDLL(lib).ceres_probe_t128
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    dev = torch.device("cuda", 0)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,"
                            "clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    large = smoke.large_scenes(dev, smoke.bunny_meshes())
    for levels, (vt, ft, cam, cs, _) in large.items():
        _, sun, points, skip = smoke.shadow_wavefront(vt, ft, cam, cs,
                                                      smoke.W, smoke.H)
        args, opts = smoke.regrouped_inputs(cs, sun, points, skip)
        counts, keys, rays, w, occ0 = args
        tiles = walk.walk_any_dest(*args, **opts)[1]
        t = int(tiles.argmax())
        only = torch.zeros_like(counts)
        only[t] = counts[t]
        n_tiles, n_k = keys.shape
        hier = opts["S"] > 1
        extra = [opts[k].data_ptr() if hier else None
                 for k in ("hull", "bbox", "first")]
        out_t = torch.empty_like(occ0)
        vis = torch.empty_like(counts)
        stamps = (ctypes.c_ulonglong * 9)()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = fn(int(hier), only.data_ptr(), keys.data_ptr(),
                 rays.data_ptr(), w.data_ptr(), occ0.data_ptr(), *extra,
                 out_t.data_ptr(), vis.data_ptr(), n_tiles, n_k,
                 (1 << prepass._cid_bits(n_k)) - 1, opts["S"],
                 ctypes.cast(stamps, ctypes.c_void_p),
                 torch.cuda.current_stream(dev).cuda_stream)
        end.record()
        torch.cuda.synchronize()
        if err != 0:
            sys.exit(f"probe launch failed: {err}")
        visits = int(vis[t])   # one loop iteration a visit
        same = "equal" if visits == int(tiles[t]) else "NOT equal"
        total = sum(stamps[slot] for _, slot, _ in PROBE_STEPS)
        print(f"probe bunny x{levels} ({'two-level' if hier else 'flat'} "
              f"streamed, K 8, 128 rays) heaviest tile {t}: {visits} visits "
              f"({same} to the kernel's) in {stamps[8]} runs of the loop; "
              f"launch {start.elapsed_time(end):.4f} ms; cycles in the runs "
              f"{stamps[7]}, in the loop {total} = "
              f"{total / max(visits, 1):.0f} a visit; SM clock "
              f"{clock} [{card}]", flush=True)
        for _, slot, what in PROBE_STEPS:
            print(f"probe bunny x{levels}: {what}: "
                  f"{stamps[slot] / max(visits, 1):.0f} cycles a visit "
                  f"({stamps[slot] / max(total, 1):.1%})", flush=True)


def sass(lib):
    """{kernel name without the anonymous namespace: its instructions}
    of a built library."""
    tool = os.path.join(os.path.dirname(_nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_walk_cu_[0-9a-f]+", "",
                          head.group(1))
            funcs[name] = []
        elif name and "/*" in line:
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line.split(";")[0])
            if ins.strip():
                funcs[name].append(ins.strip())
    return funcs


def _nvcc_path():
    sys.path.insert(0, ROOT)
    from ceres_tpu_torch.utils import native

    return native.compiler(native.SOURCES["walk"])


def sass_diff(other):
    """Compare the SASS of other's kernels with this checkout's."""
    dirs = {"other": os.path.abspath(other), "this": ROOT}
    if build_all(dirs):
        sys.exit("sass: a build failed")
    code = BUILD_WALK + "\nprint(path)"
    libs = {tag: subprocess.run([sys.executable, "-c", code], cwd=d,
                                capture_output=True, text=True,
                                check=True).stdout.split()[-1]
            for tag, d in dirs.items()}
    old, new = sass(libs["other"]), sass(libs["this"])
    same = [k for k, v in old.items() if new.get(k) == v]
    print(f"sass: {len(same)} of {other}'s {len(old)} kernels are this "
          f"checkout's instruction for instruction ({len(new)} here)",
          flush=True)
    bad = False
    for k in old:
        if k in same:
            continue
        # Kernels of 512-ray tiles (walk_solo<M, 512> among them) are
        # held; a 128-ray kernel may be replaced.
        kept = "Li512E" in k
        bad |= kept
        state = ("missing" if kept else "replaced") if k not in new else (
            f"differs ({len(old[k])} against {len(new[k])} instructions)")
        print(f"sass: {state}: {k[:100]}", flush=True)
    for k in new:
        if k not in old:
            print(f"sass: new here: {k[:100]}", flush=True)
    if bad:
        sys.exit("sass: a kernel of 512-ray tiles differs")


def build_all(dirs):
    """Build each checkout's kernels, one nvcc each, all at once. Returns
    the tags whose build failed."""
    build = BUILD_WALK
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
    ap.add_argument("--segs", default="64,256,1024")
    ap.add_argument("--turns", metavar="DIR[,DIR2...]",
                    help="time DIR's chip_smoke.py against this one's in "
                    "turns (DIR, DIR2, ..., here, here, ..., DIR2, DIR), "
                    "and nothing else")
    ap.add_argument("--phases", help="with --turns: run chip_smoke.py "
                    "--phases PHASES in each turn")
    ap.add_argument("--sass", metavar="DIR",
                    help="compare DIR's kernels' SASS with this one's, and "
                    "nothing else")
    ap.add_argument("--probe", metavar="DIR", nargs="?", const=ROOT,
                    help="time the steps of a 128-ray cluster walk visit "
                    "as DIR's walk.cu has it, and nothing else")
    ap.add_argument("--out", default=os.path.join(ROOT, "ceres_tpu_torch",
                                                  "_build", "sweep"))
    args = ap.parse_args()
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    if args.probe:
        probe(os.path.abspath(args.probe), out, card.splitlines()[0])
        return
    if args.sass:
        sass_diff(args.sass)
        return
    if args.turns:
        parent, *others = args.turns.split(",")
        dirs = {"parent": os.path.abspath(parent)}
        dirs.update({os.path.basename(os.path.normpath(d)): os.path.abspath(d)
                     for d in others})
        dirs["change"] = ROOT
        failed = build_all(dirs)
        turns = (*dirs, *reversed(dirs))
        extra = ("--phases", args.phases) if args.phases else ()
        for i, tag in enumerate(turns):
            if (tag not in failed
                    and smoke(f"{tag}{i}", dirs[tag], out, extra) != 0):
                failed.append(tag)
        if failed:
            sys.exit(f"failed: {failed}")
        return
    copies = [(name, int(k)) for name, ks in (("kK", args.ks),
                                               ("kKFlat", args.flat_ks),
                                               ("kK128", args.k128s),
                                               ("kSeg128", args.segs))
              for k in ks.split(",") if k]
    dirs = {f"{name}{k}": os.path.join(out, f"{name}{k}")
            for name, k in copies}
    for (name, k), d in zip(copies, dirs.values()):
        copy_with(name, k, d)
    failed = build_all(dirs)
    for tag, d in dirs.items():
        if tag in failed:
            continue
        extra = (("--phases", "20") if tag.startswith(("kK128", "kSeg128"))
                 else ())
        if smoke(tag, d, out, extra) != 0:
            failed.append(tag)
        shutil.rmtree(d, ignore_errors=True)
    if failed:
        sys.exit(f"failed: {failed}")
    flat_floor(card.splitlines()[0])


if __name__ == "__main__":
    main()

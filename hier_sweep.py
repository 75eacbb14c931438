"""The two-level walk kernels at each cluster size K, on one NVIDIA card.

    python3 hier_sweep.py [--ks 2,4,8] [--out ceres_tpu_torch/_build/sweep]

For each K, copies what ``chip_smoke.py`` reads (itself, the package
without built kernels, ``data/`` and ``tests/fixtures/``) into OUT/K<k>,
sets the constant kK of ``ceres_tpu_torch/ops/csrc/walk.cu`` there to
K, builds every copy's kernels in parallel (one nvcc each) and then
runs each copy's ``chip_smoke.py`` in turn: it holds every variant to
its plain version (outputs and every tile's executed visits) and times
it with CUDA events, on the 4x bunny at 1920 x 1080 among the other
paths. Each log
goes to OUT/smoke_K<k>.log. Prints, per K, the two-level kernels' lines
(visits, the heaviest tile, us per member visit, ms, bound, share) and
the 4x bunny frames' lines, beside the card's name and power limit.
Exits non-zero if a copy fails. Another commit is timed the same way by
running its own ``chip_smoke.py`` (``git archive`` it into a directory
that .gitignore lists).
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
LINES = re.compile(r"two-level: K|^phase (7|10) .*bunny x4")


def copy_with_k(k, dst):
    shutil.rmtree(dst, ignore_errors=True)
    for part in ("ceres_tpu_torch", "data", os.path.join("tests", "fixtures")):
        shutil.copytree(os.path.join(ROOT, part), os.path.join(dst, part),
                        ignore=SKIP)
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    path = os.path.join(dst, SOURCE)
    with open(path) as fh:
        text, n = re.subn(r"constexpr int kK = \d+;",
                          f"constexpr int kK = {k};", fh.read())
    if n != 1:
        sys.exit(f"{SOURCE} has no single kK constant")
    with open(path, "w") as fh:
        fh.write(text)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ks", default="2,4,8")
    ap.add_argument("--out", default=os.path.join(ROOT, "ceres_tpu_torch",
                                                  "_build", "sweep"))
    args = ap.parse_args()
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    ks = [int(x) for x in args.ks.split(",")]
    dirs = {k: os.path.join(out, f"K{k}") for k in ks}
    for k, d in dirs.items():
        copy_with_k(k, d)
    build = "from ceres_tpu_torch.ops import _build; _build.build()"
    procs = {k: subprocess.Popen([sys.executable, "-c", build], cwd=d,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, d in dirs.items()}
    failed = []
    for k, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"K={k}: build failed\n{log[-2000:]}", flush=True)
            failed.append(k)
    for k, d in dirs.items():
        if k in failed:
            continue
        t0 = time.perf_counter()
        log = os.path.join(out, f"smoke_K{k}.log")
        with open(log, "w") as fh:
            rc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=d,
                                stdout=fh, stderr=subprocess.STDOUT).returncode
        print(f"K={k}: chip_smoke.py rc={rc} "
              f"{time.perf_counter() - t0:.0f} s", flush=True)
        with open(log) as fh:
            for line in fh:
                if LINES.search(line):
                    print(f"K={k}: {line.strip()[:400]}", flush=True)
        if rc != 0:
            failed.append(k)
        shutil.rmtree(d, ignore_errors=True)
    if failed:
        sys.exit(f"failed at K = {failed}")


if __name__ == "__main__":
    main()

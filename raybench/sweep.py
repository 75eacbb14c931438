"""Run cells one after another, each run its own process, and sum up
their spread: the tool that sets and checks the bounds.

    python3 raybench/sweep.py --cells A,B --seeds 11,12,13 [--seconds S]
        [--trace 0|1] [--out raybench/out/sweep.jsonl]

Runs ``raybench/run.py`` for every cell and seed in that order (one
process at a time, so that one process uses the card), appends each
run's result line, exit code, wall seconds and the end of its standard
error to ``--out``, and prints for each cell and metric the median and
the spread: the distance between the first and third quartiles
(``statistics.quantiles(n=4)``) as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HOME = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HOME)


def spread(values):
    """(median, (q3 - q1) / median) of ``values``."""
    med = statistics.median(values)
    if len(values) < 2:
        return med, float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=os.path.join(HOME, "out",
                                                  "sweep.jsonl"))
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        seconds = args.seconds or json.load(fh)["run_seconds"]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    results = {}
    for cell in args.cells.split(","):
        for seed in args.seeds.split(","):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.join(HOME, "run.py"), "--workload",
                 cell, "--seed", seed, "--seconds", str(seconds), "--trace",
                 str(args.trace)], capture_output=True, text=True, cwd=ROOT)
            wall = time.perf_counter() - t0
            lines = proc.stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                result = None
            row = {"cell": cell, "seed": int(seed), "seconds": seconds,
                   "trace": args.trace, "rc": proc.returncode, "wall": wall,
                   "result": result, "stderr": proc.stderr[-6000:]}
            with open(args.out, "a") as fh:
                fh.write(json.dumps(row) + "\n")
            results.setdefault(cell, []).append(row)
            ok = result is not None and result["correct"]
            print(f"{cell} seed {seed}: rc {proc.returncode}, wall "
                  f"{wall:.1f} s, correct {ok}; "
                  + (json.dumps({k: v["value"] for k, v in
                                 result["compared"].items()})
                     + " " + json.dumps({k: v["value"] for k, v in
                                         result["metrics"].items()})
                     if result else proc.stderr[-1500:]), flush=True)
    for cell, rows in results.items():
        done = [r["result"] for r in rows if r["result"]]
        names = sorted({k for r in done for k in r["metrics"]})
        for name in names:
            values = [r["metrics"][name]["value"] for r in done
                      if name in r["metrics"]]
            med, sp = spread(values)
            print(f"{cell} {name}: n {len(values)} median {med!r} spread "
                  f"{sp!r} values {values}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

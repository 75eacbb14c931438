"""Run one cell of the benchmark of ``ceres_tpu_torch`` on one NVIDIA card.

    python3 raybench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``compared``: each number held to the reference, with its limit.
The same numbers end standard error. Without a card it exits with an
error and prints no result: there is no CPU fallback. The card's name
and power limit go to standard error first. A cell over N cards starts
its N - 1 other ranks first (``ranks.py``). It exits 3 with no result
when this process, or any other rank, holds JAX or the JAX package once
the window has closed, and names the modules and the rank on standard
error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Module names that the run may not hold once the window has closed,
# compared with each loaded module's top-level name as a whole word.
FORBIDDEN = {"jax", "jaxlib", "flax", "ceres_tpu"}


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the
    loaded modules)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def finite(result: dict) -> dict:
    """The result with every metric whose value is not a finite number
    left out, and every compared number that is not finite as null, so
    that the line stays JSON (``correct`` is already false then)."""
    result["metrics"] = {k: m for k, m in result["metrics"].items()
                         if math.isfinite(m["value"])}
    for row in result["compared"].values():
        if not math.isfinite(row["value"]):
            row["value"] = None
    return result


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        out = f"nvidia-smi failed: {exc}"
    return out.splitlines()[0] if out else "nvidia-smi: no output"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, ROOT)
    from raybench import manifest, ranks

    chips = {w["name"]: w for w in manifest.load(ROOT)["workloads"]}.get(
        args.workload, {}).get("chips", 1)
    if chips > 1:
        # The other ranks load torch and the port while this one does.
        ranks.prestart(chips)
    import torch

    from raybench import harness

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        ranks.unstart()
        print(f"raybench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    harness.log(f"card: {card_line()}; torch {torch.__version__}, CUDA "
                f"{torch.version.cuda}")
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    found = dict(ranks.FOUND)
    if forbidden_modules():
        found[0] = forbidden_modules()
    if found:
        for rank, names in sorted(found.items()):
            print(f"raybench: rank {rank} of the run loaded "
                  f"{', '.join(names)}", file=sys.stderr)
        return 3
    print(json.dumps(finite(result), allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())

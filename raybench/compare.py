"""The numbers that decide ``correct``: what the timed path produced,
against the plain reference (``reference.py``) on the same inputs.

Frames (each compared frame: one drawn from the seed among the window's
first ``draw_from`` frames, and the window's last):
  px_off_pct  share of pixels, in %, whose colour differs from the
              reference's by more than ``PX_TOL`` in some channel;
  rays_gap    |rays - reference rays| / reference rays;
  hits_gap    |hits - reference hits| / reference hits;
each the worst over the compared frames.

Fit (the first ``held_steps`` steps of the timed step, which the
reference follows from the same start with plain Adam):
  loss_gap    the worst step's |loss - reference loss| / reference loss;
  grad_gap    the worst leaf's | |g1| - |g1 ref| | over the larger of
              |g1 ref| of that leaf and of the median leaf, g1 the first
              gradient as Adam got it;
  last_grad_gap  the same of the last held step's gradient, which a
              replay of the captured step computed (the first step is
              the capture's eager warm-up): worked out from Adam's first
              moments m after the last two steps, (m_n - beta1 m_(n-1))
              / (1 - beta1);
  change_gap  the same of the parameters' change over the held steps,
              leaving out leaves whose reference gradient is under a
              thousandth of the median leaf's.
"""

from __future__ import annotations

import math
import statistics

import torch

from raybench import reference

PX_TOL = 1e-3


def frame_numbers(image, stats, ref_image, ref_stats) -> dict:
    d = (image.float() - ref_image.float()).abs().amax(-1)
    return {"px_off_pct": 100.0 * float((d > PX_TOL).double().mean()),
            "rays_gap": abs(int(stats["rays"]) - ref_stats["rays"])
            / ref_stats["rays"],
            "hits_gap": abs(int(stats["hits"]) - ref_stats["hits"])
            / max(ref_stats["hits"], 1)}


def worst(parts) -> dict:
    out = {}
    for numbers in parts:
        for k, x in numbers.items():
            out[k] = x if math.isnan(x) else max(out.get(k, x), x)
    return out


def frames(kept, sc) -> dict:
    """``kept``: [(image, stats, vertices, sun)] of the compared frames;
    ``sc``: the ``loops.Scene`` they were rendered from."""
    faces = torch.as_tensor(sc.f, device=sc.vt.device).long()
    eye = torch.as_tensor(sc.cam["eye"], device=sc.vt.device)
    parts = []
    for image, stats, vertices, sun in kept:
        ref_image, ref_stats = reference.frame(vertices, faces, eye, sc.cam,
                                               sun, sc.width, sc.height)
        parts.append(frame_numbers(image, stats, ref_image, ref_stats))
        del ref_image
    return worst(parts)


def reference_fit(start, sc, target, steps, lr, dtype=torch.float32):
    """The reference's (losses, first gradients, parameters, last
    gradients) of ``steps`` Adam steps from ``start`` ({"vertices",
    "eye"})."""
    faces = torch.as_tensor(sc.f, device=sc.vt.device).long()

    def grad_of(params):
        p = {k: x.detach().to(dtype).requires_grad_()
             for k, x in params.items()}
        image, _ = reference.frame(p["vertices"], faces, p["eye"], sc.cam,
                                   sc.sun_t, sc.width, sc.height, dtype)
        value = reference.loss(image, target)
        value.backward()
        return value.item(), {k: x.grad.float() for k, x in p.items()}

    return reference.adam_steps(start, grad_of, steps, lr)


def norm_gap(got: dict, ref: dict) -> float:
    """The worst leaf's gap of norms, | |got| - |ref| |, over the larger
    of that leaf's and the median leaf's reference norm."""
    n_ref = {k: float(x.norm()) for k, x in ref.items()}
    n_med = statistics.median(n_ref.values())
    return max(abs(float(got[k].norm()) - n_ref[k]) / max(n_ref[k], n_med)
               for k in n_ref)


def fit_numbers(held, start, ref_losses, ref_first, ref_params,
                ref_last) -> dict:
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(held["losses"], ref_losses))
    g_ref = {k: float(x.norm()) for k, x in ref_first.items()}
    g_med = statistics.median(g_ref.values())
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    d_ref = {k: float((ref_params[k] - start[k]).norm()) for k in moved}
    d_med = statistics.median(d_ref.values())
    change_gap = max(abs(float((held["params"][k] - start[k]).norm())
                         - d_ref[k]) / max(d_ref[k], d_med) for k in moved)
    return {"loss_gap": loss_gap,
            "grad_gap": norm_gap(held["first"], ref_first),
            "last_grad_gap": norm_gap(held["last"], ref_last),
            "change_gap": change_gap}


def judge(numbers: dict, limits: dict):
    """(correct, [(name, number, limit)]): every number at or under its
    limit; a NaN or a missing number is not."""
    rows = [(k, numbers.get(k, float("nan")), lim)
            for k, lim in limits.items()]
    return all(x <= lim for _, x, lim in rows), rows

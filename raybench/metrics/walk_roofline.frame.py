"""walk_roofline.frame: the least time the card could take for a frame's
walks over the walk kernels' device time a frame, in %.

The least time is, for each walk of the frame, the larger of its pairs
times the fp32 operations a pair over 67 TFLOP/s and its bytes over
3.35 TB/s (``roofline.bound``). The visits and pairs are what the walk's
inputs need, counted by the frozen plain walk (``walkcount.py``) on the
inputs of the walk entry points, recorded during one eager
``render_pipeline`` of the first traced frame's inputs; never what the
kernel reports. The kernel time is from the trace of the cell's frames.
Layer: the kernels. Moves rays_per_s."""

from raybench import roofline, walkcount

UNIT = "%"
LAYER = "kernels"
MOVES = "rays_per_s"
# Kernels of ceres_tpu_torch/ops/csrc/walk.cu, by the name the trace
# gives them, and the port's walk entry points.
WALK_KERNELS = ("walk_solo", "walk_tile", "split_walk", "split_list",
                "split_more", "split_replay")
ENTRY_POINTS = {"walk_closest": "closest", "walk_any_dest": "any_dest",
                "walk_any": "any"}


def recorded_walks(run_frame):
    """[(mode, args, opts)] of every walk entry point that
    ``run_frame()`` calls."""
    import torch
    from ceres_tpu_torch.ops import walk

    seen, saved = [], {n: getattr(walk, n) for n in ENTRY_POINTS}

    def recorder(name, fn):
        def call(*args, **opts):
            mode = ENTRY_POINTS[name]
            if opts.get("window"):
                mode = "closest_window"
            seen.append((mode, args, opts))
            return fn(*args, **opts)
        return call

    try:
        for name, fn in saved.items():
            setattr(walk, name, recorder(name, fn))
        run_frame()
        torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(walk, name, fn)
    return seen


def walks(ctx):
    """[(mode, visits, pairs, least seconds, bound by)] of the first
    traced frame's walks, counted once a run (``ctx.cache``)."""
    if "walks" not in ctx.cache:
        frame = ctx.next_call - ctx.trace.calls
        rows = []
        for mode, args, opts in recorded_walks(lambda: ctx.loop.eager(frame)):
            if mode.startswith("closest"):
                visits, pairs = walkcount.closest(*args[:4], opts)
            else:
                visits, pairs = walkcount.occlusion(mode, *args[:5], opts)
            visits = int(visits.sum())
            least, by = roofline.bound(mode, args, opts, visits, pairs)
            ctx.note(f"walk {mode} S {opts.get('S', 1)}: {visits} visits, "
                     f"{pairs} pairs, least {least * 1e3:.6f} ms by {by}")
            rows.append((mode, visits, pairs, least, by))
        ctx.cache["walks"] = rows
    return ctx.cache["walks"]


def read(ctx):
    tr = ctx.trace
    if (tr is None or not tr.device
            or ctx.cell["traffic"]["kind"] != "frames"):
        return None
    walk_ms = tr.device_ms_per_call(
        lambda name: any(k in name for k in WALK_KERNELS))
    if walk_ms <= 0:
        return None
    least = sum(row[3] for row in walks(ctx))
    ctx.note(f"walk kernels {walk_ms:.6f} ms a frame (trace), least "
             f"{least * 1e3:.6f} ms")
    return 100.0 * least * 1e3 / walk_ms

"""walk_roofline.f64: the least time the card could take for a
float64-exact frame's walks over the float64 walk kernel's device time a
frame, in %.

The least time is, for each float64 walk of the frame, the larger of its
pairs times the float64 operations a pair over 34 TFLOP/s (the H100
SXM's float64 rate outside the tensor cores: the ray-triangle test is
no matrix product) and its bytes over 3.35 TB/s
(``walkcount_f64.bound``). The visits and pairs are what the walk's
inputs need, counted by the frozen plain frontier rule
(``walkcount_f64.count``) on the inputs of the port's float64 walk
(``ops.walk_f64._walk``), recorded during one eager ``render_pipeline``
of the first traced frame's inputs; never what the kernel reports. The
kernel time is from the trace of the cell's frames (kernels named
``walk_f64_kernel``). With ``--fmad=false`` a multiply and an add are
two instructions, so the kernel's ceiling is about half of this peak.
None where the trace holds no such kernel; raises where the cell's loop
is not the kind ``frames_f64``'s (``own``). Layer: the kernels. Moves
rays_per_s."""

from raybench import loops, walkcount_f64

UNIT = "%"
LAYER = "kernels"
MOVES = "rays_per_s"
KERNEL = "walk_f64_kernel"
NAMES = ("cs", "weights", "order", "ent", "counts", "d3", "o3", "alive",
         "tcap", "tmin", "tmax", "occ0")


def recorded_walks(run_frame):
    """[(mode, inputs)] of every float64 walk that ``run_frame()`` makes,
    inputs by name as ``ops.walk_f64._walk`` takes them."""
    import torch
    from ceres_tpu_torch.ops import walk_f64

    real, seen = walk_f64._walk, []

    def recorder(*args, mode, **opts):
        seen.append((mode, dict(zip(NAMES, args), **{
            k: v for k, v in opts.items() if k in NAMES})))
        return real(*args, mode=mode, **opts)

    walk_f64._walk = recorder
    try:
        run_frame()
        torch.cuda.synchronize()
    finally:
        walk_f64._walk = real
    return seen


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or not ctx.cell["config"].get("f64_exact"):
        return None
    loops.kind(ctx.root, "frames_f64").own(ctx)
    walk_ms = tr.device_ms_per_call(lambda name: KERNEL in name)
    if walk_ms <= 0:
        return None
    frame = ctx.next_call - ctx.trace.calls
    least = 0.0
    for mode, inputs in recorded_walks(lambda: ctx.loop.eager(frame)):
        cs = inputs.pop("cs")
        visits, pairs = walkcount_f64.count(cs.e1, cs.e2, mode=mode,
                                            **inputs)
        visits = int(visits.sum())
        t, by = walkcount_f64.bound(mode, inputs, visits, pairs)
        ctx.note(f"float64 walk {mode}: {visits} visits, {pairs} pairs, "
                 f"least {t * 1e3:.6f} ms by {by}")
        least += t
    ctx.note(f"float64 walk kernel {walk_ms:.6f} ms a frame (trace), least "
             f"{least * 1e3:.6f} ms")
    return 100.0 * least * 1e3 / walk_ms

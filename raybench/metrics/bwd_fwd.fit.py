"""bwd_fwd.fit: step_ms / forward_ms - 1 from the medians of CUDA-event
times of STEPS train steps and STEPS forwards, alternated in one
process. The step is the cell's own (replayed graph); the forward is
the same frame and loss under ``torch.no_grad()`` (the refitted cut,
``render_pipeline``, ``image_loss``), captured as a CUDA graph and
replayed. Both sets' quartiles go to standard error. Layer: the train
step. Moves step_ms."""

import statistics

UNIT = "ratio"
LAYER = "train step"
MOVES = "step_ms"
STEPS = 20


def _timed(fn):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def read(ctx):
    loop = ctx.loop
    if ctx.dev.type != "cuda" or ctx.cell["traffic"]["kind"] != "fit":
        return None
    from ceres_tpu_torch.utils.graphs import capture

    forward = capture(loop.forward, list(loop.state.params.values()))

    def step():
        loop.state, _ = loop.step(loop.state, loop.target)

    step()
    forward.replay()
    step_t, fwd_t = [], []
    for _ in range(STEPS):
        step_t.append(_timed(step))
        fwd_t.append(_timed(forward.replay))
    q_s = statistics.quantiles(step_t, n=4)
    q_f = statistics.quantiles(fwd_t, n=4)
    ctx.note(f"bwd_fwd.fit: step ms quartiles {q_s[0]:.6f} {q_s[1]:.6f} "
             f"{q_s[2]:.6f}; forward ms quartiles {q_f[0]:.6f} "
             f"{q_f[1]:.6f} {q_f[2]:.6f} ({STEPS} of each, alternated)")
    del forward
    return statistics.median(step_t) / statistics.median(fwd_t) - 1.0

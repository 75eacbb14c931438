"""bwd_fwd_span.fit: the port's ``step.backward`` span over its
``step.forward`` and ``step.loss`` spans, in the replayed train step,
the median over as many spanned steps as the trace took
(``raybench/spans.py``). Layer: the train step. Moves step_ms."""

from raybench import spans

UNIT = "ratio"
LAYER = "train step"
MOVES = "step_ms"


def _ratio(ms):
    forward = spans.total(ms, "step.forward") + spans.total(ms, "step.loss")
    if "step.backward" not in ms or forward <= 0:
        return None
    return ms["step.backward"]["total"] / forward


def read(ctx):
    if ctx.cell["traffic"]["kind"] != "fit":
        return None
    return spans.median_of(ctx, _ratio)

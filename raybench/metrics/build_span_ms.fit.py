"""build_span_ms.fit: device milliseconds a step in the port's ``build``
spans inside the replayed train step that builds its cut (the LBVH
treelet cut and the winner table of the step's vertices), the median
over as many spanned steps as the trace took (``raybench/spans.py``, its
second loop this cell's own kind, ``kinds/fit_rebuild.py``). Layer:
accel (device). Moves step_ms."""

from raybench import loops

UNIT = "ms"
LAYER = "accel (device)"
MOVES = "step_ms"


def read(ctx):
    if ctx.cell["traffic"]["kind"] != "fit":
        return None
    return loops.kind(ctx.root, "fit_rebuild").span_ms(ctx, "build")

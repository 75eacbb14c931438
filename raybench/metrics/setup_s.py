"""setup_s: seconds from the start of the process to the first timed
frame or step: imports, the card's context, the mesh, the cut, the
graph's warm-up and capture, and the warm-up calls (host clock), less
the seconds of the reference's work in set-up (the fit's target
frame)."""

UNIT = "s"


def read(ctx):
    return ctx.window["setup_s"]

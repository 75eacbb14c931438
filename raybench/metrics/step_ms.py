"""step_ms: the window's milliseconds over the steps completed in it; a
step ends when its loss has been read on the host (host clock)."""

UNIT = "ms"


def read(ctx):
    if ctx.cell["traffic"]["kind"] != "fit":
        return None
    return 1e3 * ctx.window["seconds"] / ctx.window["calls"]

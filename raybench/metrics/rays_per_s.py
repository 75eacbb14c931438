"""rays_per_s: the rays of every frame completed in the window (each
frame's ``stats["rays"]``: pixels plus primary hits, summed on the card
and read once), over the window's seconds (host clock, from the start
of the first frame to the end of the last one's synchronise)."""

UNIT = "rays/s"


def read(ctx):
    if ctx.cell["traffic"]["kind"] != "frames":
        return None
    return ctx.window["rays"] / ctx.window["seconds"]

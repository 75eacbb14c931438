"""rays_per_s.frames4: the rays of every batch completed in the window
(each batch's ``stats["rays"]``: pixels plus primary hits, summed by the
port over the batch's frames and the ranks, summed on the card and read
once), over the window's seconds (host clock, from the hand-off of the
first batch to the end of the synchronise that makes rank 0's last
assembled batch ready)."""

UNIT = "rays/s"


def read(ctx):
    return ctx.window["rays"] / ctx.window["seconds"]

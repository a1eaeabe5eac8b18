"""points_per_s: spectral points of every forward call completed in the
window over the window's seconds (host clock; the window runs from the
first call's start to the last call's end)."""


def read(ctx):
    return ctx.calls * ctx.points / ctx.seconds

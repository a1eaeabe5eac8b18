"""setup_s: from the process's start to the window's start (host clock):
import, kernel build (first run only), model build, warm-up call."""


def read(ctx):
    return ctx.setup_s

"""jacobian_s: the window's seconds over the Jacobians completed in it
(host clock); each Jacobian is the radiance and its three columns."""


def read(ctx):
    return ctx.seconds / ctx.calls

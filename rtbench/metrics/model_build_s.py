"""model_build_s: host seconds of model_from_parameters in set-up, ended by
a synchronize (a span of the benchmark's own, around the program's call)."""


def read(ctx):
    return ctx.spans.get("model_build")

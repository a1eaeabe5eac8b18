"""step_mfu.fwd: the whole forward call's share (%) of the card's float32
peak (67 TFLOP/s outside the tensor cores): the layer steps' products
counted by rtbench.roofline over the traced calls, over their wall on the
host's clock times the peak. Elementwise work and the elemental layers are
left out of the count. It bounds layer_step_roofline from the whole call:
a change that takes the layer kernels off the path leaves the roofline
with nothing to read, and this still reads."""
from rtbench import roofline


def read(ctx):
    if ctx.trace is None or ctx.trace.wall_s <= 0:
        return None
    work = [w for call in ctx.trace.work for w in call]
    if not work:
        return None
    return 100.0 * roofline.flops(work) / (ctx.trace.wall_s
                                           * roofline.PEAK_FP32_FLOPS)

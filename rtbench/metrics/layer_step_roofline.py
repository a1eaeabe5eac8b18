"""layer_step_roofline: the share (%) of the layer step's roofline that the
port's layer kernels reach over the traced forward calls: the least time
the card could take for the calls' layer steps (rtbench.roofline: products
over the float32 peak of 67 TFLOP/s outside the tensor cores, or bytes over
3.35 TB/s, whichever is larger), over the device time of the port's
kernels without the Voigt kernels. Nothing to read where no layer kernel
ran."""
from rtbench import roofline
from rtbench.trace import LAYER_EXCLUDE


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.device_time_s(
        lambda k: k is not None and not k.startswith(LAYER_EXCLUDE))
    work = [w for call in ctx.trace.work for w in call]
    if t <= 0 or not work:
        return None
    return 100.0 * roofline.bound_s(work) / t

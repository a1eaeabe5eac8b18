"""torch_ops_ms.fwd: device milliseconds a forward call of every device
event outside the port's kernels (torch ops, copies, sets), over the
traced calls."""
from rtbench.trace import outside_port_kernels_ms as read  # noqa: F401

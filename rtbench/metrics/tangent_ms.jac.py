"""tangent_ms.jac: device milliseconds a Jacobian of every device event
outside the port's kernels: almost all of it the plain versions' tangents
under torch.func, with the primal's torch ops."""
from rtbench.trace import outside_port_kernels_ms as read  # noqa: F401

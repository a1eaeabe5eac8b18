"""The work of the layer step, counted by the benchmark, and the card's
published peaks.

The count is the benchmark's own, so it reads the same work whatever
implements the step. Per spectral point and layer it follows the port's
``cuda/layer_step_kernel.py`` (``step_flops``, ``doubling_flops``,
``step_bytes``) with one change: each (I - B)^-1, one per doubling and one
for the adding under the composite, is counted once at the fixed cost of an
N x N inverse (``inverse_flops``), not by the Newton-Schulz iterations a
solver takes, so a change of solver, engine or fusion leaves the count as
it is. Elementwise work is left out. Bytes: the elemental layer and the
composite read once, the new composite written once, in float32.
"""

#: NVIDIA H100 SXM, float32 outside the tensor cores (data sheet, dense);
#: the peak the layer step's roofline share divides by
PEAK_FP32_FLOPS = 67e12
#: NVIDIA H100 SXM HBM3 bandwidth (data sheet)
PEAK_BYTES_PER_S = 3.35e12


def inverse_flops(n: int) -> int:
    """An N x N inverse by LU: 2/3 n^3 to factor, 4/3 n^3 to invert."""
    return 2 * n ** 3


def doubling_flops(n: int, nd: int) -> int:
    """Products of nd doublings of one point: r r, the inverse, r [t | jp |
    j1m], M W and t (M W)."""
    return nd * (2 * n * n * (n + (n + 2) + 2 * (2 * n + 2))
                 + inverse_flops(n))


def step_flops(n: int, nd: int) -> int:
    """Products of one point's layer step: the doublings, then the adding
    under the composite with its one inverse."""
    return doubling_flops(n, nd) + 2 * n * n * (
        n + 1 + n + 1 + (2 * n + 1) + n + (4 * n + 2)
        + 3 * (2 * n + 1)) + inverse_flops(n)


def step_bytes(n: int) -> int:
    """Device-memory bytes of one point's layer step (float32): the
    composite and the elemental layer read once, the new composite written
    once."""
    return 4 * ((4 * n * n + 2 * n) + (2 * n * n + 2 * n + 1)
                + (4 * n * n + 2 * n))


def bound_s(work) -> float:
    """The least time the card could take for the layer steps ``work``, a
    list of (n, points, doublings): per step the larger of its products
    over the float32 peak and its bytes over the bandwidth."""
    return sum(max(s * step_flops(n, nd) / PEAK_FP32_FLOPS,
                   s * step_bytes(n) / PEAK_BYTES_PER_S)
               for n, s, nd in work)


def flops(work) -> int:
    return sum(s * step_flops(n, nd) for n, s, nd in work)

"""Matrix-product precision modes of the RT engines.

Port of the JAX package's two precision mechanisms: ``batch_mm`` of
``vsmartmom/pallas/doubling_kernel.py:35-58``, which builds the modes by
hand inside its kernels, and ``jax.default_matmul_precision``, under which
``vsmartmom/core/rt_run.py:_fourier_step`` runs every XLA dot of a Fourier
moment. A mode names one function, on every device:

  "highest"  full float32 products (TF32 off), or the operands' own dtype;
  "high"     three bf16 passes d(a_hi, b_lo) + d(a_lo, b_hi) + d(a_hi, b_hi),
             summed in that order, with x_hi = bf16(x) and
             x_lo = bf16(x - x_hi) rounded to nearest even; "bf16x3" is its
             name for the split-form kernel (dd modes);
  "default"  one pass d(bf16(a), bf16(b)).
Each pass d multiplies bf16 values exactly and sums in float32, whatever
the operand dtype (``preferred_element_type=jnp.float32``); the result
takes the operands' dtype. TF32 is none of these and never turns on.

Where JAX's CPU backend and interpret mode run a reduced mode in float32,
the port computes the documented function on every device. The torch-op
engines take the active mode (``matmul_precision``) on float32 operands
only, so a float64 run ignores it, as JAX's CPU does; the kernels' plain
versions take their ``precision`` whatever the dtype, as JAX's interpret
mode does.
"""
from __future__ import annotations

import contextlib
import threading

import torch

#: the modes of ``matmul_precision`` (the JAX package's names)
MATMUL_MODES = ("highest", "high", "default")
#: the modes of the split-form kernel (``dd_precision``; JAX's
#: ``fused_layer_step_dev`` names "high" bf16x3)
DD_MODES = ("bf16x3", "highest", "default")

_state = threading.local()


def check_mode(mode: str, modes=MATMUL_MODES) -> str:
    """``mode`` if it is one of ``modes``, else ValueError."""
    if mode not in modes:
        raise ValueError(f"unknown precision {mode!r}: expected one of "
                         f"{modes}")
    return mode


def resolve_dd(matmul_precision: str, dd_precision=None) -> str:
    """The split-form kernel's mode: ``dd_precision``, or where it is None
    "highest" for matmul_precision "highest" and "bf16x3" otherwise
    (vsmartmom/core/rt_run.py:710-719, whose environment override
    VSM_DD_PRECISION is this keyword here)."""
    check_mode(matmul_precision)
    if dd_precision is None:
        return "highest" if matmul_precision == "highest" else "bf16x3"
    return check_mode(dd_precision, DD_MODES)


def _split(x):
    """(x_hi, x_lo) as float32 tensors of bf16 values: x_hi = bf16(x),
    x_lo = bf16(x - x_hi); x - x_hi is exact in x's dtype."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _bf16x3(a, b):
    ah, al = _split(a)
    bh, bl = _split(b)
    return ((torch.matmul(ah, bl) + torch.matmul(al, bh))
            + torch.matmul(ah, bh)).to(a.dtype)


def _bf16x1(a, b):
    return torch.matmul(a.to(torch.bfloat16).float(),
                        b.to(torch.bfloat16).float()).to(a.dtype)


def batch_mm(precision: str):
    """The batched product (..., N, N) @ (..., N, K) of one mode
    ("highest", "high" or "bf16x3", "default"; module docstring): the
    counterpart of the JAX package's batch_mm, term for term. Broadcasts
    as torch.matmul does."""
    if precision == "highest":
        return torch.matmul
    if precision in ("high", "bf16x3"):
        return _bf16x3
    if precision == "default":
        return _bf16x1
    raise ValueError(f"unknown precision {precision!r}: expected one of "
                     f"{MATMUL_MODES + ('bf16x3',)}")


def batch_mm_tangent(precision: str):
    """The tangent of batch_mm(precision) as torch.func.jvp takes it:
    (a, da, b, db) -> d(a @ b), each pass's d(a, db) + d(da, b) (the split
    of a tangent is the split's tangent), the passes summed as batch_mm
    sums them. Broadcasts as torch.matmul does."""
    if precision == "highest":
        return lambda a, da, b, db: torch.matmul(da, b) + torch.matmul(a, db)
    if precision in ("high", "bf16x3"):
        def high(a, da, b, db):
            (ah, al), (dah, dal) = _split(a), _split(da)
            (bh, bl), (dbh, dbl) = _split(b), _split(db)
            return (((torch.matmul(dah, bl) + torch.matmul(ah, dbl))
                     + (torch.matmul(dal, bh) + torch.matmul(al, dbh)))
                    + (torch.matmul(dah, bh) + torch.matmul(ah, dbh))
                    ).to(da.dtype)
        return high
    if precision == "default":
        def one(a, da, b, db):
            def h(x):
                return x.to(torch.bfloat16).float()
            return (torch.matmul(h(da), h(b))
                    + torch.matmul(h(a), h(db))).to(da.dtype)
        return one
    raise ValueError(f"unknown precision {precision!r}: expected one of "
                     f"{MATMUL_MODES + ('bf16x3',)}")


def active(slot: str = "matmul") -> str:
    """The mode set for ``slot`` in this thread ("matmul": the RT engines'
    products; "ie": the Raman ie products), "highest" outside any block."""
    return getattr(_state, slot, "highest")


def product(a, b, mode: str):
    """a @ b in ``mode`` on float32 operands; any other dtype ignores the
    mode (the torch-op engines' rule)."""
    if mode == "highest" or a.dtype != torch.float32:
        return torch.matmul(a, b)
    return batch_mm(mode)(a, b)


@contextlib.contextmanager
def scoped(slot: str, mode: str, modes=MATMUL_MODES):
    """``active(slot)`` is ``mode`` inside the block, the previous mode
    after it (this thread only)."""
    check_mode(mode, modes)
    prev = active(slot)
    setattr(_state, slot, mode)
    try:
        yield
    finally:
        setattr(_state, slot, prev)


@contextlib.contextmanager
def matmul_precision(mode: str = "highest"):
    """The counterpart of ``jax.default_matmul_precision``: inside the
    block the torch-op engines (core/rt.py) compute their float32 products
    in ``mode``; float32 matmuls run in full float32 (TF32 off), the
    previous settings restored after it."""
    prev_precision = torch.get_float32_matmul_precision()
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    with scoped("matmul", mode):
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(prev_precision)
            torch.backends.cuda.matmul.allow_tf32 = prev_tf32


def mm(a, b):
    """The torch-op engines' batched product, in the active mode."""
    return product(a, b, active())

"""The comparison that decides ``correct``, driven through a whole run on the
CPU at a small size: sound runs come out correct; the control (the plain
reference with its products rounded to bfloat16, in the program's place)
and each fault planted under the timed path come out not correct.

On the CPU the program's default solver is LU, whose doubling counts follow
each layer's own depth; the card runs the schulz solver's static counts,
which the reference follows. The fixture gives the CPU run the card's
solver, so both sides discretize alike, as on the card. The look for a card
is skipped: ``run_cell`` is the run after it.
"""
import os
from unittest import mock

import numpy as np
import pytest
import torch

from rtbench import run

TINY = os.path.join(os.path.dirname(__file__), "data", "o2a_tiny.yaml")
SEED = 2 ** 31 + 12345


@pytest.fixture(autouse=True)
def card_solver():
    import vsmartmom_torch.core.rt_run as rr
    torch.set_num_threads(2)
    with mock.patch.object(rr, "default_solver",
                           lambda device, solver: solver or "schulz"):
        yield


def run_tiny(cell, control=False):
    return run.run_cell(cell, SEED, 0.0, False, device="cpu",
                        config_path=TINY, control=control,
                        log=lambda s: None)


def _zero_half(R):
    R = np.array(R)
    R[..., R.shape[-1] // 2:] = 0.0
    return R


def _alter_one(R):
    R = np.array(R)
    R[..., 1] = -R[..., 1]
    return R


def forward_fault(name):
    """A patch that breaks the forward path underneath ``rt_run``."""
    import vsmartmom_torch.core.api as api
    import vsmartmom_torch.core.rt_run as rr
    band = api.rt_run_band
    if name == "state_unchanged":
        return mock.patch.object(rr, "interaction",
                                 lambda comp, added, eye, rsolve=None: comp)
    if name == "half_left_out":
        return mock.patch.object(api, "rt_run_band", lambda *a, **k: tuple(
            _zero_half(x) for x in band(*a, **k)))
    return mock.patch.object(api, "rt_run_band", lambda *a, **k: tuple(
        _alter_one(x) for x in band(*a, **k)))


def jacobian_fault(name):
    """A patch that breaks the Jacobian path underneath ``jacfwd``."""
    import vsmartmom_torch.core.autodiff as ad
    import vsmartmom_torch.cuda.layer_step_kernel as lsk
    make = ad.make_radiance_fn
    if name == "state_unchanged":
        return mock.patch.object(lsk, "fused_layer_step",
                                 lambda comp, *a, **k: comp)

    def wrapped(*a, **k):
        fn = make(*a, **k)

        def radiance(*args):
            R = fn(*args)
            if name == "half_left_out":
                keep = torch.arange(R.shape[-1]) < R.shape[-1] // 2
                return torch.where(keep, R, 0.0)
            bump = torch.zeros(R.shape[-1], dtype=R.dtype)
            bump[1] = 1.0
            return R * (1.0 + bump * args[3])     # alters dR/d albedo
        return radiance
    return mock.patch.object(ad, "make_radiance_fn", wrapped)


@pytest.mark.parametrize("cell", ["o2a-fwd", "o2a-jac"])
def test_sound_run_is_correct(cell):
    result = run_tiny(cell)
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("cell", ["o2a-fwd", "o2a-jac"])
def test_control_is_not_correct(cell):
    result = run_tiny(cell, control=True)
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", ["o2a-fwd", "o2a-jac"])
def test_fault_is_not_correct(cell, fault):
    patch = forward_fault(fault) if cell.endswith("fwd") \
        else jacobian_fault(fault)
    with patch:
        result = run_tiny(cell)
    assert not result["correct"], result["compared"]

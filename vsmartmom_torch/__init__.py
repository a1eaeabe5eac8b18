"""vsmartmom_torch: the PyTorch/CUDA port of vsmartmom.

Polarized doubling-adding radiative transfer with HITRAN line-by-line
absorption and Mie/NAI2 aerosols, batched over the hyperspectral axis, and
its first-order Raman (inelastic) coupling: ``rt_run(model, rs_type=...)``
with rotational (RRS), vibrational (VS) and concatenated-band specs
(``inelastic/``, ``core/rt_raman.py``). Host set-up is numpy; device work
is torch on an explicit ``device``; the hot kernels of the elastic path
(the layer step in its forms, the layer scan and the tiled Voigt line sum)
are CUDA C++ for Hopper (``csrc/``), built at first use. The Raman path
is torch ops. Forward-mode AD goes through ``torch.func``
(``core/autodiff.py``, ``scattering/mie_ad.py``, the cross-section's
``autodiff``); the two fused layer-step kernels carry a forward rule.

Public API (mirrors the JAX package):
  parameters_from_yaml, default_parameters, model_from_parameters, rt_run
"""

from vsmartmom_torch.config.params import (default_parameters,
                                           parameters_from_yaml)
from vsmartmom_torch.core.api import rt_run
from vsmartmom_torch.core.model import model_from_parameters

__version__ = "0.1.0"

__all__ = ["parameters_from_yaml", "default_parameters",
           "model_from_parameters", "rt_run", "__version__"]

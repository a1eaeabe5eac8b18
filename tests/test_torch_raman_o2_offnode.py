"""The reference's O2 A-band Raman configuration through the port and the
JAX package as written: tests/data/ref_yaml/O2Parameters.yaml with its band
re-gridded from 0.05 to 2 cm^-1 (171 points) and its 60 deg views moved to
60.0001 deg, off the Gauss node 0.5 (test_torch_raman_o2.py runs the file's
own views, where the JAX package's ie_elemental loses every digit between
the two nodes and is wrapped). rt_run(model, rs_type="RRS") within 1e-9 of
max per field, with nothing of either package replaced.
"""
import os

import numpy as np
import torch

from vsmartmom.config.params import parameters_from_yaml as jax_params
from vsmartmom.core.api import rt_run as jax_rt_run
from vsmartmom.core.model import model_from_parameters as jax_model

from vsmartmom_torch.config.params import parameters_from_yaml
from vsmartmom_torch.core.api import rt_run
from vsmartmom_torch.core.model import model_from_parameters

torch.set_num_threads(2)

YAML = os.path.join(os.path.dirname(__file__), "data", "ref_yaml",
                    "O2Parameters.yaml")
VZA_OFF_NODE = 60.0001


def _regrid_off_node(params):
    band = np.asarray(params.spec_bands[0])
    params.spec_bands = [np.arange(band[0], band[-1], 2.0)]
    params.vza = np.where(params.vza == 60.0, VZA_OFF_NODE, params.vza)
    return params


def test_o2parameters_rrs_off_node_matches_jax():
    params = _regrid_off_node(parameters_from_yaml(YAML))
    assert sorted(set(params.vza)) == [30.0, VZA_OFF_NODE]
    got = rt_run(model_from_parameters(params, device="cpu"), rs_type="RRS",
                 device="cpu")
    want = jax_rt_run(jax_model(_regrid_off_node(jax_params(YAML))),
                      rs_type="RRS")
    assert got[0].shape == (4, 3, 171)
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.isfinite(a).all()
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= 1e-9, (i, err)

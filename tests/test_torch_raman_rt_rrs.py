"""rt_run(model, rs_type="RRS") of the port against the JAX package on
rayleigh_benchmark.yaml, cut as tests/test_api.py cuts it: every field
within 1e-9 of its max (float64). One JAX run a file, so that the runs go
to different workers."""
import pytest

from vsmartmom.config.params import parameters_from_yaml as jax_params
from vsmartmom.core.api import rt_run as jax_rt_run
from vsmartmom.core.model import model_from_parameters as jax_model

from vsmartmom_torch.config.params import parameters_from_yaml
from vsmartmom_torch.core.api import rt_run
from vsmartmom_torch.core.model import model_from_parameters

from test_torch_raman_ms import DATA, _close, _cut


@pytest.fixture(scope="module")
def models():
    path = f"{DATA}/rayleigh_benchmark.yaml"
    return (model_from_parameters(_cut(parameters_from_yaml(path)),
                                  device="cpu"),
            jax_model(_cut(jax_params(path))))


def test_rt_run_raman_rrs_matches_jax(models):
    model, jmodel = models
    got = rt_run(model, rs_type="RRS", device="cpu")
    want = jax_rt_run(jmodel, rs_type="RRS")
    _close(got, want, what="RRS")

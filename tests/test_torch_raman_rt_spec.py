"""rt_run(model, rs_type=spec) of the port against the JAX package with an
RRS coupling spec used as it is, on rayleigh_benchmark.yaml cut as
tests/test_api.py cuts it: every field within 1e-9 of its max (float64).
One JAX run a file, so that the runs go to different workers."""
import pytest

from vsmartmom.config.params import parameters_from_yaml as jax_params
from vsmartmom.core.api import rt_run as jax_rt_run
from vsmartmom.core.model import model_from_parameters as jax_model
from vsmartmom.inelastic.rrs import make_rrs as jax_make_rrs

from vsmartmom_torch.config.params import parameters_from_yaml
from vsmartmom_torch.core.api import rt_run
from vsmartmom_torch.core.model import model_from_parameters
from vsmartmom_torch.inelastic import make_rrs

from test_torch_raman_ms import DATA, _close, _cut


@pytest.fixture(scope="module")
def models():
    path = f"{DATA}/rayleigh_benchmark.yaml"
    return (model_from_parameters(_cut(parameters_from_yaml(path)),
                                  device="cpu"),
            jax_model(_cut(jax_params(path))))


def test_rt_run_raman_spec_matches_jax(models):
    model, jmodel = models
    grid = model.params.spec_bands[0]
    got = rt_run(model, rs_type=make_rrs(grid, T=250.0), device="cpu")
    want = jax_rt_run(jmodel, rs_type=jax_make_rrs(grid, T=250.0))
    _close(got, want, what="spec")

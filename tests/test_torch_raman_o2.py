"""The reference's O2 A-band Raman configuration through the port and the
JAX package: tests/data/ref_yaml/O2Parameters.yaml as written (Stokes_IQU,
GaussQuadHemisphere l_trunc 5: N = 15, 5 layers, 3 moments, Float64, an
aerosol, O2 lines), its band re-gridded from 0.05 to 2 cm^-1 (171 points),
rt_run(model, rs_type="RRS") within 1e-9 of max per field.

Its 60 deg view lies 1 ulp from the Gauss node 0.5. Between two such nodes
the JAX package's ie_elemental subtracts two equal exponentials (T^++ and
the solar source at equal dtau) and loses every digit; the port forms
e^-a expm1(a - b) there (test_torch_raman.py::
test_view_on_a_quadrature_node). The JAX run here takes the same form:
its ie_elemental is wrapped for this test, everything else is the JAX
package's own. test_torch_raman_o2_offnode.py moves the views off the node
and holds the JAX package as written.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import vsmartmom.core.rt_raman as jrr
from vsmartmom.config.params import parameters_from_yaml as jax_params
from vsmartmom.core.api import rt_run as jax_rt_run
from vsmartmom.core.model import model_from_parameters as jax_model

from vsmartmom_torch.config.params import parameters_from_yaml
from vsmartmom_torch.core.api import rt_run
from vsmartmom_torch.core.model import model_from_parameters

torch.set_num_threads(2)

YAML = os.path.join(os.path.dirname(__file__), "data", "ref_yaml",
                    "O2Parameters.yaml")
_JAX_IE_ELEMENTAL = jrr.ie_elemental


def _exp_quotient(a0, a1, x):
    """(e^-a1 - e^-a0) / x as e^-a0 expm1(x) / x (the port's form)."""
    big = jnp.abs(x) > 1e-10
    xs = jnp.where(big, x, 1.0)
    e0 = jnp.exp(-a0)
    return jnp.where(x > 80.0, (jnp.exp(-a1) - e0) / xs,
                     e0 * jnp.where(big, jnp.expm1(x) / xs, 1.0 + x / 2.0))


def jax_ie_elemental_expm1(shift, w_shift, dtau, f_rayl, tau_sum, z_pp_r,
                           z_mp_r, qp, wct2, wct02, i0_vec, i_mu0_n,
                           n_stokes, mu0_node):
    """The JAX package's ie_elemental with T^++ and the solar source J^+
    in the e^-a expm1(a - b) form; R^-+ and J^- are its own."""
    r_ie, _, _, iej_m = _JAX_IE_ELEMENTAL(
        shift, w_shift, dtau, f_rayl, tau_sum, z_pp_r, z_mp_r, qp, wct2,
        wct02, i0_vec, i_mu0_n, n_stokes, mu0_node)
    src, valid = jrr._as_rows(shift, dtau.shape[0])
    dt0_s = jrr.take0(dtau, src, valid)
    f0 = w_shift * jrr.take0(f_rayl, src, valid)
    dt0, dt1 = dt0_s[:, None, None], dtau[:, None, None]
    mu_i, mu_j = qp[:, None], qp[None, :]
    t_ie = (f0[:, None, None] * z_pp_r * (dt0 / mu_i)
            * _exp_quotient(dt0 / mu_j, dt1 / mu_i,
                            (mu_i * dt0 - mu_j * dt1) / (mu_i * mu_j))
            * wct2[None, None, :])
    node = jnp.arange(qp.shape[0]) // n_stokes
    keep = (wct2 > 1e-8)[None, :] & ~((node[:, None] == node[None, :])
                                       & ~jnp.eye(qp.shape[0], dtype=bool))
    t_ie = jnp.where(keep[None], t_ie, 0.0)
    dt0v, dt1v, mu_v = dt0_s[:, None], dtau[:, None], qp[None, :]
    iej_p = (wct02 * f0[:, None] * (z_pp_r @ i0_vec)[None, :]
             * (dt0v / mu_v)
             * _exp_quotient(dt0v / mu0_node, dt1v / mu_v,
                             (mu_v * dt0v - mu0_node * dt1v)
                             / (mu_v * mu0_node)))
    atten = jnp.exp(-jrr.take0(tau_sum, src, valid) / mu0_node)[:, None]
    return r_ie, t_ie, iej_p * atten, iej_m


def _regrid(params):
    band = np.asarray(params.spec_bands[0])
    params.spec_bands = [np.arange(band[0], band[-1], 2.0)]
    return params


def test_o2parameters_rrs_matches_jax(monkeypatch):
    model = model_from_parameters(_regrid(parameters_from_yaml(YAML)),
                                  device="cpu")
    got = rt_run(model, rs_type="RRS", device="cpu")
    monkeypatch.setattr(jrr, "ie_elemental", jax_ie_elemental_expm1)
    jax.clear_caches()
    want = jax_rt_run(jax_model(_regrid(jax_params(YAML))), rs_type="RRS")
    assert got[0].shape == (4, 3, 171)
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.isfinite(a).all()
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= 1e-9, (i, err)
    # Raman fills in: ieR is positive in I wherever R is
    assert np.all(got[2][:, 0] > 0)

"""The port's spectral sharding (vsmartmom_torch/parallel/sharding.py) on
the CPU, mirroring tests/test_sharding.py on its bands (3 layers, 32
points, the same seeds).

The JAX package shards through XLA SPMD; the port splits the axis itself
and hands each shard the whole band's per-layer maxima of tau * omega and
surface albedo, and for Raman runs each shard on its halo. Gates: the
sharded port against JAX's unsharded run (elastic rtol 1e-10, atol 1e-14,
as tests/test_torch_rt.py; Raman rtol 1e-11, atol 1e-16, as
tests/test_sharding.py) and against the port's unsharded run (elastic rtol
1e-12, atol 1e-15; Raman rtol 1e-11, atol 1e-16). float64, LU on the CPU.
"""
import numpy as np
import pytest
import torch

from vsmartmom.core.rt_raman import rt_run_band_rrs as jax_rt_run_band_rrs
from vsmartmom.core.rt_run import BandRTInputs as JaxBand
from vsmartmom.core.rt_run import rt_run_band as jax_rt_run_band
from vsmartmom.inelastic.plus import AbsoluteRaman as JaxAbsoluteRaman
from vsmartmom.inelastic.rrs import RRS as JaxRRS
from vsmartmom.inelastic.rrs import greek_raman_coefs as jax_greek_raman
from vsmartmom.scattering.phase import Polarization as JaxPol
from vsmartmom.scattering.phase import get_greek_rayleigh as jax_greek
from vsmartmom.util.quadrature import rt_set_streams as jax_streams

from vsmartmom_torch.core.rt_raman import build_coupling, rt_run_band_rrs
from vsmartmom_torch.core.rt_run import (BandRTInputs, build_layer_schedules,
                                         rt_run_band)
from vsmartmom_torch.inelastic.plus import AbsoluteRaman
from vsmartmom_torch.inelastic.rrs import RRS, greek_raman_coefs
from vsmartmom_torch.inelastic.rrs import make_rrs_profile
from vsmartmom_torch.parallel.sharding import (raman_halo,
                                               rt_run_band_rrs_sharded,
                                               rt_run_band_sharded,
                                               shard_bounds,
                                               spectral_devices)
from vsmartmom_torch.scattering.phase import (Polarization,
                                              get_greek_rayleigh)
from vsmartmom_torch.util.quadrature import rt_set_streams

torch.set_num_threads(2)

ELASTIC_TOL_JAX = dict(rtol=1e-10, atol=1e-14)
ELASTIC_TOL = dict(rtol=1e-12, atol=1e-15)
RAMAN_TOL = dict(rtol=1e-11, atol=1e-16)
VZA, VAZ = [0.0, 30.0], [0.0, 90.0]
STREAMS = ("GaussQuadFullSphere", 10, 45.0, VZA)
RAMAN_STREAMS = ("GaussQuadFullSphere", 8, 45.0, [0.0])


def _arrays(n_z=3, n_spec=32, seed=0):
    """tests/test_sharding.py's band: scattering tau 0.1, absorption
    uniform on [0, 0.5) from ``seed``."""
    rng = np.random.default_rng(seed)
    tau_scat = np.full((n_z, n_spec), 0.1)
    tau = tau_scat + rng.uniform(0.0, 0.5, (n_z, n_spec))
    return tau, tau_scat / tau, np.ones((n_z, 1, n_spec))


def _bands(tau, omega, zw, depol=0.028):
    """The same arrays as the port's and JAX's band inputs."""
    return (BandRTInputs(tau=tau, omega=omega, zw=zw,
                         greeks=[get_greek_rayleigh(depol)]),
            JaxBand(tau=tau, omega=omega, zw=zw, greeks=[jax_greek(depol)]))


def _close(got, want, tol, what):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, err_msg=f"{what} output {i}", **tol)


def _elastic(band, jband, surf, n_shards, **kw):
    """(sharded port, unsharded port, unsharded JAX) of one elastic run."""
    pol = Polarization.from_name("Stokes_IQU")
    quad = rt_set_streams(*STREAMS, pol.n)
    sharded = rt_run_band_sharded(pol, quad, band, VZA, VAZ, 3, surf,
                                  devices=["cpu"] * n_shards, **kw)
    single = rt_run_band(pol, quad, band, VZA, VAZ, 3, surf, device="cpu",
                         **kw)
    jax = jax_rt_run_band(JaxPol.from_name("Stokes_IQU"),
                          jax_streams(*STREAMS, pol.n), jband, VZA, VAZ, 3,
                          surf, **kw)
    return sharded, single, jax


@pytest.mark.parametrize("n_spec,n_shards", [(32, 8), (31, 4)])
def test_elastic_sharded_matches_single_and_jax(n_spec, n_shards):
    """rt_run_band_sharded over 8 shards of 4 points (and 31 points over 4
    shards of 8 and 7) equals the unsharded run."""
    assert [hi - lo for lo, hi in shard_bounds(n_spec, n_shards)] == (
        [4] * 8 if n_spec == 32 else [8, 8, 8, 7])
    band, jband = _bands(*_arrays(n_spec=n_spec))
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.2}
    sharded, single, jax = _elastic(band, jband, surf, n_shards)
    _close(sharded, single, ELASTIC_TOL, "port unsharded")
    _close(sharded, jax, ELASTIC_TOL_JAX, "JAX")


def _thick_and_thin(n_spec=32):
    """A band whose scattering depth spans 0.02 .. 6 across the points of
    each layer, so that the maximum over a 4-point shard sets another
    doubling count than the maximum over the band."""
    tau, _, zw = _arrays(n_spec=n_spec, seed=1)
    tau_scat = np.geomspace(0.02, 6.0, n_spec)[None, :] * np.array(
        [[1.0], [0.3], [0.05]])
    tau = tau_scat + tau
    return tau, tau_scat / tau, zw


def test_thick_and_thin_profile_needs_the_global_maximum():
    """Sharded equals unsharded on a profile where each shard's own maximum
    would change ndoubl; without tau_scat_max the shards' counts differ and
    the joined result misses the unsharded run by far more than the
    gate."""
    tau, omega, zw = _thick_and_thin()
    band, jband = _bands(tau, omega, zw)
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.1}
    sharded, single, jax = _elastic(band, jband, surf, 8)
    _close(sharded, single, ELASTIC_TOL, "port unsharded")
    _close(sharded, jax, ELASTIC_TOL_JAX, "JAX")

    pol = Polarization.from_name("Stokes_IQU")
    quad = rt_set_streams(*STREAMS, pol.n)
    min_mu = float(np.min(quad.qp_mu))
    whole = build_layer_schedules(tau, omega, min_mu, "schulz")
    local = [build_layer_schedules(tau[:, lo:hi], omega[:, lo:hi], min_mu,
                                   "schulz")
             for lo, hi in shard_bounds(32, 8)]
    assert any(s != whole for s in local)
    naive = [rt_run_band(pol, quad, BandRTInputs(
        tau=tau[:, lo:hi], omega=omega[:, lo:hi], zw=zw[:, :, lo:hi],
        greeks=band.greeks), VZA, VAZ, 3, surf, device="cpu")
        for lo, hi in shard_bounds(32, 8)]
    r_naive = np.concatenate([r for r, _ in naive], axis=-1)
    err = np.abs(r_naive - single[0]).max() / np.abs(single[0]).max()
    assert err > 1e-8, err


def test_legendre_surface_split_over_shards():
    """A Legendre albedo is evaluated over the whole band and sliced: the
    sharded run with the hemispheric outputs equals the unsharded one."""
    band, jband = _bands(*_arrays(n_spec=30, seed=2))
    surf = {"type": "LambertianSurfaceLegendre",
            "legendre_coeff": [0.2, 0.08, -0.03]}
    sharded, single, jax = _elastic(band, jband, surf, 4, return_hdr=True)
    assert len(sharded) == 5 and sharded[3].shape == (30,)
    _close(sharded, single, ELASTIC_TOL, "port unsharded")
    _close(sharded, jax, ELASTIC_TOL_JAX, "JAX")


def _raman(specs, jspecs, n_spec=32, n_shards=8, seed=3, jax=True, **kw):
    """(sharded port, unsharded port[, unsharded JAX]) of one Raman run on
    tests/test_sharding.py's Raman band (Stokes_I, 2 moments)."""
    tau, omega, zw = _arrays(n_spec=n_spec, seed=seed)
    band, jband = _bands(tau, omega, zw)
    f_rayl = omega * 0.9
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.1}
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams(*RAMAN_STREAMS, pol.n)
    sharded = rt_run_band_rrs_sharded(pol, quad, band, specs, f_rayl, [0.0],
                                      [0.0], 2, surf,
                                      devices=["cpu"] * n_shards, **kw)
    single = rt_run_band_rrs(pol, quad, band, specs, f_rayl, [0.0], [0.0],
                             2, surf, device="cpu", **kw)
    out = [sharded, single]
    if jax:
        out.append(jax_rt_run_band_rrs(
            JaxPol.from_name("Stokes_I"), jax_streams(*RAMAN_STREAMS, 1),
            jband, jspecs, f_rayl, [0.0], [0.0], 2, surf, **kw))
    return out


def _rrs(lib):
    """tests/test_sharding.py's synthetic coupling: shifts (-9, -5, 5, 9)
    straddle 4-point shards."""
    cls, greek = (RRS, greek_raman_coefs) if lib == "torch" \
        else (JaxRRS, jax_greek_raman)
    return cls(i_shift=np.array([-9, -5, 5, 9]),
               w_shift=np.array([0.01, 0.02, 0.02, 0.01]),
               omega_cabannes=0.97, greek_raman=greek(6.0 / 7.0),
               depol_rayl=0.028)


@pytest.mark.parametrize("n_spec,n_shards", [(32, 8), (31, 4)])
def test_raman_sharded_matches_single_and_jax(n_spec, n_shards):
    """The halo carries the coupling across shard boundaries: R, T, ieR
    and ieT of the sharded run equal the unsharded run's."""
    sharded, single, jax = _raman(_rrs("torch"), _rrs("jax"), n_spec,
                                  n_shards)
    assert np.abs(sharded[2]).max() > 0
    _close(sharded, single, RAMAN_TOL, "port unsharded")
    _close(sharded, jax, RAMAN_TOL, "JAX")
    halos = [raman_halo(build_coupling([_rrs("torch")], n_spec), lo, hi)
             for lo, hi in shard_bounds(n_spec, n_shards)]
    # banded rows: each index set holds the owned shard and lies within 9
    # points of it (the largest shift) on either side
    for h, (lo, hi) in zip(halos, shard_bounds(n_spec, n_shards)):
        assert np.array_equal(h.idx[h.keep], np.arange(lo, hi))
        assert h.idx[0] == max(0, lo - 9) and h.idx[-1] == min(n_spec - 1,
                                                              hi - 1 + 9)


def test_raman_sharded_per_layer_weights_and_static_schedules():
    """Per-layer weights (make_rrs_profile: (nZ, nR, nSpec)) are gathered at
    each halo, and the schulz solver's static schedules use the whole
    band's maxima (port against port)."""
    grid = 12740.0 + 16.0 * np.arange(32)
    specs = make_rrs_profile(grid, [210.0, 250.0, 285.0])
    sharded, single = _raman(specs, None, n_shards=4, jax=False,
                             solver="schulz", static_schedules=True)
    assert np.abs(sharded[2]).max() > 0
    _close(sharded, single, RAMAN_TOL, "port unsharded")


def _absolute(lib):
    """An RRS spec plus an AbsoluteRaman row: every output of the last
    quarter receives the field of column 3, so a shard there runs on a
    non-contiguous index set."""
    cls = AbsoluteRaman if lib == "torch" else JaxAbsoluteRaman
    greek = greek_raman_coefs if lib == "torch" else jax_greek_raman
    i_out = np.arange(24, 32)
    return [_rrs(lib), cls(i_out=i_out, i_src=3,
                           w=np.linspace(0.01, 0.03, len(i_out)),
                           greek_raman=greek(0.2))]


def test_raman_sharded_absolute_coupling_non_contiguous_halo():
    specs = _absolute("torch")
    halo = raman_halo(build_coupling(specs, 32), 24, 32)
    assert 3 in halo.idx and np.any(np.diff(halo.idx) > 1)
    sharded, single, jax = _raman(specs, _absolute("jax"), n_shards=4)
    _close(sharded, single, RAMAN_TOL, "port unsharded")
    _close(sharded, jax, RAMAN_TOL, "JAX")


def test_device_lists():
    """Without CUDA the default device list raises ValueError, and a CUDA
    entry in an explicit list raises resolve_device's RuntimeError before
    any work; an odd split refuses empty shards."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="CUDA devices are visible"):
        spectral_devices()
    band, _ = _bands(*_arrays(n_spec=4))
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams(*RAMAN_STREAMS, pol.n)
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.1}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rt_run_band_sharded(pol, quad, band, [0.0], [0.0], 1, surf,
                            devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="non-empty shards"):
        rt_run_band_sharded(pol, quad, band, [0.0], [0.0], 1, surf,
                            devices=["cpu"] * 5)

"""rt_run_band: the forward RT simulation driver.

Pipeline (ref: src/CoreRT/rt_run.jl:41-230):
  for each Fourier moment m:
    - assemble Z component matrices (host, numpy)
    - the layer scan TOA -> BOA (elemental -> doubling -> interaction),
      then the surface layer and its interaction, on ``device``
    - azimuthal synthesis of the small (n_vza, n_stokes, nSpec) outputs

The spectral axis (nSpec) is the batch axis of every device operation.

Engines for the layer scan (the JAX package's name in brackets):
  "torch"           — batched torch ops, plain form [xla];
  "kernel"          — per layer, the elemental layer in torch and the fused
                      CUDA layer step (doubling + adding,
                      cuda/layer_step_kernel.py) [pallas_step];
  "torch_dev"       — batched torch ops in direct/diffuse split form
                      [xla_dev];
  "kernel_dev"      — per layer, the split-form elemental layer in torch and
                      the split-form CUDA layer step
                      (cuda/layer_step_dev_kernel.py) [pallas_dd];
  "kernel_doubling" — the doubling-only CUDA kernel
                      (cuda/doubling_kernel.py) as the doubling step of the
                      torch engine, then the torch interaction [pallas];
  "kernel_scan"     — one launch of the fused layer-scan CUDA kernel per
                      schedule bucket: Z mixing, elemental, doubling and the
                      two-solve interaction of all its layers, the composite
                      held on chip (cuda/layer_scan_kernel.py) [pallas_scan];
  "kernel_lanes"    — per layer, the elemental layer in torch and the
                      lanes-layout CUDA layer step, the composite kept in
                      lanes layout (N, N, S) for the whole scan
                      (cuda/lanes_kernel.py) [pallas_lanes].
The kernel engines need the Newton-Schulz solver's static schedules and
raise on a layer without one; CPU tensors take each kernel's plain torch
version. auto picks kernel_scan where the scan can run the band as the
kernel engine would (select_engine), and never kernel_dev, kernel_doubling
or kernel_lanes.

Matrix-product precision (core/precision.py), as the JAX package's
``matmul_precision`` and ``dd_precision``: a run's torch ops and the
kernels of the kernel and kernel_doubling engines take
``matmul_precision``, kernel_dev's kernel takes ``dd_precision``; the scan
and lanes kernels stay in full float32, as their TPU counterparts do.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vsmartmom_torch.core import precision
from vsmartmom_torch.core.brdf import (brdf_fourier_matrix,
                                       legendre_spectral_albedo)
from vsmartmom_torch.core.rt import (LayerRT, bmv, dev_to_full,
                                     elemental_flipped,
                                     elemental_flipped_dev, interaction,
                                     interaction_dev, make_added_layer,
                                     make_added_layer_dev, make_rsolve,
                                     mix_z, ns_doubling_schedule,
                                     ns_interaction_iters, vacuum_layer,
                                     vacuum_layer_dev)
from vsmartmom_torch.core.surface import (brdf_surface_layer,
                                          lambertian_surface_layer)
from vsmartmom_torch.scattering.phase import Polarization, compute_Z_moments
from vsmartmom_torch.util.device import DEFAULT_DEVICE, resolve_device
from vsmartmom_torch.util.quadrature import QuadPoints, nearest_point
from vsmartmom_torch.util.timing import timeit

#: largest stream count N the fused layer-step kernel takes (its per-point
#: shared-memory arena at N = 63 is 188 KB of the 227 KB a block may use)
KERNEL_MAX_N = 63

#: the port's layer-scan engines (see the module docstring)
ENGINES = ("torch", "kernel", "torch_dev", "kernel_dev", "kernel_doubling",
           "kernel_scan", "kernel_lanes")
_DEV_ENGINES = ("torch_dev", "kernel_dev")

#: rt_run_band calls by the engine that "auto" resolved to (explicit
#: engines are not counted); clear it (or set it to {}) to reset
auto_choices: dict = {}


@dataclasses.dataclass
class BandRTInputs:
    """Per-band inputs of the RT core (host numpy).

    tau:   (nZ, nSpec) total layer optical depth (scattering + absorption)
    omega: (nZ, nSpec) total single-scattering albedo
    zw:    (nZ, K, nSpec) normalized scattering-component mixing weights
           (K = 1 Rayleigh + n_aerosols); the per-layer phase matrix is
           Z(layer) = sum_k zw[k] * Z_k, assembled on the device so no
           (nZ, nSpec, N, N) tensor is ever materialized.
    greeks: list of K GreekCoefs (Rayleigh first, then aerosols).
    """
    tau: np.ndarray
    omega: np.ndarray
    zw: np.ndarray
    greeks: list


def default_solver(device: torch.device, solver: Optional[str]) -> str:
    """``solver``, or the default where it is None: "lu" on the CPU,
    "schulz" on CUDA."""
    return solver or ("lu" if device.type == "cpu" else "schulz")


def synthesis_weights(quad, vza, vaz, m, n_stokes):
    """(stream slice, Stokes azimuth weights) per view for moment m
    (ref: tools/postprocessing_vza.jl:9-60)."""
    weight = 0.5 if m == 0 else 1.0
    out = []
    for za, az in zip(vza, vaz):
        i_mu = nearest_point(quad.qp_mu, np.cos(np.deg2rad(za)))
        sl = slice(n_stokes * i_mu, n_stokes * (i_mu + 1))
        cm = np.cos(np.deg2rad(m * az))
        sm = np.sin(np.deg2rad(m * az))
        out.append((sl, weight * np.array([cm, cm, sm, sm][:n_stokes])))
    return out


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A run's geometry: the beam and the streams of one polarization and
    quadrature, on the host and as tensors of the run's dtype on its
    device. Every Fourier-moment loop of the package takes its constants
    from here (``geometry`` builds it)."""
    pol: Polarization
    quad: QuadPoints
    dtype: torch.dtype
    device: torch.device
    #: (N,) host beam vector: pol.i0 on the solar node's Stokes block
    i0: np.ndarray
    #: host floats: the solar node's mu and the smallest stream mu
    mu0_node_h: float
    min_qp_mu_h: float
    # the device copies
    qp: torch.Tensor
    wt: torch.Tensor
    d_vec: torch.Tensor
    i0_vec: torch.Tensor
    mu0: torch.Tensor
    mu0_node: torch.Tensor
    min_qp_mu: torch.Tensor

    @property
    def n_stokes(self) -> int:
        return self.pol.n

    @property
    def i_mu0_n(self) -> int:
        return self.quad.i_mu0_n

    def to_dev(self, x):
        """``x`` as a tensor of the run's dtype on its device."""
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)

    def weights(self, m: int):
        """Moment m's quadrature weights (wct02, wct2): the beam's, a 0-dim
        tensor, and the streams', (N,)."""
        wct02 = torch.tensor(0.5 if m == 0 else 0.25, dtype=self.dtype,
                             device=self.device)
        return wct02, self.wt / 2.0 if m == 0 else self.wt / 4.0

    def layer_args(self, m: int):
        """The stream arguments an elemental layer of moment m takes after
        its optical depth above: (qp, wct2, wct02, i0_vec, i_mu0_n,
        n_stokes, mu0_node, mu0, d_vec)."""
        wct02, wct2 = self.weights(m)
        return (self.qp, wct2, wct02, self.i0_vec, self.i_mu0_n,
                self.n_stokes, self.mu0_node, self.mu0, self.d_vec)

    def z_moments(self, greeks, m: int):
        """Moment m's stacked (K, N, N) Z components (z_pp, z_mp) of the
        Greek coefficients ``greeks``, on the device."""
        zs = [compute_Z_moments(self.pol, self.quad.qp_mu, gc, m)
              for gc in greeks]
        return (self.to_dev(np.stack([z[0] for z in zs])),
                self.to_dev(np.stack([z[1] for z in zs])))


def geometry(pol: Polarization, quad: QuadPoints, dtype,
             device) -> Geometry:
    """The Geometry of a run at ``dtype`` on ``device``."""
    i0 = np.zeros(len(quad.qp_mu_n))
    i0[quad.i_mu0_n:quad.i_mu0_n + pol.n] = pol.i0
    mu0_node = float(quad.qp_mu_n[quad.i_mu0_n])
    min_qp_mu = float(np.min(quad.qp_mu))

    def to_dev(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return Geometry(pol, quad, dtype, device, i0, mu0_node, min_qp_mu,
                    to_dev(quad.qp_mu_n), to_dev(quad.wt_mu_n),
                    to_dev(np.tile(pol.d, quad.n_quad)), to_dev(i0),
                    to_dev(quad.mu0), to_dev(mu0_node), to_dev(min_qp_mu))


class Synthesis:
    """Host accumulator of a run's azimuthal synthesis (ref:
    tools/postprocessing_vza.jl:9-60, postprocessing_vza_ms.jl): ``n_out``
    float64 outputs of shape (n_vza, n_stokes, nSpec), with a leading
    sensor axis of ``n_sensor`` where given, and moment 0's bi-hemispheric
    fluxes ``bhr`` (up, down), each (nSpec,)."""

    def __init__(self, geom: Geometry, vza, vaz, n_spec: int, n_out: int,
                 n_sensor: Optional[int] = None):
        self.geom, self.vza, self.vaz = geom, vza, vaz
        lead = () if n_sensor is None else (n_sensor,)
        self.outs = [np.zeros(lead + (len(vza), geom.n_stokes, n_spec))
                     for _ in range(n_out)]
        self.bhr = (np.zeros(n_spec), np.zeros(n_spec))

    def add(self, m: int, *vecs):
        """Add moment m's fetched source vectors, each ([nSensor,] nSpec,
        N), into the outputs (the first len(vecs) of them)."""
        g = self.geom
        for i, (sl, cs) in enumerate(
                synthesis_weights(g.quad, self.vza, self.vaz, m,
                                  g.n_stokes)):
            for out, vec in zip(self.outs, vecs):
                out[..., i, :, :] += cs[:, None] * vec[..., sl].swapaxes(-1,
                                                                         -2)

    def add_bhr(self, hdr_j_m, j_p, tau_column):
        """Moment 0's bi-hemispheric fluxes at the surface: mu-weighted
        quadrature sums of the intensity components of the surface-leaving
        ``hdr_j_m`` and the downwelling ``j_p`` ((nSpec, N) each), plus the
        direct beam through ``tau_column`` (nSpec,) for the downwelling
        (ref: interaction_hdrf.jl:27-45)."""
        g = self.geom
        ns, mu0_node = g.n_stokes, g.mu0_node_h
        qw = (g.quad.qp_mu_n * g.quad.wt_mu_n)[::ns]
        self.bhr[0][:] = hdr_j_m[:, ::ns] @ qw
        direct = g.i0[g.i_mu0_n] * np.exp(-tau_column / mu0_node) * mu0_node
        self.bhr[1][:] = j_p[:, ::ns] @ qw + direct


def schedule_buckets(layer_schedules):
    """Runs of consecutive layers sharing one (ndoubl, NS schedule, ni)
    entry, as (entry, start, count) triples."""
    buckets = []
    for iz, entry in enumerate(layer_schedules):
        if buckets and buckets[-1][0] == entry:
            buckets[-1][2] += 1
        else:
            buckets.append([entry, iz, 1])
    return [tuple(b) for b in buckets]


def _fourier_step(tau, omega, zw, z_pp_c, z_mp_c, geom: Geometry, albedo,
                  spectral_albedo, *, m, solver, layer_schedules, engine,
                  rho_brdf=None, tau_scat_max=None,
                  matmul_precision: str = "highest", dd_precision=None):
    """Fourier moment m: layer scan + surface. Returns the composite
    layer and the surface-leaving source vector (hdr).

    ``matmul_precision``: the product mode of the kernel and
    kernel_doubling engines' kernels; ``dd_precision``: kernel_dev's
    (None: precision.resolve_dd). The torch ops take the enclosing
    ``precision.matmul_precision`` block's mode, as JAX's
    ``_fourier_step_body`` takes the enclosing default precision.

    ``rho_brdf``: the BRDF surface's (N, N) Fourier matrix of this moment,
    or None for a Lambertian surface (``albedo``, ``spectral_albedo``;
    surface_layer).

    ``layer_schedules``: one (ndoubl, ns_schedule, ni) entry per layer;
    ndoubl None derives each layer's doubling count from its optical depth,
    ns_schedule None doubles with ``solver``, ni None solves the
    interaction with ``solver``.

    ``tau_scat_max``: (nZ,) host maximum of tau * omega of each layer over
    the whole band, or None to take it over the points given; it sets the
    doubling count of a layer whose ndoubl is None.
    """
    rsolve = make_rsolve(solver)
    dtype, device = tau.dtype, tau.device
    n_spec = tau.shape[1]
    n = geom.qp.shape[0]
    eye = torch.eye(n, dtype=dtype, device=device).expand(n_spec, n, n)
    # (qp, wct2, wct02, ...): every elemental layer's stream arguments
    streams = geom.layer_args(m)

    # cumulative optical depth above each layer (TOA -> BOA)
    tau_sum_all = torch.cat([torch.zeros((1, n_spec), dtype=dtype,
                                         device=device),
                             torch.cumsum(tau, dim=0)], dim=0)

    if engine == "kernel":
        from vsmartmom_torch.cuda.layer_step_kernel import fused_layer_step
    elif engine == "kernel_dev":
        from vsmartmom_torch.cuda.layer_step_dev_kernel import \
            fused_layer_step_dev
    elif engine == "kernel_scan":
        from vsmartmom_torch.cuda.layer_scan_kernel import fused_layer_scan
        # host scalars for the kernel's launch (one read per moment)
        mu0_h, mu0_node_h = float(geom.mu0), float(geom.mu0_node)
    elif engine == "kernel_lanes":
        from vsmartmom_torch.cuda.lanes_kernel import (
            fused_layer_step_lanes, from_lanes, to_lanes, to_lanes_m,
            to_lanes_v)

    dd = precision.resolve_dd(matmul_precision, dd_precision)
    dev_form = engine in _DEV_ENGINES
    comp = (vacuum_layer_dev if dev_form else vacuum_layer)(
        n_spec, n, dtype, device)
    if engine == "kernel_lanes":
        # the composite stays in lanes layout (N, N, S) across the scan
        comp = to_lanes(comp)
    for (nd, sched, ni), start, count in schedule_buckets(layer_schedules):
        if engine.startswith("kernel") and sched is None:
            raise ValueError(f"the {engine} engine needs the schulz solver's "
                             f"static Newton-Schulz schedules")
        if dev_form and nd is None:
            raise ValueError("the split-form engines need static per-layer "
                             "doubling counts")
        if engine == "kernel_scan":
            # the kernel doubles len(sched) times: a bucket whose ndoubl
            # differs would run another discretization than its entry says
            if len(sched) != nd:
                raise ValueError(f"bucket at layer {start}: NS schedule of "
                                 f"{len(sched)} steps, ndoubl {nd}")
            sl = slice(start, start + count)
            with timeit("layer_step"):
                comp = fused_layer_scan(
                    comp, tau[sl], omega[sl], zw[sl], tau_sum_all[sl],
                    z_pp_c, z_mp_c, geom.qp, streams[1], geom.i0_vec,
                    geom.d_vec, mu0_h, mu0_node_h, 0.5 if m == 0 else 0.25,
                    ns_schedule=sched, i_mu0_n=geom.i_mu0_n,
                    n_stokes=geom.n_stokes, inter_iters=ni)
            continue
        irs = (make_rsolve("schulz", ni)
               if solver == "schulz" and ni is not None else rsolve)
        # torch_dev solves exactly (LU) under the lu solver or where a
        # layer has no NS schedule, as the JAX xla_dev engine does
        exact = solver != "schulz" or sched is None
        for iz in range(start, start + count):
            with timeit("elemental"):
                tsm = (None if tau_scat_max is None
                       else float(tau_scat_max[iz]))
                z_pp = mix_z(zw[iz], z_pp_c)
                z_mp = mix_z(zw[iz], z_mp_c)
                layer = (tau[iz], omega[iz], z_pp, z_mp, tau_sum_all[iz],
                         *streams)
                if engine in ("kernel", "kernel_lanes"):
                    r_f, t, jp, jm_f, ek, _ = elemental_flipped(
                        *layer, geom.min_qp_mu, ndoubl_static=nd,
                        tau_scat_max=tsm)
                    if engine == "kernel_lanes":
                        r_f, t = to_lanes_m(r_f), to_lanes_m(t)
                        jp, jm_f = to_lanes_v(jp), to_lanes_v(jm_f)
                elif engine == "kernel_dev":
                    r_f, g_el, e_el, jp, jm_f, ek = elemental_flipped_dev(
                        *layer, nd)
                elif engine == "torch_dev":
                    added = make_added_layer_dev(
                        *layer, geom.min_qp_mu, nd,
                        ns_schedule=None if exact else sched,
                        exact_eye=eye if exact else None)
                else:
                    added = make_added_layer(
                        *layer, geom.min_qp_mu, eye, rsolve=rsolve,
                        ndoubl_static=nd, ns_schedule=sched,
                        doubling_engine=("kernel"
                                         if engine == "kernel_doubling"
                                         else "torch"), tau_scat_max=tsm,
                        matmul_precision=matmul_precision)
            with timeit("layer_step"):
                if engine == "kernel":
                    comp = fused_layer_step(comp, r_f, t, jp, jm_f, ek,
                                            geom.d_vec, ns_schedule=sched,
                                            ni=ni, precision=matmul_precision)
                elif engine == "kernel_lanes":
                    comp = fused_layer_step_lanes(
                        comp, r_f, t, jp, jm_f, ek, geom.d_vec,
                        ns_schedule=sched, ni=ni)
                elif engine == "kernel_dev":
                    comp = fused_layer_step_dev(
                        comp, r_f, g_el, e_el, jp, jm_f, ek, geom.d_vec,
                        ns_schedule=sched, ni=ni, precision=dd)
                elif engine == "torch_dev":
                    comp = interaction_dev(comp, added,
                                           ni=None if exact else ni,
                                           exact_eye=eye if exact else None)
                else:
                    comp = interaction(comp, added, eye, rsolve=irs)
    if dev_form:
        comp = dev_to_full(comp)
    elif engine == "kernel_lanes":
        comp = from_lanes(comp)

    with timeit("surface"):
        surf = surface_layer(geom, m, tau_sum_all[-1], albedo,
                             spectral_albedo, rho_brdf)
        comp = interaction(comp, surf, eye, rsolve=rsolve)

        # Surface-leaving radiance for hemispheric (HDRF/BHR) outputs:
        # upwelling just above the surface = surface reflection of the full
        # downwelling field + direct-beam reflection
        # (ref: CoreKernel/interaction_hdrf.jl:9-45)
        hdr_j_m = bmv(surf.r_mp, comp.j_p) + surf.j_m
    return comp, hdr_j_m


# ndoubl quantization step of the per-layer schedules: both packages
# discretize identically, so the engines agree to rounding
_ND_QUANT = 4


def build_layer_schedules(tau, omega, min_qp_mu: float, solver: str,
                          tau_scat_max=None):
    """Host-side static doubling/solver schedules for one band profile.

    ``tau_scat_max``: (nZ,) maximum of tau * omega of each layer over the
    whole band, in place of the maximum over the points of ``tau`` (a
    spectral shard's schedules then equal the whole band's).

    Returns (ndoubl_static, ns_schedule, layer_schedules):
      - nearly-uniform per-layer doubling counts -> one static count
        `ndoubl_static` (+ per-step NS schedule for schulz);
      - widely-spread counts (real profiles: thin stratosphere above thick
        low layers) + schulz -> per-layer static `layer_schedules` of
        3-tuples (ndoubl, ns_doubling_schedule, ns_interaction_iters), nd
        quantized UP to a multiple of _ND_QUANT (a finer elemental slab,
        so accuracy is unaffected or better) and at most 6 distinct
        entries;
      - anything else -> (None, None, None): per-layer counts derived from
        each layer's optical depth.

    An error here propagates: the kernel engine runs only on these
    schedules, so a failure must not quietly hand the run to torch ops.
    """
    if not (isinstance(tau, np.ndarray) and isinstance(omega, np.ndarray)):
        return None, None, None
    tau_scat = (np.max(tau * omega, axis=1) if tau_scat_max is None
                else np.asarray(tau_scat_max, np.float64))
    pos = tau_scat > 0
    if not np.any(pos):
        return None, None, None
    dmax = np.minimum(tau_scat[pos], 0.004 * min_qp_mu)
    nd = np.ceil(np.log2(np.maximum(tau_scat[pos] / dmax, 1.0)))
    if nd.max() - nd.min() <= 2:
        ndoubl_static = int(nd.max())
        ns_schedule = None
        if solver == "schulz":
            ns_schedule = ns_doubling_schedule(
                float(tau_scat.max()), min_qp_mu, ndoubl_static)
        return ndoubl_static, ns_schedule, None
    if solver != "schulz":
        return None, None, None

    nd_all = np.zeros(len(tau_scat), dtype=int)
    nd_all[pos] = nd.astype(int)
    q = _ND_QUANT
    nd_all = q * np.ceil(np.maximum(nd_all, 1) / q).astype(int)
    dm = 0.004 * min_qp_mu
    ni_all = ns_interaction_iters(tau_scat, min_qp_mu)
    layer_schedules = tuple(
        (int(k), ns_doubling_schedule(dm * 2.0 ** int(k), min_qp_mu,
                                      int(k)),
         int(ni))
        for k, ni in zip(nd_all, ni_all))
    if len(set(layer_schedules)) > 6:
        # too many distinct (nd, sched, ni) entries: quantize ni UP to the
        # max within each (nd, sched) group — extra NS iterations only
        # tighten the residual
        group_ni: dict = {}
        for nd_e, sched_e, ni_e in layer_schedules:
            key = (nd_e, sched_e)
            group_ni[key] = max(group_ni.get(key, 0), ni_e)
        layer_schedules = tuple(
            (nd_e, sched_e, group_ni[(nd_e, sched_e)])
            for nd_e, sched_e, _ in layer_schedules)
    if len(set(layer_schedules)) > 6:
        # still too many: give up interaction adaptivity entirely
        layer_schedules = tuple(e[:2] + (4,) for e in layer_schedules)
    if len(set(layer_schedules)) > 6:
        # collapse to one global (max) schedule
        k = int(nd_all.max())
        sched = ns_doubling_schedule(dm * 2.0 ** k, min_qp_mu, k)
        layer_schedules = tuple((k, sched, 4) for _ in nd_all)
    return None, None, layer_schedules


def _per_layer_schedules(n_z, solver, ndoubl_static, ns_schedule,
                          layer_schedules):
    """The builder's result as one (ndoubl, ns_schedule, ni) entry per
    layer: a uniform schedule is one bucket."""
    if layer_schedules is not None:
        return tuple((nd, tuple(s), ni) for nd, s, ni in layer_schedules)
    ni = 4 if solver == "schulz" else None
    sched = tuple(ns_schedule) if ns_schedule is not None else None
    return ((ndoubl_static, sched, ni if ndoubl_static is not None
             else None),) * n_z


def surface_inputs(surface, n_spec: int, to_dev):
    """(albedo, spectral_albedo, is_brdf) of a surface dict: a Lambertian
    scalar albedo, or an (nSpec,) albedo on the device (Spectrum, or a
    Legendre expansion over the band), or a BRDF (rpvSurfaceScalar,
    RossLiSurfaceScalar: one Fourier matrix per moment, core/brdf.py).
    Any other type raises NotImplementedError."""
    kind = surface["type"]
    if kind == "LambertianSurfaceScalar":
        return float(surface["albedo"]), None, False
    if kind == "LambertianSurfaceSpectrum":
        return 0.0, to_dev(surface["albedo"]), False
    if kind == "LambertianSurfaceLegendre":
        return 0.0, to_dev(legendre_spectral_albedo(
            surface["legendre_coeff"], n_spec)), False
    if kind in ("rpvSurfaceScalar", "RossLiSurfaceScalar"):
        return 0.0, None, True
    raise NotImplementedError(kind)


def surface_layer(geom: Geometry, m: int, tau_total, albedo,
                  spectral_albedo=None, rho_brdf=None):
    """Moment m's surface layer under a column of total optical depth
    ``tau_total`` ((nSpec,) on the device): the BRDF's where ``rho_brdf``
    (its (N, N) Fourier matrix of moment m) is given, else the
    Lambertian's (``albedo`` on the device and ``spectral_albedo``, as
    surface_inputs gives them)."""
    n_spec = tau_total.shape[0]
    if rho_brdf is not None:
        return brdf_surface_layer(rho_brdf, n_spec, geom.qp, geom.wt,
                                  geom.i0_vec, tau_total, geom.mu0)
    return lambertian_surface_layer(
        albedo, n_spec, geom.n_stokes, geom.qp, geom.wt, geom.i0_vec,
        tau_total, geom.mu0, m == 0, spectral_albedo=spectral_albedo)


def select_engine(engine: str, device: torch.device, dtype, n: int,
                  layer_schedules, matmul_precision: str = "highest") -> str:
    """Resolve ``engine`` ("auto" or one of ENGINES) for a band whose
    per-layer (ndoubl, ns_schedule, ni) entries are ``layer_schedules``.

    "auto" takes a kernel for float32 CUDA tensors with N <= 63 and the
    schulz solver's static schedules on every layer: the fused layer scan
    (kernel_scan: one launch a schedule bucket, the Z mixing and the
    elemental layers inside it) where every layer's NS schedule has its
    ndoubl steps (the scan doubles len(ns_schedule) times), the products
    are at "highest" (the scan computes in full float32 whatever the mode)
    and no torch.func transform is active (the scan has no forward rule),
    else the fused layer step (kernel, which honours the mode). Beyond
    N = 63 it takes the torch ops of the direct/diffuse split form, as the
    JAX package's auto does (its plain float32 missed the Natraj I gate on
    the TPU; the split form's float32 floor is lower); and plain torch ops
    otherwise. The JAX package's auto never picks its TPU scan; this one
    does because on the H100 the scan gives the kernel engine's answer in
    less time (PERF.md). It never picks kernel_dev, kernel_doubling or
    kernel_lanes.
    """
    if engine == "auto":
        static_schulz = all(sched is not None
                            for _, sched, _ in layer_schedules)
        if device.type == "cuda" and dtype == torch.float32 \
                and static_schulz:
            if n > KERNEL_MAX_N:
                return "torch_dev"
            if matmul_precision == "highest" \
                    and all(len(sched) == nd and ni is not None
                            for nd, sched, ni in layer_schedules) \
                    and torch._C._functorch.peek_interpreter_stack() is None:
                return "kernel_scan"
            return "kernel"
        return "torch"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    return engine


def rt_run_band(pol: Polarization, quad: QuadPoints, band: BandRTInputs,
                vza, vaz, max_m: int, surface, dtype=torch.float64,
                device=DEFAULT_DEVICE, solver: Optional[str] = None,
                return_hdr: bool = False, return_composite: bool = False,
                engine: str = "auto", sfi: bool = True, tau_scat_max=None,
                matmul_precision: str = "highest", dd_precision=None):
    """Run the full Fourier-moment loop for one band; azimuthally synthesize.

    surface: dict like {"type": "LambertianSurfaceScalar", "albedo": 0.1};
    also "LambertianSurfaceSpectrum" (an (nSpec,) albedo),
    "LambertianSurfaceLegendre" (a Legendre expansion of the albedo over
    the band), "rpvSurfaceScalar" and "RossLiSurfaceScalar" (BRDFs, one
    (N, N) Fourier matrix per moment, core/brdf.py).
    Returns (R_SFI, T_SFI) of shape (n_vza, n_stokes, nSpec); with
    ``return_hdr`` also (hdr, bhr_uw, bhr_dw): the hemispheric-directional
    surface-leaving radiance per VZA plus the bi-hemispheric up/downwelling
    fluxes at the surface (ref: rt_run.jl:187-226 RAMI outputs); with
    ``return_composite`` last the list of each moment's composite layer
    (a LayerRT of host numpy arrays).
    ``device``: "cuda" (default) or "cpu"; a CUDA device without CUDA
    raises.
    ``solver``: "lu" (default on the CPU) or "schulz" (default on CUDA).
    ``engine``: "auto" or one of ENGINES (see select_engine and the module
    docstring).
    ``sfi``: True synthesizes radiances from the single-beam source vectors
    J0-/J0+; False from the R-+/T++ operator columns at the mu0 node (ref:
    postprocessing_vza.jl:30-56), which needs the beam as a real node
    (RadauQuad).
    ``tau_scat_max``: (nZ,) maximum of tau * omega of each layer over a
    whole band of which ``band`` is a spectral shard
    (parallel/sharding.py); it stands in for every maximum the run would
    take over its own points (doubling counts and static schedules). None
    (default) takes them over ``band``.
    ``matmul_precision``: "highest" (default: full float32, TF32 off),
    "high" (three bf16 passes) or "default" (one bf16 pass), for the torch
    ops of a float32 run (a float64 run ignores it) and the kernels of the
    kernel and kernel_doubling engines (core/precision.py). "high" is safe
    only in split form: the plain engines fail the accuracy gates with it
    (vsmartmom_torch/qualification/precision_h100.jsonl).
    ``dd_precision``: kernel_dev's kernel mode, "bf16x3", "highest" or
    "default"; None (default) takes "highest" for matmul_precision
    "highest" and "bf16x3" otherwise, as the JAX package does (its
    environment override VSM_DD_PRECISION is this keyword).
    """
    device = resolve_device(device)
    solver = default_solver(device, solver)
    dd_precision = precision.resolve_dd(matmul_precision, dd_precision)
    n_spec = band.tau.shape[1]
    n_z = band.tau.shape[0]
    n = len(quad.qp_mu_n)
    n_stokes = pol.n
    vza = np.asarray(vza, dtype=np.float64)
    vaz = np.asarray(vaz, dtype=np.float64)
    min_qp_mu = float(np.min(quad.qp_mu))

    with timeit("schedules"):
        ndoubl_static, ns_schedule, layer_schedules = build_layer_schedules(
            band.tau, band.omega, min_qp_mu, solver, tau_scat_max)
        schedules = _per_layer_schedules(n_z, solver, ndoubl_static,
                                          ns_schedule, layer_schedules)
        requested = engine
        engine = select_engine(engine, device, dtype, n, schedules,
                               matmul_precision)
        if requested == "auto":
            auto_choices[engine] = auto_choices.get(engine, 0) + 1
        if engine in _DEV_ENGINES and layer_schedules is None \
                and ndoubl_static is None:
            # the split-form engines always need static per-layer doubling
            # counts: under the lu solver borrow the schulz builder's
            # buckets (torch_dev then solves each of them exactly)
            _, _, layer_schedules = build_layer_schedules(
                band.tau, band.omega, min_qp_mu, "schulz", tau_scat_max)
            schedules = _per_layer_schedules(n_z, solver, ndoubl_static,
                                              ns_schedule, layer_schedules)

    from vsmartmom_torch.util.logging import run_banner
    run_banner(pol, quad, n_spec, n_z, max_m, surface, engine, solver,
               dtype, device)

    with precision.matmul_precision(matmul_precision):
        with timeit("to_device"):
            geom = geometry(pol, quad, dtype, device)
            tau_d, omega_d, zw_d = (geom.to_dev(band.tau),
                                    geom.to_dev(band.omega),
                                    geom.to_dev(band.zw))
            albedo, spectral_albedo, is_brdf = surface_inputs(
                surface, n_spec, geom.to_dev)
            albedo_d = geom.to_dev(albedo)
        syn = Synthesis(geom, vza, vaz, n_spec, 3 if return_hdr else 2)
        sl0 = slice(quad.i_mu0_n, quad.i_mu0_n + n_stokes)
        comps = []
        for m in range(max_m):
            with timeit("Z moments"):
                z_pp_c, z_mp_c = geom.z_moments(band.greeks, m)

            # brdf_fourier_matrix carries the (2/pi) integral factor common
            # to every moment (the reference splits it as ff * 2 between
            # reflectance() and create_surface_layer!, same total)
            rho_brdf = (geom.to_dev(brdf_fourier_matrix(surface, quad.qp_mu,
                                                        m, n_stokes))
                        if is_brdf else None)

            with timeit("fourier step (layer scan + surface)"):
                comp, hdr_j_m_dev = _fourier_step(
                    tau_d, omega_d, zw_d, z_pp_c, z_mp_c, geom, albedo_d,
                    spectral_albedo, m=m, solver=solver,
                    layer_schedules=schedules, engine=engine,
                    rho_brdf=rho_brdf, tau_scat_max=tau_scat_max,
                    matmul_precision=matmul_precision,
                    dd_precision=dd_precision)

            with timeit("postprocessing (device fetch)"):
                if return_composite:
                    comps.append(LayerRT(*(x.cpu().numpy() for x in comp)))
                if sfi:
                    j_m = comp.j_m.cpu().numpy()     # (nSpec, N)
                    j_p = comp.j_p.cpu().numpy()
                else:
                    r_cols = comp.r_mp[:, :, sl0].cpu().numpy()
                    t_cols = comp.t_pp[:, :, sl0].cpu().numpy()
                hdr_j_m = hdr_j_m_dev.cpu().numpy() if return_hdr else None

            with timeit("synthesis"):
                if not sfi:
                    # operator columns at the mu0 node applied to the
                    # discretized delta beam I0/(w0 mu0); the operators
                    # carry the quadrature weight on the incoming column,
                    # so the beam node's weight divides out
                    i0_blk = np.asarray(pol.i0, np.float64)
                    w0 = float(quad.wt_mu_n[quad.i_mu0_n])
                    j_m = (r_cols @ i0_blk) / w0            # (nSpec, N)
                    j_p = (t_cols @ i0_blk) / w0
                syn.add(m, *((j_m, j_p, hdr_j_m) if return_hdr
                             else (j_m, j_p)))
                if return_hdr and m == 0:
                    syn.add_bhr(hdr_j_m, j_p,
                                np.asarray(band.tau).sum(axis=0))

    out = syn.outs
    if return_hdr:
        out += list(syn.bhr)
    if return_composite:
        out.append(comps)
    return tuple(out)

"""The traffic generator: one caller, calls back to back (a closed loop).

A mix is a data file ``rtbench/traffic/<mix>.json`` that this module reads.
Its ``call`` names the kind of call, a module ``rtbench/kinds/<call>.py``
found by that name, which says what one call runs on the program, what the
plain reference computes for it, and the layer steps it does. A new kind
of call is a new file there; a new mix of a known kind is a data file.

Each call i gets its own retrieval state, drawn from the seed and i alone
(``Mix.state``): x0 in the range state.x0, the log scale of the aerosol
optical depth (forward) or of the scattering depth (jacobian, as the
retrieval demo's state), at fixed levels in a drawn order; albedo = the
file's albedo of each band x U(state.albedo_scale); x2 ~ U(state.x2), the
log scale of the absorption depth.

With ``control`` the plain reference takes the program's place, its
products rounded to bfloat16 (``reference.rt.BF16``): the control of the
comparison, which has to come out not correct.

The program is imported only here, in the kinds and in ``run``; the
reference never.
"""
from __future__ import annotations

import importlib
import re
import time

import numpy as np
import torch
import yaml

from rtbench.reference import rt as ref_rt
from rtbench.reference import scene as ref_scene


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator of the run's seed and a stream of whole numbers."""
    return np.random.default_rng([int(seed) % 2 ** 64, *stream])


def load_kind(name: str):
    """The module ``rtbench/kinds/<name>.py``."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"bad kind of call {name!r}")
    return importlib.import_module("rtbench.kinds." + name)


def assumed(config_path: str) -> dict:
    """The ``benchmark.assumed`` settings of a configuration file: what the
    run takes in place of the upstream file's own value of a key."""
    with open(config_path) as f:
        return dict((yaml.safe_load(f).get("benchmark") or {})
                    .get("assumed") or {})


class Mix:
    """Set-up, calls and the comparison of one cell's traffic."""

    def __init__(self, spec: dict, config_path: str, seed: int, device,
                 control: bool = False):
        self.spec = spec
        self.kind = load_kind(spec["call"])
        self.config_path = config_path
        self.device = torch.device(device)
        self.control = control
        self.spans = {}
        t0 = time.perf_counter()
        import vsmartmom_torch as vt
        self.vt = vt
        self.spans["import"] = time.perf_counter() - t0
        self.params = vt.parameters_from_yaml(config_path)
        for key, value in assumed(config_path).items():
            setattr(self.params, key, value)
        self.n_bands = len(self.params.spec_bands)
        self.n_spec = sum(len(b) for b in self.params.spec_bands)
        self.shared = {}               # what a kind's set-up builds
        self._ref = None
        self.reseed(seed)

    def reseed(self, seed: int):
        """Draw the calls' states and the sampled points from ``seed``."""
        self.seed = seed
        self.sample = np.sort(rng(seed, 2).choice(
            self.n_spec, size=min(self.spec["check_points"], self.n_spec),
            replace=False))

    # --- the program's side -----------------------------------------------

    def setup(self):
        """Build the model (the ``model_build`` span, ended by a
        synchronize) and what the calls share; warm up one call."""
        t0 = time.perf_counter()
        self.model = self.vt.model_from_parameters(self.params,
                                                   device=self.device)
        sync(self.device)
        self.spans["model_build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if not self.control:
            self.kind.setup(self)
        self.call(0)                                  # warm-up
        sync(self.device)
        self.spans["warm_up"] = time.perf_counter() - t0

    def state(self, i: int) -> dict:
        """Call i's state: the kind's own ``state(mix, i)`` where it has
        one, else the retrieval state: x0, x2 and one albedo for every band.
        x0 sets the doubling counts (through the aerosol's scattering
        depth), so it takes the midpoints of ``x0_levels`` equal bins of its
        range, every level once in each cycle of calls, in an order drawn
        from the seed: every seed's run does the same work."""
        if hasattr(self.kind, "state"):
            return self.kind.state(self, i)
        lim = self.spec["state"]
        levels = lim["x0_levels"]
        order = rng(self.seed, 4, i // levels).permutation(levels)
        lo, hi = lim["x0"]
        x0 = lo + (order[i % levels] + 0.5) * (hi - lo) / levels
        g = rng(self.seed, 1, i + 1)
        u = g.uniform(*lim["albedo_scale"])
        x2 = g.uniform(*lim["x2"])
        albedo = [float(s["albedo"]) * u for s in self.params.surfaces]
        return {"x0": x0, "albedo": albedo, "x2": x2}

    def call(self, i: int) -> dict:
        """Run call i; return its outputs at the sampled points."""
        if self.control:
            return self.kind.reference(self, self.state(i), ref_rt.BF16)
        return self.kind.call(self, self.state(i))

    def work(self, i: int) -> list:
        """The layer steps of call i as (n, points, doublings)."""
        return self.kind.work(self, self.state(i))

    def release(self):
        """Drop the program's state before the reference runs."""
        self.__dict__.pop("model", None)
        self.shared.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the comparison -----------------------------------------------------

    def reference_inputs(self):
        """The reference's scene and, per band, its gas depths at the
        sampled points of that band: (scene, [(band points, gas)])."""
        if self._ref is None or self._ref[0] is not self.sample:
            scene = (self._ref[1] if self._ref is not None
                     else ref_scene.build_scene(self.config_path))
            start = np.cumsum([0] + [len(b.grid) for b in scene.bands])
            per_band = []
            for ib in range(len(scene.bands)):
                idx = self.sample[(self.sample >= start[ib])
                                  & (self.sample < start[ib + 1])] - start[ib]
                per_band.append((idx, ref_scene.gas_tau(scene, ib, idx,
                                                        self.device)))
            self._ref = (self.sample, scene, per_band)
        return self._ref[1], self._ref[2]

    def check(self, outputs: dict) -> dict:
        """Readings of the comparison with the plain reference: for a
        sample of the calls, drawn from the seed, the widest gap at the
        sampled points, as a share of the reference's largest magnitude of
        the same quantity there (intensity for R and T)."""
        calls = sorted(outputs)
        n_check = min(self.spec["check_calls"], len(calls))
        picked = sorted(rng(self.seed, 3).choice(calls, size=n_check,
                                                 replace=False))
        torch.backends.cuda.matmul.allow_tf32 = False
        readings, self.references = {}, {}
        for i in picked:
            ref = self.kind.reference(self, self.state(int(i)),
                                      ref_rt.EXACT)
            self.references[int(i)] = ref
            for key, val in gaps(outputs[i], ref,
                                 getattr(self.kind, "COLUMNS", ())).items():
                readings[key] = max(readings.get(key, 0.0), val)
        return readings


def gaps(out: dict, ref: dict, columns=()) -> dict:
    """Widest gap of each output against the reference, as a share of the
    reference's largest magnitude: R and T of the intensity's, each
    Jacobian column (of ``K``, named by ``columns``) of its own."""
    g = {}
    for key in ("R", "T"):
        if key in out:
            scale = np.max(np.abs(ref[key][:, 0]))
            g[f"{key}_gap"] = float(np.max(np.abs(out[key] - ref[key]))
                                    / scale)
    for j, name in enumerate(columns):
        scale = np.max(np.abs(ref["K"][..., j]))
        g[f"dR_d{name}_gap"] = float(
            np.max(np.abs(out["K"][..., j] - ref["K"][..., j])) / scale)
    return g


def sync(device):
    """Wait for the device."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)

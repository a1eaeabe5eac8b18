"""Parameter configuration: YAML schema-compatible with the reference.

The reference evaluates Julia expressions inside YAML strings
(ref: src/CoreRT/tools/parameters_from_yaml.jl:147-287). We keep the exact
same YAML schema but replace ``eval`` with a small, safe expression parser
(arithmetic + ranges + registered constructor names) — no code execution.
"""
from __future__ import annotations

import ast
import dataclasses
import operator
import re
from typing import Any, Dict, List, Optional

import numpy as np
import yaml


# ----------------------------------------------------------------------------
# Safe arithmetic expression evaluation (for "1e7/777"-style YAML values)
# ----------------------------------------------------------------------------

_BINOPS = {ast.Add: operator.add, ast.Sub: operator.sub,
           ast.Mult: operator.mul, ast.Div: operator.truediv,
           ast.Pow: operator.pow}


def _safe_arith(expr: str) -> float:
    """Evaluate a pure-arithmetic expression (no names, no calls)."""
    node = ast.parse(expr.strip(), mode="eval").body

    def ev(n):
        if isinstance(n, ast.Constant) and isinstance(n.value, (int, float)):
            return float(n.value)
        if isinstance(n, ast.BinOp) and type(n.op) in _BINOPS:
            return _BINOPS[type(n.op)](ev(n.left), ev(n.right))
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub):
            return -ev(n.operand)
        raise ValueError(f"Disallowed expression element in {expr!r}")

    return ev(node)


# Unit conversions to cm^-1 (the reference uses Unitful + Spectral())
_UNIT_TO_WN = {
    "nm": lambda v: 1e7 / v,
    "um": lambda v: 1e4 / v,
    "µm": lambda v: 1e4 / v,
    "μm": lambda v: 1e4 / v,
    "cm^-1": lambda v: v,
}

_UNIT_RE = re.compile(r'u"([^"]+)"')


def parse_spec_band(expr: str) -> np.ndarray:
    """Parse one spec_bands entry into a wavenumber grid (cm^-1, ascending).

    Supported forms (all appear in the reference's YAML fixtures):
      "(1e7/777):0.015:(1e7/757)"  — Julia range start:step:stop
      "[18867.92 18868.92]"        — Julia matrix literal (grid points)
      with optional u"nm"/u"cm^-1" unit suffixes on the numbers.
    """
    s = expr.strip()
    unit = None
    m = _UNIT_RE.search(s)
    if m:
        unit = m.group(1)
        s = _UNIT_RE.sub("", s).replace("u", "")
    conv = _UNIT_TO_WN[unit] if unit else (lambda v: v)

    if s.startswith("["):
        vals = np.array([_safe_arith(t) for t in s.strip("[]").replace(",", " ").split()])
        wn = np.array([conv(v) for v in vals])
        return np.sort(wn)

    # Julia range a:s:b — split at top level (respect parentheses)
    parts, depth, cur = [], 0, ""
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == ":" and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    parts.append(cur)
    if len(parts) != 3:
        raise ValueError(f"Cannot parse spec band {expr!r}")
    start, step, stop = (_safe_arith(p) for p in parts)
    # Julia StepRangeLen semantics: start, start+step, ..., <= stop (fuzzy)
    n = int(np.floor((stop - start) / step + 1e-10)) + 1
    grid = start + step * np.arange(max(n, 0))
    wn = np.array([conv(v) for v in grid])
    return np.sort(wn)


_CTOR_RE = re.compile(r"^\s*(?:\w+\.)?(\w+)\s*(?:\{[^}]*\})?\s*(?:\((.*)\))?\s*$",
                      re.S)


def parse_constructor(expr: str):
    """Parse 'Name(args)' / 'Name{T}(args)' into (name, [args]).

    Arguments may be numbers, arithmetic, or a vector literal [a, b, ...].
    """
    m = _CTOR_RE.match(expr.strip())
    if not m:
        raise ValueError(f"Cannot parse constructor expression {expr!r}")
    name, argstr = m.group(1), m.group(2)
    args: List[Any] = []
    if argstr and argstr.strip():
        a = argstr.strip()
        if a.startswith("["):
            args.append([_safe_arith(t)
                         for t in a.strip("[]").replace(",", " ").split()])
        else:
            # split top-level commas
            depth, cur, parts = 0, "", []
            for ch in a:
                depth += ch in "([{"
                depth -= ch in ")]}"
                if ch == "," and depth == 0:
                    parts.append(cur)
                    cur = ""
                else:
                    cur += ch
            parts.append(cur)
            args.extend(_safe_arith(p) for p in parts if p.strip())
    return name, args


# ----------------------------------------------------------------------------
# Parameter dataclasses (ref: src/CoreRT/types.jl:394-446)
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class AerosolSpec:
    """One aerosol: log-normal size distribution + refractive index + vertical
    Gaussian-in-pressure profile. ref: parameters_from_yaml.jl:53-71."""
    mu: float            # log-mean radius (um)
    sigma: float         # log std-dev (geometric, >= 1)
    n_r: float
    n_i: float
    tau_ref: float
    p0: float            # pressure peak [hPa in profile units; yaml gives Pa]
    sigma_p: float
    # vertical density: 'gaussian' (default; Normal(p0, sigma_p) in p) or
    # 'uniform' between p0 and p_hi (RAMI aerosol placement,
    # ref: rami_tools.jl:118 Uniform(795, 1013))
    profile_type: str = "gaussian"
    p_hi: float = 0.0
    # optional bimodal size distribution overriding (mu, sigma)
    # (scattering.mie.BimodalAerosol; RAMI desert/continental shapes)
    bimodal: Any = None


@dataclasses.dataclass
class AbsorptionParameters:
    molecules: List[List[str]]
    vmr: Dict[str, Any]
    broadening: str          # 'Voigt' | 'Lorentz' | 'Doppler'
    cef: str                 # complex error function name
    wing_cutoff: float
    luts: List[Any] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ScatteringParameters:
    rt_aerosols: List[AerosolSpec]
    r_max: float
    nquad_radius: int
    lambda_ref: float
    n_ref: complex
    decomp_type: str         # 'NAI2' | 'PCW'


@dataclasses.dataclass
class RTParameters:
    """Mirror of vSmartMOM_Parameters (ref: types.jl:394-446)."""
    spec_bands: List[np.ndarray]
    surfaces: List[Dict[str, Any]]
    quadrature_type: str
    polarization_type: str
    max_m: int
    delta_angle: float
    l_trunc: int
    depol: float
    float_type: str
    architecture: str
    sza: float
    vza: np.ndarray
    vaz: np.ndarray
    obs_alt: float
    T: np.ndarray
    p: np.ndarray
    q: np.ndarray
    profile_reduction: int
    absorption_params: Optional[AbsorptionParameters]
    scattering_params: Optional[ScatteringParameters]


_REQUIRED = [
    ("radiative_transfer", "spec_bands"),
    ("radiative_transfer", "surface"),
    ("radiative_transfer", "quadrature_type"),
    ("radiative_transfer", "polarization_type"),
    ("radiative_transfer", "max_m"),
    ("radiative_transfer", "Δ_angle"),
    ("radiative_transfer", "l_trunc"),
    ("radiative_transfer", "depol"),
    ("radiative_transfer", "float_type"),
    ("radiative_transfer", "architecture"),
    ("geometry", "sza"),
    ("geometry", "vza"),
    ("geometry", "vaz"),
    ("geometry", "obs_alt"),
    ("atmospheric_profile", "T"),
    ("atmospheric_profile", "p"),
    ("atmospheric_profile", "profile_reduction"),
]

_QUAD_TYPES = {"RadauQuad", "GaussQuadHemisphere", "GaussQuadFullSphere"}
_POL_TYPES = {"Stokes_I", "Stokes_IQU", "Stokes_IQUV"}
_SURFACE_TYPES = {"LambertianSurfaceScalar", "LambertianSurfaceSpectrum",
                  "LambertianSurfaceLegendre", "rpvSurfaceScalar",
                  "RossLiSurfaceScalar"}


def _validate(d: dict, path: str):
    for keys in _REQUIRED:
        cur = d
        for k in keys:
            if not isinstance(cur, dict) or k not in cur:
                raise ValueError(
                    f"Missing key in parameters yaml {path}: {'/'.join(keys)}")
            cur = cur[k]


def parameters_from_yaml(path: str) -> RTParameters:
    """Load an RTParameters object from a (reference-schema) YAML file.

    ref: src/CoreRT/tools/parameters_from_yaml.jl:147-287
    """
    with open(path) as f:
        d = yaml.safe_load(f)
    _validate(d, path)

    rt = d["radiative_transfer"]
    spec_bands = [parse_spec_band(str(b)) for b in rt["spec_bands"]]

    surfaces = []
    for s in rt["surface"]:
        name, args = parse_constructor(str(s))
        if name not in _SURFACE_TYPES:
            raise ValueError(f"Unknown surface type {name}")
        if name == "LambertianSurfaceScalar":
            surfaces.append({"type": name, "albedo": args[0]})
        elif name == "LambertianSurfaceSpectrum":
            surfaces.append({"type": name, "albedo": args[0]})
        elif name == "LambertianSurfaceLegendre":
            # accepts both Legendre([a, b, ...]) and Legendre(a, b, ...)
            coeff = (args[0] if len(args) == 1 and isinstance(args[0], list)
                     else list(args)) or [0.0]
            surfaces.append({"type": name, "legendre_coeff": coeff})
        elif name == "rpvSurfaceScalar":
            # field order ref: CoreRT/types.jl:320-329 (rho0, rho_c, k, theta)
            surfaces.append({"type": name, "rho0": args[0], "rho_c": args[1],
                             "k": args[2], "theta": args[3]})
        elif name == "RossLiSurfaceScalar":
            # field order ref: CoreRT/types.jl:331-338 (fvol, fgeo, fiso)
            surfaces.append({"type": name, "fvol": args[0],
                             "fgeo": args[1], "fiso": args[2]})
        else:
            surfaces.append({"type": name, "args": args})

    quad_type, _ = parse_constructor(str(rt["quadrature_type"]))
    if quad_type not in _QUAD_TYPES:
        raise ValueError(f"Unknown quadrature type {quad_type}")
    pol_type, _ = parse_constructor(str(rt["polarization_type"]))
    if pol_type not in _POL_TYPES:
        raise ValueError(f"Unknown polarization type {pol_type}")

    geom = d["geometry"]
    prof = d["atmospheric_profile"]
    T = np.asarray(prof["T"], dtype=np.float64)
    p = np.asarray(prof["p"], dtype=np.float64)
    q = np.asarray(prof.get("q", np.zeros(len(T))), dtype=np.float64)

    absorption_params = None
    if "absorption" in d:
        ab = d["absorption"]
        broadening, _ = parse_constructor(str(ab["broadening"]))
        cef, _ = parse_constructor(str(ab["CEF"]))
        vmr = {}
        for k, v in ab["vmr"].items():
            vmr[k] = (np.asarray(v, dtype=np.float64)
                      if isinstance(v, (list, tuple)) else float(v))
        for band_mols in ab["molecules"]:
            for mol in band_mols:
                if mol not in vmr:
                    raise ValueError(f"{mol} listed as molecule but no vmr given")
        absorption_params = AbsorptionParameters(
            molecules=[list(m) for m in ab["molecules"]], vmr=vmr,
            broadening=broadening, cef=cef,
            wing_cutoff=float(ab["wing_cutoff"]),
            luts=list(ab.get("LUTfiles", [])))

    scattering_params = None
    if "scattering" in d:
        sc = d["scattering"]
        aerosols = []
        for a in sc["aerosols"]:
            if float(a["σ"]) < 1:
                raise ValueError("Geometric standard deviation has to be >= 1")
            aerosols.append(AerosolSpec(
                mu=float(a["μ"]), sigma=float(a["σ"]),
                n_r=float(a["nᵣ"]), n_i=float(a["nᵢ"]),
                tau_ref=float(a["τ_ref"]),
                p0=float(a["p₀"]), sigma_p=float(a["σp"])))
        decomp, _ = parse_constructor(str(sc["decomp_type"]))
        if "n_ref" in sc:
            n_ref = complex(str(sc["n_ref"]).replace("im", "j").replace(" ", ""))
        else:
            n_ref = complex(aerosols[0].n_r, -aerosols[0].n_i)
        scattering_params = ScatteringParameters(
            rt_aerosols=aerosols, r_max=float(sc["r_max"]),
            nquad_radius=int(sc["nquad_radius"]),
            lambda_ref=float(sc["λ_ref"]), n_ref=n_ref, decomp_type=decomp)

    return RTParameters(
        spec_bands=spec_bands, surfaces=surfaces,
        quadrature_type=quad_type, polarization_type=pol_type,
        max_m=int(rt["max_m"]), delta_angle=float(rt["Δ_angle"]),
        l_trunc=int(rt["l_trunc"]), depol=float(rt["depol"]),
        float_type=str(rt["float_type"]), architecture=str(rt["architecture"]),
        sza=float(geom["sza"]),
        vza=np.asarray(geom["vza"], dtype=np.float64),
        vaz=np.asarray(geom["vaz"], dtype=np.float64),
        obs_alt=float(geom["obs_alt"]),
        T=T, p=p, q=q,
        profile_reduction=int(prof["profile_reduction"] or -1),
        absorption_params=absorption_params,
        scattering_params=scattering_params)



"""Inelastic (Raman) scattering (ref: src/Inelastic/InelasticScattering.jl).

Port of ``vsmartmom/inelastic``: host-side numpy builders of the Raman
coupling specs that ``core/rt_raman.py`` consumes.
"""
from vsmartmom_torch.inelastic.constants import (MolecularConstants,
                                                 energy_levels,
                                                 molecular_constants)
from vsmartmom_torch.inelastic.plus import (AbsoluteRaman, ConcatBands,
                                            make_rrs_plus, make_rvrs_plus,
                                            make_vs_plus)
from vsmartmom_torch.inelastic.rrs import (RRS, greek_raman_coefs, make_rrs,
                                           make_rrs_profile, make_vs)
from vsmartmom_torch.inelastic.xsec import (RamanLines, apply_lineshape,
                                            cabannes_fraction,
                                            rayleigh_depol,
                                            rotational_raman_lines,
                                            vibrational_raman_lines)

__all__ = ["AbsoluteRaman", "ConcatBands", "MolecularConstants", "RRS",
           "RamanLines", "apply_lineshape", "cabannes_fraction",
           "energy_levels",
           "greek_raman_coefs", "make_rrs", "make_rrs_plus",
           "make_rrs_profile", "make_rvrs_plus", "make_vs", "make_vs_plus",
           "molecular_constants", "rayleigh_depol",
           "rotational_raman_lines", "vibrational_raman_lines"]

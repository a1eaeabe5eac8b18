from vsmartmom_torch.solar.model import (default_solar_spectrum_at_earth,
                                         default_solar_transmission,
                                         planck_spectrum_wl,
                                         planck_spectrum_wn,
                                         solar_transmission_from_file,
                                         watts_to_photons)

__all__ = ["planck_spectrum_wn", "planck_spectrum_wl", "watts_to_photons",
           "solar_transmission_from_file", "default_solar_transmission",
           "default_solar_spectrum_at_earth"]

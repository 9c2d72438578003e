from .phase_transitions import LinearLiquidus, PhaseTransitions, melting_temperature, latent_heat
from .heat_bcs import (PrescribedTemperature, MeltingConstrainedFluxBalance,
                       IceWaterThermalEquilibrium, RadiativeEmission, FluxFunction,
                       getflux, bottom_temperature)
from .slab import (ConductiveFlux, IceSnowConductiveFlux, ProportionalEvolution,
                   SlabThermodynamics, sea_ice_slab_thermodynamics,
                   snow_slab_thermodynamics)

__all__ = [
    "LinearLiquidus", "PhaseTransitions", "melting_temperature", "latent_heat",
    "PrescribedTemperature", "MeltingConstrainedFluxBalance",
    "IceWaterThermalEquilibrium", "RadiativeEmission", "FluxFunction",
    "getflux", "bottom_temperature",
    "ConductiveFlux", "IceSnowConductiveFlux", "ProportionalEvolution",
    "SlabThermodynamics", "sea_ice_slab_thermodynamics", "snow_slab_thermodynamics",
]

from .coriolis import FPlane, LatitudeCoriolis
from .stresses import SemiImplicitStress, StressFunction
from .rheologies import ElastoViscoPlasticRheology
from .momentum import (SeaIceMomentumEquation, SplitExplicitSolver, ImmersedDrag,
                       ImmersedStressBC)

__all__ = [
    "FPlane", "LatitudeCoriolis", "SemiImplicitStress", "StressFunction", "ElastoViscoPlasticRheology",
    "SeaIceMomentumEquation", "SplitExplicitSolver", "ImmersedDrag", "ImmersedStressBC",
]

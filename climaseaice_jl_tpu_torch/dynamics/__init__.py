from .coriolis import FPlane
from .stresses import SemiImplicitStress, StressFunction
from .rheologies import ElastoViscoPlasticRheology
from .momentum import (SeaIceMomentumEquation, SplitExplicitSolver, ImmersedDrag,
                       ImmersedStressBC)

__all__ = [
    "FPlane", "SemiImplicitStress", "StressFunction", "ElastoViscoPlasticRheology",
    "SeaIceMomentumEquation", "SplitExplicitSolver", "ImmersedDrag", "ImmersedStressBC",
]

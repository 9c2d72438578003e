"""climaseaice_jl_tpu_torch — the sea-ice model of `climaseaice_jl_tpu` in
PyTorch, with its TPU kernels rewritten by hand for NVIDIA Hopper (CUDA C++).

The JAX package stays the reference; this package keeps its module names,
its halo-inclusive ``(Nx+2Hx, Ny+2Hy)`` layout and its index convention, so
the two states compare element by element through numpy
(:mod:`.convert`).  It imports torch, numpy and the standard library only.

Grids live on the CUDA card unless the caller passes ``device="cpu"``.  The
EVP substep loop runs in a CUDA kernel: latitude-longitude, curvilinear and
tripolar grids (and rectilinear ones with a north fold) in
:mod:`.dynamics.fused_evp_curvilinear`, doubly periodic grids without land
in :mod:`.dynamics.fused_evp`, other bounded and immersed rectilinear grids
in :mod:`.dynamics.fused_evp_padded`; on CPU tensors the same routes run
the kernels' plain PyTorch versions.  The viscous rheology, the explicit
solver, the beta-plane, free drift and user forcing run on the general
path, as in the JAX package; :mod:`.examples` holds the eleven examples.
``SplitExplicitSolver(fixed_tiles=…)`` selects the decomposition-invariant
mode: the EVP loop with its
coefficients (pinned curvilinear tiles on grids with array metrics or a
north fold, with the ice strength), the tracer advection, the column
thermodynamics and pointwise forcing callables
(:mod:`.dynamics.fixed_tile_pointwise`) each run in a kernel whose
per-point arithmetic does not depend on the array shape or the halo width.
:mod:`.distributed_basin` builds the tripolar basin of
`validation/run_distributed_basin.py` in this mode.  :mod:`.parallel` steps
a model over a mesh of ``torch.distributed`` ranks, each rank's shard on its
own device (:func:`.parallel.make_distributed_step`); in the fixed-tile
mode the result equals the serial step's bit for bit, except with an
immersed drag on a mesh that splits the north fold across x: there the
fold halo, which evolves without refills, is not an exact mirror (the drag
samples each face at its own index), and the result parts from the serial
one in the rows next to the fold.  :mod:`.io` writes and restores
checkpoints (the JAX package's files, both ways) and NPZ and NetCDF output;
``Simulation.run`` picks up from a checkpoint and writes a device trace.
The side models: :mod:`.enthalpy` (the enthalpy-method column, one column
or a batch), :mod:`.coupled` (the ice over a slab mixed-layer ocean or over
:mod:`.ocean`'s shallow-water ocean, one ``coupled_step``; a float32 αEVP
ice model over the shallow-water ocean runs its momentum in the padded
kernel, the drag's ocean velocities being arrays).
"""

from .grids import (RectilinearGrid, LatitudeLongitudeGrid, CurvilinearGrid,
                    TripolarGrid, ImmersedBoundaryGrid, with_halo, Grid)
from .state import SeaIceState, Clock, ModelFields
from .model import (SeaIceModel, sea_ice_model, initial_state, set_fields, step,
                    step_unjitted, update_state, make_fields, cell_advection_timescale)
from .advection import Centered, UpwindBiased, WENO, FluxFormAdvection
from .thermodynamics import (LinearLiquidus, PhaseTransitions, melting_temperature,
                             latent_heat, PrescribedTemperature,
                             MeltingConstrainedFluxBalance, IceWaterThermalEquilibrium,
                             RadiativeEmission, FluxFunction, getflux,
                             ConductiveFlux, IceSnowConductiveFlux, ProportionalEvolution,
                             SlabThermodynamics, sea_ice_slab_thermodynamics,
                             snow_slab_thermodynamics)
from .forcing_utils import FieldTimeSeries
from .dynamics import (FPlane, BetaPlane, LatitudeCoriolis, SemiImplicitStress,
                       StressFunction, StressBalanceFreeDrift, ViscousRheology,
                       ElastoViscoPlasticRheology, SeaIceMomentumEquation, ExplicitSolver,
                       SplitExplicitSolver, ImmersedDrag, ImmersedStressBC)
from .simulation import (Simulation, Callback, IterationInterval, TimeInterval,
                         time_step)
from .parallel import make_distributed_step, strip_halos, unstrip_halos
from . import io

__version__ = "0.1.0"

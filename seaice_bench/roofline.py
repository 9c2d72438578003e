"""The yardstick of the roofline metrics: the published peaks of one NVIDIA
H100 and the operations and bytes of each piece of the step's work.

The counts are a frozen copy of ``chip_smoke.py:331-430`` (commit
25f59c9; the basin's fixed-tile kernels from commit 14c00ef, below), recounted there from each kernel's plain version: each value once
per point, loop-invariant forms once per call, selects not counted, a clamp
2.  The work is the same whatever kernel, plan or skip computes it.  A
piece's least time is the larger of its operations over the float32 peak
and its bytes over the memory bandwidth (``chip_smoke.py:1281``,
``bounds_ms``).
"""

from __future__ import annotations

# H100 SXM (NVIDIA data sheet): float32 outside the tensor cores, HBM3
FP32_FLOP_PER_S = 67e12     # chip_smoke.py:332
HBM_BYTES_PER_S = 3.35e12   # chip_smoke.py:331
F32 = 4

# periodic αEVP, 2.1 (csrc/evp.cu) per point and substep, and per call
FLOPS_PER_POINT_SUBSTEP = 142          # chip_smoke.py:347
FLOPS_PER_POINT_CALL = 2               # :348
EVP_ARRAYS_READ = 18                   # :349, 12 constants + 6 carried fields
EVP_ARRAYS_WRITTEN = 6                 # :350
# 2.2 (csrc/evp_tiled.cu): 2.1's substep, its coefficients derived once a call
TILED_FLOPS_PER_POINT_CALL = 24        # :357
TILED_ARRAYS_READ = 11                 # :358
# WENO-7 flux-form advection of one tracer, per padded point (the eager
# path computes the same function as 2.9)
ADV_FLOPS_PER_POINT = 1023             # :390
ADV_BYTES_PER_POINT = 18               # :391
# the slab column, bare ice with constant fluxes, per padded point
THERMO_FLOPS_PER_POINT = 254           # :398
THERMO_ARRAYS = 12                     # :399

# The fixed-tile kernels of the tripolar basin, frozen from chip_smoke.py
# (commit 14c00ef), each counted as its plain version computes it.
# 2.7 (csrc/evp_tiled_curvilinear.cu) computes 2.6's substep with the
# immersed drag, per point of the widened grid and substep (:375-384), and
# its loop-invariant block once a call (:423-431); it reads the 21 raw
# planes and the 6 carried fields and writes those 6, with 22 parameters
# (:428-429, :2828-2830).  With LatitudeCoriolis it reads one plane more, f
# at the centres, and averages it to the two velocity points once a call (4
# operations), which chip_smoke's count of the basin under FPlane leaves out.
CURV_FLOPS_PER_POINT_SUBSTEP = 185     # :384
TC_FLOPS_PER_POINT_CALL = 54 + 4       # :430, and f at the velocity points
TC_ARRAYS = 27 + 1 + 6                 # :431 (raw and carried), f, written
TC_PARAMS = 22
# 2.9 with array metrics, per padded point and tracer: 1023 operations, one
# more for the second product at each face less one in (δx + δy)/Az, and
# the three metric arrays read (:2568-2572)
ADV_METRIC_FLOPS_PER_POINT = ADV_FLOPS_PER_POINT + 1
ADV_METRIC_BYTES_PER_POINT = ADV_BYTES_PER_POINT + 12
# 2.11, snow on ice under the basin's top flux, per padded point:
# layered_thermo_flops(F) (:445-446) with F = 17, the recorded solar
# program's 9 operations, the sums 5 and emission 3 (:2954), 756 in all (the
# kernel table's row 2.11); 17 arrays read and written (:436)
LAYERED_THERMO_FLOPS_PER_POINT = 756
LAYERED_THERMO_ARRAYS = 17
# 2.8 (csrc/ice_strength_fixed.cu) per point of the widened grid: 5
# operations, h and ℵ read and P written, 2 parameters (:420-423, :2862)
STRENGTH_FLOPS_PER_POINT = 5
STRENGTH_ARRAYS = 3
# 2.10, the basin's two wind units per padded point: the recorded programs'
# 51 (x) and 52 (y) operations (chip_smoke.program_flops of each plan),
# longitude and latitude read, the stress written, the time (:2920-2921)
WIND_FLOPS_PER_POINT = (51, 52)
POINTWISE_ARRAYS = 3


def least_ms(flops, nbytes):
    """The least time of a piece of work (ms): the larger of its two bounds."""
    return max(flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3


def periodic_evp(points, substeps, tiled):
    """(operations, bytes) of one call of the periodic EVP loop over
    ``points`` interior points: 2.2's counts where ``tiled``, else 2.1's."""
    if tiled:
        flops = points * (FLOPS_PER_POINT_SUBSTEP * substeps + TILED_FLOPS_PER_POINT_CALL)
        nbytes = points * F32 * (TILED_ARRAYS_READ + EVP_ARRAYS_WRITTEN)
    else:
        flops = points * (FLOPS_PER_POINT_SUBSTEP * substeps + FLOPS_PER_POINT_CALL)
        nbytes = points * F32 * (EVP_ARRAYS_READ + EVP_ARRAYS_WRITTEN)
    return flops, nbytes


def advection(points, tracers):
    return (tracers * points * ADV_FLOPS_PER_POINT,
            tracers * points * ADV_BYTES_PER_POINT)


def bare_column(points):
    return points * THERMO_FLOPS_PER_POINT, points * F32 * THERMO_ARRAYS


def tiled_curvilinear_evp(points, substeps):
    """(operations, bytes) of one call of 2.7 over ``points`` points of the
    widened grid."""
    flops = points * (CURV_FLOPS_PER_POINT_SUBSTEP * substeps + TC_FLOPS_PER_POINT_CALL)
    return flops, (TC_ARRAYS * points + TC_PARAMS) * F32


def advection_metrics(points, tracers):
    """(operations, bytes) of 2.9 with array metrics on ``tracers`` tracers."""
    return (tracers * points * ADV_METRIC_FLOPS_PER_POINT,
            tracers * points * ADV_METRIC_BYTES_PER_POINT)


def layered_column(points):
    """(operations, bytes) of one call of 2.11 on the basin's column."""
    return points * LAYERED_THERMO_FLOPS_PER_POINT, points * F32 * LAYERED_THERMO_ARRAYS


def strength_and_winds(widened, points, winds):
    """(operations, bytes) of one stage's 2.8 over the widened grid and its
    ``winds`` wind units of 2.10 over the padded grid."""
    flops = STRENGTH_FLOPS_PER_POINT * widened + sum(WIND_FLOPS_PER_POINT[:winds]) * points
    nbytes = (STRENGTH_ARRAYS * widened + 2) * F32 + winds * (POINTWISE_ARRAYS * points + 1) * F32
    return flops, nbytes

"""The yardstick of the roofline metrics: the published peaks of one NVIDIA
H100 and the operations and bytes of each piece of the step's work.

The counts are a frozen copy of ``chip_smoke.py:331-430`` (commit
25f59c9), recounted there from each kernel's plain version: each value once
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

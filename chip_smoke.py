"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # the whole check, one card
    python3 chip_smoke.py --profile F  # also write torch.profiler tables of
                                       # one flagship (512² and 2048²), one
                                       # bounded, one tripolar basin and one
                                       # fixed-tile step to file F
    python3 chip_smoke.py --parent D   # also hold 2.10 and 2.4 against a
                                       # checkout D of commit 2a3ee95, in turns
                                       # (any other tree is refused)

Drives the port (``climaseaice_jl_tpu_torch``) through the entry points a
user calls and holds its CUDA kernels against their plain PyTorch versions.
Phases, each of which raises (exit code 1) when it fails:

1. build the CUDA kernels from ``climaseaice_jl_tpu_torch/csrc`` and the
   column-kernel units generated for the script's three flux
   configurations (bare ice under number fluxes, snow under series and
   emission, the basin's solar FluxFunction), the pointwise units of the
   basin's two wind components and of sin(x)·cos(x), one ``nvcc`` each, all
   at once;
2. the EVP kernel (2.1) vs its plain version on the card: the flagship at
   512² in soft ice (P★ = 27.5), 120 substeps; bitwise over the whole
   interior (0 ulp, a gate), so within the bars u/v ≤ 1e-4, σ/α ≤ 4e-3
   relative to the field's largest value; one launch a chunk of K
   substeps; its registers, spill, shared memory and blocks per SM; times
   per call of both and the bound;
3. the main path: the flagship step of ``bench.py:build(512, 120)`` (float32,
   αEVP with 120 substeps, WENO-7, bare-ice slab thermodynamics, RK3), one
   warm-up step and five timed steps; the state must stay finite with
   h ≥ 0 and 0 ≤ ℵ ≤ 1, and the EVP wrapper must have been called 3 times
   per step with phase 2's launches per call;
4. the dispatch boundary between the periodic kernels: one flagship step
   at 512² (262,144 points) goes through ``csrc/evp.cu`` (2.1) only, one at
   768² (589,824 points, above the 571,099 points where the JAX package
   switches) through ``csrc/evp_tiled.cu`` (2.2) only, and one at 4096²
   through 2.2, finite, each kernel with its launches per call;
5. the same port on the card and on the CPU (the plain version), 128² soft
   ice, 2 RK3 steps; bars as in phase 2 and 1e-5 for h/ℵ;
6. the padded EVP kernel vs its plain version on the card: the bounded and
   immersed configuration of ``validation/perf_sweep.py:build(512,
   bounded=True)`` (512² box, island of radius 60 km, ImmersedDrag) in soft
   ice, 120 substeps, seeded velocities; bitwise over the whole padded
   arrays (0 ulp, a gate: the parent design was), so within phase 2's bars;
   one launch a chunk of K substeps; its registers, spill, shared memory and
   blocks per SM; times per call of both; then the curvilinear kernel on
   the same input, held against the padded kernel with the same bars, and
   the two kernels timed in turns;
7. the slice's main path: that configuration at the default P★, one warm-up
   step and five timed steps; finite and physical, h = ℵ = 0 on land, u and
   v zero on peripheral nodes, the padded wrapper called 3 times per step
   (phase 6's launches per call) and the periodic one never;
8. the example configurations through the normal entry points, built by
   ``climaseaice_jl_tpu_torch.examples`` in float32: the anticyclone (128²,
   bounded, StressFunction wind, array ocean currents, 150 substeps) for 5
   ``cst.step`` calls, and the coastline (256×128, periodic-x, immersed
   coast, ImmersedDrag, 150 substeps) for 10 iterations of
   ``Simulation.run`` with a callback; both finite, physical, land empty and
   through the padded kernel, one launch a chunk;
9. the same port on the card and on the CPU, 128² bounded and immersed soft
   ice with the anticyclone example's StressFunction wind and array ocean
   currents and ImmersedDrag, 2 RK3 steps; bars as in phase 5;
10. the curvilinear EVP kernel vs its plain version on the card: the
    tripolar Arctic basin of ``validation/run_tripolar_basin.py:build(1152,
    960)`` (1162×970 padded, Zipper fold, land, ImmersedDrag, f(φ) planes)
    in soft ice with seeded velocities, 120 substeps, over the whole padded
    arrays: bitwise and within phase 2's bars, the kernel's settled-block
    flags equal to their plain version's, the settled share printed; times
    per call of both; then the same check on a 360×160 latitude-longitude
    grid (no fold, no land, no drag, FPlane; no settled block);
11. the slice's main path: the basin at the default P★ (snow,
    FieldTimeSeries fluxes, LatitudeCoriolis, StressFunction winds), dt 300
    s: one warm-up step, five timed ``cst.step`` calls and two iterations of
    ``Simulation.run``; every field finite, halos included; h, hs ≥ 0, 0 ≤
    ℵ ≤ 1; h = ℵ = hs = 0 on land; the fold halo of u equal to minus its
    mirror; every EVP call through the curvilinear kernel (3·120 + 3
    launches a call) and none through the other two; one profiled step's
    device time gives the device-busy share;
12. the same port on the card and on the CPU, the 96×80 basin in soft ice
    with 10 cm of snow on the ice at the start, 2 RK3 steps; bars u/v ≤
    1e-4, σ/α ≤ 4e-3, h/ℵ/hs ≤ 1e-5.  (Without initial snow, hs after two
    steps is 6e-6 m of fresh snow, and flooding of thin ice moves one
    float32 ulp of h, 3.7e-9 m at 5 cm, into it: 1e-4 of its largest value
    whichever device runs.)
13. the fixed-tile kernels vs their plain versions on the card, at the
    slice's 522² padded shape (phase 6's configuration with
    ``fixed_tiles=(8, 128)`` and the wide halo policy, soft ice, seeded
    velocities), each timed per call with its plain version: the EVP
    coefficients (the plain version's raw bits, a gate, also with the
    peripheral masks folded in; its device time a launch under
    torch.profiler beside the CUDA-event time a call and the host time a
    call; its registers and stack frame, a gate: no stack frame, no spill;
    with ``--parent DIR`` against the earlier tree's build, its raw bits a
    gate, timed in turns, and the device operations of the EVP launcher's
    inputs before and after); the tiled EVP loop (bitwise over the
    interiors, 0 ulp, as the parent design was, so within phase 2's bars;
    bitwise against itself with chunks of 1 and K substeps and against the
    padded kernel on the same input; one launch a chunk; its registers,
    spill, shared memory and blocks per SM; timed in turns with the padded
    kernel); the WENO-7 advection through the tile kernel, the plain
    version's raw bits over the padded arrays, so within 1e-6, also with
    UpwindBiased(5) in x and Centered(2) in y through the runtime-scheme
    kernel, and on the 1162×970 basin grid with array metrics, timed; the
    column thermodynamics of bare ice and of snow on ice under the basin's
    series and emission, the plain version's raw bits in every output, so
    within 1e-5, with the wrapper's host time per call; the registers and
    stack frame of the tile kernels and the two column units (a gate: no
    stack frame, no spill);
14. the fixed-tile slice's main path at the default P★: one warm-up step,
    five timed ``cst.step`` calls and two iterations of ``Simulation.run``;
    finite and physical, land empty, u and v zero on peripheral nodes; per
    step 3 tiled EVP, 3 coefficient, 6 advection and 3 thermodynamics calls
    and no padded, periodic or curvilinear EVP call; in turns with phase
    7's slice; one profiled step's device-busy share and device operations
    (with ``--parent`` also with the earlier tree's coefficient launch and
    launcher inputs); then two steps of the
    slice with UpwindBiased(5) in x and Centered(2) in y, 12 launches of
    2.9's runtime-scheme kernel;
15. halo 5 against halo 19 on the card: the fixed-tile slice for five RK3
    steps, bitwise-equal interiors of u, v, h, ℵ, σ₁₁, σ₂₂, σ₁₂ and α;
16. the fixed-tile route on the card and on the CPU, 128² bounded + island
    + drag in soft ice, 2 RK3 steps; bars as in phase 5;
17. the tripolar fixed-tile kernels vs their plain versions on the card, on
    the basin of ``validation/run_distributed_basin.py:build(1152, 960,
    fixed_tiles=(8, 128))`` in soft ice with seeded velocities, 24
    substeps, each timed per call with its plain version: the pinned
    curvilinear EVP loop on the 1162×1018 widened arrays (the plain
    version's bits over the interiors, signed zeros included, a gate, so
    within phase 2's bars; its settled-block
    flags equal to their plain version's, the settled share printed; 2 +
    refills + 3·24 launches; with chunks of 4 and 2 substeps, and against
    the whole-array curvilinear kernel fed the same coefficients, bitwise
    or within 1e-5, timed in turns with it, with that kernel's share of
    settled blocks); the ice strength on the
    widened h, ℵ (within 2 ulp); both
    wind components through their generated units (within 2 ulp, the same
    bits at one and four points a thread, timed in turns; the units'
    registers and stack frame, a gate: no spill, and no stack frame beyond
    the one a unit of sin(x)·cos(x) alone keeps (CUDA's sinf and cosf, for
    the argument reduction of |x| > 105615); device time a launch
    under torch.profiler; with ``--parent`` the earlier tree's interpreter's
    raw bits, a gate, timed in turns with host time a call); the snow
    column physics with the solar FluxFunction (the plain version's raw
    bits, so within 1e-5; its unit's registers and stack frame, a gate as in
    phase 13);
18. the slice's main path: that basin at the default P★, dt 600 s, one
    warm-up step, five timed ``cst.step`` calls and two iterations of
    ``Simulation.run``; every field finite, halos included, h, hs ≥ 0,
    0 ≤ ℵ ≤ 1, land empty, the fold halo of u equal to minus its mirror; per
    step one pinned EVP call (two chunks), one ice-strength, two wind, three
    advection and one column call, and no call of the other EVP kernels; in
    turns with the same build without ``fixed_tiles``; one profiled step's
    device-busy share, device operations and host waits;
19. halo 5 against halo 19 on the card: the basin at 360×300 (the script's
    default size), 3 steps, bitwise-equal interiors of u, v, h, ℵ, hs, σ₁₁,
    σ₂₂, σ₁₂ and α;
20. the tripolar fixed-tile route on the card and on the CPU, the 32×64
    basin in soft ice with seeded velocities and 10 cm of snow, 2 steps;
    bars as in phase 12;
21. the tiled EVP kernel (2.2) vs its plain version on the card: the
    flagship at 2048² in soft ice with seeded velocities, 120 substeps;
    bitwise (0 ulp, a gate) and within phase 2's bars; its registers,
    spill, shared memory and blocks per SM; times per call of both and the
    bound; then 2.1 on the same grid timed in turns with 2.2, each fed its
    own inputs (the run fails unless 2.2 is faster than 2.1), and how far
    the two functions' results lie apart (a record, not a bar);
22. the slice's main path: ``bench.py:build(2048, 120)`` at the default P★,
    one warm-up step, five timed ``cst.step`` calls and two iterations of
    ``Simulation.run``; finite and physical; per step 3 calls of 2.2 (one
    launch per chunk of the route plan's K substeps) and none of 2.1 or the
    other EVP kernels; one profiled step's device-busy share;
23. the same port on the card and on the CPU, 768² soft ice (through 2.2
    and its plain version), 12 substeps, 2 RK3 steps; bars as in phase 5;
24. kernels 2.7 and 2.9 on one shard of the distributed step: shard (1, 1)
    of a (2, 2) mesh of the basin of phase 17 with halos 2·24+3 (the
    'wide' policy), soft ice, seeded velocities, 24 substeps; no wrap along
    the split directions, the walls gated on the shard's position, no
    refill of the fold split across x; each bitwise against its plain
    version (2.7 over the interiors, signed zeros included, with its settled
    flags and share as in phase 17, 2.9 over the padded arrays, signed zeros
    included), timed per call with its plain
    version and its bound; both wind components (2.10) on every shard of
    the (2, 2) mesh within 2 ulp of their plain version (with ``--parent``
    the earlier tree's interpreter's raw bits, a gate);
25. the distributed step (``parallel.make_distributed_step``) on four gloo
    ranks sharing the card, after asking gloo whether its send and receive
    take CUDA tensors: the basin of phase 18 at the default P★, dt 600 s, 3
    steps on (1, 4) and on (2, 2), with and without the immersed drag;
    interiors of u, v, h, ℵ, hs, σ₁₁, σ₂₂, σ₁₂ and α bitwise equal to the
    serial card run, except with the drag on (2, 2), where the fold halo
    evolving without refills is not an exact mirror (the drag samples each
    face at its own index) and the pole rows' non-contractive αEVP
    amplifies the seed: per field the count of points that differ, the
    largest differences off and in the top 12 rows and the deepest row are
    printed, every such point must lie in the top 51 rows, and off the top
    12 rows the run must meet `run_distributed_basin.py:279-286`'s bars
    (u, v below 2e-2, h, ℵ, hs below 5e-3 of the field's largest value;
    `distributed_basin.xsplit_drag_band`); a band of 1e-7 of the largest
    value is not met and stands open in ROADMAP.md §3; every rank runs 2.7
    (without refills where x is split), 2.8, 2.9, 2.10 and 2.11 and none of
    the other EVP kernels; each rank's device, ms per step and bytes sent
    per step;
26. a 128² doubly periodic float64 run under the 'per_substep' policy on
    the same ranks, 5 steps, in the deferred form (local fills in both
    half-updates, one joint u, v exchange a substep) within rtol 1e-7, atol
    1e-9 of the serial card run (`tests/test_distributed.py:81`'s contract),
    and in turns with the per-half-update form (the gate turned off,
    ``exchange_every_half_update``): interiors bitwise equal
    between the forms, 22 exchange rounds a step fewer, each form's rounds,
    ms per step and bytes sent; the first run's ranks write their snapshots
    and sharded checkpoints, which must restore bitwise and reassemble to
    the gathered state;
27. kernels 2.3, 2.4 and 2.5 meshed on shard (1, 1) of a (2, 2) mesh of the
    512² flagship with halos 2·120+3 (742² padded), soft ice, seeded
    velocities, 120 substeps: 2.3 (no fill along the split directions)
    bitwise against its plain version over the whole padded arrays, also
    with phase 6's island and drag put on the periodic grid, across all
    four shards; 2.4 (images clamped at the padded edge) over the padded
    arrays, with its device time a launch (with ``--parent`` against the
    earlier tree's build as in phase 13); 2.5 (the padded extent carried) over the interiors, with its
    distance over the split directions' padded extent printed (a record:
    that band goes stale from the padded edge and depends on the chunk
    length); each timed per call with its plain version and its bound;
28. kernel 2.7's unpinned plan on a (1, 4) shard that holds the fold and on
    a (2, 2) shard of the 1152×960 basin without fixed_tiles (halos 51),
    soft ice, seeded velocities, 24 substeps: the plain version's bits over
    the interiors, signed zeros included, its settled flags and share as in
    phase 17, timed, with its bound and launches; and the settled share of each shard of path C (phase 30);
29. the wide-halo distributed step on four gloo ranks sharing the card,
    3 RK3 steps: path A (``bench.py:build(512, 120)`` under
    ``halo_exchange="wide"``, soft ice and the default P★) bitwise equal to
    the serial card step whose momentum goes through the padded route, and
    in soft ice within `tests/test_distributed.py:238-248`'s bars of the
    serial 2.1 step (u, v ≤ 2e-2 of the velocity scale, h, ℵ ≤ 1e-4); path
    B (the same with ``fixed_tiles=(8, 128)``) bitwise equal to the serial
    card step; every rank runs only 2.3 (A), or 2.4, 2.5, 2.9 and 2.11 (B);
    finite and physical; each rank's device, ms per step and bytes sent;
30. path C, the basin of ``distributed_basin.build(1152, 960,
    halo_exchange="wide")`` (2.7's unpinned plan on every shard), 3 steps
    of 600 s on (1, 4) and (2, 2), with and without the immersed drag,
    against the serial card step whose momentum runs the same plan:
    bitwise without the drag, held to phase 25's band with it; the distance
    from the default serial step (2.6, which forms its coefficients
    otherwise) printed as a record; every rank runs only 2.7;
31. the momentum physics beyond the EVP kernels at full width: the grid,
    stresses, thermodynamics, WENO-7 and RK3 of ``bench.py:build(512,
    120)`` with (a) ViscousRheology(ν = 1000) + ExplicitSolver +
    BetaPlane(1.4e-4, 1e-11), (b) the αEVP flagship with constant forcing
    rates on h and u, (c) StressBalanceFreeDrift as the whole dynamics (the
    flagship's scalar top stress over SemiImplicitStress); each one warm-up
    and 3 timed steps, finite and physical, no EVP kernel called (the fused
    gates refuse these physics, as JAX's do), (b) through the general
    split-explicit path, (c) at the closed-form velocity;
32. forcing under ``fixed_tiles``: phase 14's slice with a callable forcing
    on h, 3 steps (the last two timed), finite, h = ℵ = 0 on land; 2.9 and
    2.11 with their launches a step (6 and 3), 2.4 and 2.5 never (the EVP
    gates refuse forcing), the momentum on the general path;
33. the same port on the card and on the CPU for (a)-(c) at 128², 2 RK3
    steps (the card's timed, the code warmed up by phase 31): (a) and (c)
    h, ℵ, u, v within 1e-5 of the field's largest value, (b) at P★ = 27.5
    in phase 5's bars;
34. the port's eight examples (``climaseaice_jl_tpu_torch.examples``) on
    the card, float64 as the examples build them: each the short run of
    `tests/test_examples.py` with its assertions, through ``cst.step`` or
    ``Simulation.run``.
35. the 'overlap' policy on the same ranks and case, on (2, 2) and (1, 4):
    every rank in the overlap form, interiors bitwise equal to the deferred
    form's on the same mesh (else within rtol 1e-7, atol 1e-9 of the serial
    card run), each rank's ms per step beside the deferred form's;
36. the three builds of phase 33 at 128² (the viscous explicit beta-plane,
    the forced αEVP flagship in soft ice, free drift as the whole dynamics)
    on the same ranks on (2, 2), 2, 1 and 2 RK3 steps: h, ℵ, u, v within
    1e-5 of the serial card run's largest value, the ulp distance printed;
37. the run loop's I/O with ``bench.py:build(512, 120)``: 4 steps through
    ``Simulation.run``; 2 steps with a Checkpointer at step 2 and a fresh
    run picked up from it (``pickup=True``) to step 4, bitwise equal to the
    uninterrupted run, 2.1 launched 360 times on the resumed path and no
    other EVP kernel; a NetCDF record of the card's state read back equal;
    one step under ``run(profile_dir=…)``, whose Chrome trace holds one
    event of 2.1's kernel per launch the counter saw;
38. the enthalpy column (``climaseaice_jl_tpu_torch.enthalpy``): the
    diffusive-column example at its full length (10 days, 8,640 steps of
    100 s, float64) against `validation/diffusive_ice_column.npz` (rtol
    1e-9, atol 1e-11); a (512, 512) batch of 20-cell columns, 100 steps,
    finite, timed; the card against the CPU on a (16, 16) batch, within
    1e-12;
39. the ice over the slab ocean: the ``ice_ocean_coupled`` example's two
    years (2,880 steps of 6 h on 8×8, float64), its 72 records of mean h,
    SST and salinity within 1e-6 of each series' largest magnitude of
    `validation/ice_ocean_coupled.npz`;
40. the ice over the shallow-water ocean: (a) the
    ``melting_over_dynamic_ocean`` example at `tests/test_examples.py`'s
    short length (32², 12 steps, float64) with that test's assertions; (b)
    its configuration in float32 at 512² (``coupled_channel``), a warm-up
    and 3 timed ``coupled_step`` calls: 2.3 launched 60 times a call and 3
    calls a step, 2.1 and 2.2 never; finite, h ≥ 0, 0 ≤ ℵ ≤ 1, the ice and
    the ocean at rest on the walls, ∑η·Az conserved to float32 roundoff;
    in turns with the ice step alone; the device-busy share of one profiled
    coupled step; 2.3 against its plain version on that path's input (the
    ocean's seeded u, v as uₑ, vₑ; soft ice, seeded velocities), bitwise, timed,
    with its bound; (c) the card against the CPU at 128², float32, soft ice,
    seeded ice velocities over an ocean at rest, 2 steps: u, v ≤ 1e-4, σ, α
    ≤ 4e-3, h, ℵ, SST, salinity, η ≤ 1e-5 of each field's largest value.
    Phase 40 steps Δt = 1200 s · 32/N, the ocean's Courant number of the
    example's tested 32² run.
Phases 31-34 and 38-40 print ms per step (CUDA events) with the card's
name and power limit, and their seconds.

Then it prints the card's name and power limit, one JSON line describing
each kernel, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device it exits with code 2 and prints no result.  Before it
exits, whatever the outcome, it stops and reaps every process it started.
"""

import argparse
import contextlib
import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# The operations bound of each kernel counts the float32 operations its
# function needs, as its plain version computes them: each value once per
# point (a strain rate at its own point, not again at its neighbours'),
# loop-invariant forms once per call, a shared product once; selects are
# not counted, a clamp counts 2, the replacement pressure (the default) is
# counted.  The kernels themselves do more (they recompute the neighbours'
# strain rates and masked stresses), which their time shows and the bound
# does not.
#
# csrc/evp.cu, per point and substep: σ relaxation 72 (strain rates 11,
# cc↔ff averages 9, Δ² 12, rsqrt/min 4, ζ 2, replacement pressure 5, η 2,
# σ targets 9, γ 9, σ updates 9), each update 35 (divergence 5, transverse
# average 3, relative speed 6, forcing G 12, 1/Δτ 3, update 6); per point
# and call ½P and ½Pff
FLOPS_PER_POINT_SUBSTEP = 142
FLOPS_PER_POINT_CALL = 2
EVP_ARRAYS_READ = 18     # 12 constants + 6 carried fields
EVP_ARRAYS_WRITTEN = 6
EVP_PARAMS = 18
# csrc/evp_tiled.cu computes evp.cu's substep function; its function derives
# the coefficients once per call, per point (the kernel derives them again
# at each use, which the bound does not count): the four face averages 8,
# m_ff 4, Pff 4, gcc and gff 2, the two 1/m 2, the two drags 2, ½P and ½Pff
# 2; it reads m, ℵ, P, uⁿ, vⁿ and the 6 carried fields and writes those 6
TILED_FLOPS_PER_POINT_CALL = 24
TILED_ARRAYS_READ = 11
# csrc/evp_padded.cu with immersed drag: σ relaxation 72, masked σ 3, each
# update 40 (evp.cu's 35 and the immersed drag 5); 145 without drag; per
# call ½P, ½Pff and the two transverse averages of the ocean velocity 6
PADDED_FLOPS_PER_POINT_SUBSTEP = 155
PADDED_FLOPS_PER_POINT_CALL = 8
PADDED_ARRAYS_READ = 28  # 22 constants (with drag) + 6 carried fields
# csrc/evp_curvilinear.cu with immersed drag: σ relaxation 84 (strain rates
# ϵ̇D 6, ϵ̇T 8, ϵ̇S 8; averages 9, Δ² 12, rsqrt/min 4, ζ 2, replacement
# pressure 5, η 2, σ targets 10, γ 9, σ updates 9), the metric stress
# divergences 31 (masked σ 3, sum and difference 2, metric products 4, each
# divergence 11), each update 35 (transverse average 3, relative speed 6, G
# 12, immersed drag 5, 1/Δτ 3, update 6); 175 without drag; per call ½P,
# ½Pff, the ocean velocity averages 6 and the 8 metric forms
CURV_FLOPS_PER_POINT_SUBSTEP = 185
CURV_FLOPS_PER_POINT_CALL = 16
# 12 metrics, 14 constants, 4 drag and 4 stress arrays, 2 f planes, 6 carried
CURV_ARRAYS_READ = 42
# csrc/evp_prep.cu, per padded point: m 2, P 5 (the exp counted as 1), Pff 6,
# m_ff 6, the four face averages 8, the two γ² coefficients 4, the two 1/m 2,
# the two drags 2; h and ℵ read, 10 coefficients written, 7 parameters
PREP_FLOPS_PER_POINT = 35
PREP_ARRAYS = 12
PREP_PARAMS = 7
# csrc/evp_tiled_padded.cu computes evp_padded.cu's function (the PADDED_*
# counts above, on the same padded input)
# csrc/advection_fixed.cu with WENO-7, per padded point: at each of its x
# and y faces two one-sided reconstructions of 253 (4 candidate stencils:
# value 8, smoothness 48 from the 64 nonzero β terms, weight 4, sums 3; the
# quotient 1), the upwind average 2 and the flux product 1 at each face, and
# the divergence 5; u, v, c read as float32 and the two face masks as bytes,
# the divergence written
ADV_FLOPS_PER_POINT = 1023
ADV_BYTES_PER_POINT = 18
# csrc/thermo_column.cuh, bare ice with constant fluxes and 20 secant
# iterations, per padded point: the secant 210 (2 starting iterates, 22
# balance evaluations of 4, 20 updates of 6), the cap at Tₘ 3, conduction 3,
# the two latent energies 8, the volume tendency 5, the volume and
# concentration update 19, mf_ice 4, Qtop and Qbot 2; h, ℵ, S, Tu read and 8
# outputs written
THERMO_FLOPS_PER_POINT = 254
THERMO_ARRAYS = 12
# csrc/evp_tiled_curvilinear.cu computes evp_curvilinear.cu's substep
# function (CURV_FLOPS_PER_POINT_SUBSTEP) and derives its loop-invariant
# block once per call, per padded point: the 8 metric forms, m 2, P 5, Pff 3,
# m_ff 3, the four face averages 8, gcc and gff 4, the two 1/m 2, the two
# drags 2, the peripheral masks 3, the σ masks 2, the immersed-drag weights
# 4, the ocean velocity averages 6, ½P and ½Pff 2
TC_FLOPS_PER_POINT_CALL = 54
TC_ARRAYS_READ = 27      # 21 raw planes + 6 carried fields
# csrc/ice_strength_fixed.cu: P★·h, 1 − ℵ, its product with −C, exp and the
# product, per point; h and ℵ read, P written
STRENGTH_FLOPS_PER_POINT = 5
STRENGTH_ARRAYS = 3
# the generated pointwise units (2.10): the recorded program's operations per
# point, each value once (the recorder shares repeated subexpressions), a
# clamp 2, selects not counted; longitude and latitude read, the stress
# written
POINTWISE_ARRAYS = 3
# csrc/thermo_column.cuh, snow on ice, 20 secant iterations, the basin's top
# flux (the solar program, three series and emission, summed: F operations),
# per padded point: the secant 2 + 22·(F + 6) + 20·6, its cap 3, the
# interface temperature 6, conduction 5, the top flux once more F, the
# snow-surface balance 8, the closed-form ℵ 21, the latent energies 8, the
# volume tendency 5, the volume and concentration update 19, snow rebasing,
# snowfall and flooding 24, the diagnostics 12; h, ℵ, hs, S, Tu, Tus and the
# latitude read, 10 outputs written
LAYERED_THERMO_ARRAYS = 17
# csrc/evp_padded.cu without immersed drag (the coupled channel): 145 a point
# and substep; 14 constants, the 4 stress arrays (τ top, the ocean's uₑ, vₑ)
# and the 6 carried fields read
PADDED_NODRAG_FLOPS_PER_POINT_SUBSTEP = 145
PADDED_NODRAG_ARRAYS_READ = 24
# the three examples that run the side models (phases 38-40)
SIDE_MODEL_EXAMPLES = ("diffusive_ice_column_model", "ice_ocean_coupled",
                       "melting_over_dynamic_ocean")


def layered_thermo_flops(F):
    return 2 + 22 * (F + 6) + 120 + 3 + 6 + 5 + F + 8 + 21 + 8 + 5 + 19 + 24 + 12


def program_flops(ops):
    """Operations per point of a recorded program (a clamp 2, selects,
    loads and stores not counted)."""
    from climaseaice_jl_tpu_torch.dynamics import fixed_tile_pointwise as fpw
    free = (fpw.OP_CONST, fpw.OP_ARRAY, fpw.OP_SCALAR, fpw.OP_TEMP, fpw.OP_LOAD,
            fpw.OP_STORE, fpw.OP_WHERE)
    return sum(2 if op == fpw.OP_CLAMP else 1 for op, _, _ in ops if op not in free)
KM = 1000.0
MINUTE, DAY = 60.0, 86400.0


def flagship(cst, N, substeps=120, P_star=27500.0, device="cuda", halo=5, wide=False,
             fixed_tiles=None):
    """The configuration of bench.py:build(N, substeps), in the port; ``wide``
    sets the wide halo policy, ``fixed_tiles`` the fixed-tile mode."""
    grid = cst.RectilinearGrid(size=(N, N), x=(0, 512 * KM), y=(0, 512 * KM),
                               halo=halo, dtype="float32",
                               topology=("periodic", "periodic"), device=device)
    dynamics = cst.SeaIceMomentumEquation(
        rheology=cst.ElastoViscoPlasticRheology(ice_compressive_strength=P_star),
        coriolis=cst.FPlane(f=1.4e-4),
        top_momentum_stress={"u": 0.1, "v": 0.05},
        bottom_momentum_stress=cst.SemiImplicitStress(),
        solver=cst.SplitExplicitSolver(substeps=substeps, fixed_tiles=fixed_tiles,
                                       halo_exchange="wide" if wide else "per_substep"))
    return cst.sea_ice_model(grid, dynamics=dynamics,
                             ice_thermodynamics=cst.sea_ice_slab_thermodynamics(),
                             top_heat_flux=-20.0, bottom_heat_flux=-5.0,
                             advection=cst.WENO(order=7),
                             timestepper="SplitRungeKutta3")


def flagship_state(cst, model, velocity_seed=None, h0=None):
    import numpy as np
    import torch

    if h0 is None:
        def h0(x, y):
            return (1.0 + 0.25 * torch.sin(2 * math.pi * x / (512 * KM))
                    * torch.sin(2 * math.pi * y / (512 * KM)))

    kw = {}
    if velocity_seed is not None:
        rng = np.random.default_rng(velocity_seed)
        shape = model.grid.interior_shape
        kw = dict(u=0.05 * rng.standard_normal(shape), v=0.05 * rng.standard_normal(shape))
    return cst.initial_state(model, h=h0, a=1.0, **kw)


def bounded(cst, N, substeps=120, P_star=27500.0, device="cuda", top=None, bottom=None,
            fixed_tiles=None, halo=5, snow=False, topology=("bounded", "bounded"), wide=False,
            advection=None, forcing=None):
    """The configuration of validation/perf_sweep.py:build(N, bounded=True),
    in the port: a 512 km bounded box with a circular island of radius
    60 km and ImmersedDrag(1e-3); ``top`` and ``bottom`` replace its stresses.
    ``fixed_tiles`` selects the decomposition-invariant mode with the wide
    halo policy, as the repo's fixed-tile configurations set it, ``wide``
    that policy without it; ``snow`` puts snow on the ice with the basin's
    snowfall and its heat fluxes without the FluxFunction (the Semtner
    longwave, sensible and latent series and radiative emission);
    ``topology`` replaces the walls, ``advection`` its WENO(7); ``forcing``
    is the model's user forcing."""
    import numpy as np
    grid = cst.RectilinearGrid(size=(N, N), x=(0, 512 * KM), y=(0, 512 * KM),
                               halo=halo, dtype="float32", topology=topology, device=device)
    x = (np.arange(N) + 0.5) * (512 * KM / N)
    xc, yc = np.meshgrid(x, x, indexing="ij")
    grid = cst.ImmersedBoundaryGrid(grid, (xc - 256 * KM) ** 2 + (yc - 256 * KM) ** 2
                                    < (60 * KM) ** 2)
    dynamics = cst.SeaIceMomentumEquation(
        rheology=cst.ElastoViscoPlasticRheology(ice_compressive_strength=P_star),
        coriolis=cst.FPlane(f=1.4e-4),
        top_momentum_stress=top if top is not None else {"u": 0.1, "v": 0.05},
        bottom_momentum_stress=bottom if bottom is not None else cst.SemiImplicitStress(),
        immersed_drag=cst.ImmersedDrag(coefficient=1e-3),
        solver=cst.SplitExplicitSolver(
            substeps=substeps, fixed_tiles=fixed_tiles,
            halo_exchange="wide" if wide or fixed_tiles else "per_substep"))
    thermo = dict(top_heat_flux=-20.0, bottom_heat_flux=-5.0)
    if snow:
        from climaseaice_jl_tpu_torch import arctic_basin as ab
        series = [cst.FieldTimeSeries(times=ab.TIMES, data=tab, cyclical=True)
                  for tab in (ab.TAB_LONGWAVE, ab.TAB_SENSIBLE, ab.TAB_LATENT)]
        thermo = dict(top_heat_flux=(*series, cst.RadiativeEmission(
                          emissivity=1.0, stefan_boltzmann_constant=5.67e-8 * 1.02)),
                      bottom_heat_flux=-2.0, snowfall=3.2e-6,
                      snow_thermodynamics=cst.snow_slab_thermodynamics())
    return cst.sea_ice_model(grid, dynamics=dynamics,
                             ice_thermodynamics=cst.sea_ice_slab_thermodynamics(),
                             advection=advection or cst.WENO(order=7),
                             timestepper="SplitRungeKutta3", forcing=forcing, **thermo)


def fixed_basin(Nx, Ny, fixed_tiles=(8, 128), device="cuda", soft=False, seed=None,
                snow=0.0, halo=5):
    """The basin of validation/run_distributed_basin.py:build in the port;
    ``soft`` sets P★ = 27.5, ``seed`` seeds the velocities, ``snow`` puts
    that much snow on the ice."""
    import dataclasses
    import numpy as np
    import torch
    import climaseaice_jl_tpu_torch as cst
    from climaseaice_jl_tpu_torch import distributed_basin
    model, state = distributed_basin.build(Nx, Ny, fixed_tiles=fixed_tiles, halo=halo,
                                           device=device)
    if soft:
        dyn = model.dynamics
        model = dataclasses.replace(model, dynamics=dataclasses.replace(
            dyn, rheology=dataclasses.replace(dyn.rheology, ice_compressive_strength=27.5)))
    if seed is None and not snow:
        return model, state
    g = model.grid
    kw = dict(h=g.interior(state.h), a=g.interior(state.a),
              hs=snow * (g.interior(state.a) > 0).to(torch.float32))
    if seed is not None:
        rng = np.random.default_rng(seed)
        kw.update({c: torch.as_tensor(0.05 * rng.standard_normal(g.interior_shape),
                                      dtype=torch.float32, device=device) for c in "uv"})
    return model, cst.initial_state(model, **kw)


def rectilinear_contractive(device="cuda", N=128, halo_exchange="per_substep"):
    """A doubly periodic float64 rectilinear run in the contractive regime
    (α⁺ = 1e4), as `tests/test_distributed.py:_build` sets it, at N², under
    the halo policy ``halo_exchange`` (by default 'per_substep'): the general
    path.  Module-level, so that spawned ranks can build it."""
    import torch
    import climaseaice_jl_tpu_torch as cst
    L = 20 * KM
    grid = cst.RectilinearGrid(size=(N, N), x=(-L / 2, L / 2), y=(-L / 2, L / 2), halo=5,
                               topology=("periodic", "periodic"), device=device)
    dynamics = cst.SeaIceMomentumEquation(
        rheology=cst.ElastoViscoPlasticRheology(max_relaxation_parameter=1e4),
        coriolis=cst.FPlane(f=1e-4), top_momentum_stress={"u": 0.01, "v": 0.01},
        bottom_momentum_stress=cst.SemiImplicitStress(),
        solver=cst.SplitExplicitSolver(substeps=10, halo_exchange=halo_exchange))
    model = cst.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None,
                              advection=cst.WENO(order=7), timestepper="ForwardEuler")

    def h0(x, y):
        return 0.3 + 0.005 * (torch.sin(60 * x / L) + torch.sin(30 * y / L))

    return model, cst.initial_state(model, h=h0, a=1.0, u=0.1)


def shard_of(q, shard, nx, ny, H, Hx=None):
    """Shard ``shard``'s window of a padded array whose halos are ``H``
    wide: its interior and H-wide halos (``Hx``-wide along x where given)."""
    ix, iy = shard
    x0 = ix * nx + H - (H if Hx is None else Hx)
    return q[x0:x0 + nx + 2 * (H if Hx is None else Hx),
             iy * ny:iy * ny + ny + 2 * H].contiguous()


def shard_model(model, state, shard, mesh_shape, H):
    """The model and state of one shard of a wide-halo distributed step, cut
    from a global model whose halos are already ``H`` wide: a grid that
    names the mesh axes (a ProcessMesh without transport), and windows of
    the global masks and of the EVP's state fields.  A periodic global grid
    with ``H`` halos holds in its windows what the shard's exchanges
    bring."""
    import torch
    from climaseaice_jl_tpu_torch.parallel.stepper import ProcessMesh, _local_grid
    g = model.grid
    nx, ny = g.Nx // mesh_shape[0], g.Ny // mesh_shape[1]
    lgrid = _local_grid(g, nx, ny, *shard, ("x", "y"), mesh_shape,
                        ProcessMesh(mesh_shape, shard, g.device, transport=False))

    def cut(q):
        return shard_of(q, shard, nx, ny, H) if isinstance(q, torch.Tensor) else q

    masks = model.masks
    lmasks = masks.evolve(**{f: cut(getattr(masks, f)) for f in (
        "solid_cc", "per_fc", "per_cf", "per_ff", "imm_ff", "solid_full")})
    lstate = state.evolve(**{f: cut(getattr(state, f)) for f in (
        "h", "a", "u", "v", "sig11", "sig22", "sig12", "alpha")})
    return model.evolve(grid=lgrid.evolve(solid_cc=lmasks.solid_cc), masks=lmasks), lstate


def wide_flagship(device="cuda", fixed_tiles=None, P_star=27500.0):
    """Paths A and (with ``fixed_tiles``) B of the wide-halo distributed
    step: bench.py:build(512, 120) with SplitExplicitSolver(120,
    halo_exchange="wide"), and its initial state.  Module-level, so that
    spawned ranks can build it."""
    import climaseaice_jl_tpu_torch as cst
    model = flagship(cst, 512, 120, P_star=P_star, device=device, wide=True,
                     fixed_tiles=fixed_tiles)
    return model, flagship_state(cst, model)


def wide_basin(device="cuda", drag=True):
    """Path C: distributed_basin.build(1152, 960, substeps=24) without
    fixed_tiles, its solver under the wide halo policy."""
    from climaseaice_jl_tpu_torch import distributed_basin
    return distributed_basin.build(1152, 960, substeps=24, drag=drag, halo_exchange="wide",
                                   device=device)


class momentum_through:
    """The serial step with its momentum routed through ``step_fn`` (a
    launcher taking ``(model, state, dt, u_start, v_start)``): the serial
    counterpart of a shard's route, for the bitwise checks."""

    def __init__(self, step_fn):
        self.step_fn = step_fn

    def __enter__(self):
        from climaseaice_jl_tpu_torch import model as tmodel
        step_fn = self.step_fn

        def momentum(model, state, dt, u_prev=None, v_prev=None):
            u0 = state.u if u_prev is None else u_prev
            v0 = state.v if v_prev is None else v_prev
            return state.evolve(**step_fn(model, state, dt, u0, v0))

        self.original = tmodel.momentum_step
        tmodel.momentum_step = momentum

    def __exit__(self, *exc):
        from climaseaice_jl_tpu_torch import model as tmodel
        tmodel.momentum_step = self.original


def physics_model(cst, variant, N=512, P_star=27500.0, device="cuda"):
    """The grid, stresses, thermodynamics, WENO-7 and RK3 of
    bench.py:build(N, 120) with the momentum physics of phases 31 and 33:
    "viscous" (ViscousRheology(ν = 1000) + ExplicitSolver + BetaPlane(1.4e-4,
    1e-11)), "forced" (the αEVP flagship, 120 substeps, with constant h and u
    forcing rates) or "free_drift" (StressBalanceFreeDrift as the whole
    dynamics: the flagship's scalar top stress over SemiImplicitStress)."""
    grid = cst.RectilinearGrid(size=(N, N), x=(0, 512 * KM), y=(0, 512 * KM), halo=5,
                               dtype="float32", topology=("periodic", "periodic"),
                               device=device)
    top = {"u": 0.1, "v": 0.05}
    forcing = None
    if variant == "free_drift":
        dynamics = cst.StressBalanceFreeDrift(top_momentum_stress=top,
                                              bottom_momentum_stress=cst.SemiImplicitStress())
    else:
        viscous = variant == "viscous"
        dynamics = cst.SeaIceMomentumEquation(
            rheology=(cst.ViscousRheology(nu=1000.0) if viscous
                      else cst.ElastoViscoPlasticRheology(ice_compressive_strength=P_star)),
            coriolis=(cst.BetaPlane(f0=1.4e-4, beta=1e-11) if viscous
                      else cst.FPlane(f=1.4e-4)),
            top_momentum_stress=top, bottom_momentum_stress=cst.SemiImplicitStress(),
            solver=cst.ExplicitSolver() if viscous else cst.SplitExplicitSolver(substeps=120))
        if variant == "forced":
            forcing = {"h": lambda g, c, f: 1e-7, "u": lambda g, c, f: 2e-6}
    return cst.sea_ice_model(grid, dynamics=dynamics,
                             ice_thermodynamics=cst.sea_ice_slab_thermodynamics(),
                             top_heat_flux=-20.0, bottom_heat_flux=-5.0,
                             advection=cst.WENO(order=7), timestepper="SplitRungeKutta3",
                             forcing=forcing)


@contextlib.contextmanager
def exchange_every_half_update():
    """The gate of the split-explicit loop's local fills
    (``momentum.local_loop_ok``) turned off: a shard's loop exchanges after
    each half-update, the form 'per_substep' had before the deferred one.
    Module-level, so that a spawned rank can run a case in it."""
    from climaseaice_jl_tpu_torch.dynamics import momentum
    gate = momentum.local_loop_ok
    momentum.local_loop_ok = lambda model, h_min: False
    try:
        yield
    finally:
        momentum.local_loop_ok = gate


def physics_shard(variant, device="cuda", N=128):
    """Phase 33's build of ``variant`` (``physics_model`` at N², P★ = 27.5
    for "forced") and its state: the model that phase 36 steps on a mesh of
    ranks and serially.  Module-level, so that spawned ranks can build it."""
    import climaseaice_jl_tpu_torch as cst
    model = physics_model(cst, variant, N=N, P_star=27.5 if variant == "forced" else 27500.0,
                          device=device)
    return model, flagship_state(cst, model, velocity_seed=9)


class counting:
    """Counts the calls of ``module.attr`` inside the block (``.calls``)."""

    def __init__(self, module, attr):
        self.module, self.attr, self.calls = module, attr, 0

    def __enter__(self):
        self.original = fn = getattr(self.module, self.attr)

        def counted(*args, **kw):
            self.calls += 1
            return fn(*args, **kw)

        setattr(self.module, self.attr, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.original)


def latlon_model(cst, Nx, Ny, substeps, device="cuda"):
    """A 50–80°N latitude-longitude band, periodic in x and bounded in y, in
    soft ice with an FPlane and no land: the curvilinear kernel without a
    fold, land or drag."""
    grid = cst.LatitudeLongitudeGrid((Nx, Ny), latitude=(50.0, 80.0), halo=5,
                                     dtype="float32", topology=("periodic", "bounded"),
                                     device=device)
    dynamics = cst.SeaIceMomentumEquation(
        rheology=cst.ElastoViscoPlasticRheology(ice_compressive_strength=27.5),
        coriolis=cst.FPlane(f=1.4e-4),
        top_momentum_stress={"u": 0.1, "v": 0.05},
        bottom_momentum_stress=cst.SemiImplicitStress(),
        solver=cst.SplitExplicitSolver(substeps=substeps))
    return cst.sea_ice_model(grid, dynamics=dynamics,
                             ice_thermodynamics=cst.sea_ice_slab_thermodynamics(),
                             top_heat_flux=-20.0, bottom_heat_flux=-5.0,
                             advection=cst.WENO(order=7), timestepper="SplitRungeKutta3")


def compare_curvilinear(params, consts, carry, nsub, grid, f_planes, card, timed=True):
    """The curvilinear kernel against its plain version on the same card
    tensors over the whole padded arrays: bitwise (the kernel without the
    settled-block skip was bitwise on both of phase 10's inputs), and within
    phase 2's bars; its settled flags equal their plain version's; with
    ``timed``, the CUDA-event times per call of both and the call's
    bounds."""
    import torch
    from climaseaice_jl_tpu_torch.dynamics import fused_evp_curvilinear as fc
    flags = fc.settled_blocks_reference(consts, grid)
    settled = torch.full((flags.numel(),), -1, dtype=torch.int32, device=flags.device)
    out = fc.curvilinear_evp_substeps(params, consts, [q.clone() for q in carry], nsub, grid,
                                      f_planes, settled=settled)
    ref = fc.curvilinear_evp_substeps_reference(params, consts, carry, nsub, grid, f_planes)
    torch.cuda.synchronize()
    worst_rel = worst_abs = 0.0
    for name, r, o, bar in zip(("u", "v", "sig11", "sig22", "sig12", "alpha"), ref, out,
                               (1e-4, 1e-4, 4e-3, 4e-3, 4e-3, 4e-3)):
        if not torch.isfinite(o).all():
            raise AssertionError(f"{name} from the curvilinear kernel is not finite")
        rel, abs_err = rel_diff(r, o)
        check(name, rel, bar)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)
    bitwise = all(torch.equal(r, o) for r, o in zip(ref, out))
    ulps = max(max_ulp(r, o) for r, o in zip(ref, out))
    same_flags = torch.equal(settled.view(flags.shape) != 0, flags)
    print(f"    bitwise: {bitwise}; largest difference {ulps} ulp; settled blocks "
          f"{flags.float().mean().item():.4f} ({int(flags.sum())} of {flags.numel()}), the "
          f"kernel's flags equal their plain version's: {same_flags}")
    if not bitwise or ulps:
        raise AssertionError(f"the curvilinear kernel is {ulps} ulp from its plain version")
    if not same_flags:
        raise AssertionError("the curvilinear kernel's settled flags differ from the plain "
                             "version's")
    if not timed:
        return None
    work = [q.clone() for q in carry]
    kernel_ms = cuda_ms(lambda: fc.curvilinear_evp_substeps(params, consts, work, nsub, grid,
                                                            f_planes), 20)
    plain_ms = cuda_ms(lambda: fc.curvilinear_evp_substeps_reference(
        params, consts, carry, nsub, grid, f_planes), 3)
    points = grid.nxp * grid.nyp
    curv_bytes = ((CURV_ARRAYS_READ + EVP_ARRAYS_WRITTEN) * points + EVP_PARAMS) * 4
    curv_flops = (CURV_FLOPS_PER_POINT_SUBSTEP * nsub + CURV_FLOPS_PER_POINT_CALL) * points
    bytes_ms = curv_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = curv_flops / FP32_FLOP_PER_S * 1e3
    print(f"    kernel {kernel_ms:.4f} ms/call ({3 * nsub + 3} launches), plain "
          f"{plain_ms:.3f} ms/call, bound {max(bytes_ms, ops_ms):.4f} ms "
          f"({curv_flops / 1e9:.2f} GFLOP, {curv_bytes / 1e6:.1f} MB; the same work whatever "
          f"the kernel skips) on {card}")
    return worst_abs, worst_rel, kernel_ms, plain_ms, bytes_ms, ops_ms


def check_basin_state(model, state):
    """Over the whole padded arrays: every field finite; h, hs ≥ 0 and
    0 ≤ ℵ ≤ 1; h = ℵ = hs = 0 on land; the fold halo of u equal to minus its
    mirror (the Zipper fill)."""
    import torch
    from climaseaice_jl_tpu_torch.fields import _x_fold_indices
    for name in ("h", "a", "hs", "u", "v", "sig11", "sig22", "sig12", "alpha", "Tu", "Tus"):
        if not torch.isfinite(getattr(state, name)).all():
            raise AssertionError(f"{name} is not finite")
    h, a, hs = state.h, state.a, state.hs
    if not (h.min().item() >= 0 and hs.min().item() >= 0 and a.min().item() >= 0
            and a.max().item() <= 1):
        raise AssertionError("h < 0, hs < 0 or ℵ outside [0, 1]")
    solid = model.grid.solid_cc
    if any(q[solid].abs().max().item() != 0 for q in (h, a, hs)):
        raise AssertionError("ice or snow on land")
    g = model.grid
    src = torch.as_tensor(_x_fold_indices(g, True), device=h.device)
    if not torch.equal(state.u[:, g.Hy + g.Ny:], -state.u[src][:, g.Ny:g.Hy + g.Ny].flip(1)):
        raise AssertionError("the fold halo of u is not minus its mirror")


def profile_device_ms(cst, model, state, dt, step=None):
    """Device time (ms) of one step (``cst.step`` unless ``step`` is given)
    under torch.profiler, the count of
    device-to-host reads of a value that make the host wait for the device,
    and the profiler's table by kernel.  The device time is the union of
    the kernels' and copies' intervals, not their sum: a chunk of 2.3 or
    2.5 launched as a programmatic dependent starts inside its predecessor,
    and the profiler's duration of each counts that overlap."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (step or cst.step)(model, state, dt)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        busy_us += max(end - max(start, reach), 0.0)
        reach = max(reach, end)
    events = prof.key_averages()
    syncs = sum(e.count for e in events if e.key == "aten::_local_scalar_dense")
    return busy_us / 1e3, syncs, events.table(sort_by="self_cuda_time_total", row_limit=40)


def rel_diff(ref, x):
    """max |x − ref| over max |ref|, and max |x − ref|."""
    abs_err = (x.double() - ref.double()).abs().max().item()
    return abs_err / max(ref.double().abs().max().item(), 1e-30), abs_err


def check(name, rel, bar):
    print(f"  {name:6s} max rel diff {rel:.3e}  (bar {bar:g})")
    if not rel <= bar:
        raise AssertionError(f"{name}: relative difference {rel:.3e} above {bar:g}")


def cuda_ms(fn, repeats):
    """Mean milliseconds per call of ``fn`` on the current stream (CUDA
    events), after one warm-up call."""
    import torch
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


# sha256 of commit 2a3ee95's climaseaice_jl_tpu_torch/csrc and its two wrappers
# of kernels 2.10 and 2.4, as earlier_modules hashes them: that commit's
# wrappers are run here on this tree's other modules, and its C entries are
# called with its argument lists, which ctypes cannot check
EARLIER_SHA256 = "3d9b972d520d83f62d86ead1aec65094888ffb0319e5c1c2db46df4f16835c9d"
EARLIER_WRAPPERS = {"pointwise_fixed": "dynamics/fixed_tile_pointwise.py",
                    "evp_prep": "dynamics/fused_evp_padded.py"}


def earlier_modules(tree):
    """Kernels 2.10 and 2.4 as ``tree``, a checkout of commit 2a3ee95, has
    them: its wrapper modules loaded beside this tree's (their relative
    imports resolve to this tree's modules, which give them what they
    import) and calling its CUDA sources, the interpreter
    ``pointwise_fixed.cu`` and ``evp_prep.cu``, built with this tree's flags
    into ``_build/earlier``.  Returns {"pointwise_fixed": module, "evp_prep":
    module}; raises if the tree's sources or wrappers are not that
    commit's."""
    import ctypes
    import hashlib
    import importlib.util
    from climaseaice_jl_tpu_torch import _build
    pkg = os.path.join(tree, "climaseaice_jl_tpu_torch")
    csrc = os.path.join(pkg, "csrc")
    files = [os.path.join("csrc", n) for n in sorted(os.listdir(csrc))]
    files += list(EARLIER_WRAPPERS.values())
    digest = hashlib.sha256()
    for rel in files:
        with open(os.path.join(pkg, rel), "rb") as f:
            digest.update(os.path.join("climaseaice_jl_tpu_torch", rel).encode() + b"\0"
                          + f.read())
    if digest.hexdigest() != EARLIER_SHA256:
        raise ValueError(f"{tree} holds other sources than commit 2a3ee95's: its C entries "
                         f"would be called with the wrong arguments")
    out_dir = _build.BUILD_DIR / "earlier"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in EARLIER_WRAPPERS:
        out = out_dir / f"lib{name}_{EARLIER_SHA256[:16]}.so"
        if not out.exists():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp),
                   os.path.join(csrc, f"{name}.cu")]
            jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True), tmp, out)
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"CUDA build of the earlier {name} failed:\n{log}")
        _build.build_logs[f"earlier {name}"] = log
        os.replace(tmp, out)
    modules = {}
    for name, rel in EARLIER_WRAPPERS.items():
        sub, stem = rel[:-3].split("/")
        spec = importlib.util.spec_from_file_location(
            f"climaseaice_jl_tpu_torch.{sub}._earlier_{stem}", os.path.join(pkg, rel))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        lib = ctypes.CDLL(str(out_dir / f"lib{name}_{EARLIER_SHA256[:16]}.so"))
        if name == "pointwise_fixed":
            fn = lib.csi_pointwise_fixed
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_void_p]
            mod._pointwise_entry = lambda fn=fn: fn
        else:
            fn = lib.csi_evp_prep
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            mod._prep_entry = lambda fn=fn: fn
        fn.restype = ctypes.c_int
        modules[name] = mod
    return modules


def pointwise_units():
    """The generated pointwise units (name → text) of the basin's two wind
    components, planned on the card at a small shape (a unit's text does
    not depend on the shape)."""
    from climaseaice_jl_tpu_torch import distributed_basin
    from climaseaice_jl_tpu_torch.dynamics import fixed_tile_pointwise as fpw
    units = {}
    for fn in distributed_basin.WINDS:
        plan = fpw.plan(fn, 2, 1, "cuda", (8, 8))
        units[plan.name] = plan.text
    return units


def device_profile(fn, calls=20, match=None):
    """``fn`` called ``calls`` times under torch.profiler after a warm-up:
    (device µs a launch of the kernels whose names hold ``match``, or of
    every kernel without it; those launches a call; the device operations,
    kernels, copies and fills, a call).  The profiler now and then returns
    a trace without the device's activity: a trace without a launch named
    ``match`` is taken again, up to four times, and the µs are None (not
    measured) if none holds one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        chosen = [e for e in events if match is None or match in e.name]
        if chosen or match is None:
            break
    us = sum(e.time_range.end - e.time_range.start for e in chosen)
    return (us / len(chosen) if chosen else None), len(chosen) / calls, len(events) / calls


def device_ms_text(us):
    """A device time a launch from device_profile, in ms, for a report."""
    return "not measured (no launch in the profiler's traces)" if us is None else \
        f"{us / 1e3:.4f} ms"


def device_in_turns(fns, match, calls=20):
    """Device µs a launch of the kernels named ``match`` (device_profile),
    each of ``fns`` (label → function) in turns, forwards then backwards:
    label → [µs, µs]."""
    times = {}
    for label in list(fns) + list(fns)[::-1]:
        times.setdefault(label, []).append(device_profile(fns[label], calls, match)[0])
    return times


def print_turns(what, times, unit, card):
    def text(t):
        return "not measured" if t is None else f"{t:.4f}" if unit == "ms" else f"{t:.2f}"
    print(f"      in turns, {what}: "
          + "; ".join(f"{k} {', '.join(text(t) for t in v)}" for k, v in times.items())
          + f" {unit}, on {card}")


def in_turns(fns, repeats):
    """Each of ``fns`` (label → function) timed by cuda_ms in turns, forwards
    then backwards: label → [ms, ms]."""
    times = {}
    for label in list(fns) + list(fns)[::-1]:
        times.setdefault(label, []).append(cuda_ms(fns[label], repeats))
    return times


def host_us(fn, calls=50):
    """Microseconds of host time per call of ``fn`` (the calls enqueued
    back to back after a warm-up, timed before the device is waited for)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def bits_record(ref, outs):
    """(largest ulp distance, the same raw bits) of each output against its
    reference, over ``(ref, out)`` pairs."""
    outs = list(outs)
    return (max(max_ulp(r, o) for r, o in zip(ref, outs)),
            all(same_bits(r, o) for r, o in zip(ref, outs)))


def against_earlier(label, new, old, ref, plain_gate, card, timed=None):
    """Kernel ``label``'s outputs ``new`` against the earlier tree's ``old``
    and both against the plain version's ``ref`` (lists of tensors): the
    earlier tree's bits are a gate, the plain version's where
    ``plain_gate``; ``timed`` (label → function) are timed in turns."""
    ulp_plain, same_plain = bits_record(ref, new)
    old_plain, old_same = bits_record(ref, old)
    ulp_old, same_old = bits_record(old, new)
    print(f"    {label}: {ulp_plain} ulp from the plain version (raw bits {same_plain}); the "
          f"earlier tree's {old_plain} ulp (raw bits {old_same}); against the earlier tree "
          f"{ulp_old} ulp, raw bits {same_old}")
    if not same_old:
        raise AssertionError(f"{label} is not the earlier tree's bits ({ulp_old} ulp)")
    if plain_gate and not same_plain:
        raise AssertionError(f"{label} is not its plain version's bits ({ulp_plain} ulp)")
    if timed:
        times = in_turns(timed, 20)
        print("      in turns, ms per call (20 calls, forwards then backwards): "
              + "; ".join(f"{k} {', '.join(f'{t:.4f}' for t in v)}" for k, v in times.items())
              + f", on {card}")


def ptxas_kernels(log):
    """(kernel, registers, stack frame bytes, spill bytes) of each kernel in
    an ``nvcc -Xptxas -v`` log."""
    import re
    found, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and name:
            found.append([name, None, int(m.group(1)), int(m.group(2)) + int(m.group(3))])
        m = re.search(r"Used (\d+) registers", line)
        if m and found and found[-1][0] == name and found[-1][1] is None:
            found[-1][1] = int(m.group(1))
    return found


def ptxas_stack(name):
    """The largest stack frame (bytes) of the kernels of build ``name``, or
    None where it was not built in this run."""
    from climaseaice_jl_tpu_torch import _build
    log = _build.build_logs.get(name)
    return None if log is None else max(stack for _, _, stack, _ in ptxas_kernels(log))


def trig_unit():
    """The generated pointwise unit of sin(x)·cos(x) on the card: the
    yardstick of the stack frame that CUDA's sinf and cosf keep for the
    argument reduction of |x| > 105615 (Payne-Hanek, through an array in
    local memory)."""
    from climaseaice_jl_tpu_torch.dynamics import fixed_tile_pointwise as fpw
    return fpw.plan(_sin_cos, 1, 0, "cuda", (8, 8))


def _sin_cos(x):
    import torch
    return torch.sin(x) * torch.cos(x)


def print_ptxas(name, kernels=None, gate=None, max_stack=0):
    """Registers and stack frame of the kernels of build ``name`` whose
    mangled names hold one of ``kernels``; with ``gate``, raise unless those
    have no spill and a stack frame of at most ``max_stack`` bytes."""
    from climaseaice_jl_tpu_torch import _build
    log = _build.build_logs.get(name)
    if log is None:
        print(f"    {name}: not built in this run (no ptxas report)")
        return
    for kernel, regs, stack, spill in ptxas_kernels(log):
        if kernels and not any(k in kernel for k in kernels):
            continue
        print(f"    {name} {kernel}: {regs} registers, {stack} bytes stack frame, {spill} "
              f"bytes spilled")
        if gate and (stack > max_stack or spill):
            raise AssertionError(f"{kernel} has a {stack}-byte stack frame and {spill} bytes "
                                 f"of spills (at most {max_stack} and 0 allowed)")


def thermo_units(cst):
    """The generated column-kernel units (name → text) of the configurations
    this script runs with fixed tiles: bare ice under number fluxes (the
    slices and path B), snow under the Semtner series and emission, and the
    basin with the solar FluxFunction, each planned on a small grid."""
    from climaseaice_jl_tpu_torch import distributed_basin
    from climaseaice_jl_tpu_torch.thermodynamics import fixed_tile_thermo
    bare = bounded(cst, 128, 8, fixed_tiles=(8, 128))
    snow = bounded(cst, 128, 8, fixed_tiles=(8, 128), snow=True)
    cases = [(bare, cst.initial_state(bare, h=1.0, a=1.0)),
             (snow, cst.initial_state(snow, h=1.0, a=1.0, hs=0.1)),
             distributed_basin.build(32, 128, fixed_tiles=(8, 128))]
    units = {}
    for model, state in cases:
        plan = fixed_tile_thermo.plan(model, state.clock)
        units[plan.name] = plan.text
    return units


def tc_launches(tsub, K, refill):
    """Kernel 2.7's launches a call: the prep and the flags, one refill a
    chunk of K substeps where the fold is refilled, three a substep."""
    return 2 + 3 * tsub + (-(-tsub // K) if refill else 0)


def settled_record(settled, want):
    """The kernel's settled flags (int32) against their plain version's:
    (share, settled blocks, blocks), raising where they differ."""
    got = settled.reshape(want.shape).bool()
    if not bool((got == want).all()):
        raise AssertionError(f"2.7's settled flags differ from their plain version's at "
                             f"{int((got != want).sum())} blocks")
    return float(got.float().mean().item()), int(got.sum().item()), got.numel()


def check_state(model, state):
    """Finite and physical over the interior; on a grid with walls or land,
    h = ℵ = 0 on land cells and u, v zero on peripheral nodes."""
    import torch
    I = model.grid.interior
    for name in ("h", "a", "u", "v", "sig11", "sig22", "sig12", "alpha", "Tu"):
        q = getattr(state, name)
        if q is not None and not torch.isfinite(I(q)).all():
            raise AssertionError(f"{name} is not finite")
    h, a = I(state.h), I(state.a)
    if not (h.min().item() >= 0.0 and a.min().item() >= 0.0 and a.max().item() <= 1.0):
        raise AssertionError("h < 0 or ℵ outside [0, 1]")
    masks = model.masks
    solid = I(masks.solid_cc)
    if solid.any() and (h[solid].abs().max().item() != 0.0
                        or a[solid].abs().max().item() != 0.0):
        raise AssertionError("ice on land")
    for vel, per in ((state.u, masks.per_fc), (state.v, masks.per_cf)):
        per = I(per)
        if per.any() and I(vel)[per].abs().max().item() != 0.0:
            raise AssertionError("velocity on a peripheral node")


def timed_steps(cst, model, state, dt, steps):
    """``steps`` timed calls of cst.step: (state, CUDA-event ms per step, host
    ms per step)."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        state = cst.step(model, state, dt)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    return state, start.elapsed_time(end) / steps, host_ms


def steps_in_turns_with_earlier(cst, model, state, dt, steps, module, attr, earlier_fn):
    """ms a step (CUDA events) of this tree and of the same step with
    ``module.attr`` swapped for the earlier tree's ``earlier_fn``, in turns
    (this tree, earlier, this tree, earlier), after an untimed step of each."""
    mine = getattr(module, attr)
    times = []
    for name in ("warm-up", "warm-up earlier", "this tree", "earlier", "this tree", "earlier"):
        setattr(module, attr, earlier_fn if name.endswith("earlier") else mine)
        try:
            _, ms, _ = timed_steps(cst, model, state, dt, 1 if name.startswith("warm") else steps)
        finally:
            setattr(module, attr, mine)
        if not name.startswith("warm"):
            times.append(f"{name} {ms:.2f}")
    return times


def profile_step(cst, model, state, dt, title, card):
    """A torch.profiler table of one step, with the device time it saw."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = cst.step(model, state, dt)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    print("\n".join(table.splitlines()[:16]))
    return f"{title} on {card}: one profiled step, {host_ms:.2f} ms host time\n{table}\n"


def kernel_entry(name, source, replaces, function, launches, worst_abs, worst_rel,
                 kernel_ms, plain_ms, bytes_ms, ops_ms, shape):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "replaces_function": function,
        "launches": launches,
        "max_abs_err": worst_abs,
        "max_rel_diff": worst_rel,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None,
        "shape": shape,
    }


def max_ulp(ref, x):
    """The largest distance in float32 units in the last place."""
    import torch
    a = ref.contiguous().view(torch.int32).long()
    b = x.contiguous().view(torch.int32).long()
    a = torch.where(a < 0, -(a & 0x7FFFFFFF), a)       # order negative floats too
    b = torch.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int((a - b).abs().max().item())


def same_bits(ref, x):
    """Whether two float32 tensors hold the same bits (so −0 and +0, which
    max_ulp puts 0 apart, count as different)."""
    import torch
    return torch.equal(ref.contiguous().view(torch.int32), x.contiguous().view(torch.int32))


def bounds_ms(nbytes, flops):
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3


def card_name_and_power_limit():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def child_pids():
    """The processes whose parent is this one, from ``/proc``."""
    pids = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            with contextlib.suppress(OSError, IndexError, ValueError):
                with open(f"/proc/{entry}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == os.getpid():
                        pids.append(int(entry))
    return pids


def stop_children():
    """Stop and reap every process this script started that is still there.
    Spawning the ranks starts multiprocessing's resource tracker, which
    otherwise lives until this process ends and is reaped by no one; the
    semaphores it tracks are released first, so that nothing restarts it at
    exit.  Any other child is killed."""
    import multiprocessing
    from multiprocessing import resource_tracker, util
    gc.collect()
    util._run_finalizers(0)
    for p in multiprocessing.active_children():
        p.kill()
        p.join()
    resource_tracker._resource_tracker._stop()
    for pid in child_pids():
        print(f"chip_smoke: stopping child process {pid}", file=sys.stderr)
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
        with contextlib.suppress(ChildProcessError):
            os.waitpid(pid, 0)


def physics_phases(cst, card, evp_counters, adv_counter, thermo_counter):
    """Phases 31-34: the momentum physics beyond the αEVP kernels (viscous,
    explicit, beta-plane, forced, free drift) at full width, forcing under
    ``fixed_tiles``, card against CPU, and the port's eight examples.
    Returns the launches of 2.9 and 2.11 on phase 32's forced path."""
    import math
    import torch
    from climaseaice_jl_tpu_torch import model as tmodel
    from climaseaice_jl_tpu_torch.convert import state_to_numpy
    from climaseaice_jl_tpu_torch import examples as ex
    from climaseaice_jl_tpu_torch.examples import (arctic_basin_seasonal_cycle,
                                                   freezing_bucket, freezing_of_a_lake,
                                                   ice_advected_by_anticyclone,
                                                   ice_advected_on_coastline, melting_in_spring,
                                                   perpetual_night, simple_freezing_bucket)

    def reset(*counters):
        for c in counters:
            c.reset()

    def evp_calls():
        return {k: c.calls for k, c in evp_counters.items() if c.calls}

    # --- 31. the new momentum physics at full width --------------------------------------
    dt, steps = 120.0, 3
    labels = {"viscous": "(a) ViscousRheology(ν = 1000) + ExplicitSolver + BetaPlane",
              "forced": "(b) the αEVP flagship with forcing on h and u",
              "free_drift": "(c) StressBalanceFreeDrift as the whole dynamics"}
    expected_calls = {"viscous": (0, 3 * steps), "forced": (3 * steps, 0),
                      "free_drift": (0, 0)}
    for variant, label in labels.items():
        t0 = time.perf_counter()
        model = physics_model(cst, variant)
        state = cst.step(model, flagship_state(cst, model), dt)      # warm-up
        torch.cuda.synchronize()
        reset(*evp_counters.values())
        with counting(tmodel, "split_explicit_momentum_step") as general, \
                counting(tmodel, "explicit_momentum_step") as explicit:
            state, step_ms, host_ms = timed_steps(cst, model, state, dt, steps)
        check_state(model, state)
        speed = model.grid.interior(state.u).abs().max().item()
        if evp_calls() or (general.calls, explicit.calls) != expected_calls[variant]:
            raise AssertionError(f"[31] {variant}: EVP kernel calls {evp_calls()}, "
                                 f"{general.calls} general and {explicit.calls} explicit "
                                 f"momentum calls; expected none and {expected_calls[variant]}")
        if not speed < 1.0:
            raise AssertionError(f"[31] {variant}: max |u| {speed} m/s")
        note = ""
        if variant == "free_drift":
            # uₑ − τₓ/√(ρₑCᴰ‖τ‖) with τ = (0.1, 0.05) and uₑ = 0
            u_closed = -0.1 / math.sqrt(1026.0 * 5.5e-3 * math.hypot(0.1, 0.05))
            u = model.grid.interior(state.u)
            rel = ((u - u_closed).abs().max() / abs(u_closed)).item()
            note = f", u the closed form {u_closed:.6f} m/s within {rel:.1e}"
            if not rel <= 1e-5:
                raise AssertionError(f"[31] free drift: u {rel:.3e} from the closed form")
        if variant != "forced":
            # the forced step launches ~10⁵ kernels: profiled only where it is short
            device_ms, syncs, _ = profile_device_ms(cst, model, state, dt)
            note += (f"; one profiled step {device_ms:.3f} ms of device time, busy "
                     f"{100 * device_ms / step_ms:.1f} %, {syncs} host waits")
        print(f"[31] {label}, 512²: {step_ms:.2f} ms/step (CUDA events after a warm-up; host "
              f"{host_ms:.2f} ms/step), {steps} steps finite and physical, max |u| "
              f"{speed:.4f} m/s{note}; {general.calls} general split-explicit and "
              f"{explicit.calls} explicit momentum calls, no EVP kernel call, on {card} "
              f"({time.perf_counter() - t0:.1f} s)")
        del model, state

    # --- 32. forcing under fixed_tiles ----------------------------------------------------
    t0 = time.perf_counter()
    model = bounded(cst, 512, 120, fixed_tiles=(8, 128),
                    forcing={"h": lambda g, c, f: 1e-7 * f.a})
    state = cst.step(model, flagship_state(cst, model), dt)          # warm-up, step 1 of 3
    torch.cuda.synchronize()
    reset(adv_counter, thermo_counter, *evp_counters.values())
    steps = 2
    with counting(tmodel, "split_explicit_momentum_step") as general:
        state, step_ms, host_ms = timed_steps(cst, model, state, dt, steps)
    check_state(model, state)
    forced = {"adv": adv_counter.launches, "thermo": thermo_counter.launches}
    got = (adv_counter.calls, forced["adv"], thermo_counter.calls, forced["thermo"],
           general.calls, evp_calls())
    want = (6 * steps, 6 * steps, 3 * steps, 3 * steps, 3 * steps, {})
    if got != want:
        raise AssertionError(f"[32] 2.9 calls/launches, 2.11 calls/launches, general "
                             f"momentum calls, EVP kernel calls: {got}, expected {want}")
    print(f"[32] perf_sweep.py:build(512, bounded=True) with fixed_tiles=(8, 128) and a "
          f"callable forcing on h: {step_ms:.2f} ms/step (CUDA events over steps 2 and 3, after "
          f"the first; host {host_ms:.2f} ms/step), finite, h = ℵ = 0 on land; 2.9 "
          f"{forced['adv']} launches ({forced['adv'] // steps} a step), 2.11 "
          f"{forced['thermo']} ({forced['thermo'] // steps} a step), the general momentum "
          f"path {general.calls} times, 2.4 and 2.5 not at all, on {card} "
          f"({time.perf_counter() - t0:.1f} s)")
    del model, state

    # --- 33. card vs CPU, the new physics ----------------------------------------------------
    for variant, label in labels.items():
        t0 = time.perf_counter()
        finals = {}
        for device in ("cuda", "cpu"):
            m = physics_model(cst, variant, N=128, P_star=27.5, device=device)
            s0 = flagship_state(cst, m, velocity_seed=9)
            if device == "cuda":          # the code warmed up by phase 31
                s, step_ms, _ = timed_steps(cst, m, s0, dt, 2)
                check_state(m, s)
            else:
                s = s0
                for _ in range(2):
                    s = cst.step(m, s, dt)
            finals[device] = state_to_numpy(s)
        print(f"[33] {label}, 128², 2 RK3 steps, card vs CPU ({step_ms:.2f} ms/step on the "
              f"card, CUDA events, the code warmed up by phase 31, on {card}; "
              f"{time.perf_counter() - t0:.1f} s with the CPU run):")
        bars = {k: 1e-5 for k in ("h", "a", "u", "v")}
        if variant == "forced":      # P★ = 27.5, phase 5's bars
            bars.update(u=1e-4, v=1e-4, sig11=4e-3, sig22=4e-3, sig12=4e-3, alpha=4e-3)
        for name, bar in bars.items():
            rel, _ = rel_diff(torch.as_tensor(finals["cpu"][name]),
                              torch.as_tensor(finals["cuda"][name]))
            check(name, rel, bar)

    # --- 34. the port's eight examples on the card --------------------------------------------
    def loop(n, dt_, before=None):
        def run(model, state):
            for _ in range(n):
                if before is not None:
                    state = before(model, state, dt_)
                state = cst.step(model, state, dt_)
            return state
        return run

    def simulation(dt_, **stop):
        def run(model, state):
            sim = cst.Simulation(model, state, dt=dt_, **stop)
            sim.run()
            return sim.state
        return run

    def col(model, q):
        return model.grid.interior(q)[:, 0]

    def h0(model, state):
        return float(state.h[0, 0])

    runs = {
        "freezing_bucket": (lambda: freezing_bucket.build(device="cuda"),
                            simulation(600.0, stop_time=86400.0), 144,
                            lambda m, s: h0(m, s) > 0 and 0 < float(s.a[0, 0]) <= 1),
        "simple_freezing_bucket": (lambda: simple_freezing_bucket.build(device="cuda"),
                                   loop(144, 10 * MINUTE), 144, lambda m, s: h0(m, s) > 0.01),
        "perpetual_night": (lambda: perpetual_night.build(device="cuda"), loop(48, 3600.0), 48,
                            lambda m, s: h0(m, s) > 0.01),
        "melting_in_spring": (lambda: melting_in_spring.build(device="cuda"), loop(20, 600.0),
                              20, lambda m, s: bool(col(m, s.h)[0] >= col(m, s.h)[-1])),
        "melting_in_spring (snow)": (lambda: melting_in_spring.build(snow=True, device="cuda"),
                                     loop(20, 600.0), 20,
                                     lambda m, s: bool(col(m, s.h)[0] >= col(m, s.h)[-1])),
        "freezing_of_a_lake": (lambda: freezing_of_a_lake.build(device="cuda"),
                               loop(100, 600.0, freezing_of_a_lake.advance_lake), 100,
                               lambda m, s: bool(col(m, s.tracers["T_lake"])[0]
                                                 <= col(m, s.tracers["T_lake"])[-1])),
        "ice_advected_by_anticyclone": (
            lambda: ice_advected_by_anticyclone.build(N=32, substeps=10, device="cuda"),
            loop(5, 120.0), 5, lambda m, s: m.grid.interior(s.u).abs().max().item() > 0),
        "ice_advected_on_coastline": (
            lambda: ice_advected_on_coastline.build(Nx=64, Ny=32, substeps=10, device="cuda"),
            simulation(300.0, stop_iteration=5), 5, lambda m, s: True),
        "arctic_basin_seasonal_cycle": (lambda: arctic_basin_seasonal_cycle.build(device="cuda"),
                                        loop(90, 8 * 3600.0), 90, lambda m, s: h0(m, s) > 0),
    }
    if {k.split(" ")[0] for k in runs} | set(SIDE_MODEL_EXAMPLES) != set(ex.NAMES):
        raise AssertionError("phases 34 and 38-40 do not run every example of the port")
    t0 = time.perf_counter()
    for name, (build, run, n, ok) in runs.items():
        model, state = build()
        cst.step(model, state, 60.0)                                     # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        state = run(model, state)
        end.record()
        torch.cuda.synchronize()
        if int(state.clock.iteration) != n:
            raise AssertionError(f"[34] {name}: {int(state.clock.iteration)} steps, not {n}")
        check_state(model, state)
        if not ok(model, state):
            raise AssertionError(f"[34] {name}: the short run's assertion failed")
        print(f"[34] {name}: the short run of tests/test_examples.py, {n} steps, finite, "
              f"physical and its assertions met; {start.elapsed_time(end) / n:.3f} ms/step "
              f"(CUDA events after a warm-up) on {card}")
    print(f"[34] {time.perf_counter() - t0:.1f} s for the nine short runs")
    return forced


def io_phase(cst, card, evp_counters):
    """Phase 37: the run loop's I/O on the card with the flagship
    ``bench.py:build(512, 120)``: 4 steps through ``Simulation.run``
    uninterrupted; 2 steps with a Checkpointer at step 2; a fresh run picked
    up from it (``pickup=True``) to step 4, with 2.1's launches counted on
    the resumed path, bitwise equal to the uninterrupted run; one NetCDF
    file of the card's state written and read back; one step under
    ``run(profile_dir=…)``, whose trace must show 2.1's kernel.  Returns 2.1's
    launches on the resumed path."""
    import numpy as np
    import torch
    from scipy.io import netcdf_file
    from climaseaice_jl_tpu_torch.dynamics import fused_evp
    from climaseaice_jl_tpu_torch.io import Checkpointer, NetCDFWriter
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_io_")
    try:
        model = flagship(cst, 512, 120)
        fresh = flagship_state(cst, model)
        straight = cst.Simulation(model, fresh, dt=120.0, stop_iteration=4)
        straight.run()
        prefix = os.path.join(work, "flagship")
        first = cst.Simulation(model, fresh, dt=120.0, stop_iteration=2)
        first.output_writers["checkpoint"] = Checkpointer(prefix, cst.IterationInterval(2))
        first.run()
        resumed = cst.Simulation(model, flagship_state(cst, model), dt=120.0, stop_iteration=4)
        resumed.output_writers["checkpoint"] = Checkpointer(prefix, cst.IterationInterval(10 ** 9))
        for c in evp_counters.values():
            c.reset()
        resumed.run(pickup=True)
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in evp_counters.items() if c.launches}
        per_step = 3 * -(-120 // fused_evp.chunk_substeps())
        if launches != {"2.1": 2 * per_step}:
            raise AssertionError(f"[37] the resumed run launched {launches}, expected 2.1 "
                                 f"{2 * per_step} times and nothing else")
        names = ("h", "a", "u", "v", "sig11", "sig22", "sig12", "alpha", "Tu")
        differ = [n for n in names if not torch.equal(getattr(straight.state, n),
                                                      getattr(resumed.state, n))]
        if resumed.iteration != 4 or differ:
            raise AssertionError(f"[37] pickup: iteration {resumed.iteration}, fields that "
                                 f"differ from the uninterrupted run: {differ}")
        print(f"[37] flagship 512²: 4 steps through Simulation.run, and 2 steps with a "
              f"Checkpointer at step 2 picked up (pickup=True) by a fresh run to step 4: "
              f"{', '.join(names)} bitwise equal; 2.1 {launches['2.1']} launches on the resumed "
              f"path ({per_step} a step), no other EVP kernel")
        nc = os.path.join(work, "flagship.nc")
        NetCDFWriter(["h", "a", "u", "v"], nc, cst.IterationInterval(1)).maybe_write(resumed)
        g = model.grid
        with netcdf_file(nc, "r", mmap=False) as f:
            back = {n: f.variables[n][0] for n in ("h", "a", "u", "v")}
            shape = f.variables["h"].shape
        if not all(np.array_equal(back[n], g.interior(getattr(resumed.state, n)).cpu().numpy())
                   for n in back):
            raise AssertionError("[37] the NetCDF file does not hold the card's state")
        print(f"    one NetCDF record of h, ℵ, u, v from the card's state ({shape}, "
              f"{os.path.getsize(nc) / 1e6:.2f} MB) read back equal")
        traced = cst.Simulation(model, resumed.state, dt=120.0, stop_iteration=5)
        for c in evp_counters.values():
            c.reset()
        traced.run(profile_dir=os.path.join(work, "trace"))
        with open(traced.trace_file) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"
                   and "periodic_chunk" in e.get("name", "") and "LoadedForms" in e["name"]]
        if len(kernels) != evp_counters["2.1"].launches or not kernels:
            raise AssertionError(f"[37] the trace holds {len(kernels)} launches of 2.1's kernel; "
                                 f"the counter {evp_counters['2.1'].launches}")
        print(f"    run(profile_dir=…) of one step: a Chrome trace of "
              f"{os.path.getsize(traced.trace_file) / 1e6:.1f} MB with {len(kernels)} launches "
              f"of 2.1's kernel ({kernels[0]['name'][:60]}…), "
              f"{sum(e['dur'] for e in kernels) / 1e3:.3f} ms of it, on {card} "
              f"({time.perf_counter() - t0:.1f} s)")
        return launches["2.1"]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def coupled_channel(cst, N, dtype="float32", P_star=27500.0, device="cuda", seed=None,
                    ocean_seed=None):
    """`examples/melting_over_dynamic_ocean.py:build(N)` (the periodic ×
    bounded channel, αEVP with 120 substeps, FPlane, WENO-7, RK3, the
    shallow-water ocean with 24 substeps and κ = 20) in ``dtype`` with P★ =
    ``P_star``; with ``seed``, seeded ice velocities, with ``ocean_seed``
    seeded ocean velocities.  The example's ``build`` keeps the JAX
    example's arguments, which have neither."""
    import numpy as np
    from climaseaice_jl_tpu_torch import coupled as cp
    from climaseaice_jl_tpu_torch.ocean import ShallowWaterOcean
    grid = cst.RectilinearGrid(size=(N, N), x=(-50 * KM, 50 * KM), y=(-50 * KM, 50 * KM),
                               topology=("periodic", "bounded"), dtype=dtype, device=device)
    dynamics = cst.SeaIceMomentumEquation(
        rheology=cst.ElastoViscoPlasticRheology(ice_compressive_strength=P_star),
        coriolis=cst.FPlane(f=1.4e-4), top_momentum_stress={"u": 0.05, "v": 0.0},
        bottom_momentum_stress=cst.SemiImplicitStress(),
        solver=cst.SplitExplicitSolver(substeps=120))
    ice = cst.sea_ice_model(grid, dynamics=dynamics, top_heat_flux=(cst.RadiativeEmission(),),
                            bottom_heat_flux=0.0, ice_salinity=5.0, advection=cst.WENO(order=7),
                            timestepper="SplitRungeKutta3")
    ocean = ShallowWaterOcean(depth=50.0, coriolis=cst.FPlane(f=1.4e-4), wind_stress_x=0.05,
                              substeps=24, tracer_diffusivity=20.0)
    iom = cp.IceOceanModel(ice=ice, ocean=ocean)
    x = (np.arange(N) + 0.5) * (100 * KM / N) - 50 * KM
    T0 = -1.5 + 2.5 * np.exp(-(x[None, :] / (15 * KM)) ** 2) * np.ones((N, 1))
    kw = {}
    for keys, value in ((("u", "v"), seed), (("u_ocean", "v_ocean"), ocean_seed)):
        if value is not None:
            rng = np.random.default_rng(value)
            kw.update({k: 0.05 * rng.standard_normal((N, N)) for k in keys})
    return iom, cp.initial_state(iom, T_ocean=T0, S_ocean=30.0, h=1.0, a=1.0, **kw)


def ocean_at_rest_on_walls(iom, cstate):
    """The ocean's u and v zero on the peripheral nodes of the ice's grid."""
    g, masks = iom.ice.grid, iom.ice.masks
    for vel, per in ((cstate.u_ocean, masks.per_fc), (cstate.v_ocean, masks.per_cf)):
        per = g.interior(per)
        if per.any() and g.interior(vel)[per].abs().max().item() != 0.0:
            raise AssertionError("ocean velocity on a peripheral node")


def side_model_phases(cst, card, evp_counters):
    """Phases 38-40: the enthalpy column, the ice over the slab ocean and the
    ice over the shallow-water ocean on the card.  Returns the launches of
    2.3 on phase 40's coupled path and its kernel entry's timing and
    shape."""
    import numpy as np
    import torch
    from climaseaice_jl_tpu_torch import coupled as cp
    from climaseaice_jl_tpu_torch import enthalpy as em
    from climaseaice_jl_tpu_torch.dynamics import fused_evp_padded
    from climaseaice_jl_tpu_torch.examples import (diffusive_ice_column_model,
                                                   ice_ocean_coupled, melting_over_dynamic_ocean)
    from climaseaice_jl_tpu_torch.convert import coupled_state_to_numpy
    events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    def timed(fn):
        """(result, CUDA-event ms) of ``fn()``."""
        torch.cuda.synchronize()
        events[0].record()
        out = fn()
        events[1].record()
        torch.cuda.synchronize()
        return out, events[0].elapsed_time(events[1])

    # --- 38. the enthalpy column --------------------------------------------------------
    t0 = time.perf_counter()
    model, state = diffusive_ice_column_model.build(device="cuda")
    (_, t, T), ms = timed(lambda: diffusive_ice_column_model.run(model, state))
    ref = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "validation",
                               "diffusive_ice_column.npz"))
    if not np.array_equal(t, ref["t"]):
        raise AssertionError("[38] the column's record times differ from the golden's")
    np.testing.assert_allclose(T, ref["T"], rtol=1e-9, atol=1e-11)
    worst = np.abs(T - ref["T"]).max()
    print(f"[38] diffusive_ice_column_model: 10 days, 8,640 steps of 100 s, float64, "
          f"{ms / 8640 * 1e3:.1f} µs a step (CUDA events, no host read until the end); its 40 "
          f"records within rtol 1e-9, atol 1e-11 of validation/diffusive_ice_column.npz "
          f"(largest difference {worst:.2e} °C), on {card}")
    rng = np.random.default_rng(38)

    def batch(columns, device):
        """The example's column model and a seeded enthalpy in ``columns``."""
        grid = em.ZGrid(Nz=20, device=device)
        m = em.EnthalpyMethodSeaIceModel(
            grid=grid, closure=em.MolecularDiffusivity(kappa_ice=1e-5, kappa_water=1e-6),
            top_T_bc=em.ValueBoundaryCondition(diffusive_ice_column_model.air_ice_temperature),
            bottom_T_bc=em.ValueBoundaryCondition(
                diffusive_ice_column_model.ice_ocean_temperature))
        H = H0[tuple(slice(0, n) for n in columns)]
        return m, em.initial_state(m, H=torch.as_tensor(H, device=grid.device), columns=columns)

    def steps_of(m, s, n):
        for _ in range(n):
            s = em.step(m, s, 100.0)
        return s

    H0 = 2090.0 / 999.8 * rng.uniform(-4.0, 2.0, (512, 512, 20))
    m, s = batch((512, 512), "cuda")
    steps_of(m, s, 1)                                                    # warm-up
    s, ms = timed(lambda: steps_of(m, s, 100))
    if not torch.isfinite(s.T).all():
        raise AssertionError("[38] the batched columns are not finite")
    small = {d: steps_of(*batch((16, 16), d), 100) for d in ("cuda", "cpu")}
    rels = {n: rel_diff(getattr(small["cpu"], n), getattr(small["cuda"], n).cpu())[0]
            for n in ("H", "T", "kappa")}
    print(f"    batched columns (512, 512) × 20 cells, float64, 100 steps: finite, "
          f"{ms / 100:.3f} ms a step (CUDA events); card vs CPU on a "
          f"(16, 16) batch, 100 steps: "
          + ", ".join(f"{n} {r:.1e}" for n, r in rels.items()) + f" (bar 1e-12), on {card} "
          f"({time.perf_counter() - t0:.1f} s)")
    for n, r in rels.items():
        check(n, r, 1e-12)

    # --- 39. the ice over the slab ocean ------------------------------------------------
    t0 = time.perf_counter()
    iom, cstate = ice_ocean_coupled.build(device="cuda")
    (_, series), ms = timed(lambda: ice_ocean_coupled.run(iom, cstate, 2880))
    ref = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "validation",
                               "ice_ocean_coupled.npz"))
    devs = {}
    for k, name in enumerate(("t", "h", "T", "S")):
        devs[name] = np.abs(series[:, k] - ref[name]).max() / np.abs(ref[name]).max()
    print(f"[39] ice_ocean_coupled: 2 years, 2,880 coupled steps of 6 h on 8×8, Forward Euler, "
          f"float64, {ms / 2880:.3f} ms a step (CUDA events); its 72 records against "
          f"validation/ice_ocean_coupled.npz, largest deviation over the series' largest "
          f"magnitude: " + ", ".join(f"{n} {d:.2e}" for n, d in devs.items())
          + f" (bar 1e-6), on {card} ({time.perf_counter() - t0:.1f} s)")
    if series.shape != (72, 4) or not max(devs.values()) <= 1e-6:
        raise AssertionError(f"[39] the slab-ocean run parts from its golden: {devs}")

    # --- 40. the ice over the shallow-water ocean -----------------------------------------
    # (a) the example's short run of tests/test_examples.py:102
    t0 = time.perf_counter()
    iom, cstate = melting_over_dynamic_ocean.build(N=32, device="cuda")
    g = iom.ice.grid
    h0 = g.interior(cstate.ice.h).clone()

    def loop(iom_, s, n, dt=1200.0):
        for _ in range(n):
            s = cp.coupled_step(iom_, s, dt)
        return s

    cstate, ms = timed(lambda: loop(iom, cstate, 12))
    h, uo = g.interior(cstate.ice.h), g.interior(cstate.u_ocean)
    mid, edge = h[:, h.shape[1] // 2].mean(), h[:, 2].mean()
    if not (torch.isfinite(h).all() and torch.isfinite(uo).all()
            and mid < h0[:, h0.shape[1] // 2].mean() and mid < edge
            and uo.abs().max() > 1e-5):
        raise AssertionError("[40] melting_over_dynamic_ocean: the short run's assertions failed")
    print(f"[40] (a) melting_over_dynamic_ocean.build(N=32): 12 coupled steps of 20 min, float64 "
          f"(the general path), {ms / 12:.1f} ms a step (CUDA events, first step included); "
          f"finite, the warm strip thinner ({mid.item():.4f} m) than the edge "
          f"({edge.item():.4f} m), |u_ocean| {uo.abs().max().item():.2e} m/s, on {card} "
          f"({time.perf_counter() - t0:.1f} s)")

    # (b) the slice's main path at full width: float32, 512².  The ocean's
    # forward-backward substeps hold while gravity waves cross fewer than
    # about √2 cells a substep, √(gH)·Δt/(24·Δx): 0.35 in the 32² run that
    # tests/test_examples.py:102 makes with the example's 20 min step, 1.42 at
    # the example's default N = 128, where both packages blow up within a
    # step (ROADMAP.md §3), 5.7 at 512².  So Δt shrinks with Δx, keeping the
    # tested run's 0.35: 75 s at 512², 300 s at 128²
    t0 = time.perf_counter()
    N, nsub = 512, 120
    dt = 1200.0 * 32 / N
    iom, cstate = coupled_channel(cst, N)
    cstate = cp.coupled_step(iom, cstate, dt)                           # warm-up
    torch.cuda.synchronize()
    g = iom.ice.grid

    def volume(s):
        return (g.interior(s.eta).double() * g.interior(g.az_cc.expand(g.shape)).double()).sum()

    def abs_volume(s):
        return (g.interior(s.eta).double().abs() * float(g.az_cc)).sum()

    vol0 = volume(cstate)
    for c in evp_counters.values():
        c.reset()
    steps = 3
    cstate, ms = timed(lambda: loop(iom, cstate, steps, dt))
    calls = {k: (c.calls, c.launches) for k, c in evp_counters.items() if c.calls}
    per_call = -(-nsub // fused_evp_padded.chunk_substeps())
    want = {"2.3": (3 * steps, 3 * steps * per_call)}
    if calls != want:
        raise AssertionError(f"[40] EVP kernel calls and launches {calls}, expected {want}")
    check_state(iom.ice, cstate.ice)
    ocean_at_rest_on_walls(iom, cstate)
    for name in ("T_ocean", "S_ocean", "u_ocean", "v_ocean", "eta"):
        if not torch.isfinite(g.interior(getattr(cstate, name))).all():
            raise AssertionError(f"[40] {name} is not finite")
    drift = abs(volume(cstate) - vol0).item()
    bound = steps * iom.ocean.substeps * float(np.finfo(np.float32).eps) * abs_volume(cstate).item()
    if not drift <= bound:
        raise AssertionError(f"[40] ∑η·Az drifted by {drift:.3e} m³, above {bound:.3e}")
    coupled_launches = calls["2.3"][1]
    print(f"[40] (b) the channel in float32 at {N}² (coupled_channel: 120 EVP substeps, 24 "
          f"ocean substeps, WENO-7, RK3, Δt {dt:.0f} s): {steps} coupled steps after a warm-up, "
          f"{ms / steps:.2f} ms a step (CUDA events); 2.3 {calls['2.3'][0]} calls, "
          f"{coupled_launches} launches ({per_call} a call), 2.1 and 2.2 none; finite, h ≥ 0, "
          f"0 ≤ ℵ ≤ 1, ice and ocean at rest on the walls; ∑η·Az moved {drift:.3e} m³ "
          f"(float32 bound {bound:.3e}: {steps * iom.ocean.substeps} substeps × ε × ∑|η|·Az)")
    ice_model = cp.ice_model_for_step(iom, cstate)
    turns = []
    for name in ("coupled", "ice alone", "coupled", "ice alone"):
        if name == "coupled":
            _, turn_ms = timed(lambda: loop(iom, cstate, 2, dt))
        else:
            _, turn_ms = timed(lambda: [cst.step(ice_model, cstate.ice, dt) for _ in range(2)])
        turns.append(f"{name} {turn_ms / 2:.2f}")
    device_ms, syncs, _ = profile_device_ms(cst, iom, cstate, dt, step=cp.coupled_step)
    print(f"    in turns, ms a step (CUDA events, 2 steps each from the same state; the ice "
          f"step alone is cst.step on the refreshed ice model): {', '.join(turns)}; one "
          f"profiled coupled step {device_ms:.3f} ms of device time, busy "
          f"{100 * device_ms / (ms / steps):.1f} %, {syncs} host waits, on {card} "
          f"({time.perf_counter() - t0:.1f} s)")

    # 2.3 against its plain version on this path's input (array uₑ, vₑ), soft ice
    soft, soft_state = coupled_channel(cst, N, P_star=27.5, seed=40, ocean_seed=39)
    soft_model = cp.ice_model_for_step(soft, soft_state)
    ice = soft_state.ice
    params, consts, carry, _ = fused_evp_padded.padded_evp_inputs(soft_model, ice, dt,
                                                                  ice.u, ice.v)
    if not torch.equal(consts[-2], soft_state.u_ocean) or len(consts) != 18:
        raise AssertionError("[40] the ocean's u did not reach 2.3 as uₑ")
    out = fused_evp_padded.padded_evp_substeps(params, consts, [q.clone() for q in carry],
                                               nsub, g)
    ref23 = fused_evp_padded.padded_evp_substeps_reference(params, consts, carry, nsub, g)
    torch.cuda.synchronize()
    print(f"    2.3 against its plain version on the coupled path's input ({g.nxp}×{g.nyp} "
          f"padded, the ocean's seeded u, v as uₑ, vₑ, soft ice, seeded ice velocities, "
          f"{nsub} substeps):")
    worst_rel = worst_abs = 0.0
    for name, r, o, bar in zip(("u", "v", "sig11", "sig22", "sig12", "alpha"), ref23, out,
                               (1e-4, 1e-4, 4e-3, 4e-3, 4e-3, 4e-3)):
        rel, abs_err = rel_diff(r, o)
        check(name, rel, bar)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)
    ulps = max(max_ulp(r, o) for r, o in zip(ref23, out))
    if ulps:
        raise AssertionError(f"[40] 2.3 is {ulps} ulp from its plain version")
    work = [q.clone() for q in carry]
    kernel_ms = cuda_ms(lambda: fused_evp_padded.padded_evp_substeps(
        params, consts, work, nsub, g), 20)
    plain_ms = cuda_ms(lambda: fused_evp_padded.padded_evp_substeps_reference(
        params, consts, carry, nsub, g), 3)
    points = g.nxp * g.nyp
    nbytes = ((PADDED_NODRAG_ARRAYS_READ + EVP_ARRAYS_WRITTEN) * points + EVP_PARAMS) * 4
    flops = (PADDED_NODRAG_FLOPS_PER_POINT_SUBSTEP * nsub + PADDED_FLOPS_PER_POINT_CALL) * points
    bytes_ms, ops_ms = bounds_ms(nbytes, flops)
    print(f"    bitwise over the whole padded arrays; kernel {kernel_ms:.4f} ms a call, plain "
          f"{plain_ms:.3f} ms, bound {max(bytes_ms, ops_ms):.4f} ms ({flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB), on {card}")
    timing = (worst_abs, worst_rel, kernel_ms, plain_ms, bytes_ms, ops_ms)
    shape = f"{g.nxp}x{g.nyp} padded ({N}x{N} periodic x bounded channel, ocean u, v as ue, ve)"
    del out, ref23, work, carry, consts

    # (c) card against CPU at 128²: the ice's velocities seeded, the ocean at
    # rest as the example starts it.  Seeded grid-scale ocean currents make
    # the SST and salinity ill-conditioned: there one float32 ulp of the
    # ice's u alone moves them by 2e-5 in two steps on either device
    t0 = time.perf_counter()
    finals = {}
    for device in ("cuda", "cpu"):
        m, s = coupled_channel(cst, 128, P_star=27.5, device=device, seed=41)
        finals[device] = coupled_state_to_numpy(loop(m, s, 2, 1200.0 * 32 / 128))
    print(f"[40] (c) the channel at 128², float32, soft ice, seeded ice velocities, 2 coupled "
          f"steps of 300 s, "
          f"card (2.3) vs CPU (its plain version) ({time.perf_counter() - t0:.1f} s):")
    bars = {"ice/u": 1e-4, "ice/v": 1e-4, "ice/sig11": 4e-3, "ice/sig22": 4e-3,
            "ice/sig12": 4e-3, "ice/alpha": 4e-3, "ice/h": 1e-5, "ice/a": 1e-5,
            "T_ocean": 1e-5, "S_ocean": 1e-5, "eta": 1e-5}
    for name, bar in bars.items():
        rel, _ = rel_diff(torch.as_tensor(finals["cpu"][name]),
                          torch.as_tensor(finals["cuda"][name]))
        check(name, rel, bar)
    return coupled_launches, timing, shape


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="FILE",
                        help="write torch.profiler tables of one flagship step and "
                             "one bounded step to FILE")
    parser.add_argument("--parent", metavar="DIR",
                        help="a checkout of commit 2a3ee95 (its CUDA sources and wrappers "
                             "are checked): hold kernels 2.10 and 2.4 against its builds of "
                             "them and time them in turns (phases 13, 14, 17, 24, 27)")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    import climaseaice_jl_tpu_torch as cst
    from climaseaice_jl_tpu_torch import _build
    from climaseaice_jl_tpu_torch.dynamics import (fused_evp, fused_evp_curvilinear,
                                                   fused_evp_padded, fused_evp_tiled)
    from climaseaice_jl_tpu_torch.arctic_basin import basin_model, basin_state
    from climaseaice_jl_tpu_torch.convert import state_to_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name_and_power_limit()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    counter = fused_evp.evp_counter
    tiled_evp_counter = fused_evp_tiled.tiled_evp_counter
    padded_counter = fused_evp_padded.padded_evp_counter
    profiles = []

    # --- 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    units = thermo_units(cst)
    winds = pointwise_units()
    trig = trig_unit()
    _build.build(generated={**units, **winds, trig.name: trig.text})
    print(f"[1] built {sorted(_build.SOURCES)}, the column-kernel units {sorted(units)} and "
          f"the wind units {sorted(winds)} in {time.perf_counter() - t0:.1f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")
    earlier = None if args.parent is None else earlier_modules(args.parent)

    # --- 2. kernel vs plain version on the card ----------------------------------
    N, nsub = 512, 120
    model = flagship(cst, N, nsub, P_star=27.5)
    state = flagship_state(cst, model, velocity_seed=0)
    dt = 120.0
    names = ("u", "v", "sig11", "sig22", "sig12", "alpha")
    params, consts, carry, _ = fused_evp.evp_inputs(model, state, dt, state.u, state.v)
    counter.reset()
    out = fused_evp.evp_substeps(params, consts, [q.clone() for q in carry], nsub)
    launches_21 = counter.launches
    ref = fused_evp.evp_substeps_reference(params, consts, carry, nsub)
    torch.cuda.synchronize()
    t21_chunk = fused_evp.chunk_substeps()
    print(f"[2] EVP kernel (2.1) vs plain version, {N}² soft ice, {nsub} substeps:")
    worst_rel = worst_abs = 0.0
    for name, r, o, bar in zip(names, ref, out, (1e-4, 1e-4, 4e-3, 4e-3, 4e-3, 4e-3)):
        if not torch.isfinite(o).all():
            raise AssertionError(f"{name} from 2.1 is not finite")
        rel, abs_err = rel_diff(r, o)
        check(name, rel, bar)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)
    t21_ulp = max(max_ulp(r, o) for r, o in zip(ref, out))
    print(f"    bitwise over the whole interior: {t21_ulp == 0} (largest distance {t21_ulp} "
          f"ulp); {launches_21} launches a call, {t21_chunk} substeps a launch; "
          f"{fused_evp.describe()}")
    if t21_ulp or launches_21 != -(-nsub // t21_chunk):
        raise AssertionError(f"2.1 is {t21_ulp} ulp from its plain version with {launches_21} "
                             f"launches a call; it must be bitwise with {-(-nsub // t21_chunk)}")
    work = [q.clone() for q in carry]
    kernel_ms = cuda_ms(lambda: fused_evp.evp_substeps(params, consts, work, nsub), 20)
    plain_ms = cuda_ms(lambda: fused_evp.evp_substeps_reference(params, consts, carry, nsub), 3)
    points = N * N
    evp_bytes = ((EVP_ARRAYS_READ + EVP_ARRAYS_WRITTEN) * points + EVP_PARAMS) * 4
    evp_flops = (FLOPS_PER_POINT_SUBSTEP * nsub + FLOPS_PER_POINT_CALL) * points
    bytes_ms = evp_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = evp_flops / FP32_FLOP_PER_S * 1e3
    print(f"    kernel {kernel_ms:.4f} ms/call, plain {plain_ms:.3f} ms/call, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms ({evp_flops / 1e9:.2f} GFLOP, "
          f"{evp_bytes / 1e6:.1f} MB) on {card}")
    evp_timing = (worst_abs, worst_rel, kernel_ms, plain_ms, bytes_ms, ops_ms)
    del out, ref, work

    # --- 3. the main path ---------------------------------------------------------
    flag_model = model = flagship(cst, N, nsub)
    state = flagship_state(cst, model)
    dt, steps = 120.0, 5
    state = cst.step(model, state, dt)                  # warm-up
    torch.cuda.synchronize()
    counter.reset()
    tiled_evp_counter.reset()
    state, step_ms, host_ms = timed_steps(cst, model, state, dt, steps)
    main_calls, main_launches = counter.calls, counter.launches
    check_state(model, state)
    flag_state = state
    if (main_calls != 3 * steps or main_launches != 3 * steps * launches_21
            or tiled_evp_counter.calls):
        raise AssertionError(f"EVP wrapper: {main_calls} calls, {main_launches} launches, "
                             f"tiled {tiled_evp_counter.calls} calls; expected "
                             f"{3 * steps}, {3 * steps * launches_21} and 0")
    print(f"[3] main path {N}² flagship: {step_ms:.2f} ms/step (CUDA events; host "
          f"{host_ms:.2f} ms/step), {points / step_ms * 1e3:.4e} points/s, "
          f"EVP {main_calls} calls / {main_launches} launches in {steps} steps, on {card}")
    if args.profile:
        profiles.append(profile_step(cst, model, state, dt, f"{N}² flagship step", card))

    # --- 4. the dispatch boundary between 2.1 and 2.2 ------------------------------------
    t22_chunk = fused_evp_tiled.chunk_substeps()
    for n, expected in ((512, (3, 0)), (768, (0, 3)), (4096, (0, 3))):
        big = flagship(cst, n, nsub)
        big_state = flagship_state(cst, big)
        counter.reset()
        tiled_evp_counter.reset()
        t0 = time.perf_counter()
        big_state = cst.step(big, big_state, dt)
        torch.cuda.synchronize()
        calls = (counter.calls, tiled_evp_counter.calls)
        launches = (counter.launches, tiled_evp_counter.launches)
        expected_launches = (expected[0] * -(-nsub // t21_chunk),
                             expected[1] * -(-nsub // t22_chunk))
        if calls != expected or launches != expected_launches:
            raise AssertionError(f"{n}² step: {calls[0]} calls of 2.1 and {calls[1]} of 2.2 "
                                 f"({launches} launches), expected {expected[0]} and "
                                 f"{expected[1]} ({expected_launches})")
        check_state(big, big_state)
        print(f"[4] {n}² step ({n * n} points): {calls[0]} calls of 2.1, {calls[1]} of 2.2 "
              f"({launches[0]} and {launches[1]} launches), finite and physical, "
              f"{time.perf_counter() - t0:.2f} s")
        del big, big_state

    # --- 5. card vs CPU -------------------------------------------------------------
    finals = {}
    for device in ("cuda", "cpu"):
        m = flagship(cst, 128, nsub, P_star=27.5, device=device)
        s = flagship_state(cst, m, velocity_seed=1)
        for _ in range(2):
            s = cst.step(m, s, dt)
        finals[device] = state_to_numpy(s)
    print("[5] 128² soft ice, 2 RK3 steps, card (kernel) vs CPU (plain version):")
    for name, bar in (("u", 1e-4), ("v", 1e-4), ("h", 1e-5), ("a", 1e-5), ("sig11", 4e-3),
                      ("sig22", 4e-3), ("sig12", 4e-3), ("alpha", 4e-3)):
        rel, _ = rel_diff(torch.as_tensor(finals["cpu"][name]),
                          torch.as_tensor(finals["cuda"][name]))
        check(name, rel, bar)
    if not all(np.isfinite(q).all() for q in finals["cuda"].values()):
        raise AssertionError("card run is not finite")

    # --- 6. padded kernel vs plain version on the card -------------------------------
    model = bounded(cst, N, nsub, P_star=27.5)
    grid = model.grid
    state = flagship_state(cst, model, velocity_seed=2)
    params, consts, carry, _ = fused_evp_padded.padded_evp_inputs(model, state, dt,
                                                                  state.u, state.v)
    if len(consts) != 22:
        raise AssertionError("the immersed drag did not reach the padded kernel")
    padded_counter.reset()
    out = fused_evp_padded.padded_evp_substeps(params, consts, [q.clone() for q in carry],
                                               nsub, grid)
    ref = fused_evp_padded.padded_evp_substeps_reference(params, consts, carry, nsub, grid)
    torch.cuda.synchronize()
    launches_per_call = padded_counter.launches
    t23_chunk = fused_evp_padded.chunk_substeps()
    print(f"[6] padded EVP kernel vs plain version, {N}² bounded + island + drag, soft ice, "
          f"{nsub} substeps, whole {grid.nxp}×{grid.nyp} padded arrays:")
    worst_rel = worst_abs = 0.0
    for name, r, o, bar in zip(("u", "v", "sig11", "sig22", "sig12", "alpha"), ref, out,
                               (1e-4, 1e-4, 4e-3, 4e-3, 4e-3, 4e-3)):
        rel, abs_err = rel_diff(r, o)
        check(name, rel, bar)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)
    ulps = max(max_ulp(r, o) for r, o in zip(ref, out))
    print(f"    bitwise over the whole padded arrays: {ulps == 0} (largest distance {ulps} ulp; "
          f"the parent design was bitwise); {launches_per_call} launches a call, "
          f"{t23_chunk} substeps a launch; {fused_evp_padded.describe()}")
    if ulps or launches_per_call != -(-nsub // t23_chunk):
        raise AssertionError(f"the padded kernel is {ulps} ulp from its plain version over the "
                             f"padded arrays, {launches_per_call} launches a call")
    work = [q.clone() for q in carry]
    kernel_ms = cuda_ms(lambda: fused_evp_padded.padded_evp_substeps(
        params, consts, work, nsub, grid), 20)
    plain_ms = cuda_ms(lambda: fused_evp_padded.padded_evp_substeps_reference(
        params, consts, carry, nsub, grid), 3)
    padded_points = grid.nxp * grid.nyp
    padded_bytes = ((PADDED_ARRAYS_READ + EVP_ARRAYS_WRITTEN) * padded_points + EVP_PARAMS) * 4
    padded_flops = ((PADDED_FLOPS_PER_POINT_SUBSTEP * nsub + PADDED_FLOPS_PER_POINT_CALL)
                    * padded_points)
    bytes_ms = padded_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = padded_flops / FP32_FLOP_PER_S * 1e3
    print(f"    kernel {kernel_ms:.4f} ms/call ({launches_per_call} launches), plain "
          f"{plain_ms:.3f} ms/call, bound {max(bytes_ms, ops_ms):.4f} ms "
          f"({padded_flops / 1e9:.2f} GFLOP, {padded_bytes / 1e6:.1f} MB) on {card}")
    padded_timing = (worst_abs, worst_rel, kernel_ms, plain_ms, bytes_ms, ops_ms)
    padded_shape = f"{grid.nxp}x{grid.nyp} padded ({N}x{N} bounded, island, drag)"
    # the curvilinear kernel computes this function too (uniform metrics, no
    # fold): its result against the padded kernel's, and both timed in turns
    # on the same input, which is what the route gate's choice rests on
    c_params, c_consts, c_carry, _, c_planes = fused_evp_curvilinear.curvilinear_evp_inputs(
        model, state, dt, state.u, state.v)
    c_out = fused_evp_curvilinear.curvilinear_evp_substeps(
        c_params, c_consts, [q.clone() for q in c_carry], nsub, grid, c_planes)
    torch.cuda.synchronize()
    print("    the curvilinear kernel on the same input, against the padded kernel:")
    for name, r, o, bar in zip(("u", "v", "sig11", "sig22", "sig12", "alpha"), out, c_out,
                               (1e-4, 1e-4, 4e-3, 4e-3, 4e-3, 4e-3)):
        check(name, rel_diff(r, o)[0], bar)
    c_work = [q.clone() for q in c_carry]
    route_turns = []
    for name in ("padded", "curvilinear", "padded", "curvilinear"):
        if name == "padded":
            turn_ms = cuda_ms(lambda: fused_evp_padded.padded_evp_substeps(
                params, consts, work, nsub, grid), 20)
        else:
            turn_ms = cuda_ms(lambda: fused_evp_curvilinear.curvilinear_evp_substeps(
                c_params, c_consts, c_work, nsub, grid, c_planes), 20)
        route_turns.append(f"{name} {turn_ms:.4f}")
    print(f"    in turns, ms per call (CUDA events, 20 calls): {', '.join(route_turns)}, "
          f"on {card}")
    del work, out, ref, carry, consts, c_out, c_work, c_carry, c_consts

    # --- 7. the slice's main path -----------------------------------------------------
    model = bounded(cst, N, nsub)
    state = flagship_state(cst, model)
    state = cst.step(model, state, dt)                  # warm-up
    torch.cuda.synchronize()
    counter.reset()
    padded_counter.reset()
    state, step_ms, host_ms = timed_steps(cst, model, state, dt, steps)
    padded_calls, padded_launches = padded_counter.calls, padded_counter.launches
    check_state(model, state)
    expected = 3 * steps
    if (padded_calls != expected or padded_launches != expected * launches_per_call
            or counter.calls != 0):
        raise AssertionError(f"padded EVP wrapper: {padded_calls} calls, {padded_launches} "
                             f"launches, periodic wrapper {counter.calls} calls; expected "
                             f"{expected}, {expected * launches_per_call} and 0")
    print(f"[7] slice main path {N}² bounded + island + drag: {step_ms:.2f} ms/step (CUDA "
          f"events; host {host_ms:.2f} ms/step), {points / step_ms * 1e3:.4e} points/s, "
          f"padded EVP {padded_calls} calls / {padded_launches} launches in {steps} "
          f"steps, on {card}")
    # both main paths again, in turns, to separate the code from the shared host
    turns = []
    for name, m, s in (("flagship", flag_model, flag_state), ("bounded", model, state),
                       ("flagship", flag_model, flag_state), ("bounded", model, state)):
        _, turn_ms, _ = timed_steps(cst, m, s, dt, steps)
        turns.append(f"{name} {turn_ms:.2f}")
    print(f"    in turns, ms/step (CUDA events): {', '.join(turns)}")
    del flag_model, flag_state
    bounded_model, bounded_state = model, state         # phase 14's turns
    if args.profile:
        profiles.append(profile_step(cst, model, state, dt,
                                     f"{N}² bounded + island + drag step", card))
        os.makedirs(os.path.dirname(os.path.abspath(args.profile)), exist_ok=True)

    # --- 8. the example configurations -------------------------------------------------
    from climaseaice_jl_tpu_torch.examples import (ice_advected_by_anticyclone,
                                                   ice_advected_on_coastline)
    model, state = ice_advected_by_anticyclone.build(N=128, substeps=150, dtype="float32",
                                                     device="cuda")
    padded_counter.reset()
    t0 = time.perf_counter()
    for _ in range(5):
        state = cst.step(model, state, 2 * MINUTE)
    torch.cuda.synchronize()
    check_state(model, state)
    if padded_counter.calls != 15 or padded_counter.launches != 15 * -(-150 // t23_chunk):
        raise AssertionError(f"anticyclone: {padded_counter.calls} padded calls, "
                             f"{padded_counter.launches} launches, expected 15 calls of "
                             f"{-(-150 // t23_chunk)}")
    speed = model.grid.interior(state.u).abs().max().item()
    print(f"[8] anticyclone 128², 5 steps: finite and physical, max |u| {speed:.4e} m/s, "
          f"{padded_counter.calls} padded calls, {time.perf_counter() - t0:.2f} s")
    model, state = ice_advected_on_coastline.build(Nx=256, Ny=128, substeps=150,
                                                   dtype="float32", device="cuda")
    sim = cst.Simulation(model, state, dt=5 * MINUTE, stop_iteration=10)
    fired = []
    sim.callbacks["iterations"] = cst.Callback(lambda s: fired.append(s.iteration),
                                               schedule=cst.IterationInterval(5))
    padded_counter.reset()
    t0 = time.perf_counter()
    sim.run()
    check_state(model, sim.state)
    if (padded_counter.calls != 30 or padded_counter.launches != 30 * -(-150 // t23_chunk)
            or fired != [0, 5, 10]):
        raise AssertionError(f"coastline: {padded_counter.calls} padded calls, "
                             f"{padded_counter.launches} launches (expected 30 calls of "
                             f"{-(-150 // t23_chunk)}), callback at {fired} (expected "
                             f"[0, 5, 10])")
    print(f"    coastline 256×128, Simulation.run to iteration {sim.iteration}: finite and "
          f"physical, callback at {fired}, {padded_counter.calls} padded calls, "
          f"{time.perf_counter() - t0:.2f} s")

    # --- 9. card vs CPU, bounded and immersed ---------------------------------------------
    finals = {}
    for device in ("cuda", "cpu"):
        g = cst.RectilinearGrid(size=(128, 128), x=(0, 512 * KM), y=(0, 512 * KM),
                                halo=5, dtype="float32", topology=("bounded", "bounded"),
                                device=device)
        m = bounded(cst, 128, nsub, P_star=27.5, device=device,
                    top=ice_advected_by_anticyclone.wind_stress(),
                    bottom=ice_advected_by_anticyclone.ocean_stress(g))
        s = flagship_state(cst, m, velocity_seed=3)
        for _ in range(2):
            s = cst.step(m, s, dt)
        if device == "cuda":
            check_state(m, s)
        finals[device] = state_to_numpy(s)
    print("[9] 128² bounded + island + drag + StressFunction wind + array currents, soft "
          "ice, 2 RK3 steps, card (kernel) vs CPU (plain version):")
    for name, bar in (("u", 1e-4), ("v", 1e-4), ("h", 1e-5), ("a", 1e-5), ("sig11", 4e-3),
                      ("sig22", 4e-3), ("sig12", 4e-3), ("alpha", 4e-3)):
        rel, _ = rel_diff(torch.as_tensor(finals["cpu"][name]),
                          torch.as_tensor(finals["cuda"][name]))
        check(name, rel, bar)

    # --- 10. curvilinear kernel vs plain version on the card -----------------------------
    curv_counter = fused_evp_curvilinear.curvilinear_evp_counter
    model = basin_model(1152, 960, substeps=nsub, P_star=27.5)
    grid = model.grid
    state = flagship_state(cst, model, velocity_seed=4, h0=lambda x, y: 1.0)
    params, consts, carry, _, f_planes = fused_evp_curvilinear.curvilinear_evp_inputs(
        model, state, 300.0, state.u, state.v)
    if len(consts) != 34 or f_planes is None:
        raise AssertionError("drag or the f(φ) planes did not reach the curvilinear kernel")
    print(f"[10] curvilinear EVP kernel vs plain version, tripolar basin {grid.Nx}×{grid.Ny} "
          f"(land, fold, drag, f(φ)), soft ice, {nsub} substeps, whole {grid.nxp}×{grid.nyp} "
          "padded arrays:")
    curv_timing = compare_curvilinear(params, consts, carry, nsub, grid, f_planes, card)
    latlon = latlon_model(cst, 360, 160, nsub)
    ll_state = flagship_state(cst, latlon, velocity_seed=5, h0=lambda x, y: 1.0)
    ll_params, ll_consts, ll_carry, _, ll_planes = fused_evp_curvilinear.curvilinear_evp_inputs(
        latlon, ll_state, 300.0, ll_state.u, ll_state.v)
    if len(ll_consts) != 30 or ll_planes is not None:
        raise AssertionError("the latitude-longitude check should have no drag and a scalar f")
    print(f"     latitude-longitude {latlon.grid.Nx}×{latlon.grid.Ny} (no fold, no land, "
          "no drag, FPlane):")
    compare_curvilinear(ll_params, ll_consts, ll_carry, nsub, latlon.grid, None, card,
                        timed=False)
    del params, consts, carry, f_planes, state, ll_consts, ll_carry, ll_state, latlon

    # --- 11. the tripolar basin: the slice's main path --------------------------------------
    model = basin_model(1152, 960, substeps=nsub)
    grid = model.grid
    state = basin_state(model)
    dt = 300.0
    state = cst.step(model, state, dt)                  # warm-up
    torch.cuda.synchronize()
    for c in (counter, padded_counter, curv_counter):
        c.reset()
    state, step_ms, host_ms = timed_steps(cst, model, state, dt, steps)
    sim = cst.Simulation(model, state, dt=dt, stop_iteration=int(state.clock.iteration) + 2)
    sim.run()
    state = sim.state
    torch.cuda.synchronize()
    curv_calls, curv_launches = curv_counter.calls, curv_counter.launches
    expected = 3 * (steps + 2)
    if (curv_calls != expected or curv_launches != expected * (3 * nsub + 3)
            or counter.calls or padded_counter.calls):
        raise AssertionError(f"curvilinear EVP wrapper: {curv_calls} calls, {curv_launches} "
                             f"launches, periodic {counter.calls}, padded "
                             f"{padded_counter.calls} calls; expected {expected}, "
                             f"{expected * (3 * nsub + 3)}, 0 and 0")
    check_basin_state(model, state)
    basin_points = grid.Nx * grid.Ny
    device_ms, syncs, table = profile_device_ms(cst, model, state, dt)
    print(f"[11] slice main path, tripolar basin {grid.Nx}×{grid.Ny} (83 % land, snow, seasonal "
          f"fluxes, f(φ), winds, drag): {step_ms:.2f} ms/step (CUDA events; host "
          f"{host_ms:.2f} ms/step), {basin_points / step_ms * 1e3:.4e} points/s, "
          f"curvilinear EVP {curv_calls} calls / {curv_launches} launches in {steps} steps + "
          f"2 Simulation iterations; one profiled step {device_ms:.3f} ms of device time, "
          f"busy {100 * device_ms / step_ms:.1f} % of a step, {syncs} host waits on a "
          f"device value, on {card}")
    print("\n".join(table.splitlines()[:14]))
    if args.profile:
        profiles.append(f"tripolar basin {grid.Nx}×{grid.Ny} step on {card}: {device_ms:.3f} "
                        f"ms of device time\n{table}\n")
        with open(args.profile, "w") as f:
            f.write("\n".join(profiles))
    del model, state, sim

    # --- 12. card vs CPU, the basin -------------------------------------------------------
    finals = {}
    for device in ("cuda", "cpu"):
        m = basin_model(96, 80, substeps=nsub, P_star=27.5, device=device)
        s = basin_state(m, snow=0.1)
        for _ in range(2):
            s = cst.step(m, s, 300.0)
        if device == "cuda":
            check_basin_state(m, s)
        finals[device] = state_to_numpy(s)
    print("[12] 96×80 tripolar basin, soft ice, 10 cm of snow, 2 RK3 steps, card (kernel) "
          "vs CPU (plain version):")
    for name, bar in (("u", 1e-4), ("v", 1e-4), ("h", 1e-5), ("a", 1e-5), ("hs", 1e-5),
                      ("sig11", 4e-3), ("sig22", 4e-3), ("sig12", 4e-3), ("alpha", 4e-3)):
        rel, _ = rel_diff(torch.as_tensor(finals["cpu"][name]),
                          torch.as_tensor(finals["cuda"][name]))
        check(name, rel, bar)

    # --- 13. the fixed-tile kernels vs their plain versions -------------------------------
    from climaseaice_jl_tpu_torch.dynamics import fixed_tile_advection, fused_evp_tiled_padded
    from climaseaice_jl_tpu_torch.thermodynamics import fixed_tile_thermo
    prep_counter = fused_evp_padded.evp_prep_counter
    tiled_counter = fused_evp_tiled_padded.tiled_padded_evp_counter
    adv_counter = fixed_tile_advection.fixed_tile_advection_counter
    adv_runtime_counter = fixed_tile_advection.fixed_tile_advection_runtime_counter
    thermo_counter = fixed_tile_thermo.fixed_tile_thermo_counter
    fixed = (8, 128)
    dt = 120.0
    model = bounded(cst, N, nsub, P_star=27.5, fixed_tiles=fixed)
    grid = model.grid
    I = grid.interior
    state = flagship_state(cst, model, velocity_seed=6)
    points = grid.nxp * grid.nyp
    shape = f"{grid.nxp}x{grid.nyp} padded ({N}x{N} bounded, island, drag)"
    print(f"[13] fixed-tile kernels vs plain versions, {N}² bounded + island + drag, "
          f"{grid.nxp}×{grid.nyp} padded, on {card}:")

    # 2.4: the EVP coefficients, the plain version's raw bits
    dt_t = grid.scalar(dt)
    prm = fused_evp_padded.evp_prep_params(model, dt_t)
    h, a = state.h.contiguous(), state.a.contiguous()
    per = (model.masks.per_fc.contiguous(), model.masks.per_cf.contiguous())
    prep_fn = lambda: fused_evp_padded.evp_prep(model, dt_t, h, a)   # noqa: E731
    out = prep_fn()
    masked = fused_evp_padded.evp_prep(model, dt_t, h, a, grid, *per)
    ref = fused_evp_padded.evp_prep_reference(prm, h, a, grid)
    torch.cuda.synchronize()
    masked_ref = [r * (~per[k == 9]).to(torch.float32) if k in (6, 9) else r
                  for k, r in enumerate(ref)]
    ulps, same = bits_record(ref, out)
    masked_same = bits_record(masked_ref, masked)[1]
    prep_abs = max((r.double() - o.double()).abs().max().item() for r, o in zip(ref, out))
    prep_rel = max(rel_diff(r, o)[0] for r, o in zip(ref, out))
    print(f"  coefficients: {ulps} ulp from the plain version, raw bits {same}; with the "
          f"peripheral masks folded in, raw bits {masked_same}")
    if not (same and masked_same):
        raise AssertionError(f"the coefficient kernel is {ulps} ulp from its plain version, "
                             f"or differs in a signed zero (masked: raw bits {masked_same})")
    print_ptxas("evp_prep", gate=True)
    if earlier:
        old_prep = earlier["evp_prep"]
        old_fn = lambda: old_prep.evp_prep(   # noqa: E731
            old_prep.evp_prep_params(model, dt_t), h, a, grid)
        against_earlier("2.4", list(out), list(old_fn()), list(ref), True, card,
                        {"2.4": prep_fn, "earlier 2.4": old_fn})
        print_turns("device µs a launch (torch.profiler)",
                    device_in_turns({"2.4": prep_fn, "earlier 2.4": old_fn}, "evp_prep"),
                    "µs", card)
        print(f"      host µs a call: 2.4 {host_us(prep_fn):.1f}, earlier 2.4 (its parameters "
              f"formed on the device, as its launcher did) {host_us(old_fn):.1f}; device "
              f"operations a call: 2.4 {device_profile(prep_fn)[2]:.0f}, earlier 2.4 "
              f"{device_profile(old_fn)[2]:.0f}")
        inputs = {"2.4": fused_evp_padded.padded_evp_inputs,
                  "earlier 2.4": old_prep.padded_evp_inputs}
        print("      the EVP launcher's inputs (padded_evp_inputs, the masking folded in or "
              "not), device operations a call: " + "; ".join(
                  f"{k} {device_profile(lambda f=f: f(model, state, dt, state.u, state.v))[2]:.0f}"
                  for k, f in inputs.items()))
    kernel_ms = cuda_ms(prep_fn, 50)
    prep_dev_us = device_profile(prep_fn, 20, "evp_prep")[0]
    plain_ms = cuda_ms(lambda: fused_evp_padded.evp_prep_reference(prm, h, a, grid), 10)
    bytes_ms, ops_ms = bounds_ms((PREP_ARRAYS * points + PREP_PARAMS) * 4,
                                 PREP_FLOPS_PER_POINT * points)
    print(f"    kernel {kernel_ms:.4f} ms a call by CUDA events ({host_us(prep_fn):.1f} µs of "
          f"host time a call), {device_ms_text(prep_dev_us)} of device time a launch "
          f"(torch.profiler), plain {plain_ms:.4f} ms/call, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms")
    prep_timing = (prep_abs, prep_rel, kernel_ms, plain_ms, bytes_ms, ops_ms)

    # 2.5: the tiled EVP loop; against its plain version (the TPU kernel's
    # tiles of fixed_tiles), against the padded kernel on the same input, and
    # with chunks of K and 1 substeps
    params, consts, carry, _ = fused_evp_padded.padded_evp_inputs(model, state, dt,
                                                                  state.u, state.v)
    if len(consts) != 22:
        raise AssertionError("the immersed drag did not reach the tiled kernel")
    tiled_counter.reset()
    out = fused_evp_tiled_padded.tiled_padded_evp_substeps(
        params, consts, [q.clone() for q in carry], nsub, grid, fixed)
    tiled_launches_per_call = tiled_counter.launches
    t25_chunk = fused_evp_tiled_padded._tiled_entry()[1]
    half = fused_evp_tiled_padded.tiled_padded_evp_substeps(
        params, consts, [q.clone() for q in carry], nsub, grid, fixed, chunk=1)
    whole = fused_evp_padded.padded_evp_substeps(params, consts, [q.clone() for q in carry],
                                                 nsub, grid)
    ref = fused_evp_tiled_padded.tiled_padded_evp_substeps_reference(params, consts, carry,
                                                                     nsub, grid, fixed)
    torch.cuda.synchronize()
    names = ("u", "v", "sig11", "sig22", "sig12", "alpha")
    print(f"  tiled EVP, soft ice, {nsub} substeps ({tiled_launches_per_call} launches), "
          "interiors:")
    worst_rel = worst_abs = 0.0
    for name, r, o, bar in zip(names, ref, out, (1e-4, 1e-4, 4e-3, 4e-3, 4e-3, 4e-3)):
        if not torch.isfinite(I(o)).all():
            raise AssertionError(f"{name} from the tiled kernel is not finite")
        rel, abs_err = rel_diff(I(r), I(o))
        check(name, rel, bar)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)
    ulps = max(max_ulp(I(r), I(o)) for r, o in zip(ref, out))
    same_padded = all(torch.equal(I(w), I(o)) for w, o in zip(whole, out))
    same_chunks = all(torch.equal(I(x), I(o)) for x, o in zip(half, out))
    print(f"    bitwise: plain version {ulps == 0} (largest distance {ulps} ulp over the "
          f"interiors; the parent design was bitwise), padded kernel {same_padded}, chunks of "
          f"1 and {t25_chunk} {same_chunks}; {tiled_launches_per_call} launches a call; "
          f"{fused_evp_tiled_padded.describe()}")
    if ulps or not same_chunks or not same_padded:
        raise AssertionError(f"the tiled kernel is {ulps} ulp from its plain version; same bits "
                             f"as the padded kernel {same_padded}, across chunk lengths "
                             f"{same_chunks}")
    if tiled_launches_per_call != -(-nsub // t25_chunk):
        raise AssertionError(f"the tiled kernel made {tiled_launches_per_call} launches a call")
    work = [q.clone() for q in carry]
    work_padded = [q.clone() for q in carry]
    kernel_ms = cuda_ms(lambda: fused_evp_tiled_padded.tiled_padded_evp_substeps(
        params, consts, work, nsub, grid, fixed), 20)
    plain_ms = cuda_ms(lambda: fused_evp_tiled_padded.tiled_padded_evp_substeps_reference(
        params, consts, carry, nsub, grid, fixed), 2)
    bytes_ms, ops_ms = bounds_ms(
        ((PADDED_ARRAYS_READ + EVP_ARRAYS_WRITTEN) * points + EVP_PARAMS) * 4,
        (PADDED_FLOPS_PER_POINT_SUBSTEP * nsub + PADDED_FLOPS_PER_POINT_CALL) * points)
    route_turns = []
    for name in ("tiled", "padded", "tiled", "padded"):
        if name == "tiled":
            turn_ms = cuda_ms(lambda: fused_evp_tiled_padded.tiled_padded_evp_substeps(
                params, consts, work, nsub, grid, fixed), 20)
        else:
            turn_ms = cuda_ms(lambda: fused_evp_padded.padded_evp_substeps(
                params, consts, work_padded, nsub, grid), 20)
        route_turns.append(f"{name} {turn_ms:.4f}")
    print(f"    kernel {kernel_ms:.4f} ms/call, plain {plain_ms:.3f} ms/call, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms; in turns with the padded kernel, ms per call "
          f"(20 calls): {', '.join(route_turns)}")
    tiled_timing = (worst_abs, worst_rel, kernel_ms, plain_ms, bytes_ms, ops_ms)
    del out, half, whole, ref, work, work_padded, carry, consts

    # 2.9: the fixed-tile advection, uniform metrics on the slice (the tile kernel)
    div = fixed_tile_advection.make_fixed_tile_div(model, state.u, state.v)
    schemes = fixed_tile_advection._schemes(model.advection)
    masks = (model.masks.per_fc.contiguous(), model.masks.per_cf.contiguous())
    uniform = (1.0 / grid.scalar(grid.dx_cc), 1.0 / grid.scalar(grid.dy_cc))
    u_c, v_c, h_c = state.u.contiguous(), state.v.contiguous(), state.h.contiguous()
    out = div(h_c)
    ref = fixed_tile_advection.fixed_tile_div_reference(grid, schemes, u_c, v_c, h_c, masks,
                                                        uniform)
    torch.cuda.synchronize()
    adv_rel, adv_abs = rel_diff(ref, out)
    check("div(Uh)", adv_rel, 1e-6)
    ulps, same = bits_record([ref], [out])
    print(f"  advection, WENO-7 ({fixed_tile_advection.kernel_for(*schemes)}): {ulps} ulp from "
          f"the plain version over the padded arrays, raw bits {same}")
    if not same:
        raise AssertionError(f"2.9 is {ulps} ulp from its plain version")
    print_ptxas("advection_fixed", ["8tile_divI"], gate=True)
    kernel_ms = cuda_ms(lambda: div(h_c), 50)
    plain_ms = cuda_ms(lambda: fixed_tile_advection.fixed_tile_div_reference(
        grid, schemes, u_c, v_c, h_c, masks, uniform), 10)
    bytes_ms, ops_ms = bounds_ms(ADV_BYTES_PER_POINT * points, ADV_FLOPS_PER_POINT * points)
    print(f"    advection kernel {kernel_ms:.4f} ms/call, plain {plain_ms:.3f} ms/call, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms")
    adv_timing = (adv_abs, adv_rel, kernel_ms, plain_ms, bytes_ms, ops_ms)
    # a FluxFormAdvection of two schemes: the runtime-scheme kernel
    mixed = (cst.UpwindBiased(order=5), cst.Centered(order=2))
    out = fixed_tile_advection.fixed_tile_div(grid, mixed, u_c, v_c, h_c, masks, uniform)
    ref = fixed_tile_advection.fixed_tile_div_reference(grid, mixed, u_c, v_c, h_c, masks,
                                                        uniform)
    torch.cuda.synchronize()
    mixed_rel, mixed_abs = rel_diff(ref, out)
    ulps, same = bits_record([ref], [out])
    print(f"  advection, UpwindBiased(5) in x and Centered(2) in y "
          f"({fixed_tile_advection.kernel_for(*mixed)}): {ulps} ulp from the plain version "
          f"over the padded arrays, raw bits {same}")
    if not same:
        raise AssertionError(f"2.9's runtime-scheme kernel is {ulps} ulp from its plain version")
    kernel_ms = cuda_ms(lambda: fixed_tile_advection.fixed_tile_div(
        grid, mixed, u_c, v_c, h_c, masks, uniform), 50)
    plain_ms = cuda_ms(lambda: fixed_tile_advection.fixed_tile_div_reference(
        grid, mixed, u_c, v_c, h_c, masks, uniform), 10)
    # counted as ADV_FLOPS_PER_POINT: at the x face two UpwindBiased(5) sides of 10
    # (5 products, 4 sums, the quotient), at the y face Centered(2)'s one value of 2,
    # the upwind average 2 and the flux product 1 at each face, the divergence 5
    mixed_flops = (20 + 3) + (2 + 3) + 5
    bytes_ms, ops_ms = bounds_ms(ADV_BYTES_PER_POINT * points, mixed_flops * points)
    print(f"    runtime-scheme kernel {kernel_ms:.4f} ms/call, plain {plain_ms:.3f} ms/call, "
          f"bound {max(bytes_ms, ops_ms):.4f} ms")
    mixed_timing = (mixed_abs, mixed_rel, kernel_ms, plain_ms, bytes_ms, ops_ms)
    # array metrics on the basin's grid (its advection's shape; not on this slice's path)
    basin = basin_model(1152, 960, substeps=nsub)
    bg = basin.grid
    bstate = basin_state(basin)
    rng = np.random.default_rng(7)
    bu = torch.where(basin.masks.per_fc, 0.0, torch.as_tensor(
        0.1 * rng.standard_normal(bg.shape), dtype=torch.float32, device="cuda")).contiguous()
    bv = torch.where(basin.masks.per_cf, 0.0, torch.as_tensor(
        0.1 * rng.standard_normal(bg.shape), dtype=torch.float32, device="cuda")).contiguous()
    metrics = tuple(bg.scalar(getattr(bg, n)).expand(bg.shape).contiguous()
                    for n in ("dy_fc", "dx_cf", "az_cc"))
    bmasks = (basin.masks.per_fc.contiguous(), basin.masks.per_cf.contiguous())
    bh = bstate.h.contiguous()
    out = fixed_tile_advection.fixed_tile_div(bg, schemes, bu, bv, bh, bmasks, metrics)
    ref = fixed_tile_advection.fixed_tile_div_reference(bg, schemes, bu, bv, bh, bmasks,
                                                        metrics)
    torch.cuda.synchronize()
    check("basin", rel_diff(ref, out)[0], 1e-6)
    ulps, same = bits_record([ref], [out])
    print(f"  advection at {bg.nxp}×{bg.nyp} with array metrics: {ulps} ulp from the plain "
          f"version, raw bits {same}")
    if not same:
        raise AssertionError(f"2.9 with array metrics is {ulps} ulp from its plain version")
    basin_adv_ms = cuda_ms(lambda: fixed_tile_advection.fixed_tile_div(
        bg, schemes, bu, bv, bh, bmasks, metrics), 50)
    bpoints = bg.nxp * bg.nyp
    # the three metric arrays read; a second product at each face, and the
    # divergence (δx + δy)/Az one operation fewer than δx·(1/Δx) + δy·(1/Δy)
    bytes_ms, ops_ms = bounds_ms((ADV_BYTES_PER_POINT + 12) * bpoints,
                                 (ADV_FLOPS_PER_POINT + 1) * bpoints)
    print(f"    advection kernel {basin_adv_ms:.4f} ms/call, bound {max(bytes_ms, ops_ms):.4f} "
          f"ms")
    del basin, bstate, bu, bv, bh, metrics, out, ref

    # 2.11: the column thermodynamics, bare ice on the slice and snow on ice
    dt_t = grid.scalar(dt)
    out = fixed_tile_thermo.thermo_column(model, state, dt_t)
    ref = fixed_tile_thermo.thermo_column_reference(model, state, dt_t)
    torch.cuda.synchronize()
    thermo_rel = thermo_abs = 0.0
    for name, q in out.items():
        if not torch.isfinite(q).all():
            raise AssertionError(f"{name} from the thermodynamics kernel is not finite")
        rel, abs_err = rel_diff(ref[name].broadcast_to(grid.shape), q)
        check(name, rel, 1e-5)
        thermo_rel, thermo_abs = max(thermo_rel, rel), max(thermo_abs, abs_err)
    refs = [ref[n].broadcast_to(grid.shape) for n in out]
    ulps, same = bits_record(refs, out.values())
    bare_unit = fixed_tile_thermo.plan(model, state.clock).name
    print(f"  column, bare ice (unit {bare_unit}): {ulps} ulp from the plain version in every "
          f"output, raw bits {same}")
    if not same:
        raise AssertionError(f"2.11 (bare ice) is {ulps} ulp from its plain version")
    print_ptxas(bare_unit, gate=True)
    thermo_fn = lambda: fixed_tile_thermo.thermo_column(model, state, dt_t)   # noqa: E731
    kernel_ms = cuda_ms(thermo_fn, 50)
    plain_ms = cuda_ms(lambda: fixed_tile_thermo.thermo_column_reference(model, state, dt_t),
                       5)
    bytes_ms, ops_ms = bounds_ms(THERMO_ARRAYS * points * 4, THERMO_FLOPS_PER_POINT * points)
    print(f"    thermodynamics kernel {kernel_ms:.4f} ms/call ({host_us(thermo_fn):.1f} µs of "
          f"host time a call), plain {plain_ms:.3f} ms/call, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms")
    thermo_timing = (thermo_abs, thermo_rel, kernel_ms, plain_ms, bytes_ms, ops_ms)
    layered = bounded(cst, N, nsub, fixed_tiles=fixed, snow=True)
    lstate = cst.initial_state(layered, h=lambda x, y: 1.0 + 0.25 * torch.sin(x / (40 * KM)),
                               a=1.0, hs=0.1, time=150 * DAY)
    out = fixed_tile_thermo.thermo_column(layered, lstate, dt_t)
    ref = fixed_tile_thermo.thermo_column_reference(layered, lstate, dt_t)
    torch.cuda.synchronize()
    snow_unit = fixed_tile_thermo.plan(layered, lstate.clock).name
    print(f"  snow on ice, Semtner series + emission, snowfall 3.2e-6 (unit {snow_unit}):")
    for name, q in out.items():
        if not torch.isfinite(q).all():
            raise AssertionError(f"{name} (snow) from the thermodynamics kernel is not finite")
        check(name, rel_diff(ref[name].broadcast_to(grid.shape), q)[0], 1e-5)
    refs = [ref[n].broadcast_to(grid.shape) for n in out]
    ulps, same = bits_record(refs, out.values())
    print(f"    {ulps} ulp from the plain version in every output, raw bits {same}")
    if not same:
        raise AssertionError(f"2.11 (snow) is {ulps} ulp from its plain version")
    print_ptxas(snow_unit, gate=True)
    layered_fn = lambda: fixed_tile_thermo.thermo_column(layered, lstate, dt_t)   # noqa: E731
    layered_ms = cuda_ms(layered_fn, 50)
    print(f"    snow kernel {layered_ms:.4f} ms/call")
    del layered, lstate, out, ref, refs

    # --- 14. the fixed-tile slice's main path -------------------------------------------
    model = bounded(cst, N, nsub, fixed_tiles=fixed)
    state = flagship_state(cst, model)
    state = cst.step(model, state, dt)                  # warm-up
    torch.cuda.synchronize()
    counters = dict(tiled=tiled_counter, prep=prep_counter, adv=adv_counter,
                    adv_runtime=adv_runtime_counter, thermo=thermo_counter,
                    padded=padded_counter, periodic=counter, periodic_tiled=tiled_evp_counter,
                    curvilinear=curv_counter)
    for c in counters.values():
        c.reset()
    state, step_ms, host_ms = timed_steps(cst, model, state, dt, steps)
    sim = cst.Simulation(model, state, dt=dt, stop_iteration=int(state.clock.iteration) + 2)
    sim.run()
    state = sim.state
    torch.cuda.synchronize()
    n_steps = steps + 2
    calls = {k: c.calls for k, c in counters.items()}
    expected = dict(tiled=3 * n_steps, prep=3 * n_steps, adv=6 * n_steps, adv_runtime=0,
                    thermo=3 * n_steps, padded=0, periodic=0, periodic_tiled=0,
                    curvilinear=0)
    if calls != expected or tiled_counter.launches != 3 * n_steps * tiled_launches_per_call:
        raise AssertionError(f"fixed-tile route calls {calls}, tiled launches "
                             f"{tiled_counter.launches}; expected {expected} and "
                             f"{3 * n_steps * tiled_launches_per_call}")
    check_state(model, state)
    fixed_launches = {k: counters[k].launches for k in ("tiled", "prep", "adv", "thermo")}
    device_ms, syncs, table = profile_device_ms(cst, model, state, dt)
    print(f"[14] fixed-tile slice main path {N}² bounded + island + drag, fixed_tiles={fixed}: "
          f"{step_ms:.2f} ms/step (CUDA events; host {host_ms:.2f} ms/step), "
          f"{N * N / step_ms * 1e3:.4e} points/s; in {steps} steps + 2 Simulation iterations "
          f"calls {calls}, launches {fixed_launches}; one profiled step {device_ms:.3f} ms of "
          f"device time, busy {100 * device_ms / step_ms:.1f} % of a step, {syncs} host waits "
          f"on a device value, on {card}")
    print("\n".join(table.splitlines()[:14]))
    step_fn = lambda: cst.step(model, state, dt)   # noqa: E731
    line = f"    device operations a step: {device_profile(step_fn, 1)[2]:.0f}"
    if earlier:
        # the same step with the earlier tree's launcher inputs and coefficient kernel
        from climaseaice_jl_tpu_torch.dynamics import fused_evp_tiled_padded as ftp
        mine = ftp.padded_evp_inputs
        ftp.padded_evp_inputs = earlier["evp_prep"].padded_evp_inputs
        try:
            line += (f"; {device_profile(step_fn, 1)[2]:.0f} with the earlier tree's "
                     "coefficient launch and launcher inputs")
        finally:
            ftp.padded_evp_inputs = mine
    print(line)
    if earlier:
        print("    in turns with the earlier tree's coefficient launch and launcher inputs, "
              "ms/step (CUDA events): " + ", ".join(steps_in_turns_with_earlier(
                  cst, model, state, dt, steps, ftp, "padded_evp_inputs",
                  earlier["evp_prep"].padded_evp_inputs)))
    turns = []
    for name, m, s in (("fixed", model, state), ("bounded", bounded_model, bounded_state),
                       ("fixed", model, state), ("bounded", bounded_model, bounded_state)):
        _, turn_ms, _ = timed_steps(cst, m, s, dt, steps)
        turns.append(f"{name} {turn_ms:.2f}")
    print(f"    in turns with phase 7's slice, ms/step (CUDA events): {', '.join(turns)}")
    if args.profile:
        profiles.append(f"fixed-tile {N}² bounded step on {card}: {device_ms:.3f} ms of "
                        f"device time\n{table}\n")
        with open(args.profile, "w") as f:
            f.write("\n".join(profiles))
    # the same slice with a FluxFormAdvection of two schemes: the runtime-scheme kernel
    adv_mixed = cst.FluxFormAdvection(x=cst.UpwindBiased(order=5), y=cst.Centered(order=2))
    mixed_model = bounded(cst, N, nsub, fixed_tiles=fixed, advection=adv_mixed)
    mixed_state = flagship_state(cst, mixed_model)
    for c in (adv_counter, adv_runtime_counter):
        c.reset()
    for _ in range(2):
        mixed_state = cst.step(mixed_model, mixed_state, dt)
    torch.cuda.synchronize()
    check_state(mixed_model, mixed_state)
    mixed_launches = adv_runtime_counter.launches
    if mixed_launches != 12 or adv_counter.launches != 12:
        raise AssertionError(f"two steps with two advection schemes launched 2.9 "
                             f"{adv_counter.launches} times, its runtime-scheme kernel "
                             f"{mixed_launches}; expected 12 and 12")
    print(f"    with UpwindBiased(5) in x and Centered(2) in y: 2 steps, {mixed_launches} "
          f"launches of the runtime-scheme kernel, finite and physical")
    del model, state, sim, bounded_model, bounded_state, mixed_model, mixed_state

    # --- 15. halo 5 against halo 19 on the card -------------------------------------------
    names = ("u", "v", "h", "a", "sig11", "sig22", "sig12", "alpha")
    finals = []
    for halo in (5, 19):
        m = bounded(cst, N, nsub, fixed_tiles=fixed, halo=halo)
        s = flagship_state(cst, m)
        for _ in range(steps):
            s = cst.step(m, s, dt)
        finals.append({n: m.grid.interior(getattr(s, n)) for n in names})
    torch.cuda.synchronize()
    for name in names:
        if not torch.equal(finals[0][name], finals[1][name]):
            diff = (finals[0][name] - finals[1][name]).abs().max().item()
            raise AssertionError(f"{name}: halo 5 and halo 19 differ by {diff:.3e}")
    print(f"[15] halo 5 vs halo 19, {N}² fixed-tile slice, {steps} RK3 steps: u, v, h, ℵ, σ₁₁, "
          "σ₂₂, σ₁₂, α interiors bitwise equal")
    del finals

    # --- 16. card vs CPU, the fixed-tile route ---------------------------------------------
    finals = {}
    for device in ("cuda", "cpu"):
        m = bounded(cst, 128, nsub, P_star=27.5, device=device, fixed_tiles=fixed)
        s = flagship_state(cst, m, velocity_seed=8)
        for _ in range(2):
            s = cst.step(m, s, dt)
        if device == "cuda":
            check_state(m, s)
        finals[device] = state_to_numpy(s)
    print("[16] 128² bounded + island + drag, fixed tiles, soft ice, 2 RK3 steps, card "
          "(kernels) vs CPU (plain versions):")
    for name, bar in (("u", 1e-4), ("v", 1e-4), ("h", 1e-5), ("a", 1e-5), ("sig11", 4e-3),
                      ("sig22", 4e-3), ("sig12", 4e-3), ("alpha", 4e-3)):
        rel, _ = rel_diff(torch.as_tensor(finals["cpu"][name]),
                          torch.as_tensor(finals["cuda"][name]))
        check(name, rel, bar)

    # --- 17. the tripolar fixed-tile kernels vs their plain versions ---------------------------
    from climaseaice_jl_tpu_torch import distributed_basin
    from climaseaice_jl_tpu_torch.dynamics import fixed_tile_pointwise as fpw
    from climaseaice_jl_tpu_torch.dynamics import fused_evp_tiled_curvilinear as ftc
    tc_counter = ftc.tiled_curvilinear_evp_counter
    strength_counter = ftc.ice_strength_counter
    pw_counter = fpw.fixed_tile_pointwise_counter
    tsub, dt = 24, 600.0
    model, state = fixed_basin(1152, 960, soft=True, seed=9, snow=0.1)
    plan = ftc._fixed_plan(model.grid, tsub, fixed, widen_fold=True)
    params, planes, carry, wgrid, flags = ftc.tiled_curvilinear_inputs(
        model, state, dt, state.u, state.v, Hw=2 * plan[0] + 5)
    WI = wgrid.interior
    points = wgrid.nxp * wgrid.nyp
    print(f"[17] tripolar fixed-tile kernels vs plain versions, basin {model.grid.Nx}×"
          f"{model.grid.Ny} widened to {wgrid.nxp}×{wgrid.nyp} (plan K, TX, TY, Wx, Wy = "
          f"{plan}), soft ice, {tsub} substeps, on {card}:")
    tc_counter.reset()
    settled = torch.empty(-(-wgrid.nxp // ftc.BLOCK[0]) * -(-wgrid.nyp // ftc.BLOCK[1]),
                          dtype=torch.int32, device="cuda")
    out = ftc.tiled_curvilinear_evp_substeps(params, planes, [q.clone() for q in carry], tsub,
                                             wgrid, plan, flags, settled=settled)
    tc_launches_per_call = tc_counter.launches
    tc_settled = settled_record(settled, ftc.tiled_settled_blocks_reference(
        params, planes, wgrid, plan, flags))
    if tc_launches_per_call != tc_launches(tsub, plan[0], True):
        raise AssertionError(f"2.7 made {tc_launches_per_call} launches a call, expected "
                             f"{tc_launches(tsub, plan[0], True)}")
    chunked = [ftc.tiled_curvilinear_evp_substeps(params, planes, [q.clone() for q in carry],
                                                  tsub, wgrid, plan, flags, chunk=c)
               for c in (4, 2)]
    ref = ftc.tiled_curvilinear_evp_substeps_reference(params, planes, carry, tsub, wgrid,
                                                       plan, flags)
    p18, c_consts, c_planes = ftc.curvilinear_consts(params, planes, wgrid, plan, flags)
    whole = fused_evp_curvilinear.curvilinear_evp_substeps(p18, c_consts,
                                                           [q.clone() for q in carry], tsub,
                                                           wgrid, c_planes)
    torch.cuda.synchronize()
    print(f"  pinned curvilinear EVP ({tc_launches_per_call} launches a call), interiors:")
    worst_rel = worst_abs = 0.0
    for name, r, o, bar in zip(names[:2] + names[4:], ref, out,
                               (1e-4, 1e-4, 4e-3, 4e-3, 4e-3, 4e-3)):
        if not torch.isfinite(WI(o)).all():
            raise AssertionError(f"{name} from the pinned curvilinear kernel is not finite")
        rel, abs_err = rel_diff(WI(r), WI(o))
        check(name, rel, bar)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)
    tc_ulp = max(max_ulp(WI(r), WI(o)) for r, o in zip(ref, out))
    same_chunks = all(torch.equal(WI(x), WI(o)) for c in chunked for x, o in zip(c, out))
    same_whole = all(torch.equal(WI(w), WI(o)) for w, o in zip(whole, out))
    print(f"    bitwise: plain version {tc_ulp == 0} (largest distance {tc_ulp} ulp over the "
          f"interiors; the parent design was bitwise), chunks of 12, 4 and 2 {same_chunks}, "
          f"whole-array kernel on the same coefficients {same_whole}; settled blocks "
          f"{tc_settled[0]:.4f} ({tc_settled[1]} of {tc_settled[2]}), the kernel's flags equal "
          f"their plain version's")
    if tc_ulp or not all(same_bits(WI(r), WI(o)) for r, o in zip(ref, out)):
        raise AssertionError(f"2.7 is not its plain version's bits over the interiors ({tc_ulp} "
                             f"ulp); it must be bitwise, signed zeros included")
    # The fold halo evolves exactly only where the arithmetic is exactly
    # mirror-antisymmetric; the reference's own contract is bitwise equality
    # at one chunk length (`pallas_evp_tiled_curvilinear.py:89-93`), which
    # phase 19 holds.  Other chunk lengths and the whole-array kernel are
    # held within 1e-5, with where they part.
    ref4 = ftc.tiled_curvilinear_evp_substeps_reference(params, planes, carry, tsub, wgrid,
                                                        plan, flags, chunk=4)
    for label, other, base in (("chunks of 4", chunked[0], out), ("chunks of 2", chunked[1], out),
                               ("2.6", whole, out), ("plain, chunks of 4", ref4, ref)):
        for name, w, o in zip(names[:2] + names[4:], other, base):
            d = (WI(w).double() - WI(o).double()).abs()
            if d.max() > 0:
                i, j = divmod(int(d.argmax()), d.shape[1])
                print(f"    {label}: {name} max rel diff {rel_diff(WI(o), WI(w))[0]:.3e} at "
                      f"interior ({i}, {j}), {wgrid.Ny - 1 - j} rows below the seam")
            check(f"{name}/{label}", rel_diff(WI(o), WI(w))[0], 1e-5)
    work = [q.clone() for q in carry]
    work_whole = [q.clone() for q in carry]
    kernel_ms = cuda_ms(lambda: ftc.tiled_curvilinear_evp_substeps(
        params, planes, work, tsub, wgrid, plan, flags), 20)
    plain_ms = cuda_ms(lambda: ftc.tiled_curvilinear_evp_substeps_reference(
        params, planes, carry, tsub, wgrid, plan, flags), 2)
    bytes_ms, ops_ms = bounds_ms(
        ((TC_ARRAYS_READ + EVP_ARRAYS_WRITTEN) * points + ftc.N_PARAMS) * 4,
        (CURV_FLOPS_PER_POINT_SUBSTEP * tsub + TC_FLOPS_PER_POINT_CALL) * points)
    turns = {"pinned": lambda: ftc.tiled_curvilinear_evp_substeps(
                 params, planes, work, tsub, wgrid, plan, flags),
             "whole-array": lambda: fused_evp_curvilinear.curvilinear_evp_substeps(
                 p18, c_consts, work_whole, tsub, wgrid, c_planes)}
    route_times = in_turns(turns, 20)
    print(f"    kernel {kernel_ms:.4f} ms/call, plain {plain_ms:.3f} ms/call, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms; in turns, ms per call (20 calls, forwards then "
          f"backwards): "
          + "; ".join(f"{k} {', '.join(f'{t:.4f}' for t in v)}" for k, v in route_times.items())
          + f"; the whole-array kernel (2.6) over the pinned (2.7): at most "
          f"{max(route_times['whole-array']) / min(route_times['pinned']):.4f}, with "
          f"{fused_evp_curvilinear.settled_share(c_consts, wgrid):.4f} of its blocks settled")
    tc_timing = (worst_abs, worst_rel, kernel_ms, plain_ms, bytes_ms, ops_ms)
    tc_shape = (f"{wgrid.nxp}x{wgrid.nyp} widened (1152x960 tripolar basin, land, fold, "
                f"drag), {tsub} substeps")
    del out, chunked, ref, ref4, whole, work, work_whole, c_consts, turns

    # 2.8: the ice strength on the widened h, ℵ
    prm = ftc.ice_strength_params(model)
    hw, aw = planes[ftc.C_H], planes[ftc.C_A]
    out = ftc.fixed_tile_P(prm, hw, aw)
    ref = ftc.fixed_tile_P_reference(prm, hw, aw)
    torch.cuda.synchronize()
    ulps = max_ulp(ref, out)
    print(f"  ice strength: at most {ulps} ulp apart (bar 2), bitwise {torch.equal(ref, out)}")
    if ulps > 2:
        raise AssertionError(f"the ice-strength kernel is {ulps} ulp from its plain version")
    kernel_ms = cuda_ms(lambda: ftc.fixed_tile_P(prm, hw, aw), 50)
    strength_dev_us = device_profile(lambda: ftc.fixed_tile_P(prm, hw, aw), 20,
                                     "ice_strength")[0]
    plain_ms = cuda_ms(lambda: ftc.fixed_tile_P_reference(prm, hw, aw), 20)
    bytes_ms, ops_ms = bounds_ms((STRENGTH_ARRAYS * points + 2) * 4,
                                 STRENGTH_FLOPS_PER_POINT * points)
    print(f"    kernel {kernel_ms:.4f} ms a call by CUDA events, "
          f"{device_ms_text(strength_dev_us)} of device time a launch (torch.profiler), plain {plain_ms:.4f} ms/call, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms")
    strength_timing = (*rel_diff(ref, out)[::-1], kernel_ms, plain_ms, bytes_ms, ops_ms)
    del planes, carry

    # 2.10: both wind components on the basin's coordinates, through their units
    g = model.grid
    gpoints = g.nxp * g.nyp
    lon, lat = g.lon_cc.contiguous(), g.lat_cc.contiguous()
    t = state.clock.time
    # the units are held to no spill and, where they call sinf or cosf, to
    # the stack frame of a unit of sin(x)·cos(x) alone
    trig_frame = ptxas_stack(trig_unit().name)
    print("  a unit of sin(x)·cos(x) alone: "
          + ("not built in this run (no ptxas report)" if trig_frame is None else
             f"{trig_frame}-byte stack frame (CUDA's sinf and cosf, the argument reduction of "
             "|x| > 105615)"))
    for comp, fn in enumerate(distributed_basin.WINDS):
        out = fpw.fixed_tile_pointwise(fn, fixed, (lon, lat), scalars=(t,))
        ref = fpw.fixed_tile_pointwise_reference(fn, (lon, lat), (t,))
        wplan = fpw.plan(fn, 2, 1, lon.device, g.shape)
        torch.cuda.synchronize()
        ulps = max_ulp(ref, out)
        print(f"  wind {'xy'[comp]} (unit {wplan.name}, {len(wplan.k)} constants): at most "
              f"{ulps} ulp apart (bar 2), bitwise {torch.equal(ref, out)}, raw bits "
              f"{same_bits(ref, out)}")
        if ulps > 2:
            raise AssertionError(f"the pointwise kernel is {ulps} ulp from its plain version")
        trig = any(op in (fpw.OP_SIN, fpw.OP_COS) for op, _, _ in wplan.ops)
        print_ptxas(wplan.name, gate=True, max_stack=(trig_frame or 0) if trig else 0)
        if earlier:
            old_pw = earlier["pointwise_fixed"]
            against_earlier(f"2.10, wind {'xy'[comp]}", [out], [old_pw.fixed_tile_pointwise(
                fn, fixed, (lon, lat), scalars=(t,))], [ref], False, card)
        if comp == 0:
            wind_err = rel_diff(ref, out)[::-1]
    wind_fn = distributed_basin.WINDS[0]
    wplan = fpw.plan(wind_fn, 2, 1, lon.device, g.shape)
    wind_call = lambda: fpw.fixed_tile_pointwise(   # noqa: E731
        wind_fn, fixed, (lon, lat), scalars=(t,))
    if earlier:
        print_ptxas("earlier pointwise_fixed")
        old_call = lambda: old_pw.fixed_tile_pointwise(   # noqa: E731
            wind_fn, fixed, (lon, lat), scalars=(t,))
        print_turns("CUDA-event ms a call", in_turns({"2.10": wind_call,
                                                      "earlier 2.10": old_call}, 20), "ms",
                    card)
        print_turns("device µs a launch (torch.profiler)", device_in_turns(
            {"2.10": wind_call, "earlier 2.10": old_call}, "pointwise"), "µs", card)
        print(f"      host µs a call: 2.10 {host_us(wind_call):.1f}, earlier 2.10 "
              f"{host_us(old_call):.1f}")
    kernel_ms = cuda_ms(wind_call, 50)
    wind_dev_us = device_profile(wind_call, 20, "pointwise_unit")[0]
    plain_ms = cuda_ms(lambda: fpw.fixed_tile_pointwise_reference(wind_fn, (lon, lat), (t,)),
                       20)
    flops = program_flops(wplan.ops)
    bytes_ms, ops_ms = bounds_ms(POINTWISE_ARRAYS * gpoints * 4 + 4, flops * gpoints)
    print(f"    kernel {kernel_ms:.4f} ms a call by CUDA events ({host_us(wind_call):.1f} µs "
          f"of host time a call), {device_ms_text(wind_dev_us)} of device time a launch "
          f"(torch.profiler; {len(wplan.ops)} program steps, {flops} operations a point), "
          f"plain {plain_ms:.4f} ms/call, bound {max(bytes_ms, ops_ms):.4f} ms "
          f"({'bytes' if bytes_ms > ops_ms else 'operations'})")
    wind_timing = (*wind_err, kernel_ms, plain_ms, bytes_ms, ops_ms)
    wind_unit = wplan.name

    # 2.11 with the solar FluxFunction: the snow column under the basin's fluxes
    dt_t = g.scalar(dt)
    out = fixed_tile_thermo.thermo_column(model, state, dt_t)
    ref = fixed_tile_thermo.thermo_column_reference(model, state, dt_t)
    torch.cuda.synchronize()
    print("  snow column physics with the solar FluxFunction, Semtner series + emission:")
    flux_rel = flux_abs = 0.0
    for name, q in out.items():
        if not torch.isfinite(q).all():
            raise AssertionError(f"{name} (FluxFunction) from the column kernel is not finite")
        rel, abs_err = rel_diff(ref[name].broadcast_to(g.shape), q)
        check(name, rel, 1e-5)
        flux_rel, flux_abs = max(flux_rel, rel), max(flux_abs, abs_err)
    refs = [ref[n].broadcast_to(g.shape) for n in out]
    ulps, same = bits_record(refs, out.values())
    basin_unit = fixed_tile_thermo.plan(model, state.clock).name
    print(f"    unit {basin_unit}: {ulps} ulp from the plain version in every output, raw bits "
          f"{same}")
    if not same:
        raise AssertionError(f"2.11 (solar FluxFunction) is {ulps} ulp from its plain version")
    print_ptxas(basin_unit, gate=True)
    flux_fn = lambda: fixed_tile_thermo.thermo_column(model, state, dt_t)   # noqa: E731
    solar = fixed_tile_thermo.flux_recording(model.top_heat_flux[0], g,
                                             fixed_tile_thermo._present(model))
    F = program_flops(solar.ops) + 5 + 3       # the sums and emission
    kernel_ms = cuda_ms(flux_fn, 50)
    plain_ms = cuda_ms(lambda: fixed_tile_thermo.thermo_column_reference(model, state, dt_t),
                       5)
    bytes_ms, ops_ms = bounds_ms(LAYERED_THERMO_ARRAYS * gpoints * 4,
                                 layered_thermo_flops(F) * gpoints)
    print(f"    kernel {kernel_ms:.4f} ms/call ({host_us(flux_fn):.1f} µs of host time a call), "
          f"plain {plain_ms:.3f} ms/call, bound {max(bytes_ms, ops_ms):.4f} ms "
          f"({layered_thermo_flops(F)} operations a point)")
    flux_timing = (flux_abs, flux_rel, kernel_ms, plain_ms, bytes_ms, ops_ms)
    del model, state, out, ref, refs

    # --- 18. the tripolar fixed-tile basin: the slice's main path ----------------------------
    model, state = distributed_basin.build(1152, 960, fixed_tiles=fixed)
    grid = model.grid
    state = cst.step(model, state, dt)                  # warm-up
    torch.cuda.synchronize()
    counters = dict(tiled_curvilinear=tc_counter, strength=strength_counter, wind=pw_counter,
                    adv=adv_counter, thermo=thermo_counter, curvilinear=curv_counter,
                    tiled_padded=tiled_counter, padded=padded_counter, periodic=counter,
                    periodic_tiled=tiled_evp_counter, prep=prep_counter)
    for c in counters.values():
        c.reset()
    state, step_ms, host_ms = timed_steps(cst, model, state, dt, steps)
    sim = cst.Simulation(model, state, dt=dt, stop_iteration=int(state.clock.iteration) + 2)
    sim.run()
    state = sim.state
    torch.cuda.synchronize()
    n_steps = steps + 2
    calls = {k: c.calls for k, c in counters.items()}
    expected = dict(tiled_curvilinear=n_steps, strength=n_steps, wind=2 * n_steps,
                    adv=3 * n_steps, thermo=n_steps, curvilinear=0, tiled_padded=0, padded=0,
                    periodic=0, periodic_tiled=0, prep=0)
    if calls != expected or tc_counter.launches != n_steps * tc_launches_per_call:
        raise AssertionError(f"tripolar fixed-tile route calls {calls}, pinned EVP launches "
                             f"{tc_counter.launches}; expected {expected} and "
                             f"{n_steps * tc_launches_per_call}")
    check_basin_state(model, state)
    basin_launches = {k: counters[k].launches
                      for k in ("tiled_curvilinear", "strength", "wind", "adv", "thermo")}
    device_ms, syncs, table = profile_device_ms(cst, model, state, dt)
    basin_points = grid.Nx * grid.Ny
    print(f"[18] slice main path, tripolar fixed-tile basin {grid.Nx}×{grid.Ny}, "
          f"fixed_tiles={fixed}, dt {dt:g} s: {step_ms:.2f} ms/step (CUDA events; host "
          f"{host_ms:.2f} ms/step), {basin_points / step_ms * 1e3:.4e} points/s; in {steps} "
          f"steps + 2 Simulation iterations calls {calls}, launches {basin_launches}; one "
          f"profiled step {device_ms:.3f} ms of device time, busy "
          f"{100 * device_ms / step_ms:.1f} % of a step, {syncs} host waits on a device "
          f"value, on {card}")
    print("\n".join(table.splitlines()[:16]))
    print(f"    device operations a step: "
          f"{device_profile(lambda: cst.step(model, state, dt), 1)[2]:.0f}")
    if earlier:
        print("    in turns with the earlier tree's winds (its interpreter kernel), ms/step "
              "(CUDA events): " + ", ".join(steps_in_turns_with_earlier(
                  cst, model, state, dt, steps, distributed_basin, "fixed_tile_pointwise",
                  earlier["pointwise_fixed"].fixed_tile_pointwise)))
    eager, eager_state = distributed_basin.build(1152, 960)
    eager_state = cst.step(eager, eager_state, dt)      # warm-up
    turns = []
    for name, m, s in (("fixed", model, state), ("eager", eager, eager_state),
                       ("fixed", model, state), ("eager", eager, eager_state)):
        _, turn_ms, _ = timed_steps(cst, m, s, dt, steps)
        turns.append(f"{name} {turn_ms:.2f}")
    print(f"    in turns with the build without fixed_tiles (whole-array EVP, eager winds and "
          f"column physics), ms/step (CUDA events): {', '.join(turns)}")
    if args.profile:
        profiles.append(f"tripolar fixed-tile basin step on {card}: {device_ms:.3f} ms of "
                        f"device time\n{table}\n")
        with open(args.profile, "w") as f:
            f.write("\n".join(profiles))
    del model, state, sim, eager, eager_state

    # --- 19. halo 5 against halo 19 on the card, the basin ------------------------------------
    basin_names = ("u", "v", "h", "a", "hs", "sig11", "sig22", "sig12", "alpha")
    finals = []
    for halo in (5, 19):
        m, s = fixed_basin(360, 300, halo=halo)
        for _ in range(3):
            s = cst.step(m, s, dt)
        finals.append({n: m.grid.interior(getattr(s, n)) for n in basin_names})
    torch.cuda.synchronize()
    for name in basin_names:
        if not torch.equal(finals[0][name], finals[1][name]):
            diff = (finals[0][name] - finals[1][name]).abs().max().item()
            raise AssertionError(f"{name}: halo 5 and halo 19 differ by {diff:.3e}")
    print("[19] halo 5 vs halo 19, 360×300 tripolar fixed-tile basin, 3 steps: u, v, h, ℵ, hs, "
          "σ₁₁, σ₂₂, σ₁₂, α interiors bitwise equal")
    del finals

    # --- 20. card vs CPU, the tripolar fixed-tile route -------------------------------------
    finals = {}
    for device in ("cuda", "cpu"):
        m, s = fixed_basin(32, 64, device=device, soft=True, seed=8, snow=0.1)
        for _ in range(2):
            s = cst.step(m, s, dt)
        if device == "cuda":
            check_basin_state(m, s)
        finals[device] = state_to_numpy(s)
    print("[20] 32×64 tripolar fixed-tile basin, soft ice, 10 cm of snow, 2 steps, card "
          "(kernels) vs CPU (plain versions):")
    for name, bar in (("u", 1e-4), ("v", 1e-4), ("h", 1e-5), ("a", 1e-5), ("hs", 1e-5),
                      ("sig11", 4e-3), ("sig22", 4e-3), ("sig12", 4e-3), ("alpha", 4e-3)):
        rel, _ = rel_diff(torch.as_tensor(finals["cpu"][name]),
                          torch.as_tensor(finals["cuda"][name]))
        check(name, rel, bar)

    # --- 21. the tiled EVP kernel (2.2) vs its plain version ------------------------------
    N2, dt = 2048, 120.0
    names = ("u", "v", "sig11", "sig22", "sig12", "alpha")
    bars = (1e-4, 1e-4, 4e-3, 4e-3, 4e-3, 4e-3)
    model = flagship(cst, N2, nsub, P_star=27.5)
    state = flagship_state(cst, model, velocity_seed=9)
    params, inputs, carry, _ = fused_evp_tiled.tiled_evp_inputs(model, state, dt, state.u,
                                                                state.v)
    tiled_evp_counter.reset()
    out = fused_evp_tiled.tiled_evp_substeps(params, *inputs, [q.clone() for q in carry], nsub)
    t22_launches_per_call = tiled_evp_counter.launches
    ref = fused_evp_tiled.tiled_evp_substeps_reference(params, *inputs, carry, nsub)
    torch.cuda.synchronize()
    print(f"[21] tiled EVP kernel (2.2) vs plain version, {N2}² soft ice, seeded velocities, "
          f"{nsub} substeps ({t22_launches_per_call} launches):")
    worst_rel = worst_abs = 0.0
    for name, r, o, bar in zip(names, ref, out, bars):
        if not torch.isfinite(o).all():
            raise AssertionError(f"{name} from the tiled EVP kernel is not finite")
        rel, abs_err = rel_diff(r, o)
        check(name, rel, bar)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)
    t22_bitwise = all(torch.equal(r, o) for r, o in zip(ref, out))
    t22_ulp = max(max_ulp(r, o) for r, o in zip(ref, out))
    print(f"    bitwise: {t22_bitwise}; largest difference {t22_ulp} ulp")
    if not t22_bitwise or t22_ulp:
        raise AssertionError(f"2.2 is {t22_ulp} ulp from its plain version; it must be bitwise")
    print(f"    {fused_evp_tiled.chunk_substeps()} substeps a launch, "
          f"{fused_evp_tiled.describe()}")
    work = [q.clone() for q in carry]
    kernel_ms = cuda_ms(lambda: fused_evp_tiled.tiled_evp_substeps(params, *inputs, work, nsub),
                        10)
    plain_ms = cuda_ms(lambda: fused_evp_tiled.tiled_evp_substeps_reference(
        params, *inputs, carry, nsub), 2)
    points = N2 * N2
    bytes_ms, ops_ms = bounds_ms(
        ((TILED_ARRAYS_READ + EVP_ARRAYS_WRITTEN) * points + EVP_PARAMS) * 4,
        (FLOPS_PER_POINT_SUBSTEP * nsub + TILED_FLOPS_PER_POINT_CALL) * points)
    print(f"    kernel {kernel_ms:.4f} ms/call, plain {plain_ms:.3f} ms/call, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms (operations {ops_ms:.4f}, bytes {bytes_ms:.4f}) on "
          f"{card}")
    t22_timing = (worst_abs, worst_rel, kernel_ms, plain_ms, bytes_ms, ops_ms)
    # 2.1 on the same grid, fed its own inputs: a record of how far the two
    # functions lie apart, and their times in turns
    r_params, r_consts, r_carry, _ = fused_evp.evp_inputs(model, state, dt, state.u, state.v)
    rich = fused_evp.evp_substeps(r_params, r_consts, [q.clone() for q in r_carry], nsub)
    torch.cuda.synchronize()
    apart = ", ".join(f"{name} {rel_diff(o, r)[0]:.3e}" for name, o, r in zip(names, out, rich))
    print(f"    2.1 against 2.2, relative to 2.2's largest value: {apart}")
    r_work = [q.clone() for q in r_carry]
    turns, turn_times = [], {}
    for name in ("2.2", "2.1", "2.2", "2.1"):
        if name == "2.2":
            turn_ms = cuda_ms(lambda: fused_evp_tiled.tiled_evp_substeps(params, *inputs, work,
                                                                         nsub), 10)
        else:
            turn_ms = cuda_ms(lambda: fused_evp.evp_substeps(r_params, r_consts, r_work, nsub),
                              10)
        turns.append(f"{name} {turn_ms:.4f}")
        turn_times.setdefault(name, []).append(turn_ms)
    print(f"    in turns, ms per call (CUDA events, 10 calls): {', '.join(turns)}, on {card}")
    t22_ratio = max(turn_times["2.2"]) / min(turn_times["2.1"])
    print(f"    2.2 over 2.1 in turns: at most {t22_ratio:.4f}")
    if not t22_ratio < 1.0:
        raise AssertionError(f"2.2 is not faster than 2.1 in turns ({t22_ratio:.4f})")
    del model, state, params, inputs, carry, out, ref, work, r_consts, r_carry, rich, r_work

    # --- 22. the periodic flagship above the whole-array limit: the slice's main path ------
    model = flagship(cst, N2, nsub)
    state = flagship_state(cst, model)
    state = cst.step(model, state, dt)                  # warm-up
    torch.cuda.synchronize()
    counters = dict(periodic_tiled=tiled_evp_counter, periodic=counter, padded=padded_counter,
                    curvilinear=curv_counter, tiled_padded=tiled_counter,
                    tiled_curvilinear=tc_counter)
    for c in counters.values():
        c.reset()
    state, step_ms, host_ms = timed_steps(cst, model, state, dt, steps)
    sim = cst.Simulation(model, state, dt=dt, stop_iteration=int(state.clock.iteration) + 2)
    sim.run()
    state = sim.state
    torch.cuda.synchronize()
    n_steps = steps + 2
    calls = {k: c.calls for k, c in counters.items()}
    t22_main_launches = tiled_evp_counter.launches
    expected = dict.fromkeys(counters, 0)
    expected["periodic_tiled"] = 3 * n_steps
    if t22_launches_per_call != -(-nsub // t22_chunk):
        raise AssertionError(f"2.2 made {t22_launches_per_call} launches a call, its plan "
                             f"{-(-nsub // t22_chunk)}")
    if calls != expected or t22_main_launches != 3 * n_steps * t22_launches_per_call:
        raise AssertionError(f"{N2}² flagship EVP calls {calls}, 2.2 launches "
                             f"{t22_main_launches}; expected {expected} and "
                             f"{3 * n_steps * t22_launches_per_call}")
    check_state(model, state)
    device_ms, syncs, table = profile_device_ms(cst, model, state, dt)
    print(f"[22] slice main path {N2}² flagship: {step_ms:.2f} ms/step (CUDA events; host "
          f"{host_ms:.2f} ms/step), {points / step_ms * 1e3:.4e} points/s; 2.2 "
          f"{calls['periodic_tiled']} calls / {t22_main_launches} launches in {steps} steps + 2 "
          f"Simulation iterations, no other EVP kernel; one profiled step {device_ms:.3f} ms "
          f"of device time, busy {100 * device_ms / step_ms:.1f} % of a step, {syncs} host "
          f"waits on a device value, on {card}")
    print("\n".join(table.splitlines()[:16]))
    if args.profile:
        profiles.append(f"{N2}² flagship step on {card}: {device_ms:.3f} ms of device time\n"
                        f"{table}\n")
        with open(args.profile, "w") as f:
            f.write("\n".join(profiles))
    del model, state, sim

    # --- 23. card vs CPU above the whole-array limit -----------------------------------------
    finals = {}
    for device in ("cuda", "cpu"):
        m = flagship(cst, 768, 12, P_star=27.5, device=device)
        s = flagship_state(cst, m, velocity_seed=10)
        tiled_evp_counter.reset()
        for _ in range(2):
            s = cst.step(m, s, dt)
        if device == "cuda":
            if tiled_evp_counter.calls != 6:
                raise AssertionError(f"768² card run: {tiled_evp_counter.calls} calls of 2.2, "
                                     "expected 6")
            check_state(m, s)
        finals[device] = state_to_numpy(s)
    print("[23] 768² soft ice, 12 substeps, 2 RK3 steps, card (2.2) vs CPU (its plain "
          "version):")
    for name, bar in (("u", 1e-4), ("v", 1e-4), ("h", 1e-5), ("a", 1e-5), ("sig11", 4e-3),
                      ("sig22", 4e-3), ("sig12", 4e-3), ("alpha", 4e-3)):
        rel, _ = rel_diff(torch.as_tensor(finals["cpu"][name]),
                          torch.as_tensor(finals["cuda"][name]))
        check(name, rel, bar)

    # --- 24. kernels 2.7 and 2.9 on one shard of the distributed basin ------------------------
    from climaseaice_jl_tpu_torch.parallel import launch, strip_halos
    from climaseaice_jl_tpu_torch.parallel.stepper import ProcessMesh, _local_grid
    tsub, dt, mesh_shape, shard = 24, 600.0, (2, 2), (1, 1)
    names = ("u", "v", "sig11", "sig22", "sig12", "alpha")
    Hm = 2 * tsub + 3                     # the wide halo of the distributed step
    model, state = fixed_basin(1152, 960, soft=True, seed=9, snow=0.1, halo=Hm)
    g = model.grid
    nx, ny = g.Nx // mesh_shape[0], g.Ny // mesh_shape[1]
    lgrid = _local_grid(g, nx, ny, *shard, ("x", "y"), mesh_shape,
                        ProcessMesh(mesh_shape, shard, g.device, transport=False))
    LI = lgrid.interior
    params, planes, carry, _, flags = ftc.tiled_curvilinear_inputs(model, state, dt, state.u,
                                                                    state.v)
    planes = tuple(shard_of(q, shard, nx, ny, Hm) for q in planes)
    carry = tuple(shard_of(q, shard, nx, ny, Hm) for q in carry)
    plan = ftc._fixed_plan(lgrid, tsub, fixed)
    geo = ftc._geometry(lgrid)
    tc_counter.reset()
    settled = torch.empty(-(-lgrid.nxp // ftc.BLOCK[0]) * -(-lgrid.nyp // ftc.BLOCK[1]),
                          dtype=torch.int32, device="cuda")
    out = ftc.tiled_curvilinear_evp_substeps(params, planes, [q.clone() for q in carry], tsub,
                                             lgrid, plan, flags, settled=settled)
    mesh_launches_per_call = tc_counter.launches
    tcm_settled = settled_record(settled, ftc.tiled_settled_blocks_reference(
        params, planes, lgrid, plan, flags))
    ref = ftc.tiled_curvilinear_evp_substeps_reference(params, planes, carry, tsub, lgrid,
                                                       plan, flags)
    torch.cuda.synchronize()
    print(f"[24] kernels 2.7 and 2.9 on shard {shard} of a {mesh_shape} mesh of the basin "
          f"{g.Nx}×{g.Ny} ({lgrid.nxp}×{lgrid.nyp} padded, halos {Hm}; wrap {geo.wrap}, wall "
          f"gates {geo.gates}, fold refilled {geo.refill}), soft ice, {tsub} substeps, on {card}:")
    if mesh_launches_per_call != tc_launches(tsub, plan[0], False):
        raise AssertionError(f"2.7 on the shard launched {mesh_launches_per_call} times, "
                             f"expected {tc_launches(tsub, plan[0], False)} (no refill of the "
                             f"fold split across x)")
    worst_rel = worst_abs = 0.0
    for name, r, o, bar in zip(names, ref, out, (1e-4, 1e-4, 4e-3, 4e-3, 4e-3, 4e-3)):
        if not torch.isfinite(LI(o)).all():
            raise AssertionError(f"{name} from 2.7 on the shard is not finite")
        rel, abs_err = rel_diff(LI(r), LI(o))
        check(name, rel, bar)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)
    if not all(same_bits(LI(r), LI(o)) for r, o in zip(ref, out)):
        raise AssertionError("2.7 on the shard is not its plain version's bits")
    print(f"  2.7: interiors bitwise equal to the plain version; {mesh_launches_per_call} "
          f"launches a call (no refill); settled blocks {tcm_settled[0]:.4f} ({tcm_settled[1]} "
          f"of {tcm_settled[2]}), the kernel's flags equal their plain version's")
    points = lgrid.nxp * lgrid.nyp
    work = [q.clone() for q in carry]
    kernel_ms = cuda_ms(lambda: ftc.tiled_curvilinear_evp_substeps(
        params, planes, work, tsub, lgrid, plan, flags), 20)
    plain_ms = cuda_ms(lambda: ftc.tiled_curvilinear_evp_substeps_reference(
        params, planes, carry, tsub, lgrid, plan, flags), 2)
    bytes_ms, ops_ms = bounds_ms(
        ((TC_ARRAYS_READ + EVP_ARRAYS_WRITTEN) * points + ftc.N_PARAMS) * 4,
        (CURV_FLOPS_PER_POINT_SUBSTEP * tsub + TC_FLOPS_PER_POINT_CALL) * points)
    print(f"    kernel {kernel_ms:.4f} ms/call, plain {plain_ms:.3f} ms/call, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms ({'bytes' if bytes_ms > ops_ms else 'operations'})")
    tcm_timing = (worst_abs, worst_rel, kernel_ms, plain_ms, bytes_ms, ops_ms)
    tcm_shape = (f"{lgrid.nxp}x{lgrid.nyp} shard {shard} of a 2x2 mesh of the 1152x960 basin, "
                 f"halos {Hm}, {tsub} substeps")
    del out, ref, work, planes, carry
    schemes = (model.advection, model.advection)
    u, v, h = (shard_of(q, shard, nx, ny, Hm) for q in (state.u, state.v, state.h))
    masks = tuple(shard_of(m, shard, nx, ny, Hm) for m in (model.masks.per_fc,
                                                          model.masks.per_cf))
    metrics = tuple(lgrid.scalar(getattr(lgrid, n)).expand(lgrid.shape).contiguous()
                    for n in ("dy_fc", "dx_cf", "az_cc"))
    out = fixed_tile_advection.fixed_tile_div(lgrid, schemes, u, v, h, masks, metrics)
    ref = fixed_tile_advection.fixed_tile_div_reference(lgrid, schemes, u, v, h, masks, metrics)
    torch.cuda.synchronize()
    if not same_bits(ref, out):
        raise AssertionError(f"2.9 on the shard is {max_ulp(ref, out)} ulp from its plain "
                             "version over the padded arrays, or differs in a signed zero")
    kernel_ms = cuda_ms(lambda: fixed_tile_advection.fixed_tile_div(lgrid, schemes, u, v, h,
                                                                     masks, metrics), 50)
    plain_ms = cuda_ms(lambda: fixed_tile_advection.fixed_tile_div_reference(
        lgrid, schemes, u, v, h, masks, metrics), 5)
    bytes_ms, ops_ms = bounds_ms(ADV_BYTES_PER_POINT * points, ADV_FLOPS_PER_POINT * points)
    print(f"  2.9 (WENO-7, x split: no wrap): the plain version's raw bits over the "
          f"padded arrays; kernel {kernel_ms:.4f} ms/call, plain {plain_ms:.3f} ms/call, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms")
    advm_timing = (0.0, 0.0, kernel_ms, plain_ms, bytes_ms, ops_ms)
    # 2.10 on every shard's coordinates, as each rank of the distributed step runs it
    worst = 0
    for sx in range(mesh_shape[0]):
        for sy in range(mesh_shape[1]):
            sg = _local_grid(g, nx, ny, sx, sy, ("x", "y"), mesh_shape,
                             ProcessMesh(mesh_shape, (sx, sy), g.device, transport=False))
            slon = sg.lon_cc.to(torch.float32).contiguous()
            slat = sg.lat_cc.to(torch.float32).contiguous()
            for comp, fn in enumerate(distributed_basin.WINDS):
                out = fpw.fixed_tile_pointwise(fn, fixed, (slon, slat),
                                               scalars=(state.clock.time,))
                ref = fpw.fixed_tile_pointwise_reference(fn, (slon, slat), (state.clock.time,))
                worst = max(worst, max_ulp(ref, out))
                if earlier:
                    old = earlier["pointwise_fixed"].fixed_tile_pointwise(
                        fn, fixed, (slon, slat), scalars=(state.clock.time,))
                    if not same_bits(old, out):
                        raise AssertionError(f"2.10 on shard {(sx, sy)}, wind {'xy'[comp]}: "
                                             f"not the earlier tree's bits "
                                             f"({max_ulp(old, out)} ulp)")
    print(f"  2.10 on the {mesh_shape} mesh's four shards ({sg.nxp}×{sg.nyp} padded), both "
          f"components: at most {worst} ulp from the plain version (bar 2)"
          + ("; the earlier tree's raw bits on every shard" if earlier else ""))
    if worst > 2:
        raise AssertionError(f"2.10 on a shard is {worst} ulp from its plain version")
    del model, state, u, v, h, masks, metrics, out, ref

    # --- 25-26. the distributed step: four gloo ranks on the card ------------------------------
    probe = launch.probe_device_tensors("cuda")
    print(f"[25] gloo send/recv of a CUDA tensor (two ranks): {probe}")
    steps = 3
    basin_names = ("u", "v", "h", "a", "hs", "sig11", "sig22", "sig12", "alpha")
    runs = [("(1, 4), drag", (1, 4), True), ("(2, 2), no drag", (2, 2), False),
            ("(2, 2), drag", (2, 2), True)]
    cases = [dict(build=distributed_basin.build,
                  kwargs=dict(Nx=1152, Ny=960, fixed_tiles=fixed, drag=drag), mesh=mesh,
                  steps=steps, dt=dt, names=basin_names) for _, mesh, drag in runs]
    # 26: the deferred form and the per-half-update form in turns (the
    # first with the ranks' snapshots and sharded checkpoints); 35: the
    # overlap policy on (2, 2) and (1, 4), and the deferred form on (1, 4);
    # 36: the general physics of phase 31 on (2, 2)
    rect_steps, uv = 5, ("u", "v", "h", "a")
    io_dir = tempfile.mkdtemp(prefix="chip_smoke_rank_io_")
    rect_labels = ["deferred", "half-update", "deferred", "half-update"]
    for k, form in enumerate(rect_labels):
        cases.append(dict(build=rectilinear_contractive, mesh=(2, 2), steps=rect_steps, dt=60.0,
                          names=uv, io=io_dir if k == 0 else None,
                          **({} if form == "deferred" else
                             dict(context=exchange_every_half_update))))
    overlap_runs = [("overlap", (2, 2)), ("overlap", (1, 4)), ("per_substep", (1, 4))]
    cases += [dict(build=rectilinear_contractive, kwargs=dict(halo_exchange=policy), mesh=mesh,
                   steps=rect_steps, dt=60.0, names=uv) for policy, mesh in overlap_runs]
    physics_steps = {"viscous": 2, "forced": 1, "free_drift": 2}
    cases += [dict(build=physics_shard, kwargs=dict(variant=v), mesh=(2, 2), steps=n, dt=120.0,
                   names=uv) for v, n in physics_steps.items()]
    t0 = time.perf_counter()
    results = launch.run_cases(cases, 4, timeout=900)
    spawn_s = time.perf_counter() - t0
    physics_results = results[-len(physics_steps):]
    overlap_results = results[-len(physics_steps) - len(overlap_runs):-len(physics_steps)]
    rect_results = results[len(runs):len(runs) + len(rect_labels)]
    serial = {}
    for drag in (True, False):
        m, s = distributed_basin.build(1152, 960, fixed_tiles=fixed, drag=drag)
        for _ in range(steps):
            s = cst.step(m, s, dt)
        si = strip_halos(m, s)
        serial[drag] = {n: getattr(si, n).cpu().numpy() for n in basin_names}
    del m, s, si
    K = fused_evp.pick_chunk(tsub)
    print(f"    4 ranks spawned on {card}, {len(cases)} runs in {spawn_s:.1f} s:")
    dist_launches = {}
    for (label, mesh, drag), res in zip(runs, results):
        x_split = mesh[0] > 1
        per_call = tc_launches(tsub, K, not x_split)
        for r in res["records"]:
            calls, launches = r["calls"], r["launches"]
            if any(calls[k] for k in ("2.1", "2.2", "2.3", "2.4", "2.5", "2.6")):
                raise AssertionError(f"{label}: rank {r['rank']} called {calls}")
            if any(calls[k] == 0 for k in ("2.7", "2.8", "2.9", "2.10", "2.11")):
                raise AssertionError(f"{label}: rank {r['rank']} skipped a kernel: {calls}")
            if calls["2.7"] != steps or launches["2.7"] != steps * per_call:
                raise AssertionError(f"{label}: rank {r['rank']} 2.7 calls {calls['2.7']}, "
                                     f"launches {launches['2.7']}; expected {steps} and "
                                     f"{steps * per_call}")
            print(f"    {label}, rank {r['rank']} shard {tuple(r['index'])}: ms/step "
                  f"{', '.join(f'{t:.1f}' for t in r['ms_per_step'])}; 2.7 launches a step "
                  f"{launches['2.7'] // steps} (refills {launches['2.7'] // steps - 2 - 3 * tsub})"
                  f"; {r['bytes_per_step'] / 1e6:.3f} MB sent a step "
                  f"({'via host' if r['stage'] else 'device to device'}), "
                  f"on {r['device']} ({r['device_name']})")
        if label == "(2, 2), drag":
            dist_launches = {k: sum(r["launches"][k] for r in res["records"])
                             for k in ("2.7", "2.9")}
        for name in basin_names:
            if not np.isfinite(res["fields"][name]).all():
                raise AssertionError(f"{label}: {name} is not finite")
        cmp = distributed_basin.compare(serial[drag], res["fields"])
        parted = {n: c for n, c in cmp.items() if c["points"]}
        if not parted:
            print(f"  {label}: u, v, h, ℵ, hs, σ₁₁, σ₂₂, σ₁₂, α bitwise equal to the serial "
                  "card run")
            continue
        print(f"  {label}: fields that part from the serial card run (points; largest "
              f"difference over the field's largest value off and in the top "
              f"{distributed_basin.CAP} rows; deepest differing row below the top): "
              + "; ".join(f"{n} {c['points']}, {c['rel_err']:.3e}, {c['cap_rel_err']:.3e}, "
                          f"{c['deepest_row']}" for n, c in parted.items()))
        if not (drag and x_split):
            raise AssertionError(f"{label}: parts from serial: {parted}")
        if not distributed_basin.xsplit_drag_band(cmp, Hm, 300.0):   # the build's α⁺
            raise AssertionError(f"{label}: outside the band (top {Hm} rows; off the top "
                                 f"{distributed_basin.CAP} rows u, v < 2e-2, h, ℵ, hs < 5e-3): "
                                 f"{parted}")
        print(f"    within the band: every differing point in the top {Hm} rows, and off "
              f"the top {distributed_basin.CAP} rows u, v < 2e-2, h, ℵ, hs < 5e-3")
    rect = rect_results[0]
    m, s = rectilinear_contractive()
    for _ in range(rect_steps):
        s = cst.step(m, s, 60.0)
    si = strip_halos(m, s)
    rect_serial = {n: getattr(si, n).cpu().numpy() for n in uv}
    print(f"[26] 128² periodic rectilinear, float64, 'per_substep' on (2, 2), {rect_steps} "
          "steps, in the deferred form (one joint u, v exchange a substep), against the serial "
          "card run (rtol 1e-7, atol 1e-9):")
    for name in uv:
        ref, got = rect_serial[name], rect["fields"][name]
        err = np.abs(got - ref).max()
        print(f"  {name:6s} max abs diff {err:.3e}")
        if not np.allclose(got, ref, rtol=1e-7, atol=1e-9):
            raise AssertionError(f"{name}: per_substep distributed run outside rtol 1e-7, "
                                 f"atol 1e-9 of serial ({err:.3e})")
    for res in rect_results[1:]:
        for name in uv:
            if not np.array_equal(res["fields"][name], rect["fields"][name]):
                raise AssertionError(f"[26] {name}: the two forms' interiors differ")
    print("    the deferred and the per-half-update forms (the gate turned off): interiors of "
          "u, v, h, ℵ bitwise equal in all four runs")
    for form, res in zip(rect_labels, rect_results):
        want = "deferred" if form == "deferred" else "exchanging"
        if any(r["loop"] != want for r in res["records"]):
            raise AssertionError(f"[26] {form}: loop forms {[r['loop'] for r in res['records']]}")
        r = res["records"][0]
        print(f"    {form}, rank 0: {r['rounds_per_step']:.0f} exchange rounds a step, ms/step "
              f"{', '.join(f'{t:.1f}' for t in r['ms_per_step'])}, "
              f"{r['bytes_per_step'] / 1e6:.3f} MB sent a step, on {r['device']} "
              f"({r['device_name']})")
    saved = (rect_results[1]["records"][0]["rounds_per_step"]
             - rect["records"][0]["rounds_per_step"])
    if saved != (10 + 1) * 2:
        raise AssertionError(f"[26] the deferred form saves {saved} rounds a step, not 22")
    if not all(r["checkpoint_bitwise"] for r in rect["records"]) or not all(
            np.array_equal(rect["snapshot"][n], rect["fields"][n]) for n in uv):
        raise AssertionError("[26] a rank's sharded checkpoint or the reassembled snapshots "
                             "differ from the state")
    print(f"    each rank's snapshot and sharded checkpoint written to a temporary directory: "
          f"the checkpoints restore bitwise on every rank, the reassembled snapshots equal the "
          f"gathered state ({len(os.listdir(io_dir))} files)")
    shutil.rmtree(io_dir, ignore_errors=True)

    print(f"[35] the overlap policy, the same case, {rect_steps} steps, on {card}:")
    deferred14 = overlap_results[2]
    for (policy, mesh), res in zip(overlap_runs[:2], overlap_results):
        if any(r["loop"] != "overlap" for r in res["records"]):
            raise AssertionError(f"[35] {mesh}: loop forms {[r['loop'] for r in res['records']]}")
        ref = rect if mesh == (2, 2) else deferred14
        same = all(np.array_equal(res["fields"][n], ref["fields"][n]) for n in uv)
        if same:
            print(f"  {mesh}: interiors of u, v, h, ℵ bitwise equal to the deferred form's")
        else:
            for name in uv:
                err = np.abs(res["fields"][name] - rect_serial[name]).max()
                print(f"  {mesh}: {name} differs from the deferred form; {err:.3e} from the "
                      "serial card run")
                if not np.allclose(res["fields"][name], rect_serial[name], rtol=1e-7,
                                   atol=1e-9):
                    raise AssertionError(f"[35] {mesh} {name}: outside rtol 1e-7, atol 1e-9 "
                                         "of the serial run")
        for r, d in zip(res["records"], ref["records"]):
            print(f"    rank {r['rank']}: ms/step {', '.join(f'{t:.1f}' for t in r['ms_per_step'])}"
                  f" (deferred {', '.join(f'{t:.1f}' for t in d['ms_per_step'])}), "
                  f"{r['rounds_per_step']:.0f} rounds and {r['bytes_per_step'] / 1e6:.3f} MB a "
                  "step")

    print(f"[36] the general physics of phase 31 on four gloo ranks, (2, 2), 128², against the "
          f"serial card run, on {card}:")
    for (variant, n), res in zip(physics_steps.items(), physics_results):
        m, s = physics_shard(variant)
        for _ in range(n):
            s = cst.step(m, s, 120.0)
        si = strip_halos(m, s)
        ulps = []
        for name in uv:
            ref = torch.as_tensor(getattr(si, name).cpu().numpy())
            got = torch.as_tensor(res["fields"][name])
            if not torch.isfinite(got).all():
                raise AssertionError(f"[36] {variant}: {name} is not finite")
            rel, _ = rel_diff(ref, got)
            check(f"{variant} {name}", rel, 1e-5)
            ulps.append(max_ulp(ref, got))
        r = res["records"][0]
        print(f"  {variant}: {n} RK3 steps, {max(ulps)} ulp from the serial card run at most; "
              f"loop form {r['loop'] or 'none (no split-explicit loop)'}; rank 0 ms/step "
              f"{', '.join(f'{t:.1f}' for t in r['ms_per_step'])}, "
              f"{r['rounds_per_step']:.0f} rounds and {r['bytes_per_step'] / 1e6:.3f} MB a step")
    del m, s, si, results

    # --- 27. kernels 2.3, 2.4 and 2.5 meshed on one shard of paths A and B --------------------
    nsub, dt, mesh_shape, shard = 120, 120.0, (2, 2), (1, 1)
    Hw = 2 * nsub + 3                     # the wide halo of the distributed step
    names = ("u", "v", "sig11", "sig22", "sig12", "alpha")

    def meshed_check(label, kernel, plain, interior, record=None, signed_zeros=False):
        """Bitwise kernel against plain version over ``interior`` (with
        ``signed_zeros``, the same bits); their largest differences (a
        record), and the largest ulp distance over ``interior`` and (a
        record) over ``record``."""
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        worst = (0.0, 0.0)
        for name, r, o in zip(names, ref, out):
            if not torch.isfinite(interior(o)).all():
                raise AssertionError(f"{label}: {name} is not finite")
            rel, abs_err = rel_diff(interior(r), interior(o))
            worst = (max(worst[0], abs_err), max(worst[1], rel))
        ulps = max(max_ulp(interior(r), interior(o)) for r, o in zip(ref, out))
        print(f"  {label}: {ulps} ulp from the plain version"
              + ("" if record is None else ", a record over the split directions' padded "
                 f"extent: {max(max_ulp(record(r), record(o)) for r, o in zip(ref, out))} ulp"))
        if ulps or (signed_zeros and not all(same_bits(interior(r), interior(o))
                                             for r, o in zip(ref, out))):
            raise AssertionError(f"{label}: not bitwise its plain version ({ulps} ulp, largest "
                                 f"relative difference {worst[1]:.3e})")
        return worst

    print(f"[27] kernels 2.3, 2.4 and 2.5 meshed on shard {shard} of a {mesh_shape} mesh of "
          f"the 512² flagship, halos {Hw}, soft ice, seeded velocities, {nsub} substeps, on "
          f"{card}:")
    model = flagship(cst, 512, nsub, P_star=27.5, halo=Hw, wide=True)
    lmodel, lstate = shard_model(model, flagship_state(cst, model, velocity_seed=27), shard,
                                 mesh_shape, Hw)
    lgrid = lmodel.grid
    LI = lgrid.interior
    points = lgrid.nxp * lgrid.nyp
    if fused_evp_padded.direction_kinds(lgrid) != (fused_evp_padded.KIND_SPLIT,) * 2:
        raise AssertionError("the shard's directions are not split")
    for label, m_, s_ in (("flagship", lmodel, lstate), ("island", None, None)):
        if m_ is None:      # the island of phase 6 on the periodic grid, across all shards
            imodel = bounded(cst, 512, nsub, P_star=27.5, halo=Hw, wide=True,
                             topology=("periodic", "periodic"))
            m_, s_ = shard_model(imodel, flagship_state(cst, imodel, velocity_seed=28), shard,
                                 mesh_shape, Hw)
            del imodel
        params, consts, carry, _ = fused_evp_padded.padded_evp_inputs(m_, s_, dt, s_.u, s_.v)
        drag = len(consts) == 22
        padded_counter.reset()
        worst = meshed_check(
            f"2.3 meshed ({label}), whole padded arrays",
            lambda: fused_evp_padded.padded_evp_substeps(params, consts,
                                                         [q.clone() for q in carry], nsub,
                                                         m_.grid),
            lambda: fused_evp_padded.padded_evp_substeps_reference(params, consts, carry,
                                                                   nsub, m_.grid),
            lambda q: q)
        per_call = padded_counter.launches
        work = [q.clone() for q in carry]
        kernel_ms = cuda_ms(lambda: fused_evp_padded.padded_evp_substeps(
            params, consts, work, nsub, m_.grid), 10)
        plain_ms = cuda_ms(lambda: fused_evp_padded.padded_evp_substeps_reference(
            params, consts, carry, nsub, m_.grid), 2)
        flops = PADDED_FLOPS_PER_POINT_SUBSTEP - (0 if drag else 10)
        bytes_ms, ops_ms = bounds_ms(
            ((PADDED_ARRAYS_READ - (0 if drag else 4) + EVP_ARRAYS_WRITTEN) * points
             + EVP_PARAMS) * 4, (flops * nsub + PADDED_FLOPS_PER_POINT_CALL) * points)
        print(f"  2.3 meshed, {label} ({'island straddling the four shards, drag' if drag else 'no land'}), "
              f"{lgrid.nxp}×{lgrid.nyp}: bitwise equal to the plain version; "
              f"{per_call} launches a call; kernel {kernel_ms:.4f} ms/call, plain "
              f"{plain_ms:.3f} ms/call, bound {max(bytes_ms, ops_ms):.4f} ms")
        if label == "flagship":
            pm_timing = (*worst, kernel_ms, plain_ms, bytes_ms, ops_ms)
        del params, consts, carry, work
    del m_, s_

    fixed = (8, 128)
    model = flagship(cst, 512, nsub, P_star=27.5, halo=Hw, fixed_tiles=fixed)
    lmodel, lstate = shard_model(model, flagship_state(cst, model, velocity_seed=29), shard,
                                 mesh_shape, Hw)
    del model
    dt_t = lgrid.scalar(dt)
    prm = fused_evp_padded.evp_prep_params(lmodel, dt_t)
    h, a = lstate.h.contiguous(), lstate.a.contiguous()
    prepm_fn = lambda: fused_evp_padded.evp_prep(lmodel, dt_t, h, a, lgrid)   # noqa: E731
    out = prepm_fn()
    ref = fused_evp_padded.evp_prep_reference(prm, h, a, lgrid)
    torch.cuda.synchronize()
    if not all(same_bits(r, o) for r, o in zip(ref, out)):
        raise AssertionError(f"2.4 meshed is {max(max_ulp(r, o) for r, o in zip(ref, out))} "
                             "ulp from its plain version over the padded arrays, or differs in "
                             "a signed zero")
    if earlier:
        old_prep = earlier["evp_prep"]
        old_fn = lambda: old_prep.evp_prep(   # noqa: E731
            old_prep.evp_prep_params(lmodel, dt_t), h, a, lgrid)
        against_earlier("2.4 meshed", list(out), list(old_fn()), list(ref), True, card,
                        {"2.4": prepm_fn, "earlier 2.4": old_fn})
        print_turns("device µs a launch (torch.profiler)",
                    device_in_turns({"2.4": prepm_fn, "earlier 2.4": old_fn}, "evp_prep"),
                    "µs", card)
    kernel_ms = cuda_ms(prepm_fn, 50)
    prepm_dev_us = device_profile(prepm_fn, 20, "evp_prep")[0]
    plain_ms = cuda_ms(lambda: fused_evp_padded.evp_prep_reference(prm, h, a, lgrid), 10)
    bytes_ms, ops_ms = bounds_ms((PREP_ARRAYS * points + PREP_PARAMS) * 4,
                                 PREP_FLOPS_PER_POINT * points)
    print(f"  2.4 meshed (images clamped at the padded edge): the plain version's raw bits "
          f"over the padded arrays; kernel {kernel_ms:.4f} ms a call by CUDA events, "
          f"{device_ms_text(prepm_dev_us)} of device time a launch (torch.profiler), plain "
          f"{plain_ms:.4f} ms/call, bound {max(bytes_ms, ops_ms):.4f} ms")
    prepm_timing = (0.0, 0.0, kernel_ms, plain_ms, bytes_ms, ops_ms)
    params, consts, carry, _ = fused_evp_padded.padded_evp_inputs(lmodel, lstate, dt,
                                                                  lstate.u, lstate.v)
    tiled_counter.reset()
    worst = meshed_check(
        "2.5 meshed, interiors",
        lambda: fused_evp_tiled_padded.tiled_padded_evp_substeps(
            params, consts, [q.clone() for q in carry], nsub, lgrid, fixed),
        lambda: fused_evp_tiled_padded.tiled_padded_evp_substeps_reference(
            params, consts, carry, nsub, lgrid, fixed), LI, record=lambda q: q)
    per_call = tiled_counter.launches
    work = [q.clone() for q in carry]
    kernel_ms = cuda_ms(lambda: fused_evp_tiled_padded.tiled_padded_evp_substeps(
        params, consts, work, nsub, lgrid, fixed), 10)
    plain_ms = cuda_ms(lambda: fused_evp_tiled_padded.tiled_padded_evp_substeps_reference(
        params, consts, carry, nsub, lgrid, fixed), 2)
    bytes_ms, ops_ms = bounds_ms(
        ((PADDED_ARRAYS_READ - 4 + EVP_ARRAYS_WRITTEN) * points + EVP_PARAMS) * 4,
        ((PADDED_FLOPS_PER_POINT_SUBSTEP - 10) * nsub + PADDED_FLOPS_PER_POINT_CALL) * points)
    print(f"  2.5 meshed (the padded extent carried in its own tiles): interiors bitwise "
          f"equal to the plain version (the TPU kernel's ceil tiles of {fixed}); {per_call} "
          f"launches a call; kernel {kernel_ms:.4f} ms/call, plain {plain_ms:.3f} ms/call, "
          f"bound {max(bytes_ms, ops_ms):.4f} ms")
    tpm_timing = (*worst, kernel_ms, plain_ms, bytes_ms, ops_ms)
    pm_shape = (f"{lgrid.nxp}x{lgrid.nyp} shard {shard} of a 2x2 mesh of the 512x512 "
                f"flagship, halos {Hw}, {nsub} substeps")
    del lmodel, lstate, params, consts, carry, work, out, ref, h, a

    # --- 28. kernel 2.7's unpinned plan on shards of path C ------------------------------------
    from climaseaice_jl_tpu_torch.grids import with_halo
    tsub, dt = 24, 600.0
    Hm = 2 * tsub + 3
    model, state = fixed_basin(1152, 960, fixed_tiles=None, soft=True, seed=9, snow=0.1,
                               halo=Hm)
    g = model.grid
    params, planes, carry, _, flags = ftc.tiled_curvilinear_inputs(model, state, dt, state.u,
                                                                    state.v)
    print(f"[28] kernel 2.7's unpinned plan on shards of the basin {g.Nx}×{g.Ny} without "
          f"fixed_tiles, soft ice, seeded velocities, {tsub} substeps, on {card}:")
    for mesh_c, shard_c in (((1, 4), (0, 3)), ((2, 2), (1, 1))):
        nx, ny = g.Nx // mesh_c[0], g.Ny // mesh_c[1]
        Hx = Hm if mesh_c[0] > 1 else 5
        axes = ("x" if mesh_c[0] > 1 else None, "y")
        lgrid = _local_grid(with_halo(g, (Hx, Hm)), nx, ny, *shard_c, axes, mesh_c,
                            ProcessMesh(mesh_c, shard_c, g.device, transport=False))
        LI = lgrid.interior
        lp = tuple(shard_of(q, shard_c, nx, ny, Hm, Hx) for q in planes)
        lc = tuple(shard_of(q, shard_c, nx, ny, Hm, Hx) for q in carry)
        plan = ftc._unpinned_plan(lgrid, tsub)
        geo = ftc._geometry(lgrid)
        tc_counter.reset()
        settled = torch.empty(-(-lgrid.nxp // ftc.BLOCK[0]) * -(-lgrid.nyp // ftc.BLOCK[1]),
                              dtype=torch.int32, device="cuda")
        worst = meshed_check(
            f"2.7 unpinned on {mesh_c}",
            lambda: ftc.tiled_curvilinear_evp_substeps(
                params, lp, [q.clone() for q in lc], tsub, lgrid, plan, flags,
                settled=settled),
            lambda: ftc.tiled_curvilinear_evp_substeps_reference(params, lp, lc, tsub, lgrid,
                                                                 plan, flags), LI,
            signed_zeros=True)
        per_call = tc_counter.launches
        expect = tc_launches(tsub, plan[0], geo.refill)
        if per_call != expect:
            raise AssertionError(f"2.7 unpinned on {mesh_c}: {per_call} launches a call, "
                                 f"expected {expect}")
        share = settled_record(settled, ftc.tiled_settled_blocks_reference(
            params, lp, lgrid, plan, flags))
        points = lgrid.nxp * lgrid.nyp
        work = [q.clone() for q in lc]
        kernel_ms = cuda_ms(lambda: ftc.tiled_curvilinear_evp_substeps(
            params, lp, work, tsub, lgrid, plan, flags), 20)
        plain_ms = cuda_ms(lambda: ftc.tiled_curvilinear_evp_substeps_reference(
            params, lp, lc, tsub, lgrid, plan, flags), 2)
        bytes_ms, ops_ms = bounds_ms(
            ((TC_ARRAYS_READ + EVP_ARRAYS_WRITTEN) * points + ftc.N_PARAMS) * 4,
            (CURV_FLOPS_PER_POINT_SUBSTEP * tsub + TC_FLOPS_PER_POINT_CALL) * points)
        print(f"  {mesh_c} shard {shard_c}, {lgrid.nxp}×{lgrid.nyp} padded, plan {plan}, wrap "
              f"{geo.wrap}, wall gates {geo.gates}, fold refilled {geo.refill}: interiors "
              f"bitwise equal to the plain version; {per_call} launches a call; settled "
              f"blocks {share[0]:.4f} ({share[1]} of {share[2]}), the kernel's flags equal "
              f"their plain version's; kernel {kernel_ms:.4f} ms/call, plain "
              f"{plain_ms:.3f} ms/call, bound {max(bytes_ms, ops_ms):.4f} ms")
        if mesh_c == (2, 2):
            tcu_timing = (*worst, kernel_ms, plain_ms, bytes_ms, ops_ms)
            tcu_shape = (f"{lgrid.nxp}x{lgrid.nyp} shard {shard_c} of a 2x2 mesh of the "
                         f"1152x960 basin, halos {Hm}, {tsub} substeps, unpinned plan {plan}")
        del lp, lc, work
    # path C's shards: the flags depend on h, ℵ and the land only, as at path C's first step
    shares = []
    for mesh_c in ((1, 4), (2, 2)):
        nx, ny = g.Nx // mesh_c[0], g.Ny // mesh_c[1]
        Hx = Hm if mesh_c[0] > 1 else 5
        axes = ("x" if mesh_c[0] > 1 else None, "y")
        for shard_c in ((ix, iy) for ix in range(mesh_c[0]) for iy in range(mesh_c[1])):
            lgrid = _local_grid(with_halo(g, (Hx, Hm)), nx, ny, *shard_c, axes, mesh_c,
                                ProcessMesh(mesh_c, shard_c, g.device, transport=False))
            lp = tuple(shard_of(q, shard_c, nx, ny, Hm, Hx) for q in planes)
            flags_c = ftc.tiled_settled_blocks_reference(params, lp, lgrid,
                                                         ftc._unpinned_plan(lgrid, tsub), flags)
            shares.append(f"{mesh_c} {shard_c} {float(flags_c.float().mean()):.4f}")
    print(f"  settled blocks on path C's shards (phase 30): {'; '.join(shares)}")
    del model, state, params, planes, carry, lp

    # --- 29-30. paths A, B and C through the distributed step on four gloo ranks ----------------
    steps = 3
    rect_names = ("u", "v", "h", "a", "sig11", "sig22", "sig12", "alpha")
    runs = [("A, soft ice", dict(build=wide_flagship, kwargs=dict(P_star=27.5), dt=120.0)),
            ("A", dict(build=wide_flagship, dt=120.0)),
            ("B", dict(build=wide_flagship, kwargs=dict(fixed_tiles=fixed), dt=120.0))]
    runs += [(f"C {mesh}, {'drag' if drag else 'no drag'}",
              dict(build=wide_basin, kwargs=dict(drag=drag), dt=600.0, mesh=mesh,
                   names=basin_names))
             for mesh in ((1, 4), (2, 2)) for drag in (False, True)]
    cases = [dict(dict(mesh=(2, 2), steps=steps, names=rect_names), **c) for _, c in runs]
    t0 = time.perf_counter()
    results = dict(zip((label for label, _ in runs), launch.run_cases(cases, 4, timeout=900)))
    spawn_s = time.perf_counter() - t0
    print(f"[29] paths A and B on (2, 2), {steps} RK3 steps of 120 s, 4 ranks spawned on "
          f"{card} ({len(cases)} runs of phases 29 and 30 in {spawn_s:.1f} s):")

    def serial_run(build, kwargs, dt, names, route=None):
        m, s = build(**kwargs)
        with momentum_through(route) if route else contextlib.nullcontext():
            for _ in range(steps):
                s = cst.step(m, s, dt)
        check_state(m, s)
        si = strip_halos(m, s)
        return {n: getattr(si, n).cpu().numpy() for n in names}

    def report(label, res, expect_calls, launches_per_call):
        for r in res["records"]:
            calls, launches = r["calls"], r["launches"]
            want = {k: expect_calls.get(k, 0) for k in calls}
            if calls != want:
                raise AssertionError(f"{label}: rank {r['rank']} kernel calls {calls}, "
                                     f"expected {want}")
            for k, n in launches_per_call.items():
                if launches[k] != n * calls[k]:
                    raise AssertionError(f"{label}: rank {r['rank']} {k} launched "
                                         f"{launches[k]} times in {calls[k]} calls, expected "
                                         f"{n} a call")
            print(f"    {label}, rank {r['rank']} shard {tuple(r['index'])}: ms/step "
                  f"{', '.join(f'{t:.1f}' for t in r['ms_per_step'])}; kernel calls "
                  f"{ {k: v for k, v in calls.items() if v} }; "
                  f"{r['bytes_per_step'] / 1e6:.3f} MB sent a step "
                  f"({'via host' if r['stage'] else 'device to device'}), on {r['device']} "
                  f"({r['device_name']})")
        for name, q in res["fields"].items():
            if not np.isfinite(q).all():
                raise AssertionError(f"{label}: {name} is not finite")
        return {k: sum(r["launches"][k] for r in res["records"]) for k in res["records"][0]["launches"]}

    def bitwise(label, ref, got):
        cmp = distributed_basin.compare(ref, got)
        parted = {n: c for n, c in cmp.items() if c["points"]}
        if parted:
            raise AssertionError(f"{label}: parts from the serial card run: {parted}")
        return cmp

    stages = 3 * steps
    a_launches = -(-nsub // t23_chunk)
    for label, kw in (("A, soft ice", dict(P_star=27.5)), ("A", {})):
        res = results[label]
        launches_a = report(label, res, {"2.3": stages}, {"2.3": a_launches})
        padded_ref = serial_run(wide_flagship, kw, 120.0, rect_names,
                                fused_evp_padded.padded_fused_momentum_step)
        bitwise(label, padded_ref, res["fields"])
        print(f"  {label}: u, v, h, ℵ, σ₁₁, σ₂₂, σ₁₂, α bitwise equal to the serial card run "
              f"whose momentum goes through the padded route (2.3)")
        if label == "A, soft ice":
            ref21 = serial_run(wide_flagship, kw, 120.0, rect_names)
            vel = max(np.abs(ref21["u"]).max(), np.abs(ref21["v"]).max(), 1e-8)
            for name, bar in (("u", 2e-2), ("v", 2e-2), ("h", 1e-4), ("a", 1e-4)):
                scale = vel if name in ("u", "v") else max(np.abs(ref21[name]).max(), 1e-8)
                d = np.abs(res["fields"][name].astype(np.float64) - ref21[name]).max() / scale
                check(f"{name}/2.1", d, bar)
            print("    (against the serial card run through 2.1, bars of "
                  "tests/test_distributed.py:238-248)")
        else:
            pm_launches = launches_a["2.3"]
    res = results["B"]
    b_launches = report("B", res, {"2.4": stages, "2.5": stages, "2.9": 2 * stages,
                                   "2.11": stages},
                        {"2.4": 1, "2.5": -(-nsub // fused_evp_tiled_padded._tiled_entry()[1])})
    bitwise("B", serial_run(wide_flagship, dict(fixed_tiles=fixed), 120.0, rect_names),
            res["fields"])
    print("  B: u, v, h, ℵ, σ₁₁, σ₂₂, σ₁₂, α bitwise equal to the serial card run; finite "
          "and physical at the default P★")

    print(f"[30] path C, the 1152×960 basin without fixed_tiles under the wide policy, "
          f"{steps} steps of 600 s, on {card}:")
    serial_c = {}
    for drag in (False, True):
        serial_c[drag] = (
            serial_run(wide_basin, dict(drag=drag), 600.0, basin_names,
                       ftc.tiled_curvilinear_momentum_step),
            serial_run(wide_basin, dict(drag=drag), 600.0, basin_names))
    for mesh in ((1, 4), (2, 2)):
        for drag in (False, True):
            label = f"C {mesh}, {'drag' if drag else 'no drag'}"
            res = results[label]
            # one chunk of 24: one refill where x is whole
            launches_c = report(label, res, {"2.7": steps},
                                {"2.7": tc_launches(tsub, tsub, mesh[0] == 1)})
            if label == "C (2, 2), drag":
                tcu_launches = launches_c["2.7"]
            ref27, ref26 = serial_c[drag]
            cmp = distributed_basin.compare(ref27, res["fields"])
            parted = {n: c for n, c in cmp.items() if c["points"]}
            far = distributed_basin.compare(ref26, res["fields"])
            print(f"  {label}: against the serial card run through 2.7's unpinned plan "
                  + ("bitwise equal" if not parted else
                     "parted (points; largest difference over the field's largest value off "
                     f"and in the top {distributed_basin.CAP} rows; deepest row): "
                     + "; ".join(f"{n} {c['points']}, {c['rel_err']:.3e}, "
                                 f"{c['cap_rel_err']:.3e}, {c['deepest_row']}"
                                 for n, c in parted.items())))
            print("    against the default serial card run (2.6), a record: "
                  + "; ".join(f"{n} {c['points']} points, {max(c['rel_err'], c['cap_rel_err']):.3e}"
                              for n, c in far.items()))
            if parted and not drag:
                raise AssertionError(f"{label}: parts from the serial 2.7 run: {parted}")
            if parted and not distributed_basin.xsplit_drag_band(cmp, Hm, 300.0):
                raise AssertionError(f"{label}: outside the band of phase 25: {parted}")
    del results, serial_c

    # --- 31-34. the momentum physics beyond the EVP kernels, forcing, the examples ---------
    evp_counters = {"2.1": counter, "2.2": tiled_evp_counter, "2.3": padded_counter,
                    "2.4": prep_counter, "2.5": tiled_counter, "2.6": curv_counter,
                    "2.7": tc_counter, "2.8": strength_counter}
    forced_launches = physics_phases(cst, card, evp_counters, adv_counter, thermo_counter)
    io_phase(cst, card, evp_counters)
    coupled_launches, coupled_timing, coupled_shape = side_model_phases(cst, card, evp_counters)

    print(card)
    print(json.dumps({"kernels": [
        kernel_entry("evp_substeps", "climaseaice_jl_tpu_torch/csrc/evp.cu",
                     "climaseaice_jl_tpu/dynamics/pallas_evp.py:139", "_evp_kernel",
                     main_launches, *evp_timing, f"{N}x{N}, {nsub} substeps"),
        kernel_entry("padded_evp_substeps", "climaseaice_jl_tpu_torch/csrc/evp_padded.cu",
                     "climaseaice_jl_tpu/dynamics/pallas_evp_padded.py:167", "_padded_kernel",
                     padded_launches, *padded_timing, f"{padded_shape}, {nsub} substeps"),
        kernel_entry("curvilinear_evp_substeps",
                     "climaseaice_jl_tpu_torch/csrc/evp_curvilinear.cu",
                     "climaseaice_jl_tpu/dynamics/pallas_evp_curvilinear.py:202",
                     "_curvilinear_kernel", curv_launches, *curv_timing,
                     "1162x970 padded (1152x960 tripolar basin, land, fold, drag, f planes), "
                     "120 substeps"),
        dict(kernel_entry("evp_prep", "climaseaice_jl_tpu_torch/csrc/evp_prep.cu",
                          "climaseaice_jl_tpu/dynamics/pallas_evp_padded.py:512",
                          "_prep_kernel", fixed_launches["prep"], *prep_timing, shape),
             device_ms=None if prep_dev_us is None else prep_dev_us / 1e3),
        kernel_entry("tiled_padded_evp_substeps",
                     "climaseaice_jl_tpu_torch/csrc/evp_tiled_padded.cu",
                     "climaseaice_jl_tpu/dynamics/pallas_evp_tiled_padded.py:262",
                     "_tiled_padded_kernel", fixed_launches["tiled"], *tiled_timing,
                     f"{shape}, {nsub} substeps"),
        dict(kernel_entry("fixed_tile_div", "climaseaice_jl_tpu_torch/csrc/advection_fixed.cu",
                          "climaseaice_jl_tpu/dynamics/pallas_advection.py:142", "_adv_kernel",
                          fixed_launches["adv"], *adv_timing, f"{shape}, WENO-7"),
             entry="csi_fixed_tile_div_tiles"),
        dict(kernel_entry("fixed_tile_div_runtime_scheme",
                          "climaseaice_jl_tpu_torch/csrc/advection_fixed.cu",
                          "climaseaice_jl_tpu/dynamics/pallas_advection.py:142", "_adv_kernel",
                          mixed_launches, *mixed_timing,
                          f"{shape}, UpwindBiased(5) in x, Centered(2) in y"),
             entry="csi_fixed_tile_div"),
        dict(kernel_entry("fixed_tile_div_forced",
                          "climaseaice_jl_tpu_torch/csrc/advection_fixed.cu",
                          "climaseaice_jl_tpu/dynamics/pallas_advection.py:142", "_adv_kernel",
                          forced_launches["adv"], *adv_timing,
                          f"{shape}, WENO-7, forcing on h (phase 32)"),
             entry="csi_fixed_tile_div_tiles"),
        dict(kernel_entry("thermo_column_forced",
                          "climaseaice_jl_tpu_torch/csrc/thermo_column.cuh",
                          "climaseaice_jl_tpu/dynamics/pallas_pointwise.py:69",
                          "fixed_tile_pointwise_multi", forced_launches["thermo"],
                          *thermo_timing, f"{shape}, bare ice, forcing on h (phase 32)"),
             carries="climaseaice_jl_tpu/thermodynamics/pallas_thermo.py:169",
             unit=f"climaseaice_jl_tpu_torch/_build/{bare_unit}.cu",
             generated_by="climaseaice_jl_tpu_torch/dynamics/fixed_tile_codegen.py"),
        dict(kernel_entry("thermo_column", "climaseaice_jl_tpu_torch/csrc/thermo_column.cuh",
                          "climaseaice_jl_tpu/dynamics/pallas_pointwise.py:69",
                          "fixed_tile_pointwise_multi", fixed_launches["thermo"],
                          *thermo_timing, f"{shape}, bare ice"),
             carries="climaseaice_jl_tpu/thermodynamics/pallas_thermo.py:169",
             unit=f"climaseaice_jl_tpu_torch/_build/{bare_unit}.cu",
             generated_by="climaseaice_jl_tpu_torch/dynamics/fixed_tile_codegen.py"),
        kernel_entry("tiled_curvilinear_evp_substeps",
                     "climaseaice_jl_tpu_torch/csrc/evp_tiled_curvilinear.cu",
                     "climaseaice_jl_tpu/dynamics/pallas_evp_tiled_curvilinear.py:662",
                     "_tiled_curv_kernel", basin_launches["tiled_curvilinear"], *tc_timing,
                     tc_shape),
        dict(kernel_entry("fixed_tile_P", "climaseaice_jl_tpu_torch/csrc/ice_strength_fixed.cu",
                          "climaseaice_jl_tpu/dynamics/pallas_evp_tiled_curvilinear.py:1022",
                          "_p_kernel", basin_launches["strength"], *strength_timing,
                          "1162x1018 widened (1152x960 tripolar basin)"),
             device_ms=None if strength_dev_us is None else strength_dev_us / 1e3),
        dict(kernel_entry("fixed_tile_pointwise",
                          "climaseaice_jl_tpu_torch/dynamics/fixed_tile_codegen.py",
                          "climaseaice_jl_tpu/dynamics/pallas_pointwise.py:28",
                          "fixed_tile_pointwise", basin_launches["wind"], *wind_timing,
                          "1162x970 padded (1152x960 tripolar basin), the x wind"),
             device_ms=None if wind_dev_us is None else wind_dev_us / 1e3, unit=f"climaseaice_jl_tpu_torch/_build/{wind_unit}.cu",
             includes="climaseaice_jl_tpu_torch/csrc/pointwise_program.cuh",
             generated_by="climaseaice_jl_tpu_torch/dynamics/fixed_tile_codegen.py"),
        dict(kernel_entry("thermo_column_flux_function",
                          "climaseaice_jl_tpu_torch/csrc/thermo_column.cuh",
                          "climaseaice_jl_tpu/dynamics/pallas_pointwise.py:69",
                          "fixed_tile_pointwise_multi", basin_launches["thermo"], *flux_timing,
                          "1162x970 padded (1152x960 tripolar basin), snow, solar "
                          "FluxFunction"),
             carries="climaseaice_jl_tpu/thermodynamics/pallas_thermo.py:169",
             unit=f"climaseaice_jl_tpu_torch/_build/{basin_unit}.cu",
             generated_by="climaseaice_jl_tpu_torch/dynamics/fixed_tile_codegen.py"),
        kernel_entry("tiled_evp_substeps", "climaseaice_jl_tpu_torch/csrc/evp_tiled.cu",
                     "climaseaice_jl_tpu/dynamics/pallas_evp_tiled.py:193", "_tiled_kernel",
                     t22_main_launches, *t22_timing, f"{N2}x{N2}, {nsub} substeps"),
        kernel_entry("tiled_curvilinear_evp_substeps_meshed",
                     "climaseaice_jl_tpu_torch/csrc/evp_tiled_curvilinear.cu",
                     "climaseaice_jl_tpu/dynamics/pallas_evp_tiled_curvilinear.py:662",
                     "_tiled_curv_kernel", dist_launches["2.7"], *tcm_timing, tcm_shape),
        dict(kernel_entry("fixed_tile_div_meshed",
                          "climaseaice_jl_tpu_torch/csrc/advection_fixed.cu",
                          "climaseaice_jl_tpu/dynamics/pallas_advection.py:142", "_adv_kernel",
                          dist_launches["2.9"], *advm_timing, f"{tcm_shape}, WENO-7"),
             entry="csi_fixed_tile_div_tiles"),
        kernel_entry("padded_evp_substeps_meshed", "climaseaice_jl_tpu_torch/csrc/evp_padded.cu",
                     "climaseaice_jl_tpu/dynamics/pallas_evp_padded.py:167", "_padded_kernel",
                     pm_launches, *pm_timing, pm_shape),
        dict(kernel_entry("evp_prep_meshed", "climaseaice_jl_tpu_torch/csrc/evp_prep.cu",
                          "climaseaice_jl_tpu/dynamics/pallas_evp_padded.py:512",
                          "_prep_kernel", b_launches["2.4"], *prepm_timing, pm_shape),
             device_ms=None if prepm_dev_us is None else prepm_dev_us / 1e3),
        kernel_entry("tiled_padded_evp_substeps_meshed",
                     "climaseaice_jl_tpu_torch/csrc/evp_tiled_padded.cu",
                     "climaseaice_jl_tpu/dynamics/pallas_evp_tiled_padded.py:262",
                     "_tiled_padded_kernel", b_launches["2.5"], *tpm_timing, pm_shape),
        kernel_entry("tiled_curvilinear_evp_substeps_unpinned_meshed",
                     "climaseaice_jl_tpu_torch/csrc/evp_tiled_curvilinear.cu",
                     "climaseaice_jl_tpu/dynamics/pallas_evp_tiled_curvilinear.py:662",
                     "_tiled_curv_kernel", tcu_launches, *tcu_timing, tcu_shape),
        kernel_entry("padded_evp_substeps_coupled", "climaseaice_jl_tpu_torch/csrc/evp_padded.cu",
                     "climaseaice_jl_tpu/dynamics/pallas_evp_padded.py:167", "_padded_kernel",
                     coupled_launches, *coupled_timing, coupled_shape),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stop_children()
    sys.exit(code)

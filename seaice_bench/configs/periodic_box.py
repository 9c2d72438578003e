"""periodic_box: the periodic αEVP flagship, ``bench.py:build(N, 120)``.

A frozen copy of ``chip_smoke.py:451-486`` (``flagship``,
``flagship_state``, commit 25f59c9) that builds the configuration in the
port.  N comes from the cell's traffic; the rest from ``periodic_box.json``.
Its plain reference is ``reference/periodic_box.py``.
"""

from __future__ import annotations

import math

import torch

from .. import roofline

# the EVP kernels of this configuration's route, by name in the device trace:
# 2.1 and 2.2 both instantiate the periodic tile engine's chunk kernel
EVP_KERNELS = r"\bperiodic_chunk\b"
# 2.9's tile kernel, which the whole-grid route runs for h and ℵ
KERNELS = {"advection": r"\btile_div\b"}
# above this many points the port runs 2.2, at or below it 2.1
# (climaseaice_jl_tpu_torch/dynamics/fused_evp.py, _MAX_POINTS_RICH)
MAX_POINTS_21 = 571_099


def build(pkg, cfg, traffic, device):
    """(model, dt) of the configuration at N = ``traffic["N"]`` in ``pkg``."""
    N, L = int(traffic["N"]), float(cfg["domain_m"])
    grid = pkg.RectilinearGrid(size=(N, N), x=(0, L), y=(0, L), halo=int(cfg["halo"]),
                               dtype=cfg["dtype"], topology=tuple(cfg["topology"]),
                               device=device)
    dynamics = pkg.SeaIceMomentumEquation(
        rheology=pkg.ElastoViscoPlasticRheology(
            ice_compressive_strength=float(cfg["ice_compressive_strength"])),
        coriolis=pkg.FPlane(f=float(cfg["coriolis_f"])),
        top_momentum_stress=dict(cfg["top_momentum_stress"]),
        bottom_momentum_stress=pkg.SemiImplicitStress(),
        solver=pkg.SplitExplicitSolver(substeps=int(cfg["substeps"])))
    model = pkg.sea_ice_model(grid, dynamics=dynamics,
                              ice_thermodynamics=pkg.sea_ice_slab_thermodynamics(),
                              top_heat_flux=float(cfg["top_heat_flux"]),
                              bottom_heat_flux=float(cfg["bottom_heat_flux"]),
                              advection=pkg.WENO(order=7),
                              timestepper=cfg["timestepper"])
    return model, float(cfg["dt"])


def inputs(model, cfg, traffic, seed, device):
    """The interior fields of the initial state, made on ``device`` from
    ``seed``: the bench's thickness 1 + 0.25 sin·sin, perturbed by the
    seed's noise, full concentration, seeded velocities."""
    N, L = int(traffic["N"]), float(cfg["domain_m"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    x = (torch.arange(N, dtype=torch.float64, device=device) + 0.5) * (L / N)
    s = torch.sin(2 * math.pi * x / L)
    h = (1.0 + 0.25 * s[:, None] * s[None, :]).to(torch.float32)
    noise = torch.randn((3, N, N), generator=gen, dtype=torch.float32, device=device)
    h = h * (1.0 + float(cfg["h_noise"]) * noise[0]).clamp(min=0.5)
    vel = float(cfg["velocity_noise"])
    return dict(h=h, a=torch.ones_like(h), u=vel * noise[1], v=vel * noise[2])


def initial_state(pkg, model, fields):
    return pkg.initial_state(model, **fields)


def work(cfg, traffic):
    """The step's pieces of work: name → (operations, bytes) a step; the
    EVP loop is ``"evp"``.  Three RK3 stages, each one EVP call, the
    advection of h and ℵ and the bare-ice column."""
    N, H = int(traffic["N"]), int(cfg["halo"])
    stages = 3
    padded = (N + 2 * H) ** 2
    evp = roofline.periodic_evp(N * N, int(cfg["substeps"]), tiled=N * N > MAX_POINTS_21)
    adv = roofline.advection(padded, 2)
    col = roofline.bare_column(padded)
    return {"evp": tuple(stages * q for q in evp),
            "advection": tuple(stages * q for q in adv),
            "column": tuple(stages * q for q in col)}

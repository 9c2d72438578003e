"""periodic_box's plain reference: one SplitRungeKutta3 step of the doubly
periodic αEVP box, in plain PyTorch.

Written from the JAX package's source as the specification, and importing
neither it nor the port:

* the step, ``climaseaice_jl_tpu/model.py`` (``rk3_step``,
  ``tracer_tendencies``, ``dynamic_step_tracers``);
* the momentum, ``dynamics/momentum.py`` (``split_explicit_momentum_step``,
  ``velocity_tendencies``, ``_masked_velocity``), ``dynamics/rheologies.py``
  (strain rates, ``compute_evp_viscosities``, ``compute_evp_stresses``,
  ``stress_divergence``), ``dynamics/stresses.py`` (the constant wind and
  the quadratic ocean drag), ``dynamics/coriolis.py`` (``FPlane``);
* the tracers, ``advection.py`` (WENO of order 7, flux form);
* the column, ``thermodynamics/slab.py`` (``bare_ice_thermodynamic_step``,
  ``ice_volume_update``), ``heat_bcs.py`` (the secant solve),
  ``phase_transitions.py``.

On a doubly periodic grid every halo is the periodic image of the
interior, so the reference holds the N × N interiors alone and wraps with
``torch.roll``.  It computes in the dtype of the state it is given: float32
as the configuration states, or bfloat16 for the control.
"""

from __future__ import annotations

import math
from fractions import Fraction

import torch

# the fields of the state the reference steps, and those the program's
# halo fills keep as periodic images (α is carried unfilled)
FIELDS = ("h", "a", "u", "v", "sig11", "sig22", "sig12", "alpha", "Tu")
FILLED = ("h", "a", "u", "v", "sig11", "sig22", "sig12", "Tu")
# the numbers compared after a step: each the largest, over its fields, of
# the error in its norm ("max": max |Δ| / max |ref|; "l2": ‖Δ‖₂ / ‖ref‖₂).
# Tracers and the column by the largest error, which sees one altered
# point; velocities and normal stresses by the L2 norm, since their largest
# errors sit at the few points of rigid ice, where Δ meets its floor and the
# float32 reference itself lies 1-5 % from the float64 one; σ₁₂ and α not at
# all: float32 fixes them no better than 26-50 % there (the float32
# reference against the float64 one), nor is α carried, each substep
# deriving it afresh before it is used
COMPARED = {"tracer_err": (("h", "a", "Tu"), "max"),
            "velocity_l2": (("u", "v"), "l2"),
            "stress_l2": (("sig11", "sig22"), "l2")}

# defaults of the source's constructors (rheologies.py:93-102,
# stresses.py:50-61, momentum.py:126-136, model.py:76-95, slab.py,
# phase_transitions.py, heat_bcs.py:57-66, advection.py:44-47)
RHO_ICE = 900.0
COMPACTION_HARDENING = 20.0
ECCENTRICITY = 2.0
MIN_PLASTIC_STRESS = 2e-9
ALPHA_MIN, ALPHA_MAX = 50.0, 300.0
RELAXATION_STRENGTH = math.pi ** 2
RHO_OCEAN, DRAG = 1026.0, 5.5e-3
OCEAN_U, OCEAN_V = 0.0, 0.0
MIN_CONCENTRATION, MIN_MASS = 1e-3, 1.0
CONSOLIDATION = 0.05
CONDUCTIVITY = 2.0
LATENT_HEAT = 334e3
LIQUID_DENSITY, LIQUID_HEAT_CAPACITY = 999.8, 4186.0
ICE_DENSITY, ICE_HEAT_CAPACITY = 917.0, 2000.0
LIQUIDUS_SLOPE, ICE_SALINITY, OCEAN_SALINITY = 0.054, 0.0, 0.0
SECANT_ITERATIONS = 20
WENO_EPSILON = 1e-8
RK3_FRACTIONS = (1.0 / 3.0, 1.0 / 2.0, 1.0)


# --- staggered operators on periodic interiors (x = axis 0, y = axis 1;
#     u[i] sits on the face left of centre i, v[j] below centre j) ---------

def prev(q, axis):
    return torch.roll(q, 1, axis)


def next_(q, axis):
    return torch.roll(q, -1, axis)


def d_to_c(q, axis):
    """Difference face → centre: q[i+1] − q[i]."""
    return next_(q, axis) - q


def d_to_f(q, axis):
    """Difference centre → face: q[i] − q[i−1]."""
    return q - prev(q, axis)


def i_to_c(q, axis):
    return 0.5 * (next_(q, axis) + q)


def i_to_f(q, axis):
    return 0.5 * (q + prev(q, axis))


# --- WENO-7 tables, derived here from cell averages -----------------------

def _solve(a, b):
    """x with a x = b, exactly (Fractions, Gauss-Jordan)."""
    n = len(a)
    m = [list(row) + [bi] for row, bi in zip(a, b)]
    for c in range(n):
        p = next(r for r in range(c, n) if m[r][c] != 0)
        m[c], m[p] = m[p], m[c]
        m[c] = [x / m[c][c] for x in m[c]]
        for r in range(n):
            if r != c and m[r][c] != 0:
                m[r] = [x - m[r][c] * y for x, y in zip(m[r], m[c])]
    return [row[n] for row in m]


def _cell_integral(power, offset):
    lo, hi = Fraction(2 * offset - 1, 2), Fraction(2 * offset + 1, 2)
    return (hi ** (power + 1) - lo ** (power + 1)) / (power + 1)


def _monomials_of_cells(offsets):
    """Column j: the monomial coefficients of the polynomial whose averages
    over the unit cells at ``offsets`` are δ_j."""
    n = len(offsets)
    a = [[_cell_integral(c, o) for c in range(n)] for o in offsets]
    return [_solve(a, [Fraction(int(i == j)) for i in range(n)]) for j in range(n)]


def weno_tables(r=4):
    """(C, B, G) of WENO-(2r−1) at the right face of the donor cell: C[k][j]
    the face value's weights of candidate k (cells k−r+1 … k about the
    donor), B[k] the quadratic form of its smoothness Σₗ∫(p⁽ˡ⁾)², G the
    linear weights that recover the (2r−1)-cell face value."""
    half = Fraction(1, 2)
    C, B = [], []
    for k in range(r):
        polys = _monomials_of_cells(range(k - r + 1, k + 1))
        C.append([sum(c * half ** p for p, c in enumerate(poly)) for poly in polys])
        form = [[Fraction(0)] * r for _ in range(r)]
        for j1, p1 in enumerate(polys):
            for j2, p2 in enumerate(polys):
                d1, d2 = list(p1), list(p2)
                for _ in range(r - 1):
                    d1 = [c * p for p, c in enumerate(d1)][1:]
                    d2 = [c * p for p, c in enumerate(d2)][1:]
                    prod = {}
                    for i, x in enumerate(d1):
                        for j, y in enumerate(d2):
                            prod[i + j] = prod.get(i + j, 0) + x * y
                    form[j1][j2] += sum(c * (half ** (p + 1) - (-half) ** (p + 1)) / (p + 1)
                                        for p, c in prod.items())
        B.append(form)
    wide = range(-r + 1, r)
    face = [sum(c * half ** p for p, c in enumerate(poly)) for poly in _monomials_of_cells(wide)]
    # the wide face value as Σₖ Gₖ Cₖ: the first r cells give a triangular system
    rows = [[C[k][o - (k - r + 1)] if k - r + 1 <= o <= k else Fraction(0) for k in range(r)]
            for o in list(wide)[:r]]
    G = _solve(rows, face[:r])
    return C, B, G


_TABLES = {}


def _tables(r):
    if r not in _TABLES:
        C, B, G = weno_tables(r)
        _TABLES[r] = ([[float(x) for x in row] for row in C],
                      [[[float(x) for x in row] for row in form] for form in B],
                      [float(g) for g in G])
    return _TABLES[r]


def weno_face(cells, r=4, eps=WENO_EPSILON):
    """The WENO-(2r−1) face value from 2r−1 cells listed upwind → downwind
    (the donor is ``cells[r − 1]``)."""
    C, B, G = _tables(r)
    num = den = None
    for k in range(r):
        s = cells[k:k + r]
        value = sum(C[k][j] * s[j] for j in range(r))
        beta = sum(B[k][j][j] * s[j] * s[j] for j in range(r))
        beta = beta + sum(2.0 * B[k][i][j] * s[i] * s[j]
                          for i in range(r) for j in range(i + 1, r))
        w = G[k] / (eps + beta) ** 2
        num = w * value if num is None else num + w * value
        den = w if den is None else den + w
    return num / den


def advective_divergence(c, u, v, dx, dy, r=4):
    """∇·(U c) at the centres: [δx(Δy u ĉˣ) + δy(Δx v ĉʸ)] / Az, ĉ the
    upwind WENO value at each face (the mean of both where U = 0)."""
    out = None
    for axis, vel, width in ((0, u, dy), (1, v, dx)):
        shifted = {k: torch.roll(c, k, axis) for k in range(-(r - 1), r + 1)}
        # face i lies between cells i−1 and i: shifted[k][i] = c[i−k]
        left = weno_face([shifted[r - j] for j in range(2 * r - 1)], r)
        right = weno_face([shifted[j - r + 1] for j in range(2 * r - 1)], r)
        face = torch.where(vel > 0, left, torch.where(vel < 0, right, 0.5 * (left + right)))
        term = d_to_c(width * vel * face, axis)
        out = term if out is None else out + term
    return out / (dx * dy)


# --- momentum: the split-explicit αEVP solver ------------------------------

def _reciprocal(x):
    ok = x > 0
    return torch.where(ok, 1.0 / torch.where(ok, x, torch.ones_like(x)), torch.zeros_like(x))


def evp_momentum(cfg, s, u_start, v_start, dt, dx, dy):
    """``substeps`` αEVP substeps from (u_start, v_start) with the stage's
    σ and α; returns (u, v, σ₁₁, σ₂₂, σ₁₂, α)."""
    h, a = s["h"], s["a"]
    az = dx * dy
    e_inv2 = ECCENTRICITY ** -2.0
    f = float(cfg["coriolis_f"])
    tau_x = float(cfg["top_momentum_stress"]["u"])
    tau_y = float(cfg["top_momentum_stress"]["v"])
    m_cc = h * a * RHO_ICE
    a_fc, m_fc = i_to_f(a, 0), i_to_f(m_cc, 0)
    a_cf, m_cf = i_to_f(a, 1), i_to_f(m_cc, 1)
    m_ff = i_to_f(i_to_f(m_cc, 1), 0)
    inv_fc, inv_cf = _reciprocal(m_fc), _reciprocal(m_cf)
    P = float(cfg["ice_compressive_strength"]) * h * torch.exp(-COMPACTION_HARDENING * (1 - a))
    P_ff = i_to_f(i_to_f(P, 1), 0)
    # ice below the least mass or concentration takes its free drift, 0
    # without a free-drift closure
    moving_u = (m_fc >= MIN_MASS) & (a_fc >= MIN_CONCENTRATION)
    moving_v = (m_cf >= MIN_MASS) & (a_cf >= MIN_CONCENTRATION)

    def gamma(zeta, m):
        ok = m > 0
        g2 = torch.where(ok, zeta * RELAXATION_STRENGTH * dt / torch.where(ok, m, 1.0) / az,
                         ALPHA_MAX ** 2)
        g2 = torch.where(torch.isnan(g2), ALPHA_MAX ** 2, g2)
        return torch.clamp(torch.sqrt(g2), ALPHA_MIN, ALPHA_MAX)

    def u_update(u, v, alpha, div_x):
        ia = i_to_f(alpha, 0)
        dtau = dt / ia
        v_at_u = i_to_f(i_to_c(v, 1), 0)
        drag = RHO_OCEAN * DRAG * torch.sqrt((OCEAN_U - u) ** 2 + (OCEAN_V - v_at_u) ** 2)
        G = (f * v_at_u - tau_x * inv_fc * a_fc + drag * OCEAN_U * inv_fc * a_fc
             + div_x * inv_fc + (u_start - u) / dtau / ia)
        G = torch.where(m_fc <= 0, 0.0, G)
        implicit = torch.where(m_fc <= 0, 0.0, drag * inv_fc * a_fc)
        return torch.where(moving_u, (u + dtau * G) / (1 + dtau * implicit), 0.0)

    def v_update(u, v, alpha, div_y):
        ia = i_to_f(alpha, 1)
        dtau = dt / ia
        u_at_v = i_to_c(i_to_f(u, 1), 0)
        drag = RHO_OCEAN * DRAG * torch.sqrt((OCEAN_U - u_at_v) ** 2 + (OCEAN_V - v) ** 2)
        G = (-(f * u_at_v) - tau_y * inv_cf * a_cf + drag * OCEAN_V * inv_cf * a_cf
             + div_y * inv_cf + (v_start - v) / dtau / ia)
        G = torch.where(m_cf <= 0, 0.0, G)
        implicit = torch.where(m_cf <= 0, 0.0, drag * inv_cf * a_cf)
        return torch.where(moving_v, (v + dtau * G) / (1 + dtau * implicit), 0.0)

    u, v = u_start, v_start
    s11, s22, s12, alpha = s["sig11"], s["sig22"], s["sig12"], s["alpha"]
    for substep in range(1, int(cfg["substeps"]) + 1):
        # strain rates: divergence and tension at centres, shear at corners
        div = (d_to_c(dy * u, 0) + d_to_c(dx * v, 1)) / az
        ten = (dy ** 2 * d_to_c(u / dy, 0) - dx ** 2 * d_to_c(v / dx, 1)) / az
        she = (dx ** 2 * d_to_f(u / dx, 1) + dy ** 2 * d_to_f(v / dy, 0)) / az
        e11, e22, e12 = 0.5 * (div + ten), 0.5 * (div - ten), 0.5 * she
        e11_ff, e22_ff = i_to_f(i_to_f(e11, 1), 0), i_to_f(i_to_f(e22, 1), 0)
        e12_cc = i_to_c(i_to_c(e12, 1), 0)
        shear_cc = torch.sqrt((e11 - e22) ** 2 + 4 * e12_cc ** 2)
        shear_ff = torch.sqrt((e11_ff - e22_ff) ** 2 + 4 * e12 ** 2)
        delta_cc = torch.clamp(torch.sqrt((e11 + e22) ** 2 + shear_cc ** 2 * e_inv2),
                               min=MIN_PLASTIC_STRESS)
        delta_ff = torch.clamp(torch.sqrt((e11_ff + e22_ff) ** 2 + shear_ff ** 2 * e_inv2),
                               min=MIN_PLASTIC_STRESS)
        zeta_cc, zeta_ff = P / (2 * delta_cc), P_ff / (2 * delta_ff)
        # αEVP relaxation towards the viscous-plastic stress
        pressure = P * delta_cc / (delta_cc + MIN_PLASTIC_STRESS)
        eta_cc, eta_ff = zeta_cc * e_inv2, zeta_ff * e_inv2
        bulk = (zeta_cc - eta_cc) * (e11 + e22) - pressure / 2
        g_cc, g_ff = gamma(zeta_cc, m_cc), gamma(zeta_ff, m_ff)
        s11 = s11 + torch.where(m_cc > 0, (2 * eta_cc * e11 + bulk - s11) / g_cc, 0.0)
        s22 = s22 + torch.where(m_cc > 0, (2 * eta_cc * e22 + bulk - s22) / g_cc, 0.0)
        s12 = s12 + torch.where(m_ff > 0, (2 * eta_ff * e12 - s12) / g_ff, 0.0)
        alpha = g_cc
        # the stress divergence in its energy-conserving invariant form
        sD, sT = s11 + s22, s11 - s22
        div_x = (dy * d_to_f(sD, 0) / 2 + d_to_f(dy ** 2 * sT, 0) / dy / 2
                 + d_to_c(dx ** 2 * s12, 1) / dx) / az
        div_y = (dx * d_to_f(sD, 1) / 2 - d_to_f(dx ** 2 * sT, 1) / dx / 2
                 + d_to_c(dy ** 2 * s12, 0) / dy) / az
        # the two half-updates alternate their order from substep to substep
        if substep % 2 == 0:
            u = u_update(u, v, alpha, div_x)
            v = v_update(u, v, alpha, div_y)
        else:
            v = v_update(u, v, alpha, div_y)
            u = u_update(u, v, alpha, div_x)
    return u, v, s11, s22, s12, alpha


# --- the slab column without snow ------------------------------------------

def _latent_heat(T):
    return LATENT_HEAT + (LIQUID_DENSITY * LIQUID_HEAT_CAPACITY / ICE_DENSITY
                          - ICE_HEAT_CAPACITY) * T


def _conductive_flux(T, Tb, h):
    ok = h > 0
    return torch.where(ok, -CONDUCTIVITY * (T - Tb) / torch.where(ok, h, 1.0), 0.0)


def slab_column(cfg, h, a, Tu, dt):
    """One step of the bare slab: the top temperature from the flux balance
    (secant, capped at melting), the Stefan volume change, the Hibler
    concentration split and the clipping; returns (h, a, Tu)."""
    top, bottom = float(cfg["top_heat_flux"]), float(cfg["bottom_heat_flux"])
    Tb = 0.0 - LIQUIDUS_SLOPE * OCEAN_SALINITY
    Tm = 0.0 - LIQUIDUS_SLOPE * ICE_SALINITY
    consolidated = h >= CONSOLIDATION

    def balance(T):
        return top - _conductive_flux(T, Tb, h)

    T1, T2 = Tu + 1.0, Tu + 0.0
    F1, F2 = balance(T1), balance(T2)
    for _ in range(SECANT_ITERATIONS):
        dF = F2 - F1
        ok = dF.abs() > 0
        T3 = T2 - torch.where(ok, F2 * (T2 - T1) / torch.where(ok, dF, 1.0), 0.0)
        T1, F1, T2, F2 = T2, F2, T3, balance(T3)
    Tu = torch.where(consolidated, torch.clamp(T2, max=Tm), torch.full_like(T2, Tb))
    internal = torch.where(consolidated, _conductive_flux(Tu, Tb, h), 0.0)
    dVdt = ((top - internal) / (RHO_ICE * _latent_heat(Tu))
            + (internal - bottom) / (RHO_ICE * _latent_heat(Tb)))

    V = torch.clamp(h * a + dt * dVdt, min=0.0)
    dVdt = (V - h * a) / dt
    freezing = dVdt >= 0
    grow = torch.where(freezing, (1 - a) * (dVdt / CONSOLIDATION), 0.0)
    melt_ok = ~freezing & (h > 0)
    melt = torch.where(melt_ok, a * (dVdt / torch.where(melt_ok, 2 * h, 1.0)), 0.0)
    a1 = torch.clamp(a + dt * (grow + melt), min=0.0)
    h1 = torch.where(a1 > 0, V / torch.where(a1 > 0, a1, 1.0), 0.0)
    a1 = torch.where(dVdt == 0, a, a1)
    h1 = torch.where(dVdt == 0, h, h1)
    a1 = torch.where(h1 == 0, 0.0, a1)
    h1 = torch.where(a1 == 0, 0.0, h1)
    return torch.where(a1 > 1, h1 * a1, h1), torch.clamp(a1, max=1.0), Tu


# --- the step ---------------------------------------------------------------

def spacing(cfg, traffic):
    n = int(traffic["N"])
    return float(cfg["domain_m"]) / n, float(cfg["domain_m"]) / n


def initial(cfg, traffic, fields, dtype=torch.float32):
    """The initial state's interiors from the input fields: no stress, the
    largest relaxation parameter, the surface at 0 °C."""
    h = fields["h"].to(dtype)
    zero = torch.zeros_like(h)
    return dict(h=h, a=fields["a"].to(dtype), u=fields["u"].to(dtype), v=fields["v"].to(dtype),
                sig11=zero, sig22=zero, sig12=zero, alpha=torch.full_like(h, ALPHA_MAX),
                Tu=zero)


def step(cfg, traffic, state, dt):
    """One SplitRungeKutta3 step: three stages from the cached state Ψ⁻
    with Δτ = Δt/3, Δt/2, Δt; each advects h and ℵ with the stage's
    velocities, runs the αEVP momentum from Ψ⁻'s velocities, rebases the
    tracers on Ψ⁻ (clipped, ridged) and runs the column."""
    dx, dy = spacing(cfg, traffic)
    psi = state
    s = dict(state)
    dtype = state["h"].dtype
    for frac in RK3_FRACTIONS:
        dtau = dt * torch.tensor(frac, dtype=dtype, device=state["h"].device)
        Gh = -advective_divergence(s["h"], s["u"], s["v"], dx, dy)
        Ga = -advective_divergence(s["a"], s["u"], s["v"], dx, dy)
        u, v, s11, s22, s12, alpha = evp_momentum(cfg, s, psi["u"], psi["v"], dtau, dx, dy)
        h = torch.clamp(psi["h"] + dtau * Gh, min=0.0)
        a = torch.clamp(psi["a"] + dtau * Ga, min=0.0)
        a = torch.where(h == 0, 0.0, a)
        h = torch.where(a == 0, 0.0, h)
        h, a = torch.where(a > 1, h * a, h), torch.where(a > 1, 1.0, a)
        h, a, Tu = slab_column(cfg, h, a, s["Tu"], dtau)
        s = dict(h=h, a=a, u=u, v=v, sig11=s11, sig22=s22, sig12=s12, alpha=alpha, Tu=Tu)
    return s


def halo_image(q, halo):
    """The padded field whose interior is ``q`` and whose halos are its
    periodic images."""
    return torch.nn.functional.pad(q[None, None], (halo,) * 4, mode="circular")[0, 0]

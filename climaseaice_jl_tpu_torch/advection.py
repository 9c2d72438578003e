"""Flux-form tracer advection: Centered, UpwindBiased and WENO schemes.

Counterpart of `climaseaice_jl_tpu/advection.py`:

    ∇·(U c) = [ δx( Δy_fc · u · ĉˣ ) + δy( Δx_cf · v · ĉʸ ) ] / Az_cc

with ĉ the upwind-biased face reconstruction selected by the sign of the
transporting velocity.  Face convention: face I sits between centers I-1
(upwind-left) and I (downwind-right).  The operation order follows the JAX
package's, so float64 results agree to rounding.
"""

from __future__ import annotations

import copy
import functools
from fractions import Fraction

import torch

from .utils import frozen_dataclass
from .ops import dxc, dyc

# stencil-halo requirements per scheme (cells on each side of a face)
_REQUIRED_HALO = {1: 1, 2: 1, 3: 2, 5: 3, 7: 4, 9: 5}


@frozen_dataclass
class Centered:
    order: int = 2


@frozen_dataclass
class UpwindBiased:
    order: int = 3


@frozen_dataclass
class WENO:
    order: int = 5
    epsilon: float = 1e-8


@frozen_dataclass
class FluxFormAdvection:
    """Direction-split advection: independent schemes for x and y fluxes."""
    x: object = None
    y: object = None


def required_halo(scheme):
    if scheme is None:
        return 1
    if isinstance(scheme, FluxFormAdvection):
        return max(required_halo(scheme.x), required_halo(scheme.y))
    return _REQUIRED_HALO[scheme.order]


# --- shift helpers -----------------------------------------------------------

def _cm(c, axis, k):
    """c[I-k] along axis."""
    return torch.roll(c, k, axis)


def _cp(c, axis, k):
    """c[I+k] along axis."""
    return torch.roll(c, -k, axis)


# --- biased reconstructions at face I ----------------------------------------

def _upwind_faces(c, axis, order):
    """(left_biased, right_biased) reconstructions at face I."""
    m = lambda k: _cm(c, axis, k)
    p = lambda k: _cp(c, axis, k)
    if order == 1:
        return m(1), c
    if order == 3:
        left = (-m(2) + 5 * m(1) + 2 * c) / 6
        right = (2 * m(1) + 5 * c - p(1)) / 6
        return left, right
    if order == 5:
        left = (2 * m(3) - 13 * m(2) + 47 * m(1) + 27 * c - 3 * p(1)) / 60
        right = (2 * p(2) - 13 * p(1) + 47 * c + 27 * m(1) - 3 * m(2)) / 60
        return left, right
    if order == 7:
        left = (-3 * m(4) + 25 * m(3) - 101 * m(2) + 319 * m(1)
                + 214 * c - 38 * p(1) + 4 * p(2)) / 420
        right = (-3 * p(3) + 25 * p(2) - 101 * p(1) + 319 * c
                 + 214 * m(1) - 38 * m(2) + 4 * m(3)) / 420
        return left, right
    if order == 9:
        left = (4 * m(5) - 41 * m(4) + 199 * m(3) - 641 * m(2)
                + 1879 * m(1) + 1375 * c - 305 * p(1) + 55 * p(2)
                - 5 * p(3)) / 2520
        right = (4 * p(4) - 41 * p(3) + 199 * p(2) - 641 * p(1)
                 + 1879 * c + 1375 * m(1) - 305 * m(2) + 55 * m(3)
                 - 5 * m(4)) / 2520
        return left, right
    raise ValueError(f"unsupported UpwindBiased order {order}")


def _centered_face(c, axis, order):
    m = lambda k: _cm(c, axis, k)
    p = lambda k: _cp(c, axis, k)
    if order == 2:
        return 0.5 * (m(1) + c)
    if order == 4:
        return (-m(2) + 7 * m(1) + 7 * c - p(1)) / 12
    raise ValueError(f"unsupported Centered order {order}")


def _weno_tables(r):
    """Exact WENO-(2r−1) coefficient tables via Fraction arithmetic.

    Face convention: the face sits at x = 1/2 of the donor cell [−1/2, 1/2]
    (unit spacing).  Candidate stencil k (k = 0..r−1) covers cells at integer
    offsets o = k−r+1 .. k relative to the donor.

    Returns (C, G, B):
      C[k][j]      — face-value reconstruction coefficients of stencil k,
      G[k]         — optimal (linear) weights,
      B[k][j1][j2] — Jiang–Shu smoothness-indicator quadratic form:
                     β_k = Σ_{l=1..r−1} ∫_{−1/2}^{1/2} (q_k^{(l)})² dx.
    """
    F = Fraction

    def basis(offsets):
        """Dual basis φ_j (degree len−1 polys, monomial coeffs) with
        ∫_{o−1/2}^{o+1/2} φ_j = δ_{jo}."""
        n = len(offsets)
        # A[m][c] = ∫ x^c over cell m
        A = [[(F(2 * o + 1, 2) ** (c + 1) - F(2 * o - 1, 2) ** (c + 1)) / (c + 1)
              for c in range(n)] for o in offsets]
        # invert A by Gauss-Jordan elimination
        M = copy.deepcopy(A)
        Inv = [[F(int(i == j)) for j in range(n)] for i in range(n)]
        for col in range(n):
            piv = next(row for row in range(col, n) if M[row][col] != 0)
            M[col], M[piv] = M[piv], M[col]
            Inv[col], Inv[piv] = Inv[piv], Inv[col]
            d = M[col][col]
            M[col] = [x / d for x in M[col]]
            Inv[col] = [x / d for x in Inv[col]]
            for row in range(n):
                if row != col and M[row][col] != 0:
                    f = M[row][col]
                    M[row] = [a - f * b for a, b in zip(M[row], M[col])]
                    Inv[row] = [a - f * b for a, b in zip(Inv[row], Inv[col])]
        # coefficients of φ_j are the j-th column of A⁻¹
        return [[Inv[c][j] for c in range(n)] for j in range(n)]

    def poly_eval(coeffs, x):
        return sum(c * x ** p for p, c in enumerate(coeffs))

    def poly_deriv(coeffs):
        return [c * p for p, c in enumerate(coeffs)][1:]

    def poly_mul_int(c1, c2):
        """∫_{−1/2}^{1/2} p1·p2 dx."""
        prod = [F(0)] * (len(c1) + len(c2) - 1)
        for i, a in enumerate(c1):
            for j, b in enumerate(c2):
                prod[i + j] += a * b
        half = F(1, 2)
        return sum(c * (half ** (p + 1) - (-half) ** (p + 1)) / (p + 1)
                   for p, c in enumerate(prod))

    C, B = [], []
    for k in range(r):
        offsets = list(range(k - r + 1, k + 1))
        phis = basis(offsets)
        C.append([poly_eval(phi, F(1, 2)) for phi in phis])
        Bk = [[F(0)] * r for _ in range(r)]
        for j1 in range(r):
            for j2 in range(r):
                d1, d2 = phis[j1], phis[j2]
                for _l in range(r - 1):
                    d1, d2 = poly_deriv(d1), poly_deriv(d2)
                    Bk[j1][j2] += poly_mul_int(d1, d2)
        B.append(Bk)

    # optimal weights from the (2r−1)-cell big-stencil reconstruction
    big_offsets = list(range(-r + 1, r))
    big_phis = basis(big_offsets)
    D = {o: poly_eval(big_phis[i], F(1, 2)) for i, o in enumerate(big_offsets)}
    G = [F(0)] * r
    for o in big_offsets[:r]:  # triangular solve from the leftmost cell
        k_list = [k for k in range(r) if k - r + 1 <= o <= k]
        acc = D[o]
        for k in k_list[:-1]:  # smaller k already solved
            acc -= G[k] * C[k][o - (k - r + 1)]
        k = k_list[-1]
        G[k] = acc / C[k][o - (k - r + 1)]

    return ([[float(c) for c in row] for row in C],
            [float(g) for g in G],
            [[[float(x) for x in row] for row in Bk] for Bk in B])


@functools.lru_cache(maxsize=None)
def _weno_tables_cached(r):
    return _weno_tables(r)


def _weno_side(s, r, eps_):
    """One-sided WENO-(2r−1) from the (2r−1)-point stencil listed
    upwind→downwind (donor cell is s[r−1])."""
    C, G, B = _weno_tables_cached(r)
    num = 0.0
    den = 0.0
    for k in range(r):
        cells = s[k:k + r]
        q = sum(C[k][j] * cells[j] for j in range(r))
        beta = sum(B[k][j1][j2] * cells[j1] * cells[j2]
                   for j1 in range(r) for j2 in range(r) if B[k][j1][j2] != 0.0)
        w = G[k] / (eps_ + beta) ** 2
        num = num + w * q
        den = den + w
    return num / den


def _weno5_side(s, eps_):
    """One-sided WENO-5 from the 5-point stencil ``s`` listed upwind→downwind."""
    return _weno_side(s, 3, eps_)


def _weno_faces(c, axis, order, eps_):
    m = lambda k: _cm(c, axis, k)
    p = lambda k: _cp(c, axis, k)
    if order not in (5, 7, 9):
        raise ValueError(f"unsupported WENO order {order}")
    r = (order + 1) // 2
    # left-biased stencil: cells I−r .. I+r−2 (donor I−1); right-biased mirrors
    left_stencil = (tuple(m(r - j) for j in range(r))
                    + (c,) + tuple(p(j) for j in range(1, r - 1)))
    right_stencil = (tuple(p(r - 1 - j) for j in range(r - 1))
                     + (c,) + tuple(m(j) for j in range(1, r)))
    left = _weno_side(left_stencil, r, eps_)
    right = _weno_side(right_stencil, r, eps_)
    return left, right


def reconstruct_face(scheme, c, axis):
    """(left_biased, right_biased) face reconstructions of a centered field."""
    if isinstance(scheme, Centered):
        f = _centered_face(c, axis, scheme.order)
        return f, f
    if isinstance(scheme, UpwindBiased):
        return _upwind_faces(c, axis, scheme.order)
    if isinstance(scheme, WENO):
        return _weno_faces(c, axis, scheme.order, scheme.epsilon)
    raise TypeError(f"unsupported advection scheme {scheme!r}")


# --- fluxes and divergence ---------------------------------------------------

def _upwind_select(vel, left, right):
    return torch.where(vel > 0, left,
                       torch.where(vel < 0, right, 0.5 * (left + right)))


def advective_tracer_flux_x(grid, scheme, u, c, immersed_mask_fc=None):
    """Ax·u·ĉ at (f,c) with upwind selection by sign(u)."""
    left, right = reconstruct_face(scheme, c, 0)
    flux = grid.dy_fc * u * _upwind_select(u, left, right)
    if immersed_mask_fc is not None:
        flux = torch.where(immersed_mask_fc, 0.0, flux)
    return flux


def advective_tracer_flux_y(grid, scheme, v, c, immersed_mask_cf=None):
    left, right = reconstruct_face(scheme, c, 1)
    flux = grid.dx_cf * v * _upwind_select(v, left, right)
    if immersed_mask_cf is not None:
        flux = torch.where(immersed_mask_cf, 0.0, flux)
    return flux


def horizontal_div_Uc(grid, scheme, u, v, c, masks=None):
    """∇·(U c) at cell centers.  ``masks``: optional (peripheral_fc,
    peripheral_cf) boolean pair killing fluxes through bounded faces."""
    if scheme is None:
        return torch.zeros(grid.shape, dtype=grid.dtype, device=grid.device)
    if isinstance(scheme, FluxFormAdvection):
        sx, sy = scheme.x, scheme.y
    else:
        sx = sy = scheme
    m_fc = masks[0] if masks is not None else None
    m_cf = masks[1] if masks is not None else None
    fx = advective_tracer_flux_x(grid, sx, u, c, m_fc)
    fy = advective_tracer_flux_y(grid, sy, v, c, m_cf)
    return (dxc(fx) + dyc(fy)) / grid.az_cc


def div_Uah(grid, scheme, u, v, a, h, masks=None):
    """∇·(U ℵ h) in the flux-ratio form, each face flux the product of the
    ℵ flux over the face length and the h flux over the velocity
    (`advection.py:310-335`, mirroring the reference's `div_Uℵh`).  For API
    parity: no tendency calls it."""
    if scheme is None:
        return torch.zeros(grid.shape, dtype=grid.dtype, device=grid.device)
    if isinstance(scheme, FluxFormAdvection):
        sx, sy = scheme.x, scheme.y
    else:
        sx = sy = scheme
    m_fc = masks[0] if masks is not None else None
    m_cf = masks[1] if masks is not None else None

    fa_x = advective_tracer_flux_x(grid, sx, u, a) / grid.dy_fc
    fh_x = advective_tracer_flux_x(grid, sx, u, h)
    fx = torch.where(u == 0, 0.0, fa_x * fh_x / torch.where(u == 0, 1.0, u))
    if m_fc is not None:
        fx = torch.where(m_fc, 0.0, fx)

    fa_y = advective_tracer_flux_y(grid, sy, v, a) / grid.dx_cf
    fh_y = advective_tracer_flux_y(grid, sy, v, h)
    fy = torch.where(v == 0, 0.0, fa_y * fh_y / torch.where(v == 0, 1.0, v))
    if m_cf is not None:
        fy = torch.where(m_cf, 0.0, fy)

    return (dxc(fx) + dyc(fy)) / grid.az_cc

"""Tiled, substep-chunked αEVP loop for periodic grids above the whole-array
kernel's limit: the launcher's inputs, the CUDA kernel's wrapper and its
plain version.

Counterpart of `climaseaice_jl_tpu/dynamics/pallas_evp_tiled.py`.  The
kernel (``csrc/evp_tiled.cu``) replaces the TPU kernel ``_tiled_kernel``
(2.2), which :func:`.fused_evp.fused_split_explicit_momentum_step` runs on
doubly periodic float32 grids of more than ``fused_evp._MAX_POINTS_RICH``
points.  2.2 takes m = h·ℵ·ρ, ℵ, P and the starting velocities uⁿ, vⁿ on
interior-only arrays and derives the loop's coefficients from them in its
own forms (`pallas_evp_tiled.py:253-282`); the γ² coefficient, for one,
is cα·Δt·(1/Δx·1/Δy)/m, where 2.1's launcher forms cα·Δt/(m·Δx·Δy).  Its
per-substep algebra is 2.1's operation for operation
(`pallas_evp_tiled.py:294-366` against `pallas_evp.py:230-329`), and the
first substep of a call is substep 1 (odd substeps update v then u, even
ones u then v).  A point's value does not depend on the tile plan or the
chunk length K: the TPU kernel's tiles carry an overlap W ≥ 2K+3, which
covers the points a chunk spoils at a tile's edge.

One form differs from 2.1's: 2.2 masks the velocity forcing where the face
mass m_fc is not positive (``ok_u``), 2.1 where 1/m_fc is not positive
(``invm_u > 0``, with 1/m_fc set to 0 where m_fc ≤ 0).  The two agree for
every finite m_fc: the reciprocal of a positive finite float32 is positive
(1/FLT_MAX ≈ 2.9e-39 is a subnormal, kept on the CPU and, without
flush-to-zero, on the card); they part only where m_fc = +inf, which a
finite h·ℵ·ρ does not give.  So the plain version below derives the
coefficients in 2.2's forms and runs 2.1's plain substep loop.

:func:`tiled_evp_substeps` picks by the tensors' device: CUDA tensors go to
the kernel, CPU tensors to :func:`tiled_evp_substeps_reference`.  A CUDA
tensor never reaches the plain version; a kernel that fails to build or
launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .fused_evp import (KernelCounter, N_CARRY, _P_CALPHA, _P_CONCMIN,
                        _P_DT, _P_DX, _P_DY, _P_MASSMIN, carry_inputs, check_kernel_args,
                        cuda_error_string, describe_kernel, evp_substeps_reference,
                        periodic_params)
from .rheologies import ice_strength

N_INPUTS = 5     # m, ℵ, P, uⁿ, vⁿ

tiled_evp_counter = KernelCounter()


# --- the plain version ----------------------------------------------------------

def tiled_evp_coefficients(params, m, a, P, un, vn):
    """The twelve constants of the substep loop (:func:`.fused_evp.
    evp_substeps_reference`'s order) derived from m, ℵ, P, uⁿ, vⁿ in 2.2's
    forms and order (`pallas_evp_tiled.py:253-282`), with circular shifts."""
    p = params
    dt = p[_P_DT]
    inv_dx = 1.0 / p[_P_DX]
    inv_dy = 1.0 / p[_P_DY]
    inv_az = inv_dx * inv_dy
    c_alpha = p[_P_CALPHA]
    mass_min = p[_P_MASSMIN]
    conc_min = p[_P_CONCMIN]

    def ixf_(q):
        return 0.5 * (q + torch.roll(q, 1, 0))

    def iyf_(q):
        return 0.5 * (q + torch.roll(q, 1, 1))

    def ixyf_(q):
        t = q + torch.roll(q, 1, 1)
        return 0.25 * (t + torch.roll(t, 1, 0))

    def inv0(x):
        ok = x > 0
        return torch.where(ok, 1.0 / torch.where(ok, x, 1.0), 0.0)

    def active(mf, af):
        return ((mf >= mass_min) & (af >= conc_min)).to(mf.dtype)

    def gamma2_coefficient(mass):
        ok = mass > 0
        return torch.where(ok, c_alpha * dt * inv_az / torch.where(ok, mass, 1.0), -1.0)

    m_fc, a_fc, m_cf, a_cf = ixf_(m), ixf_(a), iyf_(m), iyf_(a)
    invm_u, invm_v = inv0(m_fc), inv0(m_cf)
    return (P, ixyf_(P), gamma2_coefficient(m), gamma2_coefficient(ixyf_(m)),
            invm_u * a_fc, invm_u, active(m_fc, a_fc), un,
            invm_v * a_cf, invm_v, active(m_cf, a_cf), vn)


def tiled_evp_substeps_reference(params, m, a, P, un, vn, carry, nsub):
    """Plain PyTorch version of the kernel: 2.2's coefficients
    (:func:`tiled_evp_coefficients`), then ``nsub`` substeps from substep 1
    on the whole interior arrays with circular shifts.  Returns the new
    (u, v, σ₁₁, σ₂₂, σ₁₂, α)."""
    return evp_substeps_reference(params, tiled_evp_coefficients(params, m, a, P, un, vn),
                                  carry, nsub)


# --- the kernel's wrapper -------------------------------------------------------

def _tiled_lib():
    lib = _build.load("evp_tiled")
    fn = lib.csi_evp_tiled_substeps
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * (1 + N_INPUTS + 2 * N_CARRY)
                       + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.csi_evp_tiled_chunk_substeps.argtypes = []
        lib.csi_evp_tiled_chunk_substeps.restype = ctypes.c_int
    return lib


def chunk_substeps():
    """The substeps one launch of the built kernel runs."""
    return _tiled_lib().csi_evp_tiled_chunk_substeps()


def describe():
    """The built kernel on the current card (:func:`.fused_evp.describe_kernel`)."""
    return describe_kernel(_tiled_lib(), "csi_evp_tiled_describe", "evp_tiled")


def tiled_evp_substeps(params, m, a, P, un, vn, carry, nsub):
    """Run ``nsub`` αEVP substeps of 2.2 on interior arrays.

    ``params``: float32[18] (:mod:`.fused_evp`'s layout); ``m``, ``a``,
    ``P``, ``un``, ``vn`` and the ``carry`` (u, v, σ₁₁, σ₂₂, σ₁₂, α): float32
    arrays of one shape.  CUDA tensors go to the CUDA kernel (one launch per
    chunk of :func:`chunk_substeps` substeps, each deriving the coefficients
    it needs from m, ℵ and P on chip), which updates the carry tensors in
    place and returns them; CPU tensors go to
    :func:`tiled_evp_substeps_reference`."""
    inputs, carry = (m, a, P, un, vn), tuple(carry)
    if len(carry) != N_CARRY:
        raise ValueError(f"expected {N_CARRY} carries")
    device = params.device
    if device.type == "cpu":
        if any(q.device != device for q in inputs + carry):
            raise ValueError("EVP tensors span devices")
        return tiled_evp_substeps_reference(params, *inputs, carry, nsub)
    if device.type != "cuda":
        raise ValueError(f"no EVP kernel for device {device}")
    nx, ny = check_kernel_args(params, inputs + carry)
    nsub = int(nsub)
    scratch = tuple(torch.empty_like(q) for q in carry)
    launches = ctypes.c_int(0)
    lib = _tiled_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.csi_evp_tiled_substeps(params.data_ptr(),
                                         *(q.data_ptr() for q in inputs + carry + scratch),
                                         nx, ny, nsub, ctypes.byref(launches), stream)
    if err != 0:
        raise RuntimeError(f"tiled EVP kernel launch failed: CUDA error {err} "
                           f"({cuda_error_string('evp_tiled', err)})")
    tiled_evp_counter.calls += 1
    tiled_evp_counter.launches += launches.value
    return carry


# --- the launcher's inputs ------------------------------------------------------

def tiled_evp_inputs(model, state, dt, u_start, v_start):
    """(params, (m, ℵ, P, uⁿ, vⁿ), carry, P_pad) of 2.2's loop: contiguous
    interiors of m = h·ℵ·ρ, ℵ, the ice strength and the starting velocities
    (`pallas_evp.py:461-466`), fresh copies of the six carried fields, and
    the padded ice strength for the state."""
    grid = model.grid
    dt = grid.scalar(dt)
    I = grid.interior
    P_pad = ice_strength(model.dynamics.rheology, state.h, state.a)
    m = state.h * state.a * grid.scalar(model.sea_ice_density)
    inputs = tuple(I(q).contiguous() for q in (m, state.a, P_pad, u_start, v_start))
    return (periodic_params(model, dt), inputs, carry_inputs(model, state, u_start, v_start),
            P_pad)

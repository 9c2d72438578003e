"""The port's EVP momentum step vs the JAX package, the fused route's gate,
the CUDA kernel vs its plain version, and the port's import boundary.

The JAX package is imported inside the tests that compare with it, so that
the CUDA test runs on a machine without JAX (``pytest --noconftest -m cuda
tests/test_torch_evp.py``)."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import climaseaice_jl_tpu_torch as cst
from climaseaice_jl_tpu_torch import model as tmodel
from climaseaice_jl_tpu_torch.convert import state_from_numpy, state_to_numpy
from climaseaice_jl_tpu_torch.dynamics import fused_evp as fe
from climaseaice_jl_tpu_torch.dynamics.fused_evp import (
    evp_counter, evp_inputs, evp_substeps, evp_substeps_reference,
    fused_available, fused_split_explicit_momentum_step)
from climaseaice_jl_tpu_torch.dynamics.fused_evp_tiled import tiled_evp_coefficients
from climaseaice_jl_tpu_torch.dynamics.momentum import split_explicit_momentum_step

REPO = pathlib.Path(__file__).resolve().parents[1]
km = 1000.0


def _build(lib, dtype, substeps=10, P_star=27.5, fused="always", size=(16, 128),
           topology=("periodic", "periodic"), **grid_kw):
    """The soft-ice configuration of tests/test_pallas_evp.py:10-33."""
    grid = lib.RectilinearGrid(size=size, x=(0, 100 * km), y=(0, 100 * km), halo=5,
                               dtype=dtype, topology=topology, **grid_kw)
    dynamics = lib.SeaIceMomentumEquation(
        rheology=lib.ElastoViscoPlasticRheology(ice_compressive_strength=P_star),
        coriolis=lib.FPlane(f=1e-4),
        top_momentum_stress={"u": 0.05, "v": 0.02},
        bottom_momentum_stress=lib.SemiImplicitStress(ue=0.1, ve=-0.05),
        solver=lib.SplitExplicitSolver(substeps=substeps, fused=fused))
    return lib.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None,
                             advection=lib.WENO(order=5), timestepper="ForwardEuler")


def _jax_state(csi, model, seed=0):
    """Initial state of test_pallas_evp.py plus a seeded velocity perturbation."""
    g = model.grid
    rng = np.random.default_rng(seed)
    x = np.asarray(g.xc)[g.Hx:g.Hx + g.Nx, None]
    y = np.asarray(g.yc)[None, g.Hy:g.Hy + g.Ny]
    h = 0.5 + 0.2 * np.sin(2 * np.pi * x / (100 * km)) * np.cos(2 * np.pi * y / (100 * km))
    return csi.initial_state(model, h=h, a=1.0,
                             u=0.02 + 0.01 * rng.standard_normal(g.interior_shape),
                             v=0.01 * rng.standard_normal(g.interior_shape))


def _rel(x, y):
    return np.abs(np.asarray(x) - np.asarray(y)).max() / max(np.abs(np.asarray(x)).max(), 1e-30)


def test_fused_plain_version_matches_pallas_interpret():
    """(a) The fused route on CPU tensors (the kernel's plain version) vs the
    JAX launcher with the Pallas kernel in interpret mode, float32, soft
    ice, 10 substeps, two successive calls.  Bars of test_pallas_evp.py:59-60
    (measured: u/v ≤ 3e-7, σ/α ≤ 1.5e-6).  Delta/zeta are skipped: neither
    route updates them."""
    import jax
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.dynamics.pallas_evp import \
        fused_split_explicit_momentum_step as jfused

    mj = _build(csi, "float32")
    mt = _build(cst, "float32", device="cpu")
    sj = _jax_state(csi, mj)
    st = state_from_numpy(mt, state_to_numpy(sj))
    step_j = jax.jit(lambda s: jfused(mj, s, 60.0, s.u, s.v, interpret=True))

    calls = evp_counter.calls
    for _ in range(2):
        sj = sj.evolve(**step_j(sj))
        st = st.evolve(**fused_split_explicit_momentum_step(mt, st, 60.0, st.u, st.v))
    assert evp_counter.calls == calls   # no kernel launch on CPU tensors

    aj, at = state_to_numpy(sj), state_to_numpy(st)
    for name, tol in (("u", 1e-4), ("v", 1e-4), ("sig11", 4e-3), ("sig22", 4e-3),
                      ("sig12", 4e-3), ("alpha", 4e-3), ("P", 1e-6),
                      ("un", 1e-4), ("vn", 1e-4)):
        assert _rel(aj[name], at[name]) <= tol, (name, _rel(aj[name], at[name]))


def test_general_path_matches_jax_float64():
    """(b) The general split-explicit path vs JAX, float64, soft ice: same
    operations in the same order, contractive regime, ≤ 1e-11."""
    import jax
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.dynamics.momentum import \
        split_explicit_momentum_step as jsplit

    mj = _build(csi, "float64", fused="never")
    mt = _build(cst, "float64", fused="never", device="cpu")
    sj = _jax_state(csi, mj, seed=1)
    st = state_from_numpy(mt, state_to_numpy(sj))
    upd_j = jax.jit(lambda s: jsplit(mj, s, 60.0, s.u, s.v))(sj)
    upd_t = split_explicit_momentum_step(mt, st, 60.0, st.u, st.v)
    assert set(upd_j) == set(upd_t)
    for name in upd_j:
        assert _rel(upd_j[name], upd_t[name].numpy()) <= 1e-11, name


def test_fused_gate_and_dispatch(monkeypatch):
    """(c) The gate takes the flagship and any periodic size (no TPU
    alignment), and refuses bounded topology and float64; fused='never'
    keeps the general path."""
    flagship = tmodel.sea_ice_model(
        cst.RectilinearGrid(size=(512, 512), x=(0, 512 * km), y=(0, 512 * km), halo=5,
                            dtype="float32", device="cpu"),
        dynamics=cst.SeaIceMomentumEquation(
            rheology=cst.ElastoViscoPlasticRheology(), coriolis=cst.FPlane(f=1.4e-4),
            top_momentum_stress={"u": 0.1, "v": 0.05},
            bottom_momentum_stress=cst.SemiImplicitStress(),
            solver=cst.SplitExplicitSolver(substeps=120)),
        ice_thermodynamics=cst.sea_ice_slab_thermodynamics(),
        top_heat_flux=-20.0, bottom_heat_flux=-5.0, advection=cst.WENO(order=7))
    assert fused_available(flagship)
    assert fused_available(_build(cst, "float32", size=(24, 40), device="cpu"))
    assert not fused_available(_build(cst, "float32", topology=("bounded", "periodic"),
                                      device="cpu"))
    assert not fused_available(_build(cst, "float64", device="cpu"))

    routes = []
    monkeypatch.setattr(tmodel, "fused_split_explicit_momentum_step",
                        lambda *a: routes.append("fused") or fused_split_explicit_momentum_step(*a))
    monkeypatch.setattr(tmodel, "split_explicit_momentum_step",
                        lambda *a: routes.append("general") or split_explicit_momentum_step(*a))
    for fused in ("auto", "always", "never"):
        m = _build(cst, "float32", substeps=2, fused=fused, device="cpu")
        tmodel.momentum_step(m, tmodel.initial_state(m, h=0.5, a=1.0), 60.0)
    assert routes == ["fused", "fused", "general"]


# params of tests/test_pallas_evp.py:120-128
_PARAMS = ((fe._P_DT, 60.), (fe._P_DX, 1000.), (fe._P_DY, 1000.), (fe._P_F, 1e-4),
           (fe._P_TAUU, 0.05), (fe._P_TAUV, 0.02), (fe._P_RC, 5.0), (fe._P_UE, 0.1),
           (fe._P_VE, -0.05), (fe._P_EINV2, 0.25), (fe._P_AMIN, 50.), (fe._P_AMAX, 300.),
           (fe._P_CALPHA, 9.87), (fe._P_DMIN, 2e-9), (fe._P_MASSMIN, 1.0),
           (fe._P_CONCMIN, 1e-3), (fe._P_REPL, 1.0))

# (K substeps a launch, TX rows, TY columns of a tile's output) of
# csrc/evp.cu's `Plan`
KERNEL_PLAN = (2, 16, 32)


def _loop_inputs(shape, seed):
    """params, the twelve constants and the six carried fields of 2.1's loop
    from the random fields of tests/test_pallas_evp.py:106-185 (numpy
    float32, the constants in 2.2's forms: any twelve arrays serve)."""
    rng = np.random.default_rng(seed)

    def mk(s=1.0, o=0.0):
        return torch.tensor(rng.random(shape).astype(np.float32) * np.float32(s)
                            + np.float32(o))

    m, a, P, un, vn = mk(500., 100.), mk(0.5, 0.5), mk(1000., 10.), mk(0.02), mk(0.02)
    carry = (un, vn, mk(0.), mk(0.), mk(0.), mk(0., 300.))
    params = torch.zeros(fe.N_PARAMS, dtype=torch.float32)
    for i, x in _PARAMS:
        params[i] = x
    return params, tiled_evp_coefficients(params, m, a, P, un, vn), carry


def _kernel_schedule(params, consts, carry, nsub, K, TX, TY, H):
    """csrc/evp.cu's schedule emulated with the plain version's phases
    (:func:`.fused_evp.evp_substep_phases`): one launch per chunk of K
    substeps (the last one shorter); each tile of TX × TY output points
    gathered with an overlap of H by periodic wrap from the twelve
    constants, u, v and σ, inside a ring of NaN that stands for what lies
    beyond the loaded tile (α is not loaded: NaN too); substep t of a chunk
    runs σ and its first update on the tile grown by 2(K − t) + 1 and its
    second update on the tile grown by 2(K − t), every value outside a
    phase's region made NaN after it; the output points are written to the
    other buffer of the ping-pong pair."""
    nx, ny = carry[0].shape
    bufs = [[q.clone() for q in carry], [torch.full_like(q, float("nan")) for q in carry]]
    o = H + 1                                  # the output's offset in a tile
    shape = (TX + 2 * o, TY + 2 * o)
    src = 0
    for k0 in range(0, nsub, K):
        nk = min(K, nsub - k0)
        dst = bufs[1 - src]
        for x0 in range(0, nx, TX):
            for y0 in range(0, ny, TY):
                ix = torch.arange(x0 - H, x0 + TX + H) % nx
                iy = torch.arange(y0 - H, y0 + TY + H) % ny

                def cut(q):
                    t = torch.full(shape, float("nan"))
                    t[1:-1, 1:-1] = q[ix][:, iy]
                    return t

                stresses, u_update, v_update = fe.evp_substep_phases(
                    params, [cut(q) for q in consts])
                u, v, s11, s22, s12 = (cut(q) for q in bufs[src][:5])

                def region(q, R):
                    out = torch.full(shape, float("nan"))
                    out[o - R:o + TX + R, o - R:o + TY + R] = q[o - R:o + TX + R,
                                                                o - R:o + TY + R]
                    return out

                for t in range(1, nk + 1):
                    R = 2 * (K - t)
                    s11, s22, s12, al = (region(q, R + 1)
                                         for q in stresses(u, v, s11, s22, s12))
                    if (k0 + t) % 2 == 0:   # even substeps: u then v
                        u = region(u_update(u, v, s11, s12, al), R + 1)
                        v = region(v_update(u, v, s22, s12, al), R)
                    else:
                        v = region(v_update(u, v, s22, s12, al), R + 1)
                        u = region(u_update(u, v, s11, s12, al), R)
                wx, wy = min(TX, nx - x0), min(TY, ny - y0)
                for d, q in zip(dst, (u, v, s11, s22, s12, al)):
                    d[x0:x0 + wx, y0:y0 + wy] = q[o:o + wx, o:o + wy]
        src = 1 - src
    return bufs[src]


@pytest.mark.parametrize("shape, seed, nsub", [((40, 70), 11, 5), ((12, 20), 12, 6)],
                         ids=["ragged-odd", "wider-than-grid"])
def test_kernel_schedule_matches_plain_version(shape, seed, nsub):
    """The CUDA kernel's schedule (its tiles with an overlap of 2K, its
    shrinking regions, its chunk length, the ping-pong buffers, α never
    read), emulated with the plain version's phases, equals the plain
    version over the whole array bitwise: on
    40×70 (ragged last tiles, 5 substeps: the last chunk is one substep)
    and 12×20 (tiles wider than the grid, periodic images inside a tile, 6
    substeps).  With the overlap one point short, the emulation parts from
    the plain version."""
    K, TX, TY = KERNEL_PLAN
    params, consts, carry = _loop_inputs(shape, seed)
    whole = evp_substeps_reference(params, consts, carry, nsub)
    tiled = _kernel_schedule(params, consts, carry, nsub, K, TX, TY, 2 * K)
    for name, w, t in zip(("u", "v", "sig11", "sig22", "sig12", "alpha"), whole, tiled):
        assert torch.equal(w, t), (name, shape)
    short = _kernel_schedule(params, consts, carry, nsub, K, TX, TY, 2 * K - 1)
    assert not all(torch.equal(w, t) for w, t in zip(whole, short))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(cuda_device):
    """(d) The CUDA kernel vs evp_substeps_reference on the same CUDA
    tensors, soft ice, 120 and 121 substeps, on a grid whose sides are not
    multiples of the kernel's tiles (ragged edges): bitwise (0 ulp; the
    kernel builds with -fmad=false and keeps the plain version's operation
    order), with one launch per chunk of K substeps."""
    m = _build(cst, "float32", substeps=120, size=(70, 45), device=cuda_device)
    rng = np.random.default_rng(2)
    s = tmodel.initial_state(m, h=0.5 + 0.1 * rng.random(m.grid.interior_shape), a=1.0,
                             u=0.02 + 0.01 * rng.standard_normal(m.grid.interior_shape))
    params, consts, carry, _ = evp_inputs(m, s, 60.0, s.u, s.v)
    K = fe.chunk_substeps()
    for nsub in (120, 121):
        ref = evp_substeps_reference(params, consts, [q.clone() for q in carry], nsub)
        evp_counter.reset()
        out = evp_substeps(params, consts, [q.clone() for q in carry], nsub)
        torch.cuda.synchronize()
        assert (evp_counter.calls, evp_counter.launches) == (1, -(-nsub // K))
        for name, a, b in zip(("u", "v", "sig11", "sig22", "sig12", "alpha"), out, ref):
            assert torch.isfinite(a).all(), name
            assert torch.equal(a, b), (nsub, name)


def _port_sources():
    return sorted((REPO / "climaseaice_jl_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax():
    """(e) No module of the port (its parallel and examples packages
    included), and not chip_smoke.py, imports jax or the JAX package: by the AST of every
    source, and by the modules a fresh interpreter holds after importing
    every module of the port."""
    def banned(name):
        return name.split(".")[0] in ("jax", "jaxlib", "climaseaice_jl_tpu")

    names = {path.name for path in _port_sources()}
    assert {"fused_evp_tiled_curvilinear.py", "fixed_tile_pointwise.py", "fixed_tile_thermo.py",
            "distributed_basin.py", "fused_evp_tiled.py", "chip_smoke.py", "stepper.py",
            "multihost.py", "launch.py", "free_drift.py", "freezing_bucket.py",
            "simple_freezing_bucket.py", "perpetual_night.py", "melting_in_spring.py",
            "freezing_of_a_lake.py", "ice_advected_by_anticyclone.py",
            "ice_advected_on_coastline.py", "arctic_basin_seasonal_cycle.py", "enthalpy.py",
            "ocean.py", "coupled.py", "diffusive_ice_column_model.py", "ice_ocean_coupled.py",
            "melting_over_dynamic_ocean.py"} <= names
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            assert not any(banned(n) for n in names), (path, names)

    code = ("import importlib, pkgutil, sys, climaseaice_jl_tpu_torch as p; "
            "[importlib.import_module(m.name) for m in "
            "pkgutil.walk_packages(p.__path__, p.__name__ + '.')]; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'climaseaice_jl_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]", out

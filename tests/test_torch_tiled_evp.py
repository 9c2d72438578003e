"""The periodic flagship above the whole-array limit: the port's tiled,
substep-chunked EVP loop (2.2, ``dynamics/fused_evp_tiled.py``) against
the JAX package's ``tiled_chunked_evp`` in interpret mode, its invariance
under the tile plan and the chunk length, the whole step through it, and
the gate that switches between 2.1 and 2.2.

The JAX package is imported inside the tests that compare with it, so that
the CUDA test runs on a machine without JAX (``pytest --noconftest -m cuda
tests/test_torch_tiled_evp.py``)."""

import numpy as np
import pytest
import torch

import climaseaice_jl_tpu_torch as cst
from climaseaice_jl_tpu_torch import model as tmodel
from climaseaice_jl_tpu_torch.convert import state_from_numpy, state_to_numpy
from climaseaice_jl_tpu_torch.dynamics import fused_evp as fe
from climaseaice_jl_tpu_torch.dynamics import fused_evp_tiled as ft

km = 1000.0
NAMES = ("u", "v", "sig11", "sig22", "sig12", "alpha")
BARS = (1e-4, 1e-4, 4e-3, 4e-3, 4e-3, 4e-3)   # tests/test_pallas_evp.py:59-60
# params of tests/test_pallas_evp.py:120-128
PARAMS = ((fe._P_DT, 60.), (fe._P_DX, 1000.), (fe._P_DY, 1000.), (fe._P_F, 1e-4),
          (fe._P_TAUU, 0.05), (fe._P_TAUV, 0.02), (fe._P_RC, 5.0), (fe._P_UE, 0.1),
          (fe._P_VE, -0.05), (fe._P_EINV2, 0.25), (fe._P_AMIN, 50.), (fe._P_AMAX, 300.),
          (fe._P_CALPHA, 9.87), (fe._P_DMIN, 2e-9), (fe._P_MASSMIN, 1.0),
          (fe._P_CONCMIN, 1e-3), (fe._P_REPL, 1.0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's PyTorch CPU work on one intra-op thread: under the
    tier-1 run's six test workers PyTorch's OpenMP pool spins while it
    waits for threads that are not scheduled (see
    tests/test_torch_fixed_tiles.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fields(shape, seed):
    """The random inputs of tests/test_pallas_evp.py:106-185 as numpy
    float32: m, ℵ, P, uⁿ, vⁿ and the six carried fields (u = uⁿ, v = vⁿ)."""
    rng = np.random.default_rng(seed)

    def mk(s=1.0, o=0.0):
        return (rng.random(shape).astype(np.float32) * np.float32(s) + np.float32(o))

    m, a, P = mk(500., 100.), mk(0.5, 0.5), mk(1000., 10.)
    un, vn = mk(0.02), mk(0.02)
    s11, s22, s12, al = mk(0.), mk(0.), mk(0.), mk(0., 300.)
    return (m, a, P, un, vn), (un, vn, s11, s22, s12, al)


def _params(device="cpu"):
    p = torch.zeros(fe.N_PARAMS, dtype=torch.float32)
    for i, x in PARAMS:
        p[i] = x
    return p.to(device)


def _torch(arrays, device="cpu"):
    return tuple(torch.tensor(q, device=device) for q in arrays)


def _rel(ref, x):
    ref, x = np.asarray(ref, np.float64), np.asarray(x, np.float64)
    return np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-30)


def _ulps(ref, x):
    def ordered(q):
        i = np.asarray(q, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(ref) - ordered(x)).max())


@pytest.mark.parametrize("shape, seed, plan", [((128, 128), 0, (8, 128, 128, 0)),
                                               ((128, 256), 1, (8, 64, 128, 64))])
def test_plain_version_matches_pallas_interpret(monkeypatch, shape, seed, plan):
    """The plain version of 2.2 against JAX's ``tiled_chunked_evp`` in
    interpret mode on the random fields of tests/test_pallas_evp.py:106-185,
    16 substeps (two chunks of 8; x-slabs at 128², 2-D tiles at 128×256),
    float32.  Bars of tests/test_pallas_evp.py:59-60.  Measured on an
    x86-64 Xeon (PyTorch's AVX512 build), relative to each field's largest
    value: u, v ≤ 5.1e-7, σ ≤ 1.7e-6, α ≤ 3.9e-6.  The largest ulp
    differences are 75 in α, 648 in u and 5,972 in v; σ₁₁, σ₂₂ and σ₁₂
    reach 1.7e6 ulp only where they cross zero.  XLA's and PyTorch's CPU
    kernels round some operations differently (PyTorch's AVX512 square
    root is not correctly rounded), and the relaxation carries the
    differences."""
    import jax.numpy as jnp
    import climaseaice_jl_tpu.dynamics.pallas_evp as pe
    import climaseaice_jl_tpu.dynamics.pallas_evp_tiled as pt

    inputs, carry = _fields(shape, seed)
    params = jnp.asarray(_params().numpy())
    monkeypatch.setattr(pt, "_plan_chunks", lambda N_, ny_, ns: plan)
    ref = pt.tiled_chunked_evp(16, params, *(jnp.asarray(q) for q in inputs + carry),
                               interpret=True)
    assert pe._P_CALPHA == fe._P_CALPHA and pe._P_REPL == fe._P_REPL
    out = ft.tiled_evp_substeps(_params(), *_torch(inputs), _torch(carry), 16)
    for name, r, o, bar in zip(NAMES, ref, out, BARS):
        r, o = np.asarray(r), o.numpy()
        assert np.isfinite(o).all(), name
        assert _rel(r, o) <= bar, (name, _rel(r, o), _ulps(r, o))


def _tiled_run(inputs, carry, nsub, K, TX, TY):
    """The plain version applied chunk by chunk to halo-extended tiles of
    TX × TY interior points gathered with periodic wrap (overlap 2K+3, as
    the TPU kernel's), keeping each tile's interior: the TPU kernel's
    contract emulated.  K even, so every chunk starts at an odd substep, as
    the plain version's first substep is."""
    nx, ny = carry[0].shape
    W = 2 * K + 3
    params = _params()
    state = list(carry)
    for _ in range(nsub // K):
        new = [torch.empty_like(q) for q in state]
        for x0 in range(0, nx, TX):
            for y0 in range(0, ny, TY):
                ix = torch.arange(x0 - W, x0 + TX + W) % nx
                iy = torch.arange(y0 - W, y0 + TY + W) % ny
                cut = [q[ix][:, iy] for q in inputs + tuple(state)]
                out = ft.tiled_evp_substeps_reference(params, *cut[:5], cut[5:], K)
                for n, o in zip(new, out):
                    n[x0:x0 + TX, y0:y0 + TY] = o[W:W + TX, W:W + TY]
        state = new
    return state


@pytest.mark.parametrize("K", [2, 4, 8])
def test_plain_version_plan_invariant(K):
    """The contract of tests/test_pallas_evp.py::test_tiled_kernel_bitwise_cross_plan
    for the plain version: chunks of K substeps on halo-extended tiles give
    interiors bitwise equal to the whole-array run, for two tilings."""
    inputs, carry = _fields((64, 128), 4)
    inputs, carry = _torch(inputs), _torch(carry)
    whole = ft.tiled_evp_substeps_reference(_params(), *inputs, carry, 16)
    for TX, TY in ((16, 32), (32, 128)):
        tiled = _tiled_run(inputs, carry, 16, K, TX, TY)
        for name, w, t in zip(NAMES, whole, tiled):
            assert torch.equal(w, t), (name, K, TX, TY)


def _reference_from(monkeypatch, first, params, inputs, carry, nsub):
    """The plain version for substeps first … first + nsub − 1, as a chunk
    of the kernel that starts there: the plain loop's substep counter
    (:func:`.fused_evp.evp_substeps_reference`'s ``range``) shifted, which
    only its parity reads."""
    import builtins
    monkeypatch.setattr(fe, "range",
                        lambda a, b: builtins.range(a + first - 1, b + first - 1),
                        raising=False)
    try:
        return ft.tiled_evp_substeps_reference(params, *inputs, carry, nsub)
    finally:
        monkeypatch.delattr(fe, "range")


def _kernel_schedule(monkeypatch, inputs, carry, nsub, K, TX, TY):
    """csrc/evp_tiled.cu's schedule emulated with the plain version: one
    launch per chunk of K substeps (the last one shorter), each tile of
    TX × TY output points gathered with an overlap of 2K by periodic wrap
    from m, ℵ, P, uⁿ, vⁿ, u, v and σ (α is not loaded: a NaN stands for
    it), its coefficients derived from the gathered m, ℵ, P alone, and its
    output points written back to the other buffer."""
    nx, ny = carry[0].shape
    H = 2 * K
    params = _params()
    state = list(carry)
    for k0 in range(0, nsub, K):
        nk = min(K, nsub - k0)
        new = [torch.empty_like(q) for q in state]
        for x0 in range(0, nx, TX):
            for y0 in range(0, ny, TY):
                ix = torch.arange(x0 - H, x0 + TX + H) % nx
                iy = torch.arange(y0 - H, y0 + TY + H) % ny
                cut = [q[ix][:, iy] for q in tuple(inputs) + tuple(state)]
                cut[-1] = torch.full_like(cut[-1], float("nan"))
                out = _reference_from(monkeypatch, k0 + 1, params, cut[:5], cut[5:], nk)
                wx, wy = min(TX, nx - x0), min(TY, ny - y0)
                for n, o in zip(new, out):
                    n[x0:x0 + wx, y0:y0 + wy] = o[H:H + wx, H:H + wy]
        state = new
    return state


# (K substeps a launch, TX rows, TY columns of a tile's output) of
# csrc/evp_tiled.cu's `Plan`
KERNEL_PLAN = (2, 32, 64)


@pytest.mark.parametrize("plan", [KERNEL_PLAN, (1, 16, 64)], ids=["kernel", "one-substep"])
@pytest.mark.parametrize("shape, seed, nsub", [((40, 96), 11, 5), ((24, 40), 12, 6)])
def test_kernel_schedule_matches_plain_version(monkeypatch, plan, shape, seed, nsub):
    """The CUDA kernel's schedule (its tiles, its chunk length, the
    coefficients derived per tile from m, ℵ, P, α never read), emulated
    with the plain version, equals the plain version over the whole array
    bitwise, in the kernel's plan and with one substep a launch on 16 × 64
    tiles: on 40×96 (ragged last tiles, 5 substeps: the kernel's plan ends
    on a short chunk) and 24×40 (tiles wider than the grid, periodic
    images inside a tile, 6 substeps)."""
    K, TX, TY = plan
    inputs, carry = _fields(shape, seed)
    inputs, carry = _torch(inputs), _torch(carry)
    whole = ft.tiled_evp_substeps_reference(_params(), *inputs, carry, nsub)
    tiled = _kernel_schedule(monkeypatch, inputs, carry, nsub, K, TX, TY)
    for name, w, t in zip(NAMES, whole, tiled):
        assert torch.equal(w, t), (name, plan, shape)


def _square(lib, fused="always", substeps=8, N=128, **grid_kw):
    """tests/test_pallas_evp.py:84's `_build_square` (soft ice), stepped by
    SplitRungeKutta3."""
    grid = lib.RectilinearGrid(size=(N, N), x=(0, 100 * km), y=(0, 100 * km), halo=5,
                               dtype="float32", topology=("periodic", "periodic"), **grid_kw)
    dynamics = lib.SeaIceMomentumEquation(
        rheology=lib.ElastoViscoPlasticRheology(ice_compressive_strength=27.5),
        coriolis=lib.FPlane(f=1e-4),
        top_momentum_stress={"u": 0.05, "v": 0.02},
        bottom_momentum_stress=lib.SemiImplicitStress(ue=0.1, ve=-0.05),
        solver=lib.SplitExplicitSolver(substeps=substeps, fused=fused))
    return lib.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None,
                             advection=lib.WENO(order=5), timestepper="SplitRungeKutta3")


def test_whole_step_matches_jax_through_tiled_route(monkeypatch):
    """One RK3 step of the 128² soft-ice square, 8 substeps, with both
    packages' ``_MAX_POINTS_RICH`` forced to 0: JAX's step through 2.2 in
    interpret mode against the port's through 2.2's plain version, from
    the same state.  Bars of tests/test_torch_evp.py, whose seeded velocity
    perturbation the state carries (measured: u, v ≤ 3.2e-7, σ ≤ 2.7e-6,
    α equal, h 1.6e-6 of the field's largest value).  From the square's own
    uniform u = 0.02, v = 0 the flow sits where Δ is a sum of cancelling
    strain terms and no two float32 formulations agree: there JAX's 2.1 and
    2.2 part by 1.3e-3 in u and 0.12 in v after one step, and the port's
    2.1 and JAX's 2.1 by as much (measured on an x86-64 CPU)."""
    import jax
    import climaseaice_jl_tpu as csi
    import climaseaice_jl_tpu.dynamics.pallas_evp as pe

    monkeypatch.setattr(pe, "_MAX_POINTS_RICH", 0)
    monkeypatch.setattr(fe, "_MAX_POINTS_RICH", 0)
    jax.clear_caches()   # identical shapes would reuse a whole-array executable
    mj = _square(csi)
    mt = _square(cst, device="cpu")

    def h0(x, y):
        return 0.5 + 0.2 * np.sin(2 * np.pi * x / (100 * km)) * np.cos(2 * np.pi * y / (100 * km))

    rng = np.random.default_rng(3)
    sj = csi.initial_state(mj, h=h0, a=1.0, u=0.02 + 0.01 * rng.standard_normal((128, 128)),
                           v=0.01 * rng.standard_normal((128, 128)))
    st = state_from_numpy(mt, state_to_numpy(sj))
    routes = []
    real_21, real_22 = fe.evp_substeps, ft.tiled_evp_substeps
    monkeypatch.setattr(fe, "evp_substeps", lambda *a: routes.append("2.1") or real_21(*a))
    monkeypatch.setattr(ft, "tiled_evp_substeps", lambda *a: routes.append("2.2") or real_22(*a))
    aj = state_to_numpy(csi.step(mj, sj, 60.0))
    at = state_to_numpy(cst.step(mt, st, 60.0))
    assert routes == ["2.2"] * 3
    for name, bar in zip(NAMES + ("h", "a"), BARS + (1e-5, 1e-5)):
        assert np.isfinite(at[name]).all(), name
        assert _rel(aj[name], at[name]) <= bar, (name, _rel(aj[name], at[name]))


def test_gate_constants_match_jax():
    """The port's switch point, tiled cap and chunk lengths are JAX's at its
    default memory limit."""
    import climaseaice_jl_tpu.dynamics.pallas_evp as pe
    import climaseaice_jl_tpu.dynamics.pallas_evp_tiled as pt

    assert fe._MAX_POINTS_RICH == 571_099 == (126 - 4) * 2 ** 20 // (56 * 4)
    assert pe.VMEM_LIMIT_MB != 126 or pe._MAX_POINTS_RICH == fe._MAX_POINTS_RICH
    assert fe._MAX_POINTS_TILED == pe._MAX_POINTS_TILED == 8192 ** 2
    assert [fe.pick_chunk(n) for n in range(1, 200)] == [pt.pick_chunk(n) for n in range(1, 200)]


def test_gate_and_dispatch(monkeypatch):
    """2.1 at or below the switch point, 2.2 above it; above it a substep
    count without a chunk length (17) or a grid above the tiled cap reaches
    neither and takes JAX's next route (the padded one here); fused='never'
    reaches neither.  The switch point is moved onto a 16×128 grid."""
    import climaseaice_jl_tpu as csi
    import climaseaice_jl_tpu.dynamics.pallas_evp as pe
    from climaseaice_jl_tpu.dynamics.pallas_evp_padded import \
        padded_fused_available as j_padded_available

    routes = []
    real_21, real_22 = fe.evp_substeps, ft.tiled_evp_substeps
    monkeypatch.setattr(fe, "evp_substeps", lambda *a: routes.append("2.1") or real_21(*a))
    monkeypatch.setattr(ft, "tiled_evp_substeps", lambda *a: routes.append("2.2") or real_22(*a))
    real_padded = tmodel.padded_fused_momentum_step
    monkeypatch.setattr(tmodel, "padded_fused_momentum_step",
                        lambda *a: routes.append("padded") or real_padded(*a))

    def route(threshold, substeps=4, fused="always", cap=fe._MAX_POINTS_TILED):
        monkeypatch.setattr(fe, "_MAX_POINTS_RICH", threshold)
        monkeypatch.setattr(fe, "_MAX_POINTS_TILED", cap)
        m = _square(cst, fused=fused, substeps=substeps, N=16, device="cpu")
        routes.clear()
        tmodel.momentum_step(m, tmodel.initial_state(m, h=0.5, a=1.0), 60.0)
        return list(routes), fe.fused_available(m)

    points = 16 * 16
    assert route(points) == (["2.1"], True)
    assert route(points - 1) == (["2.2"], True)
    assert route(points, substeps=17) == (["2.1"], True)
    assert route(points - 1, substeps=17) == (["padded"], False)
    assert route(points - 1, cap=points - 1) == (["padded"], False)
    assert route(points - 1, cap=points) == (["2.2"], True)
    assert route(points - 1, fused="never") == ([], True)

    # JAX's gate agrees on the 17-substep case and takes its padded route
    monkeypatch.setattr(pe, "_MAX_POINTS_RICH", points - 1)
    mj = _square(csi, substeps=17, N=16)
    assert not pe.fused_available(mj) and j_padded_available(mj)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(cuda_device):
    """The CUDA kernel against its plain version on the same CUDA tensors at
    256², 18 substeps (the 9 chunks of the kernel's plan leave the results
    in the scratch arrays, whose copy back is checked): bitwise.  One
    launch per chunk."""
    inputs, carry = _fields((256, 256), 5)
    params = _params(cuda_device)
    inputs, carry = _torch(inputs, cuda_device), _torch(carry, cuda_device)
    ref = ft.tiled_evp_substeps_reference(params, *inputs, carry, 18)
    ft.tiled_evp_counter.reset()
    out = ft.tiled_evp_substeps(params, *inputs, [q.clone() for q in carry], 18)
    torch.cuda.synchronize()
    K = ft.chunk_substeps()
    assert K == KERNEL_PLAN[0]
    assert (ft.tiled_evp_counter.calls, ft.tiled_evp_counter.launches) == (1, -(-18 // K))
    for name, r, o in zip(NAMES, ref, out):
        assert torch.isfinite(o).all(), name
        assert torch.equal(r, o), (name, (r - o).abs().max().item())


@pytest.mark.cuda
def test_cuda_kernel_ragged_and_small_grids(cuda_device):
    """Grids that the tiles do not divide (100×72) and grids smaller than a
    tile (12×40, whose tiles hold periodic images), 7 substeps: bitwise
    against the plain version, α's input ignored (NaN)."""
    params = _params(cuda_device)
    for shape, seed in (((100, 72), 6), ((12, 40), 7)):
        inputs, carry = _fields(shape, seed)
        inputs, carry = _torch(inputs, cuda_device), list(_torch(carry, cuda_device))
        carry[5] = torch.full_like(carry[5], float("nan"))
        ref = ft.tiled_evp_substeps_reference(params, *inputs, carry, 7)
        out = ft.tiled_evp_substeps(params, *inputs, [q.clone() for q in carry], 7)
        torch.cuda.synchronize()
        for name, r, o in zip(NAMES, ref, out):
            assert torch.equal(r, o), (shape, name, (r - o).abs().max().item())

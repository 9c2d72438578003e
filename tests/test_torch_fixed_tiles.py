"""The decomposition-invariant fixed-tile mode in the port vs the JAX
package: ``SplitExplicitSolver(fixed_tiles=…)`` on rectilinear grids, with
the plain versions of its four kernels (EVP coefficients, the tiled EVP
loop, the fixed-tile advection and the column thermodynamics) against the
Pallas kernels in interpret mode, the gates and the dispatch, the whole
step, and the halo-5 against halo-19 bitwise contract.

The JAX package is imported inside the tests that compare with it, so that
the CUDA tests run on a machine without JAX (``pytest --noconftest -m cuda
tests/test_torch_fixed_tiles.py``)."""

import numpy as np
import pytest
import torch

import climaseaice_jl_tpu_torch as cst
from climaseaice_jl_tpu_torch import model as tmodel
from climaseaice_jl_tpu_torch.convert import state_from_numpy, _FIELDS
from climaseaice_jl_tpu_torch.dynamics import fixed_tile_advection as tadv
from climaseaice_jl_tpu_torch.dynamics import fused_evp_padded as tpad
from climaseaice_jl_tpu_torch.dynamics import fused_evp_tiled_padded as ttiled
from climaseaice_jl_tpu_torch.forcing_utils import FieldTimeSeries
from climaseaice_jl_tpu_torch.thermodynamics import fixed_tile_thermo as tthermo

km = 1000.0
DAY = 86400.0
SIZE = (48, 128)     # TY = 128 is the smallest y tile the JAX gate takes
FIELDS = ("u", "v", "h", "a", "sig11", "sig22", "sig12", "alpha")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's PyTorch CPU work on one intra-op thread.  The tier-1
    run puts six test workers on the machine's cores, and PyTorch's OpenMP
    pool spins while it waits for threads that are not scheduled: under
    that load the plain tile emulation ran hundreds of times slower with
    the default pool than with one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grid(lib, topology=("bounded", "bounded"), land=True, halo=5, size=SIZE, **kw):
    Nx, Ny = size
    g = lib.RectilinearGrid(size=size, x=(0, 2 * km * Nx), y=(0, 2 * km * Ny), halo=halo,
                            dtype="float32", topology=topology, **kw)
    if land:
        x = (np.arange(Nx) + 0.5) * 2 * km
        y = (np.arange(Ny) + 0.5) * 2 * km
        xc, yc = np.meshgrid(x, y, indexing="ij")
        g = lib.ImmersedBoundaryGrid(g, (xc - 0.45 * Nx * 2 * km) ** 2
                                     + (yc - 0.55 * Ny * 2 * km) ** 2 < (0.2 * Nx * 2 * km) ** 2)
    return g


def _model(lib, topology=("bounded", "bounded"), land=True, halo=5, fixed=(8, 128),
           P_star=27.5, substeps=8, timestepper="SplitRungeKutta3", advection="weno7",
           thermo=True, device=None, **model_kw):
    kw = {} if device is None else dict(device=device)
    g = _grid(lib, topology, land, halo, **kw)
    dyn = lib.SeaIceMomentumEquation(
        rheology=lib.ElastoViscoPlasticRheology(ice_compressive_strength=P_star),
        coriolis=lib.FPlane(f=1.4e-4), top_momentum_stress={"u": 0.1, "v": 0.05},
        bottom_momentum_stress=lib.SemiImplicitStress(),
        immersed_drag=lib.ImmersedDrag(coefficient=1e-3) if land else None,
        solver=lib.SplitExplicitSolver(substeps=substeps, fused="always",
                                       halo_exchange="wide", fixed_tiles=fixed))
    adv = lib.WENO(order=7) if advection == "weno7" else advection
    if thermo:
        model_kw.setdefault("top_heat_flux", -20.0)
        model_kw.setdefault("bottom_heat_flux", -5.0)
    return lib.sea_ice_model(
        g, dynamics=dyn, advection=adv, timestepper=timestepper,
        ice_thermodynamics=lib.sea_ice_slab_thermodynamics() if thermo else None, **model_kw)


def _initial(lib, model, seed=0, **kw):
    rng = np.random.default_rng(seed)
    shape = model.grid.interior_shape
    h = 1.0 + 0.25 * rng.random(shape)
    u, v = 0.05 * rng.standard_normal(shape), 0.05 * rng.standard_normal(shape)
    if lib is cst:
        h, u, v = (torch.tensor(q, dtype=torch.float32, device=model.grid.device)
                   for q in (h, u, v))
    return lib.initial_state(model, h=h, a=0.95, u=u, v=v, **kw)


def _to_port(mt, sj):
    arrays = {n: np.asarray(getattr(sj, n)) for n in _FIELDS
              if getattr(sj, n, None) is not None}
    arrays["time"] = np.asarray(sj.clock.time)
    arrays["iteration"] = np.asarray(sj.clock.iteration)
    return state_from_numpy(mt, arrays)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(b - a).max() / max(np.abs(a).max(), 1e-30)


def _interior(grid, q):
    q = q.detach().cpu().numpy() if isinstance(q, torch.Tensor) else np.asarray(q)
    return q[grid.Hx:grid.Hx + grid.Nx, grid.Hy:grid.Hy + grid.Ny]


# --- the solver's fields and the gates ----------------------------------------------

def test_solver_fields():
    """halo_exchange and fixed_tiles as in the JAX package, validated."""
    s = cst.SplitExplicitSolver(8, halo_exchange="wide", fixed_tiles=[8, 128])
    assert s.fixed_tiles == (8, 128) and s.halo_exchange == "wide"
    assert cst.SplitExplicitSolver().halo_exchange == "per_substep"
    assert cst.SplitExplicitSolver().fixed_tiles is None
    assert cst.SplitExplicitSolver(fixed_tiles=(16, None)).fixed_tiles == (16, None)
    for bad in (dict(halo_exchange="never"), dict(fixed_tiles=(8,)),
                dict(fixed_tiles=(0, 128)), dict(fixed_tiles=(8, "a"))):
        with pytest.raises(ValueError):
            cst.SplitExplicitSolver(**bad)


GATE_CASES = {
    "slice": dict(),
    "periodic-x": dict(topology=("periodic", "bounded"), land=False),
    "ty-none": dict(fixed=(16, None)),
    "tx-indivisible": dict(fixed=(40, 128)),
    "ty-lanes": dict(fixed=(8, 64)),
    "prime-substeps": dict(substeps=17),
    "upwind3-halo2": dict(advection="upwind3", halo=2),
    "not-fixed": dict(fixed=None),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gates_match_jax(case):
    """tiled_padded_available and fixed_tile_advection_available decide as
    the JAX gates do (the JAX VMEM and device-memory budgets are far from
    binding at these sizes)."""
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.dynamics import pallas_advection as jadv
    from climaseaice_jl_tpu.dynamics import pallas_evp_tiled_padded as jtiled
    kw = dict(GATE_CASES[case])
    adv = kw.pop("advection", "weno7")
    mj = _model(csi, thermo=False, advection=csi.UpwindBiased(order=3)
                if adv == "upwind3" else "weno7", **kw)
    mt = _model(cst, thermo=False, advection=cst.UpwindBiased(order=3)
                if adv == "upwind3" else "weno7", device="cpu", **kw)
    assert ttiled.tiled_padded_available(mt) == jtiled.tiled_padded_available(mj)
    assert (tadv.fixed_tile_advection_available(mt)
            == jadv.fixed_tile_advection_available(mj))


def test_fixed_tiles_refused_on_array_metric_grids():
    """fixed_tiles on a grid with array metrics builds and takes the pinned
    curvilinear route, which refuses it only where its single-trigger-tile
    wall rule does (two y tiles on a band with a north wall); no fixed-tile
    route leaves it to the general path silently."""
    from climaseaice_jl_tpu_torch.dynamics import fused_evp_tiled_curvilinear as ttc
    for Ny, takes in ((32, True), (128, False)):
        g = cst.LatitudeLongitudeGrid((48, Ny), latitude=(50.0, 80.0), halo=5,
                                      dtype="float32", topology=("periodic", "bounded"),
                                      device="cpu")
        dyn = cst.SeaIceMomentumEquation(
            solver=cst.SplitExplicitSolver(8, fixed_tiles=(8, 128)))
        m = cst.sea_ice_model(g, dynamics=dyn, advection=cst.WENO(order=7))
        assert ttc.tiled_curvilinear_available(m) is takes
        assert not ttiled.tiled_padded_available(m)


# --- 2.4: the EVP coefficients --------------------------------------------------------

@pytest.mark.parametrize("topology", [("bounded", "bounded"), ("periodic", "bounded")],
                         ids=["bounded", "periodic-x"])
def test_prep_matches_jax(topology):
    """The plain version of the coefficient kernel against
    `_fixed_tile_prepare` (interpret mode) at every padded point, halos
    included: the activity masks equal, the other eight arrays within 4e-4
    relative; and against a float32 emulation of the same operations (numpy
    with IEEE division, torch's exp): equal bitwise.  The interpret-mode
    kernel does not divide correctly rounded on the CPU (its 1/m is up to 1
    ulp off, 2 ulp in the drags), and in one of many runs, a full run of
    the suite under load, one of its P, Pff or gcc was 471 ulp (5.6e-5) off the
    port's, in no other; the cause was not found, and 4e-4 is the precision
    of a hardware reciprocal estimate (1.5·2⁻¹²)."""
    import jax.numpy as jnp
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.dynamics.pallas_evp_padded import _fixed_tile_prepare
    mj = _model(csi, topology, land=topology[0] == "bounded")
    mt = _model(cst, topology, land=topology[0] == "bounded", device="cpu")
    sj = csi.initial_state(mj, h=1.0 + 0.25 * np.random.default_rng(1).random(SIZE), a=0.9)
    st = _to_port(mt, sj)
    ref = _fixed_tile_prepare(mj, sj.h, sj.a, jnp.asarray(40.0, jnp.float32))
    prm = tpad.evp_prep_params(mt, mt.grid.scalar(40.0))
    out = [q.numpy() for q in tpad.evp_prep_reference(prm, st.h, st.a, mt.grid)]
    assert len(out) == len(ref) == tpad.N_PREP_OUT
    names = ("P", "Pff", "gcc", "gff", "drag_u", "invm_u", "act_u", "drag_v", "invm_v",
             "act_v")
    for name, a, b in zip(names, ref, out):
        a = np.asarray(a)
        if name in ("act_u", "act_v"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=4e-4, atol=0, err_msg=name)

    # the same operations in float32 numpy, from the images of the port's gather
    g = mt.grid
    rho, Pstar, Chard, cadt, az, _, _ = (np.float32(x) for x in prm.numpy())
    ex = tpad._prep_sources(g.nxp, g.Nx, g.Hx, topology[0] == "periodic", "cpu").numpy()
    ey = tpad._prep_sources(g.nyp, g.Ny, g.Hy, False, "cpu").numpy()
    m = (st.h.numpy() * st.a.numpy() * rho)[ex][:, ey]
    ae = st.a.numpy()[ex][:, ey]
    he = st.h.numpy()[ex][:, ey]
    P = Pstar * he * torch.exp(torch.from_numpy(-Chard * (np.float32(1) - ae))).numpy()
    half = np.float32(0.5)
    m_cc, m_fc, m_cf = m[1:, 1:], half * (m[1:, 1:] + m[:-1, 1:]), half * (m[1:, 1:] + m[1:, :-1])
    m_ff = half * (half * (m[1:, 1:] + m[1:, :-1]) + half * (m[:-1, 1:] + m[:-1, :-1]))
    a_fc, a_cf = half * (ae[1:, 1:] + ae[:-1, 1:]), half * (ae[1:, 1:] + ae[1:, :-1])
    with np.errstate(divide="ignore"):
        expect = dict(gcc=np.where(m_cc > 0, cadt / (m_cc * az), -1),
                      gff=np.where(m_ff > 0, cadt / (m_ff * az), -1),
                      invm_u=np.where(m_fc > 0, np.float32(1) / m_fc, 0),
                      invm_v=np.where(m_cf > 0, np.float32(1) / m_cf, 0))
    expect["P"] = P[1:, 1:]
    expect["Pff"] = half * (half * (P[1:, 1:] + P[1:, :-1]) + half * (P[:-1, 1:] + P[:-1, :-1]))
    expect["drag_u"] = expect["invm_u"] * a_fc
    expect["drag_v"] = expect["invm_v"] * a_cf
    for name, b in zip(names, out):
        if name in expect:
            np.testing.assert_array_equal(b, expect[name].astype(np.float32), err_msg=name)


def _prep_case(case, P_star=27.5):
    """h and ℵ for 2.4 at varied values (some ℵ below the minimum
    concentration, h = 0 on land): the file's bounded + island slice, its
    periodic-x slice without land, and shard (1, 1) of a (2, 2) mesh of the
    periodic island with halo 13, where no direction wraps (split)."""
    from test_torch_immersed import _shard_model
    kw = dict(P_star=P_star, device="cpu")
    if case == "periodic-x":
        m = _model(cst, topology=("periodic", "bounded"), land=False, **kw)
    elif case == "split":
        m = _model(cst, topology=("periodic", "periodic"), halo=13, **kw)
    else:
        m = _model(cst, **kw)
    rng = np.random.default_rng(4)
    shape = m.grid.interior_shape
    s = cst.initial_state(m, h=torch.tensor(1.0 + 0.5 * rng.random(shape), dtype=torch.float32),
                          a=torch.tensor(rng.random(shape), dtype=torch.float32))
    if case == "split":
        m, s = _shard_model(m, s, (1, 1), 13)
    g = m.grid
    assert tadv._wraps(g, 0) == (case == "periodic-x") and not tadv._wraps(g, 1)
    return m, s


def _prep_schedule(prm, h, a, grid, per=(None, None), halo=1):
    """2.4's block schedule (csrc/evp_prep.cu) emulated on the CPU: per
    block of PREP_TILE outputs, the (BY + halo) × (BX + halo) tile of h and
    ℵ at the kernel's images (the remainder only in a wrapped direction's
    halo, the ragged edge read at the last row or column), NaN beyond the
    tile, m and P once a tile point, and the ten outputs in the kernel's
    operation order, act_u and act_v zero where the peripheral masks are
    set."""
    BY, BX = tpad.PREP_TILE
    rho, Pstar, Chard, cadt, az, mass_min, conc_min = prm
    wx, wy = tadv._wraps(grid, 0), tadv._wraps(grid, 1)

    def image(k, ext, H, N, wrap):
        k = np.minimum(k, ext - 1)
        if wrap:
            return np.where((k >= H) & (k < H + N), k, H + np.mod(k - H, N))
        return np.clip(k, 0, ext - 1)

    out = torch.full((tpad.N_PREP_OUT,) + grid.shape, float("nan"))
    for i0 in range(0, grid.nxp, BY):
        for j0 in range(0, grid.nyp, BX):
            rows = image(np.arange(i0 - 1, i0 + BY), grid.nxp, grid.Hx, grid.Nx, wx)
            cols = image(np.arange(j0 - 1, j0 + BX), grid.nyp, grid.Hy, grid.Ny, wy)
            ht, at = h[rows][:, cols].clone(), a[rows][:, cols].clone()
            for q in (ht, at):
                q[:1 - halo] = float("nan")
                q[:, :1 - halo] = float("nan")
            m = ht * at * rho
            P = Pstar * ht * torch.exp(-Chard * (1.0 - at))

            def ff(q):
                return 0.5 * (0.5 * (q[1:, 1:] + q[1:, :-1]) + 0.5 * (q[:-1, 1:] + q[:-1, :-1]))

            m_cc = m[1:, 1:]
            m_fc, a_fc = 0.5 * (m_cc + m[:-1, 1:]), 0.5 * (at[1:, 1:] + at[:-1, 1:])
            m_cf, a_cf = 0.5 * (m_cc + m[1:, :-1]), 0.5 * (at[1:, 1:] + at[1:, :-1])
            m_ff = ff(m)
            invm_u = torch.where(m_fc > 0, 1.0 / m_fc, 0.0)
            invm_v = torch.where(m_cf > 0, 1.0 / m_cf, 0.0)
            ni, nj = min(BY, grid.nxp - i0), min(BX, grid.nyp - j0)
            act = []
            for mq, aq, mask in ((m_fc, a_fc, per[0]), (m_cf, a_cf, per[1])):
                ok = (mq >= mass_min) & (aq >= conc_min)
                if mask is not None:
                    ok = ok & ~torch.nn.functional.pad(mask[i0:i0 + ni, j0:j0 + nj],
                                                       (0, BX - nj, 0, BY - ni))
                act.append(ok.to(torch.float32))
            vals = (P[1:, 1:], ff(P), torch.where(m_cc > 0, cadt / (m_cc * az), -1.0),
                    torch.where(m_ff > 0, cadt / (m_ff * az), -1.0), invm_u * a_fc, invm_u,
                    act[0], invm_v * a_cf, invm_v, act[1])
            for k, q in enumerate(vals):
                out[k, i0:i0 + ni, j0:j0 + nj] = q[:ni, :nj]
    return out.unbind(0)


@pytest.mark.parametrize("case", ["bounded-island", "periodic-x", "split"])
def test_prep_schedule_matches_plain_version(case):
    """2.4's block schedule, emulated on the CPU as the kernel tiles it,
    equals evp_prep_reference bitwise over the whole padded arrays, and with
    the peripheral masks evp_prep's masked act_u, act_v."""
    m, s = _prep_case(case)
    g = m.grid
    prm = tpad.evp_prep_params(m, g.scalar(120.0))
    ref = tpad.evp_prep_reference(prm, s.h, s.a, g)
    out = _prep_schedule(prm, s.h, s.a, g)
    for k, (r, o) in enumerate(zip(ref, out)):
        assert torch.equal(r.view(torch.int32), o.view(torch.int32)), (case, k)
    masks = (m.masks.per_fc, m.masks.per_cf)
    assert masks[0].any() or case == "periodic-x"
    ref = tpad.evp_prep(m, g.scalar(120.0), s.h, s.a, g, *masks)
    out = _prep_schedule(prm, s.h, s.a, g, per=masks)
    for k, (r, o) in enumerate(zip(ref, out)):
        assert torch.equal(r.view(torch.int32), o.view(torch.int32)), (case, "masked", k)


@pytest.mark.parametrize("case", ["bounded-island", "split"])
def test_prep_schedule_needs_its_halo(case):
    """One point short of the tile's halo, the emulated schedule reads NaN
    at the i−1 and j−1 neighbours of each block's first row and column."""
    m, s = _prep_case(case)
    g = m.grid
    prm = tpad.evp_prep_params(m, g.scalar(120.0))
    ref = tpad.evp_prep_reference(prm, s.h, s.a, g)
    out = _prep_schedule(prm, s.h, s.a, g, halo=0)
    assert torch.isnan(out[1]).any()
    assert not all(torch.equal(r.view(torch.int32), o.view(torch.int32))
                   for r, o in zip(ref, out))


@pytest.mark.parametrize("case, P_star", [("bounded-island", 27.5), ("periodic-x", 27500.0),
                                          ("split", 27.5)])
def test_prep_plan_rounds_as_the_device_params(case, P_star):
    """The coefficient kernel's parameters rounded on the host (the model's
    PrepPlan) are evp_prep_params' values bitwise, c_α·Δt, which the kernel
    forms, the same float32 product at every Δt; the plan is made once per
    model."""
    m, _ = _prep_case(case, P_star)
    plan = tpad.prep_plan(m)
    assert tpad.prep_plan(m) is plan
    for dt in (40.0, 120.0, 600.0 / 7):
        dt = m.grid.scalar(dt)
        want = tpad.evp_prep_params(m, dt)
        host = [np.float32(v) for v in plan.values]
        host[3] = host[3] * np.float32(dt.item())
        assert np.array_equal(np.array(host, np.float32).view(np.int32),
                              want.numpy().view(np.int32))
        assert list(plan.array) == list(plan.values)


# --- 2.5: the tiled EVP loop ---------------------------------------------------------

@pytest.mark.parametrize("case", ["bounded-island", "periodic-x"])
def test_tiled_evp_matches_jax(case):
    """The plain version of the tiled kernel (through its launcher) against
    `tiled_padded_momentum_step` in interpret mode, soft ice (P★ = 27.5), 8
    substeps: u/v ≤ 1e-4, σ/α ≤ 4e-3 of the field's largest value over the
    interior."""
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.dynamics.pallas_evp_tiled_padded import tiled_padded_momentum_step
    kw = (dict() if case == "bounded-island"
          else dict(topology=("periodic", "bounded"), land=False))
    mj, mt = _model(csi, **kw), _model(cst, device="cpu", **kw)
    sj = _initial(csi, mj)
    st = _to_port(mt, sj)
    ref = tiled_padded_momentum_step(mj, sj, 120.0, sj.u, sj.v, interpret=True)
    out = ttiled.tiled_padded_momentum_step(mt, st, 120.0, st.u, st.v)
    for name, bar in zip(("u", "v", "sig11", "sig22", "sig12", "alpha"),
                         (1e-4, 1e-4, 4e-3, 4e-3, 4e-3, 4e-3)):
        a, b = _interior(mt.grid, ref[name]), _interior(mt.grid, out[name])
        assert np.isfinite(b).all(), name
        assert _rel(a, b) <= bar, (name, _rel(a, b))


def test_tiled_evp_plan_invariant():
    """The plain version gives bitwise-equal interiors for 2-D tiles and
    y-spanning slabs, and for chunks of 8, 4 and 2 substeps."""
    m = _model(cst, device="cpu")
    s = _initial(cst, m)
    params, consts, carry, _ = tpad.padded_evp_inputs(m, s, 120.0, s.u, s.v)
    runs = [ttiled.tiled_padded_evp_substeps_reference(params, consts, carry, 8, m.grid,
                                                       plan, K=K)
            for plan, K in (((8, 128), None), ((16, None), 4), ((24, 128), 2))]
    for name, a, b, c in zip(("u", "v", "sig11", "sig22", "sig12", "alpha"), *runs):
        for other in (b, c):
            assert np.array_equal(_interior(m.grid, a), _interior(m.grid, other)), name


# csrc/evp_tiled_padded.cu's plan: (K substeps a launch, TX rows, TY columns
# of a tile's output)
KERNEL_PLAN_25 = (2, 16, 32)


def _interior_tiles(ext, H, N, kind, T, O):
    """csrc/evp_tiled_padded.cu's InteriorGeometry along one direction, in
    the form of tests/test_torch_immersed.py's `_torus_tiles`: tiles of the
    carried extent in interior coordinates (the padded extent along a split
    direction), carried fields at their interior images, constants at their
    padded images, and the gated wall fills."""
    split = kind == tpad.KIND_SPLIT
    lo, n = (-H, N + 2 * H) if split else (0, N)
    wall = kind == tpad.KIND_BOUNDED and H > 0
    tiles = []
    for b in range(-(-n // T)):
        o0 = lo + b * T
        g = np.arange(o0 - O, o0 + T + O)
        if split:
            ld = np.clip(g + H, 0, ext - 1)
        else:
            ld = H + (g % N if kind == tpad.KIND_PERIODIC else np.clip(g, 0, N - 1))
        cs = H + g % N if kind == tpad.KIND_PERIODIC else np.clip(g + H, 0, ext - 1)
        zero = wall & ((g < 0) | (g >= N))
        tiles.append(dict(ld=ld, ldF=np.where(zero, -1, ld), ldC=ld, cs=cs, zero=zero,
                          dF=np.zeros_like(g), dC=np.clip(g, 0, N - 1) - g if wall
                          else np.zeros_like(g),
                          out=np.where((g >= o0) & (g < min(o0 + T, lo + n)), H + g, -1)))
    return tiles


def _schedule_inputs(case, nsub):
    """2.5's loop inputs at the default P★ in thin ice with a near-uniform
    drift (tests/test_torch_immersed.py's state, where the σ relaxation's
    clamps leave every dependency showing in the bits): the file's bounded
    + island + drag and periodic-x cases, the island on 40×100 (ragged last
    tiles along both directions), and shard (1, 1) of a (2, 2) mesh of the
    periodic island with the wide halo 2·nsub + 3 ("split")."""
    from test_torch_immersed import _shard_model
    kw = dict(P_star=27500.0, substeps=nsub, device="cpu")
    if case == "periodic-x":
        m = _model(cst, topology=("periodic", "bounded"), land=False, **kw)
    elif case == "ragged":
        m = _model(cst, **kw)
        m = m.evolve(grid=_grid(cst, size=(40, 100), device="cpu"))
        m = cst.sea_ice_model(m.grid, dynamics=m.dynamics, advection=m.advection,
                              timestepper="SplitRungeKutta3", ice_thermodynamics=None)
    elif case == "split":
        m = _model(cst, topology=("periodic", "periodic"), halo=2 * nsub + 3, **kw)
    else:
        m = _model(cst, **kw)
    rng = np.random.default_rng(2)
    shape = m.grid.interior_shape
    s = cst.initial_state(m, h=torch.tensor(0.5 + 0.1 * rng.random(shape), dtype=torch.float32),
                          a=1.0, u=torch.tensor(0.02 + 0.01 * rng.standard_normal(shape),
                                                dtype=torch.float32),
                          v=torch.tensor(0.01 * rng.standard_normal(shape), dtype=torch.float32))
    if case == "split":
        m, s = _shard_model(m, s, (1, 1), 2 * nsub + 3)
    return m, tpad.padded_evp_inputs(m, s, 120.0, s.u, s.v)[:3]


def _emulate_25(m, params, consts, carry, nsub, O):
    from test_torch_immersed import _tile_schedule
    K, TX, TY = KERNEL_PLAN_25
    g = m.grid
    kx, ky = tpad.direction_kinds(g)
    return _tile_schedule(params, consts, [q.clone() for q in carry], nsub, K, O,
                          _interior_tiles(g.nxp, g.Hx, g.Nx, kx, TX, O),
                          _interior_tiles(g.nyp, g.Hy, g.Ny, ky, TY, O))


@pytest.mark.parametrize("case, nsub", [("bounded-island", 5), ("periodic-x", 6),
                                        ("ragged", 5), ("split", 5)])
def test_kernel_schedule_matches_plain_version(case, nsub):
    """2.5's schedule (csrc/evp_tiled_padded.cu's plan in interior
    coordinates: its tiles, its K, its regions, α never loaded, the gated
    wall fills as displacements to a source), emulated with the plain
    version's phase functions (tests/test_torch_immersed.py's
    `_tile_schedule`), equals tiled_padded_evp_substeps_reference's
    interiors bitwise.  Along a split direction the halo band goes stale from the padded edge and
    depends on the chunk length, so only the interiors are compared."""
    m, (params, consts, carry) = _schedule_inputs(case, nsub)
    K = KERNEL_PLAN_25[0]
    tiles = (8, 128) if case != "ragged" else (8, None)
    ref = ttiled.tiled_padded_evp_substeps_reference(params, consts, carry, nsub, m.grid,
                                                     tiles)
    out = _emulate_25(m, params, consts, carry, nsub, 2 * K)
    for name, r, o in zip(("u", "v", "sig11", "sig22", "sig12", "alpha"), ref, out):
        assert np.array_equal(_interior(m.grid, r), _interior(m.grid, o)), (case, name)


@pytest.mark.parametrize("case", ["bounded-island", "split"])
def test_kernel_schedule_needs_its_overlap(case):
    """One position short of the overlap 2K, the schedule parts from the
    plain version's interiors."""
    nsub = 5
    m, (params, consts, carry) = _schedule_inputs(case, nsub)
    ref = ttiled.tiled_padded_evp_substeps_reference(params, consts, carry, nsub, m.grid,
                                                     (8, 128))
    out = _emulate_25(m, params, consts, carry, nsub, 2 * KERNEL_PLAN_25[0] - 1)
    assert not all(np.array_equal(_interior(m.grid, r), _interior(m.grid, o))
                   for r, o in zip(ref, out))


# --- 2.9: the fixed-tile advection -----------------------------------------------------

def _check_div(mj, mt, sj, out, tracer):
    """Interiors of the port's fixed-tile divergence ``out`` of ``tracer``
    against the JAX general path, ≤ 1e-6 of the largest value, and against
    `make_fixed_tile_div` in interpret mode, ≤ 1e-4.  The interpret-mode
    kernel itself departs from the general path by up to 6e-5 of the
    largest value on these fields (measured), where the port's plain
    version stays within 2e-7: float32 WENO smoothness indicators cancel,
    so their rounding moves the weights."""
    from climaseaice_jl_tpu.advection import horizontal_div_Uc
    from climaseaice_jl_tpu.dynamics.pallas_advection import make_fixed_tile_div
    g = mt.grid
    c = getattr(sj, tracer)
    general = horizontal_div_Uc(mj.grid, mj.advection, sj.u, sj.v, c,
                                masks=(mj.masks.per_fc, mj.masks.per_cf))
    fixed = make_fixed_tile_div(mj, sj.u, sj.v)(c)
    b = _interior(g, out)
    assert _rel(_interior(g, general), b) <= 1e-6, (tracer, _rel(_interior(g, general), b))
    assert _rel(_interior(g, fixed), b) <= 1e-4, (tracer, _rel(_interior(g, fixed), b))


def test_advection_matches_jax_uniform():
    """The plain version on the bounded grid with land, WENO-7, for h and ℵ
    (bars of :func:`_check_div`)."""
    import climaseaice_jl_tpu as csi
    mj, mt = _model(csi), _model(cst, device="cpu")
    sj = _initial(csi, mj)
    st = _to_port(mt, sj)
    div_t = tadv.make_fixed_tile_div(mt, st.u, st.v)
    for name in ("h", "a"):
        _check_div(mj, mt, sj, div_t(getattr(st, name)), name)


@pytest.mark.parametrize("schemes", ["weno5", "upwind-centered"])
def test_advection_matches_jax_array_metrics(schemes):
    """The plain version on a latitude-longitude band (array metrics):
    WENO-5, and a FluxFormAdvection of UpwindBiased(5) in x and Centered(2)
    in y (bars of :func:`_check_div`)."""
    import climaseaice_jl_tpu as csi

    def build(lib, **kw):
        g = lib.LatitudeLongitudeGrid((48, 128), latitude=(50.0, 80.0), halo=5,
                                      dtype="float32", topology=("periodic", "bounded"), **kw)
        adv = (lib.WENO(order=5) if schemes == "weno5" else
               lib.FluxFormAdvection(x=lib.UpwindBiased(order=5), y=lib.Centered(order=2)))
        solver = lib.SplitExplicitSolver(8, fixed_tiles=(8, 128) if lib is csi else None)
        return lib.sea_ice_model(g, dynamics=lib.SeaIceMomentumEquation(solver=solver),
                                 advection=adv, ice_thermodynamics=None)

    mj, mt = build(csi), build(cst, device="cpu")
    sj = _initial(csi, mj, seed=3)
    st = _to_port(mt, sj)
    g = mt.grid
    metrics = tuple(g.scalar(getattr(g, n)).expand(g.shape) for n in ("dy_fc", "dx_cf", "az_cc"))
    out = tadv.fixed_tile_div(g, tadv._schemes(mt.advection), st.u, st.v, st.h,
                              (mt.masks.per_fc, mt.masks.per_cf), metrics)
    _check_div(mj, mt, sj, out, "h")


# 2.9's tile kernel (csrc/advection_fixed.cu): TX rows and TY columns a tile
KERNEL_TILE_29 = (16, 32)
_RADIUS = {(tadv.WENO, 5): 3, (tadv.WENO, 7): 4, (tadv.WENO, 9): 5, (tadv.UpwindBiased, 1): 1,
           (tadv.UpwindBiased, 3): 2, (tadv.UpwindBiased, 5): 3, (tadv.UpwindBiased, 7): 4,
           (tadv.Centered, 2): 1, (tadv.Centered, 4): 2}   # a face reads c(I + k), −R ≤ k < R


def _tile_schedule(grid, schemes, u, v, c, masks, metrics, widen=0):
    """2.9's tile kernel emulated with the plain version's operations: per
    TX × TY tile, c gathered at the images of the tile widened by each
    scheme's radius (+ ``widen``) and everything beyond set to NaN, the
    plain reconstructions at the tile's (TX+1)×TY x faces and TX×(TY+1) y
    faces, the upwind select, the products with the metrics and the masks
    at each face's images, and each point's divergence from its faces."""
    from climaseaice_jl_tpu_torch.advection import reconstruct_face, _upwind_select
    TX, TY = KERNEL_TILE_29
    sx, sy = schemes
    RX = _RADIUS[type(sx), sx.order] + widen
    RY = _RADIUS[type(sy), sy.order] + widen
    PAD = 6                        # NaN beyond the widened tile, wider than any stencil
    wx, wy = tadv._wraps(grid, 0), tadv._wraps(grid, 1)

    def ex(a, b):                  # images of padded rows a … b − 1 (the kernel's image())
        k = torch.arange(a, b)
        return grid.Hx + torch.remainder(k - grid.Hx, grid.Nx) if wx else k.clamp(0, grid.nxp - 1)

    def ey(a, b):
        k = torch.arange(a, b)
        return grid.Hy + torch.remainder(k - grid.Hy, grid.Ny) if wy else k.clamp(0, grid.nyp - 1)

    arr = len(metrics) == 3
    out = torch.full(grid.shape, float("nan"))
    for i0 in range(0, grid.nxp, TX):
        for j0 in range(0, grid.nyp, TY):
            rows, cols = ex(i0 - RX, i0 + TX + RX), ey(j0 - RY, j0 + TY + RY)
            block = torch.full((TX + 2 * RX + 2 * PAD, TY + 2 * RY + 2 * PAD), float("nan"))
            block[PAD:-PAD, PAD:-PAD] = c[rows][:, cols]
            fr, fc = ex(i0, i0 + TX + 1), ey(j0, j0 + TY)                  # x faces
            lx, rx = (q[PAD + RX:PAD + RX + TX + 1, PAD + RY:PAD + RY + TY]
                      for q in reconstruct_face(sx, block, 0))
            ug = u[fr][:, fc]
            cx = _upwind_select(ug, lx, rx)
            fx = metrics[0][fr][:, fc] * ug * cx if arr else ug * cx
            fx = torch.where(masks[0][fr][:, fc], 0.0, fx)
            gr, gc = ex(i0, i0 + TX), ey(j0, j0 + TY + 1)                  # y faces
            ly, ry = (q[PAD + RX:PAD + RX + TX, PAD + RY:PAD + RY + TY + 1]
                      for q in reconstruct_face(sy, block, 1))
            vg = v[gr][:, gc]
            cy = _upwind_select(vg, ly, ry)
            fy = metrics[1][gr][:, gc] * vg * cy if arr else vg * cy
            fy = torch.where(masks[1][gr][:, gc], 0.0, fy)
            dfx, dfy = fx[1:] - fx[:-1], fy[:, 1:] - fy[:, :-1]
            pr, pc = ex(i0, i0 + TX), ey(j0, j0 + TY)
            div = ((dfx + dfy) / metrics[2][pr][:, pc] if arr
                   else dfx * metrics[0] + dfy * metrics[1])
            ni, nj = min(TX, grid.nxp - i0), min(TY, grid.nyp - j0)
            out[i0:i0 + ni, j0:j0 + nj] = div[:ni, :nj]
    return out


def _tile_case(direction):
    """The slice's advection inputs with x wrapped (periodic-x), or on shard
    (1, 1) of a (2, 2) mesh of the periodic slice, where no direction wraps
    (split), with its masks and uniform metrics."""
    from test_torch_immersed import _shard_model
    if direction == "wrapped":
        m = _model(cst, topology=("periodic", "bounded"), device="cpu")
        s = _initial(cst, m)
    else:
        m = _model(cst, topology=("periodic", "periodic"), halo=13, device="cpu")
        m, s = _shard_model(m, _initial(cst, m), (1, 1), 13)
    g = m.grid
    assert tadv._wraps(g, 0) == (direction == "wrapped") and not tadv._wraps(g, 1)
    metrics = (1.0 / g.scalar(g.dx_cc), 1.0 / g.scalar(g.dy_cc))
    return g, s.u, s.v, s.h, (m.masks.per_fc, m.masks.per_cf), metrics


@pytest.mark.parametrize("scheme", ["weno7", "upwind5", "centered4"])
@pytest.mark.parametrize("direction", ["wrapped", "split"])
def test_tile_schedule_matches_plain_version(scheme, direction):
    """2.9's tile schedule, emulated on the CPU with the plain operations
    and NaN beyond each tile's widened region, equals
    fixed_tile_div_reference bitwise over the whole padded arrays."""
    sch = {"weno7": tadv.WENO(order=7), "upwind5": tadv.UpwindBiased(order=5),
           "centered4": tadv.Centered(order=4)}[scheme]
    g, u, v, h, masks, metrics = _tile_case(direction)
    ref = tadv.fixed_tile_div_reference(g, (sch, sch), u, v, h, masks, metrics)
    out = _tile_schedule(g, (sch, sch), u, v, h, masks, metrics)
    assert torch.equal(ref.view(torch.int32), out.view(torch.int32))


@pytest.mark.parametrize("direction", ["wrapped", "split"])
def test_tile_schedule_needs_its_widening(direction):
    """One point short of the stencil radius, the emulated schedule reads
    NaN at the tiles' edge faces."""
    sch = tadv.WENO(order=7)
    g, u, v, h, masks, metrics = _tile_case(direction)
    ref = tadv.fixed_tile_div_reference(g, (sch, sch), u, v, h, masks, metrics)
    out = _tile_schedule(g, (sch, sch), u, v, h, masks, metrics, widen=-1)
    assert not torch.equal(ref.view(torch.int32), out.view(torch.int32))
    assert torch.isnan(out).any()


def test_advection_dispatch_names_a_kernel_for_every_scheme_pair():
    """Every pair of schemes the fixed-tile advection takes has a C entry
    of csrc/advection_fixed.cu: the tile kernel where x and y use the same
    scheme, compiled for exactly TILE_SCHEMES, else the runtime-scheme
    kernel; the tile kernel's WENO tables have no zero smoothness
    coefficient."""
    import re
    from pathlib import Path
    src = (Path(tadv.__file__).parents[1] / "csrc" / "advection_fixed.cu").read_text()
    for entry in (tadv.TILE_ENTRY, tadv.RUNTIME_ENTRY):
        assert f'extern "C" int {entry}(' in src
    kinds = {"WENO": tadv.WENO, "UPWIND": tadv.UpwindBiased, "CENTERED": tadv.Centered}
    listed = src.split("#define CSI_TILE_SCHEMES(X)")[1].split("\n\n")[0]
    compiled = {(kinds[k], int(o)) for k, o in re.findall(r"X\((\w+), (\d+)\)", listed)}
    assert compiled == set(tadv.TILE_SCHEMES) == set(_RADIUS)
    schemes = [kind(order=o) for kind, o in _RADIUS]
    for sx in schemes:
        for sy in schemes:
            same = (type(sx), sx.order) == (type(sy), sy.order)
            assert tadv.kernel_for(sx, sy) == (tadv.TILE_ENTRY if same else tadv.RUNTIME_ENTRY)
    for o in (5, 7, 9):
        assert tadv._scheme_table(tadv.WENO(order=o), "cpu")[0] == 2
    with pytest.raises(ValueError, match="UpwindBiased order 9"):
        tadv.kernel_for(tadv.UpwindBiased(order=9), tadv.UpwindBiased(order=9))


# --- 2.11: the column thermodynamics ---------------------------------------------------

def _series_class(lib):
    if lib is cst:
        return FieldTimeSeries
    from climaseaice_jl_tpu.forcing_utils import FieldTimeSeries as JSeries
    return JSeries


def _thermo_model(lib, layered, device=None):
    series = _series_class(lib)
    monthly = series(times=(np.arange(12) * 30 * DAY).astype(np.float32),
                     data=(np.sin(np.arange(12)) * 60.0 - 20.0).astype(np.float32),
                     cyclical=True)
    kw = dict(top_heat_flux=(monthly, lib.RadiativeEmission(), -15.0), bottom_heat_flux=-2.0)
    if layered:
        snow = series(times=np.array([0.0, 30 * DAY], np.float32),
                      data=np.array([3.2e-6, 1.0e-6], np.float32))
        kw.update(snow_thermodynamics=lib.snow_slab_thermodynamics(), snowfall=snow)
    return _model(lib, device=device, **kw)


def _thermo_state(lib, model):
    rng = np.random.default_rng(7)
    shape = model.grid.interior_shape
    h = np.where(rng.random(shape) < 0.1, 0.02, 0.5 + 0.5 * rng.random(shape))
    kw = dict(h=h, a=0.9 * rng.random(shape) + 0.05, time=17 * DAY)
    if model.snow_thermodynamics is not None:
        kw["hs"] = np.where(rng.random(shape) < 0.2, 0.0, 0.1)
    if lib is cst:
        kw = {k: torch.tensor(v, dtype=torch.float32, device=model.grid.device)
              if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return lib.initial_state(model, **kw)


@pytest.mark.parametrize("layered", [False, True], ids=["bare", "snow"])
def test_thermo_matches_jax(layered):
    """The plain version of the column kernel against
    `fixed_tile_thermo_step` (interpret mode) with a series, radiative
    emission and a number in the top flux, and with snow a snowfall series:
    rtol = atol = 2e-5, as tests/test_fixed_tile_thermo.py:86-87."""
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.thermodynamics.pallas_thermo import fixed_tile_thermo_step
    mj, mt = _thermo_model(csi, layered), _thermo_model(cst, layered, device="cpu")
    sj = _thermo_state(csi, mj)
    st = _to_port(mt, sj)
    ref = fixed_tile_thermo_step(mj, sj, 600.0, (8, 128))
    out = tthermo.thermo_column(mt, st, 600.0)
    names = tthermo.LAYERED_OUTPUTS if layered else tthermo.BARE_OUTPUTS
    assert set(out) == set(names)
    for name in names:
        got = out[name].broadcast_to(mt.grid.shape).numpy()
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, np.asarray(getattr(ref, name)), rtol=2e-5, atol=2e-5,
                                   err_msg=name)


def test_thermo_flux_function_raises():
    """A FluxFunction whose callable leaves the op set of the recorded flux
    programs raises under fixed_tiles on the CPU too, naming the operation;
    one inside it runs through the column physics."""
    ff = cst.FluxFunction(func=lambda grid, Tu, clock, fields: -10.0 + 0 * torch.tanh(Tu),
                          top_temperature_dependent=True)
    m = _model(cst, device="cpu", top_heat_flux=(ff, -5.0))
    s = _initial(cst, m)
    with pytest.raises(NotImplementedError, match="tanh"):
        cst.step(m, s, 120.0)
    ff = cst.FluxFunction(func=lambda grid, Tu, clock, fields: -10.0 + 0 * Tu,
                          top_temperature_dependent=True)
    m = _model(cst, device="cpu", top_heat_flux=(ff, -5.0))
    s = cst.step(m, _initial(cst, m), 120.0)
    assert torch.isfinite(s.h).all() and torch.isfinite(s.Tu).all()


# --- the slice as a whole ------------------------------------------------------------

@pytest.mark.parametrize("layered", [False, True], ids=["bare", "snow"])
def test_codegen_twin_matches_plain_column(layered):
    """The column kernel's flux programs in the generated unit's SSA form
    (a series, radiative emission and a number on top; with snow a
    snowfall series), evaluated by a twin with the prologue once and the
    rest at every T, equal the plain fluxes and the plain column step
    bitwise (tests/test_torch_tripolar_fixed_tiles.py:check_twin_column)."""
    from test_torch_tripolar_fixed_tiles import check_twin_column
    m = _thermo_model(cst, layered, device="cpu")
    s = _thermo_state(cst, m)
    check_twin_column(m, s, 600.0, (s.Tu, s.Tu - 2.5, torch.zeros_like(s.Tu)))


def test_thermo_unit_ignores_the_clock_and_the_flux_values():
    """The generated unit, and so its library's name, depends on the flux
    programs' structure only: not on the clock's time, the series' values or
    the numbers in the fluxes; a flux of another structure gets another."""
    def unit(top, time):
        m = _thermo_model(cst, True, device="cpu").evolve(top_heat_flux=top)
        s = _thermo_state(cst, m)
        s = s.evolve(clock=s.clock.evolve(time=m.grid.scalar(time)))
        p = tthermo.plan(m, s.clock)
        return p.name, p.text

    def series(scale):
        return FieldTimeSeries(times=(np.arange(12) * 30 * DAY).astype(np.float32),
                               data=(scale * np.cos(np.arange(12))).astype(np.float32),
                               cyclical=True)

    first = unit((series(60.0), cst.RadiativeEmission(), -15.0), 17 * DAY)
    assert unit((series(-3.0), cst.RadiativeEmission(emissivity=0.9), 4.0), 211 * DAY) == first
    assert unit((series(60.0), cst.RadiativeEmission()), 17 * DAY)[0] != first[0]


@pytest.mark.parametrize("case", ["tanh", "python-branch"])
def test_thermo_plan_refuses_what_it_cannot_record(case):
    """A flux callable outside the op set raises NotImplementedError naming
    it on the CPU (the plain version's route) and where the card's route
    makes its plan, before anything is compiled."""
    fns = {"tanh": (lambda grid, Tu, clock, fields: torch.tanh(Tu), "tanh"),
           "python-branch": (lambda grid, Tu, clock, fields: Tu if Tu > 0 else -Tu, "__bool__")}
    fn, what = fns[case]
    m = _model(cst, device="cpu", top_heat_flux=(cst.FluxFunction(func=fn), -5.0))
    s = _initial(cst, m)
    with pytest.raises(NotImplementedError, match=what):
        tthermo.thermo_column(m, s, 600.0)
    with pytest.raises(NotImplementedError, match=what):
        tthermo.plan(m, s.clock)


def _spy(monkeypatch):
    """Count the calls of the four fixed-tile routes and the other EVP
    routes on the CPU (the kernels' counters count launches on the card)."""
    calls = dict(prep=0, tiled=0, adv=0, thermo=0, padded=0, periodic=0)

    def wrap(module, name, key):
        fn = getattr(module, name)

        def counted(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, counted)

    wrap(tpad, "evp_prep", "prep")
    wrap(ttiled, "tiled_padded_evp_substeps", "tiled")
    wrap(tadv, "fixed_tile_div", "adv")
    wrap(tthermo, "thermo_column", "thermo")
    wrap(tmodel, "padded_fused_momentum_step", "padded")
    wrap(tmodel, "fused_split_explicit_momentum_step", "periodic")
    return calls


@pytest.mark.parametrize("timestepper", ["ForwardEuler", "SplitRungeKutta3"])
def test_fixed_tile_step_matches_jax(timestepper, monkeypatch):
    """The whole fixed-tile step of the slice's configuration (bounded box,
    island, ImmersedDrag, WENO-7, bare-ice slab) against `csi.step` with
    `fused="always"`, 3 steps: u/v ≤ 1e-4, σ/α ≤ 4e-3, h/ℵ ≤ 1e-5; every
    call through the four fixed-tile routes."""
    import climaseaice_jl_tpu as csi
    mj = _model(csi, timestepper=timestepper)
    mt = _model(cst, timestepper=timestepper, device="cpu")
    sj = _initial(csi, mj)
    st = _to_port(mt, sj)
    calls = _spy(monkeypatch)
    for _ in range(3):
        sj = csi.step(mj, sj, 120.0)
        st = cst.step(mt, st, 120.0)
    stages = 3 * (3 if timestepper == "SplitRungeKutta3" else 1)
    assert calls == dict(prep=stages, tiled=stages, adv=2 * stages, thermo=stages,
                         padded=0, periodic=0)
    for name, bar in zip(FIELDS, (1e-4, 1e-4, 1e-5, 1e-5, 4e-3, 4e-3, 4e-3, 4e-3)):
        a, b = _interior(mt.grid, getattr(sj, name)), _interior(mt.grid, getattr(st, name))
        assert np.isfinite(b).all(), name
        assert _rel(a, b) <= bar, (name, _rel(a, b))


def test_forced_fixed_tile_step_matches_jax(monkeypatch):
    """The slice with a callable forcing on h (``1e-7·ℵ``), 3 Forward Euler
    steps, against `csi.step` within `test_fixed_tile_step_matches_jax`'s
    bars: the EVP gates refuse forcing in both packages, so the momentum
    takes the general path, while the advection (2.9) and the column
    (2.11) stay on their fixed-tile routes, as JAX's do."""
    import climaseaice_jl_tpu as csi

    def forcing(g, c, f):
        return 1e-7 * f.a

    mj = _model(csi, timestepper="ForwardEuler", forcing={"h": forcing})
    mt = _model(cst, timestepper="ForwardEuler", forcing={"h": forcing}, device="cpu")
    sj = _initial(csi, mj)
    st = _to_port(mt, sj)
    calls = _spy(monkeypatch)
    for _ in range(3):
        sj = csi.step(mj, sj, 120.0)
        st = cst.step(mt, st, 120.0)
    assert calls == dict(prep=0, tiled=0, adv=6, thermo=3, padded=0, periodic=0)
    for name, bar in zip(FIELDS, (1e-4, 1e-4, 1e-5, 1e-5, 4e-3, 4e-3, 4e-3, 4e-3)):
        a, b = _interior(mt.grid, getattr(sj, name)), _interior(mt.grid, getattr(st, name))
        assert np.isfinite(b).all(), name
        assert _rel(a, b) <= bar, (name, _rel(a, b))


def test_halo5_vs_halo19_bitwise():
    """The contract of validation/reproducibility_tpu.py on one device:
    halo 5 and halo 19 give bitwise-equal interiors of u, v, h, ℵ, σ and α
    after 3 RK3 steps at the default P★."""
    finals = []
    for halo in (5, 19):
        m = _model(cst, halo=halo, P_star=27500.0, device="cpu")
        s = _initial(cst, m)
        for _ in range(3):
            s = cst.step(m, s, 120.0)
        finals.append({n: _interior(m.grid, getattr(s, n)) for n in FIELDS})
    for name in FIELDS:
        assert np.array_equal(finals[0][name], finals[1][name]), name


def test_simulation_run_takes_the_fixed_routes(monkeypatch):
    """Simulation.run of the slice's configuration goes through the four
    fixed-tile routes, stays finite and keeps land empty."""
    m = _model(cst, P_star=27500.0, device="cpu")
    s = _initial(cst, m)
    calls = _spy(monkeypatch)
    sim = cst.Simulation(m, s, dt=120.0, stop_iteration=2)
    sim.run()
    assert calls == dict(prep=6, tiled=6, adv=12, thermo=6, padded=0, periodic=0)
    g = m.grid
    for name in FIELDS:
        assert torch.isfinite(getattr(sim.state, name)).all(), name
    solid = g.interior(g.solid_cc)
    assert g.interior(sim.state.h)[solid].abs().max() == 0
    assert g.interior(sim.state.a)[solid].abs().max() == 0


def _reproducibility_model(lib, halo, device=None):
    """`validation/reproducibility_tpu.py:21-39` (also
    `tests/test_distributed.py:299-310` with the wide halo policy), as
    written there; the port's grid takes ``device`` besides."""
    kw = {} if device is None else dict(device=device)
    grid = lib.RectilinearGrid(size=(48, 128), x=(-10 * km, 10 * km),
                               y=(-20 * km, 20 * km), halo=halo, dtype="float32", **kw)
    dynamics = lib.SeaIceMomentumEquation(
        rheology=lib.ElastoViscoPlasticRheology(ice_compressive_strength=27.5),
        coriolis=lib.FPlane(f=1e-4),
        top_momentum_stress={"u": 0.01, "v": 0.01},
        bottom_momentum_stress=lib.SemiImplicitStress(),
        solver=lib.SplitExplicitSolver(substeps=8, halo_exchange="wide", fused="always",
                                       fixed_tiles=(8, 128)))
    model = lib.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None,
                              advection=lib.WENO(order=7), timestepper="ForwardEuler")
    mod = torch if lib is cst else np

    def h0(x, y):
        return 0.3 + 0.005 * (mod.sin(60 * x / (20 * km)) + mod.sin(30 * y / (40 * km)))

    return model, lib.initial_state(model, h=h0, a=1.0, u=0.05)


def test_repo_fixed_tile_configuration_bitwise(monkeypatch):
    """The repo's periodic fixed-tile configuration builds in the port
    unchanged, takes the tiled EVP and fixed-tile advection routes, stays
    finite and gives bitwise-equal interiors at halo 5 and halo 19.  (At
    the default α⁺ = 300 this configuration amplifies float32 roundoff
    through the substeps, so two implementations agree only to a few 1e-3
    of u; the bounded comparison with JAX is the soft-relaxation slice
    above.)"""
    calls = _spy(monkeypatch)
    finals = []
    for halo in (5, 19):
        m, s = _reproducibility_model(cst, halo, device="cpu")
        for _ in range(3):
            s = cst.step(m, s, 60.0)
        finals.append({n: _interior(m.grid, getattr(s, n)) for n in FIELDS})
    assert calls == dict(prep=6, tiled=6, adv=12, thermo=0, padded=0, periodic=0)
    for name in FIELDS:
        assert np.isfinite(finals[0][name]).all(), name
        assert np.array_equal(finals[0][name], finals[1][name]), name


# --- the CUDA kernels --------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_prep_matches_plain(cuda_device):
    """The coefficient kernel against its plain version on the card: within
    1 ulp at every padded point, and its raw bits; with the peripheral masks
    act_u and act_v those of the plain version masked as the launcher
    masks them."""
    m = _model(cst, device=cuda_device)
    s = _initial(cst, m)
    dt = m.grid.scalar(120.0)
    prm = tpad.evp_prep_params(m, dt)
    ref = tpad.evp_prep_reference(prm, s.h, s.a, m.grid)
    tpad.evp_prep_counter.reset()
    out = tpad.evp_prep(m, dt, s.h.contiguous(), s.a.contiguous())
    masks = (m.masks.per_fc.contiguous(), m.masks.per_cf.contiguous())
    masked = tpad.evp_prep(m, dt, s.h.contiguous(), s.a.contiguous(), m.grid, *masks)
    torch.cuda.synchronize()
    assert (tpad.evp_prep_counter.calls, tpad.evp_prep_counter.launches) == (2, 2)
    for a, b in zip(ref, out):
        np.testing.assert_array_max_ulp(a.cpu().numpy(), b.cpu().numpy(), maxulp=1)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for k, (a, b) in enumerate(zip(ref, masked)):
        if k in (6, 9):
            a = a * (~masks[k == 9]).to(torch.float32)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), k


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bounded-island", "periodic-x"])
def test_cuda_tiled_evp_matches_plain(cuda_device, case):
    """The tiled EVP kernel against its plain version on the card, soft ice,
    120 substeps: interiors bitwise, so within u/v ≤ 1e-4, σ/α ≤ 4e-3
    (phase 2's bars)."""
    kw = (dict() if case == "bounded-island"
          else dict(topology=("periodic", "bounded"), land=False))
    m = _model(cst, substeps=120, device=cuda_device, **kw)
    s = _initial(cst, m)
    params, consts, carry, _ = tpad.padded_evp_inputs(m, s, 120.0, s.u, s.v)
    assert ttiled._tiled_entry()[1] == KERNEL_PLAN_25[0]   # the plan the CPU emulation holds
    ref = ttiled.tiled_padded_evp_substeps_reference(params, consts, carry, 120, m.grid,
                                                     (8, 128))
    out = ttiled.tiled_padded_evp_substeps(params, consts, [q.clone() for q in carry], 120,
                                           m.grid, (8, 128))
    torch.cuda.synchronize()
    for name, a, b, bar in zip(("u", "v", "sig11", "sig22", "sig12", "alpha"), ref, out,
                               (1e-4, 1e-4, 4e-3, 4e-3, 4e-3, 4e-3)):
        assert _rel(_interior(m.grid, a), _interior(m.grid, b)) <= bar, name
        assert np.array_equal(_interior(m.grid, a), _interior(m.grid, b)), name


@pytest.mark.cuda
def test_cuda_advection_matches_plain(cuda_device):
    """The advection kernel (the tile kernel, WENO-7 with land) against its
    plain version on the card: the plain version's bits over the whole
    padded arrays, signed zeros included, so within 1e-6 of the largest
    value; one launch."""
    m = _model(cst, device=cuda_device)
    s = _initial(cst, m)
    div = tadv.make_fixed_tile_div(m, s.u, s.v)
    schemes = tadv._schemes(m.advection)
    assert tadv.kernel_for(*schemes) == tadv.TILE_ENTRY
    metrics = (1.0 / m.grid.scalar(m.grid.dx_cc), 1.0 / m.grid.scalar(m.grid.dy_cc))
    ref = tadv.fixed_tile_div_reference(m.grid, schemes, s.u, s.v, s.h,
                                        (m.masks.per_fc, m.masks.per_cf), metrics)
    tadv.fixed_tile_advection_counter.reset()
    out = div(s.h)
    torch.cuda.synchronize()
    assert tadv.fixed_tile_advection_counter.launches == 1
    assert _rel(_interior(m.grid, ref), _interior(m.grid, out)) <= 1e-6
    assert torch.equal(ref.view(torch.int32), out.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("schemes", ["weno5", "upwind-centered"])
def test_cuda_advection_schemes_match_plain(cuda_device, schemes):
    """Both C entries on a latitude-longitude band (array metrics, x
    periodic): WENO-5 in both directions through the tile kernel, and
    UpwindBiased(5) in x with Centered(2) in y through the runtime-scheme
    kernel, each the plain version's bits over the padded arrays."""
    g = cst.LatitudeLongitudeGrid((48, 128), latitude=(50.0, 80.0), halo=5, dtype="float32",
                                  topology=("periodic", "bounded"), device=cuda_device)
    pair = ((tadv.WENO(order=5),) * 2 if schemes == "weno5"
            else (tadv.UpwindBiased(order=5), tadv.Centered(order=2)))
    assert tadv.kernel_for(*pair) == (tadv.TILE_ENTRY if schemes == "weno5"
                                      else tadv.RUNTIME_ENTRY)
    rng = np.random.default_rng(3)
    u, v, c = (torch.tensor(rng.standard_normal(g.shape), dtype=torch.float32,
                            device=cuda_device) for _ in range(3))
    masks = tuple(torch.tensor(rng.random(g.shape) < 0.1, device=cuda_device) for _ in range(2))
    metrics = tuple(g.scalar(getattr(g, n)).expand(g.shape).contiguous()
                    for n in ("dy_fc", "dx_cf", "az_cc"))
    ref = tadv.fixed_tile_div_reference(g, pair, u, v, c, masks, metrics)
    out = tadv.fixed_tile_div(g, pair, u, v, c, masks, metrics)
    torch.cuda.synchronize()
    assert torch.equal(ref.view(torch.int32), out.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("layered", [False, True], ids=["bare", "snow"])
def test_cuda_thermo_matches_plain(cuda_device, layered):
    """The column kernel against the slab functions on the card: the plain
    version's bits in every output, signed zeros included, so within 1e-5
    of each output's largest value."""
    m = _thermo_model(cst, layered, device=cuda_device)
    s = _thermo_state(cst, m)
    ref = tthermo.thermo_column_reference(m, s, m.grid.scalar(600.0))
    out = tthermo.thermo_column(m, s, m.grid.scalar(600.0))
    torch.cuda.synchronize()
    for name, q in out.items():
        r = ref[name].broadcast_to(m.grid.shape)
        assert torch.isfinite(q).all(), name
        assert _rel(r.cpu().numpy(), q.cpu().numpy()) <= 1e-5, name
        assert torch.equal(r.contiguous().view(torch.int32), q.contiguous().view(torch.int32)), name

"""Serial against distributed on a mesh that splits the north fold across x,
in the JAX package and in its PyTorch port, both on the CPU.

The tripolar basin of `run_distributed_basin.py:build` in the fixed-tile
mode (``fixed_tiles=(8, 128)``, the 'wide' halo policy), with and without
its ``ImmersedDrag(1e-3)``, from the build's own initial state and from a
seeded one (thickness plus up to 5 cm and velocities up to 1 cm/s,
``numpy.random.default_rng(seed)``).  Each package steps it serially and on
the mesh; the port's ranks are spawned over gloo
(``climaseaice_jl_tpu_torch.parallel.launch``), the JAX package shards over
virtual CPU devices.  Both packages start from the same bits.  Per field it
prints, for each package, the points where the distributed run parts from
the serial one, the largest difference off and in the 12 rows next to the
pole over the field's largest value, and the deepest differing row below
the top; then how far the port's distributed run lies from the JAX
package's, and the port's serial run from the JAX package's.

    python validation/xsplit_fold_parting.py --size 360x300 --substeps 24 --mesh 2x2

(about 3 minutes per configuration at 360×300 on 8 cores).
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from climaseaice_jl_tpu_torch import distributed_basin as db          # noqa: E402
from climaseaice_jl_tpu_torch import initial_state, step               # noqa: E402
from climaseaice_jl_tpu_torch.parallel import launch, strip_halos      # noqa: E402

NAMES = ("u", "v", "h", "a", "hs", "sig11", "sig22", "sig12", "alpha")


def port_build(init, **kw):
    """The port's basin with the initial interior fields ``init`` (numpy)."""
    model, _ = db.build(**kw)
    dev = model.grid.device
    return model, initial_state(model, **{k: torch.as_tensor(np.array(q), device=dev)
                                          for k, q in init.items()})


def jax_runs(Nx, Ny, substeps, mesh, steps, drag, seed):
    """The JAX package's serial and distributed interior fields, and the
    initial interior fields both packages start from."""
    import dataclasses
    import jax
    jax.config.update("jax_platforms", "cpu")
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.parallel import make_distributed_step
    from climaseaice_jl_tpu.parallel.stepper import strip_halos as jax_strip
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import run_distributed_basin as rdb

    model, state = rdb.build(Nx, Ny, substeps=substeps, fixed_tiles=(8, 128))
    if not drag:
        model = dataclasses.replace(model, dynamics=dataclasses.replace(
            model.dynamics, immersed_drag=None))
    I = model.grid.interior
    h, a = np.asarray(I(state.h)), np.asarray(I(state.a))
    init = dict(h=h, a=a, hs=np.zeros_like(h), u=np.zeros_like(h), v=np.zeros_like(h))
    if seed is not None:
        rng = np.random.default_rng(seed)
        init["h"] = np.where(h > 0, h + 0.05 * rng.random(h.shape), h).astype(np.float32)
        init["u"], init["v"] = ((0.02 * (rng.random(h.shape) - 0.5)).astype(np.float32)
                                for _ in range(2))
    state = csi.initial_state(model, **init)
    ser = state
    for _ in range(steps):
        ser = csi.step(model, ser, 600.0)
    dstep, _ = make_distributed_step(model, mesh)
    d = jax_strip(model, state)
    for _ in range(steps):
        d = dstep(d, 600.0)
    jax.block_until_ready(d.h)
    ser = jax_strip(model, ser)
    return ({n: np.asarray(getattr(ser, n)) for n in NAMES},
            {n: np.asarray(getattr(d, n)) for n in NAMES}, init)


def port_runs(Nx, Ny, substeps, mesh, steps, drag, init):
    kw = dict(init=init, Nx=Nx, Ny=Ny, substeps=substeps, fixed_tiles=(8, 128), drag=drag)
    model, state = port_build(device="cpu", **kw)
    for _ in range(steps):
        state = step(model, state, 600.0)
    si = strip_halos(model, state)
    ser = {n: getattr(si, n).numpy() for n in NAMES}
    d = launch.run_cases([dict(build=port_build, kwargs=kw, mesh=mesh, steps=steps, dt=600.0,
                               device="cpu", names=NAMES)], mesh[0] * mesh[1],
                         timeout=3600)[0]["fields"]
    return ser, d


def rel(a, b, ref):
    return np.abs(a.astype(np.float64) - b).max() / max(np.abs(ref).max(), 1e-8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="360x300")
    ap.add_argument("--substeps", type=int, default=24)
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seeds", default="none,7", help="comma-separated; 'none' is the "
                    "build's own initial state")
    args = ap.parse_args(argv)
    Nx, Ny = map(int, args.size.split("x"))
    mesh = tuple(map(int, args.mesh.split("x")))
    seeds = [None if s == "none" else int(s) for s in args.seeds.split(",")]
    torch.set_num_threads(1)
    print(f"{Nx}x{Ny} basin, fixed_tiles=(8, 128), {args.substeps} substeps, mesh {mesh}, "
          f"{args.steps} steps of 600 s, float32 on the CPU; per field: points that "
          f"part, largest difference off / in the top {db.CAP} rows, deepest row")
    for drag in (True, False):
        for seed in seeds:
            js, jd, init = jax_runs(Nx, Ny, args.substeps, mesh, args.steps, drag, seed)
            ts, td = port_runs(Nx, Ny, args.substeps, mesh, args.steps, drag, init)
            print(f"drag {'ImmersedDrag(1e-3)' if drag else 'none'}, seed {seed}:")
            cj, ct = db.compare(js, jd), db.compare(ts, td)
            for n in NAMES:
                row = [f"{pkg} {c[n]['points']}, {c[n]['rel_err']:.2e} / "
                       f"{c[n]['cap_rel_err']:.2e}, {c[n]['deepest_row']}"
                       for pkg, c in (("jax", cj), ("port", ct))]
                print(f"  {n:6s} {'; '.join(row)}; port vs jax: distributed "
                      f"{rel(td[n], jd[n], js[n]):.2e}, serial {rel(ts[n], js[n], js[n]):.2e}")
            print(f"  the port's band (every point in the top {2 * args.substeps + 3} rows, "
                  f"run_distributed_basin.py's bars off the top {db.CAP}): "
                  f"{db.xsplit_drag_band(ct, 2 * args.substeps + 3, 300.0)}; the JAX "
                  f"package's: {db.xsplit_drag_band(cj, 2 * args.substeps + 3, 300.0)}",
                  flush=True)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    sys.exit(main())

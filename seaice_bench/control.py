"""The readings that set the limits of the compared step errors: the
program's on many seeds and the control's (the plain reference computed in
bfloat16, put in the program's place) on some of them, at the cell's own
size, in one process:

    python3 -m seaice_bench.control --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 [--steps N]

For each seed the program is built from the seed's inputs as a run builds
it, warmed up and driven ``--steps`` steps through ``Simulation.run``.  The
last step is then judged as a run judges it, each compared number apart:
the program's state after it against one float32 reference step from the
program's state before it (the program's reading, the lower one), and, for
a control seed, one bfloat16 reference step from the same state against the
float32 one (the control's reading, the upper one).  Prints one JSON line a
seed and a summary line.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from . import registry
from .harness import PROGRAM, StepRecorder, always, drive
from .reference import compare


def readings(workload, seeds, control_seeds, steps, device="cuda:0", traffic=None):
    cell = registry.load_cell(workload)
    if traffic:
        cell["traffic_params"] = dict(cell["traffic_params"], **traffic)
    cfg, tp, conf, ref = cell["cfg"], cell["traffic_params"], cell["module"], cell["reference"]
    device = torch.device(device)
    cst = importlib.import_module(PROGRAM)
    model, dt = conf.build(cst, cfg, tp, device)
    halo = model.grid.Hx
    out = []
    for seed in seeds:
        fields = conf.inputs(model, cfg, tp, seed, device)
        sim = cst.Simulation(model, conf.initial_state(cst, model, fields), dt,
                             stop_iteration=0)
        rec = StepRecorder(device)
        sim.callbacks["seaice_bench"] = cst.Callback(rec, schedule=always)
        drive(sim, rec, int(tp["steps_per_run"]), steps=int(tp["warmup_steps"]) + steps)
        pre, post = rec.prev, rec.cur
        del sim, rec
        start = compare.interiors(pre, ref.FIELDS, halo)
        exact = ref.step(cfg, tp, start, dt)
        line = {"seed": seed,
                "program": compare.compared(ref, exact, compare.interiors(post, ref.FIELDS, halo))}
        if seed in control_seeds:
            low = ref.step(cfg, tp, {n: q.to(torch.bfloat16) for n, q in start.items()}, dt)
            line["control"] = compare.compared(ref, exact, low)
            del low
        del exact, start
        del pre, post
        out.append(line)
        print(json.dumps(line), flush=True)
    summary = {"workload": workload, "steps": steps,
               "lower": {k: max(r["program"][k] for r in out) for k in ref.COMPARED},
               "upper": {k: min((r["control"][k] for r in out if "control" in r), default=None)
                         for k in ref.COMPARED}}
    print(json.dumps(summary), flush=True)
    return out, summary


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m seaice_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    readings(args.workload, seeds, control, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())

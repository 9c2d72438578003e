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
program's state before it (the program's reading, the lower one), and the
float32 reference against a float64 one from the same state (float32's own
rounding, grown by the step).  For a control seed it also reads one
bfloat16 reference step from the same state against the float32 one (the
control's reading, the upper one), and each fault of ``faults.py`` that the
cell can have, planted in the program's step from the same state: its
compared numbers and halo bits, and whether they fail the cell's limits.
Each line also gives every field's error in the max, the L2 and the q0.5
and q0.9 norms, so that a field left out of the compared numbers has its
readings.  Prints one JSON line a seed and a summary line.  The benchmark's
own runs never run the control.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from . import faults, registry
from .harness import PROGRAM, StepRecorder, always, drive
from .reference import compare


def _per_field(exact, got):
    return {f: {norm: compare.field_error(exact[f], got[f], norm)
                for norm in ("max", "l2", "q0.5", "q0.9")} for f in exact}


def _faults(ref, model, cfg, tp, limits, exact, pre, dt, halo):
    """Each fault's compared numbers and halo bits, from ``pre``, and
    whether any fails its limit."""
    out = {}
    for name, fault in faults.of(ref).items():
        with faults.planted(fault):
            bad = faults.step(model, pre, dt)
            numbers = compare.compared(ref, exact, compare.interiors(bad, ref.FIELDS, halo, ref))
            numbers["halo_bits"] = compare.halo_bits(ref, bad, halo)
        del bad
        numbers["fails"] = any(v > limits[k] for k, v in numbers.items())
        out[name] = numbers
    return out


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
        start = compare.interiors(pre, ref.FIELDS, halo, ref)
        got = compare.interiors(post, ref.FIELDS, halo, ref)
        exact = compare.step(ref, cfg, tp, start, dt, pre)
        line = {"seed": seed, "program": compare.compared(ref, exact, got),
                "fields": {"program": _per_field(exact, got)}}
        if seed in control_seeds:
            low = compare.step(ref, cfg, tp, {n: q.to(torch.bfloat16) for n, q in start.items()},
                               dt, pre)
            line["control"] = compare.compared(ref, exact, low)
            line["fields"]["control"] = _per_field(exact, low)
            del low
            line["faults"] = _faults(ref, model, cfg, tp, cell["limits"], exact, pre, dt, halo)
        wide = compare.step(ref, cfg, tp, {n: q.double() for n, q in start.items()}, dt, pre)
        line["float64"] = compare.compared(ref, wide, exact)
        line["fields"]["float64"] = _per_field(wide, exact)
        line["fields"]["program_float64"] = _per_field(wide, got)
        del wide
        del exact, start, got
        del pre, post
        out.append(line)
        print(json.dumps(line), flush=True)
    summary = {"workload": workload, "steps": steps,
               "lower": {k: max(r["program"][k] for r in out) for k in ref.COMPARED},
               "upper": {k: min((r["control"][k] for r in out if "control" in r), default=None)
                         for k in ref.COMPARED},
               "float64": {k: max(r["float64"][k] for r in out) for k in ref.COMPARED},
               "faults_failed": {name: all(r["faults"][name]["fails"] for r in out if "faults" in r)
                                 for name in faults.of(ref)}}
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

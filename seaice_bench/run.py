"""Run one cell once and print its result line:

    python3 -m seaice_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits with a code other than 0, printing no result, without CUDA cards
enough for the cell, or where a module of the JAX package was loaded."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m seaice_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # load from one process with few threads, held to two cores: a launch-bound
    # step is timed on one thread, which then does not migrate
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    if hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:2])
    import torch
    torch.set_num_threads(1)
    from .harness import report, run_cell
    code, result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T0)
    if result is not None:
        report(result)
    return code


if __name__ == "__main__":
    sys.exit(main())

"""Readings for setting a cell's correctness limits, many seeds in one
process: the program's numbers on each seed, and on the first seeds the
control's (the reference in bfloat16 in the program's place) and, for a
fit cell, the planted half-batch fault's.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> ... \
        [--seconds 3] [--controls 3] [--out FILE]

Each seed's run lines go to ``--out``; one JSON line a seed and a summary
line (the largest program reading and the smallest control and fault
reading of each number) go to standard output.
"""
import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--out", default=os.devnull)
    args = p.parse_args(argv)

    import torch

    from benchmark import cells, harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload, ROOT)
    program, faults = {}, {}
    with open(args.out, "a") as log:
        for i, seed in enumerate(args.seeds):
            r = harness.run_cell(cell, seed, args.seconds, False,
                                 torch.device("cuda", 0),
                                 time.perf_counter(),
                                 control=i < args.controls, out=log, err=log)
            got = {k: v["value"] for k, v in r["checks"].items()}
            for k, v in got.items():
                program.setdefault(k, []).append(v)
            line = {"seed": seed, "correct": r["correct"], "program": got,
                    "metrics": {k: v["value"]
                                for k, v in r["metrics"].items()}}
            for kind, readings in (r.get("controls") or {}).items():
                line[kind] = readings
                for k, v in readings.items():
                    faults.setdefault(kind, {}).setdefault(k, []).append(v)
            print(json.dumps(line), flush=True)
    summary = {"program_max": {k: max(v) for k, v in program.items()},
               "program_median": {k: sorted(v)[len(v) // 2]
                                  for k, v in program.items()}}
    for kind, numbers in faults.items():
        summary[kind + "_min"] = {
            k: min(x for x in v if not math.isnan(x)) if any(
                not math.isnan(x) for x in v) else None
            for k, v in numbers.items()}
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

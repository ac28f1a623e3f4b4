"""The output check's control and its readings, on the card.

    python3 -m benchmark.control --workload NAME --seeds 1,2,3 --seconds S [--program]

For each seed, one run of the cell with a short window whose output check
puts the reference, computed with TF32 matmuls (the precision below the
configuration's float32 with TF32 off), in the program's place; with
--program, the program's own run as the benchmark makes it. Prints one
JSON line per seed with the compared numbers; the limits in
benchmark/limits/ lie between the program's readings and the control's.
The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys

from benchmark.run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = run_cell(args.workload, seed, args.seconds, False, control=not args.program)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": not args.program,
                          "correct": line["correct"], "attempted": line["attempted"],
                          "checks": {k: v["value"] for k, v in line["checks"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

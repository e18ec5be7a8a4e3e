"""The readings that the limits of ``correct`` are set from, for one cell:

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        [--out readings.json]

Per seed, in one process (or one process a rank) with one set-up: the
numbers compared for the program as the cell runs it, for the control
(the plain reference put in the program's place and computed a precision
lower: TF32 with TF32 off) and for each fault planted in the program's
timed path. The benchmark's own runs never run it. Prints one JSON
object per seed, then the lower reading (the largest the program gave)
and the smallest reading of the control and of each fault, per number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness  # noqa: E402


def summary(records: list) -> dict:
    """Per number: the program's largest reading and the smallest reading
    of every other variant."""
    out = {}
    for variant in records[0]:
        if not isinstance(records[0][variant], dict):
            continue
        pick = max if variant == "program" else min
        out[variant] = {k: pick(r[variant][k] for r in records)
                        for k in records[0][variant]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    harness.prepare_env()
    spec = harness.load_spec(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    records = harness.run_sweep(spec, seeds, args.device)
    for rec in records:
        print(json.dumps(rec))
    result = {"workload": args.workload, "records": records,
              "summary": summary(records)}
    print(json.dumps(result["summary"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

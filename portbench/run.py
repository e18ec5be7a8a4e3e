"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds the port (``dvsg_tpu_torch``)
and ``BENCHMARK.json``, on a machine with the cards the cell asks for.
The last line of standard output is the result, one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics and the device trace's breakdown. The numbers that
decide ``correct`` are printed beside their limits as the last lines of
standard error, and under ``checks``, the line's last key. Set-up's parts
go to standard error first.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.prepare_env()
    spec = harness.load_spec(args.workload)
    t0 = time.monotonic()
    import torch
    import_s = time.monotonic() - t0
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"this machine has {n}", file=sys.stderr)
        return 2
    result = harness.run_cell(spec, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    result["parts"] = dict({"import_torch": import_s}, **result["parts"])
    print("setup parts (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in result["parts"].items()),
        file=sys.stderr)
    found = sorted(set(result["forbidden"]) | set(
        harness.forbidden_modules()))
    if found:
        print(f"portbench: the run loaded {found}; the benchmark measures "
              "the PyTorch port alone", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips}
    line = harness.result_line(result, spec, device)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

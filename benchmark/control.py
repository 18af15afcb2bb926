"""The control of ``correct``: a cell run with the package at the lower
precision its traffic names (``control``: bf16 values for f32, the f32
kernels for double-double), beside the package as the traffic states it,
on several seeds. It has to come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \\
        [--seconds 1] [--sides program,control]

Prints one JSON line a run: the seed, the side, ``correct`` and the
compared numbers. The benchmark's own runs never run it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.harness import core, spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--sides", default="program,control")
    args = p.parse_args(argv)
    cell = spec.find_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        for side in args.sides.split(","):
            control = cell.traffic["control"] if side == "control" else None
            t0 = time.perf_counter()
            line = core.run_cell(
                cell, seed, args.seconds, False, "cuda", t0,
                log=lambda *a: print(*a, file=sys.stderr, flush=True),
                control=control)
            print(json.dumps({"cell": cell.name, "seed": seed, "side": side,
                              "precision": control or
                              cell.traffic["precision"],
                              "correct": line["correct"],
                              "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

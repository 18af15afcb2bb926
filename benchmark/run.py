"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Logs go to standard error, whose last lines
are the compared numbers beside their limits; the last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``. Exit codes: 0 with a result line; 2 for a cell that does not
exist; 3 without a CUDA device, or with fewer than the cell asks for; 4
when JAX or the JAX package was loaded; 1 for any other failure. Every
code but 0 comes without a result line.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# whole top-level module names that must not be loaded in this process
FORBIDDEN = ("jax", "jaxlib", "flax", "sparsematrixvectormultiplication_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"], capture_output=True,
            text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # build and kernel caches at fixed paths inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import spec

    try:
        cell = spec.find_cell(args.workload)
    except (KeyError, OSError) as e:
        log(f"error: {e}")
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"error: {cell.name} needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count()}")
        return 3
    from benchmark.harness import core

    log(f"card: {power_limit()}")
    try:
        line = core.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             "cuda", T0, log=log)
    except Exception:  # noqa: BLE001 — reported; no result line
        log(traceback.format_exc())
        return 1
    found = forbidden_modules()
    if found:
        log(f"error: modules loaded in this process: {found}")
        return 4
    for name, c in line["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

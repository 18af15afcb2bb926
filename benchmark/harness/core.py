"""One run of one cell: set-up, the measured window, the traced window, the
check against the fp64 reference, and the result line.

Set-up, each stage timed by the host clock into ``Run.spans``: import of
the package (``import``), the matrix made on the device from the seed and
copied to the host (``generate``), the package's CSR and SELL conversions
(``convert``), the upload ending in a synchronize (``upload``), the banks
of inputs and the warm-up requests, which build and load the kernels on a
checkout's first run (``warmup``). ``setup`` runs from the process's start
to the first request of the window.

The measured window issues requests for ``seconds`` and ends with a
synchronize after the last. With ``--trace 1`` a traced window of
:data:`TRACE_SECONDS` follows it under the profiler. Then the package's
state is dropped, the peak device memory having been read, and a sample of
the window's answers, drawn from the seed, is compared with the fp64
reference.
"""

from __future__ import annotations

import importlib
import importlib.util
import random
import sys
import time
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.harness import trace as tr
from benchmark.harness.client import device_bytes, no_span
from benchmark.harness.spec import Cell, reader_path
from benchmark.reference.matrix import Matrix

PORT = "sparsematrixvectormultiplication_tpu_torch"
TRACE_SECONDS = 1.0


class LayoutError(RuntimeError):
    """The conversion gave other SELL layouts than the configuration's: the
    run would measure another kernel."""


def child_seed(seed: int, name: str) -> int:
    """A 63-bit seed for stream ``name`` of run seed ``seed`` (any
    integer)."""
    ss = np.random.SeedSequence(seed % (1 << 64),
                                spawn_key=(zlib.crc32(name.encode()),))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Sample:
    """A uniform sample of ``k`` of the window's answers (reservoir
    sampling), drawn from ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items = k, random.Random(seed), []

    def offer(self, i: int, item):
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.items[j] = item


@dataclass
class Run:
    """What one run measured: read by the metric readers of ``metrics/``."""

    cell: Cell
    device: torch.device
    precision: str
    nrows: int = 0
    ncols: int = 0
    nnz: int = 0
    rhs: int = 1
    spans: dict = field(default_factory=dict)     # host seconds by stage
    counters: dict = field(default_factory=dict)  # launches, plane_bytes
    stats: dict = field(default_factory=dict)     # the client's, by request
    requests: int = 0
    window_s: float = 0.0
    trace: dict | None = None
    kind: str = "cpu"


class _Clock:
    def __init__(self, spans: dict, name: str, device: torch.device):
        self.spans, self.name, self.device = spans, name, device

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            _sync(self.device)
            self.spans[self.name] = time.perf_counter() - self.t0


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launches(port_name: str = PORT) -> int:
    """Kernel launches the package's wrappers have counted: the
    ``.launches`` of every callable in the ``__all__`` of its loaded
    ``ops`` modules, each wrapper once."""
    seen, total = set(), 0
    for name, mod in list(sys.modules.items()):
        if not name.startswith(port_name + ".ops."):
            continue
        for attr in getattr(mod, "__all__", ()):
            obj = getattr(mod, attr, None)
            n = getattr(obj, "launches", None)
            if callable(obj) and type(n) is int and id(obj) not in seen:
                seen.add(id(obj))
                total += n
    return total


def window(step, seconds: float, device, sample: Sample | None = None,
           span=no_span) -> tuple:
    """Requests from one caller for ``seconds``, then a synchronize;
    returns ``(requests, seconds from the first request to the end of the
    synchronize, requests issued by the end of each whole second)``."""
    _sync(device)
    t0 = time.perf_counter()
    i, marks, mark = 0, [], 1.0
    while True:
        item = step(i, span)
        if sample is not None:
            sample.offer(i, item)
        i += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= mark:
            marks.append(i)
            mark += 1.0
        if elapsed >= seconds:
            break
    _sync(device)
    return i, time.perf_counter() - t0, marks


def _load_reader(metric: str):
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(run: Run, metrics: list) -> dict:
    """Each metric's value by its reader, with its unit; a metric whose
    reader finds nothing to read is left out."""
    out = {}
    for m in metrics:
        value = _load_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, t0: float, log=print, control: str | None = None
             ) -> dict:
    """Run ``cell`` once and return its result line (a dict). ``t0`` is the
    process's start on the host clock. ``control`` runs the package at that
    lower precision in place of the mix's (the control of ``correct``)."""
    device = torch.device(device)
    traffic = cell.traffic
    run = Run(cell, device, control or traffic["precision"])
    if device.type == "cuda":
        run.kind = torch.cuda.get_device_name(device)
    with _Clock(run.spans, "import", device):
        port = importlib.import_module(PORT)
    client_mod = importlib.import_module(
        f"benchmark.clients.{traffic['client']}")
    gen = importlib.import_module(
        f"benchmark.reference.{cell.config['generator']}")

    with _Clock(run.spans, "generate", device):
        m = gen.generate(cell.config["params"], child_seed(seed, "matrix"),
                         device)
        run.nrows, run.ncols, run.nnz = m.nrows, m.ncols, m.nnz
        host = m.numpy()
        del m
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    with _Clock(run.spans, "convert", device):
        csr = port.CSRMatrix.from_coo(port.COOMatrix(run.nrows, run.ncols,
                                                     *host))
        sell = port.SellMatrix.from_csr(csr)
    bins = [(b.layout, int(b.k), int(b.n_groups)) for b in sell.bins]
    log(f"[{cell.name}] {run.nrows} rows, {run.nnz} nnz, SELL bins "
        f"(layout, k, groups) {bins}")
    want = cell.config.get("layouts")
    if want is not None and {b[0] for b in bins} != set(want):
        raise LayoutError(f"{cell.name}: the conversion gave layouts "
                          f"{sorted({b[0] for b in bins})}, not "
                          f"{sorted(want)}")
    client = client_mod.Client(port, traffic, device,
                               child_seed(seed, "inputs"), csr,
                               precision=control)
    run.rhs = client.rhs
    with _Clock(run.spans, "upload", device):
        client.upload(sell)
    del sell
    run.counters["plane_bytes"] = device_bytes(client.container)
    with _Clock(run.spans, "warmup", device):
        client.prepare()
    del csr
    client.csr = None
    run.spans["setup"] = time.perf_counter() - t0

    sample = Sample(int(traffic["sample"]), child_seed(seed, "sample"))
    client.stats = {}
    before = launches()
    run.requests, run.window_s, marks = window(client.step, seconds,
                                               device, sample)
    run.counters["launches"] = launches() - before
    run.stats = client.stats
    log(f"[{cell.name}] window: {run.requests} requests in "
        f"{run.window_s:.3f} s")
    log(f"[{cell.name}] requests by second of the window: "
        f"{np.diff([0] + marks).tolist()}")
    for name, values in run.stats.items():
        if len(values) >= 2:
            q = np.quantile(values, [0, 0.5, 0.95, 1])
            log(f"[{cell.name}] {name}: min {q[0]:.6g}, median {q[1]:.6g}, "
                f"p95 {q[2]:.6g}, max {q[3]:.6g}")

    if trace and device.type == "cuda":
        client.stats = {}
        run.trace = tr.profiled(lambda span: window(
            client.step, TRACE_SECONDS, device, None, span)[0])
        if run.trace is None:
            raise RuntimeError(f"{cell.name}: the profiler saw no device "
                               "activity in the traced window")
        client.stats = run.stats
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    unfinished = client.unfinished()
    client.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = Matrix.from_numpy(run.nrows, run.ncols, *host, device=device)
    del host
    per_item = [client.check(ref, item) for item in sample.items]
    del ref
    checks, failed = {}, unfinished
    for numbers in per_item:
        over = False
        for name, value in numbers.items():
            checks[name] = max(checks.get(name, value), value)
            over |= not value <= cell.limits[name]
        failed += over
    correct = (bool(per_item) and failed == 0
               and set(checks) == set(cell.limits))
    log(f"[{cell.name}] check of {len(per_item)} sampled answers: "
        f"{time.perf_counter() - t_check:.2f} s")

    metrics = read_metrics(run, cell.per_layer if trace else cell.end_to_end)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": run.kind, "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": run.requests, "failed": failed,
            "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        line["breakdown"] = {"device_ops": run.trace["ops"],
                             "idle_gaps": run.trace["gaps"]}
    line["checks"] = {name: {"value": checks.get(name),
                             "limit": limit}
                      for name, limit in cell.limits.items()}
    return line

"""The traced window: the profiler's trace reduced to busy time, device
operations and idle gaps.

The harness names its spans around the package's entries with
``torch.profiler.record_function``; the whole traced window is the span
:data:`WINDOW`, which ends after the window's last synchronize.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

import torch

WINDOW = "bench.window"
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_IDLE = "harness"  # the harness's own code between spans
TOP = 10


def _top(totals: dict) -> list:
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])
            [:TOP]]


def reduce_trace(events: list) -> dict | None:
    """Busy time, device operations and idle gaps of the :data:`WINDOW` span
    of chrome-trace ``events`` (times in microseconds); None when the
    window holds no device activity.

    ``busy_s`` is the union of the device activities' intervals,
    ``device_s`` the sum of their durations, ``ops`` the ten names with the
    most device time, and ``gaps`` the idle time of the device, each gap
    named by the innermost span of the harness open on the host where it
    begins (:data:`HOST_IDLE` where none is), the ten names with the
    most."""
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = sorted((max(float(e["ts"]), w0),
                  min(float(e["ts"]) + float(e["dur"]), w1), e["name"])
                 for e in events if e.get("cat") in DEVICE_CATS
                 and "dur" in e and float(e["ts"]) < w1
                 and float(e["ts"]) + float(e["dur"]) > w0)
    if not dev:
        return None
    ops, gaps = defaultdict(float), []
    device_us = busy_us = 0.0
    end = w0
    for s, e, name in dev:
        ops[name] += (e - s) * 1e-6
        device_us += e - s
        if s > end:
            gaps.append((end, s))
        if e > end:
            busy_us += e - max(s, end)
            end = e
    if end < w1:
        gaps.append((end, w1))
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") != WINDOW)
    starts = [s[0] for s in spans]
    idle = defaultdict(float)
    for g0, g1 in gaps:
        name = HOST_IDLE
        j = bisect.bisect_right(starts, g0) - 1
        for k in range(j, max(j - 64, -1), -1):  # the latest still open
            if spans[k][1] > g0:
                name = spans[k][2]
                break
        idle[name] += (g1 - g0) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": busy_us * 1e-6, "device_s": device_us * 1e-6,
            "ops": _top(ops), "gaps": _top(idle)}


def profiled(run_window) -> dict | None:
    """Run ``run_window(span)`` under ``torch.profiler`` inside the span
    :data:`WINDOW` and reduce its trace; ``span`` is ``record_function``.
    Returns None when the trace shows no device activity."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            requests = run_window(record_function)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    out = reduce_trace(events)
    if out is not None:
        out["requests"] = requests
    return out

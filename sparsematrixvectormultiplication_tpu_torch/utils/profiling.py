"""Profiling hooks — the counterpart of the reference's ``-lineinfo`` + nvprof
workflow (CMakeLists.txt:49, SURVEY §5 tracing).

``profile_trace`` wraps ``torch.profiler`` so any bench stage can write a
Chrome trace (chrome://tracing, Perfetto):

    with profile_trace("trace/fem3d"):
        sell_spmv(dsell, x_tab)

The CLI exposes it as ``--profile-dir`` (one trace per matrix).
``annotate`` names a span both as an NVTX range, which Nsight shows, and as
a profiler record, which the Chrome trace shows. Nothing may depend on what
a trace holds: on some machines the profiler records no device activity.
"""

# Ported from sparsematrixvectormultiplication_tpu/utils/profiling.py (the
# port must not import the JAX package).

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["profile_trace", "annotate", "TRACE_FILE"]

TRACE_FILE = "trace.json"  # the Chrome trace profile_trace writes


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Profile the CPU and, where there is one, the CUDA device inside the
    block and write ``log_dir/trace.json``; a no-op when ``log_dir`` is
    None."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """Named trace span (≙ a labeled cudaEvent region): an NVTX range where
    PyTorch has CUDA, and a ``record_function`` span."""
    with contextlib.ExitStack() as stack:
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        stack.enter_context(torch.profiler.record_function(name))
        yield

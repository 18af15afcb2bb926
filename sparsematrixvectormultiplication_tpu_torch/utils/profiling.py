"""The port's tracing: named spans and counters, and the Chrome-trace
exporter (the counterpart of the reference's ``-lineinfo`` + nvprof
workflow, CMakeLists.txt:49, SURVEY §5 tracing).

Tracing is on while a ``torch.profiler`` profile runs, or between
:func:`enable` and :func:`disable`; off otherwise. Then:

* :func:`annotate` ``(name)`` opens a span on the hot path: off, it returns
  one module-level null context and does nothing else; on, it opens an NVTX
  range (where PyTorch has CUDA) and a user-scope record function, the
  event ``torch.profiler.record_function`` makes (a ``user_annotation`` of
  the profiler's trace, on the clock of the device events), and adds its
  host time into an in-memory aggregate by name.
* :func:`setup_span` ``(name)`` times work done once a matrix (the SELL
  conversion): into the same aggregate always, tracing on or off, and into
  the trace as :func:`annotate` when tracing is on. ``@setup_span(name)``
  times every call of the decorated function.
* :func:`count` ``(name, n)`` adds to an integer counter, only while tracing
  is on.

The aggregate holds, by name, the number of spans, their total host seconds
and their self seconds (the total less the time of the spans opened inside
them). A span opened inside an open span of its own name (a conversion that
calls itself) adds nothing: the outer one holds the time. The open spans are
kept in this module: the port traces from one thread. :func:`summary`,
:func:`counters` and :func:`reset` read and clear the aggregates; nothing is
written to disk here but by :func:`profile_trace`:

    with profile_trace("trace/fem3d"):
        sell_spmv(dsell, x_tab)

The CLI exposes it as ``--profile-dir`` (one trace per matrix). Nothing may
depend on what a trace holds: on some machines the profiler records no
device activity.

Spans and counters of the port (names carry the layer):

* ``ops.sell_spmv``, ``ops.sell_spmm``;
  ``ops.sell_spmv_dd_f64`` with ``ops.dd.split_x`` (x split into its
  tables), ``ops.dd.assemble``, ``ops.dd.join_y``: each call, tracing on;
* ``solvers.cg`` with ``solvers.cg.matvec``, ``solvers.cg.update`` and
  ``solvers.cg.stop_test``, and the counters ``solvers.cg.host_reads`` and
  ``solvers.cg.fused_iters`` (the iterations its fused kernels ran);
  ``solvers.pagerank`` with ``.matvec``, ``.update`` and ``.stop_test``
  (``GraphedPageRank``: ``.iteration``, a replay, and ``.stop_test``), and
  the counter ``solvers.pagerank.host_reads``: each solve and iteration,
  tracing on;
* ``formats.sell.from_csr`` with ``formats.sell.row_order`` (the row-order
  rule of the exported ``SellMatrix``), ``.slab_lists``, ``.wl_profile``,
  ``.fill``, ``.distinct``, ``.emit`` and ``.wl_shed``: each conversion,
  always.
"""

# Ported from sparsematrixvectormultiplication_tpu/utils/profiling.py (the
# port must not import the JAX package).

from __future__ import annotations

import contextlib
import functools
import os
from time import perf_counter_ns

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["profile_trace", "annotate", "setup_span", "count", "enable",
           "disable", "tracing", "summary", "counters", "reset",
           "TRACE_FILE"]

TRACE_FILE = "trace.json"  # the Chrome trace profile_trace writes

_on = False      # enable() / disable()
_stack = []      # the open spans' frames [name, child ns], outermost first
_open = set()    # their names
_spans = {}      # name -> [count, total ns, self ns]
_counts = {}     # name -> int
_nvtx = None     # whether NVTX ranges can be opened, found at first use


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


def enable():
    """Turn tracing on without a profiler."""
    global _on
    _on = True


def disable():
    """Turn off what :func:`enable` turned on (a running profiler still
    traces)."""
    global _on
    _on = False


def tracing() -> bool:
    """Whether spans and counters record now."""
    return _on or _autograd_profiler._is_profiler_enabled


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


# record_function's own enter and exit: the same user-scope record, without
# the operator dispatch around it (2.7-4.3 us a span under the profiler on
# an H100 machine's host, against record_function's 8.5-11.5)
_record_enter = torch._C._autograd._record_function_with_args_enter
_record_exit = torch._C._autograd._record_function_with_args_exit


class _Span:
    """One span: its host time into the aggregate, and, when ``emit``, an
    NVTX range and a user-scope record function around it."""

    __slots__ = ("name", "emit", "frame", "rf", "t0")

    def __init__(self, name: str, emit: bool):
        self.name, self.emit = name, emit

    def __enter__(self):
        global _nvtx
        name = self.name
        if self.emit:
            if _nvtx is None:
                _nvtx = torch.cuda.is_available()
            if _nvtx:
                torch.cuda.nvtx.range_push(name)
            self.rf = _record_enter(name)
        if name in _open:
            self.frame = None  # re-entered: the open span holds the time
        else:
            self.frame = [name, 0]
            _stack.append(self.frame)
            _open.add(name)
        self.t0 = perf_counter_ns()
        return None

    def __exit__(self, *exc):
        ns = perf_counter_ns() - self.t0
        frame = self.frame
        if frame is not None:
            if _stack and _stack[-1] is frame:
                _stack.pop()
            _open.discard(frame[0])
            agg = _spans.get(frame[0])
            if agg is None:
                agg = _spans[frame[0]] = [0, 0, 0]
            agg[0] += 1
            agg[1] += ns
            agg[2] += ns - frame[1]
            if _stack:
                _stack[-1][1] += ns
        if self.emit:
            _record_exit(self.rf)
            if _nvtx:
                torch.cuda.nvtx.range_pop()
        return False

    def __call__(self, fn):
        """``@setup_span(name)``: time every call of ``fn``."""
        name = self.name

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with setup_span(name):
                return fn(*args, **kwargs)
        return timed


def annotate(name: str):
    """A span of the hot path named ``name``: the null context while tracing
    is off (one flag test, nothing entered); while it is on, an NVTX range
    and a record function whose host time goes into :func:`summary`."""
    if _on or _autograd_profiler._is_profiler_enabled:
        return _Span(name, True)
    return _NULL


def setup_span(name: str) -> _Span:
    """A span of work done once a matrix: its host time goes into
    :func:`summary` always, and into the trace while tracing is on. Also a
    decorator."""
    return _Span(name, tracing())


def count(name: str, n: int = 1):
    """Add ``n`` to counter ``name`` while tracing is on."""
    if _on or _autograd_profiler._is_profiler_enabled:
        _counts[name] = _counts.get(name, 0) + n


def summary() -> dict:
    """``{name: {"count", "total_s", "self_s"}}`` of the spans closed since
    the last :func:`reset`."""
    return {name: {"count": c, "total_s": total * 1e-9, "self_s": own * 1e-9}
            for name, (c, total, own) in _spans.items()}


def counters() -> dict:
    """``{name: n}`` of the counters since the last :func:`reset`."""
    return dict(_counts)


def reset():
    """Clear the span aggregate and the counters."""
    _spans.clear()
    _counts.clear()

"""Timing: CUDA events on the card, the host clock on the CPU.

:func:`time_fn` is the time of one call, host included: each rep of ``fn``
is bracketed by its own pair of CUDA events on the current stream (≙ the
reference's cudaEvent pairs, main_cuda.cu:88-90,163-180) and the median over
the reps is reported after ``skip`` warm-up calls. A rep's time includes any
host gap between its events, so a kernel shorter than the wrapper's host
overhead reads as that overhead.

:func:`device_time_fn` is the card's own time per call, back to back: a spin
kernel holds the stream while the host queues all the reps behind one pair
of events, so the device runs them without waiting for the host. It checks
that the spin was still running when the last rep was queued.

:func:`run_device_validated` checks every rep of a run against a reference
result on the device (≙ the reference's in-loop checkResult,
main_cuda.cu:183-188, and the JAX ``run_device_validated``): the running
``max|out - y_ref|`` stays a device scalar and is read back once.
"""

from __future__ import annotations

import statistics
import time

import torch

__all__ = ["time_fn", "device_time_fn", "run_device_validated",
           "ITERATION_SKIP", "MAX_QUEUED_LAUNCHES"]

ITERATION_SKIP = 5  # warm-up iterations to skip (≙ reference utility.h:7)
# launches a caller of device_time_fn keeps queued behind its spin, at most:
# the stream's launch queue overflows near a thousand pending launches, and
# the timer then raises (a dd SpMV over 37 bins, 20 reps)
MAX_QUEUED_LAUNCHES = 400
_SPIN_TRIES = 8     # each retry doubles the spin


def time_fn(fn, *args, device, reps: int = 20,
            skip: int = ITERATION_SKIP) -> float:
    """Median seconds of one ``fn(*args)`` call on ``device``."""
    device = torch.device(device)
    for _ in range(skip):
        fn(*args)
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
        return statistics.median(times)
    with torch.cuda.device(device):
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for start, end in pairs:
            start.record()
            fn(*args)
            end.record()
        torch.cuda.synchronize(device)
    return statistics.median(s.elapsed_time(e) for s, e in pairs) / 1e3


def _spin_cycles_per_second() -> float:
    """Clock cycles per second of ``torch.cuda._sleep`` on the current device."""
    cycles = 2_000_000
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(cycles)  # warm-up: the first launch loads the kernel
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / (start.elapsed_time(end) / 1e3)


def device_time_fn(fn, *args, device, reps: int = 20,
                   skip: int = ITERATION_SKIP) -> float:
    """Mean device seconds per ``fn(*args)`` call on a CUDA ``device``, the
    calls running back to back. ``fn`` must not synchronise with the host.

    The spin lasts four times the host time of queueing ``reps`` calls (from
    the fastest warm-up call) plus 1 ms. If the spin ended before the last
    call was queued, the reps run again behind a spin twice as long; after
    ``_SPIN_TRIES`` such misses it raises."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device time is taken on CUDA devices, not {device}")
    if skip < 1:
        raise ValueError("device_time_fn needs a warm-up call (skip >= 1)")
    with torch.cuda.device(device):
        host = []
        for _ in range(skip):
            t0 = time.perf_counter()
            fn(*args)
            host.append(time.perf_counter() - t0)
        torch.cuda.synchronize(device)
        spin_s = 4 * reps * min(host) + 1e-3
        rate = _spin_cycles_per_second()
        for _ in range(_SPIN_TRIES):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda._sleep(int(spin_s * rate))
            start.record()
            for _ in range(reps):
                fn(*args)
            end.record()
            fed = not start.query()  # the spin still held the stream
            end.synchronize()
            if fed:
                return start.elapsed_time(end) / reps / 1e3
            spin_s *= 2
    raise RuntimeError(
        f"the host did not queue {reps} calls within a {spin_s / 2:.4f} s "
        "spin; device time not measured")


def run_device_validated(fn, *args, y_ref: torch.Tensor, device,
                         reps: int = 16) -> tuple:
    """Run ``fn(*args)`` ``reps`` times; after each, fold ``max|out -
    y_ref|`` (over ``y_ref``'s leading entries; ``out[0]`` of a tuple) into
    a running maximum kept on the device, and read it back once at the end.
    Returns ``(max_abs_diff, seconds_per_rep)``; the seconds include the
    compare, so callers can state its overhead against the plain timed
    run (CUDA events on a CUDA device, the host clock elsewhere)."""
    device = torch.device(device)
    ref = y_ref.reshape(-1)
    acc = torch.zeros((), dtype=torch.float64, device=ref.device)

    def rep():
        out = fn(*args)
        out = (out[0] if isinstance(out, tuple) else out).reshape(-1)
        diff = (out[: ref.numel()].double() - ref.double()).abs().max()
        torch.maximum(acc, diff, out=acc)

    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            rep()
        return float(acc), (time.perf_counter() - t0) / reps
    with torch.cuda.device(device):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            rep()
        end.record()
        worst = float(acc)  # the one readback
    return worst, start.elapsed_time(end) / reps / 1e3

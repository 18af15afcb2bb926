"""The 95th percentile of the solves' host times in the measured window,
each from the call of ``cg`` to its return on the stop test's host read."""

import statistics


def read(run):
    times = run.stats.get("solve_s", ())
    if len(times) < 20:
        return None
    return statistics.quantiles(times, n=20)[-1] * 1e3

"""Products per second: 2 * nnz * R per request over the measured window,
from the first request to the synchronize after the last (host clock)."""


def read(run):
    if not run.requests or "solve_s" in run.stats:
        return None
    return 2.0 * run.nnz * run.rhs * run.requests / run.window_s / 1e9

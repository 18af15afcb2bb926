"""Time to a solution: the measured window over the solves completed in it
(host clock)."""


def read(run):
    if not run.requests or "solve_s" not in run.stats:
        return None
    return run.window_s * 1e3 / run.requests

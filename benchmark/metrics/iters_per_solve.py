"""The mean of the iterations ``cg`` returned in the measured window."""


def read(run):
    iters = run.stats.get("iters", ())
    return sum(iters) / len(iters) if iters else None

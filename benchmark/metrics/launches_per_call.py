"""Kernel launches a request, counted by the package's own wrappers
(``.launches``) over the measured window."""


def read(run):
    if not run.requests or "launches" not in run.counters:
        return None
    return run.counters["launches"] / run.requests

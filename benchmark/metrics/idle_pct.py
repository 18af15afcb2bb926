"""The device's idle share of the traced window: 1 - the union of its
activities' intervals over the window. Read for ``idle_pct.stream``,
``idle_pct.dd`` and ``idle_pct.solve``."""


def read(run):
    t = run.trace
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

"""The device's idle share of the traced window that begins while the
host waits on PageRank's stop test: the idle gaps the trace names by the
package's span ``solvers.pagerank.stop_test``, over the window."""

SPAN = "solvers.pagerank.stop_test"


def read(run):
    t = run.trace
    if not t or not t["window_s"]:
        return None
    idle = [s for name, s in t["gaps"] if name == SPAN]
    if not idle:
        return None
    return 100.0 * sum(idle) / t["window_s"]

"""Host reads a PageRank solve: the package's counter
``solvers.pagerank.host_reads`` (one a stop test) in the traced window,
over the window's solves."""

from benchmark.metrics.port_trace import counters

COUNTER = "solvers.pagerank.host_reads"


def read(run):
    t = run.trace
    n = counters().get(COUNTER)
    if not t or not t["requests"] or n is None:
        return None
    return n / t["requests"]

"""The SELL SpMV kernels' share of their roofline inside PageRank: the
least time of one product (``reference/roofline.py``: the cell's nnz,
rows, columns and precision against the card's peaks) times the matvecs of
the traced window, over the device time of the SELL SpMV kernels and of
the row-map gather (``row_gather_kernel``) among the trace's ten
operations with the most time. A matvec is one of the package's spans
``solvers.pagerank.matvec`` (an iteration of ``pagerank``) or
``solvers.pagerank.iteration`` (a replay of ``GraphedPageRank``'s captured
iteration, one matvec each). Whatever the loop around them does, this is
the kernels' own share. None where the package recorded no matvec or the
trace holds no SELL kernel."""

from benchmark.metrics.port_trace import spans
from benchmark.reference import roofline

MATVEC_SPANS = ("solvers.pagerank.matvec", "solvers.pagerank.iteration")
KERNELS = ("row_list_kernel", "k_major_kernel", "sg_kernel",
           "sg_join_kernel", "wl_kernel", "sb_kernel")
GATHER = "row_gather_kernel"


def read(run):
    t = run.trace
    peak = roofline.peaks(run.kind)
    held = spans()
    matvecs = sum(held.get(n, {}).get("count", 0) for n in MATVEC_SPANS)
    if not t or not matvecs or peak is None:
        return None
    sell = sum(s for name, s in t["ops"] if any(k in name for k in KERNELS))
    if not sell:
        return None
    sell += sum(s for name, s in t["ops"] if GATHER in name)
    nbytes, flops = roofline.count(run.nnz, run.nrows, run.ncols,
                                   run.precision, run.rhs)
    return 100.0 * matvecs * roofline.least_seconds(nbytes, flops, peak) \
        / sell

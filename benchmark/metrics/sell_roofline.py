"""The SELL SpMV or SpMM call's share of its roofline: the least time of a
request (``reference/roofline.py``: the cell's
nnz, rows, columns, precision and R against the card's peaks) over the
device time a request took in the traced window: every device activity of
the trace, summed, over the requests. Read for ``sell_roofline`` (f32
values) and ``sell_dd_roofline`` (double-double)."""

from benchmark.reference import roofline


def read(run):
    t = run.trace
    peak = roofline.peaks(run.kind)
    if not t or not t["requests"] or not t["device_s"] or peak is None:
        return None
    nbytes, ops = roofline.count(run.nnz, run.nrows, run.ncols,
                                 run.precision, run.rhs)
    per_request = t["device_s"] / t["requests"]
    return 100.0 * roofline.least_seconds(nbytes, ops, peak) / per_request

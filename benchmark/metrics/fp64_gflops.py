"""fp64-class products per second: 2 * nnz per request (a double-double
product counted as one multiply and one add, as the reference project
counts fp64) over the measured window (host clock)."""

from benchmark.metrics.gflops import read  # noqa: F401

"""The double-double SELL SpMV call's share of its roofline: as
``sell_roofline``, with 8-byte values, x and y."""

from benchmark.metrics.sell_roofline import read  # noqa: F401

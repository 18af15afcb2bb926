"""Metric readers, one file each, found by the metric's name (or the part
before its first dot): ``read(run)`` returns the value from a
:class:`benchmark.harness.core.Run`, or None where the run has nothing to
read."""

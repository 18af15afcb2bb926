"""The SpMV benchmark of the PyTorch and CUDA package.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line last on standard output. Everything a cell needs is found by name:

* ``configs/<config>.json``: the matrix (its generator in ``reference/``,
  its sizes, its source and the SELL layouts the conversion must give);
* ``traffic/<traffic>.json``: the mix (its client in ``clients/``, the
  precision, the banks of inputs, the sample that is checked);
* ``workloads/<cell>.json``: the limits that decide ``correct``, with the
  readings they were set from;
* ``metrics/<name>.py`` (or ``metrics/<name before the first dot>.py``):
  the reader of one metric.

``reference/`` is the yardstick: the matrix generators, the plain fp64
products and residuals, the roofline count and the table of peaks. It
imports nothing of the package under test.
"""

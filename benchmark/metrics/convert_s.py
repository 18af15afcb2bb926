"""The package's host conversions, ``CSRMatrix.from_coo`` and
``SellMatrix.from_csr`` (host clock)."""


def read(run):
    return run.spans.get("convert")

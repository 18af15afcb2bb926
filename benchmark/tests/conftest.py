"""The tiny sizes of the configurations added after the cell tests'
``TINY`` table was written: each test module that keeps such a table sees
them too."""

import pytest

TINY = {"gap_kron_s20": {"scale": 12, "edge_factor": 16}}


@pytest.fixture(autouse=True)
def _tiny_sizes(request, monkeypatch):
    table = getattr(request.module, "TINY", None)
    if isinstance(table, dict):
        for name, params in TINY.items():
            monkeypatch.setitem(table, name, params)

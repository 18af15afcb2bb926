"""RCM reordering against the JAX package, array-equal.

``formats/reorder.py`` is a copy of the JAX module: on the same CSR both
give the same permutation, permuted matrix and statistics, through scipy's
reverse Cuthill-McKee and through the numpy fallback that runs when scipy's
``csgraph`` cannot be imported (forced here by hiding that module).
"""

import sys

import numpy as np
import pytest

from sparsematrixvectormultiplication_tpu.formats import reorder as JR
from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix as JCSR
from sparsematrixvectormultiplication_tpu.models import synthetic as jsyn
from sparsematrixvectormultiplication_tpu_torch.formats import reorder as R
from sparsematrixvectormultiplication_tpu_torch.formats.coo import COOMatrix
from sparsematrixvectormultiplication_tpu_torch.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu_torch.models import synthetic as syn


def _scrambled_band(s, coo_cls):
    """A band matrix behind a random symmetric permutation: RCM brings the
    band back."""
    coo = s.banded(3000, 8, 40, seed=4)
    p = np.random.default_rng(4).permutation(coo.nrows).astype(np.int32)
    return coo_cls(coo.nrows, coo.ncols, p[coo.row], p[coo.col], coo.val)


MATRICES = {
    "road": lambda s, c: s.road_network(3000, seed=5),
    "scrambled_band": _scrambled_band,
    "fem": lambda s, c: s.fem_3d(5, 5, 5, dof=2, seed=1),
}


def _pair(name):
    from sparsematrixvectormultiplication_tpu.formats.coo import (
        COOMatrix as JCOO)

    return (CSRMatrix.from_coo(MATRICES[name](syn, COOMatrix)),
            JCSR.from_coo(MATRICES[name](jsyn, JCOO)))


def _same_csr(a, b):
    assert (a.nrows, a.ncols) == (b.nrows, b.ncols)
    for f in ("row_ptr", "col_idx", "values"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.fixture(params=["scipy", "numpy"])
def path(request, monkeypatch):
    if request.param == "numpy":  # scipy's csgraph unimportable
        monkeypatch.setitem(sys.modules, "scipy.sparse.csgraph", None)
    return request.param


@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_rcm_matches_jax(matrix, path):
    csr, jcsr = _pair(matrix)
    perm, jperm = R.rcm_permutation(csr), JR.rcm_permutation(jcsr)
    assert perm.dtype == jperm.dtype and np.array_equal(perm, jperm)
    assert np.array_equal(np.sort(perm), np.arange(csr.nrows))
    _same_csr(R.permute_csr(csr, perm), JR.permute_csr(jcsr, jperm))
    assert R.bandwidth_stats(csr) == JR.bandwidth_stats(jcsr)


def test_both_paths_bring_the_band_back():
    """Both paths are RCM: on the scrambled band each brings the p98
    bandwidth back below 2x the band's (40)."""
    csr, _ = _pair("scrambled_band")
    before = R.bandwidth_stats(csr)["p98"]
    for hide in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            if hide:
                mp.setitem(sys.modules, "scipy.sparse.csgraph", None)
            perm = R.rcm_permutation(csr)
        after = R.bandwidth_stats(R.permute_csr(csr, perm))["p98"]
        assert after < 80 < before, (hide, before, after)


@pytest.mark.parametrize("mode", ["rcm", "auto"])
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_reorder_rcm_matches_jax(matrix, mode):
    csr, jcsr = _pair(matrix)
    mine, perm, stats = R.reorder_rcm(csr, mode=mode)
    theirs, jperm, jstats = JR.reorder_rcm(jcsr, mode=mode)
    _same_csr(mine, theirs)
    assert (perm is None) == (jperm is None)
    if perm is not None:
        assert np.array_equal(perm, jperm)
    for key in ("mode", "applied", "bandwidth_before", "bandwidth_after",
                "p98_gain"):
        assert stats[key] == jstats[key], key


def test_reorder_refuses_rectangles_like_jax():
    coo = syn.random_general(300, 500, 0.01, seed=1)
    csr = CSRMatrix.from_coo(coo)
    out, perm, stats = R.reorder_rcm(csr)
    assert out is csr and perm is None and stats["reason"] == "non-square"
    with pytest.raises(ValueError, match="square"):
        R.rcm_permutation(csr)

"""HLL, ELL, CSR and XLA-style SELL twins against the JAX package.

The port's ``formats/hll.py`` is held array-equal to the JAX one; its
``ops/xla.py`` (``ell_spmv``, ``DeviceCSR``, ``sell_spmv_xla``) and
``ops/hll.py`` (``hll_to_sell``, run by ``sell_spmv``) against the JAX
functions on the same host arrays. Tolerance: rtol=1e-6, atol=1e-6*max|y| for f32 results
(f32 sums in another order); the bf16-valued and f64 uploads hold their
oracles to the same bar in their own types.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix as JCSR
from sparsematrixvectormultiplication_tpu.formats.hll import HLLMatrix as JHLL
from sparsematrixvectormultiplication_tpu.formats.sell import SellMatrix as JSell
from sparsematrixvectormultiplication_tpu.models import synthetic as jsyn
from sparsematrixvectormultiplication_tpu.ops import pallas_hll as JPH
from sparsematrixvectormultiplication_tpu.ops import xla as JX
from sparsematrixvectormultiplication_tpu.ops.pallas_sell import (
    device_put_sell as jax_device_put_sell,
    device_put_x as jax_device_put_x,
)
from sparsematrixvectormultiplication_tpu_torch.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu_torch.formats.hll import HLLMatrix
from sparsematrixvectormultiplication_tpu_torch.formats.sell import SellMatrix
from sparsematrixvectormultiplication_tpu_torch.models import synthetic as syn
from sparsematrixvectormultiplication_tpu_torch.ops import hll as H
from sparsematrixvectormultiplication_tpu_torch.ops import xla as X
from sparsematrixvectormultiplication_tpu_torch.ops.sell import (
    device_put_sell,
    device_put_x,
    sell_spmv,
)

MATRICES = {
    "banded": lambda s: s.banded(3000, 12, 200, seed=2),
    "fem": lambda s: s.fem_3d(6, 6, 6, dof=3, seed=1),
    "power_law": lambda s: s.power_law(2000, 3, seed=6),
    "road": lambda s: s.road_network(2500, seed=5),
}


def _csrs(name):
    return (CSRMatrix.from_coo(MATRICES[name](syn)),
            JCSR.from_coo(MATRICES[name](jsyn)))


def _x(n, seed=3):
    return np.random.default_rng(seed).standard_normal(n)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("hack", [32, 7])
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_hll_from_csr_is_array_equal(matrix, hack):
    csr, jcsr = _csrs(matrix)
    mine, theirs = HLLMatrix.from_csr(csr, hack), JHLL.from_csr(jcsr, hack)
    for f in ("nrows", "ncols", "nnz", "hack_size"):
        assert getattr(mine, f) == getattr(theirs, f), f
    for f in ("maxnz", "offsets", "ja", "as_"):
        a, b = getattr(mine, f), getattr(theirs, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert mine.memory_stats() == theirs.memory_stats()
    x = _x(csr.ncols)
    assert np.array_equal(mine.spmv(x), theirs.spmv(x))
    for a, b in zip(mine.to_rect(), theirs.to_rect()):
        assert np.array_equal(a, b)
    with pytest.raises(MemoryError):
        mine.to_rect(max_elements=10)


@pytest.mark.parametrize("matrix", ["banded", "fem", "road"])
def test_hll_to_sell_matches_jax(matrix):
    """The repack keeps the padding slots: the same bins and planes as the
    JAX hll_to_sell, and the same SpMV as the serial HLL."""
    csr, jcsr = _csrs(matrix)
    mine = H.hll_to_sell(HLLMatrix.from_csr(csr))
    theirs = JPH.hll_to_sell(JHLL.from_csr(jcsr))
    assert [(b.layout, b.k, b.n_groups) for b in mine.bins] == [
        (b.layout, b.k, b.n_groups) for b in theirs.bins]
    for a, b in zip(mine.bins, theirs.bins):
        assert np.array_equal(a.ja, b.ja) and np.array_equal(a.as_, b.as_)
    # the JAX package's host HLL uploads the same way
    assert [b.layout for b in device_put_sell(
        H.hll_to_sell(JHLL.from_csr(jcsr)), device="cpu").bins] == [
        b.layout for b in mine.bins]


def test_hll_spmv_matches_jax_pallas_hll():
    """hll_to_sell through sell_spmv (the plain SELL versions on the CPU)
    against the JAX hll_spmv_pallas in interpret mode on the same HLL."""
    csr, jcsr = _csrs("fem")
    hll = JHLL.from_csr(jcsr)
    x = _x(csr.ncols).astype(np.float32)
    want = np.asarray(JPH.hll_spmv_pallas(
        JPH.device_put_hll_pallas(hll), jax_device_put_x(x, csr.ncols),
        interpret=True))[: csr.nrows]
    got = sell_spmv(device_put_sell(H.hll_to_sell(hll), device="cpu"),
                    device_put_x(x, csr.ncols, device="cpu")).numpy()
    _close(got, want)
    _close(got, csr.spmv(x.astype(np.float64)))


@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_ell_and_csr_twins_match_jax(matrix):
    csr, jcsr = _csrs(matrix)
    hll = JHLL.from_csr(jcsr)
    x = _x(csr.ncols).astype(np.float32)
    ja, as_ = hll.to_rect()
    want = np.asarray(JX.ell_spmv(jnp.asarray(ja), jnp.asarray(
        as_.astype(np.float32)), jnp.asarray(x)))
    got = X.ell_spmv(torch.from_numpy(ja), torch.from_numpy(
        as_.astype(np.float32)), torch.from_numpy(x)).numpy()
    _close(got, want)
    dell = X.device_put_ell(HLLMatrix.from_csr(csr), device="cpu")
    _close(dell.spmv(torch.from_numpy(x)).numpy(), want[: csr.nrows])
    jd = JX.device_put_csr(jcsr, dtype=jnp.float32)
    want = np.asarray(jd.spmv(jnp.asarray(x)))
    for host in (csr, jcsr):  # either package's host CSR uploads
        d = X.device_put_csr(host, device="cpu")
        assert d.nnz == csr.nnz and d.values.dtype == torch.float32
        _close(d.spmv(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_csr_and_ell_uploads_keep_the_jax_value_type(dtype):
    """bf16 values round as the JAX upload rounds them and sum in f32 (the
    oracle of the rounded values); f64 values sum in f64."""
    csr, _ = _csrs("banded")
    x = _x(csr.ncols)
    xt = torch.from_numpy(x).to(dtype)
    vals = torch.from_numpy(csr.values).to(dtype).double().numpy()
    ref = CSRMatrix(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                    vals).spmv(xt.double().numpy())
    d = X.device_put_csr(csr, dtype, device="cpu")
    e = X.device_put_ell(HLLMatrix.from_csr(csr), dtype, device="cpu")
    assert d.values.dtype == dtype and e.as_.dtype == dtype
    for y in (d.spmv(xt), e.spmv(xt)):
        assert y.dtype == (torch.float64 if dtype == torch.float64
                           else torch.float32)
        tol = 1e-12 if dtype == torch.float64 else 1e-6
        np.testing.assert_allclose(y.double().numpy(), ref, rtol=tol,
                                   atol=tol * np.abs(ref).max())


def test_upload_guard_states_its_cap_in_bytes(monkeypatch):
    csr, _ = _csrs("banded")
    monkeypatch.setattr(X, "MAX_UPLOAD_BYTES", 1024)
    with pytest.raises(MemoryError, match="MAX_UPLOAD_BYTES"):
        X.device_put_csr(csr, device="cpu")
    with pytest.raises(MemoryError, match="MAX_UPLOAD_BYTES"):
        X.device_put_ell(HLLMatrix.from_csr(csr), device="cpu")


# layout -> (matrix, SellMatrix.from_csr keywords)
XLA_CASES = {
    "k-major": (lambda s: s.banded(3000, 12, 200, seed=2),
                {"layout": "k-major"}),
    "sb-major": (lambda s: s.banded(5 * 1024, 24, 512, seed=0),
                 {"layout": "sb-major"}),
}


@pytest.mark.parametrize("layout", sorted(XLA_CASES))
def test_sell_spmv_xla_matches_jax_on_k_and_sb_major(layout):
    make, kw = XLA_CASES[layout]
    csr, jcsr = CSRMatrix.from_coo(make(syn)), JCSR.from_coo(make(jsyn))
    sell, jsell = SellMatrix.from_csr(csr, **kw), JSell.from_csr(jcsr, **kw)
    assert {b.layout for b in sell.bins} == {layout}
    assert not any(b.add_into for b in sell.bins)
    x = _x(csr.ncols).astype(np.float32)
    want = np.asarray(JX.sell_spmv_xla(
        jax_device_put_sell(jsell, jnp.float32, resident=False),
        jax_device_put_x(x, csr.ncols)))
    d = device_put_sell(sell, device="cpu")
    got = X.sell_spmv_xla(d, device_put_x(x, csr.ncols, device="cpu"))
    assert got.shape == want.shape
    _close(got.numpy(), want)
    # and the JAX host SELL through the port's upload
    got_j = X.sell_spmv_xla(device_put_sell(jsell, device="cpu"),
                            device_put_x(x, csr.ncols, device="cpu"))
    assert torch.equal(got, got_j)


def test_sell_spmv_xla_adds_add_into_bins():
    """A matrix whose sg conversion puts far entries in add_into k-major
    bins: forced to k-major, the far bins still add onto the core rows, and
    the result is the fp64 oracle's (the JAX version would overwrite)."""
    csr = CSRMatrix.from_coo(syn.random_general(20000, 20000, 2.5e-4, seed=8))
    csr_k, seg = csr.split_heavy_rows(16, strided=True)
    sell = SellMatrix.from_csr(csr_k)
    adds = [b for b in sell.bins if b.add_into]
    assert adds and {b.layout for b in adds} == {"k-major"}
    core = [b for b in sell.bins if not b.add_into]
    x = _x(csr.ncols).astype(np.float32)
    xt = device_put_x(x, csr.ncols, device="cpu")
    d = device_put_sell(sell, device="cpu")
    # only the add_into bins: y must be their sums alone, added onto zeros
    d.bins = [b for b in d.bins if b.add_into]
    got = X.sell_spmv_xla(d, xt)[: csr_k.nrows].numpy()
    d.bins = [b for b in device_put_sell(sell, device="cpu").bins]
    with pytest.raises(ValueError, match="k-major and sb-major"):
        X.sell_spmv_xla(d, xt)  # the core bins are sg
    full = sell_spmv(d, xt).numpy()
    d.bins = [b for b in d.bins if not b.add_into]
    core_only = sell_spmv(d, xt).numpy()
    _close(got + core_only, full)
    assert core and np.abs(got).max() > 0
    # one add_into bin once as a core bin, once adding onto it: twice
    far = [b for b in device_put_sell(sell, device="cpu").bins
           if b.add_into][0]
    d.bins = [far]
    once = X.sell_spmv_xla(d, xt)
    d.bins = [dataclasses.replace(far, add_into=False), far]
    _close(X.sell_spmv_xla(d, xt).numpy(), 2 * once.numpy())
    assert once.abs().max() > 0


@pytest.mark.parametrize("layout", ["wl", "sg"])
def test_sell_spmv_xla_raises_on_other_layouts(layout):
    make = {"wl": lambda: syn.fem_3d(20, 20, 20, dof=3, seed=1),
            "sg": lambda: syn.road_network(20_000, seed=5)}[layout]
    csr = CSRMatrix.from_coo(make())
    sell = SellMatrix.from_csr(csr, layout=layout)
    assert layout in {b.layout for b in sell.bins}
    with pytest.raises(ValueError, match="k-major and sb-major"):
        X.sell_spmv_xla(device_put_sell(sell, device="cpu"),
                        device_put_x(np.ones(csr.ncols), csr.ncols,
                                     device="cpu"))


def test_sb_i16_planes_are_refused():
    csr = CSRMatrix.from_coo(syn.banded(5 * 1024, 24, 512, seed=0))
    d = device_put_sell(SellMatrix.from_csr(csr, layout="sb-major"),
                        device="cpu", sb_i16=True)
    assert any(b.ja.dtype == torch.int16 for b in d.bins)
    with pytest.raises(ValueError, match="int16"):
        X.sell_spmv_xla(d, device_put_x(np.ones(csr.ncols), csr.ncols,
                                        device="cpu"))

"""The port's solvers (``sparsematrixvectormultiplication_tpu_torch.solvers``)
against the JAX package's, on the same seeded inputs.

- fp64 over the CSR containers (JAX ``ops/xla.device_put_csr`` in float64
  under conftest's x64, the port's ``device_put_csr(..., torch.float64,
  device="cpu")``): equal iteration counts and x within 1e-10 relative
  (``max|x_port - x_jax| / max|x_jax|``); Lanczos alphas and betas within
  1e-10.
- f32 CG over SELL: JAX ``cg_sell(..., interpret=True)`` against the port's
  ``cg_sell`` on the CPU's plain kernels: iteration counts within 2, x
  within 1e-4 relative of JAX's, both within the JAX test's 5e-3 of the
  dense solve. ``cg_multi`` over BSR alike (JAX's interpret BSR kernel, the
  port's plain ``bsr_spmm``).
- Subspace iteration over SELL SpMM (JAX interpret kernel, the port's plain
  ``sell_spmm``): Ritz values within 1e-4 relative, bases equal up to column
  signs, ``|Q_port^T Q_jax| ≈ I`` within 1e-3.
- Iterative refinement: the port's numpy copy and the JAX module give
  ``array_equal`` results for the same numpy callables.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sparsematrixvectormultiplication_tpu import solvers as J
from sparsematrixvectormultiplication_tpu.formats.bsr import BSRMatrix as JBSR
from sparsematrixvectormultiplication_tpu.formats.coo import COOMatrix as JCOO
from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix as JCSR
from sparsematrixvectormultiplication_tpu.formats.sell import (
    SellMatrix as JSell,
)
from sparsematrixvectormultiplication_tpu.ops.pallas_bsr import (
    bsr_spmm_pallas,
    device_put_bsr as jax_put_bsr,
)
from sparsematrixvectormultiplication_tpu.ops.pallas_sell import (
    device_put_sell as jax_put_sell,
)
from sparsematrixvectormultiplication_tpu.ops.pallas_sell_spmm import (
    sell_spmm_pallas,
)
from sparsematrixvectormultiplication_tpu.ops.xla import (
    csr_spmm as jax_csr_spmm,
    device_put_csr as jax_put_csr,
)
from sparsematrixvectormultiplication_tpu.solvers import refine as jax_refine
from sparsematrixvectormultiplication_tpu_torch import (
    BSRMatrix,
    COOMatrix,
    CSRMatrix,
    SellMatrix,
    bsr_spmm,
    device_put_bsr,
    device_put_csr,
    device_put_sell,
    device_put_sell_dd,
    sell_spmm,
    sell_spmv_dd_f64,
)
from sparsematrixvectormultiplication_tpu_torch import solvers as T
from sparsematrixvectormultiplication_tpu_torch.models.synthetic import (
    banded,
    power_law,
)
from sparsematrixvectormultiplication_tpu_torch.ops.xla import csr_spmm
from sparsematrixvectormultiplication_tpu_torch.solvers.chebyshev import (
    chebyshev_coefficients,
)

CPU = torch.device("cpu")
F64_RTOL = 1e-10


def _both(a, n):
    """The JAX package's and the port's CSRMatrix of scipy matrix ``a``."""
    a = a.tocoo()
    args = (n, n, a.row.astype(np.int32), a.col.astype(np.int32),
            a.data.astype(np.float64))
    return JCSR.from_coo(JCOO(*args)), CSRMatrix.from_coo(COOMatrix(*args))


def _spd(n=1500, seed=3):
    """tests/test_solvers.py's ``_spd_csr``: B + B^T + c I, c above the
    largest absolute row sum (symmetric diagonally dominant, so SPD)."""
    coo = banded(n, 9, 40, seed=seed)
    m = sp.coo_matrix((coo.val, (coo.row, coo.col)), shape=(n, n))
    a = m + m.T
    a = a + sp.eye(n) * (np.abs(a).sum(axis=1).max() + 1.0)
    return (*_both(a, n), a.toarray())


def _nonsym(n=900, seed=7):
    """tests/test_solvers.py's ``_nonsym_dd_csr``: a general band plus a
    dominant diagonal, nonsingular and not symmetric."""
    coo = banded(n, 7, 25, seed=seed)
    m = sp.coo_matrix((coo.val, (coo.row, coo.col)), shape=(n, n))
    a = m + sp.eye(n) * (np.abs(m).sum(axis=1).max() + 1.0)
    return (*_both(a, n), a.toarray())


def _jacobi_case(n=1000, seed=11):
    """The JAX Jacobi test's matrix: the SPD band with a diagonal scaling
    over eight orders of magnitude."""
    _, _, dense = _spd(n, seed)
    scale = np.exp(np.linspace(0, 8, n))
    dense = dense * scale[:, None] * scale[None, :]
    return (*_both(sp.coo_matrix(dense), n), dense)


def _f64(jcsr, tcsr):
    return (jax_put_csr(jcsr, dtype=jnp.float64),
            device_put_csr(tcsr, torch.float64, device=CPU))


def _rhs(n, seed, k=None):
    shape = n if k is None else (n, k)
    return np.random.default_rng(seed).standard_normal(shape)


def _case_cg():
    jc, tc, _ = _spd()
    jd, td = _f64(jc, tc)
    b = _rhs(jc.nrows, 0)
    xj, kj, _ = J.cg_sell(jd, jnp.asarray(b), tol=1e-10, maxiter=500)
    xt, kt, _ = T.cg_sell(td, torch.from_numpy(b), tol=1e-10, maxiter=500)
    return xj, kj, xt, kt


def _case_pcg_jacobi():
    jc, tc, _ = _jacobi_case()
    jd, td = _f64(jc, tc)
    b = _rhs(jc.nrows, 4)
    mj = J.jacobi_preconditioner(jc, jnp.float64)
    mt = T.jacobi_preconditioner(tc, torch.float64, device=CPU)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    xj, kj, _ = J.cg(jd.spmv, jnp.asarray(b), tol=1e-10, maxiter=3000,
                     minv=mj)
    xt, kt, _ = T.cg(td.spmv, torch.from_numpy(b), tol=1e-10, maxiter=3000,
                     minv=mt)
    return xj, kj, xt, kt


def _case_pcg_chebyshev():
    jc, tc, _ = _spd(1200, 13)
    jd, td = _f64(jc, tc)
    b = _rhs(jc.nrows, 5)
    bounds = T.gershgorin_bounds(tc)
    assert bounds == J.gershgorin_bounds(jc)
    xj, kj, _ = J.cg(jd.spmv, jnp.asarray(b), tol=1e-10, maxiter=3000,
                     prec=J.chebyshev_preconditioner(jd.spmv, *bounds,
                                                     degree=4))
    xt, kt, _ = T.cg(td.spmv, torch.from_numpy(b), tol=1e-10, maxiter=3000,
                     prec=T.chebyshev_preconditioner(td.spmv, *bounds,
                                                     degree=4))
    return xj, kj, xt, kt


def _case_bicgstab():
    jc, tc, dense = _nonsym()
    assert not np.allclose(dense, dense.T)
    jd, td = _f64(jc, tc)
    b = _rhs(jc.nrows, 2)
    xj, kj, _ = J.bicgstab(jd.spmv, jnp.asarray(b), tol=1e-10, maxiter=500)
    xt, kt, _ = T.bicgstab(td.spmv, torch.from_numpy(b), tol=1e-10,
                           maxiter=500)
    return xj, kj, xt, kt


def _case_gmres_restarts():
    """restart=5 on the nonsymmetric band: more than two cycles."""
    jc, tc, _ = _nonsym()
    jd, td = _f64(jc, tc)
    b = _rhs(jc.nrows, 1)
    xj, kj, _ = J.gmres(jd.spmv, jnp.asarray(b), tol=1e-10, restart=5,
                        maxiter=600)
    xt, kt, _ = T.gmres(td.spmv, torch.from_numpy(b), tol=1e-10, restart=5,
                        maxiter=600)
    assert kt > 10, "the case must restart at least twice"
    return xj, kj, xt, kt


def _case_gmres_dense():
    """The JAX restart test's dense system at restart 8, from a warm start
    halfway to the solution."""
    rng = np.random.default_rng(2)
    n = 150
    a = np.eye(n) * 4 + rng.normal(size=(n, n)) * 0.25
    b = rng.standard_normal(n)
    x0 = 0.5 * np.linalg.solve(a, b)
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    xj, kj, _ = J.gmres(lambda v: aj @ v, jnp.asarray(b), x0=jnp.asarray(x0),
                        restart=8, tol=1e-9, maxiter=2000)
    xt, kt, _ = T.gmres(lambda v: at @ v, torch.from_numpy(b),
                        x0=torch.from_numpy(x0), restart=8, tol=1e-9,
                        maxiter=2000)
    assert kt > 16
    return xj, kj, xt, kt


def _case_cg_multi():
    jc, tc, _ = _spd(800, 9)
    B = _rhs(jc.nrows, 3, 5)
    jd, td = _f64(jc, tc)
    xj, kj, _ = J.cg_multi(
        lambda V: jax_csr_spmm(jd.values, jd.col_idx, jd.row_ids, V,
                               nrows=jd.nrows),
        jnp.asarray(B), tol=1e-10, maxiter=400)
    xt, kt, _ = T.cg_multi(
        lambda V: csr_spmm(td.values, td.col_idx, td.row_ids, V,
                           nrows=td.nrows),
        torch.from_numpy(B), tol=1e-10, maxiter=400)
    return xj, kj, xt, kt


def _case_power():
    jc, tc, _ = _spd(400, 15)
    jd, td = _f64(jc, tc)
    v0 = _rhs(jc.nrows, 6)
    lj, vj, kj = J.power_iteration(jd.spmv, jnp.asarray(v0), tol=1e-12,
                                   maxiter=5000)
    lt, vt, kt = T.power_iteration(td.spmv, torch.from_numpy(v0), tol=1e-12,
                                   maxiter=5000)
    assert abs(float(lt) - float(lj)) <= F64_RTOL * abs(float(lj))
    return vj, kj, vt, kt


def _case_pagerank():
    coo = power_law(500, 5, seed=17)
    a = sp.coo_matrix((np.abs(coo.val), (coo.row, coo.col)),
                      shape=coo.shape)
    jc, tc = _both(a, coo.nrows)
    tj, dj = J.pagerank_operator(jc)
    tt, dt = T.pagerank_operator(tc)
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(tt.values, tj.values)
    jd, td = _f64(tj, tt)
    pj, kj, _ = J.pagerank(jd.spmv, jnp.asarray(dj), alpha=0.85, tol=1e-12,
                           maxiter=500)
    # a float64 mask: p in float64, as JAX's default float under x64
    pt, kt, _ = T.pagerank(td.spmv, torch.from_numpy(dt.astype(np.float64)),
                           alpha=0.85, tol=1e-12, maxiter=500)
    assert pt.dtype == torch.float64 and abs(float(pt.sum()) - 1.0) < 1e-9
    return pj, kj, pt, kt


FP64_CASES = {
    "cg": _case_cg, "pcg_jacobi": _case_pcg_jacobi,
    "pcg_chebyshev": _case_pcg_chebyshev, "bicgstab": _case_bicgstab,
    "gmres_restarts": _case_gmres_restarts, "gmres_dense": _case_gmres_dense,
    "cg_multi": _case_cg_multi, "power_iteration": _case_power,
    "pagerank": _case_pagerank,
}


@pytest.mark.parametrize("case", list(FP64_CASES))
def test_fp64_matches_jax(case):
    xj, kj, xt, kt = FP64_CASES[case]()
    assert isinstance(kt, int)
    assert kt == int(kj), (kt, int(kj))
    xj = np.asarray(xj)
    assert xt.dtype == torch.float64
    err = np.abs(xt.numpy() - xj).max() / np.abs(xj).max()
    assert err <= F64_RTOL, err


def test_gmres_warm_start_exits_at_once():
    rng = np.random.default_rng(2)
    n = 150
    a = np.eye(n) * 4 + rng.normal(size=(n, n)) * 0.25
    b = rng.standard_normal(n)
    x0 = np.linalg.solve(a, b)
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    _, kj, rj = J.gmres(lambda v: aj @ v, jnp.asarray(b),
                        x0=jnp.asarray(x0), restart=16, tol=1e-8)
    xt, kt, rt = T.gmres(lambda v: at @ v, torch.from_numpy(b),
                         x0=torch.from_numpy(x0), restart=16, tol=1e-8)
    assert kt == int(kj) == 0
    assert float(rt) < 1e-8 * np.linalg.norm(b) * 10
    np.testing.assert_array_equal(xt.numpy(), x0)


@pytest.mark.parametrize("m,seed,n", [(40, 5, 600), (60, 11, 800)])
def test_lanczos_matches_jax(m, seed, n):
    jc, tc, dense = _spd(n, seed)
    jd, td = _f64(jc, tc)
    v0 = _rhs(n, 2)
    aj, bj, Vj = J.lanczos(jd.spmv, jnp.asarray(v0), m=m)
    at, bt, Vt = T.lanczos(td.spmv, torch.from_numpy(v0), m=m)
    for got, want in ((at, aj), (bt, bj)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= F64_RTOL * np.abs(
            want).max()
    np.testing.assert_allclose(Vt.numpy() @ Vt.numpy().T, np.eye(m),
                               atol=1e-10)
    ej = J.lanczos_extremal(jd.spmv, jnp.asarray(v0), m=m)
    et = T.lanczos_extremal(td.spmv, torch.from_numpy(v0), m=m)
    np.testing.assert_allclose(et, ej, rtol=F64_RTOL)
    w = np.linalg.eigvalsh(dense)
    assert et[0] >= w[0] - 1e-8 * abs(w[0]) and et[1] <= w[-1] * (1 + 1e-8)
    bounds_j = J.lanczos_bounds(jd.spmv, n, m=m, dtype=jnp.float64)
    bounds_t = T.lanczos_bounds(td.spmv, n, m=m, dtype=torch.float64,
                                device=CPU)
    np.testing.assert_allclose(bounds_t, bounds_j, rtol=F64_RTOL)


def test_cg_sell_f32_matches_jax():
    """JAX test_cg_pallas_sell_f32's system through both packages' SELL
    kernels: JAX's in interpret mode, the port's plain versions."""
    jc, tc, dense = _spd(1200, 5)
    b = _rhs(jc.nrows, 1)
    x_ref = np.linalg.solve(dense, b)
    dj = jax_put_sell(JSell.from_csr(jc), dtype=jnp.float32)
    sell = SellMatrix.from_csr(tc)
    assert sell.row_perm is None
    dt = device_put_sell(sell, device=CPU)
    xj, kj, _ = J.cg_sell(dj, jnp.asarray(b, jnp.float32), tol=1e-5,
                          maxiter=400, interpret=True)
    xt, kt, _ = T.cg_sell(dt, torch.from_numpy(b).float(), tol=1e-5,
                          maxiter=400)
    assert kt < 400 and abs(kt - int(kj)) <= 2, (kt, int(kj))
    xj = np.asarray(xj, np.float64)
    xt = xt.double().numpy()
    assert np.abs(xt - xj).max() / np.abs(xj).max() <= 1e-4
    for x in (xj, xt):
        rel = np.abs(x - x_ref) / np.maximum(1.0, np.abs(x_ref))
        assert rel.max() < 5e-3, rel.max()


def test_cg_sell_sigma_sorted_is_refused():
    """A fault of the reference: the JAX ``cg_sell`` runs a SELL-C-sigma
    matrix, whose kernel returns y in sorted row order, as if it were ``A @
    x``, and returns a wrong x (here not even finite). The port raises."""
    jc, tc, _ = _spd(1200, 5)
    b = _rhs(jc.nrows, 1)
    jsell = JSell.from_csr(jc, sigma_sort=True)
    assert not np.array_equal(jsell.row_perm, np.arange(jc.nrows))
    xj, _, _ = J.cg_sell(jax_put_sell(jsell, dtype=jnp.float32),
                         jnp.asarray(b, jnp.float32), tol=1e-5, maxiter=400,
                         interpret=True)
    xj = np.asarray(xj, np.float64)
    res = np.linalg.norm(b - tc.spmv(xj)) / np.linalg.norm(b)
    assert not res < 1e-2, res
    for sell in (SellMatrix.from_csr(tc, sigma_sort=True), jsell):
        with pytest.raises(ValueError, match="sigma"):
            T.cg_sell(device_put_sell(sell, device=CPU),
                      torch.from_numpy(b).float())


def test_cg_multi_bsr_matches_jax():
    """tests/test_solvers.py's BSR case: the JAX interpret kernel against
    the port's plain bsr_spmm."""
    jc, tc, dense = _spd(800, 9)
    B = _rhs(jc.nrows, 3, 5)
    x_ref = np.linalg.solve(dense, B)
    dj = jax_put_bsr(JBSR.from_csr(jc))
    dt = device_put_bsr(BSRMatrix.from_csr(tc), device=CPU)
    xj, kj, _ = J.cg_multi(lambda V: bsr_spmm_pallas(dj, V, interpret=True),
                           jnp.asarray(B, jnp.float32), tol=1e-5, maxiter=400)
    xt, kt, rt = T.cg_multi(lambda V: bsr_spmm(dt, V),
                            torch.from_numpy(B).float(), tol=1e-5,
                            maxiter=400)
    assert kt < 400 and abs(kt - int(kj)) <= 2, (kt, int(kj))
    assert rt.shape == (5,)
    xj = np.asarray(xj, np.float64)
    xt = xt.double().numpy()
    assert np.abs(xt - xj).max() / np.abs(xj).max() <= 1e-4
    for x in (xj, xt):
        rel = np.abs(x - x_ref) / np.maximum(1.0, np.abs(x_ref))
        assert rel.max() < 5e-3, rel.max()


def _gapped_sym(n, k):
    """tests/test_subspace.py's matrix: top-k diagonal 2k, 2k-2, ..., 2 and
    a weak tridiagonal coupling, so the top k are well separated."""
    diag = np.full(n, 0.5)
    diag[:k] = 2.0 * np.arange(k, 0, -1)
    off = np.full(n - 1, 0.01)
    a = sp.diags([off, diag, off], [-1, 0, 1], shape=(n, n))
    return _both(a, n)


def test_subspace_matches_jax():
    n, k = 512, 4
    jc, tc = _gapped_sym(n, k)
    dj = jax_put_sell(JSell.from_csr(jc, layout="k-major"),
                      dtype=jnp.float32, resident=False)
    dt = device_put_sell(SellMatrix.from_csr(tc, layout="k-major"),
                         device=CPU)
    Q0 = _rhs(n, 0, k).astype(np.float32)
    wj, Qj, itj, rj = J.subspace_iteration(
        lambda V: sell_spmm_pallas(dj, V, interpret=True)[:n],
        jnp.asarray(Q0), tol=1e-5, maxiter=300)
    wt, Qt, itt, rt = T.subspace_iteration(lambda V: sell_spmm(dt, V),
                                           torch.from_numpy(Q0), tol=1e-5,
                                           maxiter=300)
    assert isinstance(itt, int) and itt < 300 and float(rt) <= 1e-5
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-4)
    overlap = np.abs(Qt.numpy().T @ np.asarray(Qj))
    np.testing.assert_allclose(overlap, np.eye(k), atol=1e-3)
    dense = np.sort(np.linalg.eigvalsh(tc.to_dense()))[::-1]
    np.testing.assert_allclose(np.sort(wt.numpy())[::-1], dense[:k],
                               rtol=1e-4)


def _laplacian(n, shift=4.0):
    """tests/test_refine.py's ``_spd_laplacian``: tridiagonal -1, 2 + shift,
    -1."""
    a = sp.diags([-np.ones(n - 1), np.full(n, 2.0 + shift),
                  -np.ones(n - 1)], [-1, 0, 1], shape=(n, n))
    return _both(a, n)[1]


def _jacobi_sweeps(csr):
    def inner(r):
        x = r / 6.0
        for _ in range(2):
            x = x + (r - csr.spmv(x)) / 6.0
        return x
    return inner


# case -> (n, inner solve of the port's CSR, b, keywords)
REFINE_CASES = {
    "stagnation": (256, lambda csr: (lambda r: np.zeros_like(r)),
                   lambda n: np.ones(n), {"tol": 1e-14, "max_sweeps": 20}),
    "zero_rhs": (128, lambda csr: (lambda r: r), np.zeros, {}),
    "slow_contraction": (512, _jacobi_sweeps,
                         lambda n: _rhs(n, 2), {"tol": 1e-10,
                                                "max_sweeps": 60}),
    "max_sweeps": (512, _jacobi_sweeps, lambda n: _rhs(n, 3),
                   {"tol": 1e-14, "max_sweeps": 4}),
}


@pytest.mark.parametrize("case", list(REFINE_CASES))
def test_refinement_copy_equals_jax(case):
    n, make_inner, make_b, kw = REFINE_CASES[case]
    csr = _laplacian(n)
    b = make_b(n)
    got = T.iterative_refinement(make_inner(csr), csr.spmv, b, **kw)
    want = jax_refine.iterative_refinement(make_inner(csr), csr.spmv, b,
                                           **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[2] == want[2]


def test_refinement_bf16_inner_dd_residual():
    """The smoke's composition at a small size on the CPU's plain kernels:
    inner CG over the bf16 SELL at tol 1e-2, maxiter 50; residuals through
    ``sell_spmv_dd_f64``; the fp64 oracle's residual reaches 1e-12."""
    csr = _laplacian(1536)
    sell = SellMatrix.from_csr(csr)
    dbf = device_put_sell(sell, torch.bfloat16, device=CPU)
    ddd = device_put_sell_dd(sell, device=CPU)

    def inner(r):
        return T.cg_sell(dbf, torch.from_numpy(r).float(), tol=1e-2,
                         maxiter=50)[0].numpy()

    def matvec_dd(v):
        return sell_spmv_dd_f64(ddd, torch.from_numpy(v)).numpy()

    b = _rhs(csr.nrows, 0)
    x, sweeps, resnorms = T.iterative_refinement(inner, matvec_dd, b,
                                                 tol=1e-12)
    assert resnorms[-1] <= 1e-12 and sweeps <= 12, resnorms
    assert np.linalg.norm(b - csr.spmv(x)) / np.linalg.norm(b) <= 1e-12


def test_power_iteration_breakdown_is_clean():
    """A @ v == 0 (nilpotent A) stops cleanly, with JAX's answer."""
    A = np.zeros((4, 4))
    A[0, 1] = 1.0
    v0 = np.array([0.0, 1.0, 0.0, 0.0])
    lj, vj, kj = J.power_iteration(lambda u: jnp.asarray(A) @ u,
                                   jnp.asarray(v0), maxiter=50)
    At = torch.from_numpy(A)
    lt, vt, kt = T.power_iteration(lambda u: At @ u, torch.from_numpy(v0),
                                   maxiter=50)
    assert torch.isfinite(vt).all() and np.isfinite(float(lt))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert float(lt) == float(lj) and kt == int(kj)


def test_lanczos_breakdown_invariant_subspace():
    """A start vector in a 2-dimensional invariant subspace: the breakdown
    freezes cleanly and both of its eigenvalues come back."""
    n = 64
    diag = np.arange(1.0, n + 1.0)
    v0 = np.zeros(n)
    v0[3], v0[7] = 1.0, 2.0
    Aj, At = jnp.asarray(np.diag(diag)), torch.from_numpy(np.diag(diag))
    ej = J.lanczos_extremal(lambda v: Aj @ v, jnp.asarray(v0), m=10)
    et = T.lanczos_extremal(lambda v: At @ v, torch.from_numpy(v0), m=10)
    np.testing.assert_allclose(et, (diag[3], diag[7]), rtol=1e-12)
    np.testing.assert_allclose(et, ej, rtol=1e-12)


def test_chebyshev_smooth_matches_jax():
    _, tc, dense = _spd(300, 17)
    rng = np.random.default_rng(6)
    b, x0 = rng.standard_normal(tc.nrows), rng.standard_normal(tc.nrows)
    lam = np.linalg.eigvalsh(dense)
    kw = {"lmin": float(lam[0]), "lmax": float(lam[-1]), "degree": 6}
    Aj, At = jnp.asarray(dense), torch.from_numpy(dense)
    xj = J.chebyshev_smooth(lambda v: Aj @ v, jnp.asarray(b),
                            jnp.asarray(x0), **kw)
    xt = T.chebyshev_smooth(lambda v: At @ v, torch.from_numpy(b),
                            torch.from_numpy(x0), **kw)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-12,
                               atol=1e-12)
    r0 = np.linalg.norm(b - dense @ x0)
    assert np.linalg.norm(b - dense @ xt.numpy()) < 0.05 * r0
    for args in ((1.0, 0.5, 3), (0.1, 1.0, 0)):
        with pytest.raises(ValueError):
            chebyshev_coefficients(*args)


def _dev_csr(shape):
    n, m = shape
    a = sp.random(n, m, density=0.3, random_state=1, format="coo")
    csr = CSRMatrix.from_coo(COOMatrix(n, m, a.row, a.col, a.data))
    return csr


# case -> (call, the exception it raises)
BAD_INPUTS = {
    "non_square_csr": (lambda: T.cg_sell(
        device_put_csr(_dev_csr((5, 6)), torch.float64, device=CPU),
        torch.ones(5, dtype=torch.float64)), ValueError),
    "non_square_sell": (lambda: T.cg_sell(
        device_put_sell(SellMatrix.from_csr(_dev_csr((5, 6))), device=CPU),
        torch.ones(5)), ValueError),
    "unsupported_container": (lambda: T.cg_sell(
        device_put_bsr(BSRMatrix.from_csr(_dev_csr((6, 6))), device=CPU),
        torch.ones(6)), TypeError),
    "dd_container": (lambda: T.cg_sell(
        device_put_sell_dd(SellMatrix.from_csr(_dev_csr((6, 6))),
                           device=CPU), torch.ones(6)), TypeError),
    "negative_pagerank_weights": (lambda: T.pagerank_operator(
        CSRMatrix.from_coo(COOMatrix(3, 3, np.array([0, 1]),
                                     np.array([1, 2]),
                                     np.array([1.0, -2.0])))), ValueError),
    "pagerank_numpy_mask": (lambda: T.pagerank(
        lambda p: p, np.zeros(3, bool)), TypeError),
}


@pytest.mark.parametrize("case", list(BAD_INPUTS))
def test_bad_inputs_raise(case):
    call, exc = BAD_INPUTS[case]
    with pytest.raises(exc):
        call()

"""The yardstick: the generators, the fp64 reference, the roofline count,
and what it imports."""

import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import spec
from benchmark.reference import fem_3d_spd, products, roofline
from benchmark.reference.matrix import Matrix, splitmix64, uniform_of

PORT = "sparsematrixvectormultiplication_tpu_torch"


def _splitmix64_numpy(z):
    z = (z + np.uint64(0x9E3779B97F4A7C15))
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def test_splitmix64_is_the_uint64_one():
    keys = np.random.default_rng(0).integers(0, 2**63, 4096,
                                             dtype=np.int64)
    keys[:3] = (0, 1, 2**63 - 1)
    with np.errstate(over="ignore"):
        want = _splitmix64_numpy(keys.astype(np.uint64))
    got = splitmix64(torch.from_numpy(keys)).numpy().view(np.uint64)
    assert np.array_equal(got, want)


def test_uniform_values_are_in_range_and_keyed():
    key = torch.arange(100_000, dtype=torch.int64)
    u = uniform_of(key, 12345)
    assert float(u.min()) >= -1.0 and float(u.max()) < 1.0
    assert abs(float(u.mean())) < 0.02
    assert torch.equal(u, uniform_of(key.clone(), 12345))
    assert not torch.equal(u, uniform_of(key, 12346))


def _dense(m: Matrix) -> np.ndarray:
    a = np.zeros((m.nrows, m.ncols))
    np.add.at(a, (m.row.numpy(), m.col.numpy()), m.val.numpy())
    return a


def test_fem_3d_spd_pattern_symmetry_and_dominance():
    m = fem_3d_spd.generate({"nx": 4, "ny": 3, "nz": 5, "dof": 3}, 7, "cpu")
    assert m.nrows == 4 * 3 * 5 * 3
    key = m.row * m.nrows + m.col
    assert torch.unique(key).numel() == m.nnz  # no repeated coordinates
    a = _dense(m)
    assert np.array_equal(a, a.T)
    off = np.abs(a).sum(axis=1) - np.abs(np.diag(a))
    assert np.all(np.diag(a) > off)
    assert np.all(np.linalg.eigvalsh(a) > 0)
    # the package's fem_3d pattern: interior nodes couple to 27 neighbours
    assert int(np.bincount(m.row.numpy()).max()) == 27 * 3


def test_fem_3d_spd_values_follow_the_seed():
    p = {"nx": 3, "ny": 3, "nz": 3, "dof": 2}
    a, b, c = (fem_3d_spd.generate(p, s, "cpu") for s in (1, 1, 2))
    assert torch.equal(a.val, b.val) and torch.equal(a.row, c.row)
    assert not torch.equal(a.val, c.val)


@pytest.mark.parametrize("n,dof", [((4, 5, 6), 3), ((3, 3, 3), 2)])
def test_fem_3d_spd_has_the_q1_pattern(n, dof):
    """Every node couples to every unknown of each node of its
    27-neighbourhood: dof^2 * (3nx-2)(3ny-2)(3nz-2) entries, as ex56's
    assembled Q1 elasticity operator has (648,000 rows and 50,757,768
    entries at -ne 59, fem3d_cube's)."""
    nx, ny, nz = n
    m = fem_3d_spd.generate({"nx": nx, "ny": ny, "nz": nz, "dof": dof}, 3,
                            "cpu")
    assert m.nrows == nx * ny * nz * dof
    assert m.nnz == dof * dof * (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    assert 9 * (3 * 60 - 2) ** 3 == 50_757_768


@pytest.mark.parametrize("r", [None, 3])
def test_reference_products_equal_a_dense_product(r):
    m = fem_3d_spd.generate({"nx": 5, "ny": 4, "nz": 3, "dof": 3}, 11,
                            "cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((m.ncols,) if r is None else (m.ncols, r), generator=g,
                    dtype=torch.float64)
    a = _dense(m)
    y, bound = products.spmm(m, x)
    assert np.allclose(y.numpy(), a @ x.numpy(), rtol=1e-13, atol=1e-13)
    assert np.allclose(bound.numpy(), np.abs(a) @ np.abs(x.numpy()),
                       rtol=1e-13)
    assert products.row_gap(m, x, y) == 0.0
    assert products.row_gap(m, x, y.float()) < 1e-6
    assert products.row_gap(m, x, y[:-1]) == float("inf")
    bad = y.clone()
    bad.view(-1)[0] = float("nan")
    assert products.row_gap(m, x, bad) == float("inf")


def test_reference_residual():
    m = fem_3d_spd.generate({"nx": 3, "ny": 3, "nz": 2, "dof": 3}, 4, "cpu")
    a = _dense(m)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(m.nrows))
    x = torch.from_numpy(np.linalg.solve(a, b.numpy()))
    assert products.residual(m, x, b) < 1e-14
    assert products.residual(m, torch.zeros_like(b), b) == pytest.approx(1)


def test_roofline_count():
    assert roofline.count(10, 3, 4, "f32") == (10 * 4 + 7 * 4, 20)
    assert roofline.count(10, 3, 4, "dd") == (10 * 8 + 7 * 8, 20)
    assert roofline.count(10, 3, 4, "bf16", 2) == (10 * 2 + 2 * 7 * 4, 40)
    # fem3d_cube's f32 SpMV: 208,215,072 B, 62.2 us at 3.35 TB/s
    nbytes, ops = roofline.count(50_757_768, 648_000, 648_000, "f32")
    assert nbytes == 208_215_072
    peak = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert roofline.least_seconds(nbytes, ops, peak) == pytest.approx(
        62.15e-6, rel=1e-3)
    # its double-double SpMV: 416,430,144 B, 124.3 us
    nbytes, ops = roofline.count(50_757_768, 648_000, 648_000, "dd")
    assert nbytes == 416_430_144
    assert roofline.least_seconds(nbytes, ops, peak) == pytest.approx(
        124.31e-6, rel=1e-3)
    assert roofline.peaks("no such card") is None


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_package():
    files = sorted((spec.BENCH_DIR / "reference").glob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & {PORT, "jax", "jaxlib", "flax",
                                  "sparsematrixvectormultiplication_tpu"}, f
    code = ("import sys, importlib, pkgutil, benchmark.reference as r\n"
            "for m in pkgutil.iter_modules(r.__path__):\n"
            "    importlib.import_module('benchmark.reference.' + m.name)\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True).stdout
    top = set(eval(out))  # noqa: S307 — our own subprocess's list
    assert not top & {PORT, "jax", "jaxlib", "flax",
                      "sparsematrixvectormultiplication_tpu"}

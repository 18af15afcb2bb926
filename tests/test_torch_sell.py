"""The port's SELL module (ops/sell.py) against the JAX package.

On the CPU the wrappers run the plain PyTorch versions of the CUDA kernels;
those are held against the JAX package's Pallas kernels in interpret mode.
Tolerance: rtol=1e-5, atol=1e-5*max|y| — both sum in f32, in another order.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix as JCSR
from sparsematrixvectormultiplication_tpu.formats.sell import SellMatrix as JSell
from sparsematrixvectormultiplication_tpu.models import synthetic as jsyn
from sparsematrixvectormultiplication_tpu.ops.pallas_sell import (
    _pack_wl_ja,
    device_put_sell as jax_device_put_sell,
    sell_spmv_pallas,
)
from sparsematrixvectormultiplication_tpu_torch import CSRMatrix, SellMatrix
from sparsematrixvectormultiplication_tpu_torch.bench.harness import quantize_bf16
from sparsematrixvectormultiplication_tpu_torch.formats.sell import (
    PanelSellMatrix,
    slab_table_rows,
)
from sparsematrixvectormultiplication_tpu_torch.models.synthetic import (
    banded,
    fem_3d,
    random_general,
    road_network,
)
from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
from sparsematrixvectormultiplication_tpu_torch.utils.timing import (
    device_time_fn,
    time_fn,
)
from sparsematrixvectormultiplication_tpu_torch.utils.validation import (
    difference_metrics,
)

RTOL = 1e-5
ATOL_REL = 1e-5

# one shape per kernel: the k-major bin of the entry-point class matrix and
# the wl bin of a small FEM matrix (interpret mode compiles each once)
SHAPES = {
    "k-major": (lambda m: m.banded(4096, 24, 512, seed=0), "k-major"),
    "wl": (lambda m: m.fem_3d(8, 8, 8, dof=3, seed=0), "wl"),
}


def _x(n):
    return np.random.default_rng(11).standard_normal(n).astype(np.float32)


@pytest.fixture(scope="module")
def interpret_runs():
    """Per kernel: (JAX host SellMatrix holding just that layout's bins, x,
    y of sell_spmv_pallas(..., interpret=True))."""
    out = {}
    for layout, (make, want) in SHAPES.items():
        sell = JSell.from_csr(JCSR.from_coo(make(jsyn)))
        bins = [b for b in sell.bins if b.layout == want]
        assert bins, [b.layout for b in sell.bins]
        sell = dataclasses.replace(sell, bins=bins)
        x = _x(sell.ncols)
        y = np.asarray(sell_spmv_pallas(
            jax_device_put_sell(sell, jnp.float32), jnp.asarray(x),
            interpret=True))
        out[layout] = (sell, x, y)
    return out


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())


@pytest.mark.parametrize("layout", sorted(SHAPES))
def test_plain_version_matches_pallas_interpret(layout, interpret_runs):
    sell, x, y_ref = interpret_runs[layout]
    d = S.device_put_sell(sell, device="cpu")
    x_tab = S.device_put_x(x, sell.ncols, device="cpu")
    plain = {"k-major": S.k_major_bin_plain, "wl": S.wl_bin_plain}[layout]
    rows = y_ref.shape[0]
    y_groups = np.zeros((d.num_groups, 1024), np.float32)
    for b in d.bins:
        y_groups[b.group_ids.numpy()] = plain(b, x_tab).reshape(
            b.n_groups, 1024).numpy()
    _close(y_groups.reshape(-1)[:rows], y_ref)
    _close(S.sell_spmv(d, x_tab), y_ref)


def _unpack(packed, ng, tiles):
    """The JAX package's packed wl plane back to its lane indices, (ng,
    tiles, 8, 128): byte t % 4 of packed tile t // 4."""
    p = np.asarray(packed).astype(np.uint32).reshape(ng, -1, 1, 8, 128)
    m = (p >> (8 * np.arange(4, dtype=np.uint32))[None, None, :, None, None]
         ) & 127
    return m.reshape(ng, -1, 8, 128)[:, :tiles]


def _compacted_rows(b, plane, fill=-1):
    """A compacted wl plane as (rows, width) in each row's slot order,
    ``fill`` past the row's length."""
    rows = b.n_groups * 1024
    n = b.row_len.numpy()
    width = int(n.max()) if rows else 0
    r = np.arange(rows)
    base = b.plane_off.numpy()[r // 128].astype(np.int64) * 128 + r % 128
    q = np.arange(width)
    pos = base[:, None] + q[None, :] * 128
    live = q[None, :] < n[:, None]
    flat = plane.reshape(-1).numpy()
    return np.where(live, flat[np.where(live, pos, 0)], fill)


def test_wl_packing_bit_identical_to_jax():
    """The compacted plane's 2-byte codes carry the JAX package's packed
    lane indices: row by row, the codes of the real slots are ``((w*8 + s)
    << 7) | m`` with m unpacked from ``_pack_wl_ja``'s plane, in the order
    (w, l, s), and the values those slots' values."""
    sell = SellMatrix.from_csr(CSRMatrix.from_coo(fem_3d(10, 10, 10, dof=3)),
                               layout="wl")
    d = S.device_put_sell(sell, device="cpu")
    wl = [(h, b) for h, b in zip(sell.bins, d.bins) if h.layout == "wl"]
    assert wl
    for h, b in wl:
        ng, nw, L = h.n_groups, h.chunk_k, h.span
        m = _unpack(_pack_wl_ja(np.asarray(h.ja), h.k * 8), ng, h.k)
        slot = np.arange(h.k)
        code = ((slot // (8 * L) * 8 + slot % 8) << 7)[None, :] \
            + m.reshape(ng, 8, nw, L, 8, 128).transpose(
                0, 1, 5, 2, 3, 4).reshape(ng * 1024, h.k)
        v = np.asarray(h.as_).reshape(ng, 8, nw, L, 8, 128).transpose(
            0, 1, 5, 2, 3, 4).reshape(ng * 1024, h.k)
        assert b.ja.dtype == torch.int16
        assert b.ja.numel() == b.as_.numel()  # 2 bytes a slot
        got_c, got_v = _compacted_rows(b, b.ja), _compacted_rows(b, b.as_, 0)
        for r in range(0, ng * 1024, 97):
            keep = v[r] != 0
            n = int(keep.sum())
            assert np.array_equal(got_c[r, :n], code[r, keep])
            assert np.array_equal(got_v[r, :n], v[r, keep].astype(np.float32))
            assert (got_c[r, n:] == -1).all()


def test_wl_packing_pads_to_whole_words():
    """Each (group, row-block) plane is as wide as its longest row, in whole
    128-lane plane rows; a shorter row's slots past its length hold a zero
    value and code, and its real slots are the host bin's nonzeros."""
    sell = SellMatrix.from_csr(CSRMatrix.from_coo(banded(4096, 18, 40,
                                                         seed=2)),
                               layout="wl")
    (h, b), = [(h, b) for h, b in zip(sell.bins, S.device_put_sell(
        sell, device="cpu").bins) if h.layout == "wl"]
    n = b.row_len.view(-1, 128)
    widths = b.plane_off[1:] - b.plane_off[:-1]
    assert torch.equal(widths, n.amax(1))
    assert b.ja.shape == b.as_.shape == (int(b.plane_off[-1]), 128)
    assert int(n.sum()) == int((np.asarray(h.as_) != 0).sum())
    assert (n < widths[:, None]).any()  # some rows are padded
    flat = torch.arange(b.ja.numel()).view(b.ja.shape)
    real = _compacted_rows(b, flat)  # plane positions of the real slots
    pad = torch.ones(b.ja.numel(), dtype=torch.bool)
    pad[torch.from_numpy(real[real >= 0])] = False
    assert pad.any() and (b.as_.view(-1)[~pad] != 0).all()
    assert not b.ja.view(-1)[pad].any() and not b.as_.view(-1)[pad].any()


# matrix -> (generator, SellMatrix.from_csr keywords)
MATRICES = {
    "banded_k_major": (lambda: banded(4096, 24, 512, seed=0), {}),
    "fem_mixed": (lambda: fem_3d(8, 8, 8, dof=3, seed=0), {}),
    "fem_wl": (lambda: fem_3d(10, 10, 10, dof=3, seed=0), {}),
    "banded_sb_major": (lambda: banded(4096, 24, 512, seed=0),
                        {"layout": "sb-major"}),
    "banded_sb_list": (lambda: banded(4096, 24, 512, seed=0),
                       {"layout": "sb-list"}),
    "road_sg": (lambda: road_network(8000, seed=5), {"layout": "sg"}),
    "road_sg_rows": (lambda: road_network(8000, seed=5),
                     {"layout": "sg", "sg_slots": False}),
    "uniform_auto": (lambda: random_general(20000, 20000, 2.5e-4, seed=8), {}),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_spmv_against_fp64_oracle(matrix, dtype):
    make, kw = MATRICES[matrix]
    csr = CSRMatrix.from_coo(make())
    sell = SellMatrix.from_csr(csr, **kw)
    x = np.random.default_rng(4).standard_normal(csr.ncols)
    d = S.device_put_sell(sell, getattr(torch, dtype), device="cpu")
    y = S.sell_spmv(d, S.device_put_x(x, csr.ncols, device="cpu")).numpy()
    if dtype == "float32":
        refs = [csr.spmv(x), sell.spmv(x)]
    else:
        q = CSRMatrix(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                      quantize_bf16(csr.values))
        refs = [q.spmv(x)]
    for ref in refs:
        assert difference_metrics(ref, y).significant_diffs == 0


def test_bf16_quantization_matches_ml_dtypes():
    import ml_dtypes

    v = np.random.default_rng(8).standard_normal(100_000)
    v[:3] = [1 + 2**-8 + 2**-30, -(1 + 2**-8), 3.0]  # ties through f32
    want = v.astype(ml_dtypes.bfloat16).astype(np.float64)
    assert np.array_equal(quantize_bf16(v), want)


def test_jax_host_sell_carries_across():
    coo = fem_3d(8, 8, 8, dof=3, seed=0)
    mine = SellMatrix.from_csr(CSRMatrix.from_coo(coo))
    theirs = JSell.from_csr(JCSR.from_coo(jsyn.fem_3d(8, 8, 8, dof=3, seed=0)))
    x = S.device_put_x(_x(coo.ncols), coo.ncols, device="cpu")
    for dtype in (torch.float32, torch.bfloat16):
        y_mine = S.sell_spmv(S.device_put_sell(mine, dtype, device="cpu"), x)
        y_theirs = S.sell_spmv(S.device_put_sell(theirs, dtype, device="cpu"),
                               x)
        assert torch.equal(y_mine, y_theirs)


def test_jax_host_sell_carries_across_sg():
    """The JAX package's host SellMatrix with sg bins and add_into far bins
    runs in the port exactly as the port's own conversion does."""
    coo = road_network(8000, seed=5)
    mine = SellMatrix.from_csr(CSRMatrix.from_coo(coo), layout="sg")
    theirs = JSell.from_csr(JCSR.from_coo(jsyn.road_network(8000, seed=5)),
                            layout="sg")
    assert {b.layout for b in theirs.bins} == {"sg", "k-major"}
    assert any(b.add_into for b in theirs.bins)
    x = S.device_put_x(_x(coo.ncols), coo.ncols, device="cpu")
    for dtype in (torch.float32, torch.bfloat16):
        y_mine = S.sell_spmv(S.device_put_sell(mine, dtype, device="cpu"), x)
        y_theirs = S.sell_spmv(S.device_put_sell(theirs, dtype, device="cpu"),
                               x)
        assert torch.equal(y_mine, y_theirs)


@pytest.mark.parametrize("where", ["device_put_sell", "sell_spmv"])
def test_unknown_layout_refused(where):
    sell = SellMatrix.from_csr(CSRMatrix.from_coo(banded(2048, 8, 64)))
    if where == "device_put_sell":
        bad = dataclasses.replace(sell, bins=[
            dataclasses.replace(b, layout="hll") for b in sell.bins])
        with pytest.raises(ValueError, match="unknown SELL bin layout 'hll'"):
            S.device_put_sell(bad, device="cpu")
        return
    d = S.device_put_sell(sell, device="cpu")
    d.bins[0].layout = "hll"
    x = S.device_put_x(np.ones(sell.ncols), sell.ncols, device="cpu")
    with pytest.raises(ValueError, match="unknown SELL bin layout 'hll'"):
        S.sell_spmv(d, x)


def test_cpu_tensors_run_plain_without_launching():
    counts = lambda: [(w.launches, w.accumulating)  # noqa: E731
                      for w in S._KERNEL.values()]
    for coo in (fem_3d(8, 8, 8, dof=3), road_network(8000, seed=5)):
        sell = SellMatrix.from_csr(CSRMatrix.from_coo(coo))
        d = S.device_put_sell(sell, device="cpu")
        x = S.device_put_x(_x(sell.ncols), sell.ncols, device="cpu")
        before = counts()
        assert torch.equal(S.sell_spmv(d, x), S.sell_spmv_plain(d, x))
        assert counts() == before


# wrapper -> a matrix and layout whose conversion has such a bin
WRAPPED = {
    "k_major_bin": (lambda: fem_3d(8, 8, 8, dof=3), "k-major"),
    "wl_bin": (lambda: fem_3d(8, 8, 8, dof=3), "wl"),
    "sb_major_bin": (lambda: banded(2048, 8, 64), "sb-major"),
    "sb_list_bin": (lambda: banded(2048, 8, 64), "sb-list"),
    "sg_bin": (lambda: road_network(8000, seed=5), "sg"),
}


@pytest.mark.parametrize("wrapper", sorted(WRAPPED))
def test_wrapper_raises_off_cpu_and_cuda(wrapper):
    make, layout = WRAPPED[wrapper]
    kw = {} if layout in ("k-major", "wl") else {"layout": layout}
    sell = SellMatrix.from_csr(CSRMatrix.from_coo(make()), **kw)
    b = next(b for b in S.device_put_sell(sell, device="meta").bins
             if b.layout == layout)
    x_tab = torch.zeros(slab_table_rows(sell.ncols) * 128, device="meta")
    y = torch.zeros(sell.num_groups * 1024, device="meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        getattr(S, wrapper)(b, x_tab, y)


def test_x_table_padding():
    x = torch.arange(1, 301, dtype=torch.float64)
    tab = S.pack_x_table(x, 300)
    assert tab.dtype == torch.float32
    assert tab.numel() == slab_table_rows(300) * 128 > 300
    assert torch.equal(tab[:300], x.float()) and not tab[300:].any()
    assert torch.equal(S.device_put_x(x.numpy(), 300, device="cpu"), tab)


@pytest.mark.parametrize("x", ["raw", "float64_table"])
def test_spmv_takes_only_the_padded_table(x):
    sell = SellMatrix.from_csr(CSRMatrix.from_coo(banded(2048, 8, 64)))
    d = S.device_put_sell(sell, device="cpu")
    tab = S.device_put_x(np.ones(sell.ncols), sell.ncols, device="cpu")
    bad = {"raw": torch.ones(sell.ncols, dtype=torch.float32),
           "float64_table": tab.double()}[x]
    with pytest.raises(ValueError, match="padded f32 table"):
        S.sell_spmv(d, bad)


def test_device_put_rejects_other_value_dtypes():
    sell = SellMatrix.from_csr(CSRMatrix.from_coo(banded(2048, 8, 64)))
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        S.device_put_sell(sell, torch.float64, device="cpu")


def test_time_fn_on_cpu():
    calls = []
    sec = time_fn(calls.append, 1, device="cpu", reps=4, skip=2)
    assert sec >= 0.0 and len(calls) == 6


def test_device_time_fn_needs_cuda():
    calls = []
    with pytest.raises(ValueError, match="CUDA devices, not cpu"):
        device_time_fn(calls.append, 1, device="cpu")
    assert not calls


def test_build_compiles_for_sm90a_into_hashed_library(tmp_path, monkeypatch):
    """The build runs nvcc once per source hash and names the library by it;
    a failing nvcc raises with its output (run here with a stand-in nvcc)."""
    from sparsematrixvectormultiplication_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        open(out, "wb").close()
        return SimpleNamespace(returncode=0, stdout="ptxas info: ok\n",
                               stderr="")

    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    target = _build.library_path()
    assert target.parent == tmp_path and target.suffix == ".so"
    _build._build(target)
    *compiles, link = calls  # one nvcc per source, then the link
    assert sorted(c for cmd in compiles for c in cmd if c.endswith(".cu")) \
        == sorted(str(_build._CSRC / s) for s in _build._SOURCES)
    for cmd in compiles:
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert {"-c", "-O3", "-std=c++17"} <= set(cmd)
    assert "arch=compute_90a,code=sm_90a" in link and "-shared" in link
    assert sorted(c for c in link if c.endswith(".o")) == sorted(
        cmd[cmd.index("-o") + 1] for cmd in compiles)
    assert target.exists() and _build.build_log() == "ptxas info: ok\n" * len(
        _build._SOURCES)
    assert set(tmp_path.iterdir()) == {target, target.with_suffix(".log")}

    def failing_run(cmd, **kw):
        return SimpleNamespace(returncode=1, stdout="", stderr="bad ptx")

    monkeypatch.setattr(_build.subprocess, "run", failing_run)
    other = tmp_path / "libother.so"
    with pytest.raises(RuntimeError, match="bad ptx"):
        _build._build(other)
    assert set(tmp_path.iterdir()) == {target, target.with_suffix(".log")}

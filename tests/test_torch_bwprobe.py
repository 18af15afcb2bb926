"""The bandwidth probe's plain versions against the JAX probe kernels.

``probes/bw_probe.py``'s Pallas kernels run in TPU interpret mode on the
CPU (``pltpu.force_tpu_interpret_mode``), on the same inputs, made with
numpy from a seed, as the port's plain versions. The TPU reads sum only the
first 8 rows of each block they move; the port's fold sums every row, which
is the same function at 8-row blocks, so the reads compare at ``bk = 8`` and
``chunk_rows = 8``. Every input is a small integer, so every f32 sum is
exact whatever its order: the comparisons are exact.

The probe module sets ``jax_compilation_cache_dir`` when it is imported
(bw_probe.py:40); the fixture restores it.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sparsematrixvectormultiplication_tpu_torch.bench import bw_probe as B

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NR = 64
NG, K, XR = 8, 16, 64


@pytest.fixture(scope="module")
def jbw():
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(
        "jax_bw_probe", os.path.join(ROOT, "probes", "bw_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in keep.items():
            jax.config.update(k, v)
    return mod


def _ints(rng, shape, dtype, lo=-8, hi=8):
    return rng.integers(lo, hi, shape).astype(dtype)


def _jax(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*args))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_read_matches_pallas_read_at_8_row_blocks(jbw):
    rng = np.random.default_rng(0)
    buf = _ints(rng, (NR, 128), np.float32)
    seed = _ints(rng, (8, 128), np.float32)
    want = _jax(jbw.pallas_read(NR, 8), buf, seed)
    np.testing.assert_array_equal(B.bw_read_plain(_t(buf), _t(seed)).numpy(),
                                  want)


def test_read2_matches_pallas_read2(jbw):
    rng = np.random.default_rng(1)
    as_ = _ints(rng, (NR, 128), np.float32)
    ja = _ints(rng, (NR, 128), np.int32, 0, 128)
    seed = _ints(rng, (8, 128), np.float32)
    want = _jax(jbw.pallas_read2(NR, 8), as_, ja, seed)
    got = B.bw_read_plain(_t(as_), _t(seed), _t(ja)).numpy()
    np.testing.assert_array_equal(got, want)


def test_copy_matches_pallas_copy(jbw):
    rng = np.random.default_rng(2)
    buf = _ints(rng, (NR, 128), np.float32)
    seed = _ints(rng, (8, 128), np.float32)
    want = _jax(jbw.pallas_copy(NR, 8), buf, seed)
    np.testing.assert_array_equal(B.bw_copy_plain(_t(buf), _t(seed)).numpy(),
                                  want)


@pytest.mark.parametrize("nbuf", [2, 3])
def test_read_async_matches_pallas_manual_dma_at_8_row_chunks(jbw, nbuf):
    rng = np.random.default_rng(3)
    buf = _ints(rng, (NR, 128), np.float32)
    seed = _ints(rng, (8, 128), np.float32)
    want = _jax(jbw.pallas_manual_dma(NR, 8, nbuf), buf, seed)
    got = B.bw_read_async_plain(_t(buf), _t(seed), chunk_rows=8, nbuf=nbuf)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype,sub", [(np.int16, 16), (np.int8, 32)])
def test_narrow_read_matches_int_load_probe(jbw, dtype, sub):
    """int_load_probe reads one (sub, 128) tile and widens its first 8 rows;
    rows 8.. of the tile are 0 here, so the fold of the whole tile is the
    same function."""
    rng = np.random.default_rng(4)
    t = np.zeros((sub, 128), dtype)
    t[:8] = _ints(rng, (8, 128), dtype, -128, 128)
    seed = _ints(rng, (8, 128), np.float32)
    want = _jax(jbw.int_load_probe(dtype, sub), t, seed)
    np.testing.assert_array_equal(B.bw_read_plain(_t(t), _t(seed)).numpy(),
                                  want)


def _kernelsim_inputs(rng, span, packed):
    nch = K // 8
    qb = rng.integers(0, XR - span + 1, (NG, 8 * nch)).astype(np.int32)
    x = _ints(rng, (XR, 128), np.float32, -4, 4)
    as_ = _ints(rng, (NG * K * 8, 128), np.float32, -4, 4)
    # sel up to span + 1: codes past the span add nothing in both
    code = (rng.integers(0, span + 2, (NG * K * 8, 128)) * 128
            + rng.integers(0, 128, (NG * K * 8, 128))).astype(np.int32)
    if packed:
        c = code.reshape(NG, 8, nch // 2, 2, 8, 128)
        code = (c[:, :, :, 0] | (c[:, :, :, 1] << 16)).reshape(-1, 128)
    return qb, x, np.ascontiguousarray(code), as_


@pytest.mark.parametrize("variant", ["span4", "nocompute", "span4_packed16"])
def test_kernelsim_matches_pallas_kernelsim(jbw, variant):
    """The three variants of the JAX probe at NG=8, K=16 (g_per=8)."""
    kw = {"span4": dict(span=4, compute=True, packed=False),
          "nocompute": dict(span=4, compute=False, packed=False),
          "span4_packed16": dict(span=4, compute=True, packed=True)}[variant]
    rng = np.random.default_rng(5)
    qb, x, ja, as_ = _kernelsim_inputs(rng, kw["span"], kw["packed"])
    seed = _ints(rng, (8, 128), np.float32)
    fn, _ = jbw.pallas_kernelsim(NG, K, XR, g_per=8, **kw)
    want = _jax(fn, qb, x, ja, as_, seed)
    got = B.bw_kernelsim_plain(_t(qb), _t(x), _t(ja), _t(as_), _t(seed),
                               k=K, **kw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("span", [1, 4, 8])
def test_kernelsim_inputs_pack_two_chunks_per_row(span):
    """kernelsim_inputs' packed plane is its unpacked plane, two chunks per
    int32 row: the plain version reads the same codes from both."""
    g = torch.Generator().manual_seed(7)
    qb, x, code, as_ = B.kernelsim_inputs(4, 32, 256, span, generator=g,
                                          device="cpu")
    g = torch.Generator().manual_seed(7)
    qb2, x2, packed, as2 = B.kernelsim_inputs(4, 32, 256, span, generator=g,
                                              device="cpu", packed=True)
    assert packed.shape == (4 * 32 * 4, 128)
    assert torch.equal(qb, qb2) and torch.equal(x, x2) and torch.equal(as_, as2)
    seed = torch.zeros(8, 128)
    a = B.bw_kernelsim_plain(qb, x, code, as_, seed, k=32, span=span)
    b = B.bw_kernelsim_plain(qb, x, packed, as_, seed, k=32, span=span,
                             packed=True)
    assert torch.equal(a, b) and a.abs().max() > 0


def test_kernelsim_has_no_packed_nocompute_variant():
    """The JAX probe's packed no-compute variant reads rows off/2 .. off/2 +
    7 of each chunk, past the end of its plane at the last one; its main
    never runs it, and the port refuses it."""
    g = torch.Generator().manual_seed(7)
    qb, x, code, as_ = B.kernelsim_inputs(2, 16, 64, 4, generator=g,
                                          device="cpu", packed=True)
    with pytest.raises(ValueError, match="no packed no-compute"):
        B.bw_kernelsim_plain(qb, x, code, as_, torch.zeros(8, 128), k=16,
                             compute=False, packed=True)


WRAPPED = {
    "bw_read": lambda t, s: B.bw_read(t, s),
    "bw_read2": lambda t, s: B.bw_read(t, s, t.to(torch.int32)),
    "bw_copy": lambda t, s: B.bw_copy(t, s),
    "bw_read_async": lambda t, s: B.bw_read_async(t, s, chunk_rows=8),
    "bw_kernelsim": lambda t, s: B.bw_kernelsim(
        torch.zeros(1, 8, dtype=torch.int32), t,
        torch.zeros(64, 128, dtype=torch.int32), torch.zeros(64, 128), s,
        k=8),
}


@pytest.mark.parametrize("kernel", sorted(WRAPPED))
def test_wrapper_raises_on_cpu_tensors(kernel):
    """The probe measures the card: a CPU tensor raises, and nothing is
    counted as launched."""
    w = B.KERNELS["bw_read" if kernel == "bw_read2" else kernel]
    before = w.launches
    with pytest.raises(RuntimeError, match="runs on CUDA tensors"):
        WRAPPED[kernel](torch.ones(64, 128), torch.zeros(8, 128))
    assert w.launches == before


def test_run_probes_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA device"):
        B.run_probes("cpu")

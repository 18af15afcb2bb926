"""The kernel-variant probes' plain versions against the JAX probe kernels.

The Pallas kernels of ``probes/kernel_probe{,2,3,4,5}.py`` are closures
inside each probe's ``main()`` over the sizes it binds (NSTEPS, NCHUNKS,
KB, Rp, ...), so they cannot be imported. :func:`_probe_defs` takes the
named definitions out of ``main``'s body with ``ast`` and executes them in a
namespace holding jax, the Pallas modules and small sizes; the kernels then
run in TPU interpret mode on the CPU (``pltpu.force_tpu_interpret_mode``),
on the same inputs, made with numpy from a seed, as the port's plain
versions. Every input is a small integer, so every f32 sum is exact
whatever its order: the comparisons are exact (``np.array_equal``).

The TPU's column sums (``mk_read1``, ``mk_read2``, ``mk_fused_pure``) write
every grid step to output block (0, 0) and so keep only the last block's
sums; the port sums every block, which is the same function at one block,
where they are compared.
"""

import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sparsematrixvectormultiplication_tpu_torch.bench import kernel_probe as K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES, CK, RP = 128, 8, 64


def _probe_defs(path, names, **sizes):
    """The definitions ``names`` (functions and assignments) of the probe
    file's ``main``, executed in order in a namespace of jax, jnp, pl,
    pltpu, np and ``sizes``; raises if one is missing."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    keep, found = [], set()
    for node in main.body:
        if isinstance(node, ast.FunctionDef) and node.name in names:
            name = node.name
        elif (isinstance(node, ast.Assign) and len(node.targets) == 1
              and isinstance(node.targets[0], ast.Name)
              and node.targets[0].id in names):
            name = node.targets[0].id
        else:
            continue
        if name not in found:  # the first binding, as the probe reads it
            keep.append(node)
            found.add(name)
    missing = set(names) - found
    if missing:
        raise LookupError(f"{path}: main() has no {sorted(missing)}")
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu, "np": np,
          **sizes}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    return ns


def _jax(fn, *args):
    # the probes run with jax's default 32-bit types (tests/conftest.py
    # turns x64 on, under which an int32 sum would widen and not wrap)
    with jax.enable_x64(False), pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*args))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ints(rng, shape, lo=-4, hi=4, dtype=np.float32):
    return rng.integers(lo, hi, shape).astype(dtype)


def _codes(rng, qb, ck, dlo, dhi):
    """int32 codes 128*(qb + d) + m, d in [dlo, dhi) per entry."""
    steps, nch = qb.shape
    d = rng.integers(dlo, dhi, (steps, nch, ck, LANES))
    m = rng.integers(0, LANES, (steps, nch, ck, LANES))
    return ((qb[:, :, None, None] + d) * LANES + m).astype(
        np.int32).reshape(-1, LANES)


def _rel16(ja, qb, ck):
    steps, nch = qb.shape
    d = (ja.reshape(steps, nch, ck, LANES) >> 7) - qb[:, :, None, None]
    return ((d.reshape(ja.shape) << 7) | (ja & (LANES - 1))).astype(np.int16)


def _plain(mode, ja, as_, qb, x, **kw):
    return K.kp_decode_plain(mode, _t(ja), _t(as_), _t(qb), _t(x),
                             **kw).numpy()


# ---- probe 1: NSTEPS=2 steps of NCHUNKS=4 chunks of 8 rows ----

P1 = dict(LANES=LANES, CK=CK, NCHUNKS=4, KB=32, NSTEPS=2, Rp=RP)


@pytest.fixture(scope="module")
def p1():
    return _probe_defs("probes/kernel_probe.py",
                       ["grid_spec", "CPARAMS", "call", "k_span",
                        "k_span_window", "k_layered", "k_stream"], **P1)


@pytest.mark.parametrize("case", [
    "stream", "span1_i32", "span4_i32", "span8_i32", "span4_i16",
    "span8_i16", "span8_w", "layered_i32", "layered_i16", "layered_i8"])
def test_probe1_matches_plain(p1, case):
    rng = np.random.default_rng(1)
    x = _ints(rng, (RP, LANES))
    as_ = _ints(rng, (64, LANES))
    kb = P1["KB"]
    if case.startswith("layered"):
        qb = rng.integers(0, RP - CK, (2, 4)).astype(np.int32)
        ja = _codes(rng, qb, CK, 0, 1) + np.tile(
            (np.arange(CK) * LANES)[:, None], (8, 1)).astype(np.int32)
        codes = {"layered_i32": ja,
                 "layered_i16": (ja & 127).astype(np.int16),
                 "layered_i8": (ja & 127).astype(np.int8)}[case]
        body = p1["k_layered"](case != "layered_i32")  # m_only
        want = _jax(lambda *a: p1["call"](body, *a), codes, as_, qb, x)
        got = _plain("window", codes, as_, qb, x, kb=kb)
    elif case == "stream":
        qb = np.zeros((2, 4), np.int32)
        ja = rng.integers(-8, 8, (64, LANES)).astype(np.int32)
        want = _jax(lambda *a: p1["call"](p1["k_stream"](), *a), ja, as_, qb,
                    x)
        got = _plain("stream", ja, as_, qb, x, kb=kb)
    else:
        span = int(case[4:case.index("_")])
        # d in [-1, span + 2): codes outside the window add nothing
        qb = rng.integers(1, RP - span - 2, (2, 4)).astype(np.int32)
        ja = _codes(rng, qb, CK, -1, span + 2)
        if case.endswith("i16"):
            ja = _rel16(ja, qb, CK)
        body = (p1["k_span_window"](span) if case == "span8_w"
                else p1["k_span"](span, case.endswith("i16")))
        want = _jax(lambda *a: p1["call"](body, *a), ja, as_, qb, x)
        got = _plain("masked", ja, as_, qb, x, kb=kb, span=span)
    assert np.abs(want).max() > 0
    np.testing.assert_array_equal(got, want)


# ---- probe 2: chunk heights 8 and 16 over KB=32-row steps ----

P2 = dict(LANES=LANES, KB=32, NSTEPS=2, Rp=RP)


@pytest.fixture(scope="module")
def p2():
    return _probe_defs("probes/kernel_probe2.py",
                       ["grid_spec", "CPARAMS", "call", "k_stream",
                        "k_gather_b", "k_gather_w", "k_span4"], **P2)


@pytest.mark.parametrize("body,ck", [
    (b, ck) for b in ("k_stream", "k_gather_b", "k_gather_w", "k_span4")
    for ck in (8, 16)] + [("k_span4_i16", 8)])  # the probe's int16 case
def test_probe2_matches_plain(p2, body, ck):
    rng = np.random.default_rng(2 + ck)
    x = _ints(rng, (RP, LANES))
    as_ = _ints(rng, (64, LANES))
    nch = P2["KB"] // ck
    qb = rng.integers(1, RP - ck - 4, (2, nch)).astype(np.int32)
    kw = {"kb": P2["KB"], "ck": ck}
    if body == "k_stream":
        ja = rng.integers(-8, 8, (64, LANES)).astype(np.int32)
        mode, kernel = "stream", p2["k_stream"](ck)
    elif body == "k_gather_b":  # the slab part is ignored
        ja = _codes(rng, qb, ck, 0, 5)
        mode, kernel = "bcast", p2["k_gather_b"](ck)
    elif body == "k_gather_w":
        ja = _codes(rng, qb, ck, 0, 1) + np.tile(
            (np.arange(ck) * LANES)[:, None], (64 // ck, 1)).astype(np.int32)
        mode, kernel = "window", p2["k_gather_w"](ck)
    else:
        ja = _codes(rng, qb, ck, -1, 6)
        i16 = body == "k_span4_i16"
        if i16:
            ja = _rel16(ja, qb, ck)
        mode, kernel = "masked", p2["k_span4"](ck, i16)
        kw["span"] = 4
    want = _jax(lambda *a: p2["call"](kernel, *a), ja, as_, qb, x)
    assert np.abs(want).max() > 0
    np.testing.assert_array_equal(_plain(mode, ja, as_, qb, x, **kw), want)


# ---- probe 3: TOT_KB=64 rows in steps of KB=16 or 32 rows ----

P3 = dict(LANES=LANES, CK=CK, TOT_KB=64, Rp=RP)


@pytest.fixture(scope="module")
def p3():
    return _probe_defs("probes/kernel_probe3.py",
                       ["CPARAMS", "call", "k_stream", "k_fused", "k_gather",
                        "k_span"], **P3)


@pytest.mark.parametrize("case", [
    "stream_kb16", "stream_kb32", "fused_kb32", "gather_i32", "gather_i16",
    "span4_i32", "span4_i16"])
def test_probe3_matches_plain(p3, case):
    rng = np.random.default_rng(3)
    kb = 16 if case == "stream_kb16" else 32
    x = _ints(rng, (RP, LANES))
    as_ = _ints(rng, (64, LANES))
    qb = rng.integers(1, RP - 8, (64 // kb, kb // CK)).astype(np.int32)
    call = p3["call"]
    if case.startswith("stream"):
        ja = rng.integers(-8, 8, (64, LANES)).astype(np.int32)
        want = _jax(lambda *a: call(p3["k_stream"](kb), kb, *a), ja, as_, qb,
                    x)
        got = _plain("stream", ja, as_, qb, x, kb=kb)
    elif case == "fused_kb32":
        ja = rng.integers(-8, 8, (64, LANES)).astype(np.int32)
        fused = K.fuse_chunks(_t(ja), _t(as_)).numpy()
        want = _jax(lambda *a: call(p3["k_fused"](kb), kb, *a, ja_rows=2 * kb),
                    fused, as_, qb, x)
        got = K.kp_fused_plain("fused8", _t(fused), kb=kb).numpy()
    elif case.startswith("gather"):
        ja = _codes(rng, qb, CK, 0, 1)
        i16 = case.endswith("i16")
        if i16:
            ja = _rel16(ja, qb, CK)
        want = _jax(lambda *a: call(p3["k_gather"](kb, i16), kb, *a), ja,
                    as_, qb, x)
        got = _plain("bcast", ja, as_, qb, x, kb=kb)
    else:
        ja = _codes(rng, qb, CK, -1, 6)
        i16 = case.endswith("i16")
        if i16:
            ja = _rel16(ja, qb, CK)
        want = _jax(lambda *a: call(p3["k_span"](kb, 4, i16), kb, *a), ja,
                    as_, qb, x)
        got = _plain("masked", ja, as_, qb, x, kb=kb, span=4)
    assert np.abs(want).max() > 0
    np.testing.assert_array_equal(got, want)


# ---- probe 4: one block of KB=16 rows for the column sums ----

P4 = dict(LANES=LANES, CK=CK, Rp=RP, KB=32, TOTS=64)


@pytest.fixture(scope="module")
def p4():
    return _probe_defs("probes/kernel_probe4.py",
                       ["CPARAMS", "mk_read1", "mk_read2", "two_calls",
                        "mk_fused_pure", "mk_fused_gather", "mk_span"], **P4)


@pytest.mark.parametrize("case", [
    "read1", "read2", "read1_half_x2", "fused_pure", "fused_pure_wraps",
    "fused_gather", "span_base", "span_hoist"])
def test_probe4_matches_plain(p4, case):
    rng = np.random.default_rng(4)
    kb = 16
    a, b = _ints(rng, (kb, LANES)), _ints(rng, (kb, LANES))
    x = _ints(rng, (RP, LANES))
    if case == "read1":
        want = _jax(p4["mk_read1"](kb, kb), a)
        got = K.kp_colsum_plain(_t(a)).numpy()
    elif case == "read2":
        want = _jax(p4["mk_read2"](kb, kb), a, b)
        got = K.kp_colsum_plain(_t(a), _t(b)).numpy()
    elif case == "read1_half_x2":
        p4["r1"] = p4["mk_read1"](kb, kb)  # two_calls' r1, at one block
        want = _jax(p4["two_calls"], a, b)
        got = (K.kp_colsum_plain(_t(a)) + K.kp_colsum_plain(_t(b))).numpy()
    elif case.startswith("fused_pure"):
        ja = rng.integers(-8, 8, (kb, LANES)).astype(np.int32)
        wraps = case.endswith("wraps")
        bits = a.view(np.int32) if wraps else rng.integers(
            -8, 8, (kb, LANES)).astype(np.int32)
        f = np.concatenate([ja, bits])
        if wraps:  # the float bits' column sums leave the int32 range
            assert np.abs((ja.astype(np.int64) + bits).sum(0)).max() > 2 ** 31
        want = _jax(p4["mk_fused_pure"](kb, 2 * kb), f)
        got = K.kp_fused_plain("halves_pure", _t(f), kb=kb).numpy()
    elif case == "fused_gather":  # two blocks: two output tiles
        qb = rng.integers(0, RP, (2, kb // CK)).astype(np.int32)
        ja = _codes(rng, qb, CK, 0, 1)
        as_ = _ints(rng, (2 * kb, LANES))
        f = K.fuse_halves(_t(ja), _t(as_), kb).numpy()
        want = _jax(p4["mk_fused_gather"](kb, 4 * kb), qb, x, f)
        got = K.kp_fused_plain("halves_gather", _t(f), _t(qb), _t(x),
                               kb=kb).numpy()
    else:
        span, tot_kb = 8, P4["KB"]
        qb = rng.integers(1, RP - span - 2, (2, tot_kb // CK)).astype(np.int32)
        ja = _codes(rng, qb, CK, -1, span + 2)
        as_ = _ints(rng, (2 * tot_kb, LANES))
        want = _jax(p4["mk_span"](span, case == "span_hoist"), qb, x, ja, as_)
        got = _plain("masked", ja, as_, qb, x, kb=tot_kb, span=span)
    assert np.abs(want).max() > 0
    np.testing.assert_array_equal(got, want)


# ---- probe 5: NSTEPS=2 steps of NCH=4 chunks ----

P5 = dict(LANES=LANES, CK=CK, KB=32, NSTEPS=2, Rp=RP, NCH=4)


@pytest.fixture(scope="module")
def p5():
    return _probe_defs("probes/kernel_probe5.py",
                       ["CPARAMS", "call", "k_sbmajor", "k_sblist", "k_wl"],
                       **P5)


@pytest.mark.parametrize("case", [
    "sbmajor_s2", "sbmajor_s4", "sblist_s2", "sblist_s4", "sblist_repeat",
    "wl_L1", "wl_L2", "wl_L4"])
def test_probe5_matches_plain(p5, case):
    rng = np.random.default_rng(5)
    x = _ints(rng, (RP, LANES))
    as_ = _ints(rng, (64, LANES))
    call = p5["call"]
    if case.startswith("wl"):
        L = int(case[-1])
        nwin = 4 // L
        slabs = rng.integers(0, RP, (2, nwin * 8)).astype(np.int32)
        m = rng.integers(0, LANES, (64, LANES)).astype(np.int32)
        want = _jax(lambda *a: call(p5["k_wl"](L), 8, *a), m, as_, slabs, x)
        got = _plain("wl", m, as_, slabs, x, kb=32, L=L)
    else:
        span = 2 if case.endswith("s2") else 4
        qb = rng.integers(1, RP - span - 2, (2, 4)).astype(np.int32)
        ja = _codes(rng, qb, CK, -1, span + 2)
        if case.startswith("sbmajor"):
            lst = np.zeros((2, 4 * span), np.int32)
            lst[:, ::span] = qb
            want = _jax(lambda *a: call(p5["k_sbmajor"](span), span, *a),
                        ja, as_, lst, x)
            got = _plain("masked", ja, as_, lst, x, kb=32, span=span,
                         stride=span)
        else:
            lst = (qb[:, :, None] + np.arange(span)).reshape(2, -1)
            if case == "sblist_repeat":  # slab qb listed twice in a chunk
                lst = lst.reshape(2, 4, span)
                lst[:, :, 1] = lst[:, :, 0]
                lst = lst.reshape(2, -1)
            lst = lst.astype(np.int32)
            want = _jax(lambda *a: call(p5["k_sblist"](span), span, *a),
                        ja, as_, lst, x)
            got = _plain("sblist", ja, as_, lst, x, kb=32, span=span)
    assert np.abs(want).max() > 0
    np.testing.assert_array_equal(got, want)


def test_probe_defs_raises_on_a_missing_definition():
    with pytest.raises(LookupError, match="no \\['k_nowhere'\\]"):
        _probe_defs("probes/kernel_probe5.py", ["k_wl", "k_nowhere"], **P5)


# ---- the port's input builders against the probes' own checksum ----


@pytest.fixture(scope="module")
def probe_ref_sum():
    x = np.random.default_rng(6).integers(-4, 4, (RP, LANES)).astype(
        np.float32)
    ns = _probe_defs("probes/kernel_probe.py", ["ref_sum"], x_tab=x)
    return ns["ref_sum"], x


@pytest.mark.parametrize("builder", [
    "mk_data", "mk_w", "mk_ck16", "rel_i16", "fuse_halves", "sb_lists",
    "wl_data"])
def test_builders_decode_to_the_probe_checksum(probe_ref_sum, builder):
    """The planes the port builds decode, through the plain versions, to
    the probe's fp64 checksum of the same entries (small integers: exact);
    fuse_chunks' plane streams as the two planes it holds."""
    ref, x_np = probe_ref_sum
    x = _t(x_np)
    g = torch.Generator().manual_seed(7)
    steps, kb = 2, 64
    if builder == "wl_data":
        slabs, m, as_, cols = K.wl_data(2, steps=steps, kb=kb, xrows=RP,
                                        generator=g)
        y = K.kp_decode_plain("wl", m, as_, slabs, x, kb=kb, L=2)
        want = ref(cols.numpy(), as_.numpy())
    elif builder == "mk_w":
        qb, ja, as_ = K.mk_w(16, steps=steps, kb=kb, xrows=RP, generator=g)
        y = K.kp_decode_plain("window", ja, as_, qb, x, kb=kb, ck=16)
        want = ref(ja.numpy(), as_.numpy())
    elif builder == "mk_ck16":
        qb, ja, as_ = K.mk(1, steps=steps, kb=kb, ck=16, hi=RP - 16,
                           generator=g)
        y = K.kp_decode_plain("bcast", ja, as_, qb, x, kb=kb, ck=16)
        want = ref(ja.numpy(), as_.numpy())
    elif builder == "fuse_halves":
        qb = K.qb_for(steps, kb // CK, RP, generator=g)
        ja, as_ = K.mk_data(qb, 1, CK, generator=g)
        f = K.fuse_halves(ja, as_, kb)
        y = K.kp_fused_plain("halves_gather", f, qb, x, kb=kb)
        want = ref(ja.numpy(), as_.numpy())
        fc = K.fuse_chunks(ja, as_)
        assert torch.equal(K.kp_fused_plain("fused8", fc, kb=kb),
                           K.kp_decode_plain("stream", ja, as_, None, None,
                                             kb=kb))
    else:
        qb = K.qb_for(steps, kb // CK, RP - 4, generator=g)
        ja, as_ = K.mk_data(qb, 4, CK, generator=g)
        want = ref(ja.numpy(), as_.numpy())
        if builder == "mk_data":
            y = K.kp_decode_plain("masked", ja, as_, qb, x, kb=kb, span=4)
        elif builder == "rel_i16":
            y = K.kp_decode_plain("masked", K.rel_i16(ja, qb), as_, qb, x,
                                  kb=kb, span=4)
        else:
            lst_sb, lst_sl = K.sb_lists(qb, 4)
            y = K.kp_decode_plain("masked", ja, as_, lst_sb, x, kb=kb,
                                  span=4, stride=4)
            assert float(K.kp_decode_plain("sblist", ja, as_, lst_sl, x,
                                           kb=kb, span=4).double().sum()) \
                == want
    assert want != 0 and float(y.double().sum()) == want


def test_halves_pure_wraps_as_int32():
    """The plain halves-pure column sum wraps to int32 before widening."""
    f = torch.full((16, LANES), 2 ** 30, dtype=torch.int32)
    got = K.kp_fused_plain("halves_pure", f, kb=8)
    assert got.shape == (8, LANES)
    wrapped = (16 * 2 ** 30 + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert torch.all(got == float(wrapped))


def _tpu_variants():
    names = []
    for i in ("", "2", "3", "4", "5"):
        with open(os.path.join(ROOT, f"probes/kernel_probe{i}.out.json")) as f:
            names += [json.loads(line)["variant"] for line in f]
    return names


def test_cpu_run_covers_every_tpu_variant():
    """``run_kernel_probes`` on the CPU, quick (16 steps): one record per
    TPU probe row, in the probes' order, under the same name; every plain
    result equals its probe checksum; nothing timed, nothing launched."""
    before = {k: w.launches for k, w in K.KERNELS.items()}
    lines = []
    recs = K.run_kernel_probes("cpu", quick=True, emit=lines.append)
    assert [r["variant"] for r in recs] == _tpu_variants()
    assert len(lines) == len(recs)
    assert all(r["ms"] is None for r in recs)
    assert all(r.get("rel_err", 0.0) == 0.0 for r in recs)
    assert {r["kernel"] for r in recs} == set(K.KERNELS)
    assert all(r["bound_ms"] > 0 for r in recs)
    assert {k: w.launches for k, w in K.KERNELS.items()} == before


WRAPPED = {
    "kp_decode": lambda t: K.kp_decode(
        "masked", t.to(torch.int32), t, torch.zeros(1, 8, dtype=torch.int32),
        torch.zeros(64, LANES), kb=64, span=4),
    "kp_fused": lambda t: K.kp_fused("halves_pure", t.to(torch.int32), kb=32),
    "kp_colsum": lambda t: K.kp_colsum(t),
}


@pytest.mark.parametrize("kernel", sorted(WRAPPED))
def test_wrapper_raises_on_cpu_tensors(kernel):
    """The probes measure the card: a CPU tensor raises, and nothing is
    counted as launched."""
    before = K.KERNELS[kernel].launches
    with pytest.raises(RuntimeError, match="runs on CUDA tensors"):
        WRAPPED[kernel](torch.ones(64, LANES))
    assert K.KERNELS[kernel].launches == before


@pytest.mark.parametrize("sms,steps,kb,want", [
    (132, 256, 512, (5, 13, 1280)), (132, 16, 8192, (64, 16, 1024)),
    (132, 256, 8192, (5, 205, 1280)), (132, 2, 32, (4, 1, 8))])
def test_decode_grid_fills_the_card(sms, steps, kb, want):
    """Each step cut into whole runs of 8-row groups; the grid holds about
    8 blocks per SM, at least one per step."""
    parts, gpp, blocks, threads = K.decode_grid(sms, steps, kb)
    assert (parts, gpp, blocks) == want and threads == 128
    assert (parts - 1) * gpp < kb // 8 <= parts * gpp

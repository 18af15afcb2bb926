"""Kernel-variant probes of the card: what a layout's decode costs beside
what its bytes cost.

Counterpart of the JAX package's ``probes/kernel_probe{,2,3,4,5}.py``, whose
Pallas kernels become three templates of ``csrc/kernel_probe.cu`` (see its
header for the function and the design):

* :func:`kp_decode` — the decode probes: a step of ``kb`` plane rows owns
  the output tile ``y[8g:8g+8]``; a chunk of ``ck`` rows shares one scalar
  of the step's row of ``tab``; each entry adds ``v * xhat`` onto its row
  mod 8, and the mode says what ``xhat`` is: ``stream`` (``float(ja)``),
  ``bcast``, ``window``, ``masked``, ``sblist`` or ``wl``, on int32, int16 or
  int8 codes;
* :func:`kp_fused` — one int32 plane holding codes and the bits of the
  values: ``fused8`` (8-row chunks interleaved, probe 3), ``halves_gather``
  and ``halves_pure`` (blocks of a ja half then an as half, probe 4);
* :func:`kp_colsum` — the f32 column sum of one or two streams, on every
  row of the (8, 128) output (probe 4's reads).

Each kernel has a wrapper here, which launches it on CUDA tensors and raises
on anything else (the probes measure the card: there is nothing to fall
back to) and counts its launches in ``.launches``, and a plain PyTorch
version of the same function (``*_plain``). The TPU's column sums keep only
the last block's sums (every grid step writes output block (0, 0)); these
sum every block, the TPU function at one block.

:func:`run_kernel_probes` runs the five TPU probes' sweeps variant for
variant, under the names the TPU probes print (``span4_i16``,
``gather_w_ck16``, ``stream_fused_kb4096``, ``read1_half_x2``, ``wl_L2``,
...). Its planes are small integers made on the device from a
``torch.Generator``, so every f32 sum is exact and each kernel must equal
its plain version bit for bit; each result's sum must also equal the
probe's own fp64 checksum (``ref_sum``). Run on a machine with a CUDA card::

    python -m sparsematrixvectormultiplication_tpu_torch.bench.kernel_probe [--quick]

It prints one JSON line per variant with ``ms`` (``device_time_fn`` after
``flush_hbm``, the best of 3 rounds of 20 calls back to back), ``gnnz_s``,
``GBps`` of the variant's plane bytes at the probes' own bytes per entry (8
for int32 codes, 6 for int16, 5 for int8), ``bound_ms`` (the bytes the
function must move over 3.35e12 B/s), ``pct_copy`` (``GBps`` over the copy
rate of ``bench.bw_probe``'s ``bw_copy``, measured in the same run unless
given), ``plain_ms``, ``library_ms`` (one PyTorch call computing the same
function: ``a.sum(0)`` for the single-stream column sums, else null) and
the launch shape, then the card's name and power limit. It exits non-zero
without a card. On the CPU, ``run_kernel_probes`` builds the same planes,
runs the plain versions and checks them against the checksum; it times
nothing and launches nothing.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import torch

from ..ops import _build
from ..utils.timing import device_time_fn
from . import bw_probe as BW
from .harness import flush_hbm

__all__ = ["kp_decode", "kp_decode_plain", "kp_fused", "kp_fused_plain",
           "kp_colsum", "kp_colsum_plain", "decode_grid", "colsum_grid",
           "qb_for", "mk_data", "mk", "mk_w", "rel_i16", "fuse_chunks",
           "fuse_halves", "sb_lists", "wl_data", "ref_sum", "x_entries",
           "run_kernel_probes", "KERNELS", "MODES", "FUSED", "LANES"]

LANES = 128
CK = 8
MODES = ("stream", "bcast", "window", "masked", "sblist", "wl")
FUSED = ("fused8", "halves_gather", "halves_pure")
_CODE_BYTES = {torch.int32: 4, torch.int16: 2, torch.int8: 1}
_BLOCKS_PER_SM = 8         # decode and fused grids: 128-thread blocks
_COLSUM_BLOCKS_PER_SM = 8  # colsum: 256-thread blocks
_DECODE_THREADS, _COLSUM_THREADS = 128, 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak
F32_FLOP_PER_S = 67e12     # H100 SXM f32 peak outside the tensor cores
_REPS, _ROUNDS, _PLAIN_REPS = 20, 3, 3
# the probes' sizes: 256 steps of 512 rows (16,777,216 entries), a 2048-row
# x table (1 MB), probe 4's streams of 2^21 rows (8192 rows per step);
# quick: 16 steps, the least at which probe 3 still has a step of 8192 rows
STEPS, QUICK_STEPS, XROWS, KB4 = 256, 16, 2048, 8192


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _fold(p: torch.Tensor, steps: int) -> torch.Tensor:
    """(steps, ..., 128) products -> (steps*8, 128): row i of a step onto
    slot i % 8."""
    return p.reshape(steps, -1, 8, LANES).sum(1).reshape(steps * 8, LANES)


def _chunk_scalars(tab: torch.Tensor, nch: int, stride: int) -> torch.Tensor:
    """tab[g, c*stride] as a (steps, nch, 1, 1) long tensor."""
    return tab[:, : nch * stride: stride].long()[:, :, None, None]


def _xindex(mode, code, tab, *, ck, span, L, stride, rel):
    """Flat x index of each entry's ``xhat`` and its hit mask (None: every
    entry reads x), for the modes with one x read per entry."""
    steps, nch = code.shape[:2]
    m = (code & (LANES - 1)).long()
    if mode == "wl":
        rows = tab[:, : 8 * nch // L].reshape(steps, nch // L, 8).long()
        rows = rows[:, torch.arange(nch, device=code.device) // L]
        return rows[:, :, :, None] * LANES + m, None
    q = _chunk_scalars(tab, nch, stride)
    if mode == "bcast":
        return q * LANES + m, None
    if mode == "window":
        r = torch.arange(ck, device=code.device)[None, None, :, None]
        return (q + r) * LANES + m, None
    d = (code >> 7).long() if rel else (code >> 7).long() - q
    hit = (d >= 0) & (d < span)
    return (q + d.clamp(0, span - 1)) * LANES + m, hit


def _check_decode(mode, ja, as_, tab, x, kb, ck, span, L, stride):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    if ck < 8 or ck % 8 or kb % ck:
        raise ValueError(f"ck must be a multiple of 8 dividing kb, got ck={ck}"
                         f", kb={kb}")
    if ja.dtype not in _CODE_BYTES or as_.dtype != torch.float32:
        raise ValueError(f"codes int32/int16/int8 and f32 values, got "
                         f"{ja.dtype}, {as_.dtype}")
    if (ja.dim() != 2 or ja.shape[1] != LANES or ja.shape[0] % kb
            or as_.shape != ja.shape):
        raise ValueError(f"ja and as must be (steps*kb, 128), got "
                         f"{tuple(ja.shape)}, {tuple(as_.shape)}")
    steps, nch = ja.shape[0] // kb, kb // ck
    if mode == "stream":
        return steps
    if tab is None or x is None or x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError(f"mode {mode} needs tab and an (xrows, 128) x")
    need = {"sblist": nch * span, "wl": 8 * nch // max(L, 1)}.get(
        mode, (nch - 1) * stride + 1)
    if tab.dim() != 2 or tab.shape[0] != steps or tab.shape[1] < need:
        raise ValueError(f"tab must be ({steps}, >= {need}) for {mode}, got "
                         f"{tuple(tab.shape)}")
    if mode == "wl" and (ck != 8 or L < 1 or nch % L):
        raise ValueError(f"wl takes ck=8 and L dividing the {nch} chunks")
    if mode in ("masked", "sblist") and span < 1:
        raise ValueError("span must be >= 1")
    return steps


def kp_decode_plain(mode: str, ja: torch.Tensor, as_: torch.Tensor,
                    tab: torch.Tensor | None, x: torch.Tensor | None, *,
                    kb: int, ck: int = CK, span: int = 1, L: int = 1,
                    stride: int = 1) -> torch.Tensor:
    """The (steps*8, 128) f32 tiles of ``csrc/kernel_probe.cu``'s decode
    function. Preconditions (as the probes' data meet them): every x row a
    mode reads exists, and the m-only int8/int16 codes hold 0..127."""
    steps = _check_decode(mode, ja, as_, tab, x, kb, ck, span, L, stride)
    nch = kb // ck
    code = ja.view(steps, nch, ck, LANES).to(torch.int32)
    v = as_.view(steps, nch, ck, LANES)
    if mode == "stream":
        return _fold(v * code.float(), steps)
    xf = x.reshape(-1)
    if mode == "sblist":
        lst = tab[:, : nch * span].reshape(steps, nch, span).long()
        slab, m = (code >> 7).long(), (code & (LANES - 1)).long()
        xh = torch.zeros_like(v)
        for s in range(span):  # in order s: a repeated slab counts twice
            ls = lst[:, :, s, None, None]
            xh = xh + torch.where(slab == ls, xf[ls * LANES + m], 0.0)
        return _fold(v * xh, steps)
    idx, hit = _xindex(mode, code, tab, ck=ck, span=span, L=L, stride=stride,
                       rel=ja.dtype == torch.int16)
    xh = xf[idx] if hit is None else torch.where(hit, xf[idx], 0.0)
    return _fold(v * xh, steps)


def x_entries(mode: str, ja, tab, *, kb, ck=CK, span=1, L=1,
              stride=1, xrows: int) -> int:
    """How many distinct x entries the decode reads on these codes."""
    if mode == "stream":
        return 0
    steps, nch = ja.shape[0] // kb, kb // ck
    code = ja.view(steps, nch, ck, LANES).to(torch.int32)
    if mode == "sblist":
        lst = tab[:, : nch * span].reshape(steps, nch, span)
        slab = code >> 7
        hit = torch.zeros(code.shape, dtype=torch.bool, device=code.device)
        for s in range(span):
            hit |= slab == lst[:, :, s, None, None]
        idx = slab.long() * LANES + (code & (LANES - 1)).long()
    else:
        idx, hit = _xindex(mode, code, tab, ck=ck, span=span, L=L,
                           stride=stride, rel=ja.dtype == torch.int16)
    mark = torch.zeros(xrows * LANES, dtype=torch.bool, device=code.device)
    mark[idx if hit is None else idx[hit]] = True
    return int(mark.sum())


def _check_fused(mode, f, tab, x, kb):
    if mode not in FUSED:
        raise ValueError(f"mode {mode!r}: one of {FUSED}")
    if f.dtype != torch.int32 or f.dim() != 2 or f.shape[1] != LANES:
        raise ValueError(f"the fused plane must be (rows, 128) int32, got "
                         f"{f.dtype} {tuple(f.shape)}")
    if kb < 8 or kb % 8 or f.shape[0] % (2 * kb):
        raise ValueError(f"kb must be a multiple of 8 and the plane whole "
                         f"steps of 2*kb rows, got kb={kb}, "
                         f"{f.shape[0]} rows")
    steps = f.shape[0] // (2 * kb)
    if mode == "halves_gather" and (
            tab is None or x is None or tuple(tab.shape) != (steps, kb // 8)
            or x.dim() != 2 or x.shape[1] != LANES):
        raise ValueError(f"halves_gather takes tab ({steps}, {kb // 8}) and "
                         "an (xrows, 128) x")
    return steps


def kp_fused_plain(mode: str, f: torch.Tensor, tab: torch.Tensor | None = None,
                   x: torch.Tensor | None = None, *, kb: int) -> torch.Tensor:
    """fused8 and halves_gather: (steps*8, 128) f32 tiles; halves_pure: the
    int32 (wrapping) column sum of the plane, as f32, on every row of an
    (8, 128) tile."""
    steps = _check_fused(mode, f, tab, x, kb)
    if mode == "halves_pure":
        s = f.sum(0, dtype=torch.int64)  # exact, then wrapped to int32
        s = torch.remainder(s + 2 ** 31, 2 ** 32) - 2 ** 31
        return s.to(torch.int32).float().expand(8, LANES).contiguous()
    if mode == "fused8":
        c = f.view(-1, 2, 8, LANES)
        return _fold(c[:, 1].view(torch.float32) * c[:, 0].float(), steps)
    blk = f.view(steps, 2, kb // 8, 8, LANES)
    ja, v = blk[:, 0], blk[:, 1].view(torch.float32)
    idx = tab.long()[:, :, None, None] * LANES + (ja & (LANES - 1)).long()
    return _fold(v * x.reshape(-1)[idx], steps)


def kp_colsum_plain(a: torch.Tensor, b: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """The f32 column sum of ``a`` (or of ``a + b``, added per entry) on
    every row of an (8, 128) tile."""
    _check_colsum(a, b)
    s = (a if b is None else a + b).sum(0)
    return s.expand(8, LANES).contiguous()


def _check_colsum(a, b):
    for t in (a,) if b is None else (a, b):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != LANES:
            raise ValueError(f"colsum streams are (rows, 128) f32, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if b is not None and b.shape != a.shape:
        raise ValueError(f"b {tuple(b.shape)} is not the shape of a "
                         f"{tuple(a.shape)}")


# ---------------------------------------------------------------------------
# the kernels' wrappers: CUDA tensors only
# ---------------------------------------------------------------------------


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_grid(sms: int, steps: int, kb: int) -> tuple:
    """``(parts, gpp, blocks, threads)`` of a decode or fused launch: each
    step cut into ``parts`` runs of ``gpp`` 8-row groups, so that the grid
    holds about ``_BLOCKS_PER_SM`` 128-thread blocks per SM."""
    groups = kb // 8
    parts = min(groups, max(1, -(-sms * _BLOCKS_PER_SM // steps)))
    gpp = -(-groups // parts)
    parts = -(-groups // gpp)
    return parts, gpp, steps * parts, _DECODE_THREADS


def colsum_grid(sms: int, n_rows: int) -> tuple:
    """``(blocks, threads)`` of a colsum launch."""
    return (max(1, min(-(-n_rows // 8), sms * _COLSUM_BLOCKS_PER_SM)),
            _COLSUM_THREADS)


def _check_cuda(name, tensors):
    tensors = {k: t for k, t in tensors.items() if t is not None}
    BW._check(name, tensors, {k: (t.dtype,) for k, t in tensors.items()})


def _ptr(t):
    return None if t is None else t.data_ptr()


def kp_decode(mode: str, ja: torch.Tensor, as_: torch.Tensor,
              tab: torch.Tensor | None, x: torch.Tensor | None, *, kb: int,
              ck: int = CK, span: int = 1, L: int = 1,
              stride: int = 1) -> torch.Tensor:
    """:func:`kp_decode_plain` through ``kp_decode``."""
    _check_cuda("kp_decode", {"ja": ja, "as_": as_, "tab": tab, "x": x})
    steps = _check_decode(mode, ja, as_, tab, x, kb, ck, span, L, stride)
    if tab is not None and tab.dtype != torch.int32:
        raise ValueError(f"tab must be int32, got {tab.dtype}")
    dev = ja.device
    parts, gpp, _, _ = decode_grid(_sms(dev.index), steps, kb)
    y = torch.empty(steps * 8, LANES, dtype=torch.float32, device=dev)
    partial = y if parts == 1 else torch.empty(
        steps * parts * 8, LANES, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        BW._call("kp_decode", MODES.index(mode), _CODE_BYTES[ja.dtype],
                 ja.data_ptr(), as_.data_ptr(), _ptr(tab), _ptr(x),
                 partial.data_ptr(), y.data_ptr(), steps, kb, ck, span, L,
                 stride, 0 if tab is None else tab.shape[1], parts, gpp,
                 BW._stream(dev))
    kp_decode.launches += 1
    return y


def kp_fused(mode: str, f: torch.Tensor, tab: torch.Tensor | None = None,
             x: torch.Tensor | None = None, *, kb: int) -> torch.Tensor:
    """:func:`kp_fused_plain` through ``kp_fused``."""
    _check_cuda("kp_fused", {"f": f, "tab": tab, "x": x})
    steps = _check_fused(mode, f, tab, x, kb)
    if tab is not None and tab.dtype != torch.int32:
        raise ValueError(f"tab must be int32, got {tab.dtype}")
    dev = f.device
    parts, gpp, nb, _ = decode_grid(_sms(dev.index), steps, kb)
    if mode == "halves_pure":  # per-block uint32 column sums, then a fold
        y = torch.empty(8, LANES, dtype=torch.float32, device=dev)
        partial = torch.empty(nb, LANES, dtype=torch.int32, device=dev)
    else:
        y = torch.empty(steps * 8, LANES, dtype=torch.float32, device=dev)
        partial = y if parts == 1 else torch.empty(
            nb * 8, LANES, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        BW._call("kp_fused", FUSED.index(mode), f.data_ptr(), _ptr(tab),
                 _ptr(x), partial.data_ptr(), y.data_ptr(), steps, kb,
                 kb // 8, parts, gpp, BW._stream(dev))
    kp_fused.launches += 1
    return y


def kp_colsum(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`kp_colsum_plain` through ``kp_colsum``."""
    _check_cuda("kp_colsum", {"a": a, "b": b})
    _check_colsum(a, b)
    nb, _ = colsum_grid(_sms(a.device.index), a.shape[0])
    partial = torch.empty(nb, LANES, dtype=torch.float32, device=a.device)
    out = torch.empty(8, LANES, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        BW._call("kp_colsum", a.data_ptr(), _ptr(b), int(b is not None),
                 a.shape[0], nb, partial.data_ptr(), out.data_ptr(),
                 BW._stream(a.device))
    kp_colsum.launches += 1
    return out


KERNELS = {"kp_decode": kp_decode, "kp_fused": kp_fused,
           "kp_colsum": kp_colsum}
PLAIN = {"kp_decode": kp_decode_plain, "kp_fused": kp_fused_plain,
         "kp_colsum": kp_colsum_plain}
for _w in KERNELS.values():
    _w.launches = 0


# ---------------------------------------------------------------------------
# the probes' input builders, on the device
# ---------------------------------------------------------------------------


def _ints(shape, lo, hi, g, dtype=torch.int32):
    return torch.randint(lo, hi, shape, generator=g, device=g.device,
                         dtype=dtype)


def qb_for(steps: int, nch: int, hi: int, *, generator) -> torch.Tensor:
    """Each chunk's base slab, uniform in [0, hi) (≙ kernel_probe.py:64
    ``qb_for``; probe 2 and 3's ``mk`` draw it the same way)."""
    return _ints((steps, nch), 0, hi, generator)


def mk_data(qb: torch.Tensor, span: int, ck: int, *, generator) -> tuple:
    """``(ja, as_)``: ``ja = 128*(qb + d) + m`` with d in [0, span) and m in
    [0, 128) per entry, ``as_`` small integers in [-8, 8) as f32, both
    (steps * nch * ck, 128) (≙ kernel_probe.py:67 ``mk_data``)."""
    steps, nch = qb.shape
    shape = (steps, nch, ck, LANES)
    d = _ints(shape, 0, span, generator)
    m = _ints(shape, 0, LANES, generator)
    ja = ((qb[:, :, None, None] + d) * LANES + m).view(-1, LANES)
    return ja, BW.small_ints(ja.shape, torch.float32, generator=generator,
                             device=generator.device)


def mk(span: int, *, steps: int, kb: int, ck: int = CK, hi: int,
       generator) -> tuple:
    """``(qb, ja, as_)`` of ``steps`` steps of ``kb`` rows in chunks of
    ``ck`` (≙ kernel_probe2.py:166 and kernel_probe3.py:153 ``mk``)."""
    qb = qb_for(steps, kb // ck, hi, generator=generator)
    return (qb, *mk_data(qb, span, ck, generator=generator))


def mk_w(ck: int, *, steps: int, kb: int, xrows: int, generator) -> tuple:
    """The layered planes: d is the row within the ck-row chunk
    (≙ kernel_probe2.py:177 ``mk_w``, kernel_probe.py:245-253)."""
    nch = kb // ck
    qb = qb_for(steps, nch, xrows - ck, generator=generator)
    m = _ints((steps, nch, ck, LANES), 0, LANES, generator)
    d = torch.arange(ck, device=generator.device, dtype=torch.int32)
    ja = ((qb[:, :, None, None] + d[:, None]) * LANES + m).view(-1, LANES)
    return qb, ja, BW.small_ints(ja.shape, torch.float32, generator=generator,
                                 device=generator.device)


def rel_i16(ja: torch.Tensor, qb: torch.Tensor, ck: int = CK) -> torch.Tensor:
    """int16 codes ``(d << 7) | m`` relative to each chunk's qb
    (≙ kernel_probe.py:237-239)."""
    steps, nch = qb.shape
    d = (ja.view(steps, nch, ck, LANES) >> 7) - qb[:, :, None, None]
    return ((d.view(-1, LANES) << 7) | (ja & (LANES - 1))).to(torch.int16)


def fuse_chunks(ja: torch.Tensor, as_: torch.Tensor) -> torch.Tensor:
    """One int32 plane: each 8-row ja chunk followed by its 8 rows of value
    bits (≙ kernel_probe3.py:198-204)."""
    return torch.stack([ja.view(-1, 8, LANES),
                        as_.view(torch.int32).view(-1, 8, LANES)],
                       1).view(-1, LANES)


def fuse_halves(ja: torch.Tensor, as_: torch.Tensor, kb: int) -> torch.Tensor:
    """One int32 plane of 2*kb-row blocks: kb rows of ja, then their value
    bits (≙ kernel_probe4.py:170-176 and :227-232)."""
    return torch.stack([ja.view(-1, kb, LANES),
                        as_.view(torch.int32).view(-1, kb, LANES)],
                       1).view(-1, LANES)


def sb_lists(qb: torch.Tensor, span: int) -> tuple:
    """Probe 5's tables: sb-major's ``lst[g, c*span] = qb`` (0 elsewhere)
    and sb-list's distinct ``qb .. qb + span - 1`` (≙ kernel_probe5.py:
    175-181)."""
    steps, nch = qb.shape
    lst_sb = torch.zeros(steps, nch * span, dtype=torch.int32,
                         device=qb.device)
    lst_sb[:, ::span] = qb
    lst_sl = (qb[:, :, None] + torch.arange(span, dtype=torch.int32,
                                            device=qb.device)).view(steps, -1)
    return lst_sb, lst_sl


def wl_data(L: int, *, steps: int, kb: int, xrows: int, generator) -> tuple:
    """``(slabs, m, as_, cols)``: per window of L layer tiles, 8 arbitrary
    slabs; the codes are m alone; ``cols`` the absolute columns, for the
    checksum (≙ kernel_probe5.py:186-193)."""
    nwin = kb // CK // L
    slabs = _ints((steps, nwin, 8), 0, xrows, generator)
    m = _ints((steps, nwin, L, CK, LANES), 0, LANES, generator)
    as_ = BW.small_ints(m.shape, torch.float32, generator=generator,
                        device=generator.device).view(-1, LANES)
    cols = (slabs[:, :, None, :, None] * LANES + m).view(-1, LANES)
    return slabs.view(steps, -1), m.view(-1, LANES), as_, cols


def ref_sum(ja: torch.Tensor, as_: torch.Tensor, x: torch.Tensor) -> float:
    """The probes' fp64 checksum: sum of as * x.flat[ja] over every entry
    (≙ kernel_probe.py:75 ``ref_sum``)."""
    return float((as_.double() * x.reshape(-1)[ja.long()].double()).sum())


# ---------------------------------------------------------------------------
# the sweeps
# ---------------------------------------------------------------------------


def _small(ja: torch.Tensor) -> torch.Tensor:
    """The lane part of the codes: the stream variants sum float(ja) * as,
    and codes below 128 keep every such f32 sum exact at 8192-row steps."""
    return ja & (LANES - 1)


def _variants(steps: int, g: torch.Generator, x: torch.Tensor):
    """Yield ``(name, replaces, kernel, args, kw, entries, bpe, chk)`` per
    variant of the five TPU probes, in their order; ``args`` are the
    kernel's positional arguments (planes built fresh for each variant,
    dropped when the next is made)."""
    xr = x.shape[0]
    kb = 512
    dec = "kp_decode"
    ent = steps * kb * LANES
    # ---- probe 1: span sweep, int16 codes, window read, layered planes
    p1 = "probes/kernel_probe.py:96"
    qb = qb_for(steps, kb // CK, xr - 1, generator=g)
    ja, as_ = mk_data(qb, 1, CK, generator=g)
    yield ("stream2op", p1 + " k_stream", dec,
           ("stream", _small(ja), as_, qb, x),
           {"kb": kb}, ent, 8, None)
    for span in (1, 2, 4, 8, 16, 24, 32):
        qb = qb_for(steps, kb // CK, xr - span, generator=g)
        ja, as_ = mk_data(qb, span, CK, generator=g)
        chk = ref_sum(ja, as_, x)
        kw = {"kb": kb, "span": span}
        yield (f"span{span}_i32", p1 + " k_span", dec,
               ("masked", ja, as_, qb, x), kw, ent, 8, chk)
        if span in (4, 8, 16, 24):
            yield (f"span{span}_i16", p1 + " k_span(i16)", dec,
                   ("masked", rel_i16(ja, qb), as_, qb, x), kw, ent, 6, chk)
        if span == 8:
            yield ("span8_w", p1 + " k_span_window", dec,
                   ("masked", ja, as_, qb, x), kw, ent, 8, chk)
    qb, ja, as_ = mk_w(CK, steps=steps, kb=kb, xrows=xr, generator=g)
    chk = ref_sum(ja, as_, x)
    m = ja & (LANES - 1)
    for tag, codes, bpe in (("i32", ja, 8), ("i8", m.to(torch.int8), 5),
                            ("i16", m.to(torch.int16), 6)):
        yield (f"layered_{tag}", p1 + " k_layered", dec,
               ("window", codes, as_, qb, x), {"kb": kb}, ent, bpe, chk)
    del m
    # ---- probe 2: chunk height
    p2 = "probes/kernel_probe2.py:76"
    qb, ja, as_ = mk(1, steps=steps, kb=kb, hi=xr - CK, generator=g)
    yield ("stream_u_ck8", p2 + " k_stream", dec,
           ("stream", _small(ja), as_, qb, x),
           {"kb": kb}, ent, 8, None)
    for ck in (8, 16, 32, 64):
        qb, ja, as_ = mk(1, steps=steps, kb=kb, ck=ck, hi=xr - ck,
                         generator=g)
        yield (f"gather_b_ck{ck}", p2 + " k_gather_b", dec,
               ("bcast", ja, as_, qb, x), {"kb": kb, "ck": ck}, ent, 8,
               ref_sum(ja, as_, x))
        qb, ja, as_ = mk_w(ck, steps=steps, kb=kb, xrows=xr, generator=g)
        yield (f"gather_w_ck{ck}", p2 + " k_gather_w", dec,
               ("window", ja, as_, qb, x), {"kb": kb, "ck": ck}, ent, 8,
               ref_sum(ja, as_, x))
    for ck in (8, 32):
        qb, ja, as_ = mk(4, steps=steps, kb=kb, ck=ck, hi=xr - max(4, ck),
                         generator=g)
        yield (f"span4_ck{ck}", p2 + " k_span4", dec,
               ("masked", ja, as_, qb, x), {"kb": kb, "ck": ck, "span": 4},
               ent, 8, ref_sum(ja, as_, x))
    qb, ja, as_ = mk(4, steps=steps, kb=kb, hi=xr - CK, generator=g)
    yield ("i16cast_span4", p2 + " k_span4(i16)", dec,
           ("masked", rel_i16(ja, qb), as_, qb, x), {"kb": kb, "span": 4},
           ent, 6, ref_sum(ja, as_, x))
    # ---- probe 3: block height; one fused plane
    p3 = "probes/kernel_probe3.py:76"
    tot, big = steps * kb, 8192  # rows; probe 3's largest step
    for k3 in (512, 2048, 8192):
        qb, ja, as_ = mk(1, steps=tot // k3, kb=k3, hi=xr - 1, generator=g)
        yield (f"stream2_kb{k3}", p3 + " k_stream", dec,
               ("stream", _small(ja), as_, qb, x), {"kb": k3}, ent, 8, None)
    qb, ja, as_ = mk(1, steps=tot // 4096, kb=4096, hi=xr - 1, generator=g)
    yield ("stream_fused_kb4096", p3 + " k_fused", "kp_fused",
           ("fused8", fuse_chunks(_small(ja), as_)), {"kb": 4096}, ent, 8,
           None)
    for k3 in (2048, 8192):
        qb, ja, as_ = mk(1, steps=tot // k3, kb=k3, hi=xr - 1, generator=g)
        yield (f"gather_b_kb{k3}", p3 + " k_gather", dec,
               ("bcast", ja, as_, qb, x), {"kb": k3}, ent, 8,
               ref_sum(ja, as_, x))
    qb, ja, as_ = mk(1, steps=tot // big, kb=big, hi=xr - 1, generator=g)
    yield (f"gatherb_i16_kb{big}", p3 + " k_gather(i16)", dec,
           ("bcast", rel_i16(ja, qb), as_, qb, x), {"kb": big}, ent, 6,
           ref_sum(ja, as_, x))
    for span, i16 in ((4, False), (8, False), (4, True)):
        qb, ja, as_ = mk(span, steps=tot // big, kb=big, hi=xr - span,
                         generator=g)
        chk = ref_sum(ja, as_, x)
        kw = {"kb": big, "span": span}
        if i16:
            yield (f"span{span}_i16_kb{big}", p3 + " k_span(i16)", dec,
                   ("masked", rel_i16(ja, qb), as_, qb, x), kw, ent, 6, chk)
        else:
            yield (f"span{span}_kb{big}", p3 + " k_span", dec,
                   ("masked", ja, as_, qb, x), kw, ent, 8, chk)
    del qb, ja, as_
    # ---- probe 4: one stream, two, two calls, fused planes, span reads
    p4 = "probes/kernel_probe4.py"
    rows = steps * KB4  # 2^21 rows of 128 f32 per stream at 256 steps
    ints = {"generator": g, "device": g.device, "lo": -4, "hi": 4}
    a = BW.small_ints((rows, LANES), torch.float32, **ints)
    b = BW.small_ints((rows, LANES), torch.float32, **ints)
    e1 = rows * LANES
    for k4 in (2048, 8192, 32768):
        yield (f"read1_kb{k4}", f"{p4}:88 mk_read1", "kp_colsum", (a,), {},
               e1, 4, None)
    yield ("read2_kb8192", f"{p4}:118 mk_read2", "kp_colsum", (a, b), {},
           2 * e1, 4, None)
    yield ("read1_half_x2", f"{p4}:138 two_calls (mk_read1 :88)",
           "kp_colsum", ("two_calls", a, b), {}, 2 * e1, 4, None)
    del a, b
    ja = _ints((rows, LANES), 0, xr * LANES, g)
    as_ = BW.small_ints((rows, LANES), torch.float32, generator=g,
                        device=g.device)
    yield ("fused_pure_kb8192", f"{p4}:154 mk_fused_pure", "kp_fused",
           ("halves_pure", fuse_halves(ja, as_, KB4)), {"kb": KB4}, e1, 8,
           None)
    del ja
    qb = qb_for(rows // KB4, KB4 // CK, xr, generator=g)
    ja, _ = mk_data(qb, 1, CK, generator=g)
    chk = ref_sum(ja, as_, x)
    yield ("fused_gather_kb8192", f"{p4}:209 mk_fused_gather", "kp_fused",
           ("halves_gather", fuse_halves(ja, as_, KB4), qb, x), {"kb": KB4},
           e1, 8, chk)
    del ja, as_, qb
    for span in (8, 16):
        qb = qb_for(steps, kb // CK, xr - span, generator=g)
        ja, as_ = mk_data(qb, span, CK, generator=g)
        chk = ref_sum(ja, as_, x)
        for hoist in ("base", "hoist"):
            yield (f"span{span}_{hoist}", f"{p4}:285 mk_span", dec,
                   ("masked", ja, as_, qb, x), {"kb": kb, "span": span},
                   ent, 8, chk)
    # ---- probe 5: sb-major and sb-list passes, wl windows
    p5 = "probes/kernel_probe5.py:70"
    for span in (2, 4, 8):
        qb = qb_for(steps, kb // CK, xr - span, generator=g)
        ja, as_ = mk_data(qb, span, CK, generator=g)
        chk = ref_sum(ja, as_, x)
        lst_sb, lst_sl = sb_lists(qb, span)
        yield (f"sbmajor_s{span}", p5 + " k_sbmajor", dec,
               ("masked", ja, as_, lst_sb, x),
               {"kb": kb, "span": span, "stride": span}, ent, 8, chk)
        yield (f"sblist_s{span}", p5 + " k_sblist", dec,
               ("sblist", ja, as_, lst_sl, x), {"kb": kb, "span": span},
               ent, 8, chk)
    for L in (1, 2, 4):
        slabs, m, as_, cols = wl_data(L, steps=steps, kb=kb, xrows=xr,
                                      generator=g)
        yield (f"wl_L{L}", p5 + " k_wl", dec, ("wl", m, as_, slabs, x),
               {"kb": kb, "L": L}, ent, 8, ref_sum(cols, as_, x))


def _two_calls(fn, a, b):
    return fn(a) + fn(b)  # ≙ kernel_probe4.py:138: r1(a) + r1(b)


def run_kernel_probes(device, *, quick: bool = False, emit=print, log=None,
                      copy_rate: float | None = None) -> list:
    """Run the five TPU kernel probes' sweeps on ``device``; ``emit`` gets
    one JSON line per variant and the records are returned.

    On a CUDA device each variant runs its kernel, which must equal the
    plain version bit for bit and the probe's checksum, and is timed;
    ``copy_rate`` (B/s, read + write) is the ``pct_copy`` denominator,
    measured here with ``bw_copy`` when not given. On the CPU the plain
    versions run alone and nothing is timed. The probes' 256 steps (16
    when ``quick``) size every probe: the 512-row steps of probes 1, 2 and
    5, probe 3's 512 * steps rows, probe 4's 8192 * steps rows a stream."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    steps = QUICK_STEPS if quick else STEPS
    cuda = device.type == "cuda"
    g = torch.Generator(device=device).manual_seed(0)
    x = BW.small_ints((XROWS, LANES), torch.float32, generator=g,
                      device=device)
    if cuda and copy_rate is None:
        half = BW.small_ints((1 << 19, LANES), torch.float32, generator=g,
                             device=device)
        zero = torch.zeros(8, LANES, device=device)
        out = torch.empty_like(half)
        sec = min(device_time_fn(BW.bw_copy, half, zero, out,
                                 device=device) for _ in range(_ROUNDS))
        copy_rate = 2 * half.numel() * 4 / sec
        del half, out
    sms = _sms(device.index) if cuda else None
    records = []
    for name, replaces, kernel, args, kw, entries, bpe, chk in _variants(
            steps, g, x):
        mode = args[0] if isinstance(args[0], str) else "colsum"
        two = mode == "two_calls"
        if two:
            args = args[1:]
            fn_p = functools.partial(_two_calls, kp_colsum_plain)
            fn_k = functools.partial(_two_calls, kp_colsum)
        else:
            fn_p = functools.partial(PLAIN[kernel], **kw)
            fn_k = functools.partial(KERNELS[kernel], **kw)
        want = fn_p(*args)
        rec = {"probe": replaces.split(":")[0], "variant": name,
               "replaces": replaces, "kernel": kernel, "mode": mode,
               "codes": str(args[1].dtype)[6:] if kernel == "kp_decode"
               else None, **kw}
        if chk is not None:
            got_sum = float(want.double().sum())
            rec["rel_err"] = abs(got_sum - chk) / max(abs(chk), 1e-30)
            if got_sum != chk:
                raise RuntimeError(f"{name}: the plain version's sum "
                                   f"{got_sum} is not the probe's checksum "
                                   f"{chk}")
        x_read = 0
        if kernel == "kp_decode":
            x_read = x_entries(args[0], args[1], args[3], xrows=XROWS, **kw)
        elif mode == "halves_gather":
            f = args[1].view(-1, 2, kw["kb"], LANES)[:, 0].reshape(-1, LANES)
            x_read = x_entries("bcast", f, args[2], kb=kw["kb"], xrows=XROWS)
            del f
        # the function's bytes, once each: planes and tables, the x entries
        # it reads, its output; or its 2 FLOP per entry at the f32 rate
        moved = sum(t.numel() * t.element_size() for t in args
                    if isinstance(t, torch.Tensor) and t is not x) \
            + 4 * x_read + 4 * want.numel()
        by_bytes = moved / HBM_BYTES_PER_S
        by_ops = 2 * entries / F32_FLOP_PER_S
        bound = max(by_bytes, by_ops) * 1e3
        rec.update({"entries": entries, "bytes_per_entry": bpe,
                    "bound_ms": bound, "bound_bytes": moved,
                    "bound_by": "bytes" if by_bytes >= by_ops
                    else "operations",
                    "x_entries": x_read})
        if cuda:
            got = fn_k(*args)
            if not torch.equal(got, want):
                raise RuntimeError(
                    f"{name}: {kernel} disagrees with its plain version by "
                    f"up to {(got - want).abs().max().item()}")
            del got
            flush_hbm(device)
            sec = min(device_time_fn(fn_k, *args, device=device, reps=_REPS)
                      for _ in range(_ROUNDS))
            flush_hbm(device)
            plain_s = device_time_fn(fn_p, *args, device=device,
                                     reps=_PLAIN_REPS)
            lib = None
            if mode == "colsum" and len(args) == 1:
                a0 = args[0]
                flush_hbm(device)
                lib = min(device_time_fn(lambda: a0.sum(0), device=device,
                                         reps=_REPS)
                          for _ in range(_ROUNDS)) * 1e3
            gbps = bpe * entries / sec / 1e9
            if kernel == "kp_colsum":
                blocks, threads = colsum_grid(sms, args[0].shape[0])
            else:
                steps_k = args[1].shape[0] // kw["kb"] // (
                    2 if kernel == "kp_fused" else 1)
                _, _, blocks, threads = decode_grid(sms, steps_k, kw["kb"])
                blocks *= 2 if two else 1
            rec.update({"ms": sec * 1e3, "gnnz_s": entries / sec / 1e9,
                        "GBps": gbps, "pct_copy": gbps * 1e9 / copy_rate,
                        "pct_bound": bound / (sec * 1e3),
                        "plain_ms": plain_s * 1e3, "library_ms": lib,
                        "blocks": blocks, "threads": threads,
                        "equal": True})
            log(f"{name:22s} {kernel:10s} {sec * 1e3:8.4f} ms "
                f"{gbps / 1e3:6.3f} TB/s {rec['pct_copy']:6.1%} of copy, "
                f"bound {bound:.4f} ms, plain {plain_s * 1e3:.4f} ms"
                + (", PyTorch none" if lib is None
                   else f", PyTorch a.sum(0) {lib:.4f} ms"))
        else:
            rec.update({"ms": None, "gnnz_s": None, "GBps": None,
                        "pct_copy": None, "plain_ms": None,
                        "library_ms": None})
        del want, args
        records.append(rec)
        emit(json.dumps(rec))
    return records


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("kernel_probe: torch.cuda.is_available() is false: the kernel "
              "probes need a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.load()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    run_kernel_probes(dev, quick="--quick" in argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

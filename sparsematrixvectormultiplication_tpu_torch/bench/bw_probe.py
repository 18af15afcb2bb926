"""Bandwidth probe of the card: what a kernel streams from HBM.

Counterpart of the JAX package's ``probes/bw_probe.py``, whose Pallas
kernels become ``csrc/bw_probe.cu`` (see its header for the mapping and the
design). Each kernel has a wrapper here, which launches it on CUDA tensors
and raises on anything else (the probe measures the card: there is nothing
to fall back to), counts its launches in ``.launches``, and a plain PyTorch
version of the same function (``*_plain``):

* :func:`bw_read` — fold an ``(nrows, 128)`` f32, int32, int16 or int8
  array, or two of them (:func:`bw_read`'s ``b``: values + indices, the
  SELL bin's two streams), into an ``(8, 128)`` f32 tile: ``out = seed +
  sum_i a[i] (+ b[i])`` with row i onto ``out[i % 8]``;
* :func:`bw_copy` — ``out = buf + seed[0, 0]``, read and written once: its
  rate is the %STREAM denominator;
* :func:`bw_read_async` — the f32 fold through ``cp.async`` copies into
  shared memory, ``nbuf`` stages of ``chunk_rows`` rows per block;
* :func:`bw_kernelsim` — the miniature SELL kernel of the JAX probe, with
  its ``compute``, ``packed`` and ``span`` variants.

The TPU reads summed only the first 8 rows of each block they moved; these
sum every row, which equals the TPU function at 8-row blocks (``bk = 8``,
``chunk_rows = 8``). The probe's data are small integers (kernelsim's
codes gather from a ``span``-row window per chunk), so every sum is exact
in f32 and a kernel equals its plain version bit for bit.

Run on a machine with a CUDA card::

    python -m sparsematrixvectormultiplication_tpu_torch.bench.bw_probe [--quick]

It prints one JSON line per probe (``probe``, ``seconds``, ``gbytes``,
``GBps`` and extras, as the JAX probe does), the card's name and power
limit, and a summary table on stderr. Times are ``device_time_fn`` device
times (calls back to back behind a spin), the best of 3 rounds of 20. It
also times PyTorch's own read (``buf.sum(0)``, ≙ ``xla_sum_read``) and copy
(``torch.add(buf, s, out=...)``, ≙ ``xla_copy_rw``) and the device time of
one tiny launch (≙ ``launch_overhead``). It exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time

import torch

from ..ops import _build
from ..utils.timing import device_time_fn, time_fn

__all__ = ["bw_read", "bw_read_plain", "bw_copy", "bw_copy_plain",
           "bw_read_async", "bw_read_async_plain", "bw_kernelsim",
           "bw_kernelsim_plain", "run_probes", "KERNELS", "LANES",
           "ASYNC_CONFIGS"]

LANES = 128
_VEC_BYTES = 16
_THREADS = 256
_BLOCKS_PER_SM = 8  # read and copy grids: 8 blocks of 256 threads per SM
_READ_ENTRY = {torch.float32: "bw_read_f32", torch.int32: "bw_read_i32",
               torch.int16: "bw_read_i16", torch.int8: "bw_read_i8"}
# (chunk_rows, nbuf) of the cp.async sweep: three chunk sizes two stages
# deep and one three deep, as the JAX probe sweeps its DMA chunks
# (bw_probe.py:359); a block's stages live in its shared memory (<= 227 KB),
# so the chunks are rows of a block's stage, not the TPU's MB-sized chunks
ASYNC_CONFIGS = ((16, 2), (32, 2), (128, 2), (32, 3))
_REPS, _ROUNDS = 20, 3


def _check(name: str, tensors: dict, dtypes: dict):
    """Every tensor on one CUDA device, contiguous, of its dtype."""
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        raise RuntimeError(f"{name} runs on CUDA tensors, not {first.device}: "
                           "the probe measures the card")
    for key, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{key} is on {t.device}, not {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{key} is not contiguous")
        if t.dtype not in dtypes[key]:
            want = " or ".join(map(str, dtypes[key]))
            raise ValueError(f"{key} must be {want}, got {t.dtype}")


def _check_rows(name: str, a: torch.Tensor, multiple: int = 8):
    if a.dim() != 2 or a.shape[1] != LANES or a.shape[0] % multiple:
        raise ValueError(f"{name} must be (nrows, 128) with nrows a multiple "
                         f"of {multiple}, got {tuple(a.shape)}")


def _seed_tile(seed: torch.Tensor):
    if tuple(seed.shape) != (8, LANES):
        raise ValueError(f"seed must be (8, 128), got {tuple(seed.shape)}")


def _n_blocks(device: torch.device, n_vec: int, per_sm: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-n_vec // _THREADS), sms * per_sm))


def _call(name: str, *args) -> None:
    err = getattr(_build.load(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _fold(a: torch.Tensor) -> torch.Tensor:
    return a.view(-1, 8, LANES).sum(0, dtype=torch.float32)


def bw_read_plain(a: torch.Tensor, seed: torch.Tensor,
                  b: torch.Tensor | None = None) -> torch.Tensor:
    """``seed + sum_i f32(a[i]) (+ f32(b[i]))``, row i onto ``out[i % 8]``."""
    out = seed + _fold(a)
    return out if b is None else out + _fold(b)


def bw_copy_plain(buf: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    return buf + seed.reshape(-1)[0]


def bw_read_async_plain(buf: torch.Tensor, seed: torch.Tensor, *,
                        chunk_rows: int = 32, nbuf: int = 2) -> torch.Tensor:
    """The fold of :func:`bw_read_plain`: the chunks only pace the copies."""
    return bw_read_plain(buf, seed)


def _codes(ja: torch.Tensor, ng: int, nch: int, packed: bool) -> torch.Tensor:
    """The (ng, 8, nch, 8, 128) codes of every chunk row."""
    if not packed:
        return ja.view(ng, 8, nch, 8, LANES)
    p = ja.view(ng, 8, nch // 2, 8, LANES)
    return torch.stack([p & 0xFFFF, (p >> 16) & 0xFFFF], dim=3).view(
        ng, 8, nch, 8, LANES)


def _check_variant(compute: bool, packed: bool):
    if packed and not compute:
        raise ValueError("kernelsim has no packed no-compute variant (the JAX "
                         "probe's reads past the end of its plane)")


def bw_kernelsim_plain(qb: torch.Tensor, x: torch.Tensor, ja: torch.Tensor,
                       as_: torch.Tensor, seed: torch.Tensor, *, k: int,
                       span: int = 4, compute: bool = True,
                       packed: bool = False) -> torch.Tensor:
    """``y[g*8 + sb, lane] = seed[0,0] + sum_{c, r} as * x[q + sel, m]``
    over the chunks c < k/8 and rows r < 8 of row-block sb of group g, as
    ``csrc/bw_probe.cu``'s kernelsim_kernel says (codes with sel outside
    ``[0, span)`` add nothing); ``compute=False``: ``as + f32(ja)`` on the
    unpacked plane."""
    _check_variant(compute, packed)
    ng, nch = qb.shape[0], k // 8
    vals = as_.view(ng, 8, nch, 8, LANES)
    if not compute:
        j = ja.view(ng, 8, nch, 8, LANES).float()
        return (vals + j).sum(dim=(2, 3)).view(ng * 8, LANES) \
            + seed.reshape(-1)[0]
    code = _codes(ja, ng, nch, packed)
    sel, m = code >> 7, code & (LANES - 1)
    q = qb.view(ng, 8, nch, 1, 1).long()
    hit = (sel >= 0) & (sel < span)
    idx = (q + sel.clamp(0, max(span - 1, 0))) * LANES + m
    xv = torch.where(hit, x.reshape(-1)[idx], 0.0)
    return (vals * xv).sum(dim=(2, 3)).view(ng * 8, LANES) \
        + seed.reshape(-1)[0]


# ---------------------------------------------------------------------------
# the kernels' wrappers: CUDA tensors only
# ---------------------------------------------------------------------------


def bw_read(a: torch.Tensor, seed: torch.Tensor,
            b: torch.Tensor | None = None) -> torch.Tensor:
    """The fold of :func:`bw_read_plain` through ``bw_read_<type>`` (one
    stream) or ``bw_read2_f32_i32`` (``a`` f32 values, ``b`` int32
    indices); returns the (8, 128) f32 tile."""
    tensors = {"a": a, "seed": seed}
    types = {"a": tuple(_READ_ENTRY), "seed": (torch.float32,)}
    if b is not None:
        tensors["b"], types["a"], types["b"] = b, (torch.float32,), \
            (torch.int32,)
    _check("bw_read", tensors, types)
    _check_rows("a", a)
    _seed_tile(seed)
    if b is not None and b.shape != a.shape:
        raise ValueError(f"b {tuple(b.shape)} is not the shape of a "
                         f"{tuple(a.shape)}")
    name = "bw_read2_f32_i32" if b is not None else _READ_ENTRY[a.dtype]
    n_vec = a.numel() * a.element_size() // _VEC_BYTES
    nb = _n_blocks(a.device, n_vec, _BLOCKS_PER_SM)
    partial = torch.empty(nb, 8 * LANES, dtype=torch.float32, device=a.device)
    out = torch.empty(8, LANES, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        _call(name, a.data_ptr(), (b if b is not None else a).data_ptr(),
              n_vec, nb, partial.data_ptr(), seed.data_ptr(), out.data_ptr(),
              _stream(a.device))
    bw_read.launches += 1
    return out


def bw_copy(buf: torch.Tensor, seed: torch.Tensor,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """``buf + seed[0, 0]`` through ``bw_copy_f32`` (into ``out`` when
    given)."""
    if out is None:
        out = torch.empty_like(buf)
    _check("bw_copy", {"buf": buf, "seed": seed, "out": out},
           {"buf": (torch.float32,), "seed": (torch.float32,),
            "out": (torch.float32,)})
    _check_rows("buf", buf, 1)
    if out.shape != buf.shape:
        raise ValueError("out is not the shape of buf")
    n_vec = buf.numel() // 4
    nb = _n_blocks(buf.device, n_vec, _BLOCKS_PER_SM)
    with torch.cuda.device(buf.device):
        _call("bw_copy_f32", buf.data_ptr(), seed.data_ptr(), out.data_ptr(),
              n_vec, nb, _stream(buf.device))
    bw_copy.launches += 1
    return out


def _async_blocks_per_sm(device, chunk_rows: int, nbuf: int) -> int:
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        _call("bw_read_async_occupancy", chunk_rows, nbuf, ctypes.byref(n))
    if n.value < 1:
        raise RuntimeError(f"a cp.async block of {chunk_rows} rows x {nbuf} "
                           "stages does not fit an SM")
    return n.value


def bw_read_async(buf: torch.Tensor, seed: torch.Tensor, *,
                  chunk_rows: int = 32, nbuf: int = 2) -> torch.Tensor:
    """The f32 fold through ``bw_read_async_f32``: each block copies chunks
    of ``chunk_rows`` rows (a multiple of 8 dividing nrows) into ``nbuf`` (2
    or 3) shared-memory stages with ``cp.async``."""
    _check("bw_read_async", {"buf": buf, "seed": seed},
           {"buf": (torch.float32,), "seed": (torch.float32,)})
    if chunk_rows < 8 or chunk_rows % 8 or nbuf not in (2, 3):
        raise ValueError(f"chunk_rows must be a multiple of 8 and nbuf 2 or "
                         f"3, got {chunk_rows}, {nbuf}")
    _check_rows("buf", buf, chunk_rows)
    _seed_tile(seed)
    n_chunks = buf.shape[0] // chunk_rows
    sms = torch.cuda.get_device_properties(buf.device).multi_processor_count
    nb = max(1, min(n_chunks, sms * _async_blocks_per_sm(
        buf.device, chunk_rows, nbuf)))
    partial = torch.empty(nb, 8 * LANES, dtype=torch.float32,
                          device=buf.device)
    out = torch.empty(8, LANES, dtype=torch.float32, device=buf.device)
    with torch.cuda.device(buf.device):
        _call("bw_read_async_f32", buf.data_ptr(), n_chunks, chunk_rows, nbuf,
              nb, partial.data_ptr(), seed.data_ptr(), out.data_ptr(),
              _stream(buf.device))
    bw_read_async.launches += 1
    return out


def bw_kernelsim(qb: torch.Tensor, x: torch.Tensor, ja: torch.Tensor,
                 as_: torch.Tensor, seed: torch.Tensor, *, k: int,
                 span: int = 4, compute: bool = True,
                 packed: bool = False) -> torch.Tensor:
    """:func:`bw_kernelsim_plain` through ``bw_kernelsim_*_f32``: qb (ng,
    k) int32, x (xrows, 128) f32, as (ng*k*8, 128) f32, ja (ng*k*8, 128)
    int32 codes or, packed, (ng*k*4, 128) int32 of two 16-bit codes."""
    _check("bw_kernelsim", {"qb": qb, "x": x, "ja": ja, "as_": as_,
                            "seed": seed},
           {"qb": (torch.int32,), "x": (torch.float32,), "ja": (torch.int32,),
            "as_": (torch.float32,), "seed": (torch.float32,)})
    _check_variant(compute, packed)
    ng = qb.shape[0]
    if k < 8 or k % 8 or (packed and k % 16):
        raise ValueError(f"k must be a multiple of 8 (16 when packed), got "
                         f"{k}")
    rows = ng * k * 8
    if (tuple(qb.shape) != (ng, k) or tuple(as_.shape) != (rows, LANES)
            or tuple(ja.shape) != (rows // 2 if packed else rows, LANES)
            or x.dim() != 2 or x.shape[1] != LANES):
        raise ValueError("kernelsim planes do not match the groups and k")
    _seed_tile(seed)
    y = torch.empty(ng * 8, LANES, dtype=torch.float32, device=x.device)
    name = ("bw_kernelsim_" + ("" if compute else "nocompute_")
            + ("packed_" if packed else "") + "f32")
    with torch.cuda.device(x.device):
        _call(name, qb.data_ptr(), x.data_ptr(), ja.data_ptr(),
              as_.data_ptr(), seed.data_ptr(), y.data_ptr(), ng, k, span,
              _stream(x.device))
    bw_kernelsim.launches += 1
    return y


KERNELS = {"bw_read": bw_read, "bw_copy": bw_copy,
           "bw_read_async": bw_read_async, "bw_kernelsim": bw_kernelsim}
for _w in KERNELS.values():
    _w.launches = 0


# ---------------------------------------------------------------------------
# inputs and the probe run
# ---------------------------------------------------------------------------


def small_ints(shape, dtype, *, generator, device, lo=-8, hi=8):
    """Integers in ``[lo, hi)`` of ``dtype``: every sum the probes take of
    them stays below 2^24, where f32 adds integers exactly."""
    return torch.randint(lo, hi, shape, generator=generator, device=device,
                         dtype=torch.int32).to(dtype)


def kernelsim_inputs(ng: int, k: int, xrows: int, span: int, *, generator,
                     device, packed: bool = False):
    """``(qb, x, ja, as_)`` of the miniature: each code gathers lane m of a
    row ``q + sel``, ``sel < span``, of its chunk's window ``q``."""
    nch = k // 8
    ints = dict(generator=generator, device=device)
    qb = torch.randint(0, xrows - span + 1, (ng, 8 * nch), dtype=torch.int32,
                       **ints)
    x = small_ints((xrows, LANES), torch.float32, **ints)
    as_ = small_ints((ng * k * 8, LANES), torch.float32, **ints)
    code = (torch.randint(0, span, (ng * k * 8, LANES), dtype=torch.int32,
                          **ints) << 7) | torch.randint(
        0, LANES, (ng * k * 8, LANES), dtype=torch.int32, **ints)
    if packed:  # chunk pairs (2h, 2h+1) of each row-block share an int32 row
        c = code.view(ng, 8, nch // 2, 2, 8, LANES)
        code = (c[:, :, :, 0] | (c[:, :, :, 1] << 16)).reshape(-1, LANES)
    return qb, x, code.contiguous(), as_


def _best(fn, *args, device, reps=_REPS) -> float:
    return min(device_time_fn(fn, *args, device=device, reps=reps)
               for _ in range(_ROUNDS))


def run_probes(device, *, quick: bool = False, emit=print, log=None,
               seed: int = 0) -> list:
    """Run every probe on CUDA ``device``; ``emit`` gets one JSON line per
    probe and the records are returned."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"the bandwidth probe runs on a CUDA device, not "
                           f"{device}")
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    gen = torch.Generator(device=device).manual_seed(seed)
    ints = dict(generator=gen, device=device)
    records = []

    def report(name, seconds, gbytes, extra=None):
        rec = {"probe": name, "seconds": seconds, "gbytes": gbytes,
               "GBps": gbytes / seconds, **(extra or {})}
        records.append(rec)
        emit(json.dumps(rec))
        log(f"{name:42s} {gbytes / seconds:8.1f} GB/s   "
            f"({seconds * 1e3:.4f} ms for {gbytes:.3f} GB)")

    def probe(name, fn, args, gbytes, extra=None, **kw):
        report(name, _best(lambda: fn(*args, **kw), device=device), gbytes,
               extra)

    nr = (1 << 19) if quick else (1 << 20)  # rows of 128 f32: 256 / 512 MB
    gb = nr * LANES * 4 / 1e9
    buf = small_ints((nr, LANES), torch.float32, **ints)
    seed_t = small_ints((8, LANES), torch.float32, **ints)
    half = buf[: nr // 2]
    ja = small_ints((nr // 2, LANES), torch.int32, **ints)
    out = torch.empty_like(half)

    # PyTorch's own read and copy (≙ xla_sum_read, xla_copy_rw)
    probe("xla_sum_read", lambda b: b.sum(0), (buf,), gb)
    s = seed_t[0, 0]
    probe("xla_copy_rw", lambda b: torch.add(b, s, out=out), (half,), gb)
    probe("bw_read_f32", bw_read, (buf, seed_t), gb)
    probe("bw_read2_f32_i32", bw_read, (half, seed_t, ja), gb)
    probe("bw_copy_f32", bw_copy, (half, seed_t, out), gb)
    del out
    for ch, nb in (ASYNC_CONFIGS[1:2] if quick else ASYNC_CONFIGS):
        probe(f"bw_read_async_ch{ch}_nb{nb}", bw_read_async, (buf, seed_t), gb,
              {"chunk_kb": ch * LANES * 4 / 1024}, chunk_rows=ch, nbuf=nb)

    # the narrow index planes, at full size (512 MB each, 256 MB quick)
    for dtype, tag in ((torch.int32, "i32"), (torch.int16, "i16"),
                       (torch.int8, "i8")):
        nbytes = nr * LANES * 4
        t = small_ints((nbytes // (LANES * dtype.itemsize), LANES), dtype,
                       **ints)
        probe(f"bw_read_{tag}", bw_read, (t, seed_t), nbytes / 1e9)
        del t

    # the miniature SELL kernel: K=64, 240 groups (120 quick), 1 MB x table
    ng, k, xr = (120 if quick else 240), 64, 2048
    nnz = ng * k * 1024
    for name, kw, xrows in [
            ("kernelsim_span4", dict(span=4), xr),
            ("kernelsim_nocompute", dict(span=4, compute=False), xr),
            ("kernelsim_span4_packed16", dict(span=4, packed=True), xr),
            ("kernelsim_span1", dict(span=1), xr),
            ("kernelsim_span8", dict(span=8), xr),
            ("kernelsim_span4_xtab8mb", dict(span=4), 16384)]:
        if quick and name not in ("kernelsim_span4",
                                  "kernelsim_span4_packed16"):
            continue
        qb, x, code, as_ = kernelsim_inputs(ng, k, xrows, kw["span"],
                                            packed=kw.get("packed", False),
                                            **ints)
        probe(name, bw_kernelsim, (qb, x, code, as_, seed_t),
              (as_.numel() * 4 + code.numel() * 4) / 1e9,
              {"gflops_at_100pct": 2 * nnz / 1e9}, k=k, **kw)
        del qb, x, code, as_

    # launch overhead: a tiny read, 100 back to back (device) and per call
    tiny = small_ints((64, LANES), torch.float32, **ints)
    sec = _best(bw_read, tiny, seed_t, device=device, reps=100)
    call = time_fn(bw_read, tiny, seed_t, device=device, reps=100)
    report("launch_overhead", sec, 64 * LANES * 4 / 1e9,
           {"us_per_launch": sec * 1e6, "us_per_call": call * 1e6})
    return records


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("bw_probe: torch.cuda.is_available() is false: the bandwidth "
              "probe needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.load()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    run_probes(dev, quick="--quick" in argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Conjugate gradients' vector work as hand-written CUDA kernels, with the
scalars kept on the card.

The fused path of :func:`..solvers.cg.cg`. The TPU package runs a CG
iteration as one ``lax.while_loop`` body; the port's eager loop runs it as
some 17 PyTorch launches (three dots, two divides, seven elementwise ops, the
stop test's compare), each costing the host more than the card. Here one
iteration is three launches of ``csrc/cg_step.cu`` besides the caller's
matvec, and one flag read:

* :func:`cg_init` after ``ax = A x0``: ``r = b - ax``, ``p = minv * r``, and
  in the workspace ``atol2 = (tol ||b||)^2``, ``rz``, ``rr`` and the stop
  flag ``rr > atol2``;
* :func:`cg_alpha` after ``ap = A p``: ``alpha = rz / p.ap``;
* :func:`cg_step`: ``x += alpha p``, ``r -= alpha ap``, then ``beta``, the
  new ``rz`` and ``rr``, and the flag;
* :func:`cg_dir`: ``p = minv * r + beta p``;
* :func:`cg_unconverged` reads the flag, which the kernels write to a
  pinned host word, as soon as it is written: the work queued behind it
  (the next matvec) runs on. :func:`cg_settle` waits for a flag nobody
  read, so that the word goes back to the allocator with no write pending.

A solve's :class:`CGWork` holds its vectors (x, r, p; z = minv * r is never
stored), ``minv`` in the state's dtype, the workspace (the scalars, a
ticket and the partial sums of the last-block reductions) and the launch
context: the library's entries, the stream and the pointers, taken once a
solve. Sums are in the state's dtype (float32 or float64) in an order fixed
by n, so a repeated solve is bit for bit the same.

Each wrapper launches its kernel, checks the launch and counts it in
``.launches``. The plain versions (``*_plain``) are the eager loop's ops on
the same tensors, the kernels' arguments: they write the scalars into a
workspace's scalar view (:attr:`CGWork.scalars`, or any tensor of five) and
return the stop flag as a 0-d bool tensor.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["CGWork", "cg_init", "cg_alpha", "cg_step", "cg_dir",
           "cg_unconverged", "cg_settle", "cg_init_plain", "cg_alpha_plain",
           "cg_step_plain", "cg_dir_plain"]

# the workspace's scalars, in the order of csrc/cg_step.cu's Work
ALPHA, BETA, RZ, RR, ATOL2 = range(5)
_SCALARS = 5
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_ALIGN = 256  # bytes: where the workspace starts after x
_NO_FLAG = -1000  # cg_flag: the stream drained and the word was not written


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.vdot(a, b).real


class CGWork:
    """One solve's state on the card: ``b``, ``x`` (``x0`` copied in the
    state's dtype, or zeros), ``r``, ``p``, ``minv`` (or None), the
    workspace ``work`` with its scalar view :attr:`scalars` (``ALPHA``,
    ``BETA``, ``RZ``, ``RR``, ``ATOL2``), the stop flag's pinned word,
    whether a launch's flag is still unread (``unread``) and the stream of
    the solve. ``b`` is a contiguous 1-D float32 or float64 CUDA tensor;
    ``x0`` and ``minv`` have its shape and device."""

    def __init__(self, b: torch.Tensor, x0=None, minv=None, tol=1e-6):
        if b.dtype not in _SUFFIX or b.dim() != 1 or not b.is_contiguous():
            raise ValueError(f"b must be a contiguous float32 or float64 "
                             f"vector, got {b.dtype} {tuple(b.shape)}")
        for name, t in (("x0", x0), ("minv", minv)):
            if t is not None and (t.shape != b.shape or t.device != b.device):
                raise ValueError(f"{name} must have b's shape and device, "
                                 f"got {tuple(t.shape)} on {t.device}")
        if b.device.type != "cuda":
            raise ValueError(f"b must be on a CUDA device, got {b.device}")
        dt, dev, es = b.dtype, b.device, b.element_size()
        self.b, self.dtype, self.shape, self.device = b, dt, b.shape, dev
        self.n, self.tol = b.numel(), float(tol)
        self.minv = None if minv is None else minv.to(dt).contiguous()
        lib = _build.load()
        # x and the workspace in one zero-filled allocation
        at = -(-self.n * es // _ALIGN) * _ALIGN
        buf = torch.zeros(at + lib.cg_work_bytes(es), dtype=torch.uint8,
                          device=dev)
        self.x = buf[: self.n * es].view(dt)
        if x0 is not None:
            self.x.copy_(x0)
        self.work = buf[at:]
        self.scalars = self.work[: _SCALARS * es].view(dt)
        self.r, self.p = torch.empty((2, self.n), dtype=dt, device=dev)
        self.flag = torch.empty(1, dtype=torch.int32, pin_memory=True)
        self.flag_word = self.flag.numpy()
        self.flag_host = self.flag.data_ptr()
        self.flag_dev = lib.cg_flag_pointer(self.flag_host)
        if not self.flag_dev:
            raise RuntimeError("the stop flag's pinned word has no device "
                               "address")
        self.unread = False
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        v = _SUFFIX[dt]
        self.entries = (getattr(lib, f"cg_init_{v}"),
                        getattr(lib, f"cg_alpha_{v}"),
                        getattr(lib, f"cg_step_{v}"),
                        getattr(lib, f"cg_dir_{v}"), lib.cg_flag)
        self.ptrs = tuple(None if t is None else t.data_ptr() for t in (
            b, self.x, self.r, self.p, self.minv, self.work))

    def check(self, v: torch.Tensor, name: str) -> None:
        """Raise unless ``v`` is a contiguous vector of the state's dtype,
        shape and device (a matvec's output)."""
        if v.dtype != self.dtype or v.shape != self.shape \
                or not v.is_contiguous() or v.device != self.device:
            raise ValueError(f"{name} must be a contiguous {self.dtype} "
                             f"vector of shape {tuple(self.shape)} on "
                             f"{self.device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")

    def resnorm(self) -> torch.Tensor:
        """``sqrt(rr)``, a 0-d tensor on the state's device."""
        return torch.sqrt(self.scalars[RR])


def _launched(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def cg_init(w: CGWork, ax: torch.Tensor) -> None:
    """``r = b - ax``, ``p = minv * r``; ``atol2``, ``rz``, ``rr`` and the
    stop flag (``csrc/cg_step.cu`` ``cg_init``)."""
    w.check(ax, "ax")
    b, _, r, p, minv, work = w.ptrs
    w.flag_word[0] = -1
    _launched(w.entries[0](b, ax.data_ptr(), minv, r, p, work, w.flag_dev,
                           w.n, w.tol, w.stream), "cg_init")
    w.unread = True
    cg_init.launches += 1


def cg_alpha(w: CGWork, ap: torch.Tensor) -> None:
    """``alpha = rz / p.ap`` (``cg_alpha``)."""
    w.check(ap, "ap")
    _launched(w.entries[1](w.ptrs[3], ap.data_ptr(), w.ptrs[5], w.n,
                           w.stream), "cg_alpha")
    cg_alpha.launches += 1


def cg_step(w: CGWork, ap: torch.Tensor) -> None:
    """``x += alpha p``, ``r -= alpha ap``; ``beta``, ``rz``, ``rr`` and the
    stop flag (``cg_step``)."""
    w.check(ap, "ap")
    _, x, r, p, minv, work = w.ptrs
    w.flag_word[0] = -1
    _launched(w.entries[2](x, r, ap.data_ptr(), p, minv, work, w.flag_dev,
                           w.n, w.stream), "cg_step")
    w.unread = True
    cg_step.launches += 1


def cg_dir(w: CGWork) -> None:
    """``p = minv * r + beta p`` (``cg_dir``)."""
    _, _, r, p, minv, work = w.ptrs
    _launched(w.entries[3](r, minv, p, work, w.n, w.stream), "cg_dir")
    cg_dir.launches += 1


def cg_unconverged(w: CGWork) -> bool:
    """The stop flag of the last :func:`cg_init` or :func:`cg_step`, ``rr >
    atol2``, read on the host as soon as that launch has written it
    (``cg_flag``), whatever is queued behind it."""
    f = w.entries[4](w.flag_host, w.stream)
    w.unread = False  # written, or the stream drained or failed
    if f < 0:
        why = "never written" if f == _NO_FLAG else f"cudaError {-f}"
        raise RuntimeError(f"cg_flag: the stop flag was not read ({why})")
    return f != 0


def cg_settle(w: CGWork) -> None:
    """Wait until the last flag launched has been written, where the host
    has not read it (a solve that ends at ``maxiter`` or on an exception):
    the kernel writes the pinned word behind PyTorch's back, so the word
    must not return to the caching host allocator with that write pending,
    or it lands in the next tensor given the word (the next solve's
    flag)."""
    if w.unread:
        cg_unconverged(w)


for _f in (cg_init, cg_alpha, cg_step, cg_dir):
    _f.launches = 0


def _z(r: torch.Tensor, minv) -> torch.Tensor:
    return r if minv is None else r * minv


def cg_init_plain(b, ax, minv, r, p, s, tol) -> torch.Tensor:
    """:func:`cg_init` in PyTorch ops, those of the eager loop: ``r`` and
    ``p`` written, the scalars into ``s``; returns the stop flag."""
    torch.sub(b, ax, out=r)
    p.copy_(_z(r, minv))
    s[ATOL2] = (tol * torch.sqrt(_dot(b, b))) ** 2
    s[RZ] = _dot(r, p)
    s[RR] = _dot(r, r)
    return s[RR] > s[ATOL2]


def cg_alpha_plain(p, ap, s) -> None:
    """:func:`cg_alpha` in PyTorch ops."""
    torch.div(s[RZ], _dot(p, ap), out=s[ALPHA])


def cg_step_plain(x, r, ap, p, minv, s) -> torch.Tensor:
    """:func:`cg_step` in PyTorch ops; returns the stop flag."""
    x.add_(s[ALPHA] * p)
    r.sub_(s[ALPHA] * ap)
    rz = _dot(r, _z(r, minv))
    torch.div(rz, s[RZ], out=s[BETA])
    s[RZ] = rz
    s[RR] = _dot(r, r)
    return s[RR] > s[ATOL2]


def cg_dir_plain(r, minv, p, s) -> None:
    """:func:`cg_dir` in PyTorch ops."""
    torch.add(_z(r, minv), s[BETA] * p, out=p)

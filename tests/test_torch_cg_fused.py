"""CG's two paths on the CPU (``solvers/cg.py``): the rule that picks the
fused kernels (``ops/cg_step.py``) or the eager loop for each kind of input;
``cg`` on the CPU and with a ``prec`` callable runs the eager loop (the
counter ``solvers.cg.fused_iters`` stays 0); and the fused path's loop
(``_cg_fused``), run here on a CPU stand-in for ``CGWork`` whose launches
are the kernels' plain versions, equals the eager loop bit for bit (the
plain versions are its PyTorch ops in the same order), in as many
iterations and stop tests, with one matvec more a solve that stops on its
test (the product queued ahead of the read), and leaves no flag unread at
``maxiter`` or on an exception. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""

import contextlib
import importlib

import numpy as np
import pytest
import torch

from sparsematrixvectormultiplication_tpu_torch import solvers as SV
from sparsematrixvectormultiplication_tpu_torch.ops import cg_step as CS
from sparsematrixvectormultiplication_tpu_torch.utils import profiling

C = importlib.import_module(
    "sparsematrixvectormultiplication_tpu_torch.solvers.cg")
N = 300


@pytest.fixture(autouse=True)
def clean():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _system(dt):
    """A seeded SPD matrix (G G^T + N I) as a matvec, b and its diagonal's
    inverse, in ``dt``."""
    rng = np.random.default_rng(4)
    g = rng.standard_normal((N, N))
    a = torch.from_numpy(g @ g.T + N * np.eye(N)).to(dt)
    b = torch.from_numpy(rng.standard_normal(N)).to(dt)
    calls = []

    def matvec(v):
        calls.append(1)
        return a @ v

    return matvec, b, 1.0 / torch.diagonal(a), calls


B = torch.ones(4)
# case -> (b, x0, minv, prec, the reason cg gives for the eager loop)
RULE = {
    "cpu_f32": (B, None, None, None, "device"),
    "cpu_f64_minv_x0": (B.double(), B.double(), B.double(), None, "device"),
    "meta": (torch.ones(4, device="meta"), None, None, None, "device"),
    "prec": (B, None, None, lambda r: r, "prec"),
    "f16": (B.half(), None, None, None, "dtype"),
    "int": (torch.ones(4, dtype=torch.int32), None, None, None, "dtype"),
    "complex": (torch.ones(4, dtype=torch.complex64), None, None, None,
                "dtype"),
    "matrix": (torch.ones(4, 1), None, None, None, "layout"),
    "strided": (torch.ones(8)[::2], None, None, None, "layout"),
    "minv_broadcast": (B, None, torch.ones(1), None, "minv"),
    "minv_numpy": (B, None, np.ones(4), None, "minv"),
    "minv_device": (B, None, torch.ones(4, device="meta"), None, "minv"),
    "x0_shape": (B, torch.ones(5), None, None, "x0"),
    "x0_numpy": (B, np.zeros(4), None, None, "x0"),
}


@pytest.mark.parametrize("case", list(RULE))
def test_path_rule_on_each_input_kind(case):
    b, x0, minv, prec, want = RULE[case]
    assert C._eager_reason(b, x0, minv, prec) == want


@pytest.mark.parametrize("kind", ["none", "minv", "prec", "f64_minv"])
def test_cg_on_the_cpu_runs_the_eager_loop(kind, monkeypatch):
    def fused(*args):
        raise AssertionError("the fused path ran on the CPU")

    monkeypatch.setattr(C, "_cg_fused", fused)
    dt = torch.float64 if kind == "f64_minv" else torch.float32
    matvec, b, minv, _ = _system(dt)
    kw = {"prec": lambda r: r * minv} if kind == "prec" else \
        {"minv": minv} if kind != "none" else {}
    profiling.enable()
    x, k, res = SV.cg(matvec, b, tol=1e-5, **kw)
    counted = profiling.counters()
    assert 0 < k < 100 and x.dtype == res.dtype == dt
    assert counted == {"solvers.cg.host_reads": k + 1}


class PlainWork:
    """A CPU stand-in for ``CGWork``: the same state, and launches that run
    the plain versions (:func:`_plain_launches`)."""

    def __init__(self, b, x0=None, minv=None, tol=1e-6):
        dt = self.dtype = b.dtype
        self.b, self.tol = b, tol
        self.x = torch.zeros_like(b) if x0 is None else x0.to(dt)
        self.minv = None if minv is None else minv.to(dt)
        self.r, self.p = torch.empty_like(b), torch.empty_like(b)
        self.scalars = torch.zeros(5, dtype=dt)
        self.flag, self.unread = None, False
        WORKS.append(self)

    def resnorm(self):
        return torch.sqrt(self.scalars[CS.RR])


WORKS = []


def _plain_launches(monkeypatch):
    """Route ``_cg_fused`` to :class:`PlainWork` and the plain versions."""
    def init(w, ax):
        w.flag = CS.cg_init_plain(w.b, ax, w.minv, w.r, w.p, w.scalars,
                                  w.tol)
        w.unread = True

    def step(w, ap):
        w.flag = CS.cg_step_plain(w.x, w.r, ap, w.p, w.minv, w.scalars)
        w.unread = True

    def unconverged(w):
        w.unread = False
        return bool(w.flag)

    WORKS.clear()
    for name, fn in (
            ("CGWork", PlainWork), ("cg_init", init),
            ("cg_alpha", lambda w, ap: CS.cg_alpha_plain(w.p, ap, w.scalars)),
            ("cg_step", step),
            ("cg_dir", lambda w: CS.cg_dir_plain(w.r, w.minv, w.p,
                                                 w.scalars)),
            ("cg_unconverged", unconverged)):
        monkeypatch.setattr(CS, name, fn)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())


# case -> (dtype, cg's keyword arguments but tol)
FUSED = {
    "f32_none": (torch.float32, {}),
    "f32_minv": (torch.float32, {"minv": True}),
    "f64_none": (torch.float64, {}),
    "f64_minv": (torch.float64, {"minv": True}),
    "x0": (torch.float32, {"minv": True, "x0": True}),
    "maxiter": (torch.float32, {"minv": True, "maxiter": 3}),
    "maxiter_0": (torch.float64, {"maxiter": 0}),
    "b_zero": (torch.float32, {"minv": True, "b_zero": True}),
}


@pytest.mark.parametrize("case", list(FUSED))
def test_fused_loop_on_plain_versions_equals_eager(case, monkeypatch):
    dt, spec = FUSED[case]
    matvec, b, minv, calls = _system(dt)
    if spec.get("b_zero"):
        b = torch.zeros_like(b)
    x0 = torch.linspace(-1.0, 1.0, N, dtype=torch.float64) \
        if spec.get("x0") else None  # another dtype: cast once a solve
    minv = minv if spec.get("minv") else None
    maxiter = spec.get("maxiter", 1000)
    tol = 1e-5 if dt == torch.float32 else 1e-10
    x_e, k_e, res_e = C._cg_eager(matvec, b, x0, tol, maxiter, minv, None)
    eager_calls = len(calls)
    _plain_launches(monkeypatch)
    profiling.enable()
    x_f, k_f, res_f = C._cg_fused(matvec, b, x0, tol, maxiter, minv)
    counted = profiling.counters()
    summary = profiling.summary()
    fused_calls = len(calls) - eager_calls
    assert k_f == k_e
    assert {"maxiter": k_f == 3, "maxiter_0": k_f == 0,
            "b_zero": k_f == 0}.get(case, k_f > 3)
    assert torch.equal(x_f, x_e) and torch.equal(res_f, res_e)
    assert x_f.dtype == res_f.dtype == dt and res_f.dim() == 0
    stopped = k_f < maxiter
    assert counted.get("solvers.cg.fused_iters", 0) == k_f
    assert counted.get("solvers.cg.host_reads", 0) == k_f + stopped
    assert eager_calls == k_f + 1 and fused_calls == eager_calls + stopped
    assert summary["solvers.cg.matvec"]["count"] == fused_calls
    assert len(WORKS) == 1 and not WORKS[0].unread


@pytest.mark.parametrize("case", ["maxiter", "maxiter_0", "raise_init",
                                  "raise_loop"])
def test_fused_loop_leaves_no_flag_unread(case, monkeypatch):
    """The last flag launched is read (``cg_settle``) however the solve
    leaves: at ``maxiter`` (0 included), where no stop test read it, and
    where the matvec raises, the exception passing on."""
    matvec, b, minv, calls = _system(torch.float32)
    fail_at = {"raise_init": 1, "raise_loop": 3}.get(case)

    def failing(v):
        if len(calls) + 1 == fail_at:
            raise ArithmeticError("matvec failed")
        return matvec(v)

    _plain_launches(monkeypatch)
    maxiter = 0 if case == "maxiter_0" else 2
    profiling.enable()
    if fail_at:
        with pytest.raises(ArithmeticError, match="matvec failed"):
            C._cg_fused(failing, b, None, 1e-5, maxiter, minv)
    else:
        _, k, _ = C._cg_fused(failing, b, None, 1e-5, maxiter, minv)
        assert k == maxiter
    counted = profiling.counters()
    assert len(WORKS) == 1 and not WORKS[0].unread
    # the settle's read is not a stop test: host_reads counts the tests
    assert counted.get("solvers.cg.host_reads", 0) == \
        {"maxiter": 2, "maxiter_0": 0, "raise_init": 0,
         "raise_loop": 1}[case]


def test_cg_work_checks_its_vectors():
    b = torch.ones(6)
    with pytest.raises(ValueError, match="contiguous float32"):
        CS.CGWork(torch.ones(6, dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous float32"):
        CS.CGWork(torch.ones(12)[::2])
    with pytest.raises(ValueError, match="minv"):
        CS.CGWork(b, minv=torch.ones(3))
    with pytest.raises(ValueError, match="x0"):
        CS.CGWork(b, x0=torch.ones(7))
    with pytest.raises(ValueError, match="CUDA device"):
        CS.CGWork(b, x0=torch.zeros(6), minv=torch.ones(6), tol=1e-3)


@pytest.mark.parametrize("minv", [False, True])
def test_plain_versions_are_the_eager_ops(minv):
    """One init and one iteration of the plain versions against the eager
    loop's ops written out: r, p, x and the scalars bit for bit."""
    matvec, b, mv, _ = _system(torch.float64)
    mv = mv if minv else None
    z = (lambda r: r * mv) if minv else (lambda r: r)
    r, p = torch.empty((2, N), dtype=torch.float64)
    x = torch.zeros(N, dtype=torch.float64)
    s = torch.zeros(5, dtype=torch.float64)
    go = CS.cg_init_plain(b, matvec(x), mv, r, p, s, 1e-8)
    r_e = b - matvec(torch.zeros_like(b))
    p_e = z(r_e)
    assert torch.equal(r, r_e) and torch.equal(p, p_e)
    assert float(s[CS.ATOL2]) == float(
        (1e-8 * torch.sqrt(torch.vdot(b, b))) ** 2)
    rz0 = torch.vdot(r_e, p_e)
    assert float(s[CS.RZ]) == float(rz0)
    assert bool(go) and float(s[CS.RR]) == float(torch.vdot(r_e, r_e))
    ap = matvec(p)
    CS.cg_alpha_plain(p, ap, s)
    alpha = rz0 / torch.vdot(p_e, ap)
    assert float(s[CS.ALPHA]) == float(alpha)
    go = CS.cg_step_plain(x, r, ap, p, mv, s)
    CS.cg_dir_plain(r, mv, p, s)
    x_e = alpha * p_e
    r_e = r_e - alpha * ap
    rz = torch.vdot(r_e, z(r_e))
    beta = rz / rz0
    assert torch.equal(x, x_e) and torch.equal(r, r_e)
    assert float(s[CS.RZ]) == float(rz) and float(s[CS.BETA]) == float(beta)
    assert torch.equal(p, z(r_e) + beta * p_e)
    assert bool(go) == bool(torch.vdot(r_e, r_e) > s[CS.ATOL2])

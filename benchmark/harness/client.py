"""What every client of ``clients/`` shares.

A client issues one kind of request of a traffic mix through the package's
public entries. The harness calls, in order: :meth:`Client.upload` (the
``upload`` span of set-up), :meth:`Client.prepare` (banks of inputs and the
warm-up, ``warmup``), :meth:`Client.step` once a request in the windows,
:meth:`Client.release` once the windows have closed, and
:meth:`Client.check` to compare the sampled answers with the fp64
reference. Each client module defines ``Client``, a subclass of this one.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
X_DTYPES = {"f32": torch.float32, "f64": torch.float64}


def no_span(name: str):
    return contextlib.nullcontext()


def device_bytes(obj) -> int:
    """Bytes of every tensor reachable from ``obj`` (through dataclass
    fields, lists, tuples and dicts), each storage counted once."""
    storages, seen, stack = {}, set(), [obj]
    while stack:
        o = stack.pop()
        if id(o) in seen:
            continue
        seen.add(id(o))
        if isinstance(o, torch.Tensor):
            s = o.untyped_storage()
            storages[(s.device, s.data_ptr())] = s.nbytes()
        elif dataclasses.is_dataclass(o) and not isinstance(o, type):
            stack.extend(getattr(o, f.name) for f in dataclasses.fields(o))
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
        elif isinstance(o, dict):
            stack.extend(o.values())
    return sum(storages.values())


class Client:
    """Base of the clients: holds the package, the mix and the inputs.

    ``precision`` is the mix's, or the control's lower one where the
    harness runs the control in the program's place. ``stats`` collects
    what a client records per request in the measured window (lists by
    name); ``rhs`` is the right-hand sides of a request, for the count of
    operations."""

    rhs = 1

    def __init__(self, port, traffic: dict, device: torch.device,
                 input_seed: int, csr, precision: str | None = None):
        self.port = port
        self.traffic = traffic
        self.device = device
        self.csr = csr
        self.nrows, self.ncols = int(csr.nrows), int(csr.ncols)
        self.precision = precision or traffic["precision"]
        self.bank = int(traffic["bank"])
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(input_seed)
        self.stats = {}
        self.container = None

    def randn(self, shape, dtype) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator,
                           device=self.device, dtype=dtype)

    def warm_up(self):
        for i in range(int(self.traffic["warmup"])):
            self.step(i, no_span)

    def upload(self, sell):
        raise NotImplementedError

    def prepare(self):
        raise NotImplementedError

    def step(self, i: int, span):
        """Issue request ``i``; returns what the sample keeps of it."""
        raise NotImplementedError

    def release(self):
        """Drop the package's state; the inputs stay for the check."""
        self.container = None

    def check(self, matrix, item) -> dict:
        """The compared numbers of one sampled answer ``item``, by name."""
        raise NotImplementedError

    def unfinished(self) -> int:
        """Requests of the measured window that gave no answer."""
        return 0

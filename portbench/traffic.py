"""The one general generator: a traffic mix file -> inputs and calls.

A mix (``traffic/<name>.json``) is data only:

``op``            allreduce | reduce_scatter | allgather | alltoall | bcast
``reduce``        sum | max | min (the reducing ops)
``dtype``         float32 | float64
``elements``      elements of one rank's send buffer (packed elements
                  where ``stride`` > 1)
``stride``        1: contiguous buffers; s > 1: the send buffer is an MPI
                  ``vector(elements, 1, s)`` over a span of s * elements,
                  packed on the card (``datatype.device.device_pack``)
                  before the call, and the result is unpacked
                  (``device_unpack``) into a receive span of the same stride
``buffers``       distinct input buffers a rank
``ops_per_step``  calls a step; op j of step k reads buffer (j + k) % buffers,
                  and the step ends in a synchronize of the rank's card
``nonblocking``   true: ``i<op>_arr`` calls and one wait at the end of the step
``root``          the root of a bcast
``warm_steps``    steps run in set-up, before the window

Inputs are uniform in [-1, 1) and drawn on the rank's device from the
seed, one generator a (rank, buffer); the elements a vector skips hold
``SEND_FILL`` (beyond every value, so a wrong pack shows in any
reduction) and the receive span's gaps ``RECV_FILL``.

Before each op a rank stamps ``STAMPS`` elements of the send buffer,
spread over it, with a row of its stamp table (``Stamps``): row n for
the rank's n-th op, also drawn from the seed.  The buffers are the same
from step to step otherwise, so without the stamps a result left over
from an earlier step of the same buffer would read as correct.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import List, Tuple

import torch

KINDS = ("allreduce", "reduce_scatter", "allgather", "alltoall", "bcast")
REDUCING = ("allreduce", "reduce_scatter")
DTYPES = {"float32": torch.float32, "float64": torch.float64}
SEND_FILL = {"sum": 3.0, "max": 3.0, "min": -3.0, None: 3.0}
RECV_FILL = 7.0
STAMPS = 16            # stamped elements of a send buffer
STAMP_ROWS = 1 << 16   # rows of a rank's stamp table (one an op, cycled)
_now = time.perf_counter_ns


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one stream of the run, from the run's seed."""
    h = hashlib.sha256(":".join(str(int(k)) for k in (seed,) + keys).encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def draw(seed: int, k: int) -> float:
    """A uniform number in [0, 1) for step k of the run ``seed``: the same
    on every rank, so the ranks agree on which step they keep."""
    return sub_seed(seed, 1 << 40, k) / float(1 << 63)


@dataclass(frozen=True)
class Mix:
    name: str
    kind: str
    reduce: str
    dtype: torch.dtype
    elements: int
    stride: int
    buffers: int
    ops_per_step: int
    nonblocking: bool
    root: int
    warm_steps: int

    @classmethod
    def from_dict(cls, name: str, d: dict, scale: int = 1) -> "Mix":
        """``scale`` > 1 divides the element count (CPU rehearsal only)."""
        kind = d["op"]
        if kind not in KINDS:
            raise ValueError(f"mix {name}: op {kind!r} not in {KINDS}")
        red = d.get("reduce")
        if (kind in REDUCING) != (red is not None):
            raise ValueError(f"mix {name}: 'reduce' goes with {REDUCING}")
        nb = bool(d.get("nonblocking", False))
        if nb and kind != "allreduce":
            raise ValueError(f"mix {name}: nonblocking is for allreduce")
        return cls(name, kind, red, DTYPES[d["dtype"]],
                   max(1, int(d["elements"]) // scale), int(d.get("stride", 1)),
                   int(d["buffers"]), int(d["ops_per_step"]), nb,
                   int(d.get("root", 0)), int(d.get("warm_steps", 3)))

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    @property
    def send_bytes(self) -> int:
        """S: one rank's (packed) send buffer in bytes."""
        return self.elements * self.itemsize

    def out_elements(self, nranks: int) -> int:
        c = self.elements
        if self.kind == "reduce_scatter":
            return c // nranks
        if self.kind == "allgather":
            return c * nranks
        return c

    def validate(self, nranks: int) -> None:
        if self.kind in ("reduce_scatter", "alltoall") \
                and self.elements % nranks:
            raise ValueError(f"mix {self.name}: {self.elements} elements do "
                             f"not split over {nranks} ranks")
        if not 0 <= self.root < nranks:
            raise ValueError(f"mix {self.name}: root {self.root} out of range")
        if self.buffers < self.ops_per_step:
            # a step stamps each buffer it uses before its op; a buffer
            # used twice in a step could be stamped under a running op
            raise ValueError(f"mix {self.name}: fewer buffers than ops a step")

    def buffer_of(self, k: int, j: int) -> int:
        """The input buffer that op j of step k reads."""
        return (j + k) % self.buffers


def make_inputs(mix: Mix, seed: int, rank: int, device) -> List[torch.Tensor]:
    """One rank's ``mix.buffers`` send buffers (spans where stride > 1),
    drawn on ``device`` from the seed: a few large calls a buffer."""
    out = []
    for b in range(mix.buffers):
        g = torch.Generator(device=device)
        g.manual_seed(sub_seed(seed, rank, b))
        vals = torch.rand(mix.elements, generator=g, device=device,
                          dtype=mix.dtype)
        vals.mul_(2.0).sub_(1.0)
        if mix.stride == 1:
            out.append(vals)
            continue
        span = torch.full((mix.elements * mix.stride,),
                          SEND_FILL[mix.reduce], dtype=mix.dtype,
                          device=device)
        span[::mix.stride] = vals
        del vals
        out.append(span)
    return out


class Stamps:
    """One rank's stamps: the positions of the send buffer's stamped
    elements (packed elements spread evenly, in the buffer's own
    coordinates) and a table of ``STAMP_ROWS`` rows of values in
    [-1, 1), drawn on the rank's device from the seed."""

    def __init__(self, mix: Mix, seed: int, rank: int, device) -> None:
        n = min(STAMPS, mix.elements)
        packed = torch.arange(n, device=device) * (mix.elements // n)
        self.index = packed * mix.stride
        g = torch.Generator(device=device)
        g.manual_seed(sub_seed(seed, rank, 1 << 41))
        self.table = torch.rand((STAMP_ROWS, n), generator=g, device=device,
                                dtype=mix.dtype).mul_(2.0).sub_(1.0)

    def apply(self, x: torch.Tensor, row: int) -> None:
        """Write row ``row`` (cycled) into the stamped elements of ``x``."""
        x.index_copy_(0, self.index, self.table[row % STAMP_ROWS])


def recv_span(mix: Mix, nranks: int, device) -> torch.Tensor:
    """A receive span for a vector layout, gaps at ``RECV_FILL``."""
    return torch.full((mix.out_elements(nranks) * mix.stride,), RECV_FILL,
                      dtype=mix.dtype, device=device)


class Caller:
    """One rank's calls into the program for a mix: ``op(x, recv)``
    issues one call on send buffer ``x`` (a span for a vector layout,
    unpacked into ``recv``) and returns its output handle; ``wait``
    completes a nonblocking step.  ``spans`` gets (code, t0, t1) for
    the program's calls, the packs and the unpacks."""

    CALL, PACK, UNPACK, SYNC, WAIT = range(5)
    NAMES = ("call", "pack", "unpack", "sync", "wait")

    def __init__(self, mix: Mix, comm, spans: list) -> None:
        from ompi_tpu_torch.op import op as _op
        self.mix, self.comm, self.spans = mix, comm, spans
        self.opobj = {"sum": _op.SUM, "max": _op.MAX, "min": _op.MIN,
                      None: None}[mix.reduce]
        self.pending: List[Tuple[object, object]] = []
        if mix.stride > 1:
            from ompi_tpu_torch.datatype import device as ddev
            from ompi_tpu_torch.datatype import engine as dt
            self.ddev = ddev
            # each rank commits its own pair of vector types, as an MPI
            # process does
            base = {torch.float32: dt.FLOAT,
                    torch.float64: dt.DOUBLE}[mix.dtype]
            self.svec = dt.vector(mix.elements, 1, mix.stride, base).commit()
            self.rvec = dt.vector(mix.out_elements(comm.size), 1, mix.stride,
                                  base).commit()

    def _call(self, x):
        c, m = self.comm, self.mix
        if m.kind == "allreduce":
            if m.nonblocking:
                return c.iallreduce_arr(x, self.opobj)
            return c.allreduce_arr(x, self.opobj)
        if m.kind == "reduce_scatter":
            return c.reduce_scatter_arr(x, self.opobj)
        if m.kind == "allgather":
            return c.allgather_arr(x)
        if m.kind == "alltoall":
            return c.alltoall_arr(x)
        return c.bcast_arr(x, m.root)

    def op(self, x, recv=None):
        now, sp = _now, self.spans
        if self.mix.stride > 1:
            t0 = now()
            x = self.ddev.device_pack(self.svec, 1, x)
            t1 = now()
            sp.append((self.PACK, t0, t1))
        t0 = now()
        out = self._call(x)
        t1 = now()
        sp.append((self.CALL, t0, t1))
        if self.mix.nonblocking:
            self.pending.append((out, recv))
            return None
        return self._deliver(out, recv)

    def _deliver(self, out, recv):
        if self.mix.stride == 1:
            return out
        t0 = _now()
        self.ddev.device_unpack(self.rvec, 1, out, recv)
        self.spans.append((self.UNPACK, t0, _now()))
        return recv

    def wait(self) -> list:
        """Complete a nonblocking step's calls; their outputs in order."""
        if not self.pending:
            return []
        t0 = _now()
        self.pending[-1][0].wait()
        self.spans.append((self.WAIT, t0, _now()))
        outs = [self._deliver(q.result, recv) for q, recv in self.pending]
        self.pending = []
        return outs

"""The plain reference of every traffic mix: plain PyTorch, nothing else.

It imports nothing of the program.  From the send buffers the
benchmark made (one list a rank) it works out what each rank's output
of a collective must hold, in float64 by default, or in a lower
precision for the control.  ``plan`` says, for one rank, which output
elements come from which ranks' send elements; ``expected`` computes
one block of them.

MPI semantics (MPI 3.1, ch. 5): allreduce gives every rank the
reduction of all send buffers; reduce_scatter (block) gives rank r
block r of that reduction; allgather gives every rank the
concatenation of all send buffers; alltoall gives rank r block r of
every rank's buffer, in rank order; bcast gives every rank the root's.
A vector datatype ``vector(count, 1, stride)`` selects every
``stride``-th element of a span (``packed``), and its receive side
writes those positions and no other (``unpack``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

# (output lo, output hi, source ranks, source lo): the output elements
# [lo, hi) are the reduction of those ranks' send elements from
# ``source lo`` on (one source rank: a copy)
Segment = Tuple[int, int, Tuple[int, ...], int]


def packed(buf: torch.Tensor, stride: int) -> torch.Tensor:
    """The elements a vector(count, 1, stride) type selects from a span."""
    return buf[::stride] if stride > 1 else buf


def plan(kind: str, rank: int, nranks: int, count: int,
         root: int = 0) -> List[Segment]:
    """Where rank ``rank``'s output elements come from, for a send
    buffer of ``count`` (packed) elements a rank."""
    every = tuple(range(nranks))
    if kind == "allreduce":
        return [(0, count, every, 0)]
    if kind == "reduce_scatter":
        m = count // nranks
        return [(0, m, every, rank * m)]
    if kind == "allgather":
        return [(s * count, (s + 1) * count, (s,), 0) for s in every]
    if kind == "alltoall":
        m = count // nranks
        return [(s * m, (s + 1) * m, (s,), rank * m) for s in every]
    if kind == "bcast":
        return [(0, count, (root,), 0)]
    raise ValueError(f"no reference for {kind!r}")


def reduce_stack(blocks: Sequence[torch.Tensor], reduce: str,
                 dtype: torch.dtype) -> torch.Tensor:
    """Reduce equal-length blocks elementwise in ``dtype``."""
    st = torch.stack([b.to(dtype) for b in blocks])
    if reduce == "sum":
        return st.sum(0, dtype=dtype)
    if reduce == "max":
        return st.amax(0)
    if reduce == "min":
        return st.amin(0)
    raise ValueError(f"no reference for reduce {reduce!r}")


def expected(sends: Sequence[torch.Tensor], segment: Segment, lo: int,
             hi: int, reduce: str, stride: int, device,
             dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Output elements [lo, hi) of ``segment`` (within its bounds),
    computed in ``dtype`` on ``device`` from the ranks' send buffers."""
    s_lo, _, srcs, src_lo = segment
    a, b = src_lo + lo - s_lo, src_lo + hi - s_lo
    blocks = [packed(sends[s], stride)[a:b].to(device) for s in srcs]
    if len(blocks) == 1:
        return blocks[0].to(dtype)
    return reduce_stack(blocks, reduce, dtype)


def unpack(vals: torch.Tensor, stride: int, fill: float) -> torch.Tensor:
    """A receive span of a vector(len(vals), 1, stride) type holding
    ``vals``, its gaps at ``fill``."""
    if stride == 1:
        return vals.clone()
    span = torch.full((vals.numel() * stride,), fill, dtype=vals.dtype,
                      device=vals.device)
    span[::stride] = vals
    return span


def output(sends: Sequence[torch.Tensor], kind: str, reduce: str, rank: int,
           count: int, stride: int, fill: float, device,
           dtype: torch.dtype = torch.float64, root: int = 0) -> torch.Tensor:
    """Rank ``rank``'s whole output (a receive span for stride > 1),
    in ``dtype``: the control's stand-in for the program's output."""
    segs = plan(kind, rank, len(sends), count, root)
    vals = torch.cat([expected(sends, s, s[0], s[1], reduce, stride, device,
                               dtype) for s in segs])
    return unpack(vals, stride, fill)

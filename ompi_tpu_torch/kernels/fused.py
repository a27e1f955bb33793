"""Wrapper of the fused-batch kernel (csrc/fused.cu), its plain
PyTorch version, and its launch counter.

K3 ``fused_batch`` replaces the reference's fused hbm programs,
``_hbm_slot_outs`` / ``_build_fused_hbm`` (ompi_tpu/coll/fusion.py:335-368)
and the cross-session ``_build_fused_hbm_multi`` (:371-385): one launch
covers every slot of one (op, dtype) group of a flushed batch of small
nonblocking collectives, or of every session's batch that a combined
dispatch carries (``split=False``: one launch, or a ValueError).
A slot folds its N ranks' inputs with the group's op (the templates K1
uses, csrc/reduce_ops.cuh), or, as a bcast entry, copies its root's
input; every rank gets its own output.

Bound by bytes, like K1; at the small sizes a batch holds, the launch
and this wrapper's host work weigh as much as the bytes (see the note
at the top of fused.cu).

A wrapper takes the plain version only for tensors that lie on the
CPU.  A CUDA tensor launches the kernel, or the wrapper raises: there
is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import torch

from . import build
from .stacked import (_DTYPES, _OPS, LaunchCount, _launch, launch_stream,
                      reduce_supported, stacked_reduce_plain)

MAX_PTRS = 1024   # FUSED_MAX_PTRS: 4 sessions x 32 slots x 8 ranks
MAX_SLOTS = 128   # FUSED_MAX_SLOTS
ELEMS = 1024  # elements one block covers (FUSED_ELEMS in fused.cu)

#: one slot of a batch: the N ranks' inputs, and the bcast root (None
#: for a fold with the group's op)
Slot = Tuple[Sequence[torch.Tensor], Optional[int]]


class _Slot(ctypes.Structure):
    _fields_ = [("n", ctypes.c_longlong), ("out_off", ctypes.c_longlong),
                ("first_block", ctypes.c_int), ("root", ctypes.c_int)]


class _FusedArgs(ctypes.Structure):
    _fields_ = [("inp", ctypes.c_void_p * MAX_PTRS),
                ("slot", _Slot * MAX_SLOTS),
                ("out", ctypes.c_void_p), ("out_stride", ctypes.c_longlong),
                ("nslots", ctypes.c_int), ("nranks", ctypes.c_int)]


_lib_lock = threading.Lock()
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("fused")
            lib.ompi_fused_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.ompi_fused_batch.restype = ctypes.c_int
            if (lib.ompi_fused_args_size() != ctypes.sizeof(_FusedArgs)
                    or lib.ompi_fused_max_ptrs() != MAX_PTRS
                    or lib.ompi_fused_max_slots() != MAX_SLOTS
                    or lib.ompi_fused_elems() != ELEMS):
                raise RuntimeError("fused.cu argument layout does not "
                                   "match fused.py")
            _lib = lib
    return _lib


def _check(slots: Sequence[Slot], opname: str) -> None:
    if not slots:
        raise ValueError("fused_batch: no slots")
    x0 = slots[0][0][0]
    n = len(slots[0][0])
    if not 1 <= n <= MAX_PTRS:
        raise ValueError(f"fused_batch: {n} ranks (1 to {MAX_PTRS})")
    if not reduce_supported(x0.dtype, opname):
        raise TypeError(f"fused_batch: {opname} on {x0.dtype} is not a "
                        "pair the kernel takes")
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_batch: unsupported device {x0.device}")
    for xs, root in slots:
        if len(xs) != n:
            raise ValueError("fused_batch: every slot needs one input "
                             "per rank")
        if root is not None and not 0 <= root < n:
            raise ValueError(f"fused_batch: root {root} out of range")
        for x in xs:
            if not isinstance(x, torch.Tensor):
                raise TypeError("fused_batch: inputs must be tensors")
            if x.device != x0.device or x.dtype != x0.dtype \
                    or x.shape != xs[0].shape:
                raise ValueError("fused_batch: a group's inputs share "
                                 "device and dtype, a slot's its shape")
            if not x.is_contiguous():
                raise ValueError("fused_batch: inputs must be contiguous")


def per_launch(n: int) -> int:
    """Slots one launch holds at N = ``n`` ranks."""
    return min(MAX_SLOTS, MAX_PTRS // n)


def fused_batch(slots: Sequence[Slot], opname: str, split: bool = True
                ) -> List[List[torch.Tensor]]:
    """Run one (op, dtype) group of a fused batch.

    ``slots`` holds (xs, root) pairs: xs the N ranks' same-shape inputs
    of one slot (one dtype across the group), root None to fold them
    with ``opname`` or the rank whose input every rank receives.
    Returns outs[slot][rank], each its own tensor of the slot's shape.
    One launch covers the whole group unless it holds more than
    MAX_SLOTS slots or MAX_PTRS input pointers; then one launch per
    part, or, with ``split`` False (a combined dispatch), a ValueError
    on any device."""
    _check(slots, opname)
    x0 = slots[0][0][0]
    n = len(slots[0][0])
    per = per_launch(n)
    if not split and len(slots) > per:
        raise ValueError(
            f"fused_batch: {len(slots)} slots of {n} ranks exceed one "
            f"launch ({per} slots: MAX_SLOTS {MAX_SLOTS}, MAX_PTRS "
            f"{MAX_PTRS})")
    if x0.device.type == "cpu":
        return fused_batch_plain(slots, opname)
    sizes = [xs[0].numel() for xs, _ in slots]
    offs = [0] * len(slots)
    for i in range(1, len(slots)):
        offs[i] = offs[i - 1] + sizes[i - 1]
    total = offs[-1] + sizes[-1]
    buf = torch.empty(n * total, dtype=x0.dtype, device=x0.device)
    outs = [[buf[r * total + o:r * total + o + m].view(xs[0].shape)
             for r in range(n)]
            for (xs, _), o, m in zip(slots, offs, sizes)]
    lib = _library()
    with torch.cuda.device(x0.device):
        stream = launch_stream(x0.device)
        for lo in range(0, len(slots), per):
            a = _FusedArgs()
            nblocks = 0
            for j, s in enumerate(range(lo, min(lo + per, len(slots)))):
                xs, root = slots[s]
                for r, x in enumerate(xs):
                    a.inp[j * n + r] = x.data_ptr()
                rec = a.slot[j]
                rec.n, rec.out_off = sizes[s], offs[s]
                rec.first_block = nblocks
                rec.root = -1 if root is None else root
                nblocks += -(-sizes[s] // ELEMS)
                a.nslots = j + 1
            if nblocks == 0:
                continue
            a.out = buf.data_ptr()
            a.out_stride = total
            a.nranks = n
            _launch(lib.ompi_fused_batch(
                ctypes.byref(a), _DTYPES[x0.dtype], _OPS[opname], nblocks,
                stream), "fused_batch")
            fused_batch.launches.add()
    return outs


fused_batch.launches = LaunchCount()


def fused_batch_plain(slots: Sequence[Slot], opname: str
                      ) -> List[List[torch.Tensor]]:
    """Plain PyTorch version of K3, on any device: each fold slot is
    K1's plain left fold, each bcast entry a clone of its root's
    input."""
    out = []
    for xs, root in slots:
        if root is None:
            out.append(stacked_reduce_plain(xs, opname))
        else:
            out.append([xs[root].clone() for _ in xs])
    return out

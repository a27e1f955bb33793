"""Wrapper of the integrity digest kernel (csrc/digest.cu), its plain
PyTorch version, and its launch counter.

K11 ``digest`` replaces the reference's host reduction,
``fold`` / ``digest`` (ompi_tpu/obs/integrity.py:221-247): one 8-byte
checksum an operand, for a whole table of operands on one device in
one launch, so that only the results cross to the host.  The folds
(``F_INTSUM``, ``F_FSUM``, ``F_MAX``, ``F_MIN``, the reference's
codes) and the value each gives are in the note at the top of
digest.cu; ``decode`` turns a result's 8 bytes into that value.

The kernel is deterministic, and its bits depend on an operand's
values and length, never on its address (the same values at any
element offset give the same bits): the integrity plane compares a
re-digest of an output or a view with a claim taken over a fresh clone
at zero tolerance.  ``_plan`` gives what the wrapper works out for one
operand: its blocks, a function of its length and width alone (the
fold order follows from them), and its load mode, the one thing its
address chooses (16-byte words where the base is 16-byte aligned, else
element by element: the same elements in the same order either way).
The counters that elect each operand's finishing block sit in the
library's static device array, one row a slot; ``_slot`` gives each
(device, stream) a row of its own, so no launch needs a memset.  The
plain version sums floats in PyTorch's order, not the kernel's, so the
two agree exactly for INTSUM, MAX and MIN and within float64 rounding
for FSUM.

A wrapper takes the plain version only for tensors that lie on the
CPU.  A CUDA tensor launches the kernel, or the wrapper raises: there
is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Dict, List, Sequence, Tuple

import torch

from . import build
from .stacked import _DTYPES, LaunchCount, _launch, launch_stream

F_INTSUM, F_FSUM, F_MAX, F_MIN = 1, 2, 3, 4

MAX_OPS = 96
THREADS = 256
U = 4            # digest.cu DIGEST_U: 16-byte groups a thread a round
MAX_BLOCKS = 1024
SLOTS = 256      # streams a device

_INTS = (torch.int8, torch.uint8, torch.int16, torch.uint16, torch.int32,
         torch.uint32, torch.int64, torch.uint64)
_FLOATS = (torch.float16, torch.float32, torch.float64)
_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)
# same-width signed views: torch has no arithmetic on uint16 / uint32
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_M64 = (1 << 64) - 1


class _DigestOp(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("first_block", ctypes.c_int), ("nblocks", ctypes.c_int),
                ("dtype", ctypes.c_int), ("code", ctypes.c_int),
                ("vec", ctypes.c_int)]


class _DigestArgs(ctypes.Structure):
    _fields_ = [("op", _DigestOp * MAX_OPS), ("partial", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("nops", ctypes.c_int),
                ("slot", ctypes.c_int)]


_lib_lock = threading.Lock()
_lib = None
_slots: Dict[Tuple[int, int], int] = {}  # (device, stream) -> slot


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("digest")
            lib.ompi_digest.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p]
            lib.ompi_digest.restype = ctypes.c_int
            if (lib.ompi_digest_args_size() != ctypes.sizeof(_DigestArgs)
                    or lib.ompi_digest_max_ops() != MAX_OPS
                    or lib.ompi_digest_threads() != THREADS
                    or lib.ompi_digest_u() != U
                    or lib.ompi_digest_max_blocks() != MAX_BLOCKS
                    or lib.ompi_digest_slots() != SLOTS):
                raise RuntimeError("digest.cu argument layout does not "
                                   "match digest.py")
            _lib = lib
    return _lib


def supported(dtype: torch.dtype, code: int) -> bool:
    """Does K11 take this (dtype, fold) pair?  INTSUM on the integers,
    FSUM on float16/32/64, MAX and MIN on both."""
    if code == F_INTSUM:
        return dtype in _INTS
    if code == F_FSUM:
        return dtype in _FLOATS
    return code in (F_MAX, F_MIN) and (dtype in _INTS or dtype in _FLOATS)


def blocks(n: int, isz: int) -> int:
    """Blocks K11 gives an operand of n elements of isz bytes: one a
    span of THREADS * U 16-byte groups, at most MAX_BLOCKS; a function
    of the length and the width alone (digest.cu digest_blocks)."""
    groups = -(-n * isz // 16)
    return max(1, min(MAX_BLOCKS, -(-groups // (THREADS * U))))


def _plan(addr: int, n: int, isz: int) -> Tuple[int, int, int]:
    """What the wrapper plans for one operand at integer address
    ``addr``: (blocks, groups of 16 // isz elements, load mode).  Only
    the load mode (1: 16-byte words, ``addr`` 16-byte aligned; 0:
    element by element) depends on the address; the blocks and groups,
    which fix the fold order, do not."""
    return blocks(n, isz), -(-n * isz // 16), int(addr % 16 == 0)


def _slot(dev: torch.device, stream: int) -> int:
    """The row of the library's done counters that launches on
    ``stream`` of ``dev`` use: one a (device, stream), never shared, so
    that digests on concurrent streams never race on a counter."""
    key = (dev.index, stream)
    slot = _slots.get(key)
    if slot is None:
        with _lib_lock:
            slot = _slots.get(key)
            if slot is None:
                slot = sum(1 for d, _ in _slots if d == dev.index)
                if slot >= SLOTS:
                    raise RuntimeError(f"digest: more than {SLOTS} streams "
                                       f"on {dev}")
                _slots[key] = slot
    return slot


def _check(xs: Sequence[torch.Tensor], codes: Sequence[int]) -> None:
    if not xs or len(xs) != len(codes):
        raise ValueError("digest: one fold code an operand, at least one "
                         "operand")
    dev = xs[0].device
    for x, code in zip(xs, codes):
        if not isinstance(x, torch.Tensor):
            raise TypeError("digest: operands must be tensors")
        if x.device != dev:
            raise ValueError("digest: a table's operands share one device")
        if not x.is_contiguous():
            raise ValueError("digest: operands must be contiguous")
        if not supported(x.dtype, code):
            raise TypeError(f"digest: fold {code} on {x.dtype} is not a "
                            "pair the kernel takes")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"digest: unsupported device {dev}")


def digest(xs: Sequence[torch.Tensor], codes: Sequence[int]
           ) -> torch.Tensor:
    """K11: the digest of every operand ``xs[i]`` under fold
    ``codes[i]``, as the 8 raw bytes of each result in an int64 tensor
    of len(xs) on the operands' device (``decode`` reads one).  ONE
    launch on that device's current stream for up to MAX_OPS operands
    (one launch a part beyond), whatever their lengths; no host
    synchronisation."""
    _check(xs, codes)
    dev = xs[0].device
    if dev.type == "cpu":
        return digest_plain(xs, codes)
    out = torch.empty(len(xs), dtype=torch.int64, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = launch_stream(dev)
        slot = _slot(dev, stream)
        for lo in range(0, len(xs), MAX_OPS):
            part = range(lo, min(lo + MAX_OPS, len(xs)))
            a = _DigestArgs()
            nblocks = 0
            for j, i in enumerate(part):
                x = xs[i]
                rec = a.op[j]
                addr = x.data_ptr() if x.numel() else 0
                rec.ptr = addr or None
                rec.n = x.numel()
                rec.first_block = nblocks
                rec.nblocks, _, rec.vec = _plan(addr, x.numel(),
                                                x.element_size())
                rec.dtype = _DTYPES[x.dtype]
                rec.code = codes[i]
                nblocks += rec.nblocks
            a.nops = len(part)
            a.slot = slot
            # one partial a block; each is written before it is read
            partial = torch.empty(nblocks, dtype=torch.int64, device=dev)
            a.partial = partial.data_ptr()
            a.out = out.data_ptr() + 8 * lo
            _launch(lib.ompi_digest(ctypes.byref(a), nblocks, stream),
                    "digest")
            digest.launches.add()
    return out


digest.launches = LaunchCount()


def _plain_one(x: torch.Tensor, code: int) -> torch.Tensor:
    if x.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=x.device)
    x = x.reshape(-1)
    isz = x.element_size()
    if code == F_INTSUM:  # unsigned of the width, wrapping in int64
        w = x.view(_SIGNED[isz]).to(torch.int64)
        if isz < 8:
            w = w & ((1 << (8 * isz)) - 1)
        return w.sum()
    if x.dtype.is_floating_point:
        v = x.to(torch.float64).sum() if code == F_FSUM else \
            (x.amax() if code == F_MAX else x.amin()).to(torch.float64)
        return v.reshape(1).view(torch.int64)[0]
    if x.dtype == torch.uint64:  # order the int64 view with its sign flipped
        w = x.view(torch.int64) ^ (-(1 << 63))
        v = w.amax() if code == F_MAX else w.amin()
        return v ^ (-(1 << 63))
    w = x.view(_SIGNED[isz]).to(torch.int64)
    if x.dtype in _UNSIGNED:
        w = w & ((1 << (8 * isz)) - 1)
    return w.amax() if code == F_MAX else w.amin()


def digest_plain(xs: Sequence[torch.Tensor], codes: Sequence[int]
                 ) -> torch.Tensor:
    """Plain PyTorch version of K11, on any device: the same 8-byte
    results, one operand at a time (INTSUM wraps in int64)."""
    _check(xs, codes)
    return torch.stack([_plain_one(x, c) for x, c in zip(xs, codes)])


def decode(bits: int, code: int, dtype: torch.dtype):
    """The value one result's 8 bytes hold (``bits`` as an int64 reads
    them): a Python int for INTSUM and integer MAX/MIN, a float for
    FSUM and float MAX/MIN — the type ``integrity.digest`` returns."""
    u = bits & _M64
    if code == F_INTSUM:
        return u
    if code == F_FSUM or dtype.is_floating_point:
        return struct.unpack("<d", u.to_bytes(8, "little"))[0]
    if dtype in _UNSIGNED:
        return u
    return u - (1 << 64) if u >> 63 else u


def values(raw: List[int], codes: Sequence[int],
           dtypes: Sequence[torch.dtype]) -> list:
    """``decode`` over a table's results (``raw``: ``tolist()`` of what
    ``digest`` returned, on the host)."""
    return [decode(b, c, d) for b, c, d in zip(raw, codes, dtypes)]

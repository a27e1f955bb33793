"""Wrappers of the one-sided RMA kernels (csrc/rma.cu), their plain
PyTorch versions, and their launch counters.

K8 ``rma_copy`` replaces the reference's put, get and local-slice
programs (ompi_tpu/osc/device.py:181 ``_build_put``, :203
``_build_get``, :286 ``_build_lslice``): raw bytes from one buffer
into another at byte offsets, the source or the destination possibly
on a peer card.  ``_copy_plan`` splits a copy on the destination's
alignment (head bytes, whole 16-byte destination words, tail bytes)
and gives the source's shift against those words, so that every store
of the body is an aligned 16-byte word at any byte skew (rma.cu).  K9 ``rma_acc`` replaces ``_build_acc`` (:220), plain
and fetch: ``w[i] = op(s[i], w[i])`` over the wire dtypes, the pre-op
bytes written to ``old`` first when one is given.  K10 ``rma_cas``
replaces ``_build_cas`` (:259): one element swapped when it equals
``compare`` by value, the old value written to ``old``.

Semantics the kernels and the plain versions share, and which give the
bytes numpy gives the reference's host path (``Op.reduce``): MAX and
MIN return the first operand when it is greater (less) or NaN, else
the second (so signed zeros and NaN payloads come out as numpy's);
bool is one byte read as its 0/1 value; REPLACE and NO_OP move bytes
as they are.  Complex PROD rounds each product and sum on its own
(reduce_ops.cuh); a numpy built with FMA fuses one product into the
sum (a pinned divergence, see the tests).

A wrapper takes the plain version only for tensors that lie on the
CPU.  A CUDA tensor launches the kernel, or the wrapper raises: there
is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import build
from .stacked import (_DTYPES, _OPS, LaunchCount, _launch, fold_plain,
                      launch_stream, reduce_supported, require_peer)

#: the window wire dtypes (ompi_tpu/osc/window.py:62 _WIRE_DTYPES)
WIRE_DTYPES = (torch.uint8, torch.int8, torch.int16, torch.uint16,
               torch.int32, torch.uint32, torch.int64, torch.uint64,
               torch.float32, torch.float64, torch.complex64,
               torch.complex128, torch.bool)
ACC_OPS = dict(_OPS, MPI_REPLACE=10, MPI_NO_OP=11)
_MOVE = ("MPI_REPLACE", "MPI_NO_OP")
# element-equal views for K10's plain version: torch compares these
# dtypes bit for bit, which for integers is equality of value
_BITS = {torch.uint16: torch.int16, torch.uint32: torch.int32,
         torch.uint64: torch.int64}

_lib_lock = threading.Lock()
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("rma")
            lib.ompi_rma_copy.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_void_p]
            lib.ompi_rma_copy.restype = ctypes.c_int
            lib.ompi_rma_acc.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
            lib.ompi_rma_acc.restype = ctypes.c_int
            lib.ompi_rma_cas.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            lib.ompi_rma_cas.restype = ctypes.c_int
            _lib = lib
    return _lib


def acc_supported(dtype: torch.dtype, opname: str) -> bool:
    """Does K9 take this (dtype, op) pair?  The wire dtypes, with the
    pairs Op.valid_for admits (K1's table) plus REPLACE and NO_OP on
    every one of them."""
    if dtype not in WIRE_DTYPES:
        return False
    return opname in _MOVE or reduce_supported(dtype, opname)


def _bytes_of(t: torch.Tensor, what: str) -> torch.Tensor:
    if not isinstance(t, torch.Tensor) or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous tensor")
    return t.reshape(-1).view(torch.uint8)


def _span(t: torch.Tensor, off: int, n: int, what: str) -> None:
    if off < 0 or off + n > t.numel():
        raise ValueError(f"{what}: bytes [{off}, {off + n}) outside the "
                         f"{t.numel()}-byte buffer")


def _where(tensors, what: str) -> str:
    """"cpu" when every tensor lies on the CPU, "cuda" when every one
    lies on a card; raises on a mix or any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"}:
        return "cuda"
    raise ValueError(f"{what}: tensors on {sorted(kinds)} (all on the CPU, "
                     "or all on cards)")


# ---------------------------------------------------------------------------
# K8: rma_copy
# ---------------------------------------------------------------------------

def _copy_plan(dst_addr: int, src_addr: int, n: int):
    """K8's plan of an n-byte copy, from integer addresses: (head,
    words, tail, shift).  ``head``: the bytes before dst reaches a
    16-byte boundary (all n when it never does); the body: ``words``
    whole 16-byte destination words; ``tail``: the rest, under 16;
    ``shift``: (src_addr + head) mod 16, where the body's source bytes
    start inside their first aligned 16-byte source word."""
    head = min(n, -dst_addr % 16)
    words = (n - head) // 16
    return head, words, n - head - 16 * words, (src_addr + head) % 16


def rma_copy(dst: torch.Tensor, dst_off: int, src: torch.Tensor,
             src_off: int, n: int, device: Optional[torch.device] = None
             ) -> torch.Tensor:
    """K8: ``dst[dst_off:dst_off+n] = src[src_off:src_off+n]`` on the
    raw bytes of two contiguous tensors that do not overlap, in ONE
    launch on ``device``'s current stream (default: dst's device); the
    other buffer may lie on a peer card.  Any byte offsets, planned by
    ``_copy_plan``.  Returns ``dst``."""
    db, sb = _bytes_of(dst, "rma_copy dst"), _bytes_of(src, "rma_copy src")
    _span(db, dst_off, n, "rma_copy dst")
    _span(sb, src_off, n, "rma_copy src")
    if _where([db, sb], "rma_copy") == "cpu":
        return rma_copy_plain(dst, dst_off, src, src_off, n)
    if n == 0:
        return dst
    dev = dst.device if device is None else device
    require_peer(dev, db.device)
    require_peer(dev, sb.device)
    d_addr, s_addr = db.data_ptr() + dst_off, sb.data_ptr() + src_off
    head, words, tail, shift = _copy_plan(d_addr, s_addr, n)
    lib = _library()
    with torch.cuda.device(dev):
        stream = launch_stream(dev)
        _launch(lib.ompi_rma_copy(d_addr, s_addr, n, head, words, tail,
                                  shift, stream), "rma_copy")
        rma_copy.launches.add()
    return dst


rma_copy.launches = LaunchCount()


def rma_copy_plain(dst: torch.Tensor, dst_off: int, src: torch.Tensor,
                   src_off: int, n: int) -> torch.Tensor:
    """Plain PyTorch version of K8, on any device: one ``copy_``."""
    db, sb = _bytes_of(dst, "dst"), _bytes_of(src, "src")
    db[dst_off:dst_off + n].copy_(sb[src_off:src_off + n])
    return dst


# ---------------------------------------------------------------------------
# K9: rma_acc
# ---------------------------------------------------------------------------

def _check_acc(w, start, s, opname, old):
    if s.dtype not in WIRE_DTYPES:
        raise TypeError(f"rma_acc: {s.dtype} is not a window wire dtype")
    if not acc_supported(s.dtype, opname):
        raise TypeError(f"rma_acc: {opname} on {s.dtype} is not a pair "
                        "the kernel takes")
    wb, sb = _bytes_of(w, "rma_acc window"), _bytes_of(s, "rma_acc origin")
    _span(wb, start, sb.numel(), "rma_acc window")
    ob = None
    if old is not None:
        ob = _bytes_of(old, "rma_acc old")
        if ob.numel() != sb.numel():
            raise ValueError(f"rma_acc: old holds {ob.numel()} bytes, the "
                             f"origin {sb.numel()}")
    return wb, sb, ob


def _mode(addr: int, body: int, isz: int) -> int:
    """An operand's mode at the body's start ``addr + body``: 2 that
    address 16-byte aligned, 1 element-aligned, 0 neither."""
    return 2 if (addr + body) % 16 == 0 else 1 if addr % isz == 0 else 0


def _acc_split(w_addr: int, s_addr: int, old_addr: Optional[int],
               count: int, isz: int):
    """K9's split of ``count`` elements of ``isz`` bytes, from integer
    addresses: (head, vectors, tail, w mode, s mode, old mode or None).
    ``head``: the elements before w reaches a 16-byte boundary (none
    when w is not element-aligned: then the whole body goes byte by
    byte for w); the body: vectors of 16 // isz elements; ``tail``: the
    rest.  Each mode (``_mode``) is the operand's own at the body's
    start, so that each is widened on its own; w's is 2 or 0 (its body
    starts on a 16-byte boundary unless it is not element-aligned)."""
    v = 16 // isz
    head = 0 if w_addr % isz else min(count, -w_addr % 16 // isz)
    nvec = (count - head) // v
    body = head * isz
    return (head, nvec, count - head - nvec * v, 0 if w_addr % isz else 2,
            _mode(s_addr, body, isz),
            None if old_addr is None else _mode(old_addr, body, isz))


def rma_acc(w: torch.Tensor, start: int, s: torch.Tensor, opname: str,
            old: Optional[torch.Tensor] = None) -> None:
    """K9: for the s.numel() elements of s's dtype at byte ``start`` of
    the window buffer ``w``, ``w[i] = op(s[i], w[i])``; with ``old``,
    the pre-op bytes are written there first.  ONE launch on w's
    device's current stream (s and old may lie on peer cards); any
    byte offset, split by ``_acc_split``.  In place."""
    wb, sb, ob = _check_acc(w, start, s, opname, old)
    ts = [wb, sb] + ([ob] if ob is not None else [])
    if _where(ts, "rma_acc") == "cpu":
        rma_acc_plain(w, start, s, opname, old)
        return
    if s.numel() == 0:
        return
    dev = w.device
    for t in ts[1:]:
        require_peer(dev, t.device)
    w_addr, s_addr = wb.data_ptr() + start, sb.data_ptr()
    o_addr = ob.data_ptr() if ob is not None else None
    n = s.numel()
    head, nvec, tail, wm, sm, om = _acc_split(w_addr, s_addr, o_addr, n,
                                              s.element_size())
    lib = _library()
    with torch.cuda.device(dev):
        stream = launch_stream(dev)
        _launch(lib.ompi_rma_acc(
            w_addr, s_addr, o_addr, n, head, tail, wm, sm, om or 0,
            _DTYPES[s.dtype], ACC_OPS[opname], stream), "rma_acc")
        rma_acc.launches.add()


rma_acc.launches = LaunchCount()


def acc_values(s: torch.Tensor, w: torch.Tensor, opname: str
               ) -> torch.Tensor:
    """op(s, w) elementwise with K9's semantics, as a new tensor of
    the operands' dtype (both 1-D, one dtype, one device)."""
    if opname == "MPI_REPLACE":
        return s.clone()
    if opname == "MPI_NO_OP":
        return w.clone()
    if s.dtype == torch.bool:  # read each byte as its 0/1 value
        s, w = s.view(torch.uint8) != 0, w.view(torch.uint8) != 0
    if s.dtype.is_floating_point and opname in ("MPI_MAX", "MPI_MIN"):
        first = (s > w) if opname == "MPI_MAX" else (s < w)
        return torch.where(first | torch.isnan(s), s, w)
    return fold_plain([s, w], opname)


def rma_acc_plain(w: torch.Tensor, start: int, s: torch.Tensor, opname: str,
                  old: Optional[torch.Tensor] = None) -> None:
    """Plain PyTorch version of K9, on any device, in place."""
    wb, sb, ob = _check_acc(w, start, s, opname, old)
    span = wb[start:start + sb.numel()]
    cur = span.clone()  # an aligned copy, so any byte offset views
    if ob is not None:
        ob.copy_(cur)
    if opname == "MPI_NO_OP":
        return
    span.copy_(acc_values(sb.view(s.dtype), cur.view(s.dtype),
                          opname).view(torch.uint8))


# ---------------------------------------------------------------------------
# K10: rma_cas
# ---------------------------------------------------------------------------

def _check_cas(w, start, compare, new, old):
    dt = old.dtype
    if dt not in WIRE_DTYPES:
        raise TypeError(f"rma_cas: {dt} is not a window wire dtype")
    for t, what in ((compare, "compare"), (new, "new"), (old, "old")):
        if not isinstance(t, torch.Tensor) or t.dtype != dt \
                or t.numel() != 1 or not t.is_contiguous():
            raise ValueError(f"rma_cas: {what} must be one contiguous "
                             f"element of {dt}")
    wb = _bytes_of(w, "rma_cas window")
    _span(wb, start, old.element_size(), "rma_cas window")
    return wb


def rma_cas(w: torch.Tensor, start: int, compare: torch.Tensor,
            new: torch.Tensor, old: torch.Tensor) -> None:
    """K10: the element of old's dtype at byte ``start`` of ``w`` is
    swapped for ``new`` when it equals ``compare`` by value; its old
    value goes to ``old``.  ONE launch (one thread) on w's device's
    current stream; compare, new and old may lie on peer cards."""
    wb = _check_cas(w, start, compare, new, old)
    ts = [wb, compare, new, old]
    if _where(ts, "rma_cas") == "cpu":
        rma_cas_plain(w, start, compare, new, old)
        return
    dev = w.device
    for t in ts[1:]:
        require_peer(dev, t.device)
    lib = _library()
    with torch.cuda.device(dev):
        stream = launch_stream(dev)
        _launch(lib.ompi_rma_cas(wb.data_ptr() + start, compare.data_ptr(),
                                 new.data_ptr(), old.data_ptr(),
                                 _DTYPES[old.dtype], stream), "rma_cas")
        rma_cas.launches.add()


rma_cas.launches = LaunchCount()


def rma_cas_plain(w: torch.Tensor, start: int, compare: torch.Tensor,
                  new: torch.Tensor, old: torch.Tensor) -> None:
    """Plain PyTorch version of K10, on any device, in place (no host
    synchronisation: the swap is a select on the bytes)."""
    wb = _check_cas(w, start, compare, new, old)
    dt = old.dtype
    span = wb[start:start + old.element_size()]
    cur = span.clone()
    a, c = cur.view(dt), compare.reshape(-1)
    if dt == torch.bool:
        hit = (a.view(torch.uint8) != 0) == (c.view(torch.uint8) != 0)
    else:
        bits = _BITS.get(dt)
        hit = a.view(bits) == c.view(bits) if bits is not None else a == c
    old.reshape(-1).view(torch.uint8).copy_(cur)
    span.copy_(torch.where(hit, new.reshape(-1).view(torch.uint8), cur))

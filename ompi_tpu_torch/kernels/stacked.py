"""Wrappers of the stacked-collective kernels (csrc/stacked.cu), their
plain PyTorch versions, and their launch counters.

K1 ``stacked_reduce`` replaces the reference's stacked reduction
programs, ``HbmCollModule._build_stacked("allreduce", op)`` and
``("reduce_scatter", op)`` (ompi_tpu/coll/device.py:1389-1417; the
fold table ``_fold_fn`` at :136 and op/op.py:153 ``jax_binary``).
K2 ``stacked_copy`` replaces their data-movement halves,
``_build_stacked("alltoall")`` (:1421-1431) and ``("allgather")``
(:1418).  K2's peer mode, ``peer_copy``, serves the mesh tier: one
launch per destination device, reading sources that may lie on other
cards (the all_gather / all_to_all halves of ``_build_mesh_collective``,
:997, and the segbcast / sega2a schedules of coll/pipeline.py:192).

Both are bound by bytes (see the note at the top of stacked.cu): one
read of every input and one write of every output, 16 bytes a thread
where the pointers allow, is all the simple design does about it.

A wrapper takes the plain version only for tensors that lie on the
CPU.  A CUDA tensor launches the kernel, or the wrapper raises: there
is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import List, Sequence

import torch

from ompi_tpu_torch.op.op import PREDEFINED, torch_binary
from . import build

MAX_PTRS = 128

_DTYPES = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2,
           torch.float64: 3, torch.int8: 4, torch.uint8: 5,
           torch.int32: 6, torch.int64: 7, torch.bool: 8, torch.int16: 9,
           torch.uint16: 10, torch.uint32: 11, torch.uint64: 12,
           torch.complex64: 13, torch.complex128: 14}
_OPS = {"MPI_SUM": 0, "MPI_PROD": 1, "MPI_MAX": 2, "MPI_MIN": 3,
        "MPI_LAND": 4, "MPI_BAND": 5, "MPI_LOR": 6, "MPI_BOR": 7,
        "MPI_LXOR": 8, "MPI_BXOR": 9}
_FLOAT_OPS = ("MPI_SUM", "MPI_PROD", "MPI_MAX", "MPI_MIN")
_COMPLEX_OPS = ("MPI_SUM", "MPI_PROD")
_LOGICAL = ("MPI_LAND", "MPI_LOR", "MPI_LXOR")
_HALF = (torch.float16, torch.bfloat16)
# torch has no arithmetic on these: the plain version folds them in
# int64 and keeps the low bits
_NARROW_UNSIGNED = {torch.uint16: 0xFFFF, torch.uint32: 0xFFFFFFFF}
_SIGN = -(1 << 63)


class LaunchCount:
    """How many times a wrapper launched its kernel (plain-version
    calls on CPU tensors are not launches and do not count)."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


def reduce_supported(dtype: torch.dtype, opname: str) -> bool:
    """Does K1 take this (dtype, op) pair?  Every pair of its dtype
    table that Op.valid_for admits: floats take SUM/PROD/MAX/MIN,
    complex SUM/PROD, integers and bool all ten ops."""
    if dtype not in _DTYPES or opname not in _OPS:
        return False
    if dtype.is_complex:
        return opname in _COMPLEX_OPS
    if dtype.is_floating_point:
        return opname in _FLOAT_OPS
    return True


class _ReduceArgs(ctypes.Structure):
    _fields_ = [("inp", ctypes.c_void_p * MAX_PTRS),
                ("out", ctypes.c_void_p * MAX_PTRS),
                ("n", ctypes.c_longlong), ("stripe", ctypes.c_longlong),
                ("nin", ctypes.c_int), ("nout", ctypes.c_int),
                ("scatter", ctypes.c_int)]


class _CopyArgs(ctypes.Structure):
    _fields_ = [("inp", ctypes.c_void_p * MAX_PTRS),
                ("out", ctypes.c_void_p * MAX_PTRS),
                ("chunk", ctypes.c_longlong),
                ("in_stride", ctypes.c_longlong),
                ("out_stride", ctypes.c_longlong),
                ("limit", ctypes.c_longlong), ("n", ctypes.c_int),
                ("nout", ctypes.c_int), ("first_out", ctypes.c_int)]


_lib_lock = threading.Lock()
_lib = None


def _library() -> ctypes.CDLL:
    """The built library, with its entry points typed and its
    argument layouts checked against ours (once per process)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("stacked")
            lib.ompi_stacked_reduce.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.ompi_stacked_reduce.restype = ctypes.c_int
            lib.ompi_stacked_copy.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            lib.ompi_stacked_copy.restype = ctypes.c_int
            lib.ompi_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.ompi_enable_peer.restype = ctypes.c_int
            if (lib.ompi_reduce_args_size() != ctypes.sizeof(_ReduceArgs)
                    or lib.ompi_copy_args_size() != ctypes.sizeof(_CopyArgs)
                    or lib.ompi_max_ptrs() != MAX_PTRS):
                raise RuntimeError("stacked.cu argument layout does not "
                                   "match stacked.py")
            _lib = lib
    return _lib


def _check(xs: Sequence[torch.Tensor], what: str) -> None:
    if not xs:
        raise ValueError(f"{what}: no input tensors")
    if len(xs) > MAX_PTRS:
        raise ValueError(f"{what}: {len(xs)} inputs exceed the kernel's "
                         f"cap of {MAX_PTRS}")
    x0 = xs[0]
    for x in xs:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{what}: inputs must be tensors")
        if x.device != x0.device or x.dtype != x0.dtype \
                or x.shape != x0.shape:
            raise ValueError(f"{what}: inputs must share device, dtype "
                             "and shape")
        if not x.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x0.device}")


def _launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {rc}")


_peer_lock = threading.Lock()
_peer_ok: set = set()


def require_peer(dev: torch.device, src: torch.device) -> None:
    """Let kernels on card ``dev`` read card ``src``'s memory, or raise
    when the pair has no peer access: the mesh tier never stages a
    card's data through the host.  Enabled once per pair."""
    if dev.type != "cuda" or src.type != "cuda" or dev.index == src.index:
        return
    key = (dev.index, src.index)
    if key in _peer_ok:
        return
    with _peer_lock:
        if key in _peer_ok:
            return
        if not torch.cuda.can_device_access_peer(dev.index, src.index):
            raise RuntimeError(
                f"cuda:{dev.index} cannot read cuda:{src.index}'s memory "
                "(no peer access between the two cards): the mesh tier "
                "does not stage device data through the host")
        _launch(_library().ompi_enable_peer(dev.index, src.index),
                "cudaDeviceEnablePeerAccess")
        _peer_ok.add(key)


def _scatter_shape(x: torch.Tensor, n: int):
    if x.dim() == 0 or x.shape[0] % n:
        raise ValueError(f"reduce_scatter: leading dimension of "
                         f"{tuple(x.shape)} is not divisible by {n}")
    return (x.shape[0] // n,) + tuple(x.shape[1:])


# ---------------------------------------------------------------------------
# K1: stacked reduction
# ---------------------------------------------------------------------------

def stacked_reduce(xs: Sequence[torch.Tensor], opname: str,
                   scatter: bool = False) -> List[torch.Tensor]:
    """Reduce N same-shape shards with ``opname`` in one launch.

    Replicate mode (allreduce) returns N outputs of the input's shape,
    each its own tensor holding the whole result.  Scatter mode
    (reduce_scatter) returns N outputs; output i holds stripe i of the
    flattened result, shaped (shape[0] // N, *shape[1:])."""
    _check(xs, "stacked_reduce")
    x0, n = xs[0], len(xs)
    if not reduce_supported(x0.dtype, opname):
        raise TypeError(f"stacked_reduce: {opname} on {x0.dtype} is not "
                        "a pair the kernel takes")
    shape = _scatter_shape(x0, n) if scatter else tuple(x0.shape)
    if x0.device.type == "cpu":
        return stacked_reduce_plain(xs, opname, scatter)
    outs = [torch.empty(shape, dtype=x0.dtype, device=x0.device)
            for _ in range(n)]
    a = _ReduceArgs()
    for i, x in enumerate(xs):
        a.inp[i] = x.data_ptr()
    for i, o in enumerate(outs):
        a.out[i] = o.data_ptr()
    a.n = x0.numel()
    a.stripe = a.n // n if scatter else a.n
    a.nin = a.nout = n
    a.scatter = int(scatter)
    vec_elems = 16 // x0.element_size()
    vec = (all(p % 16 == 0 for p in a.inp[:n])
           and all(p % 16 == 0 for p in a.out[:n])
           and (not scatter or a.stripe % vec_elems == 0))
    lib = _library()
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        if a.n:
            _launch(lib.ompi_stacked_reduce(
                ctypes.byref(a), _DTYPES[x0.dtype], _OPS[opname],
                int(vec), stream), "stacked_reduce")
            stacked_reduce.launches.add()
    return outs


stacked_reduce.launches = LaunchCount()


def stacked_reduce_plain(xs: Sequence[torch.Tensor], opname: str,
                         scatter: bool = False) -> List[torch.Tensor]:
    """Plain PyTorch version of K1, on any device: the same left fold
    in rank order, float16/bfloat16 accumulated in float32 and rounded
    once, logical ops normalised to 0/1, complex PROD as (ac - bd,
    ad + bc) with every product and sum rounded on its own."""
    n = len(xs)
    res = fold_plain(xs, opname)
    if not scatter:
        return [res] + [res.clone() for _ in range(n - 1)]
    shape = _scatter_shape(xs[0], n)
    flat = res.reshape(-1)
    m = flat.numel() // n
    return [flat[i * m:(i + 1) * m].reshape(shape).clone()
            for i in range(n)]


def _fold_parts(dt: torch.dtype, opname: str):
    """(binop, lift, drop, mask) of the plain folds: the op in the
    carrier type of ``_carrier``, and the wrap mask of a narrow
    unsigned type (None for the others)."""
    binop = _cmul if dt.is_complex and opname == "MPI_PROD" \
        else torch_binary(PREDEFINED[opname])
    lift, drop = _carrier(dt, opname)
    return binop, lift, drop, _NARROW_UNSIGNED.get(dt)


def fold_plain(xs: Sequence[torch.Tensor], opname: str) -> torch.Tensor:
    """The left fold op(...op(op(xs[0], xs[1]), xs[2])..., xs[-1]) with
    K1's semantics, as one new tensor."""
    binop, lift, drop, mask = _fold_parts(xs[0].dtype, opname)
    acc = lift(xs[0]).clone()
    if opname in _LOGICAL:
        acc = (acc != 0).to(acc.dtype)
    for x in xs[1:]:
        acc = binop(acc, lift(x))
        if mask is not None:
            acc &= mask
    return drop(acc)


def tree_plain(xs: Sequence[torch.Tensor], opname: str) -> torch.Tensor:
    """The balanced tree over xs (a power-of-two count) with K1's
    semantics: each node op(lower half, upper half), the recursive
    doubling order of the reference's segrd schedule."""
    n = len(xs)
    if n & (n - 1):
        raise ValueError(f"tree fold over {n} inputs: not a power of two")
    binop, lift, drop, mask = _fold_parts(xs[0].dtype, opname)
    stack: List[torch.Tensor] = []
    for r, x in enumerate(xs):
        v = lift(x)
        if opname in _LOGICAL:
            v = (v != 0).to(v.dtype)
        c = r
        while c & 1:
            v = binop(stack.pop(), v)
            if mask is not None:
                v &= mask
            c >>= 1
        stack.append(v)
    return drop(stack[0])


def _carrier(dt: torch.dtype, opname: str):
    """(lift, drop): the type the plain fold computes in and back.
    uint64 folds as its int64 view (the same bits for every op), with
    the sign bit flipped for MAX/MIN so that signed order is unsigned
    order; uint16/uint32 fold in int64 (masked each step)."""
    if dt in _HALF:
        return (lambda x: x.to(torch.float32)), (lambda a: a.to(dt))
    if dt in _NARROW_UNSIGNED:
        return (lambda x: x.to(torch.int64)), (lambda a: a.to(dt))
    if dt == torch.uint64:
        if opname in ("MPI_MAX", "MPI_MIN"):
            return (lambda x: x.view(torch.int64) ^ _SIGN), \
                (lambda a: (a ^ _SIGN).view(dt))
        return (lambda x: x.view(torch.int64)), (lambda a: a.view(dt))
    return (lambda x: x), (lambda a: a)


def _cmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.complex(a.real * b.real - a.imag * b.imag,
                         a.real * b.imag + a.imag * b.real)


# ---------------------------------------------------------------------------
# K2: stacked data movement (alltoall block transpose, allgather concat)
# ---------------------------------------------------------------------------

def _width(nbytes: int, ptrs) -> int:
    for w in (16, 8, 4, 2):
        if nbytes % w == 0 and all(p % w == 0 for p in ptrs):
            return w
    return 1


def stacked_copy(xs: Sequence[torch.Tensor], kind: str
                 ) -> List[torch.Tensor]:
    """One launch over N inputs and N outputs.

    ``alltoall``: out[i][j*m:(j+1)*m] = in[j][i*m:(i+1)*m], m =
    shape[0] // N rows (trailing dimensions folded in); outputs keep
    the input shape.  ``allgather``: out[i] = cat(in) along the first
    dimension (a 0-d input counts as shape (1,))."""
    _check(xs, "stacked_copy")
    x0, n = xs[0], len(xs)
    if kind == "alltoall":
        if x0.dim() == 0 or x0.shape[0] % n:
            raise ValueError(f"alltoall: leading dimension of "
                             f"{tuple(x0.shape)} is not divisible by {n}")
        shape = tuple(x0.shape)
        chunk = x0.numel() * x0.element_size() // n
    elif kind == "allgather":
        s = tuple(x0.shape) or (1,)
        shape = (n * s[0],) + s[1:]
        chunk = x0.numel() * x0.element_size()
    else:
        raise ValueError(f"stacked_copy: unknown kind {kind!r}")
    if x0.device.type == "cpu":
        return stacked_copy_plain(xs, kind)
    outs = [torch.empty(shape, dtype=x0.dtype, device=x0.device)
            for _ in range(n)]
    a = _CopyArgs()
    for i, x in enumerate(xs):
        a.inp[i] = x.data_ptr()
    for i, o in enumerate(outs):
        a.out[i] = o.data_ptr()
    w = _width(chunk, list(a.inp[:n]) + list(a.out[:n]))
    a.chunk = a.out_stride = chunk // w
    a.in_stride = a.chunk if kind == "alltoall" else 0
    a.limit = n * a.chunk
    a.n = a.nout = n
    a.first_out = 0
    lib = _library()
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        if chunk:
            _launch(lib.ompi_stacked_copy(ctypes.byref(a), w, stream),
                    "stacked_copy")
            stacked_copy.launches.add()
    return outs


stacked_copy.launches = LaunchCount()


def stacked_copy_plain(xs: Sequence[torch.Tensor], kind: str
                       ) -> List[torch.Tensor]:
    """Plain PyTorch version of K2, on any device."""
    n = len(xs)
    if kind == "allgather":
        flat = [x.reshape(-1) if x.dim() == 0 else x for x in xs]
        return [torch.cat(flat, 0) for _ in range(n)]
    if kind != "alltoall":
        raise ValueError(f"stacked_copy: unknown kind {kind!r}")
    blocks = [x.reshape(n, -1) for x in xs]
    return [torch.cat([b[i] for b in blocks]).reshape(xs[0].shape)
            for i in range(n)]


# ---------------------------------------------------------------------------
# K2 peer mode: one destination device, sources anywhere
# ---------------------------------------------------------------------------

def _peer_plan(srcs, out, block, dst, src_stride, src_off, out_stride,
               out_off, limit):
    """(source element offset, [(j, count)]) of a peer copy, checked
    against the tensors' sizes.  A None source is a null source: its
    block is zero-filled, and it has no size to check."""
    if not srcs or len(srcs) > MAX_PTRS:
        raise ValueError(f"peer_copy: {len(srcs)} sources (1 to "
                         f"{MAX_PTRS})")
    a = src_off + dst * src_stride
    moves = []
    for j, s in enumerate(srcs):
        if s is not None:
            if not isinstance(s, torch.Tensor) or s.dtype != out.dtype:
                raise ValueError("peer_copy: sources must be tensors of "
                                 "the output's dtype")
            if not s.is_contiguous():
                raise ValueError("peer_copy: sources must be contiguous")
        cnt = min(block, limit - j * out_stride)
        if cnt <= 0:
            continue
        if (s is not None and (a < 0 or a + cnt > s.numel())) \
                or out_off + j * out_stride + cnt > out.numel():
            raise ValueError("peer_copy: a block lies outside its tensor")
        moves.append((j, cnt))
    return a, moves


def peer_copy(srcs: Sequence[torch.Tensor], out: torch.Tensor, block: int,
              *, dst: int = 0, src_stride: int = 0, src_off: int = 0,
              out_stride: int = None, out_off: int = 0,
              limit: int = None) -> torch.Tensor:
    """K2 in peer mode: ONE launch on ``out``'s device that writes, for
    every source j and k < block,

        out[out_off + j * out_stride + k]
            = srcs[j][src_off + dst * src_stride + k]

    (flat element indices), but no element at or past ``out_off +
    limit``.  The sources may lie on other cards (peer access).  An
    allgather is src_stride 0; an alltoall's destination ``dst`` takes
    block ``dst`` of every source.  A source given as None is a null
    source (a PROC_NULL neighbour): the same launch writes zeros into
    its block.  Writes ``out`` in place and returns it."""
    out_stride = block if out_stride is None else out_stride
    limit = len(srcs) * out_stride if limit is None else limit
    if not out.is_contiguous():
        raise ValueError("peer_copy: out must be contiguous")
    a, moves = _peer_plan(srcs, out, block, dst, src_stride, src_off,
                          out_stride, out_off, limit)
    real = [s for s in srcs if s is not None]
    if out.device.type == "cpu":
        if any(s.device.type != "cpu" for s in real):
            raise ValueError("peer_copy: a CPU output takes CPU sources")
        return peer_copy_plain(srcs, out, block, dst=dst,
                               src_stride=src_stride, src_off=src_off,
                               out_stride=out_stride, out_off=out_off,
                               limit=limit)
    if out.device.type != "cuda" or any(s.device.type != "cuda"
                                        for s in real):
        raise ValueError("peer_copy: sources and output must lie on cards")
    if not moves:
        return out
    isz = out.element_size()
    c = _CopyArgs()
    for j, s in enumerate(srcs):
        if s is None:
            c.inp[j] = None  # the kernel zero-fills a null source's block
            continue
        require_peer(out.device, s.device)
        c.inp[j] = s.data_ptr() + a * isz
    c.out[0] = out.data_ptr() + out_off * isz
    w = _width(math.gcd(block * isz, out_stride * isz, limit * isz),
               [p or 0 for p in c.inp[:len(srcs)]] + [c.out[0]])
    c.chunk = block * isz // w
    c.out_stride = out_stride * isz // w
    c.limit = limit * isz // w
    c.in_stride = 0
    c.n = len(srcs)
    c.nout = 1
    c.first_out = 0
    lib = _library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        _launch(lib.ompi_stacked_copy(ctypes.byref(c), w, stream),
                "peer_copy")
        peer_copy.launches.add()
    return out


peer_copy.launches = LaunchCount()


def peer_copy_plain(srcs: Sequence[torch.Tensor], out: torch.Tensor,
                    block: int, *, dst: int = 0, src_stride: int = 0,
                    src_off: int = 0, out_stride: int = None,
                    out_off: int = 0, limit: int = None) -> torch.Tensor:
    """Plain PyTorch version of K2's peer mode, on any device: the same
    block copies, one ``copy_`` each (a ``zero_`` for a null source),
    in place."""
    out_stride = block if out_stride is None else out_stride
    limit = len(srcs) * out_stride if limit is None else limit
    a, moves = _peer_plan(srcs, out, block, dst, src_stride, src_off,
                          out_stride, out_off, limit)
    flat = out.view(-1)
    for j, cnt in moves:
        b = out_off + j * out_stride
        if srcs[j] is None:
            flat[b:b + cnt].zero_()
        else:
            flat[b:b + cnt].copy_(srcs[j].reshape(-1)[a:a + cnt])
    return out

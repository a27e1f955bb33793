"""Wrappers of the stacked-collective kernels (csrc/stacked.cu), their
plain PyTorch versions, and their launch counters.

K1 ``stacked_reduce`` replaces the reference's stacked reduction
programs, ``HbmCollModule._build_stacked("allreduce", op)`` and
``("reduce_scatter", op)`` (ompi_tpu/coll/device.py:1389-1417; the
fold table ``_fold_fn`` at :136 and op/op.py:153 ``jax_binary``).
K2 ``stacked_copy`` replaces their data-movement halves,
``_build_stacked("alltoall")`` (:1421-1431) and ``("allgather")``
(:1418).  K2's peer mode, ``peer_copy_many`` (``peer_copy`` is a
table of one), serves the mesh tier: ONE launch a card over every
destination on that card, reading sources that may lie on other cards
(the all_gather / all_to_all halves of ``_build_mesh_collective``,
:997, and the segbcast / sega2a schedules of coll/pipeline.py:192).

Both are bound by bytes (see the note at the top of stacked.cu).  K1
reads every input once and writes every output once, 16 bytes a
thread where the pointers allow.  K2 is a persistent grid that walks
a flat tile list over every (destination, source) row of the launch,
moving each row's 16-byte-aligned body by bulk copies through a ring
of shared-memory stages; ``_row_tiles`` and ``_row_split`` are the
Python statement of its tiling, which the CPU tests hold.

A wrapper takes the plain version only for tensors that lie on the
CPU.  A CUDA tensor launches the kernel, or the wrapper raises: there
is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import List, Optional, Sequence, Tuple

import torch

from ompi_tpu_torch.op.op import PREDEFINED, torch_binary
from . import build

MAX_PTRS = 128
COPY_TILE = 32768  # bytes a K2 tile
COPY_STAGES = 4    # K2's ring: 2, 4 or 8 stages

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
                ("limit", ctypes.c_longlong), ("tile", ctypes.c_longlong),
                ("ntiles", ctypes.c_longlong),
                ("first_tile", ctypes.c_int * (MAX_PTRS + 1)),
                ("dst", ctypes.c_int * MAX_PTRS),
                ("n", ctypes.c_int), ("nout", ctypes.c_int)]


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


class _LaunchMarks(threading.local):
    """A thread's launch marks: while a traced meeting's body runs on
    the thread (``on``, coll/device.py ``_fence``), the timing event
    recorded just before each card's first launch, by card, and where
    the card's stream had nothing queued then, the host ns it was
    recorded at (``idle_ns``)."""

    def __init__(self) -> None:
        self.on = False
        self.starts: dict = {}
        self.idle_ns: dict = {}


marks = _LaunchMarks()
#: a mark is a clock reading only when its query, record and clock reads
#: took less than this: no other thread ran in between
PROBE_NS = 50_000


def arm_marks() -> _LaunchMarks:
    """Mark the launches of the body about to run on this thread (its
    marks cleared); the caller sets ``on`` back to False after it."""
    m = marks
    m.starts.clear()
    m.idle_ns.clear()
    m.on = True
    return m


def launch_stream(dev, _pcns=time.perf_counter_ns) -> int:
    """The handle of ``dev``'s current stream for a launch.  Inside a
    marked body the card's first launch records a timing event on the
    stream first: where the body starts on the card, once the host has
    built the launch.  On a stream with nothing queued the event
    completes as it is recorded, so the host ns then reads the card's
    clock (the anchor's rate, coll/device.py)."""
    stream = torch.cuda.current_stream(dev)
    m = marks
    if m.on and dev not in m.starts:
        t0 = _pcns()
        idle = stream.query()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        t1 = _pcns()
        m.starts[dev] = ev
        if idle and t1 - t0 < PROBE_NS:
            m.idle_ns[dev] = t1
    return stream.cuda_stream


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
        stream = launch_stream(x0.device)
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

def groups(devices: Sequence, cap: int) -> List[List[int]]:
    """The indices of ``devices`` grouped by device, in order of first
    appearance, each group cut into runs of at most ``cap``: one launch
    a run, so one a card while a card holds at most ``cap``."""
    by: dict = {}
    for i, d in enumerate(devices):
        by.setdefault(d, []).append(i)
    return [g[k:k + cap] for g in by.values() for k in range(0, len(g), cap)]


def _row_tiles(nsrc: int, chunk: int, out_stride: int, limit: int,
               tile: int) -> List[int]:
    """K2's prefix table over the sources (bytes throughout): row j of
    every destination moves min(chunk, limit - j * out_stride) bytes
    in ceil(that / tile) tiles; entry j is the first tile of row j
    among one destination's tiles, entry nsrc their count.  A launch
    over D destinations walks D * pre[-1] tiles, tile t being tile
    t // D - pre[j] of destination t % D's row j (source-major, so the
    destinations that read one source tile run together)."""
    pre = [0]
    for j in range(nsrc):
        cnt = min(chunk, limit - j * out_stride)
        pre.append(pre[-1] + (-(-cnt // tile) if cnt > 0 else 0))
    return pre


def _row_split(src: Optional[int], dst: int, cnt: int, k: int, tile: int
               ) -> Tuple[Optional[Tuple[int, int]], List[Tuple[int, int]]]:
    """What tile k of a K2 row moves, as stacked.cu's copy_tiles splits
    it (byte offsets into the row): (the bulk span, or None; the spans
    its edge threads move).  ``src`` and ``dst`` are the row's
    addresses (src None: a null source, zeros).  A row whose source and
    destination are congruent modulo 16 moves its 16-byte-aligned body
    by bulk copies, and its head and tail in its last tile; any other
    row moves each tile with plain loads."""
    ntile = -(-cnt // tile)
    if src is not None and (src ^ dst) & 15 == 0:
        h = min(cnt, (16 - src % 16) % 16)
        end = h + ((cnt - h) & ~15)
        b0 = h + k * tile
        bulk = (b0, min(b0 + tile, end)) if b0 < end else None
        edges = [(0, h), (end, cnt)] if k == ntile - 1 else []
        return bulk, [e for e in edges if e[1] > e[0]]
    return None, [(k * tile, min((k + 1) * tile, cnt))]


def _copy_launch(c: _CopyArgs, dev: torch.device, what: str) -> None:
    lib = _library()
    with torch.cuda.device(dev):
        stream = launch_stream(dev)
        _launch(lib.ompi_stacked_copy(ctypes.byref(c), COPY_STAGES, stream),
                what)


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
    for dev, c in _copy_tables([x.data_ptr() for x in xs],
                               [(o.device, o.data_ptr()) for o in outs], 0,
                               chunk, chunk if kind == "alltoall" else 0,
                               chunk, n * chunk):
        _copy_launch(c, dev, "stacked_copy")
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
# K2 peer mode: destinations on any cards, sources anywhere
# ---------------------------------------------------------------------------

def _peer_plan(srcs, out, block, dst, src_stride, src_off, out_stride,
               out_off, limit):
    """(source element offset, [(j, count)]) of a peer copy, checked
    against the tensors' sizes.  A None source is a null source: its
    block is zero-filled, and it has no size to check."""
    if not srcs or len(srcs) > MAX_PTRS:
        raise ValueError(f"peer_copy: {len(srcs)} sources (1 to "
                         f"{MAX_PTRS})")
    if not out.is_contiguous():
        raise ValueError("peer_copy: out must be contiguous")
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


def peer_copy_many(srcs: Sequence[Optional[torch.Tensor]],
                   outs: Sequence[torch.Tensor], block: int, *,
                   first_dst: int = 0, src_stride: int = 0,
                   src_off: int = 0, out_stride: int = None,
                   out_off: int = 0, limit: int = None
                   ) -> List[torch.Tensor]:
    """K2 in peer mode over a destination table: for each output i
    (destination d = first_dst + i), every source j and k < block,

        outs[i][out_off + j * out_stride + k]
            = srcs[j][src_off + d * src_stride + k]

    (flat element indices), but no element at or past ``out_off +
    limit``.  ONE launch a card: the outputs are grouped by device
    (``groups``), each card's destinations in one table.  The sources
    may lie on other cards (peer access).  An allgather is src_stride
    0; an alltoall's destination d takes block d of every source.  A
    source given as None is a null source (a PROC_NULL neighbour): the
    launch writes zeros into its block.  Writes the outputs in place
    and returns them.  Stream order: the launch runs on the output
    card's current stream; logical devices of one card share that
    stream (and coll/device's fence), so a grouped launch needs no
    event of its own."""
    out_stride = block if out_stride is None else out_stride
    limit = len(srcs) * out_stride if limit is None else limit
    if not outs:
        return []
    for i, o in enumerate(outs):  # checks every destination's bounds
        _peer_plan(srcs, o, block, first_dst + i, src_stride, src_off,
                   out_stride, out_off, limit)
    real = [s for s in srcs if s is not None]
    if all(o.device.type == "cpu" for o in outs):
        if any(s.device.type != "cpu" for s in real):
            raise ValueError("peer_copy: a CPU output takes CPU sources")
        return peer_copy_many_plain(
            srcs, outs, block, first_dst=first_dst, src_stride=src_stride,
            src_off=src_off, out_stride=out_stride, out_off=out_off,
            limit=limit)
    if any(o.device.type != "cuda" for o in outs) or \
            any(s.device.type != "cuda" for s in real):
        raise ValueError("peer_copy: sources and outputs must lie on cards")
    if any(o.dtype != outs[0].dtype for o in outs):
        raise ValueError("peer_copy: outputs must share a dtype")
    isz = outs[0].element_size()
    tables = _copy_tables(
        [None if s is None else s.data_ptr() + src_off * isz for s in srcs],
        [(o.device, o.data_ptr() + out_off * isz) for o in outs], first_dst,
        block * isz, src_stride * isz, out_stride * isz, limit * isz)
    for dev, c in tables:
        for s in real:
            require_peer(dev, s.device)
        _copy_launch(c, dev, "peer_copy")
        peer_copy.launches.add()
    return list(outs)


def _copy_tables(ptrs, outs, first_dst: int, chunk: int, in_stride: int,
                 out_stride: int, limit: int
                 ) -> List[Tuple[object, _CopyArgs]]:
    """K2 peer's launches over the source addresses ``ptrs`` (None: a
    null source) and the destinations (device, address), destination i
    taking source block first_dst + i (bytes throughout): one (device,
    table) a card (``groups``: MAX_PTRS destinations a table); none
    when no row has a byte to move."""
    pre = _row_tiles(len(ptrs), chunk, out_stride, limit, COPY_TILE)
    if not pre[-1]:
        return []
    tables = []
    for grp in groups([d for d, _ in outs], MAX_PTRS):
        c = _CopyArgs()
        for j, p in enumerate(ptrs):
            c.inp[j] = p
        c.chunk, c.in_stride, c.out_stride, c.limit = (chunk, in_stride,
                                                       out_stride, limit)
        c.tile = COPY_TILE
        c.first_tile[:len(pre)] = pre
        c.n = len(ptrs)
        for il, i in enumerate(grp):
            c.out[il] = outs[i][1]
            c.dst[il] = first_dst + i
        c.nout = len(grp)
        c.ntiles = len(grp) * pre[-1]
        tables.append((outs[grp[0]][0], c))
    return tables


def peer_copy(srcs: Sequence[Optional[torch.Tensor]], out: torch.Tensor,
              block: int, *, dst: int = 0, src_stride: int = 0,
              src_off: int = 0, out_stride: int = None, out_off: int = 0,
              limit: int = None) -> torch.Tensor:
    """K2 in peer mode for one destination ``dst``: ``peer_copy_many``
    over a table of one (one launch), writing ``out`` in place."""
    return peer_copy_many(srcs, [out], block, first_dst=dst,
                          src_stride=src_stride, src_off=src_off,
                          out_stride=out_stride, out_off=out_off,
                          limit=limit)[0]


peer_copy.launches = LaunchCount()


def peer_copy_plain(srcs: Sequence[Optional[torch.Tensor]],
                    out: torch.Tensor, block: int, *, dst: int = 0,
                    src_stride: int = 0, src_off: int = 0,
                    out_stride: int = None, out_off: int = 0,
                    limit: int = None) -> torch.Tensor:
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


def peer_copy_many_plain(srcs: Sequence[Optional[torch.Tensor]],
                         outs: Sequence[torch.Tensor], block: int, *,
                         first_dst: int = 0, **kw) -> List[torch.Tensor]:
    """Plain PyTorch version of ``peer_copy_many``: ``peer_copy_plain``
    for each destination, in place."""
    return [peer_copy_plain(srcs, o, block, dst=first_dst + i, **kw)
            for i, o in enumerate(outs)]

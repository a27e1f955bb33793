"""Wrappers of the mesh-tier kernels (csrc/mesh.cu), their plain
PyTorch versions, and their launch counters.

K6 ``mesh_fold`` replaces the reductions of the reference's mesh
programs: ``_build_mesh_collective`` (ompi_tpu/coll/device.py:997),
the segring / segrd schedules of ``_build_seg_kernel``
(coll/pipeline.py:192), ``_compile_mesh`` (coll/plan.py:257) and the
group reductions of the fused mesh batch (coll/fusion.py:257).  One
launch on a destination device folds the N members' inputs, read
through their pointers, over the stripe that device owns, in the
reference's order: rank order, the segring rotation (stripe c of a
segment folds ranks c, c+1, ..., c-1), or segrd's balanced tree.

K7 ``slot_pack`` replaces ``_build_pack`` (coll/fusion.py:231): one
launch packs one rank's slots of a fused group into one buffer,
writing zeros for the non-root bcast slots.

Both are bound by bytes (see the note at the top of mesh.cu).

A wrapper takes the plain version only for tensors that lie on the
CPU.  A CUDA tensor launches the kernel, or the wrapper raises: there
is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Sequence, Tuple

import torch

from . import build
from .stacked import (_DTYPES, _OPS, LaunchCount, _launch, _width,
                      fold_plain, reduce_supported, require_peer,
                      tree_plain)

MAX_PTRS = 128
MAX_SLOTS = 64
UNITS = 1024  # units one K7 block covers (PACK_UNITS in mesh.cu)


class _FoldArgs(ctypes.Structure):
    _fields_ = [("inp", ctypes.c_void_p * MAX_PTRS),
                ("out", ctypes.c_void_p),
                ("lo", ctypes.c_longlong), ("len", ctypes.c_longlong),
                ("ring_seg", ctypes.c_longlong),
                ("ring_m", ctypes.c_longlong),
                ("nin", ctypes.c_int), ("tree", ctypes.c_int),
                ("order", ctypes.c_ubyte * MAX_PTRS)]


class _PackSlot(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("off", ctypes.c_longlong), ("first_block", ctypes.c_int),
                ("zero", ctypes.c_int)]


class _PackArgs(ctypes.Structure):
    _fields_ = [("slot", _PackSlot * MAX_SLOTS), ("out", ctypes.c_void_p),
                ("nslots", ctypes.c_int)]


_lib_lock = threading.Lock()
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("mesh")
            lib.ompi_mesh_fold.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.ompi_mesh_fold.restype = ctypes.c_int
            lib.ompi_slot_pack.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.ompi_slot_pack.restype = ctypes.c_int
            if (lib.ompi_fold_args_size() != ctypes.sizeof(_FoldArgs)
                    or lib.ompi_pack_args_size() != ctypes.sizeof(_PackArgs)
                    or lib.ompi_mesh_max_ptrs() != MAX_PTRS
                    or lib.ompi_pack_max_slots() != MAX_SLOTS
                    or lib.ompi_pack_units() != UNITS):
                raise RuntimeError("mesh.cu argument layout does not "
                                   "match mesh.py")
            _lib = lib
    return _lib


def _order(order, n: int) -> Tuple[int, int, int]:
    """(tree, ring_seg, ring_m) of a fold order: "rank" (rank order),
    ("ring", seg, m) (segring: the element at flat index g folds ranks
    c, c+1, ..., c-1 for c = (g % seg) // m) or "tree" (segrd's
    balanced tree, N a power of two)."""
    if order == "rank":
        return 0, 0, 0
    if order == "tree":
        if n & (n - 1):
            raise ValueError(f"mesh_fold: a tree over {n} inputs (not a "
                             "power of two)")
        return 1, 0, 0
    if isinstance(order, tuple) and len(order) == 3 and order[0] == "ring":
        _, seg, m = order
        if m < 1 or seg < m:
            raise ValueError(f"mesh_fold: ring geometry {order}")
        return 0, int(seg), int(m)
    raise ValueError(f"mesh_fold: unknown order {order!r}")


def _check_fold(xs, out, lo: int, opname: str) -> None:
    if not xs or len(xs) > MAX_PTRS:
        raise ValueError(f"mesh_fold: {len(xs)} inputs (1 to {MAX_PTRS})")
    x0 = xs[0]
    for x in xs:
        if not isinstance(x, torch.Tensor):
            raise TypeError("mesh_fold: inputs must be tensors")
        if x.dtype != x0.dtype or x.numel() != x0.numel():
            raise ValueError("mesh_fold: inputs must share dtype and size")
        if not x.is_contiguous():
            raise ValueError("mesh_fold: inputs must be contiguous")
    if out.dtype != x0.dtype or not out.is_contiguous():
        raise ValueError("mesh_fold: out must be contiguous, of the "
                         "inputs' dtype")
    if lo < 0 or lo + out.numel() > x0.numel():
        raise ValueError(f"mesh_fold: elements [{lo}, "
                         f"{lo + out.numel()}) outside {x0.numel()}")
    if not reduce_supported(x0.dtype, opname):
        raise TypeError(f"mesh_fold: {opname} on {x0.dtype} is not a pair "
                        "the kernel takes")


def mesh_fold(xs: Sequence[torch.Tensor], out: torch.Tensor, lo: int,
              opname: str, order="rank") -> torch.Tensor:
    """K6: ONE launch on ``out``'s device writing, for k < out.numel(),
    out[k] = the fold of the N inputs at flat element lo + k, in
    ``order`` (see ``_order``).  The inputs may lie on other cards (peer
    access).  Writes ``out`` in place and returns it."""
    _check_fold(xs, out, lo, opname)
    tree, seg, m = _order(order, len(xs))
    if out.device.type == "cpu":
        if any(x.device.type != "cpu" for x in xs):
            raise ValueError("mesh_fold: a CPU output takes CPU inputs")
        out.view(-1).copy_(mesh_fold_plain(xs, lo, out.numel(), opname,
                                           order))
        return out
    if out.device.type != "cuda" or any(x.device.type != "cuda"
                                        for x in xs):
        raise ValueError("mesh_fold: inputs and output must lie on cards")
    if out.numel() == 0:
        return out
    x0 = xs[0]
    a = _FoldArgs()
    for i, x in enumerate(xs):
        require_peer(out.device, x.device)
        a.inp[i] = x.data_ptr()
        a.order[i] = i
    a.out = out.data_ptr()
    a.lo, a.len = lo, out.numel()
    a.ring_seg, a.ring_m = seg, m
    a.nin, a.tree = len(xs), tree
    v = 16 // x0.element_size()
    vec = (not tree and lo % v == 0 and (m == 0 or m % v == 0)
           and all(p % 16 == 0 for p in a.inp[:len(xs)])
           and a.out % 16 == 0)
    lib = _library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        _launch(lib.ompi_mesh_fold(ctypes.byref(a), _DTYPES[x0.dtype],
                                   _OPS[opname], int(vec), stream),
                "mesh_fold")
        mesh_fold.launches.add()
    return out


mesh_fold.launches = LaunchCount()


def mesh_fold_plain(xs: Sequence[torch.Tensor], lo: int, length: int,
                    opname: str, order="rank",
                    device: Optional[torch.device] = None) -> torch.Tensor:
    """Plain PyTorch version of K6, on any device (``device``, default
    the first input's): the explicit fold of elements [lo, lo + length)
    in the same order, with K1's semantics (kernels/stacked.py
    fold_plain / tree_plain).  Returns a new 1-D tensor."""
    n = len(xs)
    tree, seg, m = _order(order, n)
    dev = xs[0].device if device is None else device
    parts = [x.reshape(-1)[lo:lo + length].to(dev) for x in xs]
    if tree:
        return tree_plain(parts, opname)
    if not m:
        return fold_plain(parts, opname)
    if length == 0:
        return torch.empty(0, dtype=xs[0].dtype, device=dev)
    g = torch.arange(lo, lo + length, device=dev)
    rot = torch.remainder(torch.div(torch.remainder(g, seg), m,
                                    rounding_mode="floor"), n)
    # every rotation's fold over every element, each element's kept
    # by a mask on a byte view (no data-dependent shapes, so the plain
    # version runs under CUDA graph capture; torch has no where() for
    # every dtype)
    out = None
    for c in range(n):
        res = fold_plain([parts[(c + k) % n] for k in range(n)], opname)
        res = res.view(torch.uint8).view(length, -1)
        out = res if out is None else \
            torch.where((rot == c).unsqueeze(1), res, out)
    return out.reshape(-1).view(xs[0].dtype)


# ---------------------------------------------------------------------------
# K7: slot pack
# ---------------------------------------------------------------------------

def slot_pack(xs: Sequence[torch.Tensor],
              zero: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """K7: flatten and concatenate one rank's slots (one dtype, one
    device) into one new 1-D buffer, slot i's elements zeros where
    ``zero[i]``.  One launch, or one per MAX_SLOTS slots."""
    if not xs:
        raise ValueError("slot_pack: no slots")
    zero = [False] * len(xs) if zero is None else list(zero)
    x0 = xs[0]
    for x in xs:
        if not isinstance(x, torch.Tensor) or x.dtype != x0.dtype \
                or x.device != x0.device:
            raise ValueError("slot_pack: slots must be tensors of one "
                             "dtype on one device")
        if not x.is_contiguous():
            raise ValueError("slot_pack: slots must be contiguous")
    if len(zero) != len(xs):
        raise ValueError("slot_pack: one zero flag a slot")
    if x0.device.type == "cpu":
        return slot_pack_plain(xs, zero)
    if x0.device.type != "cuda":
        raise ValueError(f"slot_pack: unsupported device {x0.device}")
    isz = x0.element_size()
    sizes = [x.numel() for x in xs]
    offs = [0] * len(xs)
    for i in range(1, len(xs)):
        offs[i] = offs[i - 1] + sizes[i - 1]
    out = torch.empty(offs[-1] + sizes[-1], dtype=x0.dtype, device=x0.device)
    ptrs = [x.data_ptr() for x, z in zip(xs, zero) if not z]
    w = _width(math.gcd(*[s * isz for s in sizes], *[o * isz for o in offs]),
               ptrs + [out.data_ptr()])
    lib = _library()
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        for lo in range(0, len(xs), MAX_SLOTS):
            a = _PackArgs()
            nblocks = 0
            for j, i in enumerate(range(lo, min(lo + MAX_SLOTS, len(xs)))):
                rec = a.slot[j]
                rec.src = xs[i].data_ptr()
                rec.n = sizes[i] * isz // w
                rec.off = offs[i] * isz // w
                rec.first_block = nblocks
                rec.zero = int(zero[i])
                nblocks += -(-rec.n // UNITS)
                a.nslots = j + 1
            if nblocks == 0:
                continue
            a.out = out.data_ptr()
            _launch(lib.ompi_slot_pack(ctypes.byref(a), w, nblocks, stream),
                    "slot_pack")
            slot_pack.launches.add()
    return out


slot_pack.launches = LaunchCount()


def slot_pack_plain(xs: Sequence[torch.Tensor],
                    zero: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Plain PyTorch version of K7, on any device."""
    zero = [False] * len(xs) if zero is None else zero
    return torch.cat([torch.zeros_like(x).reshape(-1) if z
                      else x.reshape(-1) for x, z in zip(xs, zero)])

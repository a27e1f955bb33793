"""Wrappers of the mesh-tier kernels (csrc/mesh.cu), their plain
PyTorch versions, and their launch counters.

K6 ``mesh_fold`` replaces the reductions of the reference's mesh
programs: ``_build_mesh_collective`` (ompi_tpu/coll/device.py:997),
the segring / segrd schedules of ``_build_seg_kernel``
(coll/pipeline.py:192), ``_compile_mesh`` (coll/plan.py:257) and the
group reductions of the fused mesh batch (coll/fusion.py:257).
``mesh_fold_many`` takes a destination table, jobs (out, lo): ONE
launch a card folds the N members' inputs, read through their
pointers, over each job's stripe [lo, lo + out.numel()), in the
reference's order: rank order, the segring rotation (stripe c of a
segment folds ranks c, c+1, ..., c-1), or segrd's balanced tree.
``mesh_fold`` is a table of one.  A job may read its own set of N
inputs: one launch a card over the group buffers of every session a
cross-session combined dispatch carries (the reference's
``_build_fused_mesh_multi``, coll/fusion.py:310; ``split=False``: one
launch a card, or a ValueError where they outgrow one table).

K7 ``slot_pack`` replaces ``_build_pack`` (coll/fusion.py:231): one
launch packs one rank's slots of a fused group into one buffer,
writing zeros for the non-root bcast slots.

Both are bound by bytes (see the note at the top of mesh.cu).  K6 is
a persistent grid over a flat tile list of every job of the launch,
fed by bulk copies through a ring of shared-memory stages;
``_fold_job``, ``_fold_job_tiles`` and ``_fold_span`` are the Python
statement of its tiling, which the CPU tests hold.  K7 moves each slot
at its own width, planned here (``_pack_plan``: head bytes, a body of
16-, 8-, 4-, 2- or 1-byte units, tail bytes) and laid out in slot
tables (``_pack_tables``), which the CPU tests hold too.

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
from .stacked import (_DTYPES, _OPS, LaunchCount, _launch, fold_plain,
                      groups, launch_stream, reduce_supported, require_peer,
                      tree_plain)

MAX_PTRS = 128
MAX_JOBS = 64     # destinations in one K6 table (FOLD_MAX_JOBS)
MAX_STAGES = 8    # FOLD_MAX_STAGES
FOLD_TILE = 2048  # bytes of one member a K6 tile, at most
FOLD_STAGES = 2   # K6's ring
FOLD_SMEM = 192 * 1024  # bytes a K6 ring may take
MAX_SLOTS = 64
UNITS = 256  # 16-byte units one K7 block covers (PACK_UNITS in mesh.cu)


class _FoldJob(ctypes.Structure):
    _fields_ = [("out", ctypes.c_void_p), ("lo", ctypes.c_longlong),
                ("len", ctypes.c_longlong), ("first_tile", ctypes.c_int),
                ("head", ctypes.c_int), ("in0", ctypes.c_int)]


class _FoldArgs(ctypes.Structure):
    _fields_ = [("inp", ctypes.c_void_p * MAX_PTRS),
                ("job", _FoldJob * MAX_JOBS),
                ("ring_seg", ctypes.c_longlong),
                ("ring_m", ctypes.c_longlong),
                ("tile", ctypes.c_longlong),
                ("nin", ctypes.c_int), ("tree", ctypes.c_int),
                ("njobs", ctypes.c_int), ("ntiles", ctypes.c_int),
                ("stages", ctypes.c_int),
                ("order", ctypes.c_ubyte * MAX_PTRS)]


class _PackSlot(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("off", ctypes.c_longlong),
                ("units", ctypes.c_longlong), ("head", ctypes.c_int),
                ("tail", ctypes.c_int), ("width", ctypes.c_int)]


class _PackArgs(ctypes.Structure):
    _fields_ = [("first_block", ctypes.c_int * MAX_SLOTS),
                ("slot", _PackSlot * MAX_SLOTS), ("out", ctypes.c_void_p),
                ("nslots", ctypes.c_int), ("each", ctypes.c_int)]


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
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.ompi_mesh_fold.restype = ctypes.c_int
            lib.ompi_slot_pack.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            lib.ompi_slot_pack.restype = ctypes.c_int
            if (lib.ompi_fold_args_size() != ctypes.sizeof(_FoldArgs)
                    or lib.ompi_pack_args_size() != ctypes.sizeof(_PackArgs)
                    or lib.ompi_mesh_max_ptrs() != MAX_PTRS
                    or lib.ompi_fold_max_jobs() != MAX_JOBS
                    or lib.ompi_fold_max_stages() != MAX_STAGES
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


def _check_inputs(xs, opname: str) -> None:
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
    if not reduce_supported(x0.dtype, opname):
        raise TypeError(f"mesh_fold: {opname} on {x0.dtype} is not a pair "
                        "the kernel takes")


def _check_job(x0, out, lo: int) -> None:
    if out.dtype != x0.dtype or not out.is_contiguous():
        raise ValueError("mesh_fold: out must be contiguous, of the "
                         "inputs' dtype")
    if lo < 0 or lo + out.numel() > x0.numel():
        raise ValueError(f"mesh_fold: elements [{lo}, "
                         f"{lo + out.numel()}) outside {x0.numel()}")


def _fold_tile(nin: int, isz: int) -> int:
    """Elements of one member a K6 tile: FOLD_TILE bytes, less where N
    members' slices over FOLD_STAGES stages would pass FOLD_SMEM, in
    whole 16-byte vectors."""
    b = min(FOLD_TILE, FOLD_SMEM // (FOLD_STAGES * nin) // 16 * 16)
    return max(16, b) // isz


def _fold_job(in_addrs: Sequence[int], out_addr: int, lo: int, length: int,
              isz: int, seg: int = 0, m: int = 0) -> int:
    """The head of a K6 job: the elements ahead of its first whole
    16-byte vector, when every input's element ``lo`` and the output
    share one residue modulo 16 (and, segring, no vector straddles a
    ring_m stripe), so that the job's body moves by bulk copies; -1
    otherwise (the whole job on the kernel's edge path)."""
    v = 16 // isz
    r = out_addr % 16
    if r % isz or any((p + lo * isz) % 16 != r for p in in_addrs):
        return -1
    h = min(length, (16 - r) % 16 // isz)
    if m and (m % v or seg % v or (lo + h) % v):
        return -1
    return h


def _fold_job_tiles(length: int, head: int, tile: int, v: int) -> int:
    """Tiles of a K6 job (mesh.cu fold_span): ceil(length / tile) on
    the edge path; else its bulk tiles and, if the head or the tail
    misses a whole vector, one edge tile."""
    if head < 0:
        return -(-length // tile)
    body = (length - head) // v * v
    return -(-body // tile) + (1 if length > body else 0)


def _fold_span(length: int, head: int, tile: int, v: int, k: int):
    """(kind, e0, e1) of tile k of a K6 job, as mesh.cu's fold_span:
    kind 1 bulk elements [e0, e1); 0 edge-path elements [e0, e1); 2 the
    edge tile of elements [0, e0) and [e1, length)."""
    if head < 0:
        return 0, k * tile, min((k + 1) * tile, length)
    body = (length - head) // v * v
    if k < -(-body // tile):
        return 1, head + k * tile, head + min((k + 1) * tile, body)
    return 2, head, head + body


def _sets(xs) -> List[List[torch.Tensor]]:
    """The input sets of a K6 table: ``xs`` is one set of N inputs, or
    a list of such sets."""
    if not xs:
        raise ValueError(f"mesh_fold: 0 inputs (1 to {MAX_PTRS})")
    return [list(xs)] if isinstance(xs[0], torch.Tensor) \
        else [list(s) for s in xs]


def sets_per_launch(n: int) -> int:
    """Input sets of N members one K6 launch a card holds, whatever
    their lengths, in a mesh allreduce over the sets laid end to end
    (coll/device ``_mesh_allreduce_sets``): MAX_PTRS pointers in all,
    and MAX_JOBS jobs on a card — the N members' stripes, cut once
    more by each boundary between two sets, when every member lies on
    that card."""
    return max(0, min(MAX_PTRS // n, MAX_JOBS - n + 1))


def mesh_fold_many(xs, jobs, opname: str, order="rank", split: bool = True
                   ) -> List[torch.Tensor]:
    """K6 over a destination table: for each job (out, lo[, k]) and e <
    out.numel(), out[e] = the fold of input set k's N inputs at flat
    element lo + e, in ``order`` (see ``_order``).  ``xs`` is one set
    of N inputs (every job's k is 0), or a list of sets of N inputs of
    one dtype — the group buffers of every session a cross-session
    combined dispatch carries; MAX_PTRS pointers in all.  The jobs are
    grouped by ``out.device``: ONE launch a card (MAX_JOBS a table; a
    longer table splits, or, with ``split`` False, raises ValueError
    on any device), each counted on ``mesh_fold.launches``.  The
    inputs may lie on other cards (peer access).  Writes the outputs
    in place and returns them.  Stream order: each launch runs on its
    card's current stream; logical devices of one card share that
    stream (and coll/device's fence), so a grouped launch needs no
    event of its own."""
    sets = _sets(xs)
    n = len(sets[0])
    if len(sets) * n > MAX_PTRS:
        raise ValueError(f"mesh_fold: {len(sets)} sets of {n} inputs "
                         f"exceed one table ({MAX_PTRS} pointers)")
    for s in sets:
        if len(s) != n:
            raise ValueError("mesh_fold: every set holds N inputs")
        _check_inputs(s, opname)
        if s[0].dtype != sets[0][0].dtype:
            raise ValueError("mesh_fold: the sets share a dtype")
    jobs = [(j[0], j[1], j[2] if len(j) > 2 else 0) for j in jobs]
    for out, lo, k in jobs:
        _check_job(sets[k][0], out, lo)
    tree, seg, m = _order(order, n)
    outs = [out for out, _, _ in jobs]
    cards = [o.device for o in outs if o.numel()]
    if not split and len(groups(cards, MAX_JOBS)) > len(set(cards)):
        raise ValueError(f"mesh_fold: more than {MAX_JOBS} jobs on one "
                         "card")
    xs_all = [x for s in sets for x in s]
    if all(o.device.type == "cpu" for o in outs):
        if any(x.device.type != "cpu" for x in xs_all):
            raise ValueError("mesh_fold: a CPU output takes CPU inputs")
        return mesh_fold_many_plain(sets, jobs, opname, order)
    if any(o.device.type != "cuda" for o in outs) or \
            any(x.device.type != "cuda" for x in xs_all):
        raise ValueError("mesh_fold: inputs and outputs must lie on cards")
    x0 = xs_all[0]
    tables = _fold_tables([x.data_ptr() for x in xs_all],
                          [(o.device, o.data_ptr(), lo, o.numel(), k)
                           for o, lo, k in jobs if o.numel()],
                          x0.element_size(), tree, seg, m, nin=n)
    lib = _library()
    for dev, a in tables:
        for x in xs_all:
            require_peer(dev, x.device)
        with torch.cuda.device(dev):
            stream = launch_stream(dev)
            _launch(lib.ompi_mesh_fold(ctypes.byref(a), _DTYPES[x0.dtype],
                                       _OPS[opname], stream), "mesh_fold")
            mesh_fold.launches.add()
    return outs


def _fold_tables(ptrs: Sequence[int], jobs, isz: int, tree: int = 0,
                 seg: int = 0, m: int = 0, nin: Optional[int] = None
                 ) -> List[Tuple[object, _FoldArgs]]:
    """K6's launches over the input addresses ``ptrs`` and the
    non-empty jobs (device, out address, lo, len[, set]): one (device,
    table) a card (``groups``: MAX_JOBS jobs a table), each job's head and
    first tile filled in, the tile and the stages set.  ``nin``: the
    members a fold reads, when ``ptrs`` holds several sets of them
    back to back (job set k reads ptrs[k * nin:(k + 1) * nin]); None
    for one set."""
    n = len(ptrs) if nin is None else nin
    if len(ptrs) % n or len(ptrs) > MAX_PTRS:
        raise ValueError(f"mesh_fold: {len(ptrs)} input pointers (sets "
                         f"of {n}, at most {MAX_PTRS} in all)")
    v = 16 // isz
    tile = _fold_tile(n, isz)
    order = range(n)
    out = []
    for grp in groups([j[0] for j in jobs], MAX_JOBS):
        a = _FoldArgs()
        for i, p in enumerate(ptrs):
            a.inp[i] = p
        a.order[:n] = order
        t = 0
        for q, i in enumerate(grp):
            _, addr, lo, length = jobs[i][:4]
            in0 = jobs[i][4] * n if len(jobs[i]) > 4 else 0
            rec = a.job[q]
            rec.out, rec.lo, rec.len, rec.in0 = addr, lo, length, in0
            rec.head = _fold_job(ptrs[in0:in0 + n], addr, lo, length, isz,
                                 seg, m)
            rec.first_tile = t
            t += _fold_job_tiles(length, rec.head, tile, v)
        a.ring_seg, a.ring_m, a.tile = seg, m, tile
        a.nin, a.tree, a.njobs, a.ntiles = n, tree, len(grp), t
        a.stages = FOLD_STAGES
        out.append((jobs[grp[0]][0], a))
    return out


def mesh_fold(xs: Sequence[torch.Tensor], out: torch.Tensor, lo: int,
              opname: str, order="rank") -> torch.Tensor:
    """K6 for one destination: ``mesh_fold_many`` over a table of one
    (one launch on ``out``'s card), writing ``out`` in place."""
    return mesh_fold_many(xs, [(out, lo)], opname, order)[0]


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


def mesh_fold_many_plain(xs, jobs, opname: str, order="rank"
                         ) -> List[torch.Tensor]:
    """Plain PyTorch version of ``mesh_fold_many`` (one set or a list
    of sets, jobs (out, lo[, k])): ``mesh_fold_plain`` of set k for
    each job, written into its output in place."""
    sets = _sets(xs)
    for j in jobs:
        out, lo = j[0], j[1]
        out.view(-1).copy_(mesh_fold_plain(
            sets[j[2] if len(j) > 2 else 0], lo, out.numel(), opname,
            order, device=out.device))
    return [j[0] for j in jobs]


# ---------------------------------------------------------------------------
# K7: slot pack
# ---------------------------------------------------------------------------

def _pack_plan(src_addrs: Sequence[int], nbytes: Sequence[int],
               out_addr: int, offs: Sequence[int], zero: Sequence[bool]
               ) -> List[Tuple[int, int, int, int]]:
    """K7's plan, one row (head, width, units, tail) a slot, from integer
    addresses: slot i's ``nbytes[i]`` bytes at ``src_addrs[i]`` go to
    byte ``offs[i]`` of the buffer at ``out_addr``.  ``head``: the bytes
    ahead of the slot's first 16-byte-aligned output address; then
    ``units`` units of ``width`` bytes, the widest of 16, 8, 4, 2, 1 at
    which the source and the output are both aligned there (16 for a
    zero slot, which has no source); then ``tail`` bytes.  One odd slot
    narrows only itself."""
    rows = []
    for src, n, off, z in zip(src_addrs, nbytes, offs, zero):
        d = out_addr + off
        head = min(n, -d % 16)
        w = 16
        if not z:  # the output is 16-byte aligned at head, or units is 0
            while (src + head) % w:
                w //= 2
        units = (n - head) // w
        rows.append((head, w, units, n - head - units * w))
    return rows


def _pack_blocks(row: Tuple[int, int, int, int]) -> int:
    """K7's blocks for one slot row: ceil(body bytes / (UNITS * 16)),
    and one for a slot whose bytes are all head and tail; none for an
    empty slot."""
    head, w, n, tail = row
    return max(1 if head + tail else 0, -(-n * w // (UNITS * 16)))


def _pack_tables(src_addrs: Sequence[int], nbytes: Sequence[int],
                 out_addr: int, zero: Sequence[bool]
                 ) -> List[Tuple[_PackArgs, int]]:
    """K7's launches over the slots, packed in order at ``out_addr``:
    (table, blocks) for each run of MAX_SLOTS slots that holds any byte
    (a run of empty slots launches nothing), each slot's row of
    ``_pack_plan`` and its first block filled in, and ``each`` set where
    every slot of the table takes as many blocks."""
    offs = [0] * len(nbytes)
    for i in range(1, len(nbytes)):
        offs[i] = offs[i - 1] + nbytes[i - 1]
    plan = _pack_plan(src_addrs, nbytes, out_addr, offs, zero)
    out = []
    for lo in range(0, len(nbytes), MAX_SLOTS):
        a = _PackArgs()
        a.out = out_addr
        nblocks = 0
        counts = set()
        for j, i in enumerate(range(lo, min(lo + MAX_SLOTS, len(nbytes)))):
            rec = a.slot[j]
            rec.src = None if zero[i] else src_addrs[i]
            rec.off = offs[i]
            rec.head, rec.width, rec.units, rec.tail = plan[i]
            a.first_block[j] = nblocks
            blocks = _pack_blocks(plan[i])
            counts.add(blocks)
            nblocks += blocks
            a.nslots = j + 1
        if nblocks:
            a.each = counts.pop() if len(counts) == 1 else 0
            out.append((a, nblocks))
    return out


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
    out = torch.empty(sum(x.numel() for x in xs), dtype=x0.dtype,
                      device=x0.device)
    tables = _pack_tables([x.data_ptr() for x in xs],
                          [x.numel() * isz for x in xs], out.data_ptr(),
                          zero)
    lib = _library()
    with torch.cuda.device(x0.device):
        stream = launch_stream(x0.device)
        for a, nblocks in tables:
            _launch(lib.ompi_slot_pack(ctypes.byref(a), nblocks, stream),
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

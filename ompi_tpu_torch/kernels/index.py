"""Wrappers of the index gather/scatter kernels (csrc/index.cu), their
plain PyTorch versions, and their launch counters.

K4 ``index_gather`` replaces the reference's ``device_pack``
(ompi_tpu/datatype/device.py:67, ``jnp.take`` by a cached element-index
vector); K5 ``index_scatter`` replaces ``device_unpack`` (:86, the
mirrored ``.at[idx].set``).  Both move elements by width (1, 2, 4, 8 or
16 bytes) and take their indices as an ``IndexVector``, whose bounds
are known on the host, so the wrapper checks them against the buffers
without reading the card.  Bound by bytes (see the note at the top of
index.cu).

K5 has two modes, both the kernel.  An ``IndexVector`` splits its
indices once, on the host, into a table of affine runs (``_runs``),
accepted only after its expansion equals the vector exactly
(``_checked``); where the indices are distinct and the table is
shorter than the vector, K5 takes run mode and reads no index (the
table rides in its launch arguments; config 5's ``vector(m, 1, 2)`` is
one run).  Otherwise (a permutation, an indexed type of many short
blocks, repeated indices) it takes index mode and reads the vector.
``index_scatter.launches`` counts one a launch in either mode,
``index_scatter.run_launches`` the run-mode ones.

A wrapper takes the plain version only for tensors that lie on the
CPU.  A CUDA tensor launches the kernel, or the wrapper raises: there
is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from . import build
from .stacked import LaunchCount, _launch, launch_stream

WIDTHS = (1, 2, 4, 8, 16)
MAX_RUNS = 64  # runs a table holds at most: SCATTER_RUNS in index.cu
# a run: first destination, block length, stride, block count (all in
# elements) and the packed offset of its first element
DST, BLEN, STRIDE, NBLK, POFF = range(5)


def _runs(idx: np.ndarray) -> Optional[np.ndarray]:
    """Split ``idx`` greedily into affine runs: an (R, 5) int64 table
    (DST, BLEN, STRIDE, NBLK, POFF) in packed order, or None when it
    takes more than MAX_RUNS runs.  Maximal blocks of consecutive
    indices first; then each run takes, from its first block on, the
    following blocks of the same length at the same stride.  The work
    in Python is one step a run, so a permutation gives up after
    MAX_RUNS + 1 steps; the rest is numpy over the vector."""
    n = idx.size
    if n == 0:
        return None
    starts = np.concatenate(([0], np.flatnonzero(np.diff(idx) != 1) + 1))
    lens = np.diff(np.append(starts, n))
    first = idx[starts]
    k = starts.size
    # transition j joins block j to block j + 1; a stretch is a maximal
    # range of transitions of equal (length, next length, gap), and
    # end[j] the last transition of j's stretch
    gap = np.diff(first)
    new = np.ones(k - 1, dtype=bool)
    new[1:] = ((lens[1:-1] != lens[:-2]) | (lens[2:] != lens[1:-1])
               | (gap[1:] != gap[:-1]))
    end = np.append(np.flatnonzero(new)[1:] - 1, k - 2)[np.cumsum(new) - 1]
    table = []
    a = 0
    while a < k:
        if len(table) == MAX_RUNS:
            return None
        # the run takes blocks a..b: to the end of a's stretch when its
        # next block is as long, else block a alone
        b = end[a] + 1 if a + 1 < k and lens[a] == lens[a + 1] else a
        stride = int(gap[a]) if b > a else int(lens[a])
        table.append((int(first[a]), int(lens[a]), stride, b - a + 1,
                      int(starts[a])))
        a = b + 1
    return np.array(table, dtype=np.int64)


def _expand(table: np.ndarray) -> np.ndarray:
    """The index vector a run table describes, in packed order."""
    parts = [(d + s * np.arange(nb, dtype=np.int64)[:, None]
              + np.arange(bl, dtype=np.int64)[None, :]).reshape(-1)
             for d, bl, s, nb, _ in table.tolist()]
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def _checked(idx: np.ndarray, table: np.ndarray) -> np.ndarray:
    """``table``, once its packed offsets follow each other from 0 and
    its expansion equals ``idx`` exactly; else ValueError."""
    table = np.ascontiguousarray(table, dtype=np.int64).reshape(-1, 5)
    sizes = table[:, BLEN] * table[:, NBLK]
    offs = np.concatenate(([0], np.cumsum(sizes)[:-1]))
    if (len(table) == 0 or len(table) > MAX_RUNS
            or (table[:, BLEN] < 1).any() or (table[:, NBLK] < 1).any()
            or not np.array_equal(table[:, POFF], offs)
            or not np.array_equal(_expand(table), idx)):
        raise ValueError("index run table does not expand to its vector")
    return table


class IndexVector:
    """An int64 element-index vector on a device, with its least and
    greatest index kept on the host, and K5's plan: ``runs``, the run
    table (``_runs``, checked by ``_checked``) where K5 takes run mode,
    else None (index mode)."""

    def __init__(self, idx: np.ndarray, device) -> None:
        idx = np.ascontiguousarray(idx, dtype=np.int64).reshape(-1)
        self.n = int(idx.size)
        self.lo = int(idx.min()) if self.n else 0
        self.hi = int(idx.max()) if self.n else -1
        self.tensor = torch.from_numpy(idx).to(device)
        table = _runs(idx)
        # run mode: a description shorter than the vector, of distinct
        # indices (the table's writes must not race)
        if table is not None and (table.size >= self.n
                                  or np.unique(idx).size != self.n):
            table = None
        self.runs = None if table is None else _checked(idx, table)

    @property
    def mode(self) -> str:
        return "index" if self.runs is None else "runs"


_lib_lock = threading.Lock()
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("index")
            for fn in (lib.ompi_index_gather, lib.ompi_index_scatter):
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.ompi_index_scatter_runs.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_void_p]
            lib.ompi_index_scatter_runs.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(what: str, index: IndexVector, span: int, *ts: torch.Tensor
           ) -> None:
    """Same device and dtype, contiguous, element-aligned, and every
    index inside [0, span)."""
    t0 = ts[0]
    for t in ts:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: buffers must be tensors")
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError(f"{what}: buffers must share device and "
                             "dtype")
        if not t.is_contiguous():
            raise ValueError(f"{what}: buffers must be contiguous")
    if t0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t0.device}")
    if index.tensor.device != t0.device:
        raise ValueError(f"{what}: index vector on {index.tensor.device}, "
                         f"buffers on {t0.device}")
    if index.n and (index.lo < 0 or index.hi >= span):
        raise IndexError(f"{what}: indices [{index.lo}, {index.hi}] "
                         f"outside a buffer of {span} elements")
    w = t0.element_size()
    if w not in WIDTHS:
        raise TypeError(f"{what}: element width {w} not taken")


def _run(call, a: torch.Tensor, out: torch.Tensor, what: str) -> None:
    """Launch ``call(a_ptr, out_ptr, width, stream)`` on out's card, on
    its current stream; raise on the cudaError_t it returns."""
    w = out.element_size()
    if a.data_ptr() % w or out.data_ptr() % w:
        raise ValueError(f"{what}: buffers not aligned to their "
                         "element width")
    with torch.cuda.device(out.device):
        stream = launch_stream(out.device)
        _launch(call(a.data_ptr(), out.data_ptr(), w, stream), what)


# ---------------------------------------------------------------------------
# K4: gather (device_pack)
# ---------------------------------------------------------------------------

def index_gather(src: torch.Tensor, index: IndexVector) -> torch.Tensor:
    """out[i] = src.flatten()[index[i]]: a new 1-D tensor of index.n
    elements."""
    _check("index_gather", index, src.numel(), src)
    if src.device.type == "cpu":
        return index_gather_plain(src, index)
    out = torch.empty(index.n, dtype=src.dtype, device=src.device)
    if index.n:
        lib = _library()
        _run(lambda a, o, w, s: lib.ompi_index_gather(
            a, index.tensor.data_ptr(), o, index.n, w, s),
            src, out, "index_gather")
        index_gather.launches.add()
    return out


index_gather.launches = LaunchCount()


def index_gather_plain(src: torch.Tensor, index: IndexVector
                       ) -> torch.Tensor:
    """Plain PyTorch version of K4, on any device."""
    return src.reshape(-1)[index.tensor]


# ---------------------------------------------------------------------------
# K5: scatter (device_unpack), in place
# ---------------------------------------------------------------------------

def index_scatter(packed: torch.Tensor, index: IndexVector,
                  out: torch.Tensor) -> torch.Tensor:
    """out.flatten()[index[i]] = packed[i], written into ``out`` in
    place; returns ``out``.  With repeated indices, which value lands
    is unspecified.  On a card, one launch in the mode ``index.mode``
    names."""
    _check("index_scatter", index, out.numel(), packed, out)
    if packed.numel() != index.n:
        raise ValueError(f"index_scatter: {packed.numel()} packed "
                         f"elements for {index.n} indices")
    if out.device.type == "cpu":
        return index_scatter_plain(packed, index, out)
    if index.n:
        lib, runs = _library(), index.runs
        if runs is None:
            _run(lambda a, o, w, s: lib.ompi_index_scatter(
                a, index.tensor.data_ptr(), o, index.n, w, s),
                packed, out, "index_scatter")
        else:  # the C entry re-checks the table against [lo, hi]
            _run(lambda a, o, w, s: lib.ompi_index_scatter_runs(
                a, o, index.n, w, runs.ctypes.data, len(runs), index.lo,
                index.hi, out.numel(), s), packed, out, "index_scatter")
            index_scatter.run_launches.add()
        index_scatter.launches.add()
    return out


index_scatter.launches = LaunchCount()
index_scatter.run_launches = LaunchCount()  # the launches in run mode


def index_scatter_plain(packed: torch.Tensor, index: IndexVector,
                        out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5, on any device, in place."""
    out.view(-1)[index.tensor] = packed.reshape(-1)
    return out


def index_scatter_runs_plain(packed: torch.Tensor, index: IndexVector,
                             out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5's run mode, on any device, in place:
    each run of ``index.runs`` copied as one strided view of ``out``,
    no index vector read."""
    if index.runs is None:
        raise ValueError("index_scatter_runs_plain: the vector has no run "
                         "table (index mode)")
    flat, src = out.view(-1), packed.reshape(-1)
    base = flat.storage_offset()
    for d, bl, st, nb, p in index.runs.tolist():
        block = src[p:p + bl * nb].view(nb, bl)
        if st < 0:  # blocks in falling order: the view from the last up
            d, st, block = d + (nb - 1) * st, -st, block.flip(0)
        flat.as_strided((nb, bl), (st, 1), base + d).copy_(block)
    return out

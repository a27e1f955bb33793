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

A wrapper takes the plain version only for tensors that lie on the
CPU.  A CUDA tensor launches the kernel, or the wrapper raises: there
is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import build
from .stacked import LaunchCount, _launch

WIDTHS = (1, 2, 4, 8, 16)


class IndexVector:
    """An int64 element-index vector on a device, with its least and
    greatest index kept on the host."""

    def __init__(self, idx: np.ndarray, device) -> None:
        idx = np.ascontiguousarray(idx, dtype=np.int64).reshape(-1)
        self.n = int(idx.size)
        self.lo = int(idx.min()) if self.n else 0
        self.hi = int(idx.max()) if self.n else -1
        self.tensor = torch.from_numpy(idx).to(device)


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


def _run(fn, a: torch.Tensor, index: IndexVector, out: torch.Tensor,
         what: str) -> None:
    w = out.element_size()
    if a.data_ptr() % w or out.data_ptr() % w:
        raise ValueError(f"{what}: buffers not aligned to their "
                         "element width")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        _launch(fn(a.data_ptr(), index.tensor.data_ptr(), out.data_ptr(),
                   index.n, w, stream), what)


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
        _run(_library().ompi_index_gather, src, index, out, "index_gather")
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
    is unspecified."""
    _check("index_scatter", index, out.numel(), packed, out)
    if packed.numel() != index.n:
        raise ValueError(f"index_scatter: {packed.numel()} packed "
                         f"elements for {index.n} indices")
    if out.device.type == "cpu":
        return index_scatter_plain(packed, index, out)
    if index.n:
        _run(_library().ompi_index_scatter, packed, index, out,
             "index_scatter")
        index_scatter.launches.add()
    return out


index_scatter.launches = LaunchCount()


def index_scatter_plain(packed: torch.Tensor, index: IndexVector,
                        out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5, on any device, in place."""
    out.view(-1)[index.tensor] = packed.reshape(-1)
    return out

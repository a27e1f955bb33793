"""Wrapper of the driver-step kernel (csrc/entry.cu), its plain
PyTorch version, and its launch counter.

K12 ``driver_step`` replaces the reference's ``collective_step``
(__graft_entry__.py:17-45): on x of shape (R, N), N % R == 0 and
n = N / R, it returns ``(out, rs)`` with

    red       = x.sum(0), folded over the rows in rank order (K1's fold)
    rs        = red.reshape(R, n)
    out[i, c] = red[c] + x[c // n, i * n + c % n]

in one launch: the allreduce, the reduce_scatter stripes and the
alltoall block transpose of R ranks co-located on one card.  It takes
every dtype K1's SUM takes (float16 and bfloat16 fold in float32, the
red rounded once before the add).  It is bound by bytes; see the note
at the top of entry.cu.

A wrapper takes the plain version only for tensors that lie on the
CPU.  A CUDA tensor launches the kernel, or the wrapper raises: there
is no fallback from the kernel to the plain version.  The refusals
(N % R != 0, R over the kernel's cap, a non-contiguous x) hold on the
card and on the CPU alike.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from . import build
from .stacked import (_DTYPES, MAX_PTRS, LaunchCount, _fold_parts, _launch,
                      fold_plain, launch_stream)

MAX_ROWS = MAX_PTRS  # K1's cap on the ranks it folds

_lib_lock = threading.Lock()
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("entry")
            lib.ompi_driver_step.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p]
            lib.ompi_driver_step.restype = ctypes.c_int
            if lib.ompi_driver_step_max_rows() != MAX_ROWS:
                raise RuntimeError("entry.cu row cap does not match "
                                   "entry.py")
            _lib = lib
    return _lib


def _check(x: torch.Tensor) -> Tuple[int, int]:
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("driver_step: x must be a 2-D tensor (R, N)")
    r, n = x.shape
    if r < 1 or r > MAX_ROWS:
        raise ValueError(f"driver_step: {r} rows (1 to {MAX_ROWS})")
    if n % r:
        raise ValueError(f"driver_step: N = {n} is not divisible by "
                         f"R = {r}")
    if not x.is_contiguous():
        raise ValueError("driver_step: x must be contiguous")
    if x.dtype not in _DTYPES:
        raise TypeError(f"driver_step: no SUM on {x.dtype}")
    return r, n


def driver_step(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, rs) of the driver's step on x of shape (R, N), one launch
    on a card (the plain version on the CPU)."""
    r, n = _check(x)
    if x.device.type == "cpu":
        return driver_step_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"driver_step: unsupported device {x.device}")
    out = torch.empty_like(x)
    rs = torch.empty((r, n // r), dtype=x.dtype, device=x.device)
    if n == 0:
        return out, rs
    vec = ((n // r) * x.element_size() % 16 == 0
           and all(t.data_ptr() % 16 == 0 for t in (x, out, rs)))
    with torch.cuda.device(x.device):
        stream = launch_stream(x.device)
        _launch(_library().ompi_driver_step(
            x.data_ptr(), out.data_ptr(), rs.data_ptr(), _DTYPES[x.dtype],
            r, n, int(vec), stream), "driver_step")
        driver_step.launches.add()
    return out, rs


driver_step.launches = LaunchCount()


def driver_step_plain(x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K12, on any device: the same left fold
    over the rows (``stacked.fold_plain``, K1's SUM), rounded to x's
    dtype, then one SUM a position with the alltoall's block
    transpose, in the fold's carrier type, rounded once."""
    r, n = _check(x)
    m = n // r
    red = fold_plain(list(x.unbind(0)), "MPI_SUM")
    binop, lift, drop, mask = _fold_parts(x.dtype, "MPI_SUM")
    a2a = x.reshape(r, r, m).transpose(0, 1).reshape(r, n)
    acc = binop(lift(red).unsqueeze(0), lift(a2a))
    if mask is not None:
        acc &= mask
    return drop(acc), red.reshape(r, m)

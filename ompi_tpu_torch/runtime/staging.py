"""runtime/staging: the shared host<->device staging discipline.

Port of the reference's runtime/staging.py: one alignment rule, one
aliasing answer and one pool for whatever stages host memory into
device buffers, instead of private copies that drift.

The pieces:

* ``STAGE_ALIGN`` / ``aligned_empty(nbytes, device)``: a staging
  buffer for an upload to ``device``.  For the CPU, the reference's
  buffer: uninitialised numpy bytes carved at a 64-byte-aligned offset
  of an oversized allocation (numpy only guarantees 16).  For a card,
  pinned host memory (a page-locked uint8 tensor from PyTorch's
  caching host allocator, page-aligned): the copy engine reads and
  writes it directly, with no bounce through CUDA's own staging, so a
  copy from it can be queued (``non_blocking``) while the host goes on.  Pinning
  that fails raises; pageable memory is never handed back in its
  place.
* ``runtime_zero_copy(device)``: whether ``torch.as_tensor`` of a host
  buffer onto ``device`` ALIASES it.  The reference probes its one
  runtime once a process; in torch the answer follows from the device
  type (the CPU aliases, a card with its own memory copies), and one
  process holds CPU and card ranks alike.
* ``MirrorPool``: a bounded free list of staging buffers, so steady-
  state staging never pays fresh pages or a fresh pinned allocation.
* ``d2h`` / ``h2d``: a tensor's bytes into a stage and back, queued on
  the current stream, with the event wait a pooled stage needs;
  ``d2h_async`` queues the D2H and hands back its event instead of
  waiting (pml/vprotocol's sender-log snapshot).

Its users: the hierarchical tier's leader hop (fresh stages a call),
and through ``pool(device)`` — one shared ``MirrorPool`` a device type
in the process — the cross-process device paths: btl/tpu's chunked
pull (every chunk D2H into a stage on the sender, into a stage and
H2D on the receiver) and ``HostArrModule``'s collectives on
communicators that span processes.  The port's plan tier and device
window do not stage through this module: ``torch.cat`` already makes
the pack's one copy, and a window's numpy buffer goes to and from the
card in one pageable copy, which a pinned stage plus its host memcpy
did not beat (PERF.md §5).

A pooled card stage must not be handed out again while a queued copy
still reads or writes it: PyTorch's caching host allocator waits on a
block's recorded copies only once the tensor is freed, and a stage the
pool keeps is never freed.  So a caller parks a stage only once its
copy is known complete.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Union

import numpy as np
import torch

#: staging alignment for uploads: the CPU aliases a 64-byte-aligned
#: host buffer instead of copying it
STAGE_ALIGN = 64

Stage = Union[np.ndarray, torch.Tensor]


def _type(device) -> str:
    if hasattr(device, "slot"):  # a LogicalDevice
        device = device.device
    return torch.device(device).type


def aligned_empty(nbytes: int, device="cpu") -> Stage:
    """Uninitialised staging bytes for an upload to ``device``: a numpy
    uint8 array whose data pointer is STAGE_ALIGN-aligned for the CPU,
    a pinned uint8 tensor (page-aligned) for a card.  Raises where the
    host memory cannot be pinned."""
    if _type(device) == "cpu":
        raw = np.empty(nbytes + STAGE_ALIGN, dtype=np.uint8)
        off = (-raw.ctypes.data) % STAGE_ALIGN
        return raw[off: off + nbytes]
    buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    if not buf.is_pinned():
        raise RuntimeError(f"a {nbytes}-byte staging buffer for {device} "
                           "could not be pinned")
    return buf


def runtime_zero_copy(device="cpu") -> bool:
    """Whether ``torch.as_tensor`` of a host buffer onto ``device``
    aliases it: True for the CPU, False for a card."""
    return _type(device) == "cpu"


class MirrorPool:
    """Bounded free list of staging buffers for one kind of device.

    ``take`` prefers the smallest parked buffer of sufficient capacity
    (sliced to the requested span — slicing from offset 0 preserves
    alignment) and falls back to a fresh ``aligned_empty``, counted in
    ``allocs``; ``park`` takes a slice back at the whole capacity of
    the buffer it was cut from and keeps at most ``max_buffers`` around
    so a pathological caller cannot hoard host memory — the largest
    ones: past the bound the smallest buffer drops to its allocator, so
    a warm pool fed a mixed ladder of sizes allocates nothing.
    Contents of a taken buffer are UNDEFINED — callers overwrite
    before use, exactly as with ``aligned_empty``.  Park a card stage
    only once no queued copy uses it."""

    __slots__ = ("_free", "_max", "_lock", "_device", "allocs")

    def __init__(self, max_buffers: int = 8, device="cpu") -> None:
        self._free: List[Stage] = []
        self._max = max(1, int(max_buffers))
        self._lock = threading.Lock()
        self._device = device
        #: fresh buffers ``take`` allocated (flat once the pool is warm)
        self.allocs = 0

    def take(self, nbytes: int) -> Stage:
        with self._lock:
            best = None
            for i, buf in enumerate(self._free):
                if buf.nbytes >= nbytes and (
                        best is None or buf.nbytes < self._free[best].nbytes):
                    best = i
            if best is not None:
                return self._free.pop(best)[:nbytes]
            self.allocs += 1
        return aligned_empty(nbytes, self._device)

    def park(self, buf: Optional[Stage]) -> None:
        if buf is None:
            return
        buf = _whole(buf)
        with self._lock:
            free = self._free
            if len(free) < self._max:
                free.append(buf)
                return
            small = min(range(len(free)), key=lambda i: free[i].nbytes)
            if free[small].nbytes < buf.nbytes:
                free[small] = buf


def _whole(buf: Stage) -> Stage:
    """A stage sliced from the start of a larger buffer, at the whole
    capacity of that buffer (its allocation from this slice's start);
    any other buffer as it is."""
    if isinstance(buf, torch.Tensor):
        store = buf.untyped_storage()
        if buf.storage_offset() == 0 and store.nbytes() > buf.nbytes:
            return torch.empty(0, dtype=torch.uint8).set_(store)
        return buf
    raw = buf.base
    if (isinstance(raw, np.ndarray) and raw.ndim == 1
            and raw.dtype == np.uint8 and raw.flags.c_contiguous
            and buf.flags.c_contiguous):
        return raw[buf.ctypes.data - raw.ctypes.data:]
    return buf


def host_view(stage: Stage) -> np.ndarray:
    """The stage's bytes as a numpy uint8 array (its own memory)."""
    return stage if isinstance(stage, np.ndarray) else stage.numpy()


def tensor_view(stage: Stage) -> torch.Tensor:
    """The stage's bytes as a uint8 tensor (its own memory)."""
    return torch.from_numpy(stage) if isinstance(stage, np.ndarray) \
        else stage


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat uint8 view."""
    t = t.reshape(-1)
    return t.view(torch.uint8) if t.numel() else \
        torch.empty(0, dtype=torch.uint8, device=t.device)


def d2h(src: torch.Tensor, stage: Stage) -> None:
    """Copy the bytes of the contiguous tensor ``src`` into the start of
    ``stage`` and return once they are there: for a card, a copy queued
    on the current stream and a wait on its event."""
    src = _bytes(src)
    dst = tensor_view(stage)[:src.numel()]
    if not src.is_cuda:
        dst.copy_(src)
        return
    dst.copy_(src, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(src.device))
    done.synchronize()


def d2h_async(src: torch.Tensor, stage: Stage):
    """Queue a copy of the bytes of the contiguous tensor ``src`` into
    the start of ``stage`` and return the event recorded after it: for
    a card, on the current stream of ``src``'s card (the host does not
    wait); off the card the copy is done on return and the result is
    None.  The stage must not be read before the event is done."""
    src = _bytes(src)
    dst = tensor_view(stage)[:src.numel()]
    if not src.is_cuda:
        dst.copy_(src)
        return None
    dst.copy_(src, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(src.device))
    return done


def h2d(stage: Stage, dst: torch.Tensor, wait: bool = False):
    """Copy the first bytes of ``stage`` into the contiguous tensor
    ``dst``.  For a card the copy is queued on the current stream and
    the event recorded after it is returned, waited on first when
    ``wait`` (a pooled stage may be parked only once that event is
    done); None off the card, where the copy is done on return."""
    dst = _bytes(dst)
    src = tensor_view(stage)[:dst.numel()]
    if not dst.is_cuda:
        dst.copy_(src)
        return None
    dst.copy_(src, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dst.device))
    if wait:
        done.synchronize()
    return done


_pools = {}
_pools_lock = threading.Lock()


def pool(device) -> MirrorPool:
    """The process's shared pool of stages for ``device``'s type (one
    for the CPU, one of pinned memory for the cards): every rank
    thread of a process takes from and parks into it."""
    kind = _type(device)
    with _pools_lock:
        p = _pools.get(kind)
        if p is None:
            p = _pools[kind] = MirrorPool(16, kind)
        return p

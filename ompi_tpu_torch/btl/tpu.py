"""Device-buffer point-to-point — the thread-world half of the
reference's ``btl/tpu`` shim (ompi_tpu/btl/tpu.py:33-55, 348-442).

Send and receive between co-located rank threads move the bytes
device to device: the sender writes the receiver's own copy of the
tensor on the receiver's device — a peer copy when the cards differ
(never a trip through the host), a copy on the card when both ranks
share it or own logical devices of it — and the copy rides the pml
as an opaque payload through the inproc btl, by reference.

Two things differ from the reference, whose jax arrays are immutable
and whose ``device_put`` may hand over the sender's own buffer:

* the receiver always gets a copy of its own, so a sender that writes
  into its tensor right after ``send_arr`` does not change what the
  receiver reads;
* the copy runs on the sender's current stream and the payload
  carries a CUDA event recorded after it; ``recv_arr`` makes the
  receiver's current stream wait on that event (the receiver may run
  on a side stream of its own) and keeps the tensor's memory alive on
  that stream.

A peer in another process (the reference's chunked pull,
``TpuRndvEngine``, and its host staging) is not ported: ``send_arr``
to such a peer raises (ROADMAP A8); nothing is staged through the
host in silence.

API (on Communicator): ``send_arr`` / ``recv_arr`` /
``sendrecv_arr``.  Ordering and matching are the pml's (the same
(cid, src, tag) discipline as byte messages).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ompi_tpu_torch import convert
from ompi_tpu_torch.pml.request import PROC_NULL


class DeviceArrayPayload:
    """Opaque pml payload carrying the receiver's copy of a tensor by
    reference, and the event that marks the end of the copy on the
    sender's stream (None off the card)."""

    __slots__ = ("arr", "event")

    def __init__(self, arr, event=None) -> None:
        self.arr = arr
        self.event = event

    def __len__(self) -> int:
        """Payload size in bytes (the pml envelope's total)."""
        a = self.arr
        if isinstance(a, torch.Tensor):
            return a.numel() * a.element_size()
        return int(np.asarray(a).nbytes)


def _peer_local_device(comm, dst: int) -> Tuple[bool, Any]:
    """(peer is a co-resident rank thread, its torch.device or None).
    Locality and device ownership are separate facts: a co-resident
    peer without a device still gets by-reference delivery."""
    world = getattr(comm.state.rte, "world", None)
    if world is None:
        return False, None
    gdst = comm.group[dst]
    if not world.is_local(gdst):
        return False, None
    peer_state = world.states[gdst]
    dev = getattr(peer_state, "device", None) \
        if peer_state is not None else None
    return True, dev


def _place(x, dev) -> Tuple[Any, Optional[torch.cuda.Event]]:
    """The receiver's own copy of ``x`` on ``dev`` (x's own device, or
    a numpy copy, when ``dev`` is None), written on the sender's
    current stream, and the event recorded after the copy when it
    lands on a card."""
    if not isinstance(x, torch.Tensor):
        if dev is None:
            return np.array(x, copy=True), None
        x = convert.to_torch(x, "cpu")
    if dev is not None and dev.type == "cuda" and x.is_cuda \
            and dev != x.device and not torch.cuda.can_device_access_peer(
                dev.index, x.device.index):
        raise RuntimeError(
            f"send_arr: {dev} cannot reach {x.device} by a peer copy, and "
            "the port does not stage device data through the host")
    out = torch.empty(x.shape, dtype=x.dtype,
                      device=x.device if dev is None else dev)
    out.copy_(x)
    if not out.is_cuda:
        return out, None
    # a copy between cards runs on the source card's current stream;
    # an upload on the destination card's
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(x.device if x.is_cuda
                                        else out.device))
    return out, ev


def send_arr(comm, x, dst: int, tag: int = 0) -> None:
    """Device-aware send: the receiver's own copy on the receiver's
    device, handed over by reference through the pml.  PROC_NULL
    destinations are no-ops (MPI semantics — cart.Shift edges)."""
    if dst == PROC_NULL:
        return
    local, pdev = _peer_local_device(comm, dst)
    if not local:
        raise NotImplementedError(
            f"send_arr to rank {dst}, which lives in another process: the "
            "port has no cross-process device transfer yet (ROADMAP A8) "
            "and does not stage device data through the host")
    arr, ev = _place(x, pdev)
    comm.state.pml.isend_obj(DeviceArrayPayload(arr, ev), dst, tag, comm)


def recv_arr(comm, src: int, tag: int = 0):
    """Matched receive of a device payload: the receiver's own copy,
    placed on this rank's device by the sender (a numpy array when the
    rank owns no device), ordered after the sender's copy on this
    rank's current stream."""
    if src == PROC_NULL:
        return None
    msg = comm.state.pml.recv_obj(src, tag, comm)
    payload = msg.payload
    if not isinstance(payload, DeviceArrayPayload):
        raise TypeError(
            f"recv_arr matched a non-device message (tag {tag} from "
            f"{src}); byte messages use Recv")
    arr = payload.arr
    if payload.event is not None:
        stream = torch.cuda.current_stream(arr.device)
        stream.wait_event(payload.event)
        arr.record_stream(stream)
    return arr


def sendrecv_arr(comm, x, dst: int, src: int, tag: int = 0):
    """Combined exchange (halo shifts): the send is an eager object,
    so posting it before the blocking receive is deadlock-free."""
    send_arr(comm, x, dst, tag)
    return recv_arr(comm, src, tag)

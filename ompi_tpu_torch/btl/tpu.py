"""Device-buffer point-to-point — the port of the reference's
``btl/tpu`` shim (ompi_tpu/btl/tpu.py).

Send and receive between co-located rank threads move the bytes
device to device: the sender writes the receiver's own copy of the
tensor on the receiver's device — a peer copy when the cards differ
(never a trip through the host), a copy on the card when both ranks
share it or own logical devices of it — and the copy rides the pml
as an opaque payload through the inproc btl, by reference.

Across a process boundary (a process rank, or a rank of another app
shell) the bytes go through the host, and only through pinned stages
(``runtime/staging.py``):

* a tensor of at most ``btl_tpu_chunk_bytes`` rides one object frag:
  the wire codec pickles the payload at the send, and its
  ``__getstate__`` copies the tensor D2H into a pinned stage on the
  current stream, waits on that copy's event and hands over numpy
  bytes — never a torch storage; the receiver uploads them from a
  pinned stage onto its device;
* a larger one takes the chunked pull (``TpuRndvEngine`` and
  ``_pull_transfer``, the pipelined-schedule analog of ref:
  ompi/mca/pml/ob1/pml_ob1_sendreq.c:404-453): the sender parks a
  snapshot and sends a header; the receiver posts its receives into
  pinned stages ``btl_tpu_pipeline_depth`` chunks ahead, then pulls.
  Each pull copies one chunk D2H into a pinned stage, waits on its
  event and hands the stage's numpy view to ``pml.isend``; a stage
  goes back to the pool when its send completes (``max_staged_bytes``
  counts them).  The receiver allocates the result once on its device
  and copies each chunk H2D into its slice (``non_blocking``); a stage
  is reused only after that copy's event.  Peak host memory on both
  sides is a few chunks, never the tensor.

A host-only receiver gets numpy, as in the reference.

Where the port differs from the reference, whose jax arrays are
immutable and whose ``device_put`` may hand over the sender's own
buffer:

* the receiver always gets a copy of its own, so a sender that writes
  into its tensor right after ``send_arr`` does not change what the
  receiver reads — across processes too: the chunked path snapshots
  the tensor on the current stream at the call;
* within a process the copy runs on the sender's current stream and
  the payload carries a CUDA event recorded after it; ``recv_arr``
  makes the receiver's current stream wait on that event (the receiver
  may run on a side stream of its own) and keeps the tensor's memory
  alive on that stream.

API (on Communicator): ``send_arr`` / ``recv_arr`` /
``sendrecv_arr``.  Ordering and matching are the pml's (the same
(cid, src, tag) discipline as byte messages).
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ompi_tpu_torch import convert
from ompi_tpu_torch.mca.params import registry as _mca
from ompi_tpu_torch.pml.request import PROC_NULL
from ompi_tpu_torch.runtime import staging

_chunk_var = _mca.register(
    "btl", "tpu", "chunk_bytes", 4 * 1024 * 1024, int,
    help="Cross-process device-array transfers larger than this are "
         "streamed in chunks of this size (bounded host staging); "
         "smaller ones ride one eager object frag")
_restore_grace_var = _mca.register(
    "btl", "tpu", "restore_grace_s", 300.0, float,
    help="Seconds a snapshot-restored parked transfer waits for its "
         "receiver's first pull before being garbage-collected (the "
         "receiver may have completed the pull before the snapshot "
         "was restored — an uncoordinated-capture race)")
_depth_var = _mca.register(
    "btl", "tpu", "pipeline_depth", 2, int,
    help="Chunks the receiver pulls ahead (overlaps d2h staging, "
         "wire transfer and h2d placement)")


def _dtype_name(x) -> str:
    """The dtype a header or payload names: ``torch.<name>`` for a
    tensor (bfloat16 has no numpy dtype), numpy's name otherwise."""
    return str(x.dtype) if isinstance(x, torch.Tensor) \
        else str(np.dtype(x.dtype))


def _dtypes(name: str) -> Tuple[Optional[torch.dtype], Optional[np.dtype]]:
    """(torch dtype, numpy dtype) of a named dtype; either may be None
    where that library has no such dtype."""
    if name.startswith("torch."):
        tdt = getattr(torch, name[len("torch."):])
        try:
            return tdt, convert.numpy_dtype(tdt)
        except (KeyError, ImportError, TypeError):
            return tdt, None
    npdt = np.dtype(name)
    try:
        return convert.torch_dtype(npdt), npdt
    except KeyError:
        return None, npdt


def _upload(raw: np.ndarray, tdt: torch.dtype, shape, dev) -> torch.Tensor:
    """Host bytes onto ``dev`` through a pinned stage: the bytes are
    copied into a fresh stage and uploaded with a queued copy (PyTorch's
    caching host allocator keeps the stage until that copy is done)."""
    out = torch.empty(shape, dtype=tdt, device=dev)
    if raw.nbytes:
        stage = staging.aligned_empty(raw.nbytes, dev)
        staging.host_view(stage)[:] = raw.reshape(-1).view(np.uint8)
        staging.h2d(stage, out)
    return out


class DeviceArrayPayload:
    """Opaque pml payload carrying the receiver's copy of a tensor by
    reference, and the event that marks the end of the copy on the
    sender's stream (None off the card).

    Within a process it is never serialized (inproc passes the
    object).  Crossing a process boundary the wire codec's pickle
    fallback invokes ``__getstate__``, which hands over host bytes:
    a card tensor is copied D2H into a pinned stage once its placement
    event is done — a torch storage is never pickled."""

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

    def __getstate__(self):
        a = self.arr
        if not isinstance(a, torch.Tensor):
            return {"np": np.asarray(a)}
        if self.event is not None:
            self.event.synchronize()
        a = a.detach().contiguous()
        nbytes = a.numel() * a.element_size()
        if a.device.type != "cpu":
            stage = staging.aligned_empty(nbytes, a.device)
            staging.d2h(a, stage)
            raw = staging.host_view(stage)[:nbytes]
        else:
            raw = a.reshape(-1).view(torch.uint8).numpy()
        return {"raw": raw, "dtype": str(a.dtype),
                "shape": tuple(a.shape)}

    def __setstate__(self, st) -> None:
        self.event = None
        if "np" in st:
            self.arr = st["np"]
            return
        # a tensor that crossed a process boundary: numpy where numpy
        # has the dtype, else the raw bytes and the dtype's name (the
        # receiver rebuilds the tensor from them)
        tdt, npdt = _dtypes(st["dtype"])
        raw = st["raw"]
        self.arr = raw.view(npdt).reshape(st["shape"]) \
            if npdt is not None else (raw, tdt, st["shape"])


# ---------------------------------------------------------------------------
# chunked cross-process rendezvous: a large tensor never host-stages
# whole.  The sender parks a snapshot in a registry and sends a small
# header; the receiver pulls chunks (a window of `pipeline_depth`
# ahead), each chunk D2H-staged at pull time, wired as an ordinary
# byte message, and H2D-placed on arrival.
# ---------------------------------------------------------------------------

T_PULL = -471            # pull-request object messages (any comm)
_DATA_BASE = -472_000    # chunk-data byte messages
_DATA_SPAN = 4096


class _XferHdr:
    """Rendezvous header: metadata only; rides the object channel
    with the USER tag so matching semantics are the pml's."""

    __slots__ = ("xfer_id", "shape", "dtype", "nbytes", "chunk")

    def __init__(self, xfer_id, shape, dtype, nbytes, chunk):
        self.xfer_id = xfer_id
        self.shape = shape
        self.dtype = dtype
        self.nbytes = nbytes
        self.chunk = chunk

    def __len__(self):
        return self.nbytes  # envelope total (probe/monitoring)


class _XferPull:
    """Receiver -> sender: stream chunks [start, start+count)."""

    __slots__ = ("xfer_id", "start", "count", "cid", "rank")

    def __init__(self, xfer_id, start, count, cid, rank):
        self.xfer_id = xfer_id
        self.start = start
        self.count = count
        self.cid = cid       # comm to send chunk data on
        self.rank = rank     # receiver's rank in that comm

    def __len__(self):
        return 32


class TpuRndvEngine:
    """Sender-side service: pending transfers + pull handling inside
    the progress loop.  ``max_staged_bytes`` is the high-water mark
    of live host-staged chunk bytes — tests assert the bound.

    A pending entry is ``[flat, sent, nchunks, per, event]``: the
    snapshot (a flat tensor, or a numpy array for a host sender or a
    restored entry), the chunks handed out, the chunk count, elements
    a chunk, and the CUDA event after the snapshot's copy (None off the
    card)."""

    def __init__(self, state) -> None:
        self.state = state
        self._xfer_ids = itertools.count(1)
        self.pending: Dict[int, list] = {}
        self._inflight: list = []             # (req, nbytes, stage)
        self._restored: Dict[int, float] = {}  # xid -> restore stamp
        self._gc_tombstones: set = set()       # grace-GC'd xids
        self.staged_bytes = 0
        self.max_staged_bytes = 0
        state.progress.register(self.progress, low_priority=True)

    def begin_send(self, flat, event=None) -> int:
        xid = next(self._xfer_ids)
        # chunking is in ELEMENTS (both sides derive the same count
        # from the header's chunk-bytes and the dtype): a byte-based
        # count loses tail elements whenever itemsize does not divide
        # chunk_bytes
        itemsize = flat.element_size() if isinstance(flat, torch.Tensor) \
            else flat.dtype.itemsize
        n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
        per = max(1, _chunk_var.value // itemsize)
        nchunks = -(-int(n) // per)
        self.pending[xid] = [flat, 0, nchunks, per, event]
        return xid

    def ft_reset(self) -> None:
        """Epoch reset: every pre-epoch transfer is dead — the pml
        sequence space restarted, so the _XferHdr naming a pending
        entry will never be replayed, and a post-recovery xid colliding
        with a stale entry would hand the new receiver the OLD array.
        Drop everything and re-seed the id space past every xid this
        incarnation ever issued."""
        top = 0
        for xid in self.pending:
            top = max(top, xid)
        for xid in self._gc_tombstones:
            top = max(top, xid)
        # the counter itself may be past any surviving table entry
        # (completed transfers leave no trace): peek without consuming
        nxt = next(self._xfer_ids)
        top = max(top, nxt - 1)
        self.pending.clear()
        self._restored.clear()
        self._gc_tombstones.clear()
        self._inflight = []
        self.staged_bytes = 0
        self._xfer_ids = itertools.count(top + 1)

    def _reap(self) -> int:
        n = 0
        alive = []
        for req, nb, stage in self._inflight:
            if req.complete:
                self.staged_bytes -= nb
                if stage is not None:
                    stage[1].park(stage[0])
                n += 1
            else:
                alive.append((req, nb, stage))
        self._inflight = alive
        return n

    def cr_capture(self, lenient: bool = False) -> list:
        """Snapshot parked (not-yet-pulled) transfers: the data half
        of any _XferHdr a peer's cr_capture snapshots.  A partially
        pulled transfer cannot exist at a QUIESCED checkpoint — the
        puller would still be inside recv_arr, which no rank can be
        during a collective checkpoint — so there it is a protocol bug
        worth a loud failure.  The UNCOORDINATED path (``lenient``)
        snapshots a transfer mid-pull with its FULL parked data and a
        reset cursor (a restarted receiver re-pulls from chunk 0).
        Entries carry host copies (numpy; a tensor's bytes once its
        snapshot event is done)."""
        out = []
        for xid, (flat, sent, nchunks, per, ev) in sorted(
                self.pending.items()):
            if sent and not lenient:
                raise RuntimeError(
                    "cr_capture with a partially pulled device "
                    "transfer (receiver mid-recv_arr at quiesce?)")
            if ev is not None:
                ev.synchronize()
            host = convert.to_numpy(flat) \
                if isinstance(flat, torch.Tensor) else np.asarray(flat)
            out.append((xid, host, nchunks, per))
        return out

    def cr_restore(self, entries: list) -> None:
        top = 0
        now = time.monotonic()
        for xid, arr, nchunks, per in entries:
            self.pending[xid] = [np.asarray(arr).reshape(-1), 0,
                                 nchunks, per, None]
            # a snapshot may predate the receiver FINISHING its pull
            # (uncoordinated capture): a restored entry no peer ever
            # claims would otherwise hold its host-staged array
            # forever.  Stamp it; progress GCs unclaimed restored
            # entries after restore_grace_s
            self._restored[xid] = now
            top = max(top, xid)
        if top:
            self._xfer_ids = itertools.count(top + 1)

    def _stage_chunk(self, flat, lo: int, hi: int, ev):
        """One chunk as a host buffer for ``pml.isend``: a numpy slice
        of a host snapshot as it is (no copy), a tensor's bytes copied
        into a stage of the shared pool (D2H and its event wait on a
        card).  Returns (buffer, nbytes, (stage, pool) or None)."""
        if not isinstance(flat, torch.Tensor):
            piece = np.ascontiguousarray(flat[lo:hi]).view(np.uint8)
            return piece, piece.nbytes, None
        src = flat[lo:hi]
        nb = src.numel() * src.element_size()
        pool = staging.pool(flat.device)
        stage = pool.take(nb)
        if ev is not None:
            torch.cuda.current_stream(flat.device).wait_event(ev)
        staging.d2h(src, stage)
        return staging.host_view(stage)[:nb], nb, (stage, pool)

    def progress(self) -> int:
        pml = self.state.pml
        n = self._reap()
        if self._restored:
            now = time.monotonic()
            for xid in [x for x, t in self._restored.items()
                        if now - t > _restore_grace_var.value]:
                del self._restored[xid]
                self.pending.pop(xid, None)  # unclaimed: receiver had
                #                              already completed its
                #                              pull before the snapshot
                #                              was restored
                self._gc_tombstones.add(xid)
        while True:
            msg = pml.poll_obj_any(T_PULL)
            if msg is None:
                break
            n += 1
            pull: _XferPull = msg.payload
            entry = self.pending.get(pull.xfer_id)
            self._restored.pop(pull.xfer_id, None)  # claimed: live
            if entry is None:
                if pull.xfer_id in self._gc_tombstones:
                    # the restore-grace GC dropped this transfer as
                    # unclaimed, but the receiver's re-pull was just
                    # slow: the data is gone — say so loudly so the
                    # receiver's hang is diagnosable
                    import sys
                    sys.stderr.write(
                        f"btl_tpu: pull for restored transfer "
                        f"{pull.xfer_id} arrived after the "
                        f"restore-grace GC discarded it; the "
                        f"receiver's recv_arr cannot complete "
                        f"(raise btl_tpu_restore_grace_s)\n")
                continue  # duplicate/late pull
            flat, _, nchunks, per, ev = entry
            comm = self.state.comms.get(pull.cid)
            tag = _DATA_BASE - (pull.xfer_id % _DATA_SPAN)
            from ompi_tpu_torch.datatype import engine as dtmod
            size = flat.numel() if isinstance(flat, torch.Tensor) \
                else flat.size
            for i in range(pull.start, pull.start + pull.count):
                buf, nb, stage = self._stage_chunk(
                    flat, i * per, min(size, (i + 1) * per), ev)
                self.staged_bytes += nb
                self.max_staged_bytes = max(self.max_staged_bytes,
                                            self.staged_bytes)
                req = pml.isend(buf, nb, dtmod.BYTE, pull.rank, tag, comm)
                self._inflight.append((req, nb, stage))
            entry[1] = max(entry[1], pull.start + pull.count)
            if entry[1] >= nchunks:
                # all chunks handed to the pml: the snapshot may go
                self.pending.pop(pull.xfer_id, None)
        return n


def _engine(state) -> TpuRndvEngine:
    eng = getattr(state, "_tpu_rndv", None)
    if eng is None:
        eng = TpuRndvEngine(state)
        state._tpu_rndv = eng
    return eng


def _pull_transfer(comm, src: int, hdr: _XferHdr):
    """Receiver side: window-ahead pulls.  With a device, each chunk
    lands in a pinned stage of the shared pool and is copied H2D into
    its slice of the result (allocated once on this rank's device; a
    stage is parked once its copy's event is done); a host-only rank
    receives straight into its numpy result."""
    from ompi_tpu_torch.datatype import engine as dtmod
    pml = comm.state.pml
    tag = _DATA_BASE - (hdr.xfer_id % _DATA_SPAN)
    tdt, npdt = _dtypes(hdr.dtype)
    itemsize = torch.empty((), dtype=tdt).element_size() \
        if tdt is not None else npdt.itemsize
    per = max(1, hdr.chunk // itemsize)
    total_elems = hdr.nbytes // itemsize
    nchunks = -(-total_elems // per)
    depth = max(1, _depth_var.value)
    dev = comm.state.device
    if dev is None:
        if npdt is None:
            raise TypeError(
                f"recv_arr: a {tdt} tensor has no numpy form for a rank "
                "that owns no device")
        out = np.empty(total_elems, npdt)
        out_u8 = out.view(np.uint8)
        pool = None
    else:
        out = torch.empty(total_elems, dtype=tdt, device=dev)
        out_u8 = out.view(torch.uint8)
        pool = staging.pool(dev)
    posted: Dict[int, tuple] = {}
    uploading: list = []  # (event, stage): H2D copies still reading
    pulled = 0

    def reclaim(block: bool) -> None:
        keep = []
        for ev, stage in uploading:
            if block:
                ev.synchronize()
            if block or ev.query():
                pool.park(stage)
            else:
                keep.append((ev, stage))
        uploading[:] = keep

    def pull_upto(limit: int) -> None:
        nonlocal pulled
        limit = min(limit, nchunks)
        if limit <= pulled:
            return
        # post the recvs BEFORE requesting: chunk data then lands in
        # posted buffers, never the unexpected queue
        for i in range(pulled, limit):
            lo = i * per * itemsize
            hi = min(total_elems, (i + 1) * per) * itemsize
            if pool is None:
                stage, buf = None, out_u8[lo:hi]
            else:
                if uploading:
                    reclaim(False)
                stage = pool.take(hi - lo)
                buf = staging.host_view(stage)[:hi - lo]
            req = pml.irecv(buf, hi - lo, dtmod.BYTE, src, tag, comm)
            posted[i] = (req, stage, lo, hi)
        pml.isend_obj(
            _XferPull(hdr.xfer_id, pulled, limit - pulled, comm.cid,
                      comm.rank), src, T_PULL, comm)
        pulled = limit

    pull_upto(depth)
    for i in range(nchunks):
        pull_upto(i + 1 + depth)  # keep the window full
        req, stage, lo, hi = posted.pop(i)
        req.wait()
        if stage is None:
            continue
        ev = staging.h2d(stage, out_u8[lo:hi])
        if ev is None:
            pool.park(stage)
        else:
            uploading.append((ev, stage))
    if uploading:
        reclaim(True)
    return out.reshape(hdr.shape)


def _peer_local_device(comm, dst: int) -> Tuple[bool, Any]:
    """(peer is a co-resident rank thread, its torch.device or None).
    Locality and device ownership are separate facts: a co-resident
    peer without a device still gets by-reference delivery."""
    world = getattr(comm.state.rte, "world", None)
    gdst = comm.group[dst]
    if world is None:  # a process rank: only itself is local
        return (True, comm.state.device) if gdst == comm.state.rank \
            else (False, None)
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


def _send_remote(comm, x, dst: int, tag: int) -> None:
    """``send_arr`` to a rank in another process: one object frag up to
    ``btl_tpu_chunk_bytes`` (pickled at this call), else the chunked
    pull of a snapshot taken now, on the current stream."""
    if not isinstance(x, torch.Tensor) and (
            not hasattr(x, "nbytes") or not hasattr(x, "reshape")):
        x = np.asarray(x)  # lists/tuples: one materialization
    if isinstance(x, torch.Tensor):
        nbytes = x.numel() * x.element_size()
        chunkable = True
    else:
        nbytes = int(x.nbytes)
        dt = np.dtype(x.dtype)
        chunkable = dt.fields is None and not dt.hasobject \
            and np.dtype(str(dt)) == dt
    if nbytes <= _chunk_var.value or not chunkable:
        if isinstance(x, np.ndarray):
            x = x.copy()
        comm.state.pml.isend_obj(DeviceArrayPayload(x), dst, tag, comm)
        return
    # the chunked rendezvous: the data stays where it is until the
    # receiver pulls, so the sender's tensor is snapshotted here (a
    # torch tensor is mutable: a write after send_arr must not reach
    # the receiver), and a host array is copied once
    ev = None
    if isinstance(x, torch.Tensor):
        flat = x.detach().reshape(-1).clone()
        if flat.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(flat.device))
    else:
        flat = x.reshape(-1).copy()
    xid = _engine(comm.state).begin_send(flat, ev)
    hdr = _XferHdr(xid, tuple(x.shape), _dtype_name(x), nbytes,
                   _chunk_var.value)
    comm.state.pml.isend_obj(hdr, dst, tag, comm)


def send_arr(comm, x, dst: int, tag: int = 0) -> None:
    """Device-aware send: the receiver's own copy on the receiver's
    device, handed over by reference through the pml when the peer is
    a rank thread of this process; host-staged through pinned memory
    otherwise.  PROC_NULL destinations are no-ops (MPI semantics —
    cart.Shift edges)."""
    if dst == PROC_NULL:
        return
    local, pdev = _peer_local_device(comm, dst)
    if not local:
        _send_remote(comm, x, dst, tag)
        return
    arr, ev = _place(x, pdev)
    comm.state.pml.isend_obj(DeviceArrayPayload(arr, ev), dst, tag, comm)


def recv_arr(comm, src: int, tag: int = 0):
    """Matched receive of a device payload: the receiver's own copy on
    this rank's device (a numpy array when the rank owns no device) —
    placed by a sender in this process and ordered after its copy on
    this rank's current stream, or uploaded from a pinned stage when
    it crossed a process boundary."""
    if src == PROC_NULL:
        return None
    msg = comm.state.pml.recv_obj(src, tag, comm)
    payload = msg.payload
    if isinstance(payload, _XferHdr):
        return _pull_transfer(comm, msg.src, payload)
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
    dev = comm.state.device
    if isinstance(arr, tuple):  # raw bytes of a dtype numpy lacks
        raw, tdt, shape = arr
        if dev is None:
            raise TypeError(
                f"recv_arr: a {tdt} tensor has no numpy form for a rank "
                "that owns no device")
        return _upload(raw, tdt, shape, dev)
    if dev is not None and isinstance(arr, np.ndarray):
        # it crossed a process boundary, or it is a vprotocol replay's
        # host copy: onto this rank's device
        return _upload(np.ascontiguousarray(arr),
                       convert.torch_dtype(arr.dtype), arr.shape, dev)
    if dev is not None and isinstance(arr, torch.Tensor) \
            and arr.device.type == "cpu" and dev.type != "cpu":
        # a vprotocol replay's host copy of a dtype numpy lacks
        return arr.to(dev)
    return arr


def sendrecv_arr(comm, x, dst: int, src: int, tag: int = 0):
    """Combined exchange (halo shifts): the send is an eager object,
    so posting it before the blocking receive is deadlock-free."""
    send_arr(comm, x, dst, tag)
    return recv_arr(comm, src, tag)

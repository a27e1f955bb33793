"""pml/vprotocol pessimist: sender-based message logging.

Port of the reference's pml/vprotocol.py, a re-design of
ompi/mca/vprotocol/pessimist (ref: vprotocol_pessimist.c,
vprotocol_pessimist_sender_based.c — a pml wrapper that logs every
outgoing message so checkpoints need no global coordination: the logs
reconstruct whatever the restart cut line left in flight).  The
coordinated C/R stack requires a full quiesce (crcp/bkmrk drain)
before every snapshot; with this component enabled a rank may snapshot
at its own moment — messages mid-wire at the cut are REPLAYED from the
sender's log on restart, and the receiver's restored per-(cid,src)
sequence counters drop whatever it had already consumed (exactly-once
redelivery from the envelope stream's own ordering).

What is logged: every sequence-numbered envelope (eager, sync-eager,
rendezvous, object) with its FULL packed payload, user and internal
tags alike — the sequence space is shared, so a replay gap anywhere
would wedge the channel.  ACK/FRAG protocol messages carry no
sequence and are regenerated by the protocol itself.

Device payloads (``send_arr``): the pml carries the receiver's own
copy of the tensor by reference, and the receiver may write into it
after delivery, so the log never keeps a reference to it.  It takes
its own snapshot (``_Snapshot``): a D2H copy into a pinned stage,
queued on the card's current stream behind the placement event, never
a blocking host copy on the send path; the payload's event becomes
the one recorded after that copy, so the receiver's later writes are
ordered behind the snapshot's read.  ``log_bytes`` counts the
snapshot; ``cr_capture_vlog`` and ``replay`` wait on its event before
they read it.  A replay hands the receiver a fresh host copy, which
``recv_arr`` uploads onto the receiver's device.  A chunked
cross-process send logs its ``_XferHdr`` only: the data is the
rendezvous engine's parked snapshot, which ``cr.checkpoint_local``'s
lenient capture holds.

Garbage collection (ref: vprotocol_pessimist_sender_based.c): two
mechanisms.  A COORDINATED checkpoint (cr.checkpoint's quiesce proves
every logged message consumed) clears the whole log.  In steady state,
RECEIVER ACKS trim it: each rank's pessimist layer periodically sends
every sender its consumed-sequence watermark (next_seq) per channel,
riding the btl UNSEQUENCED (an ack through the sequenced send path
would itself need logging); the sender drops log entries below the
watermark.  ``vprotocol_pessimist_log_max_mb`` remains the hard cap,
failing loudly on overflow rather than silently dropping replay
coverage — with GC it is reached only when a receiver stops consuming
(or acking) entirely.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ompi_tpu_torch.mca.params import registry

enable_var = registry.register(
    "pml", "vprotocol", "", "", str,
    help="Set to 'pessimist' to interpose sender-based message "
         "logging over the selected pml (uncoordinated checkpoints; "
         "ref: ompi/mca/vprotocol/pessimist)")
_log_max_var = registry.register(
    "vprotocol", "pessimist", "log_max_mb", 256, int,
    help="Sender log cap; exceeding it raises (coverage must never "
         "silently end)")
_ack_interval_var = registry.register(
    "vprotocol", "pessimist", "ack_interval_s", 0.25, float,
    help="How often a receiver acks its consumed-sequence watermarks "
         "to senders so their logs trim in steady state (receiver-ack "
         "GC; 0 disables)")
_ack_refresh_var = registry.register(
    "vprotocol", "pessimist", "ack_refresh_ticks", 8, int,
    help="Every Nth ack tick re-sends the latest watermark even if "
         "already recorded as acked, so one lost ack cannot stall a "
         "log-capped sender until the next checkpoint (0 disables)")


class _Snapshot:
    """The sender log's own copy of a tensor payload: its bytes in a
    stage (a pinned one for a card tensor, filled by a queued D2H; host
    bytes otherwise), the event recorded after that copy (None once the
    bytes are known to be there), and the tensor's dtype name and
    shape.  Pickles as host bytes (``cr_capture_vlog``'s image)."""

    __slots__ = ("stage", "event", "dtype", "shape", "nbytes")

    def __init__(self, arr, after=None) -> None:
        from ompi_tpu_torch.runtime import staging
        a = arr.detach()
        self.dtype = str(a.dtype)
        self.shape = tuple(a.shape)
        self.nbytes = a.numel() * a.element_size()
        self.stage = staging.aligned_empty(self.nbytes, a.device)
        if a.is_cuda and after is not None:
            # the placement first, then the copy (and the reorder of a
            # non-contiguous tensor) on the same stream
            import torch
            torch.cuda.current_stream(a.device).wait_event(after)
        self.event = staging.d2h_async(a.contiguous(), self.stage)

    def wait(self) -> np.ndarray:
        """The logged bytes (a uint8 view of the stage), once the copy
        into it is done."""
        from ompi_tpu_torch.runtime import staging
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        return staging.host_view(self.stage)[:self.nbytes]

    def payload(self):
        """A fresh host copy for a replay: numpy where numpy has the
        dtype, else a CPU tensor (``recv_arr`` uploads either onto the
        receiver's device).  Never an alias of the log."""
        import torch
        from ompi_tpu_torch.btl.tpu import _dtypes
        raw = self.wait().copy()
        tdt, npdt = _dtypes(self.dtype)
        if npdt is not None:
            return raw.view(npdt).reshape(self.shape)
        return torch.from_numpy(raw).view(tdt).reshape(self.shape)

    def __len__(self) -> int:
        return self.nbytes

    def __getstate__(self):
        return {"raw": self.wait().copy(), "dtype": self.dtype,
                "shape": self.shape}

    def __setstate__(self, st) -> None:
        self.stage = st["raw"]
        self.event = None
        self.dtype = st["dtype"]
        self.shape = tuple(st["shape"])
        self.nbytes = int(self.stage.nbytes)


def _logged_obj(obj):
    """What the log keeps of an object payload: a snapshot of a tensor
    payload (the payload's event moves to the one after the snapshot's
    copy), a copy of a numpy one, the object itself otherwise (a
    chunked transfer's header, a pull request)."""
    arr = getattr(obj, "arr", None)
    if arr is None:
        return obj
    if hasattr(arr, "detach"):
        snap = _Snapshot(arr, getattr(obj, "event", None))
        if snap.event is not None:
            obj.event = snap.event
        return snap
    return np.array(arr, copy=True)


def _size(payload) -> int:
    try:
        return int(payload.nbytes) if hasattr(payload, "nbytes") \
            else len(payload)
    except TypeError:
        return 0


class VprotocolPessimist:
    """Wraps the real pml; mirrors every sequenced send into the
    per-peer log.  Delegation mirrors pml/monitoring's interposition
    discipline: instrument the send surface, pass everything else
    through untouched."""

    def __init__(self, pml, state) -> None:
        self._pml = pml
        self._state = state
        # the matching engine at the bottom of the wrapper stack:
        # sequence maps must be read AND WRITTEN there (a setattr on
        # an interposer would only shadow them)
        base = pml
        while hasattr(base, "_pml"):
            base = base._pml
        self._base = base
        # (cid, dst_global) -> [(seq, tag, src_local, kind, payload)]
        self.log: Dict[Tuple[int, int], List[tuple]] = {}
        self.log_bytes = 0
        # receiver-ack GC state
        self._base.vack_handler = self._on_ack
        self._acked: Dict[Tuple[int, int], int] = {}  # sent watermarks
        self._durable: Dict[Tuple[int, int], int] = {}
        self._ack_t = 0.0
        self._ack_round = 0
        state.progress.register(self._ack_progress, low_priority=True)

    # -- logging send surface -------------------------------------------
    def _log(self, comm, dst: int, tag: int, kind: str,
             payload) -> None:
        key = (comm.cid, dst)
        seq = self._base._send_seq.get(key, 0)  # seq the send WILL use
        self.log_bytes += _size(payload)
        if self.log_bytes > _log_max_var.value * (1 << 20):
            raise MemoryError(
                "vprotocol/pessimist sender log exceeded "
                "vprotocol_pessimist_log_max_mb — checkpoint (the "
                "coordinated path clears it) or raise the cap")
        # keyed by GLOBAL destination so replay needs no live comm
        # object for sub-communicators; src_local recorded because the
        # wire envelope carries comm-local ranks
        gkey = (comm.cid, comm.group[dst])
        self.log.setdefault(gkey, []).append(
            (seq, tag, comm.rank, kind, payload))

    def isend(self, buf, count, datatype, dst, tag, comm, *a, **kw):
        from ompi_tpu_torch.datatype.convertor import make_convertor
        from ompi_tpu_torch.pml.request import PROC_NULL
        if dst != PROC_NULL:
            offset = kw.get("offset", a[1] if len(a) > 1 else 0)
            conv = make_convertor(datatype, count, buf, offset=offset)
            self._log(comm, dst, tag, "bytes", conv.pack_bytes())
        return self._pml.isend(buf, count, datatype, dst, tag, comm,
                               *a, **kw)

    def send(self, buf, count, datatype, dst, tag, comm, *a, **kw):
        return self.isend(buf, count, datatype, dst, tag, comm,
                          *a, **kw).wait()

    def isend_obj(self, obj, dst, tag, comm):
        from ompi_tpu_torch.pml.request import PROC_NULL
        if dst != PROC_NULL:
            self._log(comm, dst, tag, "obj", _logged_obj(obj))
        return self._pml.isend_obj(obj, dst, tag, comm)

    # -- receiver-ack GC -------------------------------------------------
    def mark_durable(self, captured_next_seq: Dict,
                     replay_want) -> None:
        """Called by checkpoint_local AFTER its snapshot is durably on
        disk: everything the snapshot covers no longer needs sender
        logs for my restart — those watermarks are what acks may
        carry.  Two exclusions make the watermark exact:

          * the LIVE next_seq is wrong (messages consumed since the
            capture roll back on restart) — use the CAPTURED map;
          * sequence slots burned by arrived-but-unconsumed messages
            (the snapshot's replay_want) are NOT durable: the payload
            lives only in the sender's log — the watermark stops at
            the lowest wanted seq per channel."""
        durable = {tuple(k) if not isinstance(k, tuple) else k: v
                   for k, v in captured_next_seq.items()}
        for w in replay_want:
            cid, src, seq = w
            key = (cid, src)
            if key in durable:
                durable[key] = min(durable[key], seq)
        self._durable = durable

    def _ack_progress(self) -> int:
        """Low-priority progress hook: every ``ack_interval_s``, tell
        each sender the snapshot-durable consumed watermark of every
        channel that advanced since the last ack, so its log trims
        without a coordinated checkpoint."""
        import time

        iv = _ack_interval_var.value
        if iv <= 0 or not self._durable:
            return 0
        now = time.monotonic()
        if now - self._ack_t < iv:
            return 0
        self._ack_t = now
        # an ack travels best-effort: the endpoint send can succeed
        # locally yet the frame die on the wire, leaving the sender's
        # log pinned until the next checkpoint.  Every Nth tick the
        # "already acked" skip is bypassed so the newest watermark is
        # re-sent — acks are idempotent.
        self._ack_round += 1
        rv = _ack_refresh_var.value
        refresh = rv > 0 and self._ack_round % rv == 0
        per_sender: Dict[int, list] = {}
        me = self._state.rank
        for (cid, src_local), nseq in self._durable.items():
            if not refresh and \
                    self._acked.get((cid, src_local), -1) >= nseq:
                continue
            comm = self._state.comms.get(cid)
            if comm is None or src_local >= len(comm.group):
                continue
            gsrc = comm.group[src_local]
            if gsrc == me:
                continue
            per_sender.setdefault(gsrc, []).append(
                (cid, src_local, nseq))
        n = 0
        for gsrc, acks in per_sender.items():
            try:
                ep = self._base._ep(gsrc)
                from .ob1 import VACK
                # (cid, my_global_rank, consumed_next_seq): the
                # sender's log key is (cid, receiver_global); entry
                # seqs share the per-(cid, channel) space next_seq
                # counts
                ep.send((VACK, [(cid, me, nseq)
                                for cid, _s, nseq in acks]))
            except (RuntimeError, IndexError, OSError):
                continue  # no route yet: retry next tick, unacked
            # watermark committed only AFTER the ack is on the wire —
            # recording it first would silently drop the ack forever
            # on a transient endpoint failure
            for cid, src_local, nseq in acks:
                self._acked[(cid, src_local)] = nseq
            n += 1
        return n

    def _on_ack(self, acks) -> None:
        """Sender side: drop fully-consumed log entries."""
        for cid, rglobal, nseq in acks:
            key = (cid, rglobal)
            entries = self.log.get(key)
            if not entries:
                continue
            keep = []
            for e in entries:
                if e[0] < nseq:
                    self.log_bytes -= _size(e[4])
                else:
                    keep.append(e)
            if keep:
                self.log[key] = keep
            else:
                del self.log[key]

    def ft_reset(self) -> None:
        """Live-recovery epoch reset: pre-epoch log entries are keyed
        by sequence numbers the reset wipes — a later replay would
        re-inject them into the restarted sequence space, and the GC
        watermarks could never trim them.  The snapshot every rank
        reloads is the recovery cut line; the log restarts with it."""
        self.log.clear()
        self.log_bytes = 0
        self._acked.clear()
        self._durable.clear()
        self._pml.ft_reset()

    # -- log lifecycle ---------------------------------------------------
    def clear_log(self) -> None:
        """Called by the coordinated checkpoint after quiesce: every
        logged message is provably consumed."""
        self.log.clear()
        self.log_bytes = 0

    def cr_capture_vlog(self) -> dict:
        """Snapshot: the log plus BOTH sequence maps — uncoordinated
        restart continues the sequence spaces instead of resetting
        them (the coordinated path's reset assumes a drained wire).
        A tensor snapshot's copy is waited on here; it pickles as host
        bytes."""
        out = {}
        for key, entries in self.log.items():
            ser = []
            for seq, tag, src_local, kind, payload in entries:
                if isinstance(payload, _Snapshot):
                    payload.wait()
                elif kind == "obj" and isinstance(payload, np.ndarray):
                    kind = "nparr"
                ser.append((seq, tag, src_local, kind, payload))
            out[key] = ser
        return {"log": out,
                "send_seq": dict(self._base._send_seq),
                "next_seq": dict(self._base._next_seq)}

    def cr_restore_vlog(self, blob: dict) -> None:
        self.log = {tuple(k) if not isinstance(k, tuple) else k: list(v)
                    for k, v in blob["log"].items()}
        self.log_bytes = sum(_size(p) for es in self.log.values()
                             for (_, _, _, _, p) in es)
        self._base._send_seq = {
            tuple(k) if not isinstance(k, tuple) else k: v
            for k, v in blob["send_seq"].items()}
        self._base._next_seq = {
            tuple(k) if not isinstance(k, tuple) else k: v
            for k, v in blob["next_seq"].items()}

    def replay(self) -> int:
        """Resend every logged envelope — ALL communicators — with
        its ORIGINAL sequence number; receivers drop the prefix they
        already consumed (seq < restored next_seq) and accept the
        rest in order — the in-flight window at the cut line is
        exactly re-delivered.  Sub-communicator entries rely on the
        app recreating the comm deterministically (same cid from the
        same collective call sequence).  Returns messages resent."""
        import pickle

        from ompi_tpu_torch.btl.tpu import DeviceArrayPayload
        from .ob1 import MATCH, MATCH_OBJ
        n = 0
        gsrc = self._state.rank
        for (cid, gdst), entries in sorted(self.log.items()):
            ep = self._base._ep(gdst)
            btl = ep.btl
            # a single frame must fit the transport (the shm ring
            # rejects frames it can NEVER hold); payloads past the
            # eager limit are replayed as position-addressed MSEG
            # segments and reassembled before matching
            limit = btl.eager_limit
            seg_sz = btl.max_send_size
            for seq, tag, src_local, kind, payload in sorted(
                    entries, key=lambda e: e[0]):
                if kind in ("obj", "nparr"):
                    # a fresh host copy a replay: by reference within
                    # a process, the receiver must never alias the log
                    if isinstance(payload, _Snapshot):
                        obj = DeviceArrayPayload(payload.payload())
                    elif isinstance(payload, np.ndarray):
                        obj = DeviceArrayPayload(
                            np.array(payload, copy=True))
                    else:
                        obj = payload
                    # threshold on the payload's own size (len = the
                    # envelope total): pickling just to measure would
                    # host-stage every logged payload per replay.
                    # Objects without __len__ take the segmented path,
                    # which measures the real pickled size.
                    try:
                        size = len(obj)
                    except TypeError:
                        size = limit + 1
                    if size <= limit:
                        ep.send((MATCH_OBJ, cid, src_local, tag, seq,
                                 gsrc, obj))
                    else:
                        blob = pickle.dumps(
                            obj, protocol=pickle.HIGHEST_PROTOCOL)
                        self._replay_seg(ep, cid, src_local, tag, seq,
                                         gsrc, 1, blob, seg_sz)
                else:
                    data = bytes(payload)
                    if len(data) <= limit:
                        ep.send((MATCH, cid, src_local, tag, seq,
                                 gsrc, data))
                    else:
                        self._replay_seg(ep, cid, src_local, tag, seq,
                                         gsrc, 0, data, seg_sz)
                n += 1
        return n

    @staticmethod
    def _replay_seg(ep, cid, src, tag, seq, gsrc, kindcode,
                    data: bytes, seg_sz: int) -> None:
        from .ob1 import MSEG
        total = len(data)
        for pos in range(0, total, seg_sz):
            ep.send((MSEG, cid, src, tag, seq, gsrc, total, kindcode,
                     pos, data[pos:pos + seg_sz]))

    # everything else passes straight through
    def __getattr__(self, name):
        return getattr(self._pml, name)


def maybe_wrap(pml, state):
    if registry.lookup("pml", "vprotocol", "", "") == "pessimist":
        return VprotocolPessimist(pml, state)
    return pml


def find(pml):
    """The pessimist layer inside a (possibly multiply wrapped) pml,
    or None."""
    seen = set()
    cur = pml
    while cur is not None and id(cur) not in seen:
        if isinstance(cur, VprotocolPessimist):
            return cur
        seen.add(id(cur))
        cur = getattr(cur, "_pml", None)
    return None

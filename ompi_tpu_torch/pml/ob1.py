"""PML ob1: the point-to-point matching + protocol engine.

Re-design of ompi/mca/pml/ob1 (protocol ladder ref:
pml_ob1_sendreq.h:354-399 and pml_ob1_sendreq.c:404-453,667,716-747;
matching ref: pml_ob1_recvfrag.c:102-186,510-558 — posted-recv queues,
unexpected queue, per-peer sequence ordering with a cant-match list).

Protocols:
  * eager  — packed payload ≤ btl.eager_limit rides in one MATCH frag;
    the send request completes locally (buffered semantics).
  * eager-sync — MATCH_SYNC requires a SYNC_ACK on match (MPI_Ssend).
  * rendezvous — RNDV carries the first eager_limit bytes + total
    size + sender request id; the receiver matches, unpacks the head,
    replies ACK; the sender streams the rest as FRAG segments of
    max_send_size, each positioned by packed offset (pipelined through
    the resumable convertor; the reference's RDMA PUT/GET schedule
    collapses to this because co-located ranks share memory and
    remote ones go through a streaming transport).

Concurrency model: actor-style.  All matching state belongs to the
owning rank; peers only append to ``inbox`` (a lock-free deque) and
ring the doorbell.  The owner drains the inbox inside its progress
sweep.  This replaces ob1's fine-grained matching locks.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ompi_tpu_torch import memchecker, peruse
from ompi_tpu_torch import trace as _trace
from ompi_tpu_torch.datatype.convertor import Convertor, make_convertor
from ompi_tpu_torch.mca.base import Component, frameworks
from ompi_tpu_torch.mca.params import registry
from .request import (ANY_SOURCE, ANY_TAG, PROC_NULL, ERR_TRUNCATE,
                      CompletedRequest, Request, Status)

pml_framework = frameworks.create("ompi", "pml")

# interned trace ids as module constants: the span call sites pass
# small ints, never strings, on the hot path
_CAT_P2P = _trace.CAT_P2P
_NAME_SEND = _trace.NAME_SEND
_NAME_RECV = _trace.NAME_RECV
_CAT_PHASE = _trace.CAT_PHASE
_NAME_PH_RDV = _trace.NAME_PH_RDV
_HIST_RDV = _trace.HIST_RDV_WAIT

registry.register(
    "pml", "ob1", "rsend_is_standard", True, bool,
    help="Ready sends are executed as standard sends (the reference's "
         "ob1 behavior): a missing matching receive is NOT detected, "
         "so erroneous ready-mode programs run silently.  Read-only "
         "declaration for ompi_info.")

# Send modes
MODE_STANDARD = 0
MODE_SYNC = 1
MODE_READY = 2
MODE_BUFFERED = 3

# Frag kinds (tuple tag at index 0)
MATCH = "M"
MATCH_OBJ = "MO"   # opaque-object payload (device tensors, btl/tpu)
MATCH_SYNC = "MS"
RNDV = "R"
ACK = "A"
SYNC_ACK = "SA"
FRAG = "F"
VACK = "VA"        # vprotocol consumed-seq receiver ack (log GC)
MSEG = "MG"        # segmented MATCH: vprotocol replay of payloads
#                    larger than one transport frame (a raw MATCH
#                    bigger than the shm ring can never be pushed).
#                    Reassembled BEFORE sequencing, then dispatched
#                    as a normal MATCH / MATCH_OBJ.


class SendRequest(Request):
    __slots__ = ("conv", "req_id", "total", "dst", "cid", "acked",
                 "mc_crc", "tr")

    def __init__(self, progress, conv, req_id, dst, cid=-1):
        super().__init__(progress)
        self.conv = conv
        self.req_id = req_id
        self.total = conv.packed_size
        self.dst = dst           # GLOBAL rank (failure matching)
        self.cid = cid           # communicator id
        self.tr = None  # (t0_ns, cid, src, tag, seq) while traced


class RecvRequest(Request):
    __slots__ = ("conv", "req_id", "src", "tag", "cid", "matched",
                 "expected", "received", "incoming", "_canceller",
                 "_held", "tr")

    def __init__(self, progress, conv, req_id, src, tag, cid):
        super().__init__(progress)
        self._canceller = None
        self.tr = None  # [t0_ns, cid, src, tag, seq] while traced
        self.conv = conv
        self.req_id = req_id
        self.src = src
        self.tag = tag
        self.cid = cid
        self.matched = False
        self.expected = 0   # bytes that will actually arrive
        self.received = 0   # contiguous coverage watermark
        self.incoming = 0   # sender's total (for truncation check)
        self._held = None   # out-of-order coverage intervals {pos: end}


class UnexpectedMsg:
    """A matched-nothing incoming message buffered for a future recv
    (or probe/mprobe)."""

    __slots__ = ("kind", "cid", "src", "tag", "seq", "total", "sreq_id",
                 "payload", "arrival")
    _arrival_counter = itertools.count()

    def __init__(self, kind, cid, src, tag, seq, total, sreq_id, payload):
        self.kind = kind
        self.cid = cid
        self.src = src
        self.tag = tag
        self.seq = seq
        self.total = total
        self.sreq_id = sreq_id
        self.payload = payload
        self.arrival = next(UnexpectedMsg._arrival_counter)


class PmlOb1:
    """One matching engine per rank."""

    def __init__(self, state) -> None:
        self.state = state
        self.inbox: deque = deque()
        self.endpoints: List = []   # filled by add_procs
        self._req_counter = itertools.count(1)
        self._send_reqs: Dict[int, SendRequest] = {}
        self._recv_reqs: Dict[int, RecvRequest] = {}
        # matching state, keyed per communicator cid
        self._posted: Dict[int, List[RecvRequest]] = {}
        self._unexpected: Dict[int, List[UnexpectedMsg]] = {}
        self._send_seq: Dict[Tuple[int, int], int] = {}     # (cid,dst)->seq
        self._next_seq: Dict[Tuple[int, int], int] = {}     # (cid,src)->seq
        self._cant_match: Dict[Tuple[int, int], Dict[int, UnexpectedMsg]] = {}
        # (cid, src, seq, gsrc) -> [bytearray, filled, positions]:
        # in-progress segmented replay reassembly (MSEG; vprotocol only)
        self._mseg: Dict[tuple, list] = {}
        # (cid, src, seq) triples an uncoordinated restart expects to
        # be REDELIVERED by vprotocol replay although their sequence
        # slot was consumed before the snapshot (the message was in
        # the unexpected queue at capture; its payload is not in the
        # snapshot — the sender's log carries it)
        self._replay_want: set = set()
        # checkpoint/restart bookmark counters (crcp/bkmrk analog,
        # ref: ompi/mca/crcp/bkmrk/crcp_bkmrk_pml.c): user-tag message
        # envelopes sent to / arrived from each GLOBAL rank.  Quiesce
        # drains until every pair's counts match (see ompi_tpu_torch/cr).
        self.cr_sent: Dict[int, int] = {}
        self.cr_arrived: Dict[int, int] = {}
        self.pvar_sent = registry.register_pvar(
            "pml", "ob1", f"bytes_sent_r{state.rank}")
        self.pvar_recv = registry.register_pvar(
            "pml", "ob1", f"bytes_recv_r{state.rank}")
        # span tracer cached once (mpi_init attaches it before pml
        # selection): the p2p hot paths pay one is-None check when
        # tracing is off — the peruse-flag discipline
        self._tracer = getattr(state, "tracer", None)
        # ULFM state, same caching discipline; u.active only flips
        # once the first failure/revoke record arrives, so the
        # healthy-path cost is one attribute fetch + one falsy check
        self._ulfm = getattr(state, "ulfm", None)
        state.progress.register(self.progress)

    # -- wiring ----------------------------------------------------------
    def add_procs(self, endpoints) -> None:
        self.endpoints = endpoints

    def _ep(self, peer_global: int):
        ep = self.endpoints[peer_global]
        if ep is None:
            raise RuntimeError(f"no btl route to rank {peer_global}")
        return ep

    # -- send ------------------------------------------------------------
    def _envelope(self, dst, tag, comm):
        """Shared send-side bookkeeping: rank check + translation,
        per-(cid,dst) sequencing, C/R sent counting.  Returns
        (gdst, endpoint, seq)."""
        if not 0 <= dst < len(comm.group):
            # comm.group is the p2p translation table: the membership
            # for intracomms, the REMOTE group for intercomms
            raise ValueError(
                f"invalid rank {dst} for {len(comm.group)}-rank "
                "destination group (MPI_ERR_RANK)")
        gdst = comm.group[dst]
        ep = self._ep(gdst)
        key = (comm.cid, dst)
        seq = self._send_seq.get(key, 0)
        self._send_seq[key] = seq + 1
        if tag >= 0:
            self.cr_sent[gdst] = self.cr_sent.get(gdst, 0) + 1
        return gdst, ep, seq

    def isend(self, buf, count, datatype, dst, tag, comm,
              mode=MODE_STANDARD, offset: int = 0) -> Request:
        if dst == PROC_NULL:
            return CompletedRequest(self.state.progress)
        u = self._ulfm
        if u is not None and u.active:
            u.poll()
            u.check_peer(comm, dst)
        # convertor construction FIRST: an argument error must not
        # consume the (cid,dst) sequence number (a burned seq wedges
        # the channel — the receiver can never match past the hole)
        conv = make_convertor(datatype, count, buf, offset=offset)
        gdst, ep, seq = self._envelope(dst, tag, comm)
        btl = ep.btl
        cid = comm.cid
        src = comm.rank
        req_id = next(self._req_counter)
        req = SendRequest(self.state.progress, conv, req_id, gdst, cid)
        req.status.count = conv.packed_size
        self.pvar_sent.add(conv.packed_size)
        if peruse.enabled:
            peruse.fire("req_activate", kind="send", cid=cid, peer=dst,
                        tag=tag, bytes=conv.packed_size)
        if self._tracer is not None:
            # the match-id components (identical on the receiver's
            # span) ride as ints; the mid string traceview stitches
            # on is synthesized at snapshot time, off the hot path
            t0 = self._tracer.start_sampled(_CAT_P2P)
            if t0:
                req.tr = (t0, cid, src, tag, seq)
        gsrc = self.state.rank  # global sender id
        if conv.packed_size <= btl.eager_limit and mode != MODE_SYNC:
            # pack_bytes: the request completes NOW, but the frag may
            # sit in a transport queue — the payload must own its bytes
            payload = conv.pack_bytes()
            ep.send((MATCH, cid, src, tag, seq, gsrc, payload))
            req._complete()
            if peruse.enabled:
                peruse.fire("req_complete", kind="send",
                            bytes=req.total)
            if req.tr is not None:
                self._trace_p2p_end(req, _NAME_SEND, req.total)
        elif conv.packed_size <= btl.eager_limit:  # sync eager
            payload = conv.pack_bytes()
            self._send_reqs[req_id] = req
            ep.send((MATCH_SYNC, cid, src, tag, seq, gsrc,
                     req_id, payload))
        else:
            if memchecker.enabled():
                req.mc_crc = memchecker.send_checksum(conv)
            head = conv.pack_bytes(btl.eager_limit)
            self._send_reqs[req_id] = req
            ep.send((RNDV, cid, src, tag, seq, gsrc,
                     conv.packed_size, req_id, head))
        return req

    def send(self, buf, count, datatype, dst, tag, comm,
             mode=MODE_STANDARD, offset: int = 0) -> Status:
        return self.isend(buf, count, datatype, dst, tag, comm, mode,
                          offset).wait()

    # -- opaque-object channel (device payloads; btl/tpu) ---------------
    def isend_obj(self, obj, dst, tag, comm) -> None:
        """Eager send of an opaque payload object: same envelope and
        sequencing as byte messages, but a DISTINCT kind (MATCH_OBJ)
        so object messages can never bind a posted byte receive (and
        byte probes never steal them).  The object rides by reference
        through inproc."""
        if dst == PROC_NULL:
            return
        gdst, ep, seq = self._envelope(dst, tag, comm)
        ep.send((MATCH_OBJ, comm.cid, comm.rank, tag, seq,
                 self.state.rank, obj))

    def poll_obj_any(self, tag):
        """Non-blocking: pop one buffered object message with ``tag``
        from ANY communicator's unexpected queue (no progress call —
        this may run inside a progress sweep)."""
        for lst in self._unexpected.values():
            for m in lst:
                if m.kind == MATCH_OBJ and m.tag == tag:
                    lst.remove(m)
                    return m
        return None

    def recv_obj(self, src, tag, comm):
        """Blocking matched receive of an object message (kind
        MATCH_OBJ only) returning the UnexpectedMsg with its payload
        uninterpreted (no convertor)."""
        if src == PROC_NULL:
            return None
        while True:
            self.state.progress.progress()
            best = self._find_unexpected(comm.cid, src, tag,
                                         want_obj=True)
            if best is not None:
                self._unexpected[comm.cid].remove(best)
                return best
            self.state.progress.idle_tick()

    # -- recv ------------------------------------------------------------
    def irecv(self, buf, count, datatype, src, tag, comm,
              offset: int = 0) -> RecvRequest:
        if src == PROC_NULL:
            r = CompletedRequest(self.state.progress)
            r.status.source = PROC_NULL
            r.status.tag = ANY_TAG
            return r
        u = self._ulfm
        if u is not None and u.active:
            u.poll()
            u.check_peer(comm, src)
        conv = make_convertor(datatype, count, buf, offset=offset,
                              writable=True) \
            if buf is not None else Convertor(datatype, 0, b"")
        req_id = next(self._req_counter)
        req = RecvRequest(self.state.progress, conv, req_id, src, tag,
                          comm.cid)
        req._canceller = self.cancel_recv
        self._recv_reqs[req_id] = req
        if peruse.enabled:
            peruse.fire("req_activate", kind="recv", cid=comm.cid,
                        peer=src, tag=tag, bytes=conv.packed_size)
        if self._tracer is not None:
            # match-id ints filled at match time (_bind) once the
            # sender's src/seq are known
            t0 = self._tracer.start_sampled(_CAT_P2P)
            if t0:
                req.tr = [t0, 0, 0, 0, 0]
        if memchecker.enabled() and buf is not None:
            memchecker.poison_recv(conv)
        # match against buffered unexpected messages first
        msg = self._match_unexpected(req)
        if msg is not None:
            self._bind(req, msg)
        else:
            self._posted.setdefault(comm.cid, []).append(req)
        return req

    def recv(self, buf, count, datatype, src, tag, comm,
             offset: int = 0) -> Status:
        return self.irecv(buf, count, datatype, src, tag, comm,
                          offset).wait()

    # -- probe -----------------------------------------------------------
    def iprobe(self, src, tag, comm) -> Optional[Status]:
        self.state.progress.progress()
        msg = self._find_unexpected(comm.cid, src, tag)
        if msg is None:
            return None
        st = Status()
        st.source = msg.src
        st.tag = msg.tag
        st.count = msg.total
        return st

    def probe(self, src, tag, comm) -> Status:
        while True:
            st = self.iprobe(src, tag, comm)
            if st is not None:
                return st
            self.state.progress.idle_tick()

    def improbe(self, src, tag, comm):
        """Matched probe: removes the message from matching
        (ref: ompi/message mprobe)."""
        self.state.progress.progress()
        msg = self._find_unexpected(comm.cid, src, tag)
        if msg is None:
            return None
        self._unexpected[comm.cid].remove(msg)
        return msg

    def mrecv(self, buf, count, datatype, msg, comm) -> Status:
        req_id = next(self._req_counter)
        conv = make_convertor(datatype, count, buf, writable=True)
        req = RecvRequest(self.state.progress, conv, req_id, msg.src,
                          msg.tag, comm.cid)
        self._recv_reqs[req_id] = req
        self._bind(req, msg)
        return req.wait()

    # -- matching internals ----------------------------------------------
    def _matchable(self, cid: int, src: int, seq: int) -> bool:
        return self._next_seq.get((cid, src), 0) == seq

    def _find_unexpected(self, cid, src, tag,
                         want_obj: bool = False) -> Optional[UnexpectedMsg]:
        # messages here already consumed their sequence number at
        # arrival dispatch; FIFO per source is preserved by arrival
        # order, so match the earliest arrival only.  ``want_obj``
        # selects the object channel (MATCH_OBJ) vs byte messages —
        # the two never match each other's receives.
        best = None
        for m in self._unexpected.get(cid, []):
            # ANY_TAG never matches reserved internal (negative) tags
            if (m.kind == MATCH_OBJ) == want_obj and \
               (src == ANY_SOURCE or m.src == src) and \
               (m.tag == tag or (tag == ANY_TAG and m.tag >= 0)):
                if best is None or m.arrival < best.arrival:
                    best = m
        return best

    def _match_unexpected(self, req: RecvRequest) -> Optional[UnexpectedMsg]:
        m = self._find_unexpected(req.cid, req.src, req.tag)
        if m is not None:
            self._unexpected[req.cid].remove(m)
        return m

    def _match_posted(self, cid, src, tag) -> Optional[RecvRequest]:
        posted = self._posted.get(cid, [])
        for req in posted:
            if req.cancelled:
                continue
            if (req.src == ANY_SOURCE or req.src == src) and \
               (req.tag == tag or (req.tag == ANY_TAG and tag >= 0)):
                posted.remove(req)
                return req
        return None

    def _advance_seq(self, cid, src) -> None:
        key = (cid, src)
        self._next_seq[key] = self._next_seq.get(key, 0) + 1
        if self._mseg:
            # straggler MSEG duplicates may have re-seeded a partial
            # reassembly for a seq that just got consumed (its full
            # assembly dispatched from _cant_match); such an entry can
            # never complete — purge it so cr_capture's in-flight
            # guard only fires for genuinely undeliverable messages
            nxt = self._next_seq[key]
            stale = [k for k in self._mseg
                     if k[0] == cid and k[1] == src and k[2] < nxt
                     and (cid, src, k[2]) not in self._replay_want]
            for k in stale:
                del self._mseg[k]
        # an out-of-order frag may now be matchable
        held = self._cant_match.get(key)
        if held:
            nxt = held.pop(self._next_seq[key], None)
            if nxt is not None:
                self._dispatch_arrival(nxt)

    def _bind(self, req: RecvRequest, msg: UnexpectedMsg) -> None:
        """Attach a matched incoming message to a recv request and run
        the receive-side protocol."""
        req.matched = True
        req.incoming = msg.total
        req.status.source = msg.src
        req.status.tag = msg.tag
        if req.tr is not None:
            rt = req.tr
            rt[1] = msg.cid
            rt[2] = msg.src
            rt[3] = msg.tag
            rt[4] = msg.seq
        capacity = req.conv.packed_size
        req.expected = min(msg.total, capacity)
        if msg.total > capacity:
            req.status.error = ERR_TRUNCATE
        self.pvar_recv.add(req.expected)
        head = msg.payload
        take = min(len(head), capacity)
        if take:
            req.conv.unpack(head[:take])
        req.received = len(head)  # count sender-sent bytes incl. dropped
        req.status.count = min(req.received, capacity)
        if msg.kind == MATCH_SYNC:
            ep = self._ep(self.state_comm_peer(msg.cid, msg.src))
            ep.send((SYNC_ACK, msg.sreq_id))
        if msg.kind == RNDV:
            gsrc = self.state_comm_peer(msg.cid, msg.src)
            ep = self._ep(gsrc)
            ep.send((ACK, msg.sreq_id, req.req_id))
        if req.received >= msg.total:
            req.status.count = min(msg.total, capacity)
            self._finish_recv(req)

    def _trace_p2p_end(self, req, name_id: int, nbytes: int) -> None:
        """Close a p2p span (activate → complete); feeds the
        p2p_complete latency histogram through the tracer."""
        t0, cid, src, tag, seq = req.tr
        req.tr = None
        self._tracer.end(t0, name_id, _CAT_P2P, cid, src, tag, seq,
                         nbytes)

    def _finish_recv(self, req: RecvRequest) -> None:
        self._recv_reqs.pop(req.req_id, None)
        req._complete()
        if peruse.enabled:
            peruse.fire("req_complete", kind="recv",
                        bytes=req.status.count)
        if req.tr is not None:
            self._trace_p2p_end(req, _NAME_RECV, req.status.count)

    def state_comm_peer(self, cid: int, comm_rank: int) -> int:
        comm = self.state.comms.get(cid)
        return comm.group[comm_rank]

    # -- inbox dispatch --------------------------------------------------
    def progress(self) -> int:
        n = 0
        while self.inbox:
            try:
                frag = self.inbox.popleft()
            except IndexError:
                break
            self._handle(frag)
            n += 1
        return n

    def _handle(self, frag: tuple) -> None:
        kind = frag[0]
        if kind in (MATCH, MATCH_OBJ, MATCH_SYNC, RNDV):
            if kind in (MATCH, MATCH_OBJ):
                _, cid, src, tag, seq, gsrc, payload = frag
                msg = UnexpectedMsg(kind, cid, src, tag, seq,
                                    len(payload), None, payload)
            elif kind == MATCH_SYNC:
                _, cid, src, tag, seq, gsrc, sreq_id, payload = frag
                msg = UnexpectedMsg(kind, cid, src, tag, seq,
                                    len(payload), sreq_id, payload)
            else:
                _, cid, src, tag, seq, gsrc, total, sreq_id, payload = frag
                msg = UnexpectedMsg(kind, cid, src, tag, seq, total,
                                    sreq_id, payload)
            # the envelope carries the sender's GLOBAL rank so C/R
            # bookkeeping never depends on resolving the cid locally.
            # Count AFTER the sequence gate: transport-duplicate
            # envelopes must not inflate arrived.
            if self._dispatch_arrival(msg) and tag >= 0:
                self.cr_arrived[gsrc] = self.cr_arrived.get(gsrc, 0) + 1
        elif kind == ACK:
            _, sreq_id, rreq_id = frag
            self._send_rest(sreq_id, rreq_id)
        elif kind == SYNC_ACK:
            _, sreq_id = frag
            req = self._send_reqs.pop(sreq_id, None)
            if req is not None:
                req._complete()
                if peruse.enabled:
                    peruse.fire("req_complete", kind="send",
                                bytes=req.total)
                if req.tr is not None:
                    self._trace_p2p_end(req, _NAME_SEND, req.total)
        elif kind == FRAG:
            _, rreq_id, pos, payload = frag
            self._recv_segment(rreq_id, pos, payload)
        elif kind == MSEG:
            self._handle_mseg(frag)
        elif kind == VACK:
            # receiver-ack for the vprotocol sender log (GC); rides
            # the btl UNSEQUENCED — an ack must never consume a
            # sequence slot (it would itself need logging).  Ignored
            # unless a pessimist layer installed its handler.
            h = getattr(self, "vack_handler", None)
            if h is not None:
                h(frag[1])

    def _handle_mseg(self, frag: tuple) -> None:
        """Reassemble a segmented replay MATCH.  Segments are
        position-addressed (transports may interleave rails); the
        assembled message enters matching exactly as a single MATCH
        frame would — including the duplicate-sequence drop for
        receivers that already consumed it.

        Duplicate segments (a tcp reconnect resends every frame not
        provably written) must not double-count: coverage is tracked
        per position.  And a segment for an already-consumed sequence
        number is dropped BEFORE assembly — after a completed
        reassembly advanced the sequence, straggler duplicates would
        otherwise re-seed a stale partial entry that lives forever."""
        _, cid, src, tag, seq, gsrc, total, kindcode, pos, chunk = frag
        if seq < self._next_seq.get((cid, src), 0) and \
                (cid, src, seq) not in self._replay_want:
            return  # consumed seq: this whole message is a duplicate
        key = (cid, src, seq, gsrc)
        entry = self._mseg.get(key)
        if entry is None:
            entry = self._mseg[key] = [bytearray(total), 0, set()]
        buf, got, seen = entry
        if pos in seen:
            return  # duplicated segment (transport resend): one replay
        #           chunks at a fixed stride, so positions identify
        #           segments exactly
        seen.add(pos)
        buf[pos:pos + len(chunk)] = chunk
        entry[1] = got + len(chunk)
        if entry[1] < total:
            return
        del self._mseg[key]
        if kindcode == 1:
            import pickle
            payload = pickle.loads(bytes(buf))
            msg = UnexpectedMsg(MATCH_OBJ, cid, src, tag, seq,
                                len(payload), None, payload)
        else:
            payload = bytes(buf)
            msg = UnexpectedMsg(MATCH, cid, src, tag, seq,
                                len(payload), None, payload)
        if self._dispatch_arrival(msg) and tag >= 0:
            self.cr_arrived[gsrc] = self.cr_arrived.get(gsrc, 0) + 1

    def _dispatch_arrival(self, msg: UnexpectedMsg) -> bool:
        """Sequence-gate an arrived envelope into matching.  A
        message whose sequence slot was already consumed is a
        transport duplicate and is dropped; one that arrives ahead of
        its turn is held until the gap fills.  Returns False for a
        duplicate that will never reach matching — callers must NOT
        count such arrivals in the C/R bookmark."""
        key = (msg.cid, msg.src)
        if not self._matchable(msg.cid, msg.src, msg.seq):
            if msg.seq < self._next_seq.get(key, 0):
                want = (msg.cid, msg.src, msg.seq)
                if want in self._replay_want:
                    # vprotocol replay of a message whose sequence
                    # slot was consumed before an uncoordinated
                    # snapshot: deliver to matching WITHOUT
                    # re-sequencing (its slot is already burned)
                    self._replay_want.discard(want)
                    self._match_or_buffer(msg)
                    return True
                # already-consumed sequence: a reconnect-resent
                # duplicate envelope.  Drop it — parking it in
                # _cant_match would leak it forever (its seq can
                # never become next)
                return False
            held = self._cant_match.setdefault(key, {})
            dup = msg.seq in held
            held[msg.seq] = msg
            return not dup
        if self._replay_want:
            # normally-sequenced redelivery: the want entry is served
            self._replay_want.discard((msg.cid, msg.src, msg.seq))
        self._advance_seq(msg.cid, msg.src)
        self._match_or_buffer(msg)
        return True

    def _match_or_buffer(self, msg: UnexpectedMsg) -> None:
        if msg.kind == MATCH_OBJ:
            # object messages wait for recv_obj; a posted byte recv
            # must never bind one (its payload is not a buffer)
            self._unexpected.setdefault(msg.cid, []).append(msg)
            return
        req = self._match_posted(msg.cid, msg.src, msg.tag)
        if req is not None:
            if peruse.enabled:
                peruse.fire("req_match", cid=msg.cid, peer=msg.src,
                            tag=msg.tag, bytes=msg.total)
            self._bind(req, msg)
        else:
            if peruse.enabled:
                peruse.fire("req_match_unex", cid=msg.cid,
                            peer=msg.src, tag=msg.tag, bytes=msg.total)
            self._unexpected.setdefault(msg.cid, []).append(msg)

    def _send_rest(self, sreq_id: int, rreq_id: int) -> None:
        req = self._send_reqs.pop(sreq_id, None)
        if req is None:
            return
        tr = self._tracer
        if tr is not None and tr.phase and req.tr is not None:
            # host-path rendezvous wait (RNDV sent at isend, ACK just
            # arrived): rides the p2p span's sampling decision — no
            # second start_sampled, req.tr stays armed for the send
            # span closed below
            t0, cid, src, tag, seq = req.tr
            dur = tr.end(t0, _NAME_PH_RDV, _CAT_PHASE, cid, seq,
                         req.total)
            tr.hist_add(_HIST_RDV, dur * 1e-9)
        ep = self._ep(req.dst)
        btl = ep.btl
        conv = req.conv
        while not conv.done:
            pos = conv.position
            payload = conv.pack_bytes(btl.max_send_size)
            # position-addressed: stripes across same-tier rails
            # (receiver coverage is interval-based, order-free)
            ep.send_striped((FRAG, rreq_id, pos, payload))
        if memchecker.enabled():
            memchecker.verify_send(
                conv, getattr(req, "mc_crc", None),
                f"rendezvous send req {sreq_id}")
        req._complete()
        if peruse.enabled:
            peruse.fire("req_complete", kind="send", bytes=req.total)
        if req.tr is not None:
            self._trace_p2p_end(req, _NAME_SEND, req.total)

    def _recv_segment(self, rreq_id: int, pos: int, payload: bytes) -> None:
        req = self._recv_reqs.get(rreq_id)
        if req is None:
            return
        capacity = req.conv.packed_size
        if pos < capacity:
            take = min(len(payload), capacity - pos)
            req.conv.set_position(pos)
            req.conv.unpack(payload[:take])
        # coverage as watermark + held intervals: duplicated segments
        # (transport reconnect resends) never double-count, and a
        # segment arriving AHEAD of the watermark (a reconnected
        # conn's resend processed before the old conn's in-flight
        # data — the selector may interleave the two) is remembered
        # and merged once the gap fills, instead of silently dropped
        # (which stalled the recv forever; ADVICE r3 #1).  A LOST
        # segment (the unrecoverable kernel-buffer window of a dead
        # connection) still leaves a hole forever — the recv fails
        # stop via timeout instead of completing with one
        if pos <= req.received:
            req.received = max(req.received, pos + len(payload))
            held = req._held
            if held:
                # merge any held intervals the new watermark reaches
                while True:
                    nxt = [p for p in held if p <= req.received]
                    if not nxt:
                        break
                    for p in nxt:
                        end = held.pop(p)
                        if end > req.received:
                            req.received = end
        else:
            if req._held is None:
                req._held = {}
            end = pos + len(payload)
            if end > req._held.get(pos, 0):
                req._held[pos] = end
        if req.received >= req.incoming:
            req.status.count = min(req.incoming, capacity)
            self._finish_recv(req)

    # -- checkpoint/restart hooks (ompi_tpu_torch/cr; crcp/bkmrk) ------
    def cr_pending_sends(self) -> int:
        """Send requests whose payload is not fully on the wire yet
        (rendezvous streams, sync-eager awaiting ACK)."""
        return len(self._send_reqs)

    def cr_capture(self) -> List[tuple]:
        """Snapshot the in-flight state a quiesced rank may legally
        hold: buffered-eager user messages in the unexpected queues.
        Everything else must be drained — a stuck rendezvous or
        out-of-order hold at quiesce is a protocol violation worth a
        loud failure, not a silent bad snapshot."""
        if self._send_reqs:
            raise RuntimeError(
                "cr_capture with pending send requests (quiesce bug)")
        if any(self._cant_match.values()):
            raise RuntimeError(
                "cr_capture with out-of-order frags held (messages "
                "still in flight)")
        if self._mseg:
            raise RuntimeError(
                "cr_capture with a partially reassembled replay "
                "message (sender died mid-replay?) — the message is "
                "neither capturable nor deliverable")
        msgs = []
        for cid, lst in self._unexpected.items():
            for m in sorted(lst, key=lambda u: u.arrival):
                if m.tag < 0:
                    # post-quiesce traffic from the checkpoint's own
                    # machinery (a faster rank's seq-Bcast fan-out can
                    # land here before we capture): consumed by OUR
                    # upcoming phase, never snapshotted
                    continue
                if m.kind == MATCH_OBJ:
                    from ompi_tpu_torch.btl.tpu import _XferHdr
                    if isinstance(m.payload, _XferHdr):
                        # chunked-transfer header whose DATA is parked
                        # on the sender (captured there by the rndv
                        # engine's cr_capture); snapshot the metadata
                        # so the pull protocol resumes after restart
                        h = m.payload
                        msgs.append((cid, m.src, m.tag, m.total,
                                     "xferhdr",
                                     (h.xfer_id, tuple(h.shape),
                                      h.dtype, h.nbytes, h.chunk)))
                        continue
                    # in-flight device payload (send_arr completed,
                    # recv_arr pending): a host copy of the receiver's
                    # tensor, taken once the sender's copy into it has
                    # finished; restore re-places it on the device
                    msgs.append((cid, m.src, m.tag, m.total, "obj",
                                 _host_copy(m.payload)))
                    continue
                if m.kind != MATCH:
                    raise RuntimeError(
                        f"cr_capture: {m.kind} message unmatched at "
                        "quiesce (sender's request could not have "
                        "completed — user requests must complete "
                        "before checkpoint)")
                msgs.append((cid, m.src, m.tag, m.total, "bytes",
                             bytes(m.payload)))
        return msgs

    def cr_capture_lenient(self) -> List[tuple]:
        """Uncoordinated snapshot: the (cid, src, seq) of every
        arrived-but-unconsumed message instead of its payload (a
        sender-side log redelivers them after restart).  Out-of-order
        holds are recorded too.  Locally-incomplete requests are an
        app-contract violation either way."""
        if self._send_reqs:
            raise RuntimeError(
                "uncoordinated checkpoint with locally-incomplete "
                "send requests (wait/test them first)")
        for req in self._recv_reqs.values():
            if req.matched and not req.complete:
                raise RuntimeError(
                    "uncoordinated checkpoint with a matched, "
                    "partially-received request (wait it first)")
        want = []
        for cid, lst in self._unexpected.items():
            for m in lst:
                want.append((cid, m.src, m.seq))
        for (cid, src), held in self._cant_match.items():
            for seq in held:
                want.append((cid, src, seq))
        return want

    def cr_restore(self, msgs: List[tuple]) -> None:
        """Reinject snapshot-carried eager messages as fresh arrivals.
        Sequence numbers restart from zero on both sides after a
        restart, so reinjection bypasses sequencing (these envelopes
        already consumed their pre-checkpoint sequence slots)."""
        for cid, src, tag, total, kind, payload in msgs:
            if kind == "xferhdr":
                from ompi_tpu_torch.btl.tpu import _XferHdr
                xid, shape, dtype, nbytes, chunk = payload
                m = UnexpectedMsg(MATCH_OBJ, cid, src, tag, 0, total,
                                  None,
                                  _XferHdr(xid, shape, dtype, nbytes,
                                           chunk))
            elif kind == "obj":
                from ompi_tpu_torch.btl.tpu import DeviceArrayPayload
                from ompi_tpu_torch import convert
                dev = self.state.device
                arr = payload
                if dev is not None:
                    arr = payload.to(dev) if hasattr(payload, "to") \
                        else convert.to_torch(payload, dev)
                m = UnexpectedMsg(MATCH_OBJ, cid, src, tag, 0, total,
                                  None, DeviceArrayPayload(arr))
            else:
                m = UnexpectedMsg(MATCH, cid, src, tag, 0, total,
                                  None, payload)
            self._unexpected.setdefault(cid, []).append(m)

    # -- recovery epochs (ompi_tpu_torch/ft/respawn) ---------------------
    def ft_reset(self) -> None:
        """Epoch reset: drop every piece of matching and sequence
        state.  Both ends of every channel restart at zero — the
        snapshot all ranks reload has no in-flight traffic by quiesce
        construction."""
        self.inbox.clear()
        self._send_reqs.clear()
        self._recv_reqs.clear()
        self._posted.clear()
        self._unexpected.clear()
        self._send_seq.clear()
        self._next_seq.clear()
        self._cant_match.clear()
        self._mseg.clear()
        self._replay_want.clear()
        self.cr_sent.clear()
        self.cr_arrived.clear()

    def ft_reset_peer(self, granks, comms) -> None:
        """Respawn rejoin (ft/respawn): a replaced rank restarts its
        pml at zero, so BOTH directions of every channel naming it
        must forget their sequence state — the survivor's next send
        to it carries seq 0 again, and seq 0 from it matches instead
        of parking in _cant_match behind the dead predecessor's
        counters.  Survivor<->survivor channels keep their live
        sequences."""
        granks = set(granks)
        for comm in comms.values():
            if comm is None:
                continue
            group = list(comm.group)
            for r, g in enumerate(group):
                if g not in granks:
                    continue
                self._send_seq.pop((comm.cid, r), None)
                self._next_seq.pop((comm.cid, r), None)
                self._cant_match.pop((comm.cid, r), None)
                for key in [k for k in self._mseg
                            if k[0] == comm.cid and k[1] == r]:
                    del self._mseg[key]
                pend = self._unexpected.get(comm.cid)
                if pend:
                    self._unexpected[comm.cid] = [
                        m for m in pend if m.src != r]
        for g in granks:
            self.cr_sent.pop(g, None)
            self.cr_arrived.pop(g, None)

    # -- ULFM drain (ompi_tpu_torch/ft/ulfm) -----------------------------
    def ulfm_sweep(self, failed, revoked) -> int:
        """Complete every parked request naming a failed peer or a
        revoked communicator with the matching ULFM error class
        (Request.wait raises it) instead of hanging forever.  Called
        from UlfmState._ingest whenever a failure/revoke record is
        ingested — the drain half of detect → report."""
        from ompi_tpu_torch import errhandler as _eh
        n = 0
        for req in list(self._send_reqs.values()):
            err = 0
            group = self._ulfm_group(req.cid)
            if group is not None and (req.cid, group) in revoked:
                err = _eh.ERR_REVOKED
            elif req.dst in failed:
                err = _eh.ERR_PROC_FAILED
            if err:
                self._send_reqs.pop(req.req_id, None)
                req.status.error = err
                req._complete()
                if req.tr is not None:
                    self._trace_p2p_end(req, _NAME_SEND, 0)
                n += 1
        for req in list(self._recv_reqs.values()):
            err = 0
            group = self._ulfm_group(req.cid)
            if group is not None:
                src = req.status.source if req.matched else req.src
                if (req.cid, group) in revoked:
                    err = _eh.ERR_REVOKED
                elif src == ANY_SOURCE:
                    # as the reference: a parked wildcard receive
                    # completes with the PENDING class rather than
                    # staying pending until failure_ack
                    if any(g in failed for g in group):
                        err = _eh.ERR_PROC_FAILED_PENDING
                elif 0 <= src < len(group) and group[src] in failed:
                    err = _eh.ERR_PROC_FAILED
            if err:
                posted = self._posted.get(req.cid, [])
                if req in posted:
                    posted.remove(req)
                self._recv_reqs.pop(req.req_id, None)
                req.status.error = err
                req._complete()
                if req.tr is not None:
                    self._trace_p2p_end(req, _NAME_RECV, 0)
                n += 1
        return n

    def _ulfm_group(self, cid: int):
        comm = self.state.comms.get(cid)
        return None if comm is None else tuple(comm.group)

    # -- cancel ----------------------------------------------------------
    def cancel_recv(self, req: RecvRequest) -> bool:
        posted = self._posted.get(req.cid, [])
        if req in posted:
            posted.remove(req)
            req.cancelled = True
            req.status.cancelled = True
            self._recv_reqs.pop(req.req_id, None)
            req._complete()
            return True
        return False


def _host_copy(payload):
    """A host copy of a parked device payload (cr_capture): a CPU
    tensor once the sender's copy into the receiver's tensor has
    finished, or a numpy copy for a rank with no device."""
    arr = payload.arr
    if getattr(payload, "event", None) is not None:
        payload.event.synchronize()
    if hasattr(arr, "detach"):
        return arr.detach().to("cpu", copy=True)
    import numpy as np
    return np.array(arr, copy=True)


class Ob1Component(Component):
    name = "ob1"
    priority = 20

    def query(self, state=None):
        return (self.priority, PmlOb1)


pml_framework.add_component(Ob1Component())

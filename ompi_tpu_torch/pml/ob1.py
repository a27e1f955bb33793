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


from ompi_tpu_torch.datatype.convertor import Convertor, make_convertor
from ompi_tpu_torch.mca.base import Component, frameworks
from ompi_tpu_torch.mca.params import registry
from .request import (ANY_SOURCE, ANY_TAG, PROC_NULL, ERR_TRUNCATE,
                      CompletedRequest, Request, Status)

pml_framework = frameworks.create("ompi", "pml")

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


class SendRequest(Request):
    __slots__ = ("conv", "req_id", "total", "dst", "cid", "acked")

    def __init__(self, progress, conv, req_id, dst, cid=-1):
        super().__init__(progress)
        self.conv = conv
        self.req_id = req_id
        self.total = conv.packed_size
        self.dst = dst           # GLOBAL rank (failure matching)
        self.cid = cid           # communicator id


class RecvRequest(Request):
    __slots__ = ("conv", "req_id", "src", "tag", "cid", "matched",
                 "expected", "received", "incoming", "_canceller",
                 "_held")

    def __init__(self, progress, conv, req_id, src, tag, cid):
        super().__init__(progress)
        self._canceller = None
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
        self.pvar_sent = registry.register_pvar(
            "pml", "ob1", f"bytes_sent_r{state.rank}")
        self.pvar_recv = registry.register_pvar(
            "pml", "ob1", f"bytes_recv_r{state.rank}")
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
        per-(cid,dst) sequencing.  Returns
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
        return gdst, ep, seq

    def isend(self, buf, count, datatype, dst, tag, comm,
              mode=MODE_STANDARD, offset: int = 0) -> Request:
        if dst == PROC_NULL:
            return CompletedRequest(self.state.progress)
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
        gsrc = self.state.rank  # global sender id
        if conv.packed_size <= btl.eager_limit and mode != MODE_SYNC:
            # pack_bytes: the request completes NOW, but the frag may
            # sit in a transport queue — the payload must own its bytes
            payload = conv.pack_bytes()
            ep.send((MATCH, cid, src, tag, seq, gsrc, payload))
            req._complete()
        elif conv.packed_size <= btl.eager_limit:  # sync eager
            payload = conv.pack_bytes()
            self._send_reqs[req_id] = req
            ep.send((MATCH_SYNC, cid, src, tag, seq, gsrc,
                     req_id, payload))
        else:
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
        conv = make_convertor(datatype, count, buf, offset=offset,
                              writable=True) \
            if buf is not None else Convertor(datatype, 0, b"")
        req_id = next(self._req_counter)
        req = RecvRequest(self.state.progress, conv, req_id, src, tag,
                          comm.cid)
        req._canceller = self.cancel_recv
        self._recv_reqs[req_id] = req
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

    def _finish_recv(self, req: RecvRequest) -> None:
        self._recv_reqs.pop(req.req_id, None)
        req._complete()

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
            self._dispatch_arrival(msg)
        elif kind == ACK:
            _, sreq_id, rreq_id = frag
            self._send_rest(sreq_id, rreq_id)
        elif kind == SYNC_ACK:
            _, sreq_id = frag
            req = self._send_reqs.pop(sreq_id, None)
            if req is not None:
                req._complete()
        elif kind == FRAG:
            _, rreq_id, pos, payload = frag
            self._recv_segment(rreq_id, pos, payload)

    def _dispatch_arrival(self, msg: UnexpectedMsg) -> None:
        """Sequence-gate an arrived envelope into matching.  A
        message whose sequence slot was already consumed is a
        transport duplicate and is dropped; one that arrives ahead of
        its turn is held until the gap fills."""
        key = (msg.cid, msg.src)
        if not self._matchable(msg.cid, msg.src, msg.seq):
            if msg.seq < self._next_seq.get(key, 0):
                # already-consumed sequence: a reconnect-resent
                # duplicate envelope.  Drop it — parking it in
                # _cant_match would leak it forever (its seq can
                # never become next)
                return
            self._cant_match.setdefault(key, {})[msg.seq] = msg
            return
        self._advance_seq(msg.cid, msg.src)
        self._match_or_buffer(msg)

    def _match_or_buffer(self, msg: UnexpectedMsg) -> None:
        if msg.kind == MATCH_OBJ:
            # object messages wait for recv_obj; a posted byte recv
            # must never bind one (its payload is not a buffer)
            self._unexpected.setdefault(msg.cid, []).append(msg)
            return
        req = self._match_posted(msg.cid, msg.src, msg.tag)
        if req is not None:
            self._bind(req, msg)
        else:
            self._unexpected.setdefault(msg.cid, []).append(msg)

    def _send_rest(self, sreq_id: int, rreq_id: int) -> None:
        req = self._send_reqs.pop(sreq_id, None)
        if req is None:
            return
        ep = self._ep(req.dst)
        btl = ep.btl
        conv = req.conv
        while not conv.done:
            pos = conv.position
            payload = conv.pack_bytes(btl.max_send_size)
            # position-addressed: stripes across same-tier rails
            # (receiver coverage is interval-based, order-free)
            ep.send_striped((FRAG, rreq_id, pos, payload))
        req._complete()

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


class Ob1Component(Component):
    name = "ob1"
    priority = 20

    def query(self, state=None):
        return (self.priority, PmlOb1)


pml_framework.add_component(Ob1Component())

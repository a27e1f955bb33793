"""TCP BTL: socket transport between process-ranks.

Re-design of opal/mca/btl/tcp (endpoints own sockets with
nonblocking read/write handlers, ref: btl_tcp_endpoint.c:116-117,
469,568; 128 KiB max-send pipelining unit ref:
btl_tcp_component.c:304).  Differences from the reference:

  * one socket per DIRECTION (each rank initiates its own send
    channel, inbound connections are read-only) — removes the
    reference's simultaneous-connect tie-breaking dance entirely;
  * frames are 4-byte length + wire-codec frag (ompi_tpu_torch/btl/wire):
    a fixed binary header followed by the raw payload bytes, gathered
    onto the socket with vectored ``sendmsg`` so payloads are never
    serialized or concatenated (the reference likewise sends headers
    + convertor-packed bytes, ref: btl_tcp_frag.c);
  * nonblocking sends drain a per-endpoint queue from the progress
    engine, so two ranks streaming rendezvous segments at each other
    can never deadlock on full socket buffers.
"""

from __future__ import annotations

import errno
import random
import selectors
import socket
import struct
import time
from collections import deque
from typing import Dict, List, Optional

from ompi_tpu_torch.mca.params import registry
from . import wire
from .base import BTLComponent, BTLModule, BtlError, btl_framework

_eager_var = registry.register(
    "btl", "tcp", "eager_limit", 64 * 1024, int,
    help="Max bytes sent eagerly over TCP")
_max_send_var = registry.register(
    "btl", "tcp", "max_send_size", 128 * 1024, int,
    help="Rendezvous segment size over TCP "
         "(ref: btl_tcp_component.c:304)")
_if_ip_var = registry.register(
    "btl", "tcp", "if_ip", "", str,
    help="IP to advertise for inbound btl connections (the opal if/"
         "reachable analog; set per-node by the tpud daemon from the "
         "route toward the HNP).  Empty = loopback, single-host.")
_advertise_all_var = registry.register(
    "btl", "tcp", "advertise_all", False, bool,
    help="Bind wildcard and advertise EVERY up NIC in the modex; "
         "dialing peers pick the best pair by reachable/weighted "
         "scoring.  Off = traffic stays on btl_tcp_if_ip only.")

# -- reliable sublayer (go-back-N over the per-direction streams) -----
# A kernel-accepted-but-undelivered frame is unrecoverable without
# btl-level acks (the pml/bfo gap the old _reconnect docstring named):
# every DATA frame carries a sequence number + header CRC, receivers
# ACK cumulatively and NACK on gap/corruption, and a sender resends
# its unacked window on a fresh connection.  Duplicates from resends
# are absorbed by seq dedup; ordering is preserved (go-back-N never
# delivers out of order).
_reliable_var = registry.register(
    "btl", "tcp", "reliable", True, bool,
    help="Sequence-numbered idempotent retransmit + header CRC over "
         "every tcp frame: a severed/lossy connection replays unacked "
         "frames instead of wedging the pml.  Must match on all ranks")
_retry_max_var = registry.register(
    "btl", "tcp", "retry_max", 5, int,
    help="Reconnect budget per peer connection (resets on ack "
         "progress); exhausted = endpoint failover/BtlError")
_retry_delay_var = registry.register(
    "btl", "tcp", "retry_delay", 0.05, float,
    help="Base reconnect backoff (exponential, jittered, capped 2 s)")
_ack_frames_var = registry.register(
    "btl", "tcp", "ack_frames", 64, int,
    help="Receiver acks at least every N delivered frames (every "
         "pump batch is also acked)")
_rto_var = registry.register(
    "btl", "tcp", "rto", 1.0, float,
    help="Sender resends its unacked window when no ack arrives for "
         "this long (0 disables the timer; NACKs still resend)")

_pay_digest_var = registry.register(
    "btl", "tcp", "payload_digest", True, bool,
    help="CRC the bytes the header CRC does not cover (payload + "
         "pickle tails) on every reliable DATA frame; a mismatch is "
         "NACKed and the pristine unacked window replayed — catches "
         "wire corruption the narrow header span is blind to")

_RHDR = struct.Struct("<BIQ")   # rtype, wire-header crc, seq
_RHDRD = struct.Struct("<BIQI")  # ... + payload crc (_T_DATAD; same
#                                  prefix, so _RHDR.unpack_from still
#                                  reads rtype/crc/seq off either)
_T_DATA, _T_HELLO, _T_ACK, _T_NACK, _T_DATAD = 0, 1, 2, 3, 4


class _Conn:
    __slots__ = ("sock", "rxbuf", "txq", "txoff", "wr_registered",
                 "peer", "reconnects", "dead",
                 "tx_seq", "unacked", "last_ack_t", "rx_peer",
                 "nacked")

    def __init__(self, sock: socket.socket, peer: int = -1) -> None:
        self.sock = sock
        self.rxbuf = bytearray()
        self.txq: deque = deque()
        self.txoff = 0
        self.wr_registered = False
        self.peer = peer          # >= 0 on outbound conns (reconnect)
        self.reconnects = 0
        self.dead = False
        # reliable sublayer state
        self.tx_seq = 0           # next DATA seq on this channel
        self.unacked: deque = deque()   # (seq, frame) awaiting ack
        self.last_ack_t = 0.0     # last ack progress (RTO base)
        self.rx_peer = -1         # inbound: sender rank from HELLO
        self.nacked = False       # inbound: gap seen, draining dups


_rails_var = registry.register(
    "btl", "tcp", "rails", 1, int,
    help="Parallel tcp rails per peer (multi-rail striping, the "
         "bml/r2 multi-btl analog): rail 0 carries ordered envelope "
         "traffic, rendezvous FRAG segments round-robin across all "
         "rails (position-addressed, order-free).  On multi-NIC "
         "hosts combine with btl_tcp_advertise_all; on one NIC "
         "extra rails still parallelize kernel socket work")


class TcpModule(BTLModule):
    name = "tcp"
    exclusivity = 10

    def __init__(self, state, rail: int = 0) -> None:
        self.state = state
        self.rail = rail
        self._sfx = "" if rail == 0 else f"_r{rail}"
        self.eager_limit = _eager_var.value
        self.max_send_size = _max_send_var.value
        self.rank = state.rank
        self.pvar_frags = registry.register_pvar(
            "btl", "tcp", f"rail{rail}_frags_r{state.rank}")
        self.sel = selectors.DefaultSelector()
        if_ip = _if_ip_var.value or "127.0.0.1"
        advertise_all = _advertise_all_var.value
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # default: bind the advertised IP itself — loopback-only jobs
        # never open a network-reachable port, and a configured if_ip
        # keeps traffic OFF other interfaces (the btl_tcp_if_include
        # discipline).  btl_tcp_advertise_all opts into wildcard bind
        # + multi-NIC advertising with reachable scoring.
        bind_ip = "0.0.0.0" if (advertise_all
                                and if_ip != "127.0.0.1") else if_ip
        self.listener.bind((bind_ip, 0))
        self.listener.listen(state.size * 2)
        self.listener.setblocking(False)
        self.sel.register(self.listener, selectors.EVENT_READ,
                          ("accept", None))
        port = self.listener.getsockname()[1]
        state.rte.modex_put(f"btl_tcp_addr{self._sfx}",
                            f"{if_ip}:{port}")
        # multi-NIC: advertise every usable address (reachable analog,
        # ref: opal/mca/reachable/weighted); the dialing side scores
        # each against its own NICs and picks the best pair.  Always
        # published (single-addr configs advertise just if_ip) so the
        # connector's lookup never blocks on a missing key.
        if advertise_all and if_ip != "127.0.0.1":
            from ompi_tpu_torch.runtime import reachable
            addrs = [if_ip] + [a for a in reachable.advertised_addrs()
                               if a != if_ip]
        else:
            addrs = [if_ip]
        state.rte.modex_put(f"btl_tcp_addrs{self._sfx}",
                            [f"{a}:{port}" for a in addrs])
        self._out: Dict[int, _Conn] = {}
        self._in: List[_Conn] = []
        self.reliable = _reliable_var.value
        self.pay_digest = self.reliable and _pay_digest_var.value
        # per-PEER receive stream state: survives connection severs
        # (the whole point — a reconnecting sender resends its window
        # and the expected-seq cursor dedups), dies at ft_reset
        self._rx_expected: Dict[int, int] = {}
        self._rx_conn: Dict[int, _Conn] = {}
        self._rx_since_ack: Dict[int, int] = {}
        self._delayed: list = []  # (due_t, conn, frame) injector holds
        from ompi_tpu_torch import ft_inject
        self._inj = ft_inject.btl_injector(state.rank)
        # gray-failure shaping: seeded latency/loss
        # on outbound frames — drops ride the reliable sublayer's
        # NACK/RTO replay, delays reuse the 'delay' hold queue
        self._nj = ft_inject.net_jitter_injector(state.rank,
                                                 scope="tcp_net")
        # inbound sockets double as idle-selector wakeup fds: a rank
        # parked in idle_wait unblocks the moment bytes arrive
        state.progress.register_idle_fd(self.listener.fileno())
        state.progress.register(self.progress)
        state.progress.poll_mode = True

    def reaches(self, peer: int) -> bool:
        return peer != self.rank

    def _connect(self, peer: int) -> _Conn:
        conn = self._out.get(peer)
        if conn is not None:
            return conn
        addr = self.state.rte.modex_get(
            peer, f"btl_tcp_addr{self._sfx}")
        try:
            # multi-NIC peers advertise every address; score each
            # against our NICs and dial the best pair (reachable
            # analog).  Single-addr peers skip the lookup.
            addrs = self.state.rte.modex_get(
                peer, f"btl_tcp_addrs{self._sfx}")
        except Exception:
            addrs = None
        if addrs and len(addrs) > 1:
            from ompi_tpu_torch.runtime import reachable
            best = reachable.pick_remote_addr(
                [a.rsplit(":", 1)[0] for a in addrs])
            if best is not None:
                addr = next(a for a in addrs
                            if a.rsplit(":", 1)[0] == best)
        host, port = addr.rsplit(":", 1)
        try:
            s = socket.create_connection((host, int(port)), timeout=30)
        except OSError as e:
            raise BtlError(f"tcp connect to rank {peer} failed: {e}")
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.setblocking(False)
        conn = _Conn(s, peer=peer)
        conn.last_ack_t = time.monotonic()
        self._out[peer] = conn
        if self.reliable:
            # hello-first: names our rank so the receiver keys its
            # expected-seq cursor by PEER, not by connection — the
            # cursor must survive severs
            conn.txq.append(self._ctl_frame(_T_HELLO, self.rank))
            self._sel_register(s, selectors.EVENT_READ, ("out", conn))
        return conn

    @staticmethod
    def _ctl_frame(rtype: int, seq: int) -> list:
        return [struct.pack(">I", _RHDR.size)
                + _RHDR.pack(rtype, 0, int(seq))]

    def _sel_register(self, sock: socket.socket, events, data) -> None:
        """register() that first purges a stale entry for a reused fd
        number: reliable mode keeps sockets registered for their whole
        life, so a socket closed out from under us (injected sever,
        peer surgery) leaves a dead map entry that collides with the
        next accept/dial landing on the same fd."""
        key = self.sel.get_map().get(sock.fileno())
        if key is not None and key.fileobj is not sock:
            try:
                self.sel.unregister(key.fileobj)
            except (KeyError, ValueError):
                pass
        try:
            self.sel.register(sock, events, data)
        except KeyError:
            self.sel.modify(sock, events, data)

    def _reconnect(self, conn: _Conn) -> bool:
        """Transport-level recovery (the failover half the endpoint
        cannot do): dial the peer again and resend on a clean frame
        boundary.  Reliable mode resends the whole UNACKED window
        (hello-first); frames the kernel accepted but the peer never
        delivered are thereby recovered, and resend duplicates die at
        the receiver's seq cursor.  Unreliable mode resends only what
        txq still holds — the legacy best-effort path."""
        budget = _retry_max_var.value if self.reliable else 3
        if conn.peer < 0 or conn.reconnects >= budget:
            return False
        conn.reconnects += 1
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        conn.wr_registered = False
        try:
            conn.sock.close()
        except OSError:
            pass
        if self.reliable and conn.reconnects > 1:
            # exponential backoff with jitter: don't hammer a peer
            # that is restarting its listener
            base = max(0.0, _retry_delay_var.value)
            delay = min(2.0, base * (2 ** (conn.reconnects - 2)))
            time.sleep(delay * (0.5 + random.random()))
        addr = self.state.rte.modex_get(
            conn.peer, f"btl_tcp_addr{self._sfx}")
        host, port = addr.rsplit(":", 1)
        try:
            s = socket.create_connection((host, int(port)), timeout=10)
        except OSError:
            return False
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.setblocking(False)
        conn.sock = s
        conn.txoff = 0  # resend the partially-written frame whole
        if self.reliable:
            conn.txq = deque([self._ctl_frame(_T_HELLO, self.rank)])
            conn.txq.extend(f for _seq, f in conn.unacked)
            self._sel_register(s, selectors.EVENT_READ
                               | selectors.EVENT_WRITE, ("out", conn))
            conn.wr_registered = True
            conn.last_ack_t = time.monotonic()
        return True

    def _force_resend(self, conn: _Conn) -> None:
        """NACK or RTO: the in-flight stream is suspect — replay the
        unacked window on a fresh connection (clean boundaries; the
        receiver's cursor absorbs duplicates)."""
        if conn.dead:
            return
        if self._reconnect(conn):
            self._drain(conn)
        else:
            self._kill_conn(conn)

    def _kill_conn(self, conn: _Conn) -> None:
        """Reconnects exhausted: tear the connection down fully so no
        selector ever polls a dead fd and no sweep busy-loops; the
        next send() to this peer raises BtlError for endpoint
        failover."""
        conn.dead = True
        conn.txq.clear()
        conn.unacked.clear()
        conn.txoff = 0
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        conn.wr_registered = False
        try:
            conn.sock.close()
        except OSError:
            pass
        if self.reliable and conn.peer >= 0 and \
                getattr(self.state, "ulfm", None) is not None:
            # the reliable sublayer burned its whole reconnect budget
            # on this peer: that is transport-level proof of permanent
            # death — promote it to a job-wide ULFM failure record so
            # parked ops drain with ERR_PROC_FAILED instead of timing
            # out one by one
            from ompi_tpu_torch.ft import ulfm as _ulfm
            _ulfm.publish_failure(self.state, conn.peer)

    def send(self, peer: int, frag) -> None:
        conn = self._connect(peer)
        if conn.dead:
            # endpoint failover consumed this transport for the peer
            del self._out[peer]
            raise BtlError(f"tcp transport to rank {peer} is dead")
        self.pvar_frags.add(1)
        hdr, payload = wire.encode(frag)
        plen = 0 if payload is None else len(payload)
        # txq holds WHOLE FRAMES (a list of buffers each): retirement
        # and reconnect-resend happen on frame boundaries only, so a
        # resent stream can never start mid-frame.  The payload rides
        # as its own buffer so sendmsg gathers it copy-free.
        if self.reliable:
            seq = conn.tx_seq
            conn.tx_seq = seq + 1
            if self.pay_digest:
                frame = [struct.pack(">I",
                                     _RHDRD.size + len(hdr) + plen)
                         + _RHDRD.pack(_T_DATAD, wire.frame_crc(hdr),
                                       seq,
                                       wire.payload_crc(hdr, payload))
                         + hdr]
            else:
                frame = [struct.pack(">I", _RHDR.size + len(hdr) + plen)
                         + _RHDR.pack(_T_DATA, wire.frame_crc(hdr), seq)
                         + hdr]
        else:
            frame = [struct.pack(">I", len(hdr) + plen) + hdr]
        if plen:
            frame.append(payload
                         if isinstance(payload, (bytes, memoryview))
                         else memoryview(payload))
        if self.reliable:
            # the PRISTINE frame enters the retransmit window before
            # any injection below mangles what goes on the wire —
            # recovery must always have clean bytes to replay
            conn.unacked.append((seq, frame))
            if self._inj is not None \
                    and self._inject(conn, frame, peer):
                return
            if self._nj is not None:
                d = self._nj.maybe_delay_s()
                if d:
                    if self._nj.should_drop():
                        return  # NACK/RTO replays from unacked
                    self._delayed.append(
                        (time.monotonic() + d, conn, frame))
                    return
        conn.txq.append(frame)
        self._drain(conn)

    def _inject(self, conn: _Conn, frame: list, peer: int) -> bool:
        """Fault-injection hook (ompi_tpu_torch/ft_inject): mutate how this
        frame hits the wire.  Returns True when the frame was fully
        handled (possibly by not sending it at all)."""
        act = self._inj.pick(self.rail, peer)
        if act is None:
            return False
        if act == "drop":
            # never hits the wire; the receiver NACKs the gap (or the
            # sender RTOs) and the unacked window replays it
            return True
        if act == "corrupt":
            bad = bytearray(frame[0])
            bad[-1] ^= 0xFF  # flip a bit inside the wire header span
            conn.txq.append([bytes(bad)] + frame[1:])
            self._drain(conn)
            return True
        if act == "corrupt_payload":
            # flip a bit OUTSIDE the header-CRC span (the header CRC
            # stays valid by construction): only the payload digest
            # (btl_tcp_payload_digest) can see this flip
            if len(frame) > 1:
                bad = bytearray(frame[1])
                bad[len(bad) // 2] ^= 0x10
                conn.txq.append([frame[0], bytes(bad)])
                self._drain(conn)
                return True
            head = bytearray(frame[0])
            rh = _RHDRD.size if head[4] == _T_DATAD else _RHDR.size
            hdr = head[4 + rh:]
            if len(hdr) > wire.hdr_span(hdr):
                head[-1] ^= 0x10  # pickle-body tail past the span
                conn.txq.append([bytes(head)])
                self._drain(conn)
                return True
            return False  # fully-covered frame: nothing to flip above CRC
        if act == "dup":
            conn.txq.append(frame)
            conn.txq.append(frame)
            self._drain(conn)
            return True
        if act == "reorder":
            conn.txq.append(frame)
            # swap the last two queued frames — never the head while a
            # partial write is in flight (framing must stay intact)
            if len(conn.txq) >= 2 and (len(conn.txq) > 2
                                       or conn.txoff == 0):
                conn.txq[-1], conn.txq[-2] = conn.txq[-2], conn.txq[-1]
            self._drain(conn)
            return True
        if act == "delay":
            self._delayed.append(
                (time.monotonic() + self._inj.delay_s, conn, frame))
            return True
        if act == "sever":
            conn.txq.append(frame)
            self._drain(conn)
            try:
                conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            return True
        return False

    def _set_wr_interest(self, conn: _Conn) -> None:
        """Write interest only while the queue is non-empty: idle
        sockets must not wake every progress sweep (ref: the
        reference's event-driven send_handler registration)."""
        if conn.dead:
            return
        want = bool(conn.txq)
        if self.reliable:
            # reliable conns stay read-registered for acks (outbound)
            # / data (inbound); only the WRITE bit toggles
            if want == conn.wr_registered:
                return
            kind = "out" if conn.peer >= 0 else "in"
            ev = selectors.EVENT_READ | (
                selectors.EVENT_WRITE if want else 0)
            try:
                self.sel.modify(conn.sock, ev, (kind, conn))
            except (KeyError, ValueError, OSError):
                return
            conn.wr_registered = want
            return
        if want and not conn.wr_registered:
            self._sel_register(conn.sock, selectors.EVENT_WRITE,
                               ("out", conn))
            conn.wr_registered = True
        elif not want and conn.wr_registered:
            try:
                self.sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
            conn.wr_registered = False

    def _drain(self, conn: _Conn) -> int:
        if conn.dead:
            return 0
        sent = 0
        txq = conn.txq
        while txq:
            # gather up to 16 buffers into one vectored send; txoff
            # is the byte offset into the FIRST frame
            bufs = []
            skip = conn.txoff
            for frame in txq:
                for b in frame:
                    if skip:
                        if skip >= len(b):
                            skip -= len(b)
                            continue
                        b = memoryview(b)[skip:]
                        skip = 0
                    bufs.append(b)
                if len(bufs) >= 16:
                    break
            try:
                n = conn.sock.sendmsg(bufs)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                # socket died: reconnect and resend from the first
                # not-fully-sent frame; exhausted reconnects tear the
                # conn down so the next send() fails over
                if self._reconnect(conn):
                    continue
                self._kill_conn(conn)
                break
            sent += n
            # retire fully-sent FRAMES; the offset tracks into the
            # first remaining frame
            n += conn.txoff
            conn.txoff = 0
            while txq:
                flen = sum(len(b) for b in txq[0])
                if n < flen:
                    conn.txoff = n
                    break
                n -= flen
                txq.popleft()
        self._set_wr_interest(conn)
        return sent

    def _ctl_send(self, conn: _Conn, rtype: int, seq: int) -> None:
        """Queue an ACK/NACK on an inbound conn (TCP is full duplex:
        control rides back on the data stream's own socket)."""
        if conn.dead:
            return
        conn.txq.append(self._ctl_frame(rtype, seq))
        self._drain(conn)

    def _pump_rx(self, conn: _Conn) -> int:
        events = 0
        closed = False
        try:
            while True:
                data = conn.sock.recv(1 << 20)
                if not data:
                    closed = True
                    break
                conn.rxbuf += data
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            closed = True
        # parse everything buffered BEFORE dropping a closed socket —
        # the peer's final frags often arrive with the FIN
        buf = conn.rxbuf
        off = 0
        delivered = 0
        ack_due = False
        body = frame = None
        view = memoryview(buf)
        while len(buf) - off >= 4:
            (ln,) = struct.unpack_from(">I", buf, off)
            if len(buf) - off - 4 < ln:
                break
            body = view[off + 4:off + 4 + ln]
            off += 4 + ln
            if not self.reliable:
                self.state.pml.inbox.append(wire.decode(body))
                events += 1
                continue
            rtype, crc, seq = _RHDR.unpack_from(body)
            if rtype == _T_HELLO:
                peer = int(seq)
                conn.rx_peer = peer
                conn.nacked = False
                self._rx_conn[peer] = conn
                self._rx_expected.setdefault(peer, 0)
                # tell the (re)connecting sender where we are so it
                # trims acked frames before replaying
                self._ctl_send(conn, _T_ACK, self._rx_expected[peer])
                events += 1
                continue
            if rtype != _T_DATA and rtype != _T_DATAD:
                continue  # stray control on a data stream: ignore
            frame = body[_RHDRD.size if rtype == _T_DATAD
                         else _RHDR.size:]
            peer = conn.rx_peer
            if peer < 0:
                # hello-first contract violated (mixed reliable
                # settings?): deliver untracked rather than wedge
                self.state.pml.inbox.append(wire.decode(frame))
                events += 1
                continue
            exp = self._rx_expected[peer]
            if seq < exp:
                # duplicate from a window replay: drop, re-ack so the
                # sender retires it
                ack_due = True
                continue
            if conn.nacked:
                continue  # draining a known-bad tail; resend incoming
            if seq > exp:
                # gap — go-back-N: NACK the cursor once and drop this
                # conn's tail; the sender replays on a fresh conn
                self._ctl_send(conn, _T_NACK, exp)
                conn.nacked = True
                continue
            try:
                wire.check_crc(frame, crc)
                if rtype == _T_DATAD:
                    (pcrc,) = struct.unpack_from(
                        "<I", body, _RHDR.size)
                    wire.check_payload_crc(frame, pcrc)
                frag = wire.decode(frame)
            except Exception:
                # CRC mismatch, or a decode that blew up on bytes the
                # narrow header CRC doesn't cover (pickle bodies):
                # corrupt at the cursor — same recovery as a gap.
                self._ctl_send(conn, _T_NACK, exp)
                conn.nacked = True
                continue
            self.state.pml.inbox.append(frag)
            self._rx_expected[peer] = exp + 1
            delivered += 1
            events += 1
            n = self._rx_since_ack.get(peer, 0) + 1
            if n >= max(1, _ack_frames_var.value):
                self._ctl_send(conn, _T_ACK, exp + 1)
                n = 0
            self._rx_since_ack[peer] = n
        # drop live sub-views before resizing the bytearray (a held
        # export makes `del buf[:off]` raise BufferError)
        body = frame = None  # noqa: F841
        view.release()
        if off:
            del buf[:off]
        if self.reliable and not closed and conn.rx_peer >= 0 \
                and (ack_due or delivered):
            # batch-end ack: keeps the sender's window trimmed and its
            # RTO quiet even for tiny exchanges
            self._ctl_send(conn, _T_ACK, self._rx_expected[conn.rx_peer])
            self._rx_since_ack[conn.rx_peer] = 0
        if closed:
            if conn.rx_peer >= 0 \
                    and self._rx_conn.get(conn.rx_peer) is conn:
                del self._rx_conn[conn.rx_peer]
            try:
                self.state.progress.unregister_idle_fd(conn.sock.fileno())
            except OSError:
                pass
            try:
                self.sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
            try:
                conn.sock.close()
            except OSError:
                pass
            conn.dead = True
        return events

    def _retire(self, conn: _Conn, upto: int) -> None:
        while conn.unacked and conn.unacked[0][0] < upto:
            conn.unacked.popleft()

    def _pump_acks(self, conn: _Conn) -> int:
        """Sender side of the reliable channel: drain ACK/NACK frames
        the receiver writes back on our outbound socket."""
        events = 0
        closed = False
        try:
            while True:
                data = conn.sock.recv(65536)
                if not data:
                    closed = True
                    break
                conn.rxbuf += data
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            closed = True
        buf = conn.rxbuf
        off = 0
        now = time.monotonic()
        resend = False
        while len(buf) - off >= 4:
            (ln,) = struct.unpack_from(">I", buf, off)
            if len(buf) - off - 4 < ln:
                break
            rtype, _crc, seq = _RHDR.unpack_from(buf, off + 4)
            off += 4 + ln
            if rtype == _T_ACK:
                self._retire(conn, seq)
                conn.reconnects = 0  # ack progress refills the budget
                conn.last_ack_t = now
                events += 1
            elif rtype == _T_NACK:
                self._retire(conn, seq)
                conn.last_ack_t = now
                resend = True
                events += 1
        if off:
            del buf[:off]
        if resend or (closed and not conn.dead):
            self._force_resend(conn)
        return events

    def progress(self) -> int:
        events = 0
        for key, mask in self.sel.select(timeout=0):
            kind, conn = key.data
            if kind == "accept":
                try:
                    s, _ = self.listener.accept()
                except OSError:
                    continue
                s.setblocking(False)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                c = _Conn(s)
                self._in.append(c)
                self._sel_register(s, selectors.EVENT_READ, ("in", c))
                self.state.progress.register_idle_fd(s.fileno())
                events += 1
            elif kind == "in":
                if mask & selectors.EVENT_READ:
                    events += self._pump_rx(conn)
                if mask & selectors.EVENT_WRITE and conn.txq \
                        and not conn.dead:
                    events += 1 if self._drain(conn) else 0
            elif kind == "out":
                if mask & selectors.EVENT_READ and self.reliable:
                    events += self._pump_acks(conn)
                if mask & selectors.EVENT_WRITE and conn.txq \
                        and not conn.dead:
                    events += 1 if self._drain(conn) else 0
        if self.reliable:
            events += self._tick_reliable()
        return events

    def _tick_reliable(self) -> int:
        ev = 0
        now = time.monotonic()
        if self._delayed:
            held = self._delayed
            due = [e for e in held if e[0] <= now]
            if due:
                self._delayed = [e for e in held if e[0] > now]
                for _t, conn, frame in due:
                    if not conn.dead:
                        conn.txq.append(frame)
                        self._drain(conn)
                        ev += 1
        rto = _rto_var.value
        if rto > 0:
            for conn in list(self._out.values()):
                if conn.dead or not conn.unacked:
                    continue
                if now - conn.last_ack_t > rto:
                    # no ack progress for a full RTO: suspected loss
                    # (or a silently severed peer socket) — replay
                    conn.last_ack_t = now
                    self._force_resend(conn)
                    ev += 1
        return ev

    def ft_reset(self, epoch: int) -> bool:
        """Live-recovery epoch reset (runtime/ft.py): close every
        connection (stale pre-epoch bytes die with the sockets), open
        a fresh listener, and advertise it under the EPOCH modex
        namespace (the rte suffixes keys; the KV proxies cache
        write-once modex values, so a changed address needs a new
        name).  Returns True: the module stays in service."""
        for conn in list(self._out.values()) + self._in:
            try:
                self.sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
            try:
                self.state.progress.unregister_idle_fd(
                    conn.sock.fileno())
            except (OSError, ValueError):
                pass
            try:
                conn.sock.close()
            except OSError:
                pass
        self._out.clear()
        self._in.clear()
        # per-peer stream cursors are SEQUENCE state: the epoch
        # restarts every channel at zero, so a surviving cursor would
        # drop the new epoch's frames as duplicates
        self._rx_expected.clear()
        self._rx_conn.clear()
        self._rx_since_ack.clear()
        self._delayed = []
        try:
            self.sel.unregister(self.listener)
        except (KeyError, ValueError):
            pass
        try:
            self.state.progress.unregister_idle_fd(
                self.listener.fileno())
        except (OSError, ValueError):
            pass
        try:
            self.listener.close()
        except OSError:
            pass
        if_ip = _if_ip_var.value or "127.0.0.1"
        self.listener = socket.socket(socket.AF_INET,
                                      socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET,
                                 socket.SO_REUSEADDR, 1)
        self.listener.bind((if_ip, 0))
        self.listener.listen(self.state.size * 2)
        self.listener.setblocking(False)
        self.sel.register(self.listener, selectors.EVENT_READ,
                          ("accept", None))
        port = self.listener.getsockname()[1]
        self.state.rte.modex_put(f"btl_tcp_addr{self._sfx}",
                                 f"{if_ip}:{port}")
        self.state.rte.modex_put(f"btl_tcp_addrs{self._sfx}",
                                 [f"{if_ip}:{port}"])
        self.state.progress.register_idle_fd(self.listener.fileno())
        return True

    def finalize(self) -> None:
        # flush pending sends before closing (teardown traffic)
        for conn in self._out.values():
            while conn.txq:
                try:
                    conn.sock.setblocking(True)
                    self._drain(conn)
                except OSError:
                    break
        for conn in self._out.values():
            try:
                conn.sock.close()
            except OSError:
                pass
        try:
            self.listener.close()
        except OSError:
            pass


class TcpComponent(BTLComponent):
    name = "tcp"
    priority = 10

    def init_modules(self, state) -> List[BTLModule]:
        if not hasattr(state.rte, "kv") or state.size == 1:
            return []
        rails = max(1, _rails_var.value)
        return [TcpModule(state, rail=r) for r in range(rails)]


btl_framework.add_component(TcpComponent())

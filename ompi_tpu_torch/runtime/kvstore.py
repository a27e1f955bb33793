"""KV rendezvous store: the PMIx analog.

The launcher hosts one TCP server; ranks connect as clients and use
put / blocking-get (modex business-card exchange) / fence (barrier)
/ abort — the exact contract ompi_mpi_init needs from its runtime
(ref: opal/mca/pmix usage at ompi/runtime/ompi_mpi_init.c:654-661;
the modex OPAL_MODEX_SEND/RECV pattern of btl_tcp_component.c:1128).

Wire format: 4-byte big-endian length + JSON object.  Values are
JSON-serializable (byte payloads go hex-encoded; modex values are
small address blobs, never data-plane traffic).
"""

from __future__ import annotations

import hmac
import json
import os
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ompi_tpu_torch.mca.params import registry

_kv_retry_max_var = registry.register(
    "rte", "base", "kv_retry_max", 3, int,
    help="Retries per KV op after a transient server failure "
         "(reconnect + resend; replies are re-awaited only for "
         "idempotent ops)")
_kv_retry_delay_var = registry.register(
    "rte", "base", "kv_retry_delay", 0.05, float,
    help="Base KV retry backoff (exponential, jittered, capped 2 s)")
_kv_replicas_var = registry.register(
    "rte", "base", "kv_replicas", 0, int,
    help="Hot-standby replicas behind the KV server (0 = single "
         "server, the default and the fast path; 1 = one in-process "
         "standby fed by streaming op replication, advertised through "
         "the kv2: multi-endpoint uri so clients fail over when the "
         "primary dies)")
_kv_standby_host_var = registry.register(
    "rte", "base", "kv_standby_host", -1, int,
    help="Failure-domain (host) id the hot standby is placed on.  -1 "
         "= auto: anti-affinity with the primary when the fleet has "
         "more than one host, else co-resident (the in-process "
         "placement).  Explicit ids pin the standby for chaos runs — "
         "a standby sharing the primary's host dies WITH it on a "
         "host kill, wedging every client's endpoint rotation")

# monotonic per-process client ids: fence arrivals are cid-tagged so a
# re-sent arrival (lost reply, or failover to the promoted standby)
# re-registers the waiter without double-counting its weight.  The
# server treats an id as an opaque key; the "t" keeps the port's ids
# apart from the reference client's "pid.n" in a process that loads
# both packages, whose counters run separately
_cid_lock = threading.Lock()
_cid_next = [0]


def _next_cid() -> str:
    with _cid_lock:
        _cid_next[0] += 1
        return f"{os.getpid()}.t{_cid_next[0]}"


_pv_kv = None  # lazy (retries, reconnects, failovers) scoped pvars


def _kv_pvars():
    """Client-side resilience counters, band-scoped so DVM sessions
    (ns 's<sid>') get per-session attribution.  Lazy: obs pulls in
    the MPI state module, which this leaf must not import eagerly."""
    global _pv_kv
    if _pv_kv is None:
        from ompi_tpu_torch import obs as _obs
        _pv_kv = (
            _obs.scoped_pvar(
                "kv", "", "retries",
                help="KV ops re-sent after a transient failure"),
            _obs.scoped_pvar(
                "kv", "", "reconnects",
                help="KV client sockets re-established after a drop"),
            _obs.scoped_pvar(
                "kv", "", "failovers",
                help="KV client endpoint rotations onto a standby "
                     "after the current endpoint refused a connect"),
        )
    return _pv_kv


def job_secret() -> Optional[str]:
    """The per-job control-plane secret (launcher-generated,
    env-forwarded).  The sec/basic analog (ref:
    opal/mca/sec/basic/sec_basic.c — credentials checked at
    connection acceptance): without it any local process could dial
    the rendezvous server and inject aborts or spawns."""
    return os.environ.get("TPUMPI_JOB_SECRET") or None


_DFS_REMOTE = 1 << 30  # proxy fd-namespace offset for forwarded files


def dfs_parse_uri(uri: str) -> Tuple[str, str]:
    """'file://HOST/abs/path' -> (HOST, /abs/path); a bare path is
    ('', path) — local.  (ref: orte/mca/dfs/dfs.h:50 — the uri names
    the host the file lives on.)"""
    if uri.startswith("file://"):
        rest = uri[len("file://"):]
        host, sep, path = rest.partition("/")
        return host, "/" + path if sep else ""
    return "", uri


def _dfs_serve(op: str, msg: dict, fds: Dict[int, int]) -> dict:
    """Serve one dfs request against THIS host's filesystem (the
    daemon/HNP side of orte/mca/dfs — read-only by design).  ``fds``
    is the per-connection descriptor table; the connection's close
    cleans it up."""
    try:
        if op == "dfs_open":
            _, path = dfs_parse_uri(msg["uri"])
            fd = os.open(path, os.O_RDONLY)
            fds[fd] = fd
            return {"fd": fd, "size": os.fstat(fd).st_size}
        fd = fds.get(int(msg.get("fd", -1)), -1)
        if fd < 0:
            return {"error": "bad dfs fd"}
        if op == "dfs_read":
            data = os.pread(fd, int(msg["len"]), int(msg["offset"]))
            return {"data": data.decode("latin-1")}
        if op == "dfs_size":
            return {"size": os.fstat(fd).st_size}
        if op == "dfs_close":
            fds.pop(fd, None)
            os.close(fd)
            return {"ok": True}
        return {"error": f"unknown dfs op {op}"}
    except OSError as e:
        return {"error": str(e)}


def _require_hello(conn, secret: Optional[str]) -> bool:
    """Server side of the hello frame: when a secret is configured,
    the FIRST message must be an authenticating hello.  Returns True
    when the connection may proceed."""
    if not secret:
        return True
    msg = _recv_msg(conn)
    if msg is None:
        return False
    if msg.get("op") != "hello" or not isinstance(
            msg.get("secret"), str) or not hmac.compare_digest(
            msg["secret"], secret):
        try:
            _send_msg(conn, {"error": "unauthenticated"})
        except OSError:
            pass
        try:
            conn.close()
        except OSError:
            pass
        return False
    _send_msg(conn, {"ok": True})
    return True


def _send_msg(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_msg(sock: socket.socket) -> Optional[dict]:
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = struct.unpack(">I", hdr)
    data = b""
    while len(data) < n:
        chunk = sock.recv(n - len(data))
        if not chunk:
            return None
        data += chunk
    return json.loads(data)


class KVServer:
    """Runs inside the launcher (the HNP role)."""

    def __init__(self, nprocs: int, host: str = "127.0.0.1",
                 advertise: Optional[str] = None,
                 replicas: Optional[int] = None,
                 host_id: int = 0,
                 standby_host: Optional[int] = None) -> None:
        """``host`` is the bind address (0.0.0.0 for multi-host jobs);
        ``advertise`` is the address clients are told to dial (the
        HNP's reachable IP when binding wildcard).  ``replicas``
        overrides the rte_base_kv_replicas knob (the standby itself is
        built with replicas=0 so the chain is exactly one deep).
        ``host_id`` homes this server on a fleet failure domain;
        ``standby_host`` places the standby (default: anti-affine per
        rte_base_kv_standby_host — a standby that shares the
        primary's host dies with it on a host kill)."""
        self.nprocs = nprocs
        self.host_id = host_id
        self.secret = job_secret()
        self.data: Dict[str, Any] = {}
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.counters: Dict[str, int] = {}
        self.fences: Dict[str, int] = {}
        self.fence_waiters: Dict[str, List[socket.socket]] = {}
        # fid -> {cid: weight}: which clients already arrived, so a
        # re-sent arrival (lost reply / failover onto the standby)
        # never double-counts its weight
        self.fence_cids: Dict[str, Dict[str, int]] = {}
        # completed-fence memory (bounded): a client whose fence_done
        # reply was lost retries and must get fence_done again, not a
        # fresh one-member fence that parks it forever
        self.fence_done: Dict[str, bool] = {}
        self._fence_done_order: List[str] = []
        # per-namespace aborts (the DVM serve plane: many resident
        # sessions share ONE long-lived server, each under a key
        # namespace).  An abort carrying "ns" poisons only that
        # namespace's blocking gets/takes/fences — peer sessions keep
        # running.  The global `aborted` (no ns) still poisons all.
        self.ns_aborted: Dict[str, Tuple[int, int, str]] = {}
        # O(daemons)-vs-O(ranks) scalability diagnostic: connections
        # ever accepted (daemon KV proxies collapse per-rank traffic
        # onto one upstream connection per node)
        self.connections_served = 0
        self.aborted: Optional[Tuple[int, int, str]] = None
        # dpm: the universe rank space grows as jobs are spawned
        # (ref: ompi/dpm over the PMIx server); mpirun drains
        # spawn_requests and launches when spawn_enabled
        self.universe = nprocs
        self.spawn_enabled = False
        self.spawn_requests: List[dict] = []
        # optional event sinks (the job state machine): called OUTSIDE
        # the lock with activations only (queue puts, never blocking)
        self.on_abort = None
        self.on_spawn = None
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, 0))
        self.sock.listen(nprocs * 4)
        self.addr = (f"{advertise or host}:"
                     f"{self.sock.getsockname()[1]}")
        self._threads: List[threading.Thread] = []
        self._conns: set = set()  # accepted sockets, for crash()
        self._stop = False
        # replication: the standby is a second KVServer fed a stream
        # of normalized mutation records over one socket, applied in
        # arrival order.  Replicate-before-reply: the record is in the
        # standby's TCP receive buffer before the client sees its ack,
        # so a promoted standby can only be MISSING ops the client
        # never saw acknowledged (and will therefore retry).
        self.standby: Optional["KVServer"] = None
        self._repl: Optional[socket.socket] = None
        self.repl_degraded = False
        want_repl = _kv_replicas_var.value if replicas is None \
            else replicas
        if want_repl > 0:
            sb_host = _kv_standby_host_var.value
            if sb_host < 0:  # auto placement
                sb_host = host_id if standby_host is None \
                    else standby_host
            self.standby = KVServer(nprocs, host=host,
                                    advertise=advertise, replicas=0,
                                    host_id=sb_host)
            peer = ("127.0.0.1" if host in ("127.0.0.1", "0.0.0.0")
                    else host, self.standby.sock.getsockname()[1])
            self._repl = socket.create_connection(peer, timeout=10)
            self._repl.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
            if self.secret:
                _send_msg(self._repl, {"op": "hello",
                                       "secret": self.secret})
                if not (_recv_msg(self._repl) or {}).get("ok"):
                    raise ConnectionError("standby refused hello")
            _send_msg(self._repl, {"op": "repl_stream"})
        # chaos: kv_kill arms a deterministic op-count trigger that
        # hard-crashes THIS server (the primary) mid-traffic
        from ompi_tpu_torch import ft_inject
        self._kill = ft_inject.kv_kill_injector() if replicas != 0 \
            else None
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    @property
    def uri(self) -> str:
        """The address doc clients dial: the plain 'host:port' when
        unreplicated, else the versioned multi-endpoint form
        'kv2:<primary>,<standby>' (KVClient rotates through it)."""
        if self.standby is not None:
            return f"kv2:{self.addr},{self.standby.addr}"
        return self.addr

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            if self._stop:
                # crash()/close() raced our in-flight accept(): the
                # kernel kept the listener alive through the syscall
                # and handed us one more connection — a dead server
                # must not serve it
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass
                return
            self.connections_served += 1
            self._conns.add(conn)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _replicate(self, rec: dict) -> None:
        """Stream one mutation record to the standby.  Called UNDER
        self.cv so records hit the wire in apply order.  A dead
        standby degrades the server to single mode permanently (no
        failback: the standby's state is stale the moment the stream
        breaks)."""
        if self._repl is None:
            return
        try:
            _send_msg(self._repl, rec)
        except OSError:
            self.repl_degraded = True
            try:
                self._repl.close()
            except OSError:
                pass
            self._repl = None

    def _apply_repl(self, conn: socket.socket) -> None:
        """Standby side of the stream: apply records until EOF.  No
        per-record replies — the ack domain is TCP delivery, and the
        primary never waits on us."""
        while True:
            rec = _recv_msg(conn)
            if rec is None:
                return
            op = rec.get("op")
            with self.cv:
                if op == "put":
                    self.data[rec["key"]] = rec["value"]
                elif op == "ctr":
                    self.counters[rec["key"]] = rec["value"]
                elif op == "del":
                    self.data.pop(rec["key"], None)
                elif op == "purge":
                    self._purge_locked(rec["prefix"])
                elif op == "fence":
                    self._fence_arrive_locked(rec, None)
                elif op == "abort":
                    self._abort_locked(rec)
                elif op == "spawn_state":
                    self.universe = rec["universe"]
                    self.spawn_requests.append(rec["req"])
                self.cv.notify_all()

    def _purge_locked(self, pfx: str) -> int:
        nd = 0
        for k in [k for k in self.data
                  if isinstance(k, str) and k.startswith(pfx)]:
            del self.data[k]
            nd += 1
        for k in [k for k in self.counters
                  if isinstance(k, str)
                  and (k.startswith(pfx) or
                       k.startswith("claim:" + pfx))]:
            del self.counters[k]
            nd += 1
        # a full-namespace purge ("ns/") is session teardown: clear
        # the poison record and the completed-fence memory too so a
        # reused server never haunts later lookups
        if pfx.endswith("/"):
            self.ns_aborted.pop(pfx[:-1], None)
        for f in [f for f in self.fence_done if f.startswith(pfx)]:
            del self.fence_done[f]
        return nd

    def _fence_done_add_locked(self, fid: str) -> None:
        if fid not in self.fence_done:
            self.fence_done[fid] = True
            self._fence_done_order.append(fid)
            while len(self._fence_done_order) > 4096:
                self.fence_done.pop(self._fence_done_order.pop(0),
                                    None)

    def fence_snapshot(self, prefix: str = "") -> dict:
        """Doctor-facing capture of in-flight (incomplete) fences
        fence id -> accumulated arrival weight,
        parked waiter count, and the per-client arrival map, filtered
        by id prefix (fence ids are ns-prefixed, so a session scope is
        a prefix).  A fence that appears here during a stall names
        exactly who has NOT arrived — the hang doctor's fence-side
        verdict.  Cold path; takes the store lock."""
        with self.cv:
            out: Dict[str, dict] = {}
            for fid, have in self.fences.items():
                if prefix and not fid.startswith(prefix):
                    continue
                out[fid] = {
                    "arrived_weight": have,
                    "waiters": len(self.fence_waiters.get(fid, ())),
                    "arrivals": dict(self.fence_cids.get(fid, {})),
                }
            return out

    def _fence_arrive_locked(self, msg: dict,
                             conn: Optional[socket.socket]
                             ) -> Optional[dict]:
        """Register one (possibly re-sent) fence arrival.  Returns an
        immediate reply dict for ``conn`` (error, or fence_done from
        the completed-fence memory), or None when the arrival parked
        or completed — completion broadcasts fence_done to every
        registered waiter, including ``conn``.  Replicated arrivals
        pass conn=None: the standby accumulates weights without
        waiter sockets, and reconstructs the waiter side from the
        clients' own re-sent arrivals after failover."""
        fid = msg["id"]
        if fid in self.fence_done:
            return {"fence_done": fid} if conn is not None else None
        want = int(msg.get("n") or self.nprocs)
        ns = msg.get("ns")
        ab = self.aborted
        if ab is None and ns is not None:
            ab = self.ns_aborted.get(ns)
        if ab is None and self.ns_aborted:
            # untagged late arrival (e.g. a proxied fence drops the
            # ns tag): fence ids are ns-prefixed "ns/<id>" by
            # KVClient, so recover the scope by prefix
            for a_ns, rec in self.ns_aborted.items():
                if fid.startswith(a_ns + "/"):
                    ab = rec
                    break
        if ab is not None:
            # the abort sweep only releases waiters already parked; a
            # rank fencing AFTER its scope was poisoned must fail here
            # — the aborting rank will never arrive, and re-registering
            # the fence would park this client forever
            if conn is not None:
                return {"error": f"aborted by rank {ab[0]}: {ab[2]}"}
            return None
        cids = self.fence_cids.setdefault(fid, {})
        cid = msg.get("cid")
        if cid is None:  # legacy arrival: never dedups
            cid = f"anon.{len(cids)}"
        if cid not in cids:
            cids[cid] = int(msg.get("weight", 1))
            self.fences[fid] = self.fences.get(fid, 0) + cids[cid]
        if conn is not None:
            ws = self.fence_waiters.setdefault(fid, [])
            if conn not in ws:
                ws.append(conn)
        if self.fences.get(fid, 0) >= want:
            for c in self.fence_waiters.get(fid, []):
                try:
                    _send_msg(c, {"fence_done": fid})
                except OSError:
                    pass
            self.fences.pop(fid, None)
            self.fence_waiters.pop(fid, None)
            self.fence_cids.pop(fid, None)
            self._fence_done_add_locked(fid)
            self.cv.notify_all()
        return None

    def _abort_locked(self, msg: dict) -> Tuple[bool, tuple]:
        ns = msg.get("ns")
        rec = (msg["rank"], msg["code"], msg.get("msg", ""))
        if ns is not None:
            first = ns not in self.ns_aborted
            if first:
                self.ns_aborted[ns] = rec
            rec = self.ns_aborted[ns]
        else:
            first = self.aborted is None
            if first:
                self.aborted = rec
            rec = self.aborted
        # release fence waiters of the poisoned scope with an error:
        # the aborting rank never arrives, so a parked peer must get
        # a diagnosable failure, not a silent hang.  Fence ids are
        # ns-prefixed ("ns/<id>") by KVClient, so the scope is a
        # prefix match; a global abort releases every fence.
        fpfx = f"{ns}/" if ns is not None else ""
        for fid in [f for f in self.fences if f.startswith(fpfx)]:
            for c in self.fence_waiters.get(fid, []):
                try:
                    _send_msg(c, {"error": f"aborted by rank "
                                           f"{rec[0]}: {rec[2]}"})
                except OSError:
                    pass
            self.fences.pop(fid, None)
            self.fence_waiters.pop(fid, None)
            self.fence_cids.pop(fid, None)
        self.cv.notify_all()
        return first, rec

    def _serve(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if not _require_hello(conn, self.secret):
            return
        dfs_fds: Dict[int, int] = {}
        try:
            while True:
                msg = _recv_msg(conn)
                if msg is None:
                    return
                op = msg.get("op") or ""
                if self._kill is not None and op != "hello" \
                        and self._kill.op():
                    # armed kv_kill: die BEFORE processing, exactly
                    # like a SIGKILL between recv and apply — the
                    # client saw no reply and must retry elsewhere
                    self.crash()
                    return
                if op == "hello":
                    # secretless server: ack so mixed configs work
                    _send_msg(conn, {"ok": True})
                elif op == "repl_stream":
                    # this connection IS the primary's replication
                    # feed: we are the standby from here on
                    self._apply_repl(conn)
                    return
                elif op.startswith("dfs_"):
                    _send_msg(conn, _dfs_serve(op, msg, dfs_fds))
                elif op == "put":
                    with self.cv:
                        self.data[msg["key"]] = msg["value"]
                        self._replicate({"op": "put",
                                         "key": msg["key"],
                                         "value": msg["value"]})
                        self.cv.notify_all()
                    _send_msg(conn, {"ok": True})
                elif op == "get":
                    timeout = msg.get("timeout", 60.0)
                    ns = msg.get("ns")
                    with self.cv:
                        deadline_hit = not self.cv.wait_for(
                            lambda: msg["key"] in self.data
                            or self.aborted is not None
                            or (ns is not None
                                and ns in self.ns_aborted),
                            timeout=timeout)
                        ab = self.aborted if self.aborted is not None \
                            else (self.ns_aborted.get(ns)
                                  if ns is not None else None)
                        if ab is not None:
                            _send_msg(conn, {"abort": list(ab)})
                        elif deadline_hit:
                            _send_msg(conn, {"timeout": True})
                        else:
                            _send_msg(conn, {"value": self.data[msg["key"]]})
                elif op == "incr":
                    # atomic fetch-and-add counter, distinct namespace
                    # from put/get data (dpm cid + rendezvous sequencing)
                    with self.cv:
                        v = self.counters.get(msg["key"], 0)
                        self.counters[msg["key"]] = v + 1
                        # replicated as the RESULT, not the op: a
                        # re-applied absolute value is idempotent
                        self._replicate({"op": "ctr",
                                         "key": msg["key"],
                                         "value": v + 1})
                    _send_msg(conn, {"value": v})
                elif op == "uncr":
                    # compensating decrement: roll a ticket back only
                    # if no later ticket was issued meanwhile (dpm
                    # rendezvous-timeout recovery)
                    with self.cv:
                        cur = self.counters.get(msg["key"], 0)
                        ok = cur == msg["expect"] + 1
                        if ok:
                            self.counters[msg["key"]] = msg["expect"]
                            self._replicate({"op": "ctr",
                                             "key": msg["key"],
                                             "value": msg["expect"]})
                    _send_msg(conn, {"ok": ok})
                elif op == "purge":
                    # prefix delete over data AND counters (including
                    # the put_once claim tickets, which live in the
                    # counter namespace as "claim:<key>"): store
                    # hygiene for ULFM notes/tickets at finalize and
                    # respawn epoch rollover
                    pfx = msg["prefix"]
                    with self.cv:
                        nd = self._purge_locked(pfx)
                        self._replicate({"op": "purge",
                                         "prefix": pfx})
                        self.cv.notify_all()
                    _send_msg(conn, {"ok": True, "n": nd})
                elif op == "take":
                    # blocking get that atomically deletes the record:
                    # one-shot rendezvous consumption (dpm accept/connect)
                    timeout = msg.get("timeout", 60.0)
                    ns = msg.get("ns")
                    with self.cv:
                        deadline_hit = not self.cv.wait_for(
                            lambda: msg["key"] in self.data
                            or self.aborted is not None
                            or (ns is not None
                                and ns in self.ns_aborted),
                            timeout=timeout)
                        ab = self.aborted if self.aborted is not None \
                            else (self.ns_aborted.get(ns)
                                  if ns is not None else None)
                        if ab is not None:
                            _send_msg(conn, {"abort": list(ab)})
                        elif deadline_hit:
                            _send_msg(conn, {"timeout": True})
                        else:
                            val = self.data.pop(msg["key"])
                            self._replicate({"op": "del",
                                             "key": msg["key"]})
                            _send_msg(conn, {"value": val})
                elif op == "fence":
                    # weighted arrival: a daemon KV proxy fences ONCE
                    # on behalf of its node's ranks (weight = local
                    # rank count); the fence completes when the summed
                    # weights reach n (grpcomm aggregation analog,
                    # ref: orte/mca/grpcomm — daemons collect their
                    # local procs' contributions).  cid-deduped, so a
                    # retried arrival is safe and the standby rebuilds
                    # in-flight fences from the replicated records.
                    with self.cv:
                        self._replicate({
                            "op": "fence", "id": msg["id"],
                            "cid": msg.get("cid"),
                            "n": msg.get("n"),
                            "weight": msg.get("weight", 1),
                            "ns": msg.get("ns")})
                        reply = self._fence_arrive_locked(msg, conn)
                    if reply is not None:
                        try:
                            _send_msg(conn, reply)
                        except OSError:
                            pass
                    # else: reply rides the completion broadcast
                elif op == "abort":
                    with self.cv:
                        self._replicate({
                            "op": "abort", "rank": msg["rank"],
                            "code": msg["code"],
                            "msg": msg.get("msg", ""),
                            "ns": msg.get("ns")})
                        first, _rec = self._abort_locked(msg)
                    if first and msg.get("ns") is None \
                            and self.on_abort is not None:
                        self.on_abort(self.aborted)
                    _send_msg(conn, {"ok": True})
                elif op == "spawn":
                    # allocate a universe-rank block and hand the
                    # launch to mpirun's supervision loop.  segments =
                    # [{cmd, args, n}] — one world spanning every
                    # segment (MPI_Comm_spawn_multiple shape; plain
                    # spawn is one segment)
                    segments = msg.get("segments") or [{
                        "cmd": msg["cmd"], "args": msg.get("args") or [],
                        "n": int(msg["maxprocs"])}]
                    total = sum(int(s["n"]) for s in segments)
                    with self.cv:
                        if not self.spawn_enabled:
                            _send_msg(conn, {
                                "error": "dynamic spawn is not "
                                         "supported by this launcher"})
                            continue
                        base = self.universe
                        self.universe += total
                        req = {
                            "base": base,
                            "maxprocs": total,
                            "segments": segments,
                            "parent_root": int(msg["parent_root"]),
                        }
                        self.spawn_requests.append(req)
                        self._replicate({"op": "spawn_state",
                                         "universe": self.universe,
                                         "req": req})
                        self.cv.notify_all()
                    if self.on_spawn is not None:
                        self.on_spawn()
                    _send_msg(conn, {"base": base})
        except OSError:
            return
        finally:
            self._conns.discard(conn)
            # a client gone without dfs_close must not leak this
            # long-lived process's descriptors (EMFILE would take
            # down the whole control plane)
            for fd in dfs_fds.values():
                try:
                    os.close(fd)
                except OSError:
                    pass

    def crash(self) -> None:
        """Simulate process death for chaos runs: hard-close the
        listener, every accepted connection and the replication
        stream, with NO orderly teardown — exactly what clients of a
        SIGKILLed server observe.  The standby (its own object with
        its own listener) keeps running and becomes the acting
        primary as clients fail over to it."""
        self._stop = True
        try:
            # shutdown BEFORE close here too: the accept thread is
            # parked in accept() on this listener, which pins the
            # kernel socket past close() — a reconnecting client's
            # handshake would still complete and the "dead" primary
            # would keep serving it.
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        if self._repl is not None:
            try:
                self._repl.close()
            except OSError:
                pass
            self._repl = None
        for c in list(self._conns):
            # shutdown BEFORE close: a serving thread is parked in
            # recv on this socket, which on Linux pins the open file
            # past close() — no FIN would reach the client and parked
            # fence waiters would never notice the death.  shutdown
            # tears the connection down regardless.
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def crash_host(self, host_id: int) -> bool:
        """Sever every endpoint of this server homed on failure
        domain ``host_id`` (the host-kill path: a dying host takes
        its resident KV endpoint with it).  Primary on the victim →
        crash() and the anti-affine standby keeps serving; standby on
        the victim → hard-close it and degrade replication, the
        primary keeps serving.  A co-resident standby (placed WITHOUT
        anti-affinity) dies together with its primary — exactly the
        wedge rte_base_kv_standby_host exists to avoid.  Returns True
        when any endpoint died."""
        hit = False
        if self.standby is not None \
                and self.standby.host_id == host_id:
            self.standby.crash()
            if self._repl is not None:
                try:
                    self._repl.close()
                except OSError:
                    pass
                self._repl = None
            self.repl_degraded = True
            hit = True
        if self.host_id == host_id:
            self.crash()
            hit = True
        return hit

    def close(self) -> None:
        self._stop = True
        try:
            self.sock.close()
        except OSError:
            pass
        if self._repl is not None:
            try:
                self._repl.close()
            except OSError:
                pass
            self._repl = None
        if self.standby is not None:
            self.standby.close()


class KVClient:
    """One per rank process.  Single socket, single lock: rank
    processes are single-threaded through the rte, and every op is
    strictly request/reply.  A second thread must NOT share this
    client (a blocking fence would starve it on the lock).

    Transient-fault tolerance: ops ride ``_request``, which
    reconnects and retries with backoff against a restarted or
    partitioned server, rotating through the kv2: endpoint list when
    the current endpoint refuses the reconnect (standby failover).
    A failed SEND is always retryable (the server discards a partial
    frame on its read error); a lost REPLY is retried only for
    idempotent ops — resending an ``incr`` the server already applied
    would corrupt the job.  ``fence`` is retryable because arrivals
    are cid-deduped server-side.

    ``ns`` scopes every key under "ns/" (put_once claim tickets under
    "claim:ns/", so the server's purge hygiene still sweeps them) and
    tags blocking ops so a namespace-scoped abort poisons only this
    client's session — the isolation contract of the DVM serve plane,
    where many resident sessions share one long-lived server.  The
    per-node KVProxy does not forward the ns abort tag; DVM sessions
    dial the shared server directly on loopback, never a proxy."""

    def __init__(self, addr: str, ns: Optional[str] = None) -> None:
        # 'host:port', or the replicated multi-endpoint uri
        # 'kv2:<primary>,<standby>' — endpoints tried in order, with
        # rotation on connect failure (the failover path)
        self.uri = addr
        eps = addr[4:] if addr.startswith("kv2:") else addr
        self._eps: List[Tuple[str, int]] = []
        for ep in eps.split(","):
            host, port = ep.rsplit(":", 1)
            self._eps.append((host, int(port)))
        self._ep_i = 0
        self.addr = self._eps[0]
        self.ns = ns or None
        # pvar attribution band: DVM session namespaces are "s<sid>"
        self._band = int(ns[1:]) if ns and ns.startswith("s") \
            and ns[1:].isdigit() else 0
        # stable client id for fence-arrival dedup (per client object,
        # monotonic so a recycled id never aliases an old arrival)
        self._cid = _next_cid()
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        err: Optional[OSError] = None
        for _ in range(len(self._eps)):
            try:
                self._sock = self._connect()
                break
            except PermissionError:
                raise
            except OSError as e:  # dead endpoint at dial time: rotate
                err = e
                self._ep_i = (self._ep_i + 1) % len(self._eps)
                self.addr = self._eps[self._ep_i]
        if self._sock is None:
            raise err if err is not None else ConnectionError(
                "kv server unreachable")
        from ompi_tpu_torch import ft_inject
        self._inj = ft_inject.kv_injector(
            int(os.environ.get("TPUMPI_RANK", "0")))
        # gray-failure shaping: seeded added latency
        # on every KV op — the health plane's kv_rtt signal target
        self._nj = ft_inject.net_jitter_injector(
            int(os.environ.get("TPUMPI_RANK", "0")), scope="kv_net")

    def _connect(self) -> socket.socket:
        # with a standby available, fail a dead endpoint fast and
        # rotate instead of waiting out the full single-server grace
        timeout = 60 if len(self._eps) == 1 else 5
        s = socket.create_connection(self.addr, timeout=timeout)
        # connect timeout only: blocking ops (fence with rank skew,
        # modex gets) must not inherit a 60s socket timeout — hang
        # protection is the server-side get timeout + mpirun --timeout
        s.settimeout(None)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        secret = job_secret()
        if secret:
            _send_msg(s, {"op": "hello", "secret": secret})
            resp = _recv_msg(s)
            if not resp or not resp.get("ok"):
                s.close()
                raise PermissionError(
                    "kv server refused the job secret "
                    "(TPUMPI_JOB_SECRET mismatch)")
        return s

    def _drop_sock(self) -> None:
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._sock = None

    def _note_failover(self) -> None:
        """Count + trace one endpoint rotation (the standby-promotion
        moment from this client's point of view).  Diagnostics only —
        never allowed to fail the recovery path."""
        try:
            _kv_pvars()[2].add(1, self._band)
            ep = f"{self.addr[0]}:{self.addr[1]}"
            from ompi_tpu_torch import obs as _obs
            from ompi_tpu_torch import trace
            tr = trace.current_tracer()
            if tr is not None:
                tr.instant("kv_failover", "rte", ep=ep, ns=self.ns)
            _obs.record_event(_obs.EV_KV_FAILOVER, self._band,
                              _obs.intern(ep))
        except Exception:  # noqa: BLE001
            pass

    def _request(self, msg: dict, idempotent: bool = False) -> dict:
        """One request/reply with reconnect + jittered-backoff retry
        (see class docstring for the idempotency contract).
        PermissionError (an OSError subclass!) is never retried — a
        refused job secret will not improve with patience.

        Failover: an endpoint that refuses the reconnect is rotated
        out immediately (no backoff) until every endpoint has been
        tried once — a warm standby is reached within one failed
        connect, keeping kill→first-completed-op MTTR at connect
        latency, not backoff latency.  Backoff applies only once a
        whole rotation came up empty."""
        nep = len(self._eps)
        tries = (1 + max(0, _kv_retry_max_var.value)) * nep
        delay = max(0.005, _kv_retry_delay_var.value)
        last: Optional[Exception] = None
        # with a standby, the first retries are SLEEPLESS — one per
        # endpoint: reconnect-refused + rotate + standby send happen
        # at connect latency, not backoff latency
        fast = nep if nep > 1 else 0
        backoffs = 0
        for attempt in range(tries):
            if attempt:
                _kv_pvars()[0].add(1, self._band)
                if fast > 0:
                    fast -= 1
                else:
                    # shared control-plane pacing (oob.backoff_s);
                    # lazy import — oob itself imports this module
                    from ompi_tpu_torch.runtime import oob
                    time.sleep(oob.backoff_s(backoffs, delay, cap=2.0))
                    backoffs += 1
            if self._nj is not None:
                # net_jitter: delay only, never a drop — KV callers
                # see added RTT, exactly what the health plane scores
                d = self._nj.maybe_delay_s()
                if d:
                    time.sleep(d)
            with self._lock:
                if self._inj is not None and self._inj.sever() \
                        and self._sock is not None:
                    # injected partition: close the socket under our
                    # own feet and let the machinery below recover
                    # (no socket yet — the reference raises
                    # AttributeError here — is already a partition)
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                try:
                    if self._sock is None:
                        self._sock = self._connect()
                        _kv_pvars()[1].add(1, self._band)
                    _send_msg(self._sock, msg)
                except PermissionError:
                    raise
                except OSError as e:
                    last = e
                    connect_failed = self._sock is None
                    self._drop_sock()
                    if nep > 1 and connect_failed:
                        # the endpoint itself is down (not just this
                        # socket): fail over to the next one now
                        self._ep_i = (self._ep_i + 1) % nep
                        self.addr = self._eps[self._ep_i]
                        self._note_failover()
                    continue
                try:
                    resp = _recv_msg(self._sock)
                except OSError:
                    resp = None
                if resp is None:
                    self._drop_sock()
                    if idempotent:
                        last = ConnectionError(
                            "kv server closed mid-reply")
                        continue
                    raise ConnectionError("kv server closed")
                return resp
        if isinstance(last, Exception):
            eps = ",".join(f"{h}:{p}" for h, p in self._eps)
            hint = ""
            if nep > 1:
                # every endpoint in the kv2 list refused a full
                # rotation of reconnects: the classic cause is both
                # endpoints sharing one dead host (standby placed
                # without anti-affinity) — say so instead of leaving
                # the user to decode a bare connect error
                hint = ("; all endpoints are down — if they share a "
                        "host, the standby was placed without host "
                        "anti-affinity (see rte_base_kv_standby_host)")
            raise ConnectionError(
                f"kv server unreachable after {tries} attempts "
                f"across endpoints [{eps}]{hint}: {last}") from last
        raise ConnectionError("kv server unreachable")

    def _k(self, key: str) -> str:
        """Apply the namespace prefix.  Claim tickets keep their
        "claim:" marker OUTSIDE the namespace ("claim:ns/rest") so the
        server's purge branch — which matches counters against both
        ``pfx`` and ``"claim:" + pfx`` — sweeps a namespaced prefix's
        tickets exactly like an un-namespaced one's."""
        if self.ns is None:
            return key
        if key.startswith("claim:"):
            return "claim:" + self.ns + "/" + key[len("claim:"):]
        return f"{self.ns}/{key}"

    def _ns_tag(self, msg: dict) -> dict:
        if self.ns is not None:
            msg["ns"] = self.ns
        return msg

    def put(self, key: str, value: Any) -> None:
        self._request({"op": "put", "key": self._k(key),
                       "value": value}, idempotent=True)

    def get(self, key: str, timeout: float = 60.0) -> Any:
        resp = self._request(self._ns_tag(
            {"op": "get", "key": self._k(key),
             "timeout": timeout}), idempotent=True)
        if "abort" in resp:
            raise RuntimeError(f"job aborted: {resp['abort']}")
        if resp.get("timeout"):
            raise TimeoutError(f"kv get({key}) timed out")
        return resp["value"]

    def incr(self, key: str) -> int:
        """Atomic fetch-and-add on a server-side counter (returns the
        pre-increment value)."""
        resp = self._request({"op": "incr", "key": self._k(key)})
        return int(resp["value"])

    def put_once(self, key: str, value: Any) -> bool:
        """First-writer-wins publish: claims ``key`` through an
        incr-ticket (pre-increment 0 == first claimant) and only the
        winner stores the value.  Losers return False and must
        ``get`` the winner's value.  Gives the ULFM agreement/shrink
        protocols a decide-once primitive without a server-side CAS
        op."""
        if self.incr("claim:" + key) == 0:
            self.put(key, value)
            return True
        return False

    def purge(self, prefix: str) -> int:
        """Delete every data key and counter (including put_once claim
        tickets) under ``prefix``; returns the number removed.
        Idempotent by construction — deleting twice deletes nothing."""
        resp = self._request({"op": "purge", "prefix": self._k(prefix)},
                             idempotent=True)
        return int(resp.get("n", 0))

    def uncr(self, key: str, expect: int) -> bool:
        """Roll back a ticket taken with incr() (which returned
        ``expect``) — succeeds only if no later ticket was issued."""
        resp = self._request({"op": "uncr", "key": self._k(key),
                              "expect": expect})
        return bool(resp["ok"])

    def take(self, key: str, timeout: float = 60.0) -> Any:
        """Blocking get that atomically removes the record — one-shot
        rendezvous consumption."""
        resp = self._request(self._ns_tag(
            {"op": "take", "key": self._k(key), "timeout": timeout}))
        if "abort" in resp:
            raise RuntimeError(f"job aborted: {resp['abort']}")
        if resp.get("timeout"):
            raise TimeoutError(f"kv take({key}) timed out")
        return resp["value"]

    def fence(self, fence_id: str, n: Optional[int] = None,
              weight: int = 1) -> None:
        # cid-tagged, so a re-sent arrival (lost reply, or failover
        # onto the promoted standby mid-fence) re-registers this
        # client's waiter WITHOUT re-adding its weight — retryable,
        # hence idempotent=True; the standby rebuilds the in-flight
        # fence from the replicated arrivals plus these re-sends
        msg: Dict[str, Any] = self._ns_tag(
            {"op": "fence", "id": self._k(fence_id),
             "cid": self._cid})
        if n is not None:
            msg["n"] = n
        if weight != 1:
            msg["weight"] = weight
        try:
            resp = self._request(msg, idempotent=True)
        except ConnectionError as e:
            raise RuntimeError(f"fence {fence_id} failed: {e}") from e
        if "fence_done" not in resp:
            raise RuntimeError(f"fence {fence_id} failed: {resp}")

    def spawn(self, cmd: str, args: List[str], maxprocs: int,
              parent_root: int) -> int:
        """Ask the launcher for `maxprocs` new universe ranks running
        `cmd`; returns the allocated rank base."""
        return self.spawn_multiple(
            [{"cmd": cmd, "args": args, "n": maxprocs}], parent_root)

    def spawn_multiple(self, segments: List[dict],
                       parent_root: int) -> int:
        """Spawn one world made of several (cmd, args, n) segments
        (MPI_Comm_spawn_multiple)."""
        resp = self._request({"op": "spawn", "segments": segments,
                              "parent_root": parent_root})
        if "error" in resp:
            raise RuntimeError(f"MPI_Comm_spawn: {resp['error']}")
        return int(resp["base"])

    def abort(self, rank: int, code: int, msg: str = "") -> None:
        # best-effort by design: the job is going down anyway, and an
        # unreachable server must not mask the original error
        try:
            self._request(self._ns_tag(
                {"op": "abort", "rank": rank,
                 "code": code, "msg": msg}), idempotent=True)
        except (ConnectionError, OSError, RuntimeError):
            pass

    # -- dfs (orte/mca/dfs/app analog: remote read-only file access) ----
    def _dfs_req(self, msg: dict) -> dict:
        resp = self._request(msg)
        if "error" in resp:
            raise OSError(f"dfs: {resp['error']}")
        return resp

    def dfs_open(self, uri: str) -> Tuple[int, int]:
        resp = self._dfs_req({"op": "dfs_open", "uri": uri})
        return int(resp["fd"]), int(resp["size"])

    def dfs_read(self, fd: int, offset: int, n: int) -> bytes:
        resp = self._dfs_req({"op": "dfs_read", "fd": fd,
                              "offset": offset, "len": n})
        return resp["data"].encode("latin-1")

    def dfs_size(self, fd: int) -> int:
        return int(self._dfs_req({"op": "dfs_size",
                                  "fd": fd})["size"])

    def dfs_close(self, fd: int) -> None:
        self._dfs_req({"op": "dfs_close", "fd": fd})

    def close(self) -> None:
        with self._lock:
            self._drop_sock()


class KVProxy:
    """Per-node KV aggregation daemon — the grpcomm/routed analog.

    Runs inside tpud.  Local ranks speak the ordinary KV wire protocol
    to this proxy on loopback; the proxy maintains ONE upstream
    connection to the HNP's KVServer, so the central server sees
    O(daemons) connections instead of O(ranks) (ref:
    orte/mca/grpcomm/brucks — daemons aggregate their local procs'
    collective contributions; orte/mca/routed — control traffic rides
    the daemon overlay, not per-proc sockets).

    Aggregation:
      * fence  — collect ``local_expected`` arrivals, then ONE
        weighted upstream arrival (weight = local rank count); the
        server completes when summed weights reach n;
      * get    — write-once ``modex:`` keys are cached after the
        first fetch, so N local readers cost one upstream read;
        blocking upstream gets poll with short timeouts so one
        waiting rank never serializes the node's other traffic;
      * everything else (put/incr/uncr/take/abort/spawn) forwards.
    """

    def __init__(self, upstream_addr: str, local_expected: int) -> None:
        self.local_expected = max(1, local_expected)
        self.secret = job_secret()
        self.up = KVClient(upstream_addr)
        # dedicated fence channel, reused across fences (a pending
        # fence must never block ops; fences of one job are
        # sequential, so one channel suffices per node)
        self._up_fence: Optional[KVClient] = None
        self._fence_lock = threading.Lock()
        self._cache: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # fid -> [arrivals, result ('done'|'error'), waiter sockets]
        self._fences: Dict[str, list] = {}
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(64)
        self.addr = f"127.0.0.1:{self.sock.getsockname()[1]}"
        self._stop = False
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _poll_upstream(self, op: str, key: str, timeout: float):
        """Blocking get/take forwarded as short polls so the shared
        upstream channel is never held across a long wait."""
        deadline = time.monotonic() + timeout
        while True:
            left = deadline - time.monotonic()
            step = min(0.2, max(0.01, left))
            try:
                if op == "get":
                    return {"value": self.up.get(key, timeout=step)}
                return {"value": self.up.take(key, timeout=step)}
            except TimeoutError:
                if time.monotonic() >= deadline:
                    return {"timeout": True}
            except RuntimeError as e:  # job abort rides the reply
                return {"abort": str(e)}

    def _dfs_upstream(self, msg: dict) -> dict:
        with self.up._lock:
            _send_msg(self.up._sock, msg)
            resp = _recv_msg(self.up._sock)
        return resp or {"error": "upstream gone"}

    def _serve(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if not _require_hello(conn, self.secret):
            return
        dfs_fds: Dict[int, int] = {}
        dfs_owner: Dict[int, str] = {}  # forwarded fd -> remote host
        try:
            while True:
                msg = _recv_msg(conn)
                if msg is None:
                    return
                op = msg.get("op") or ""
                if op == "hello":
                    _send_msg(conn, {"ok": True})
                elif op.startswith("dfs_"):
                    # client-visible REMOTE fds are offset by _DFS_REMOTE
                    # so they live in a namespace disjoint from this
                    # node's os fds (a collision would silently route
                    # local reads to the wrong remote file)
                    fd_in = int(msg.get("fd", -1))
                    if op == "dfs_open":
                        host = dfs_parse_uri(msg.get("uri", ""))[0]
                        local = host in (
                            "", "localhost",
                            os.environ.get("TPUMPI_NODE_NAME", ""))
                        if local:
                            _send_msg(conn,
                                      _dfs_serve(op, msg, dfs_fds))
                        else:
                            resp = self._dfs_upstream(msg)
                            if "fd" in resp:
                                up = int(resp["fd"])
                                dfs_owner[_DFS_REMOTE + up] = up
                                resp["fd"] = _DFS_REMOTE + up
                            _send_msg(conn, resp)
                    elif fd_in in dfs_owner:
                        fwd = dict(msg)
                        fwd["fd"] = dfs_owner[fd_in]
                        resp = self._dfs_upstream(fwd)
                        if op == "dfs_close":
                            dfs_owner.pop(fd_in, None)
                        _send_msg(conn, resp)
                    else:
                        _send_msg(conn, _dfs_serve(op, msg, dfs_fds))
                elif op == "put":
                    self.up.put(msg["key"], msg["value"])
                    _send_msg(conn, {"ok": True})
                elif op == "get":
                    key = msg["key"]
                    with self._lock:
                        hit = self._cache.get(key)
                    if hit is not None:
                        _send_msg(conn, {"value": hit})
                        continue
                    resp = self._poll_upstream(
                        "get", key, msg.get("timeout", 60.0))
                    if "value" in resp and key.startswith("modex:"):
                        # modex keys are write-once per rank: safe to
                        # serve every later local reader from cache
                        with self._lock:
                            self._cache[key] = resp["value"]
                    _send_msg(conn, resp)
                elif op == "take":
                    _send_msg(conn, self._poll_upstream(
                        "take", msg["key"], msg.get("timeout", 60.0)))
                elif op == "incr":
                    _send_msg(conn, {"value": self.up.incr(msg["key"])})
                elif op == "uncr":
                    _send_msg(conn, {"ok": self.up.uncr(
                        msg["key"], msg["expect"])})
                elif op == "purge":
                    pfx = msg["prefix"]
                    with self._lock:
                        for k in [k for k in self._cache
                                  if k.startswith(pfx)]:
                            del self._cache[k]
                    _send_msg(conn,
                              {"ok": True,
                               "n": self.up.purge(pfx)})
                elif op == "abort":
                    try:
                        self.up.abort(msg["rank"], msg["code"],
                                      msg.get("msg", ""))
                    except (RuntimeError, OSError):
                        pass
                    _send_msg(conn, {"ok": True})
                elif op == "fence":
                    self._fence(conn, msg)
                elif op == "spawn":
                    with self.up._lock:
                        _send_msg(self.up._sock, msg)
                        resp = _recv_msg(self.up._sock)
                    _send_msg(conn, resp or {"error": "upstream gone"})
        except OSError:
            return
        finally:
            for fd in dfs_fds.values():
                try:
                    os.close(fd)
                except OSError:
                    pass
            for cfd, up in dfs_owner.items():
                try:
                    self._dfs_upstream({"op": "dfs_close", "fd": up})
                except Exception:
                    pass

    def _fence(self, conn: socket.socket, msg: dict) -> None:
        fid = msg["id"]
        release = None
        with self._cv:
            ent = self._fences.setdefault(fid, [0, None, []])
            ent[0] += 1
            ent[2].append(conn)
            if ent[0] == self.local_expected:
                release = ent
        if release is None:
            return  # reply comes when the node's last rank arrives
        # last local arrival: ONE weighted upstream fence on the
        # dedicated fence channel
        try:
            with self._fence_lock:
                if self._up_fence is None:
                    # the full uri, not the current endpoint: the
                    # fence channel must inherit the failover list
                    self._up_fence = KVClient(self.up.uri)
                self._up_fence.fence(fid, n=msg.get("n"),
                                     weight=self.local_expected)
            reply = {"fence_done": fid}
        except (RuntimeError, OSError) as e:
            reply = {"error": f"fence failed: {e}"}
        with self._cv:
            ent = self._fences.pop(fid)
        for c in ent[2]:
            try:
                _send_msg(c, reply)
            except OSError:
                pass

    def close(self) -> None:
        self._stop = True
        try:
            self.sock.close()
        except OSError:
            pass
        try:
            self.up.close()
        except OSError:
            pass
        if self._up_fence is not None:
            try:
                self._up_fence.close()
            except OSError:
                pass

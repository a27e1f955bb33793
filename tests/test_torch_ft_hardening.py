"""The transient-fault hardening through the port, with the reference
beside it: wire CRCs (ompi_tpu_torch/btl/wire.py), the progress
interrupt's suppression and deferral and its stale-fd repair
(runtime/progress.py), the KV client's retry semantics
(runtime/kvstore.py), shmem ``set_lock``'s ticket retirement on
timeout (shmem/__init__.py), the rendezvous engine's epoch reset
(``TpuRndvEngine.ft_reset``, btl/tpu.py), vprotocol's ack-watermark
refresh (pml/vprotocol.py) and ``cr_arrived`` against transport
duplicates (pml/ob1.py).

The analogs of tests/test_ft_hardening.py's tests; each body runs
through both packages (ids ``port`` and ``ref``).  Two of its fifteen
have port analogs elsewhere, named here instead of duplicated:
``test_heartbeat_silence_declares_daemon_lost`` is held by
tests/test_torch_fleet.py::test_heartbeat_silence_declares_host_lost
and tests/test_torch_multinode_faults.py::test_daemon_kill_terminates_job
(a daemon that stops beating is declared lost), and
``test_reconnect_grace_holds_daemon_lost`` by
tests/test_torch_multinode_faults.py::test_oob_sever_daemon_reconnects
(a dropped channel re-registers inside the grace and the job never
notices).
"""

import socket
import threading
import time
import types

import numpy as np
import pytest


def _pkg(name):
    if name == "port":
        import ompi_tpu_torch as top
        from ompi_tpu_torch import cr, shmem
        from ompi_tpu_torch.btl import tpu, wire
        from ompi_tpu_torch.mca.params import registry
        from ompi_tpu_torch.pml import ob1, vprotocol
        from ompi_tpu_torch.runtime import kvstore, progress
        from ompi_tpu_torch.testing import run_ranks
    else:
        import ompi_tpu as top
        from ompi_tpu import cr, shmem
        from ompi_tpu.btl import tpu, wire
        from ompi_tpu.mca.params import registry
        from ompi_tpu.pml import ob1, vprotocol
        from ompi_tpu.runtime import kvstore, progress
        from ompi_tpu.testing import run_ranks
    return types.SimpleNamespace(
        name=name, top=top, cr=cr, shmem=shmem, tpu=tpu, wire=wire,
        registry=registry, ob1=ob1, vprotocol=vprotocol, kvstore=kvstore,
        progress=progress, run_ranks=run_ranks)


@pytest.fixture(params=["port", "ref"])
def pkg(request):
    return _pkg(request.param)


# ---- wire frame CRCs ------------------------------------------------

def test_wire_crc_header_corruption_detected(pkg):
    wire = pkg.wire
    frame = bytearray(b"\x00" + bytes(range(120)))  # unknown code:
    crc = wire.frame_crc(frame)                     # span = 64
    wire.check_crc(frame, crc)  # pristine passes
    bad = bytearray(frame)
    bad[10] ^= 0xFF
    with pytest.raises(wire.CorruptFrame):
        wire.check_crc(bad, crc)


def test_wire_crc_covers_header_span_only(pkg):
    """The CRC protects the parsed header region (hdr_span); payload
    integrity past it is the datatype engine's concern.  A flip past
    the span must NOT trip the header check.  Both packages give the
    same CRC for the same frame."""
    wire = pkg.wire
    frame = bytearray(b"\x00" + bytes(range(120)))
    assert wire.hdr_span(frame) == 64
    crc = wire.frame_crc(frame)
    assert crc == _pkg("ref").wire.frame_crc(frame)
    tail = bytearray(frame)
    tail[100] ^= 0xFF
    wire.check_crc(tail, crc)


def test_wire_hdr_span_short_frame(pkg):
    wire = pkg.wire
    short = bytearray(b"\x00\x01\x02")
    assert wire.hdr_span(short) == 3
    wire.check_crc(short, wire.frame_crc(short))


# ---- Progress: interrupt suppression / deferral / stale fds ---------

def test_progress_suppressed_interrupt_discarded(pkg):
    p = pkg.progress.Progress()
    p.interrupt = RuntimeError("late ft interrupt")
    p.suppress_interrupts = True
    p.progress()  # must not raise
    assert p.interrupt is None


def test_progress_deferred_interrupt_held_then_raised(pkg):
    p = pkg.progress.Progress()
    p.interrupt = RuntimeError("recovery wanted")
    with p.deferred_interrupts():
        p.progress()  # held: checkpoint write in flight
        assert p.interrupt is not None
    with pytest.raises(RuntimeError, match="recovery wanted"):
        p.progress()
    assert p.interrupt is None


def test_progress_idle_fd_reregister_after_reuse(pkg):
    """A transport socket closed without unregistering leaves a stale
    selector entry; a new socket reusing the fd number must still
    register cleanly."""
    p = pkg.progress.Progress()
    s1 = socket.socket()
    fd1 = s1.fileno()
    p.register_idle_fd(fd1, drain=lambda: None)
    s1.close()  # selector entry for fd1 is now stale
    s2 = socket.socket()
    try:
        if s2.fileno() != fd1:  # Linux reuses the lowest free fd
            pytest.skip("OS did not reuse the fd number")
        p.register_idle_fd(s2.fileno())  # must repair, not raise
        assert fd1 not in p._idle_drains  # stale drain hook dropped
    finally:
        s2.close()


# ---- KV client retry/backoff ----------------------------------------

class _FlakyKV:
    """Minimal KV server that kills the first ``fail_replies``
    connections right after reading a request (send consumed, reply
    lost) — the exact shape of a mid-op partition."""

    def __init__(self, kvstore, fail_replies: int) -> None:
        self._recv, self._send = kvstore._recv_msg, kvstore._send_msg
        self.fail_replies = fail_replies
        self.requests: list = []
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.addr = "127.0.0.1:%d" % self.sock.getsockname()[1]
        self._stop = False
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self) -> None:
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            try:
                while True:
                    msg = self._recv(conn)
                    if msg is None:
                        break
                    self.requests.append(msg)
                    if self.fail_replies > 0:
                        self.fail_replies -= 1
                        conn.close()  # reply lost
                        break
                    self._send(conn, {"ok": True, "value": msg})
            except OSError:
                pass

    def close(self) -> None:
        self._stop = True
        try:
            self.sock.close()
        except OSError:
            pass


@pytest.fixture
def kv(pkg):
    reg = pkg.registry
    old = reg.get("rte_base_kv_retry_delay", 0.05)
    reg.set("rte_base_kv_retry_delay", "0.01")
    servers = []

    def make(fail_replies):
        srv = _FlakyKV(pkg.kvstore, fail_replies)
        servers.append(srv)
        return srv, pkg.kvstore.KVClient(srv.addr)
    yield make
    for srv in servers:
        srv.close()
    reg.set("rte_base_kv_retry_delay", str(old))


def test_kv_idempotent_op_retried_through_lost_reply(kv):
    srv, cli = kv(1)
    resp = cli._request({"op": "probe"}, idempotent=True)
    assert resp["ok"]
    # the op was SENT twice (first reply lost, retried)
    assert len(srv.requests) == 2
    cli.close()


def test_kv_nonidempotent_lost_reply_raises(kv):
    """A lost reply to a non-idempotent op (incr, fence, spawn) must
    surface, never silently resend: the server may already have
    applied it."""
    srv, cli = kv(1)
    with pytest.raises(ConnectionError):
        cli._request({"op": "probe"}, idempotent=False)
    assert len(srv.requests) == 1  # exactly once on the wire
    cli.close()


def test_kv_send_failure_always_retried(kv):
    """A severed socket discovered at SEND time is retryable for any
    op: the server never saw (a complete frame of) the request."""
    srv, cli = kv(0)
    cli._sock.close()  # partition before the op
    resp = cli._request({"op": "probe"}, idempotent=False)
    assert resp["ok"]
    cli.close()


# ---- shmem: set_lock timeout retires its ticket ---------------------

def test_set_lock_timeout_does_not_wedge_lock(pkg):
    shmem = pkg.shmem

    def fn(comm):
        ctx = shmem.init(comm)
        try:
            lock = ctx.malloc(1, np.int64)
            ctx.barrier_all()
            if comm.rank == 0:
                ctx.set_lock(lock)
            comm.Barrier()
            if comm.rank == 1:
                # held by rank 0: time out, and the abandoned ticket
                # must be retired — else the lock wedges forever
                with pytest.raises(TimeoutError):
                    ctx.set_lock(lock, timeout=0.4)
            comm.Barrier()
            if comm.rank == 0:
                ctx.clear_lock(lock)
            comm.Barrier()
            # both ranks take and release it again, in rank order:
            # proves no ghost ticket is holding the queue
            for turn in range(comm.size):
                if comm.rank == turn:
                    ctx.set_lock(lock, timeout=10.0)
                    ctx.clear_lock(lock)
                comm.Barrier()
            return True
        finally:
            shmem.finalize()

    assert all(pkg.run_ranks(2, fn))


# ---- btl/tpu rendezvous engine epoch reset --------------------------

def test_rndv_engine_ft_reset_clears_tables(pkg):
    state = types.SimpleNamespace(progress=types.SimpleNamespace(
        register=lambda *a, **k: None))
    eng = pkg.tpu.TpuRndvEngine(state)
    flat = np.arange(32, dtype=np.float32)
    x1 = eng.begin_send(flat)
    x2 = eng.begin_send(flat)
    eng._gc_tombstones.add(99)
    eng.staged_bytes = 4096
    eng._inflight.append(("req", 4096, None))
    eng.ft_reset()
    assert eng.pending == {} and eng._gc_tombstones == set()
    assert eng._inflight == [] and eng.staged_bytes == 0
    # the id space must stay MONOTONE across the epoch: a recycled
    # xid would let a stale pull address a new transfer
    x3 = eng.begin_send(flat)
    assert x3 > max(x1, x2, 99)


# ---- vprotocol: periodic ack-watermark refresh ----------------------

def test_vprotocol_ack_refresh_resends_watermark(pkg, tmp_path):
    """Every Nth ack tick bypasses the already-acked skip, so a
    watermark whose ack frame died on the wire is re-sent (acks are
    idempotent)."""
    reg = pkg.registry
    store = str(tmp_path / "store")
    reg.set("pml_vprotocol", "pessimist")
    reg.set("vprotocol_pessimist_ack_interval_s", "0.01")
    reg.set("vprotocol_pessimist_ack_refresh_ticks", "2")
    try:
        def fn(comm):
            v = pkg.vprotocol.find(comm.state.pml)
            assert v is not None
            if comm.rank == 0:
                comm.Send(np.arange(4, dtype=np.float64), 1, tag=3)
                comm.Barrier()
                comm.Barrier()
                return True
            got = np.empty(4)
            comm.Recv(got, 0, tag=3)
            # a local snapshot makes the consumed watermark durable —
            # only durable watermarks are ever acked
            pkg.cr.checkpoint_local(comm, {"ok": 1}, store_dir=store)
            cid = comm.cid
            key = next(k for k in v._durable if k[0] == cid)
            v._acked[key] = v._durable[key]  # pretend ack delivered
            comm.Barrier()
            sent = []
            orig = v._base._ep

            def spying_ep(gsrc):
                sent.append(gsrc)
                return orig(gsrc)

            v._base._ep = spying_ep
            deadline = time.monotonic() + 5.0
            while not sent and time.monotonic() < deadline:
                comm.state.progress.progress()
                time.sleep(0.005)
            v._base._ep = orig
            assert sent, "refresh tick never re-sent the watermark"
            comm.Barrier()
            return True

        assert all(pkg.run_ranks(2, fn))
    finally:
        reg.set("pml_vprotocol", "")
        reg.set("vprotocol_pessimist_ack_interval_s", "0.25")
        reg.set("vprotocol_pessimist_ack_refresh_ticks", "8")


# ---- C/R bookmark vs transport duplicates ---------------------------

def test_cr_arrived_ignores_transport_duplicate_envelopes(pkg):
    """A reconnect-resent duplicate envelope is dropped by the pml
    sequence gate and must not inflate cr_arrived: quiesce balances
    sender sent against receiver arrived, so one phantom arrival
    stalls every later checkpoint."""
    MATCH = pkg.ob1.MATCH

    def fn(comm):
        sub = comm.dup()  # private cid: never pollute WORLD's seq space
        pml = sub.state.pml
        cid = sub.cid
        base = pml._next_seq.get((cid, 0), 0)
        before = pml.cr_arrived.get(0, 0)
        first = (MATCH, cid, 0, 5, base, 0, b"first")
        pml._handle(first)
        pml._handle(first)  # transport duplicate: dropped, uncounted
        assert pml.cr_arrived.get(0, 0) == before + 1
        # out-of-order copy parked, duplicated while parked, then the
        # gap fills: exactly three real messages counted overall
        ahead = (MATCH, cid, 0, 5, base + 2, 0, b"third")
        pml._handle(ahead)
        pml._handle(ahead)  # duplicate of a parked envelope
        pml._handle((MATCH, cid, 0, 5, base + 1, 0, b"second"))
        assert pml.cr_arrived.get(0, 0) == before + 3
        # exactly-once delivery: three distinct messages, no copies
        assert sorted(m.payload for m in pml._unexpected.get(cid, [])) \
            == [b"first", b"second", b"third"]
        pml._unexpected.get(cid, []).clear()  # consumed: quiet finalize

    pkg.run_ranks(1, fn)

"""The port's KV rendezvous store (runtime/kvstore.py): put / get /
fence / abort, the node proxy, the job secret, the replicated
primary's failover and the KV fault injectors — and cross-talk with the
reference's store in one process (the port's client against the
reference's server and the reverse, a fence of mixed clients, the
frames byte for byte), which shows the wire protocol is unchanged."""

import socket
import threading
import time

import pytest

from ompi_tpu.runtime import kvstore as ref_kv
from ompi_tpu_torch import ft_inject
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.runtime import kvstore

PKGS = {"port": kvstore, "ref": ref_kv}


@pytest.fixture
def knobs():
    saved = {}

    def set_(**kv):
        for k, v in kv.items():
            saved.setdefault(k, registry.get(k))
            registry.set(k, v)
    yield set_
    for k, v in saved.items():
        registry.set(k, v)


def ops(c):
    """One op sequence; returns what every op answered."""
    out = []
    c.put("a/x", {"v": [1, 2, 3]})
    out.append(c.get("a/x", timeout=10))
    out.append([c.incr("a/ctr") for _ in range(3)])
    out.append(c.put_once("a/once", "first"))
    out.append(c.put_once("a/once", "second"))
    out.append(c.get("a/once", timeout=10))
    out.append(c.uncr("a/ctr", 2))  # the last ticket rolls back
    out.append(c.uncr("a/ctr", 0))  # an older one cannot
    c.put("a/tk", 7)
    out.append(c.take("a/tk", timeout=10))
    out.append(c.purge("a/"))
    return out


def test_put_get_incr_take_purge():
    srv = kvstore.KVServer(1)
    c = kvstore.KVClient(srv.addr)
    try:
        assert ops(c) == [{"v": [1, 2, 3]}, [0, 1, 2], True, False,
                          "first", True, False, 7, 4]
        with pytest.raises(Exception):
            c.get("missing", timeout=0.2)
    finally:
        c.close()
        srv.close()


def test_blocking_get_wakes_on_put():
    srv = kvstore.KVServer(2)
    a, b = kvstore.KVClient(srv.addr), kvstore.KVClient(srv.addr)
    got = []
    t = threading.Thread(target=lambda: got.append(a.get("late", 10)))
    t.start()
    time.sleep(0.2)
    b.put("late", "here")
    t.join(10)
    assert got == ["here"]
    a.close(), b.close(), srv.close()


def test_fence_releases_all_and_only_all():
    n = 4
    srv = kvstore.KVServer(n)
    cs = [kvstore.KVClient(srv.addr) for _ in range(n)]
    done = []
    lock = threading.Lock()

    def arrive(c, i):
        c.fence("f1", n=n)
        with lock:
            done.append(i)

    ts = [threading.Thread(target=arrive, args=(c, i))
          for i, c in enumerate(cs[:-1])]
    for t in ts:
        t.start()
    time.sleep(0.3)
    assert done == []  # three of four arrived: nobody leaves
    arrive(cs[-1], n - 1)
    for t in ts:
        t.join(10)
    assert sorted(done) == list(range(n))
    for c in cs:
        c.close()
    srv.close()


def test_abort_reaches_the_launcher_and_blocked_getters():
    srv = kvstore.KVServer(2)
    seen = []
    srv.on_abort = seen.append
    a, b = kvstore.KVClient(srv.addr), kvstore.KVClient(srv.addr)
    errs = []

    def wait():
        try:
            a.get("never", timeout=10)
        except RuntimeError as e:
            errs.append(str(e))

    t = threading.Thread(target=wait)
    t.start()
    time.sleep(0.2)
    b.abort(1, 42, "bye")
    t.join(10)
    assert seen and tuple(seen[0])[:2] == (1, 42)
    assert errs and "aborted" in errs[0]
    a.close(), b.close(), srv.close()


def test_proxy_aggregates_fences_and_caches_modex():
    """KVProxy: local ranks fence through the proxy, which sends ONE
    weighted arrival upstream; write-once modex keys are read upstream
    once."""
    srv = kvstore.KVServer(3)
    px = kvstore.KVProxy(srv.addr, local_expected=2)
    local = [kvstore.KVClient(px.addr) for _ in range(2)]
    direct = kvstore.KVClient(srv.addr)
    direct.put("modex:0:card", "addr0")
    assert [c.get("modex:0:card", timeout=10) for c in local] == \
        ["addr0", "addr0"]
    ts = [threading.Thread(target=c.fence, args=("pf", 3))
          for c in local]
    for t in ts:
        t.start()
    direct.fence("pf", n=3)
    for t in ts:
        t.join(10)
        assert not t.is_alive()
    for c in local + [direct]:
        c.close()
    px.close()
    srv.close()


@pytest.mark.parametrize("server,client", [("ref", "port"),
                                           ("port", "ref")])
def test_cross_talk_parity(server, client):
    """The port's client against the reference's server and the
    reverse: every op answers what it answers within one package."""
    srv = PKGS[server].KVServer(1)
    c = PKGS[client].KVClient(srv.addr)
    try:
        got = ops(c)
    finally:
        c.close()
        srv.close()
    srv = PKGS[server].KVServer(1)
    c = PKGS[server].KVClient(srv.addr)
    try:
        want = ops(c)
    finally:
        c.close()
        srv.close()
    assert got == want


@pytest.mark.parametrize("server", ["ref", "port"])
def test_cross_talk_mixed_fence(server):
    """Two clients of each package fence together on one server.  The
    two packages' client-id counters are set equal first: the fence
    dedups arrivals by client id, so ids minted alike by both
    packages would count two clients as one and never complete."""
    kvstore._cid_next[0] = ref_kv._cid_next[0] = max(
        kvstore._cid_next[0], ref_kv._cid_next[0])
    srv = PKGS[server].KVServer(4)
    cs = [PKGS[p].KVClient(srv.addr) for p in ("port", "ref") * 2]
    ts = [threading.Thread(target=c.fence, args=("mixed", 4), daemon=True)
          for c in cs]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
            assert not t.is_alive()
    finally:
        srv.close()
        for c, t in zip(cs, ts):
            if not t.is_alive():  # a parked fence holds its client
                c.close()


def test_frames_byte_identical():
    """``_send_msg`` writes the same bytes in both packages."""
    msgs = [{"op": "put", "key": "modex:3:btl_tcp_addr",
             "value": "127.0.0.1:4242"},
            {"op": "fence", "id": "job-1:f2", "cid": "9.1", "n": 8},
            {"op": "abort", "rank": 1, "code": 42, "msg": "é"}]
    for m in msgs:
        outs = []
        for mod in (kvstore, ref_kv):
            a, b = socket.socketpair()
            mod._send_msg(a, m)
            a.close()
            outs.append(b.recv(1 << 16))
            b.close()
        assert outs[0] == outs[1], m


def test_kill_injectors_disabled_by_default():
    assert not ft_inject.enabled()
    assert ft_inject.kv_kill_injector() is None
    assert ft_inject.kv_injector(0) is None
    assert ft_inject.net_jitter_injector(0) is None
    assert ft_inject.btl_injector(0) is None


def test_kill_injector_fires_exactly_once_at_count():
    ki = ft_inject.KillInjector("kv", 5)
    assert [ki.op() for _ in range(10)] == \
        [False] * 4 + [True] + [False] * 5
    assert ft_inject.KillInjector("kv", 0.02).after_ops == 64


def test_kv_kill_class_crashes_primary_at_op_count(knobs):
    """ft_inject_plan=kv_kill:N makes the replicated primary crash
    serving its Nth op; the client fails over to the standby and every
    op lands."""
    knobs(ft_inject_plan="kv_kill:10")
    srv = kvstore.KVServer(2, replicas=1)
    assert srv._kill is not None
    c = kvstore.KVClient(srv.uri)
    for k in range(30):
        c.put(f"a/{k}", k)
    assert c.get("a/29", timeout=10) == 29
    assert c.get("a/5", timeout=10) == 5
    c.close()
    srv.close()
    knobs(ft_inject_plan="kv_kill:10")
    srv = kvstore.KVServer(1, replicas=0)
    assert srv._kill is None  # never the only copy
    srv.close()


def test_kv_partition_and_jitter_ops_survive(knobs):
    """kv_partition severs the client's socket before some ops and
    net_jitter delays others: every op still lands (reconnect and
    retry), and the reconnects are counted."""
    knobs(ft_inject_plan="kv_partition:0.3,net_jitter:0.3",
          ft_inject_seed=7, ft_inject_skip=0, ft_inject_net_jitter_ms=1)
    before = kvstore._kv_pvars()[1].read()
    srv = kvstore.KVServer(1)
    c = kvstore.KVClient(srv.addr)
    assert c._inj is not None and c._nj is not None
    for k in range(40):
        c.put(f"p/{k}", k)
    assert [c.get(f"p/{k}", timeout=10) for k in range(40)] == \
        list(range(40))
    assert kvstore._kv_pvars()[1].read() > before
    c.close()
    srv.close()

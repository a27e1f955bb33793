"""Persistent requests and buffered sends through the port
(ompi_tpu_torch/pml/persistent.py, the communicator's ``Send_init`` /
``Ssend_init`` / ``Bsend_init`` / ``Recv_init`` / ``Bsend`` /
``Ibsend`` and the package's ``attach_buffer`` / ``detach_buffer``),
with the reference beside it.

The analogs of tests/test_persistent.py's ten tests that need no flat
``mpi.py`` surface; its three ``test_flat_mpi_*`` tests are in
tests/test_torch_mpi_surface.py.  Each test body runs once through each
package (ids ``port`` and ``ref``) on the same numpy payloads made
from a seed, and the two packages' results are compared where a test
returns values.  Tolerance: bytes.

Pinned divergence: pt2pt takes host buffers only in the port, so a
persistent or buffered send of a tensor raises TypeError where the
communicator parses the buffer, as ``Send`` does
(``test_divergence_persistent_and_bsend_refuse_tensors``).
"""

import types

import numpy as np
import pytest
import torch

SEED = 20261018


def _pkg(name):
    if name == "port":
        import ompi_tpu_torch as top
        from ompi_tpu_torch.pml import persistent, request
        from ompi_tpu_torch.testing import run_ranks
    else:
        import ompi_tpu as top
        from ompi_tpu.pml import persistent, request
        from ompi_tpu.testing import run_ranks
    return types.SimpleNamespace(
        run_ranks=run_ranks, attach_buffer=top.attach_buffer,
        detach_buffer=top.detach_buffer, start_all=persistent.start_all,
        test_all=request.test_all, wait_any=request.wait_any)


@pytest.fixture(params=["port", "ref"])
def pkg(request):
    return _pkg(request.param)


def _payloads(n, length, dtype=np.float64):
    rng = np.random.default_rng(SEED)
    return [rng.standard_normal(length).astype(dtype) for _ in range(n)]


def test_persistent_ping_loop(pkg):
    pay = _payloads(5, 16)

    def fn(comm):
        out = []
        if comm.rank == 0:
            buf = np.zeros(16, dtype=np.float64)
            req = comm.Send_init(buf, dest=1, tag=7)
            for it in range(5):
                buf[:] = pay[it]  # refresh payload between starts
                req.start()
                req.wait()
        else:
            buf = np.empty(16, dtype=np.float64)
            req = comm.Recv_init(buf, source=0, tag=7)
            for _ in range(5):
                req.start()
                st = req.wait()
                assert st.source == 0 and st.tag == 7
                out.append(buf.copy())
        return out

    res = pkg.run_ranks(2, fn)
    for it, arr in enumerate(res[1]):
        np.testing.assert_array_equal(arr, pay[it])


def test_persistent_startall_and_inactive_wait(pkg):
    def fn(comm):
        right = (comm.rank + 1) % comm.size
        left = (comm.rank - 1) % comm.size
        s = np.array([comm.rank * 1.0])
        r = np.zeros(1)
        sreq = comm.Send_init(s, dest=right, tag=2)
        rreq = comm.Recv_init(r, source=left, tag=2)
        # wait on an inactive persistent request returns immediately
        rreq.wait()
        for _ in range(3):
            pkg.start_all([rreq, sreq])
            rreq.wait()
            sreq.wait()
        return float(r[0])

    assert pkg.run_ranks(3, fn) == [2.0, 0.0, 1.0]


def test_persistent_double_start_raises(pkg):
    def fn(comm):
        if comm.rank == 0:
            r = np.zeros(1)
            req = comm.Recv_init(r, source=1, tag=0)
            req.start()
            try:
                req.start()
                out = "no-error"
            except RuntimeError:
                out = "ok"
            req.wait()  # the peer's send satisfies the first start
            comm.Send(np.zeros(1), dest=1, tag=1)  # release peer
            return out
        comm.Send(np.zeros(1), dest=0, tag=0)
        comm.Recv(np.zeros(1), source=0, tag=1)
        return None

    assert pkg.run_ranks(2, fn)[0] == "ok"


def test_bsend_user_buffer_reusable(pkg):
    pay = _payloads(2, 32)

    def fn(comm):
        if comm.rank == 0:
            pkg.attach_buffer(1 << 16)
            buf = pay[0].copy()
            comm.Bsend(buf, dest=1, tag=0)
            buf[:] = -1  # clobber immediately: receiver must see copy
            comm.Ibsend(pay[1], dest=1, tag=1).wait()
            return pkg.detach_buffer()
        r1 = np.empty(32, dtype=np.float64)
        r2 = np.empty(32, dtype=np.float64)
        comm.Recv(r1, source=0, tag=0)
        comm.Recv(r2, source=0, tag=1)
        return (r1, r2)

    size, (r1, r2) = pkg.run_ranks(2, fn)
    assert size == 1 << 16
    np.testing.assert_array_equal(r1, pay[0])
    np.testing.assert_array_equal(r2, pay[1])


def test_bsend_without_buffer_raises(pkg):
    def fn(comm):
        try:
            comm.Bsend(np.zeros(4), dest=(comm.rank + 1) % 2, tag=0)
            return "no-error"
        except RuntimeError:
            return "ok"

    assert pkg.run_ranks(2, fn) == ["ok", "ok"]


def test_bsend_exhaustion_raises(pkg):
    def fn(comm):
        if comm.rank == 0:
            pkg.attach_buffer(256)
            try:
                # a 512-byte payload can't fit a 256-byte buffer
                comm.Bsend(np.zeros(64, dtype=np.float64), dest=1, tag=0)
                out = "no-error"
            except RuntimeError:
                out = "ok"
            comm.Send(np.zeros(1), dest=1, tag=9)
            pkg.detach_buffer()
            return out
        comm.Recv(np.zeros(1), source=0, tag=9)
        return None

    assert pkg.run_ranks(2, fn)[0] == "ok"


def test_bsend_init_persistent(pkg):
    pay = [np.random.default_rng(SEED + i).integers(-99, 99, 8)
           for i in range(3)]

    def fn(comm):
        if comm.rank == 0:
            pkg.attach_buffer(1 << 14)
            buf = np.zeros(8, dtype=np.int64)
            req = comm.Bsend_init(buf, dest=1, tag=3)
            for it in range(3):
                buf[:] = pay[it]
                req.start()
                req.wait()
            # a synchronous-mode persistent send completes once matched
            sreq = comm.Ssend_init(buf, dest=1, tag=4)
            sreq.start()
            sreq.wait()
            pkg.detach_buffer()
            return None
        got = []
        r = np.empty(8, dtype=np.int64)
        for _ in range(4):
            comm.Recv(r, source=0, tag=3 if len(got) < 3 else 4)
            got.append(r.copy())
        return got

    got = pkg.run_ranks(2, fn)[1]
    for it in range(3):
        np.testing.assert_array_equal(got[it], pay[it])
    np.testing.assert_array_equal(got[3], pay[2])


def test_rsend_behaves_as_send(pkg):
    def fn(comm):
        if comm.rank == 0:
            comm.Rsend(np.full(4, 9.0), dest=1, tag=0)
            comm.Irsend(np.full(4, 8.0), dest=1, tag=1).wait()
            return None
        a = np.empty(4)
        b = np.empty(4)
        comm.Recv(a, source=0, tag=0)
        comm.Recv(b, source=0, tag=1)
        return (float(a[0]), float(b[0]))

    assert pkg.run_ranks(2, fn)[1] == (9.0, 8.0)


def test_persistent_with_waitany_testall(pkg):
    pay = _payloads(1, 1)[0]

    def fn(comm):
        if comm.rank == 0:
            req = comm.Send_init(pay, dest=1, tag=0)
            req.start()
            i = pkg.wait_any([req])            # must observe completion
            assert i == 0 and pkg.test_all([req])
            return "ok"
        r = np.zeros(1)
        rq = comm.Recv_init(r, source=0, tag=0)
        rq.start()
        assert pkg.wait_any([rq]) == 0
        return float(r[0])

    assert pkg.run_ranks(2, fn) == ["ok", float(pay[0])]


def test_bsend_failed_send_releases_reservation(pkg):
    def fn(comm):
        pkg.attach_buffer(600)
        try:
            try:
                comm.Bsend(np.zeros(32, dtype=np.float64), dest=99, tag=0)
            except Exception:
                pass
            # the 256 B + overhead reservation must have been
            # released: a legal send of the same size fits a 600-byte
            # buffer only if the failed one didn't leak
            comm.Bsend(np.zeros(32, dtype=np.float64),
                       dest=(comm.rank + 1) % 2, tag=1)
            comm.Recv(np.empty(32, dtype=np.float64),
                      source=(comm.rank - 1) % 2, tag=1)
            return "ok"
        finally:
            pkg.detach_buffer()

    assert pkg.run_ranks(2, fn) == ["ok", "ok"]


def test_persistent_results_match_reference():
    """The same persistent ring (Send_init / Recv_init / start_all) on
    seeded payloads through both packages gives the same bytes."""
    pay = _payloads(4, 64)

    def prog(p):
        def fn(comm):
            right = (comm.rank + 1) % comm.size
            left = (comm.rank - 1) % comm.size
            s = np.empty(64)
            r = np.empty(64)
            sreq = comm.Send_init(s, dest=right, tag=5)
            rreq = comm.Recv_init(r, source=left, tag=5)
            out = []
            for it in range(3):
                s[:] = pay[comm.rank] * (it + 1)
                p.start_all([rreq, sreq])
                rreq.wait()
                sreq.wait()
                out.append(r.copy())
            return out
        return p.run_ranks(4, fn)

    port, ref = prog(_pkg("port")), prog(_pkg("ref"))
    for a, b in zip(port, ref):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_divergence_persistent_and_bsend_refuse_tensors():
    """pt2pt takes host buffers only: a tensor given to ``Send_init``,
    ``Recv_init`` or ``Bsend`` raises TypeError as ``Send`` does (a
    ``meta`` tensor stands in for a card tensor here)."""
    from ompi_tpu_torch.testing import run_ranks

    def fn(comm):
        x = torch.ones(4, device="meta")
        out = []
        for call in (lambda: comm.Send(x, dest=0),
                     lambda: comm.Send_init(x, dest=0),
                     lambda: comm.Recv_init(x, source=0),
                     lambda: comm.Bsend(x, dest=0)):
            try:
                call()
                out.append("no-error")
            except TypeError:
                out.append("TypeError")
        return out

    assert run_ranks(1, fn) == [["TypeError"] * 4]

"""The port's host RMA window (osc/pt2pt, ompi_tpu_torch/osc/window.py)
through both packages: each case of tests/test_osc.py runs the same
rank program through the reference's window and the port's, and their
results are compared byte for byte (for the cases whose outcome
depends on the order in which ranks win a race — the CAS election, the
fetch_and_op tickets — the order-free facts are compared: the sorted
tickets, one winner, every rank seeing it).  Both worlds are host-only
(no device map), so osc.create/allocate select pt2pt in both.

Beyond the reference's cases: the pt2pt window takes a CPU tensor as
its memory in place, and refuses a tensor that lies on any other device
(a ``meta`` tensor stands in for a card tensor here) — it stages
nothing of a card through the host, where the reference snapshots a
device buffer to the host; dynamic and shared windows.
"""

import numpy as np
import pytest
import torch

from ompi_tpu import osc as ref_osc
from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import osc as port_osc
from ompi_tpu_torch.mca.params import registry as port_registry
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import run_ranks as port_run_ranks

SIZES = [2, 3, 4, 8]


def both(n, case):
    """case(osc, op_module) -> rank fn, run through the port and the
    reference; returns (port results, reference results)."""
    port = port_run_ranks(n, case(port_osc, port_op))
    ref = ref_run_ranks(n, case(ref_osc, ref_op))
    return port, ref


def same(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape \
            and a.tobytes() == b.tobytes()
    return a == b


def _put_fence(osc, ops):
    def fn(comm):
        mem = np.full(4, -1, dtype=np.int64)
        win = osc.create(comm, mem)
        win.fence()
        right = (comm.rank + 1) % comm.size
        win.put(np.full(4, comm.rank, dtype=np.int64), right)
        win.fence()
        out = mem.copy()
        win.free()
        return out
    return fn


@pytest.mark.parametrize("n", SIZES)
def test_put_fence(n):
    port, ref = both(n, _put_fence)
    assert same(port, ref)
    for k, r in enumerate(port):
        np.testing.assert_array_equal(r, np.full(4, (k - 1 + n) % n))


def _get_fence(osc, ops):
    def fn(comm):
        mem = np.arange(3, dtype=np.float64) * (comm.rank + 1)
        win = osc.create(comm, mem)
        win.fence()
        left = (comm.rank - 1 + comm.size) % comm.size
        out = np.empty(3, dtype=np.float64)
        win.get(out, left)
        win.fence()
        win.free()
        return out
    return fn


@pytest.mark.parametrize("n", SIZES)
def test_get_fence(n):
    port, ref = both(n, _get_fence)
    assert same(port, ref)
    for k, r in enumerate(port):
        np.testing.assert_array_equal(
            r, np.arange(3, dtype=np.float64) * ((k - 1 + n) % n + 1))


def _put_disp(osc, ops):
    def fn(comm):
        mem = np.zeros(comm.size, dtype=np.int64)
        win = osc.create(comm, mem)  # disp_unit = 8 (itemsize)
        win.fence()
        for t in range(comm.size):
            win.put(np.array([comm.rank + 1], dtype=np.int64), t,
                    disp=comm.rank)
        win.fence()
        out = mem.copy()
        win.free()
        return out
    return fn


def test_put_disp_and_subrange():
    port, ref = both(4, _put_disp)
    assert same(port, ref)
    for r in port:
        np.testing.assert_array_equal(r, np.arange(1, 5, dtype=np.int64))


def _accumulate_sum(osc, ops):
    def fn(comm):
        mem = np.zeros(5, dtype=np.int64)
        win = osc.create(comm, mem)
        win.fence()
        win.accumulate(np.arange(5, dtype=np.int64) + comm.rank, 0,
                       op=ops.SUM)
        win.fence()
        out = mem.copy()
        win.free()
        return out
    return fn


@pytest.mark.parametrize("n", SIZES)
def test_accumulate_sum(n):
    port, ref = both(n, _accumulate_sum)
    assert same(port, ref)
    np.testing.assert_array_equal(
        port[0], sum(np.arange(5, dtype=np.int64) + k for k in range(n)))


def _lock_counter(osc, ops):
    def fn(comm):
        mem = np.zeros(1, dtype=np.int64)
        win = osc.create(comm, mem)
        for _ in range(10):
            win.lock(0, osc.LOCK_EXCLUSIVE)
            old = np.empty(1, dtype=np.int64)
            win.get(old, 0)
            win.put(old + 1, 0)
            win.unlock(0)
        comm.Barrier()
        out = int(mem[0])
        win.free()
        return out
    return fn


def test_lock_unlock_counter():
    port, ref = both(6, _lock_counter)
    assert port[0] == ref[0] == 60


def _fetch_and_op(osc, ops):
    def fn(comm):
        mem = np.zeros(1, dtype=np.int64)
        win = osc.create(comm, mem)
        olds = []
        for _ in range(7):
            old = np.empty(1, dtype=np.int64)
            win.fetch_and_op(1, old, 0, op=ops.SUM)
            olds.append(int(old[0]))
        comm.Barrier()
        out = int(mem[0])
        win.free()
        return out, olds
    return fn


def test_fetch_and_op():
    port, ref = both(5, _fetch_and_op)
    for res in (port, ref):
        assert res[0][0] == 35
        assert sorted(v for _, olds in res for v in olds) == list(range(35))


def _cas_election(osc, ops):
    def fn(comm):
        mem = np.full(1, -1, dtype=np.int64)
        win = osc.create(comm, mem)
        win.fence()
        old = np.empty(1, dtype=np.int64)
        win.compare_and_swap(-1, comm.rank, old, 0)
        win.fence()
        final = np.empty(1, dtype=np.int64)
        win.get(final, 0)
        win.fence()
        out = (int(old[0]), int(final[0]))
        win.free()
        return out
    return fn


def test_compare_and_swap_election():
    for res in both(6, _cas_election):
        winners = [k for k, (old, _) in enumerate(res) if old == -1]
        assert len(winners) == 1
        assert all(final == winners[0] for _, final in res)
        assert sorted(old for old, _ in res) == [-1] + [winners[0]] * 5


def _get_accumulate(osc, ops):
    def fn(comm):
        mem = np.full(2, 100, dtype=np.int64)
        win = osc.create(comm, mem)
        win.fence()
        old = np.empty(2, dtype=np.int64)
        win.get_accumulate(np.full(2, 1, dtype=np.int64), old, 0,
                           op=ops.SUM)
        win.fence()
        out = (old.copy(), mem.copy())
        win.free()
        return out
    return fn


def test_get_accumulate():
    port, ref = both(4, _get_accumulate)
    assert same(port[0][1], ref[0][1])
    np.testing.assert_array_equal(port[0][1], np.full(2, 104))
    for res in (port, ref):
        assert sorted(int(o[0]) for o, _ in res) == [100, 101, 102, 103]


def _pscw(osc, ops):
    def fn(comm):
        mem = np.zeros(1, dtype=np.int64)
        win = osc.create(comm, mem)
        if comm.rank % 2 == 0:
            origin = comm.rank + 1
            if origin < comm.size:
                win.post([origin])
                win.wait()
            out = int(mem[0])
        else:
            target = comm.rank - 1
            win.start([target])
            win.put(np.array([comm.rank * 100], dtype=np.int64), target)
            win.complete()
            out = -1
        comm.Barrier()
        win.free()
        return out
    return fn


def test_pscw():
    port, ref = both(4, _pscw)
    assert port == ref == [100, -1, 300, -1]


def _flush_passive(osc, ops):
    def fn(comm):
        mem = np.zeros(1, dtype=np.int64)
        win = osc.create(comm, mem)
        got = None
        if comm.rank == 1:
            win.lock(0, osc.LOCK_SHARED)
            win.put(np.array([42], dtype=np.int64), 0)
            win.flush(0)  # applied at target NOW
            got = np.empty(1, dtype=np.int64)
            win.get(got, 0)
            win.unlock(0)
            got = int(got[0])
        comm.Barrier()
        out = (int(mem[0]), got)
        win.free()
        return out
    return fn


def test_flush_passive():
    port, ref = both(3, _flush_passive)
    assert port == ref
    assert port[0][0] == 42 and port[1][1] == 42


def _shared_readers(osc, ops):
    def fn(comm):
        mem = np.array([comm.rank * 3], dtype=np.int64)
        win = osc.create(comm, mem)
        comm.Barrier()
        vals = []
        for t in range(comm.size):
            win.lock(t, osc.LOCK_SHARED)
            v = np.empty(1, dtype=np.int64)
            win.get(v, t)
            win.unlock(t)
            vals.append(int(v[0]))
        win.free()
        return vals
    return fn


def test_lock_shared_concurrent_readers():
    port, ref = both(5, _shared_readers)
    assert port == ref == [[k * 3 for k in range(5)]] * 5


def _two_windows(osc, ops):
    def fn(comm):
        m1 = np.zeros(2, dtype=np.int64)
        m2 = np.zeros(2, dtype=np.int64)
        w1 = osc.create(comm, m1)
        w2 = osc.create(comm, m2)
        w1.fence()
        w2.fence()
        right = (comm.rank + 1) % comm.size
        w1.put(np.full(2, 10 + comm.rank, dtype=np.int64), right)
        w2.put(np.full(2, 20 + comm.rank, dtype=np.int64), right)
        w1.fence()
        w2.fence()
        out = (m1.copy(), m2.copy())
        w1.free()
        w2.free()
        return out
    return fn


def test_two_windows_independent():
    port, ref = both(3, _two_windows)
    assert same(port, ref)
    for k, (a, b) in enumerate(port):
        np.testing.assert_array_equal(a, np.full(2, 10 + (k - 1) % 3))
        np.testing.assert_array_equal(b, np.full(2, 20 + (k - 1) % 3))


def _passive_then_fence(osc, ops):
    def fn(comm):
        mem = np.zeros(1, dtype=np.int64)
        win = osc.create(comm, mem)
        if comm.rank == 1:
            win.lock(0, osc.LOCK_EXCLUSIVE)
            win.put(np.array([7], dtype=np.int64), 0)
            win.unlock(0)
        comm.Barrier()
        win.fence()
        if comm.rank == 2:
            win.put(np.array([9], dtype=np.int64), 0)
        win.fence()
        out = int(mem[0])
        win.free()
        return out
    return fn


def test_passive_then_fence_epoch():
    port, ref = both(3, _passive_then_fence)
    assert port == ref and port[0] == 9


def _zero_count(osc, ops):
    def fn(comm):
        mem = np.full(2, 5, dtype=np.int64)
        win = osc.create(comm, mem)
        win.fence()
        win.put(np.empty(0, dtype=np.int64), (comm.rank + 1) % comm.size)
        win.fence()
        out = mem.copy()
        win.free()
        return out
    return fn


def test_zero_count_put():
    port, ref = both(2, _zero_count)
    assert same(port, ref)
    for r in port:
        np.testing.assert_array_equal(r, np.full(2, 5))


def _allocate_float(osc, ops):
    def fn(comm):
        win = osc.allocate(comm, 8 * 4)
        win.fence()
        if comm.rank == 0:
            win.put(np.linspace(0, 1, 4, dtype=np.float64), 1)
        win.fence()
        out = win.memory.view(np.float64).copy() if comm.rank == 1 \
            else None
        win.free()
        return out
    return fn


def test_win_allocate_and_float():
    port, ref = both(2, _allocate_float)
    assert same(port[1], ref[1])
    np.testing.assert_array_equal(port[1], np.linspace(0, 1, 4))


# ---- the port's own cases ---------------------------------------------

def test_cpu_tensor_memory_in_place():
    """A CPU tensor as the window memory of a host comm: pt2pt, and the
    puts land in the tensor itself."""
    def fn(comm):
        mem = torch.full((4,), -1, dtype=torch.int64)
        win = port_osc.create(comm, mem)
        win.fence()
        win.put(np.full(4, comm.rank, dtype=np.int64),
                (comm.rank + 1) % comm.size)
        win.fence()
        out = (type(win).__name__, win.disp_unit, mem.tolist())
        win.free()
        return out

    res = port_run_ranks(3, fn)
    for k, (kind, du, vals) in enumerate(res):
        assert (kind, du) == ("Window", 8)
        assert vals == [(k - 1) % 3] * 4


def test_pt2pt_refuses_card_tensor():
    """--mca osc pt2pt over a tensor that is not on the CPU raises
    (a meta tensor stands in for a card tensor): the reference
    snapshots it to the host, the port stages nothing through it.  A
    card-tensor origin buffer is refused the same way."""
    def fn(comm):
        errors = []
        try:
            port_osc.create(comm, torch.empty(4, device="meta"))
        except NotImplementedError as e:
            errors.append(str(e))
        win = port_osc.allocate(comm, 16)
        try:
            win.put(torch.empty(2, dtype=torch.int64, device="meta"), 0)
        except NotImplementedError as e:
            errors.append(str(e))
        win.free()
        return type(win).__name__, errors

    port_registry.set("osc", "pt2pt")
    try:
        res = port_run_ranks(2, fn)
    finally:
        port_registry.set("osc", "")
    for kind, errors in res:
        assert kind == "Window"
        assert len(errors) == 2 and all("meta" in e for e in errors)


def test_dynamic_window_attach_put():
    def fn(comm):
        win = port_osc.create_dynamic(comm)
        region = np.zeros(4, dtype=np.int64)
        win.attach(region)
        addrs = np.zeros(comm.size, dtype=np.int64)
        comm.Allgather(np.array([region.ctypes.data], dtype=np.int64),
                       addrs)
        win.lock_all()
        right = (comm.rank + 1) % comm.size
        win.put(np.array([comm.rank + 1], dtype=np.int64), right,
                disp=int(addrs[right]))
        win.flush_all()
        comm.Barrier()
        got = int(region[0])
        win.unlock_all()
        win.detach(region)
        win.free()
        return got

    assert port_run_ranks(3, fn) == [3, 1, 2]


def test_shared_window_direct_store():
    def fn(comm):
        win = port_osc.allocate_shared(comm, 8)
        win.memory.view(np.int64)[0] = comm.rank + 100
        comm.Barrier()
        n, du, peer = port_osc.shared_query(win, (comm.rank + 1) % comm.size)
        out = (n, du, int(peer.view(np.int64)[0]))
        comm.Barrier()
        win.free()
        return out

    assert port_run_ranks(3, fn) == [(8, 1, 101), (8, 1, 102), (8, 1, 100)]


def test_window_errhandler_api():
    """Set/Get/Call_errhandler on a window (errhandler.attach_api): the
    default ERRORS_RETURN raises the MPIException carrying the class; a
    user handler runs first; classify maps the usual exceptions."""
    from ompi_tpu_torch import errhandler as eh

    def fn(comm):
        win = port_osc.allocate(comm, 8)
        seen = []
        first = win.Get_errhandler() is eh.ERRORS_RETURN
        codes = []
        for handler in (eh.ERRORS_RETURN,
                        eh.Errhandler(lambda w, c: seen.append(c))):
            win.Set_errhandler(handler)
            try:
                win.Call_errhandler(eh.ERR_WIN)
            except eh.MPIException as e:
                codes.append(e.error_class)
        win.free()
        return first, codes, seen

    assert port_run_ranks(2, fn) == [(True, [49, 49], [49])] * 2
    assert eh.classify(ValueError("x (MPI_ERR_RANK)")) == eh.ERR_RANK
    assert eh.classify(TypeError("x")) == eh.ERR_ARG
    assert eh.classify(RuntimeError("x")) == eh.ERR_OTHER
    assert eh.error_string(eh.ERR_WIN) == "MPI_ERR_WIN"

"""The port's OpenSHMEM layer (ompi_tpu_torch/shmem: the symmetric
heap, the memheap allocators, scoll, the ticket lock, the flat shmem_*
API) through both packages, from the same numpy seeds, byte for byte.

Mirrors the thread-rank cases of tests/test_shmem.py.  A case runs the
same rank program on a context of each package, on a host heap (the
pt2pt window over numpy: no device map in the port, ``devices=False``
in the reference) or on a device heap (the reference's device window,
one rank a virtual CPU device under ``run_ranks(devices=True)``; the
port's, one rank a logical device of the CPU,
``testing.logical_devices("cpu")``, where the shards are CPU tensors
and K8–K10 take their plain versions), the device heap under
``osc_device_dma`` 1 and 0, and holds the results equal.

Left out: test_shmem_ring_example_procs,
test_shmem_atomics_example_procs and test_lock_mutual_exclusion_procs
run the reference's shmem examples under mpirun (process ranks); they
come with those examples (ROADMAP A10).  Their workloads run here on
thread ranks (``ompi_tpu_torch.testing.shmem``).

The divergences of the layer (the device window holds no pool and no
host mirror) are pinned in tests/test_torch_staging.py, with the
parity tests of ``shmem.init()`` without a communicator.
"""

import numpy as np
import pytest

from ompi_tpu import shmem as ref_shmem
from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu.osc import device as _ref_device  # noqa: F401
from ompi_tpu.shmem import memheap as ref_memheap
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import shmem as port_shmem
from ompi_tpu_torch.mca.params import registry as port_registry
from ompi_tpu_torch.osc import device as _port_device  # noqa: F401
from ompi_tpu_torch.shmem import memheap as port_memheap
from ompi_tpu_torch.testing import logical_devices
from ompi_tpu_torch.testing import run_ranks as port_run_ranks
from ompi_tpu_torch.testing import shmem as wl
from ompi_tpu_torch.testing.shmem import pe_program

HEAPS = [("host", None), ("device", "1"), ("device", "0")]
HEAP_IDS = ["host", "device_dma1", "device_dma0"]
DEVICE_HEAPS = [("device", "1"), ("device", "0")]
HEAP_SIZE = 1 << 20


def with_knob(name, value, run):
    """run() with the MCA variable ``name`` set in both registries,
    restored after (set around run_ranks, never inside a rank)."""
    if value is None:
        return run()
    saved = (port_registry.get(name), ref_registry.get(name))
    port_registry.set(name, value)
    ref_registry.set(name, value)
    try:
        return run()
    finally:
        port_registry.set(name, saved[0])
        ref_registry.set(name, saved[1])


def run_both(n, fn, heap, dma, heap_size=HEAP_SIZE, **kw):
    """fn(ctx, comm) on n PEs through each package on the named heap:
    (reference results, port results)."""
    dev = heap == "device"
    ref = with_knob("osc_device_dma", dma, lambda: ref_run_ranks(
        n, pe_program(ref_shmem, fn, heap_size, **kw), devices=dev))
    port = with_knob("osc_device_dma", dma, lambda: port_run_ranks(
        n, pe_program(port_shmem, fn, heap_size, **kw),
        device_map=logical_devices("cpu") if dev else None))
    return ref, port


def same(n, fn, heap, dma, **kw):
    """run_both, holding every PE's results equal; the port's."""
    ref, port = run_both(n, fn, heap, dma, **kw)
    assert port == ref
    return port


# ---- memheap --------------------------------------------------------

def _offsets(ctx, comm):
    a = ctx.malloc(16, np.float64)
    b = ctx.malloc((4, 4), np.int32)
    assert a.local.shape == (16,) and b.local.shape == (4, 4)
    return (ctx.device, a.offset, b.offset)


@pytest.mark.parametrize("heap,dma", HEAPS, ids=HEAP_IDS)
def test_symmetric_offsets_and_views(heap, dma):
    res = same(4, _offsets, heap, dma)
    assert len(set(res)) == 1  # identical offsets on every PE
    assert res[0][0] is (heap == "device")


def _reuse(ctx, comm):
    a = ctx.malloc(1024, np.uint8)
    off_a = a.offset
    ctx.free(a)
    b = ctx.malloc(512, np.uint8)
    assert b.offset == off_a  # the hole is reused
    with pytest.raises(MemoryError):
        ctx.malloc(ctx.heap_size * 2, np.uint8)
    return (off_a, b.offset)


@pytest.mark.parametrize("heap,dma", HEAPS[:2], ids=HEAP_IDS[:2])
def test_malloc_free_reuse_and_exhaustion(heap, dma):
    same(1, _reuse, heap, dma)


# ---- put/get/p/g ----------------------------------------------------

def _roundtrip(ctx, comm):
    me, n = comm.rank, comm.size
    x = ctx.malloc(8, np.int64)
    ctx._write_sym(x, np.full(8, -1, np.int64))
    ctx.barrier_all()
    right = (me + 1) % n
    ctx.put(x, np.full(8, me, dtype=np.int64), right)
    ctx.barrier_all()
    left = (me - 1) % n
    assert (x.local == left).all()
    got = ctx.get(x, right)  # read my right neighbor's memory
    assert (got == me).all()
    ctx.barrier_all()
    return (np.asarray(x.local).tobytes(), got.tobytes())


@pytest.mark.parametrize("heap,dma", HEAPS, ids=HEAP_IDS)
def test_put_get_roundtrip(heap, dma):
    same(4, _roundtrip, heap, dma)


def _p_g(ctx, comm):
    x = ctx.malloc(4, np.float64)
    ctx._write_sym(x, np.zeros(4))
    ctx.barrier_all()
    ctx.p(x, 2, 3.5, (comm.rank + 1) % comm.size)
    ctx.barrier_all()
    assert x.local[2] == 3.5
    got = ctx.g(x, 2, (comm.rank + 1) % comm.size)
    assert got == 3.5
    ctx.barrier_all()
    return (np.asarray(x.local).tobytes(), np.float64(got).tobytes())


@pytest.mark.parametrize("heap,dma", HEAPS, ids=HEAP_IDS)
def test_p_g_single_element(heap, dma):
    same(3, _p_g, heap, dma)


def _wait(ctx, comm):
    flag = ctx.malloc(1, np.int64)
    ctx._write_sym(flag, np.zeros(1, np.int64))
    ctx.barrier_all()
    if comm.rank == 0:
        for peer in range(1, comm.size):
            ctx.p(flag, 0, 7, peer)
        ctx.quiet()
    else:
        ctx.wait_until(flag, 0, "eq", 7)
    ctx.barrier_all()
    return np.asarray(flag.local).tobytes()


@pytest.mark.parametrize("heap,dma", HEAPS, ids=HEAP_IDS)
def test_wait_until(heap, dma):
    same(3, _wait, heap, dma)


# ---- atomics --------------------------------------------------------

def _counter_and_cas(ctx, comm):
    me, n = comm.rank, comm.size
    ctr = ctx.malloc(1, np.int64)
    ctx._write_sym(ctr, np.zeros(1, np.int64))
    ctx.barrier_all()
    t = ctx.atomic_fetch_inc(ctr, 0, 0)
    ctx.barrier_all()
    if me == 0:
        assert ctr.local[0] == n
    ctx.barrier_all()
    # cas: exactly one PE wins the 100 -> me race
    tgt = ctx.malloc(1, np.int64)
    ctx._write_sym(tgt, np.full(1, 100, np.int64))
    ctx.barrier_all()
    old = ctx.atomic_compare_swap(tgt, 0, 100, me + 1000, 0)
    wins = ctx.malloc(n, np.int64)
    mine = ctx.malloc(1, np.int64)
    ctx._write_sym(mine, np.full(1, 1 if old == 100 else 0, np.int64))
    ctx.collect(wins, mine)
    assert wins.local.sum() == 1
    # swap returns previous value
    sw = ctx.malloc(1, np.int64)
    ctx._write_sym(sw, np.full(1, 5, np.int64))
    ctx.barrier_all()
    if me == 0:
        prev = ctx.atomic_swap(sw, 0, 9, 0)
        assert prev == 5 and sw.local[0] == 9
    ctx.barrier_all()
    return int(t)


@pytest.mark.parametrize("heap,dma", HEAPS, ids=HEAP_IDS)
def test_atomics_counter_and_cas(heap, dma):
    ref, port = run_both(4, _counter_and_cas, heap, dma)
    assert sorted(port) == sorted(ref) == list(range(4))  # distinct tickets


def _int64_ticket_cell(ctx, comm):
    """The lock's packed cell: adds of 1 << 32 through K9 SUM and a
    compare-and-swap through K10 stay exact on int64, the old values
    fetched back whole."""
    cell = ctx.malloc(1, np.int64)
    big = np.int64(1) << 32
    ctx._write_sym(cell, np.full(1, (5 << 32) + 3, np.int64))
    ctx.barrier_all()
    olds = []
    if comm.rank == 0:
        olds.append(int(ctx.atomic_fetch_add(cell, 0, big, 0)))
        olds.append(int(ctx.atomic_compare_swap(
            cell, 0, (6 << 32) + 3, (6 << 32) + 4, 0)))
        ctx.atomic_add(cell, 0, -big, 0)
        olds.append(int(ctx.atomic_fetch(cell, 0, 0)))
    ctx.barrier_all()
    return (olds, np.asarray(cell.local).tobytes())


@pytest.mark.parametrize("heap,dma", HEAPS, ids=HEAP_IDS)
def test_int64_ticket_cell_exact(heap, dma):
    got = same(2, _int64_ticket_cell, heap, dma)
    assert got[0][0] == [(5 << 32) + 3, (6 << 32) + 3, (5 << 32) + 4]


# ---- collectives ----------------------------------------------------

def _bcast_collect_reduce(ctx, comm):
    me, n = comm.rank, comm.size
    src = ctx.malloc(2, np.float64)
    dst = ctx.malloc(2, np.float64)
    ctx._write_sym(src, np.full(2, me + 1.0))
    ctx.barrier_all()
    ctx.broadcast(dst, src, root=1)
    assert (dst.local == 2.0).all()
    allv = ctx.malloc(2 * n, np.float64)
    ctx.collect(allv, src)
    assert allv.local[::2].tolist() == [r + 1 for r in range(n)]
    total = ctx.malloc(2, np.float64)
    ctx.sum_to_all(total, src)
    assert (total.local == sum(range(1, n + 1))).all()
    mx = ctx.malloc(2, np.float64)
    ctx.max_to_all(mx, src)
    assert (mx.local == n).all()
    ctx.barrier_all()
    return b"".join(np.asarray(a.local).tobytes()
                    for a in (dst, allv, total, mx))


@pytest.mark.parametrize("heap,dma", HEAPS, ids=HEAP_IDS)
def test_scoll_broadcast_collect_reduce(heap, dma):
    same(3, _bcast_collect_reduce, heap, dma)


def _rides_coll(ctx, comm):
    assert ctx.scoll.name == "mpi"
    calls = []
    orig = comm.Allreduce

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    comm.Allreduce = counted
    try:
        s = ctx.malloc(4, np.int64)
        d = ctx.malloc(4, np.int64)
        ctx._write_sym(s, np.full(4, comm.rank, np.int64))
        ctx.barrier_all()
        ctx.sum_to_all(d, s)
        assert (d.local == sum(range(comm.size))).all()
        assert len(calls) == 1  # rode Allreduce, not a side path
    finally:
        comm.Allreduce = orig
    # and the comm's merged vtable is the provider underneath
    assert "allreduce" in comm.coll.providers
    return np.asarray(d.local).tobytes()


@pytest.mark.parametrize("heap,dma", HEAPS[:2], ids=HEAP_IDS[:2])
def test_scoll_rides_the_comm_coll_stack(heap, dma):
    same(3, _rides_coll, heap, dma)


# ---- the memheap framework (buddy + firstfit components) -------------

@pytest.mark.parametrize("mod", [ref_memheap, port_memheap],
                         ids=["reference", "port"])
def test_buddy_allocator_split_coalesce(mod):
    b = mod.Buddy(1 << 16)
    a1 = b.malloc(1000)   # order 10
    a2 = b.malloc(1000)
    a3 = b.malloc(100)    # order 7
    assert len({a1, a2, a3}) == 3
    b.free(a2)
    b.free(a1)
    b.free(a3)
    big = b.malloc((1 << 16) - 1)
    assert big == 0
    b.free(big)
    c = mod.Buddy(1 << 16)
    assert [c.malloc(1000), c.malloc(1000), c.malloc(100)] == \
        [a1, a2, a3]


def _alloc_trace(mod, cls, size, seed):
    """A seeded sequence of mallocs and frees: the offsets and the
    final state, which both packages must produce alike."""
    rng = np.random.default_rng(seed)
    a = cls(size)
    live, trace = [], []
    for _ in range(200):
        if live and rng.random() < 0.4:
            a.free(live.pop(int(rng.integers(len(live)))))
            continue
        try:
            off = a.malloc(int(rng.integers(0, 3000)))
        except MemoryError:
            trace.append(-1)
            continue
        live.append(off)
        trace.append(off)
    return trace, a.state()


@pytest.mark.parametrize("alloc", ["Buddy", "FirstFit"])
@pytest.mark.parametrize("size", [1 << 16, (1 << 16) + (1 << 12) + 64])
def test_allocators_match_reference(alloc, size):
    got = _alloc_trace(port_memheap, getattr(port_memheap, alloc), size, 7)
    want = _alloc_trace(ref_memheap, getattr(ref_memheap, alloc), size, 7)
    assert got == want


@pytest.mark.parametrize("mod", [ref_memheap, port_memheap],
                         ids=["reference", "port"])
def test_buddy_nonpow2_heap_covered_by_top_blocks(mod):
    size = (1 << 16) + (1 << 12) + 64
    b = mod.Buddy(size)
    total = 0
    seen = set()
    while True:
        try:
            off = b.malloc(64)
        except MemoryError:
            break
        assert off + 64 <= size
        assert off not in seen
        seen.add(off)
        total += 64
    assert total == size


def test_memheap_component_selection():
    assert port_memheap.select(1 << 12).name == "buddy"
    port_registry.set("shmem_memheap_allocator", "firstfit")
    try:
        assert port_memheap.select(1 << 12).name == "firstfit"
    finally:
        port_registry.set("shmem_memheap_allocator", "buddy")
    port_registry.set("shmem_memheap_allocator", "nope")
    try:
        with pytest.raises(ValueError):
            port_memheap.select(1 << 12)
    finally:
        port_registry.set("shmem_memheap_allocator", "buddy")


@pytest.mark.parametrize("mod", [ref_memheap, port_memheap],
                         ids=["reference", "port"])
def test_allocator_checkpoint_state_roundtrip(mod):
    b = mod.select(1 << 14)
    keep = b.malloc(500)
    tmp = b.malloc(700)
    b.free(tmp)
    st = b.state()
    r = mod.restore(st, 1 << 14)
    assert r.malloc(300) == b.malloc(300)
    r.free(keep)
    b.free(keep)
    assert r.state() == b.state()


def test_heap_size_knob():
    def fn(ctx, comm):
        return ctx.heap_size

    port_registry.set("shmem_memheap_size", 1 << 16)
    try:
        got = port_run_ranks(2, pe_program(port_shmem, fn),
                             device_map=logical_devices("cpu"))
    finally:
        port_registry.set("shmem_memheap_size", 1 << 22)
    assert got == [1 << 16] * 2


# ---- the API tail: iput/iget, locks, shmem_ptr -----------------------

@pytest.mark.parametrize("heap,dma", HEAPS, ids=HEAP_IDS)
def test_test_lock_semantics(heap, dma):
    def fn(ctx, comm):
        lock = ctx.malloc(1, np.int64)
        ctx._write_sym(lock, np.zeros(1, np.int64))
        ctx.barrier_all()
        got = []
        if comm.rank == 0:
            got.append(ctx.test_lock(lock))     # free -> acquired
        comm.Barrier()
        if comm.rank == 1:
            got.append(ctx.test_lock(lock))     # held -> refused
        comm.Barrier()
        if comm.rank == 0:
            ctx.clear_lock(lock)
        comm.Barrier()
        if comm.rank == 1:
            got.append(ctx.test_lock(lock))     # free again
            ctx.clear_lock(lock)
        ctx.barrier_all()
        return got

    assert same(2, fn, heap, dma) == [[True], [False, True]]


def test_retire_ticket_after_timeout():
    """A waiter that times out retires its ticket (the allocation is
    rolled back), so the next holder is served: the reference's
    ``_retire_ticket``, on the device heap (K9 adds, K10 the CAS)."""
    def fn(ctx, comm):
        lock = ctx.malloc(1, np.int64)
        ctx._write_sym(lock, np.zeros(1, np.int64))
        ctx.barrier_all()
        if comm.rank == 0:
            ctx.set_lock(lock)
        comm.Barrier()
        timed_out = False
        if comm.rank == 1:
            try:
                ctx.set_lock(lock, timeout=0.05)
            except TimeoutError:
                timed_out = True
        comm.Barrier()
        if comm.rank == 0:
            ctx.clear_lock(lock)
        comm.Barrier()
        if comm.rank == 1:
            ctx.set_lock(lock, timeout=5.0)
            ctx.clear_lock(lock)
        ctx.barrier_all()
        return (timed_out, np.int64(ctx.g(lock, 0, 0)).tobytes())

    assert same(2, fn, "device", "1") == [
        (False, np.int64((2 << 32) + 2).tobytes()),
        (True, np.int64((2 << 32) + 2).tobytes())]


def test_shmem_ptr():
    """Thread-rank PEs share an address space: on a host heap ptr() is
    a REAL view of the peer's heap (stores are visible to the peer)."""
    def fn(ctx, comm):
        x = ctx.malloc(4, np.int64)
        x.local[:] = comm.rank
        ctx.barrier_all()
        peer = (comm.rank + 1) % comm.size
        view = ctx.ptr(x, peer)
        assert view is not None and (view == peer).all()
        view[comm.rank % 4] = 100 + comm.rank
        ctx.barrier_all()
        left = (comm.rank - 1) % comm.size
        assert x.local[left % 4] == 100 + left, x.local
        ctx.barrier_all()
        return x.local.tobytes()

    same(4, fn, "host", None)


@pytest.mark.parametrize("heap,dma", DEVICE_HEAPS, ids=HEAP_IDS[1:])
def test_device_heap_local_readonly_and_ptr_none(heap, dma):
    """A device heap has no live host alias: SymArray.local is a
    read-only snapshot and ptr() refuses to hand out peer views."""
    def fn(ctx, comm):
        assert ctx.device and ctx.heap is None
        x = ctx.malloc(4, np.int32)
        ctx._write_sym(x, np.arange(4, dtype=np.int32))
        loc = x.local
        assert not loc.flags.writeable
        with pytest.raises(ValueError):
            loc[0] = 9
        assert (ctx.ptr(x, comm.rank) == np.arange(4)).all()
        peer = (comm.rank + 1) % comm.size
        assert ctx.ptr(x, peer) is None
        ctx.barrier_all()
        return loc.tobytes()

    same(2, fn, heap, dma)


# ---- the flat shmem_* API ------------------------------------------------

def _flat_api(shmem):
    def fn(comm):
        shmem.init(comm, heap_size=HEAP_SIZE)
        me, n = shmem.my_pe(), shmem.n_pes()
        x = shmem.malloc(4, np.int64)
        c = shmem.malloc(1, np.int64)
        shmem.barrier_all()
        shmem.put(x, np.full(4, me, np.int64), (me + 1) % n)
        shmem.p(x, 0, 100 + me, (me + 1) % n)
        shmem.quiet()
        shmem.barrier_all()
        got = shmem.get(x, me)
        g = int(shmem.g(x, 1, (me + 1) % n))
        shmem.atomic_inc(c, 0, 0)
        shmem.atomic_add(c, 0, 10, 0)
        shmem.barrier_all()
        ctr = int(shmem.atomic_fetch(c, 0, 0))
        with pytest.raises(RuntimeError):
            shmem.init(comm, heap_size=2 * HEAP_SIZE)
        shmem.free(x)
        shmem.finalize()
        with pytest.raises(RuntimeError):
            shmem.my_pe()
        return (got.tobytes(), g, ctr)
    return fn


@pytest.mark.parametrize("heap,dma", HEAPS, ids=HEAP_IDS)
def test_flat_api(heap, dma):
    dev = heap == "device"
    ref = with_knob("osc_device_dma", dma, lambda: ref_run_ranks(
        3, _flat_api(ref_shmem), devices=dev))
    port = with_knob("osc_device_dma", dma, lambda: port_run_ranks(
        3, _flat_api(port_shmem),
        device_map=logical_devices("cpu") if dev else None))
    assert port == ref
    assert [r[2] for r in port] == [33] * 3


# ---- the promoted workloads: byte identity across heaps and packages ------

@pytest.mark.parametrize("name", list(wl.WORKLOADS))
@pytest.mark.parametrize("heap,dma", HEAPS, ids=HEAP_IDS)
def test_promoted_workloads_byte_identical(name, heap, dma):
    """Each workload of ``ompi_tpu_torch.testing.shmem`` (the ring, the
    atomics with tickets and collect, the lock's mutual exclusion, the
    strided iput/iget, scoll, the bulk put/get ladder at small sizes)
    gives the reference's bytes on the same heap, and the port's host
    heap's bytes on its device heap."""
    kw = {"sizes": (8, 4096, 65536)} if name == "bulk" else {}
    if name == "lock":
        kw = {"iters": 4}
    ref, port = run_both(4, wl.WORKLOADS[name], heap, dma, **kw)
    assert all(r["device"] is (heap == "device") for r in port + ref)
    strip = [{k: v for k, v in r.items() if k != "device"} for r in port]
    assert strip == [{k: v for k, v in r.items() if k != "device"}
                     for r in ref]
    if heap == "device":
        host = port_run_ranks(4, pe_program(
            port_shmem, wl.WORKLOADS[name], HEAP_SIZE, **kw))
        assert strip == [{k: v for k, v in r.items() if k != "device"}
                         for r in host]


def test_lock_stress_short_switch_interval():
    """The lock workload at 8 PEs on the device heap, with the
    interpreter switching threads every 10 µs: a ticket lost between
    ``set_lock`` and ``clear_lock``, or a put to the counter not yet
    landed at ``clear_lock``, shows as a lost update."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = port_run_ranks(8, pe_program(port_shmem, wl.lock, HEAP_SIZE,
                                           iters=5),
                             device_map=logical_devices("cpu"), timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert [r["counter"] for r in got] == [np.int64(40).tobytes()] * 8
    assert all(r["device"] for r in got)


@pytest.mark.parametrize("dma", ["1", "0"])
@pytest.mark.parametrize("name", list(wl.WORKLOADS))
def test_workload_launch_counts(name, dma, monkeypatch):
    """The launch counts ``chip_smoke.py`` phase 7 holds the card to, on
    the CPU through counting stand-ins for the three RMA wrappers: K9
    and K10 exactly ``testing.shmem.launches``, K8 none with dma 1 and,
    with dma 0, exactly its count where the workload polls nothing and
    at least it where it polls (ring, lock)."""
    import threading

    from ompi_tpu_torch.kernels import rma

    got = {"rma_copy": 0, "rma_acc": 0, "rma_cas": 0}
    lock = threading.Lock()
    for k in got:
        def counted(*a, _f=getattr(rma, k), _k=k, **kw):
            with lock:
                got[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(rma, k, counted)
    kw = {"sizes": (8, 4096)} if name == "bulk" else {}
    with_knob("osc_device_dma", dma, lambda: port_run_ranks(
        4, pe_program(port_shmem, wl.WORKLOADS[name], HEAP_SIZE, **kw),
        device_map=logical_devices("cpu")))
    want = wl.launches(name, 4, **kw)
    assert (got["rma_acc"], got["rma_cas"]) == (want["rma_acc"],
                                                want["rma_cas"])
    if dma == "1":
        assert got["rma_copy"] == 0
    elif name in ("ring", "lock"):
        assert got["rma_copy"] >= want["rma_copy"]
    else:
        assert got["rma_copy"] == want["rma_copy"]


def test_ring_byte_identity_across_shrink():
    """Survivors of a ULFM shrink rebuild a device-heap context on the
    shrunken comm and the ring workload is byte-identical to a fresh
    3-rank world's, in the port and in the reference (the kill follows
    a ``comm.agree(True)``, a sync point that cannot half-complete)."""
    from ompi_tpu_torch import errhandler as eh
    from ompi_tpu_torch.ft import ulfm

    codes = (eh.ERR_PROC_FAILED, eh.ERR_PROC_FAILED_PENDING,
             eh.ERR_REVOKED)

    def chaos(comm):
        comm.agree(True)
        if comm.rank == 0:
            ulfm.kill_now(comm.state)
        work = comm
        while work is comm:
            try:
                work.Barrier()
            except eh.MPIException as e:
                assert e.code in codes, e.code
                work = work.shrink(name="survivors")
        ctx = port_shmem.ShmemCtx(work, HEAP_SIZE)
        out = wl.ring(ctx, work)
        ctx.finalize()
        return out

    got = port_run_ranks(4, chaos, device_map=logical_devices("cpu"),
                         allow_failures=True)
    fresh = port_run_ranks(3, pe_program(port_shmem, wl.ring, HEAP_SIZE),
                           device_map=logical_devices("cpu"))
    ref = ref_run_ranks(3, pe_program(ref_shmem, wl.ring, HEAP_SIZE),
                        devices=True)
    assert got[0] is None
    for i in range(1, 4):
        assert got[i] == fresh[i - 1] == ref[i - 1], i
        assert got[i]["device"] is True

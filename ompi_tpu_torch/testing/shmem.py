"""The promoted OpenSHMEM workloads, for the tests and the card's smoke
run: the shmem_ring and shmem_atomics examples and the reference's
thread-rank SHMEM cases (the ticket lock's mutual exclusion, strided
iput/iget, PE collectives), written against the SHMEM API alone — no
``.local`` stores, so they run unchanged on a host heap and on a
device heap.

Each workload is ``fn(ctx, comm)`` over a ``ShmemCtx`` of either
package (this one's or the reference's) and returns a dict whose
values are raw bytes (and ``"device"``, whether the heap is on the
device), so two runs compare byte for byte.  ``pe_program`` makes the
rank function ``run_ranks`` takes.  ``launches`` gives, for each
workload at n PEs, the launches a device heap makes: K9 ``rma_acc``
and K10 ``rma_cas`` exactly, and K8 ``rma_copy`` under
``osc_device_dma`` 0 at least (a poll of ``wait_until`` or
``set_lock`` reads once more each time it finds the value unchanged).
"""

from __future__ import annotations

import numpy as np


def pe_program(shmem, workload, heap_size=None, **kw):
    """A rank function: a context of ``shmem`` (this package's or the
    reference's module) on the rank's comm, the workload, finalize."""
    def fn(comm):
        ctx = shmem.ShmemCtx(comm, heap_size)
        out = workload(ctx, comm, **kw)
        ctx.finalize()
        return out
    return fn


def ring(ctx, comm):
    """examples/shmem_ring.py: a token injected by PE 0 circles the
    ring via shmem_p + wait_until, incremented at every hop."""
    me, n = comm.rank, comm.size
    flag = ctx.malloc(1, np.int64)
    ctx._write_sym(flag, np.full(1, -1, np.int64))
    ctx.barrier_all()
    if me == 0:
        ctx.p(flag, 0, 42, (me + 1) % n)
    ctx.wait_until(flag, 0, "ge", 0)
    token = int(flag.local[0])
    if me != 0:
        ctx.p(flag, 0, token + 1, (me + 1) % n)
    ctx.barrier_all()
    if me == 0 and token != 42 + n - 1:
        raise AssertionError(f"ring token {token} != {42 + n - 1}")
    return {"device": ctx.device,
            "token": np.int64(token).tobytes(),
            "final": np.asarray(flag.local).tobytes()}


def atomics(ctx, comm):
    """examples/shmem_atomics.py: fetch-inc ticketing and an atomic
    accumulator on PE 0, distinct tickets proven via fcollect; then
    the compare-and-swap race of tests/test_shmem.py (exactly one PE
    wins) and an atomic swap that returns the previous value."""
    me, n = comm.rank, comm.size
    counter = ctx.malloc(1, np.int64)
    acc = ctx.malloc(1, np.int64)
    ctx._write_sym(counter, np.zeros(1, np.int64))
    ctx._write_sym(acc, np.zeros(1, np.int64))
    ctx.barrier_all()
    ticket = int(ctx.atomic_fetch_inc(counter, 0, 0))
    ctx.atomic_add(acc, 0, me + 1, 0)
    ctx.barrier_all()
    all_t = ctx.malloc(n, np.int64)
    mine = ctx.malloc(1, np.int64)
    ctx._write_sym(mine, np.full(1, ticket, np.int64))
    ctx.barrier_all()
    ctx.collect(all_t, mine)
    tickets = sorted(np.asarray(all_t.local).tolist())
    if tickets != list(range(n)):
        raise AssertionError(f"tickets {tickets}")
    # compare-and-swap: exactly one PE wins the 100 -> 1000 + me race
    tgt = ctx.malloc(1, np.int64)
    ctx._write_sym(tgt, np.full(1, 100, np.int64))
    ctx.barrier_all()
    won = int(ctx.atomic_compare_swap(tgt, 0, 100, me + 1000, 0)) == 100
    wins = ctx.malloc(n, np.int64)
    ctx._write_sym(mine, np.full(1, int(won), np.int64))
    ctx.barrier_all()
    ctx.collect(wins, mine)
    nwins = int(np.asarray(wins.local).sum())
    if nwins != 1:
        raise AssertionError(f"{nwins} PEs won the compare-and-swap")
    # swap returns the previous value
    sw = ctx.malloc(1, np.int64)
    ctx._write_sym(sw, np.full(1, 5, np.int64))
    ctx.barrier_all()
    if me == 0:
        prev = int(ctx.atomic_swap(sw, 0, 9, 0))
        if prev != 5 or int(sw.local[0]) != 9:
            raise AssertionError(f"swap: previous {prev}, now {sw.local}")
    ctx.barrier_all()
    return {"device": ctx.device,
            "counter": np.int64(ctx.g(counter, 0, 0)).tobytes(),
            "acc": np.int64(ctx.g(acc, 0, 0)).tobytes(),
            "tickets": np.asarray(tickets, np.int64).tobytes(),
            "cas_wins": np.int64(nwins).tobytes()}


LOCK_ITERS = 10


def lock(ctx, comm, iters: int = LOCK_ITERS):
    """The ticket lock's mutual exclusion (tests/test_shmem.py
    test_lock_mutual_exclusion_threads): every PE increments a counter
    on PE 0 by a get and a put inside the critical section; a lost
    update — a put still in flight when the lock is released, or two
    holders at once — shows as a counter below PEs x sections."""
    lk = ctx.malloc(1, np.int64)
    counter = ctx.malloc(1, np.int64)
    ctx._write_sym(lk, np.zeros(1, np.int64))
    ctx._write_sym(counter, np.zeros(1, np.int64))
    ctx.barrier_all()
    for _ in range(iters):
        ctx.set_lock(lk)
        v = int(ctx.g(counter, 0, 0))
        ctx.p(counter, 0, v + 1, 0)
        ctx.win.flush(0)
        ctx.clear_lock(lk)
    ctx.barrier_all()
    total = int(ctx.g(counter, 0, 0))
    if total != comm.size * iters:
        raise AssertionError(f"lock counter {total} != "
                             f"{comm.size * iters}: lost updates")
    return {"device": ctx.device, "counter": np.int64(total).tobytes()}


def strided(ctx, comm):
    """shmem_iput/iget (tests/test_shmem.py
    test_iput_iget_strided_roundtrip): every 2nd element of a local
    stream to every 2nd index of the right neighbour, and back."""
    right = (comm.rank + 1) % comm.size
    dst = ctx.malloc(8, np.int64)
    ctx._write_sym(dst, np.full(8, -1, np.int64))
    ctx.barrier_all()
    src = np.arange(8, dtype=np.int64) + 10 * comm.rank
    ctx.iput(dst, src, tst=2, sst=2, nelems=4, pe=right)
    ctx.barrier_all()
    placed = np.asarray(dst.local).tobytes()
    got = np.full(8, -7, dtype=np.int64)
    ctx.iget(got, dst, tst=2, sst=2, nelems=4, pe=right)
    ctx.barrier_all()
    return {"device": ctx.device, "placed": placed, "got": got.tobytes()}


def scoll(ctx, comm):
    """PE collectives on symmetric blocks (tests/test_shmem.py
    test_scoll_on_device_heap and test_scoll_broadcast_collect_reduce):
    sum_to_all, max_to_all, collect, alltoall and an in-place
    broadcast, staged through the ctx accessors."""
    me, n = comm.rank, comm.size
    src = ctx.malloc(3, np.int32)
    dst = ctx.malloc(3, np.int32)
    ctx._write_sym(src, np.full(3, me + 1, np.int32))
    ctx.barrier_all()
    ctx.sum_to_all(dst, src)
    out = {"sum": np.asarray(dst.local).tobytes()}
    ctx.max_to_all(dst, src)
    out["max"] = np.asarray(dst.local).tobytes()
    allv = ctx.malloc(3 * n, np.int32)
    ctx.collect(allv, src)
    out["collect"] = np.asarray(allv.local).tobytes()
    a2a_src = ctx.malloc(2 * n, np.int32)
    a2a_dst = ctx.malloc(2 * n, np.int32)
    ctx._write_sym(a2a_src, np.arange(2 * n, dtype=np.int32) + 100 * me)
    ctx.barrier_all()
    ctx.alltoall(a2a_dst, a2a_src)
    out["alltoall"] = np.asarray(a2a_dst.local).tobytes()
    b = ctx.malloc(4, np.int32)
    if me == 1 % n:
        ctx._write_sym(b, np.arange(4, dtype=np.int32) * 7)
    ctx.barrier_all()
    ctx.broadcast(b, b, root=1 % n)
    out["bcast"] = np.asarray(b.local).tobytes()
    ctx.barrier_all()
    out["device"] = ctx.device
    return out


BULK_SIZES = (8, 64 << 10, 1 << 20, 4 << 20)
SEED = 1234


def bulk(ctx, comm, sizes=BULK_SIZES):
    """osu_oshm_put / osu_oshm_get's pattern at full width: every PE
    puts a seeded block of each size into its right neighbour's heap,
    reads what its left neighbour put, and gets the block back from
    its right neighbour."""
    me, n = comm.rank, comm.size
    right, left = (me + 1) % n, (me - 1) % n
    out = {"device": ctx.device}
    for nb in sizes:
        blk = ctx.malloc(nb, np.uint8)
        data = np.random.default_rng(SEED + me).integers(
            0, 256, nb, dtype=np.uint8)
        ctx.put(blk, data, right)
        ctx.barrier_all()
        got = np.asarray(blk.local).tobytes()
        want = np.random.default_rng(SEED + left).integers(
            0, 256, nb, dtype=np.uint8).tobytes()
        if got != want:
            raise AssertionError(f"{nb} B put from PE {left} corrupt")
        back = ctx.get(blk, right)
        if back.tobytes() != data.tobytes():
            raise AssertionError(f"{nb} B get from PE {right} corrupt")
        out[f"put_{nb}"] = got
        ctx.barrier_all()
        ctx.free(blk)
    return out


WORKLOADS = {"ring": ring, "atomics": atomics, "lock": lock,
             "strided": strided, "scoll": scoll, "bulk": bulk}


def launches(name: str, n: int, **kw) -> dict:
    """The launches a run of workload ``name`` on a device heap of n
    PEs makes: K9 (``rma_acc``) and K10 (``rma_cas``) exactly, K8
    (``rma_copy``) with ``osc_device_dma`` 0 at least (exactly where
    the workload polls nothing: every workload but ring and lock).
    A put, get, p, g or self-put (``_write_sym``) is one K8 launch, a
    ``.local`` read (a self-get) one, an iput/iget one an element,
    a collective one read and one self-put a PE (the broadcast: one
    read on the root); an atomic add, fetch-add, fetch-inc or swap,
    and each ``set_lock`` ticket and ``clear_lock``, one K9; a
    compare-and-swap one K10."""
    iters = kw.get("iters", LOCK_ITERS)
    sizes = kw.get("sizes", BULK_SIZES)
    k8 = {"ring": 5 * n,
          "atomics": 14 * n + 1,
          "lock": (3 + 3 * iters) * n,
          "strided": 10 * n,
          "scoll": 16 * n + 2,
          "bulk": 3 * len(sizes) * n}[name]
    k9 = {"atomics": 2 * n + 1, "lock": 2 * iters * n}.get(name, 0)
    k10 = {"atomics": n}.get(name, 0)
    return {"rma_copy": k8, "rma_acc": k9, "rma_cas": k10}

"""Rank programs written against the flat MPI_* surface
(``ompi_tpu_torch.mpi``), for the tests and the card's smoke run: the
headline allreduce_arr on a communicator reached through MPI handles,
with attributes, an error handler and MPI_T sessions around it; host
MPI_Allreduce / PMPI_Allreduce; the memchecker's checks; a user error
handler and the attribute delete callback at free.

Each returns a rank function for ``run_ranks`` that takes the world
from ``MPI_COMM_WORLD()`` (the comm ``run_ranks`` passes is ignored)
and returns plain data — counts, raw bytes, digests and the output
tensor — so a caller holds it to exact expectations.  The kernel
launch counts are the caller's to read: the programs run on whatever
device the rank was given (the CPU runs the kernels' plain versions).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

import ompi_tpu_torch.coll.plan  # noqa: F401  (registers PLAN_PVARS)
import ompi_tpu_torch.pml.monitoring  # noqa: F401  (and MONITOR_PVARS)
from ompi_tpu_torch import mpi as MPI
from ompi_tpu_torch import mpit

SEED = 20261018
# the plan tier's counters and pml/monitoring's internal-traffic rows
PLAN_PVARS = ("coll_plan_builds", "coll_plan_hits")
MONITOR_PVARS = ("pml_monitoring_filtered_count",
                 "pml_monitoring_filtered_size")


def values(rank: int, n: int, dev) -> torch.Tensor:
    """The rank's float32 input: seeded normal draws, made on the
    rank's device."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED * 100 + rank)
    return torch.randn(n, generator=g, device=dev, dtype=torch.float32)


def host_values(rank: int, nbytes: int) -> np.ndarray:
    """The rank's int64 host input of ``nbytes`` bytes."""
    g = np.random.default_rng(SEED + 1000 * nbytes + rank)
    return g.integers(-(1 << 40), 1 << 40, nbytes // 8, dtype=np.int64)


def digest(x) -> str:
    """sha256 of a tensor's or array's bytes (a card tensor is copied
    to the host for it)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous().numpy()
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def _session(names):
    s = mpit.pvar_session_create()
    handles = {n: mpit.pvar_handle_alloc(s, n) for n in names}
    for h in handles.values():
        mpit.pvar_reset(h)
    return s, handles


def headline(dev, n: int, ops: int, host_sizes=(8, 8 << 20)):
    """18a: the world from MPI_COMM_WORLD; an attribute whose keyval
    copies (the copy function's calls counted); MPI_Comm_dup; the
    duplicate set to MPI_ERRORS_RETURN; ``ops`` allreduce_arr SUM of
    the rank's ``n`` float32 values on it, with the plan tier's pvars
    read through one MPI_T session (reset before a Barrier, read after
    another: process-wide counters) and pml/monitoring's rows through
    another (reset and read around the ops alone: this rank's rows);
    then MPI_Allreduce and PMPI_Allreduce SUM of int64 host buffers of
    each of ``host_sizes`` bytes.  Needs pml_monitoring_enable set
    before the world starts."""
    def fn(_comm):
        world = MPI.MPI_COMM_WORLD()
        copies = []
        kv = MPI.MPI_Comm_create_keyval(
            copy_fn=lambda obj, k, extra, v: copies.append(v) or v + 1)
        MPI.MPI_Comm_set_attr(world, kv, world.rank)
        dup = MPI.MPI_Comm_dup(world)
        MPI.MPI_Comm_set_errhandler(dup, MPI.MPI_ERRORS_RETURN)
        x = values(dup.rank, n, dev)
        mpit.init_thread()
        try:
            plan_s, plan = _session(PLAN_PVARS)
            MPI.MPI_Barrier(dup)
            mon_s, mon = _session(MONITOR_PVARS)
            for _ in range(ops):
                y = dup.allreduce_arr(x, MPI.MPI_SUM)
            deltas = {k: mpit.pvar_read(h) for k, h in mon.items()}
            MPI.MPI_Barrier(dup)
            deltas.update((k, mpit.pvar_read(h)) for k, h in plan.items())
            for s in (plan_s, mon_s):
                mpit.pvar_session_free(s)
        finally:
            mpit.finalize()
        host = []
        for nbytes in host_sizes:
            a = host_values(dup.rank, nbytes)
            r1 = np.empty_like(a)
            r2 = np.empty_like(a)
            MPI.MPI_Allreduce(a, r1, a.size, MPI.MPI_INT64_T, MPI.MPI_SUM,
                              dup)
            MPI.PMPI_Allreduce(a, r2, a.size, MPI.MPI_INT64_T, MPI.MPI_SUM,
                               dup)
            host.append((r1.tobytes(), r2.tobytes()))
        out = {"copies": copies, "attr": MPI.MPI_Comm_get_attr(dup, kv),
               "errhandler": MPI.MPI_Comm_get_errhandler(dup)
               is MPI.MPI_ERRORS_RETURN,
               "pvars": deltas, "y": y, "host": host,
               "host_provider": dup.coll.providers["allreduce"]}
        MPI.MPI_Comm_free(dup)
        MPI.MPI_Comm_free_keyval(kv)
        return out
    return fn


def host_sum(nranks: int, nbytes: int) -> bytes:
    """numpy's int64 SUM of ``headline``'s host inputs."""
    return np.sum([host_values(r, nbytes) for r in range(nranks)], axis=0,
                  dtype=np.int64).tobytes()


def memcheck(dev, n: int, nbytes: int):
    """18b, on two ranks with opal_memchecker_enable set: rank 0
    send_arrs its ``n`` float32 values to rank 1 (btl/tpu: the checker
    leaves it alone); rank 1 posts an MPI_Irecv of ``nbytes`` host
    bytes and reads its buffer (the poison) before releasing rank 0,
    which MPI_Isends ``nbytes`` bytes (rendezvous), changes its buffer
    and MPI_Waits (the checker raises, naming the request).  Rank 0
    returns (the error text, its tensor's digest), rank 1 (the
    received tensor's device type and digest, the posted buffer's
    bytes before and after the receive completed)."""
    def fn(_comm):
        world = MPI.MPI_COMM_WORLD()
        if world.rank == 0:
            x = values(0, n, dev)
            world.send_arr(x, 1, tag=4)
            buf = np.zeros(nbytes, np.uint8)
            MPI.MPI_Recv(np.empty(1, np.uint8), 1, MPI.MPI_BYTE, 1, 8,
                         world)
            req = MPI.MPI_Isend(buf, nbytes, MPI.MPI_BYTE, 1, 9, world)
            buf[0] = 99  # erroneous: the request owns the buffer
            try:
                MPI.MPI_Wait(req)
                err = None
            except RuntimeError as e:
                err = str(e)
            return err, digest(x)
        y = world.recv_arr(0, tag=4)
        got = np.zeros(nbytes, np.uint8)
        req = MPI.MPI_Irecv(got, nbytes, MPI.MPI_BYTE, 0, 9, world)
        posted = bytes(np.unique(got))
        MPI.MPI_Send(np.zeros(1, np.uint8), 1, MPI.MPI_BYTE, 0, 8, world)
        MPI.MPI_Wait(req)
        return y.device.type, digest(y), posted, bytes(np.unique(got))
    return fn


def errhandlers(dev, n: int):
    """18c: a duplicate with a handler from MPI_Comm_create_errhandler
    and an attribute with a delete function; an MPI_Bcast whose root
    is out of range (the handler is called, the error propagates); the
    next allreduce_arr SUM of the rank's ``n`` float32 values on that
    comm; MPI_Comm_free (the delete function runs).  Returns (the
    handler's calls, the exception's type name, the output, the delete
    function's calls)."""
    def fn(_comm):
        world = MPI.MPI_COMM_WORLD()
        dup = MPI.MPI_Comm_dup(world)
        calls, deleted = [], []
        MPI.MPI_Comm_set_errhandler(dup, MPI.MPI_Comm_create_errhandler(
            lambda comm, code: calls.append((comm.cid == dup.cid, code))))
        kv = MPI.MPI_Comm_create_keyval(
            delete_fn=lambda obj, k, v, extra: deleted.append(v))
        MPI.MPI_Comm_set_attr(dup, kv, 100 + dup.rank)
        try:
            MPI.MPI_Bcast(np.zeros(1, np.int64), 1, MPI.MPI_INT64_T,
                          dup.size, dup)
            raised = None
        except (IndexError, RuntimeError) as e:
            raised = type(e).__name__
        y = dup.allreduce_arr(values(dup.rank, n, dev), MPI.MPI_SUM)
        MPI.MPI_Comm_free(dup)
        MPI.MPI_Comm_free_keyval(kv)
        return calls, raised, y, deleted
    return fn

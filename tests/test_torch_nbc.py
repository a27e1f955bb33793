"""The port's nonblocking host collectives (coll/nbc round schedules,
comm.I* methods) against the reference's: the same numpy buffers
through both packages, byte for byte, with several collectives in
flight on one comm at once (per-instance tags keep them apart)."""

import numpy as np
import pytest

from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.pml.request import wait_all
from ompi_tpu_torch.testing import run_ranks as port_run_ranks


def _program(op, seed):
    def fn(comm):
        rng = np.random.default_rng(seed + comm.rank)
        P, r = comm.size, comm.rank
        a = rng.integers(-1000, 1000, 4 * P).astype(np.int32)
        out = {}
        bufs = {
            "allreduce": np.empty_like(a),
            "bcast": a.copy() if r == 2 % P else np.zeros_like(a),
            "allgather": np.empty(a.size * P, np.int32),
            "alltoall": np.empty_like(a),
            "rsb": np.empty(a.size // P, np.int32),
            "scan": np.empty_like(a),
            "exscan": np.zeros_like(a),
            "reduce": np.empty_like(a) if r == 0 else None,
        }
        reqs = [comm.Ibarrier(),
                comm.Iallreduce(a, bufs["allreduce"], op.SUM),
                comm.Ibcast(bufs["bcast"], root=2 % P),
                comm.Iallgather(a, bufs["allgather"]),
                comm.Ialltoall(a, bufs["alltoall"]),
                comm.Ireduce_scatter_block(a, bufs["rsb"], op.MAX),
                comm.Iscan(a, bufs["scan"], op.SUM),
                comm.Iexscan(a, bufs["exscan"], op.BXOR),
                comm.Ireduce(a, bufs["reduce"], op.MIN, root=0)]
        for q in reqs:
            q.wait()
        for k, b in bufs.items():
            if b is not None and not (k == "exscan" and r == 0):
                out[k] = b.tobytes()
        return out
    return fn


@pytest.mark.parametrize("n", [2, 3, 4])
def test_nonblocking_collectives_byte_equal(n):
    port = port_run_ranks(n, _program(port_op, 40))
    ref = ref_run_ranks(n, _program(ref_op, 40))
    assert port == ref


def test_nbc_is_the_nonblocking_provider():
    def fn(comm):
        prov = comm.coll.providers
        return {k: prov[k] for k in ("ibarrier", "iallreduce",
                                     "iallreduce_arr", "ibcast_arr")}

    for got in port_run_ranks(2, fn):
        assert set(got.values()) == {"nbc"}


def test_requests_complete_through_wait_all():
    """Many schedules in flight on one comm complete in any wait
    order, each with its own result."""
    def fn(comm):
        xs = [np.full(8, comm.rank + k, np.int64) for k in range(5)]
        rs = [np.empty_like(x) for x in xs]
        reqs = [comm.Iallreduce(x, r, port_op.SUM)
                for x, r in zip(xs, rs)]
        wait_all(list(reversed(reqs)))
        return [int(r[0]) for r in rs]

    P = 3
    for got in port_run_ranks(P, fn):
        assert got == [sum(range(P)) + P * k for k in range(5)]

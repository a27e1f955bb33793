"""coll/sm through the port (ompi_tpu_torch/coll/sm.py): a thread
world's host collectives meet once at the communicator's rendezvous,
the meeting coll/device's card collectives use, and the last arriver
folds every deposit in rank order.  The reference beside it.

The analogs of tests/test_coll_sm.py's 8 tests: each rank program
runs through both packages on the same numpy inputs (made from a
seed, or from the rank as in the reference) and the results are
compared byte for byte — both fold left in rank order, so even a
float SUM is bitwise the reference's — and, for integer and
non-commutative ops, byte for byte against the p2p route (coll/tuned
called directly).  Further: sm meetings interleaved with
``allreduce_arr`` on one communicator on the CPU device path, the
monitoring count of a numpy and a barrier deposit, and a ``device_sdc``
flip of an sm deposit.
"""

import numpy as np
import pytest
import torch

from ompi_tpu.coll.buffers import IN_PLACE as REF_IN_PLACE
from ompi_tpu.coll.tuned import TunedModule as RefTuned
from ompi_tpu.datatype import engine as ref_dt
from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
import ompi_tpu.ft_inject  # noqa: F401  (registers the injector knobs)
from ompi_tpu_torch.coll.buffers import IN_PLACE as PORT_IN_PLACE
from ompi_tpu_torch.coll.tuned import TunedModule as PortTuned
from ompi_tpu_torch.datatype import engine as port_dt
from ompi_tpu_torch.mca.params import registry as port_registry
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import run_ranks as port_run_ranks
import ompi_tpu_torch.ft_inject  # noqa: F401

SEED = 20261018
CPU = torch.device("cpu")


class _Pkg:
    def __init__(self, name, op, dt, tuned, in_place, run, registry):
        self.name, self.op, self.dt, self.Tuned = name, op, dt, tuned
        self.IN_PLACE, self.run_ranks, self.registry = in_place, run, \
            registry


PORT = _Pkg("port", port_op, port_dt, PortTuned, PORT_IN_PLACE,
            port_run_ranks, port_registry)
REF = _Pkg("ref", ref_op, ref_dt, RefTuned, REF_IN_PLACE, ref_run_ranks,
           ref_registry)


def _plain(x):
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.tobytes())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def both(n, fn):
    """fn(comm, pkg) on n thread-ranks of each package; asserts the
    results equal byte for byte and returns the port's."""
    port = PORT.run_ranks(n, lambda c: fn(c, PORT))
    ref = REF.run_ranks(n, lambda c: fn(c, REF))
    assert _plain(port) == _plain(ref)
    return port


def test_allreduce_matches_p2p_bitwise():
    """A float SUM: sm folds left in rank order in both packages, so
    the two are bitwise equal; against the p2p route's binomial tree
    only within rounding, as in the reference.  An int64 SUM is
    bitwise the p2p route's."""
    def fn(comm, pkg):
        x = np.random.default_rng(SEED + comm.rank).standard_normal(64)
        r_sm = np.empty_like(x)
        comm.Allreduce(x, r_sm, pkg.op.SUM)
        r_p2p = np.empty_like(x)
        pkg.Tuned().allreduce(comm, x, r_p2p, 64, pkg.dt.DOUBLE,
                              pkg.op.SUM)
        np.testing.assert_allclose(r_sm, r_p2p, rtol=1e-12)
        xi = np.random.default_rng(SEED + comm.rank).integers(
            -2**40, 2**40, 64)
        ri_sm, ri_p2p = np.empty_like(xi), np.empty_like(xi)
        comm.Allreduce(xi, ri_sm, pkg.op.SUM)
        pkg.Tuned().allreduce(comm, xi, ri_p2p, 64, pkg.dt.INT64_T,
                              pkg.op.SUM)
        assert ri_sm.tobytes() == ri_p2p.tobytes()
        return r_sm, ri_sm

    both(4, fn)


def test_noncommutative_user_op_rank_order():
    def fn(comm, pkg):
        # left-fold of digits: (((r0 op r1) op r2) op r3) —
        # order-sensitive; invec is the LOWER-rank partial
        def user(invec, inoutvec, _dt):
            inoutvec[:] = invec * 10 + inoutvec

        op = pkg.op.create(user, commute=False)
        x = np.array([comm.rank + 1], dtype=np.int64)
        r = np.empty_like(x)
        comm.Allreduce(x, r, op)
        want = 0
        for d in range(1, comm.size + 1):
            want = want * 10 + d
        assert r[0] == want, (r[0], want)
        p = np.empty_like(x)
        pkg.Tuned().allreduce(comm, x, p, 1, pkg.dt.INT64_T, op)
        assert p.tobytes() == r.tobytes()
        return r

    both(4, fn)


def test_bcast_and_root_buffer_reuse():
    def fn(comm, pkg):
        buf = np.full(16, float(comm.rank), np.float64)
        if comm.rank == 2:
            buf[:] = 7.25
        comm.Bcast(buf, root=2)
        # root may clobber its buffer immediately after returning
        if comm.rank == 2:
            buf[:] = -1.0
        comm.Barrier()
        if comm.rank != 2:
            assert (buf == 7.25).all()
        return buf

    both(6, fn)


def test_reduce_only_root_receives():
    def fn(comm, pkg):
        x = np.random.default_rng(SEED + comm.rank).integers(0, 99, 4)
        r = np.zeros(4, np.int64) if comm.rank == 1 else None
        comm.Reduce(x, r, pkg.op.MAX, root=1)
        return r

    res = both(5, fn)
    want = np.max([np.random.default_rng(SEED + r).integers(0, 99, 4)
                   for r in range(5)], axis=0)
    assert res[1].tobytes() == want.tobytes()
    assert all(r is None for i, r in enumerate(res) if i != 1)


def test_allgather_and_alltoall():
    def fn(comm, pkg):
        n = comm.size
        mine = np.array([comm.rank * 10 + 1], np.int32)
        allg = np.empty(n, np.int32)
        comm.Allgather(mine, allg)
        assert list(allg) == [r * 10 + 1 for r in range(n)]
        sb = np.array([comm.rank * n + d for d in range(n)], np.int64)
        rb = np.empty_like(sb)
        comm.Alltoall(sb, rb)
        assert list(rb) == [s * n + comm.rank for s in range(n)]
        return allg, rb

    both(4, fn)


def test_minloc_pair_and_in_place():
    def fn(comm, pkg):
        pair = np.zeros(2, dtype=[("v", "f8"), ("i", "i8")])
        pair["v"] = [comm.rank + 0.5, 10 - comm.rank]
        pair["i"] = comm.rank
        out = np.empty_like(pair)
        comm.Allreduce((pair, 2, pkg.dt.DOUBLE_INT),
                       (out, 2, pkg.dt.DOUBLE_INT), pkg.op.MINLOC)
        assert out["i"][0] == 0          # min of rank+0.5 at rank 0
        assert out["i"][1] == comm.size - 1
        buf = np.full(3, comm.rank + 1.0)
        comm.Allreduce(pkg.IN_PLACE, buf, pkg.op.SUM)
        assert (buf == sum(range(1, comm.size + 1))).all()
        return out, buf

    both(3, fn)


def test_derived_datatype_goes_through_pack():
    def fn(comm, pkg):
        vec = pkg.dt.vector(3, 1, 2, pkg.dt.DOUBLE).commit()
        sb = np.arange(6, dtype=np.float64) + comm.rank
        rb = np.zeros(6, dtype=np.float64)
        comm.Allreduce((sb, 1, vec), (rb, 1, vec), pkg.op.SUM)
        n = comm.size
        base = sum(range(n))
        # strided elements reduced; gaps untouched
        assert rb[0] == 0 * n + base and rb[2] == 2 * n + base
        assert rb[1] == 0.0
        return rb

    both(4, fn)


def test_sm_actually_selected_in_thread_world():
    def fn(comm, pkg):
        return [comm.coll.providers.get(f) for f in
                ("barrier", "bcast", "allreduce", "reduce", "allgather",
                 "alltoall")]

    assert both(2, fn) == [["sm"] * 6] * 2


def test_sm_meetings_interleave_with_allreduce_arr():
    """A training step's shape on one comm, on the CPU device path:
    ``allreduce_arr`` (K1's plain version), a host Allreduce of one
    float64 and a Bcast of 64 int64 through sm, ``allgather_arr``
    (K2's plain version) and a Barrier — one rendezvous, one sequence
    of meetings.  Every host result is numpy's; the card results are
    plain torch's (small integers: the float SUM is exact)."""
    n, steps = 1 << 12, 3

    def fn(comm):
        from ompi_tpu_torch.coll import device
        rv = device._get_rendezvous(comm)
        g0 = rv.gen
        out = []
        for s in range(steps):
            g = np.random.default_rng(SEED + 97 * s + comm.rank)
            x = torch.as_tensor(g.integers(0, 1000, n).astype(np.float32))
            y = comm.allreduce_arr(x, port_op.SUM)
            loss = np.array([g.standard_normal()])
            tot = np.empty(1)
            comm.Allreduce(loss, tot, port_op.SUM)
            b = g.integers(0, 2**40, 64) if comm.rank == 0 \
                else np.zeros(64, np.int64)
            comm.Bcast(b, root=0)
            z = comm.allgather_arr(x[:256])
            comm.Barrier()
            out.append((y.numpy(), tot, b, z.numpy()))
        return rv.gen - g0, out

    res = port_run_ranks(4, fn, device_map=lambda r: CPU)
    for gens, out in res:
        assert gens == 5 * steps  # one meeting an op
        for s, (y, tot, b, z) in enumerate(out):
            gs = [np.random.default_rng(SEED + 97 * s + r)
                  for r in range(4)]
            xs = [g.integers(0, 1000, n).astype(np.float32) for g in gs]
            losses = [g.standard_normal() for g in gs]
            assert y.tobytes() == np.sum(xs, axis=0,
                                         dtype=np.float32).tobytes()
            # sm's rank-order left fold
            acc = np.array([losses[0]])
            for v in losses[1:]:
                acc = acc + v
            assert tot.tobytes() == acc.tobytes()
            assert b.tobytes() == gs[0].integers(0, 2**40, 64).tobytes()
            assert z.tobytes() == np.concatenate(
                [x[:256] for x in xs]).tobytes()


def _set(name, value):
    PORT.registry.set(name, value)
    REF.registry.set(name, value)


@pytest.fixture
def monitoring():
    _set("pml_monitoring_enable", True)
    yield
    _set("pml_monitoring_enable", False)


def test_host_deposits_count_like_the_reference(monitoring):
    """A numpy deposit counts its bytes, a barrier's None 0, one
    internal message to every other member, in both packages."""
    def fn(comm, pkg):
        before = comm.state.pml.matrix_rows()
        x = np.arange(10, dtype=np.float64) + comm.rank
        r = np.empty_like(x)
        comm.Allreduce(x, r, pkg.op.SUM)
        comm.Barrier()
        after = comm.state.pml.matrix_rows()
        return [[b - a for a, b in zip(before[k], after[k])]
                for k in ("sent_filtered_msgs", "sent_filtered_bytes",
                          "sent_msgs")]

    res = both(3, fn)
    for r, (msgs, nbytes, user) in enumerate(res):
        assert msgs == [0 if p == r else 2 for p in range(3)]
        assert nbytes == [0 if p == r else 80 for p in range(3)]
        assert user == [0] * 3


def test_device_sdc_flip_of_sm_deposits():
    """``device_sdc`` armed in a thread world: the victim's numpy
    deposit is flipped in a copy (its own array untouched), byte for
    byte as the reference flips it — the same corrupted sum in both
    packages — and in the port a barrier's None deposit passes (the
    reference's flip raises on it, so its run has no Barrier)."""
    knobs = {"ft_inject_plan": "device_sdc:1", "ft_inject_victim_rank": 1,
             "ft_inject_sdc_period": 1}  # every meeting of the victim
    saved = {k: (PORT.registry.get(k), REF.registry.get(k)) for k in knobs}

    def fn(comm, pkg, barrier):
        if barrier:
            comm.Barrier()  # the victim's first meeting: None passes
        x = np.random.default_rng(SEED + comm.rank).integers(
            0, 1 << 20, 32).astype(np.int64)
        keep = x.copy()
        r = np.empty_like(x)
        comm.Allreduce(x, r, pkg.op.SUM)
        assert x.tobytes() == keep.tobytes()
        return r

    try:
        for k, v in knobs.items():
            _set(k, v)
        port = PORT.run_ranks(3, lambda c: fn(c, PORT, True))
        port_nb = PORT.run_ranks(3, lambda c: fn(c, PORT, False))
        ref = REF.run_ranks(3, lambda c: fn(c, REF, False))
    finally:
        for k, (p, r) in saved.items():
            PORT.registry.set(k, p)
            REF.registry.set(k, r)
    draws = [np.random.default_rng(SEED + r).integers(0, 1 << 20, 32)
             for r in range(3)]
    # the flip's target: byte 7 of the middle element of rank 1's copy
    flipped = draws[1].copy()
    flipped.view(np.uint8)[16 * 8 + 7] ^= 0x40
    want = draws[0] + flipped + draws[2]
    assert want.tobytes() != np.sum(draws, axis=0).tobytes()
    assert _plain(port) == _plain(port_nb) == _plain(ref) == \
        [_plain(want)] * 3

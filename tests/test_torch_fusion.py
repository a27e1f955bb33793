"""coll/hbm's small-message fusion tier through both packages: the
nonblocking iallreduce_arr / ibcast_arr / flush_arr surface
(coll/nbc -> coll/fusion), one rendezvous per batch and one K3
fused_batch call per (op, dtype) group, the finalize flush and the
dispatcher drain.  Mirrors the hbm cases of tests/test_coll_fusion.py.

The reference runs its coll/hbm under jax on the CPU (every rank on
one device); the port runs every rank on torch.device("cpu"), where
K3's wrapper takes its plain version.  Knobs are set in both
registries and restored.

Tolerance: byte for byte.  The batches hold int32 and float32
payloads of small integers, exact under any fold order; the dtype of
every result is compared too.
"""


import jax
import numpy as np
import pytest
import torch

import ompi_tpu.coll.fusion  # noqa: F401  (registers the fusion knobs)
from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import convert
from ompi_tpu_torch.coll import device, fusion
from ompi_tpu_torch.kernels import fused
from ompi_tpu_torch.mca.params import registry as port_registry
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import run_ranks as port_run_ranks

CPU = torch.device("cpu")


class knobs:
    """Set MCA knobs in both registries; restore on exit."""

    def __init__(self, vals) -> None:
        self.vals = vals

    def __enter__(self):
        self.saved = [(reg, {k: reg.get(k) for k in self.vals})
                      for reg in (ref_registry, port_registry)]
        for reg, _ in self.saved:
            for k, v in self.vals.items():
                reg.set(k, v)
        return self

    def __exit__(self, *exc):
        for reg, saved in self.saved:
            for k, v in saved.items():
                reg.set(k, v)


def _port(n, fn):
    return port_run_ranks(n, fn, device_map=lambda r: CPU)


def _np(x):
    return convert.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _interleaved(comm, put, op):
    """The canonical fused batch: mixed kinds, ops, dtypes, a scalar.
    Returns (fused results, unfused references) as (dtype, bytes)."""
    r = comm.rank
    a = put(np.arange(16, dtype=np.int32) * (r + 1))
    b = np.ones((8,), np.float32) * (r + 1)
    b[0] = -r
    b = put(b)
    c = put(np.full((5,), r * 3 + 1, np.int32))
    d = put(np.asarray(r + 2, dtype=np.int32))
    reqs = [comm.iallreduce_arr(a, op.SUM),
            comm.iallreduce_arr(b, op.MAX),
            comm.ibcast_arr(c, 1 % comm.size),
            comm.iallreduce_arr(d, op.PROD)]
    for q in reqs:
        q.wait()

    def key(x):
        x = _np(x)
        return str(x.dtype), x.shape, x.tobytes()

    fused_out = [key(q.result) for q in reqs]
    unfused = [key(comm.allreduce_arr(a, op.SUM)),
               key(comm.allreduce_arr(b, op.MAX)),
               key(comm.bcast_arr(c, 1 % comm.size)),
               key(comm.allreduce_arr(d, op.PROD))]
    return fused_out, unfused


def test_fused_byte_identical_hbm():
    """The interleaved batch on a one-card comm at 3 ranks: the
    port's fused results equal its unfused blocking path and the
    reference's fused results, byte for byte, dtype and shape
    included; the nonblocking surface is coll/nbc's."""
    def port_fn(comm):
        assert comm.coll.providers["iallreduce_arr"] == "nbc"
        assert comm.coll.providers["ibcast_arr"] == "nbc"
        assert comm.coll.providers["allreduce_arr"] == "hbm"
        return _interleaved(
            comm, lambda a: convert.to_torch(a, comm.device), port_op)

    def ref_fn(comm):
        return _interleaved(
            comm, lambda a: jax.device_put(a, comm.device), ref_op)

    port = _port(3, port_fn)
    ref = ref_run_ranks(3, ref_fn, device_map=lambda r: jax.devices()[0])
    for (pf, pu), (rf, _ru) in zip(port, ref):
        assert pf == pu
        assert pf == rf


def test_fused_flush_is_one_call_per_group(monkeypatch):
    """One flush of the interleaved batch is one rendezvous and one
    K3 call per (op, dtype) group: (SUM, int32) with the int32 bcast
    riding it as a copy-from-root entry, (MAX, float32), (PROD,
    int32) — three calls, on the last arriver only."""
    calls = []
    real = fused.fused_batch

    def counting(slots, opname):
        calls.append((opname, slots[0][0][0].dtype,
                      tuple(root for _, root in slots)))
        return real(slots, opname)

    monkeypatch.setattr(fused, "fused_batch", counting)

    def fn(comm):
        rv = device._get_rendezvous(comm)
        comm.Barrier()
        g0 = rv.gen
        out = _interleaved(
            comm, lambda a: convert.to_torch(a, comm.device), port_op)
        return out, rv.gen - g0

    res = _port(3, fn)
    # the batch's meeting, then the four unfused blocking calls
    assert [g for _, g in res] == [5, 5, 5]
    assert sorted(calls, key=repr) == sorted([
        ("MPI_SUM", torch.int32, (None, 1)),
        ("MPI_MAX", torch.float32, (None,)),
        ("MPI_PROD", torch.int32, (None,))], key=repr)


def test_fused_counts_one_batch():
    """A wait on the FIRST request flushes the whole pending batch as
    ONE fused dispatch; the pvars record batch vs per-collective
    counts."""
    b0 = fusion._pv_batches.read()
    c0 = fusion._pv_colls.read()
    y0 = fusion._pv_bytes.read()

    def fn(comm):
        qs = [comm.iallreduce_arr(torch.arange(4, dtype=torch.int32) + k,
                                  port_op.SUM)
              for k in range(6)]
        qs[0].wait()  # flushes all six
        assert all(q.complete for q in qs)
        return [int(q.result.sum()) for q in qs]

    res = _port(4, fn)
    assert res[0] == [4 * (6 + 4 * k) for k in range(6)]
    assert fusion._pv_batches.read() - b0 == 4   # one batch per rank
    assert fusion._pv_colls.read() - c0 == 24    # six collectives each
    assert fusion._pv_bytes.read() - y0 == 4 * 6 * 16


def test_fused_auto_flush_at_max_ops():
    with knobs({"coll_device_fusion_max_ops": 3}):
        def fn(comm):
            qs = [comm.iallreduce_arr(torch.tensor(k, dtype=torch.int32),
                                      port_op.SUM)
                  for k in range(3)]
            # the third enqueue crossed the bound: batch already ran
            assert all(q.complete for q in qs)
            assert all(q.result.shape == () for q in qs)
            return [int(q.result) for q in qs]

        for vals in _port(2, fn):
            assert vals == [0, 2, 4]


def test_fusion_disabled_knob_runs_immediately():
    with knobs({"coll_device_fusion": False}):
        def fn(comm):
            q = comm.iallreduce_arr(torch.arange(4, dtype=torch.int32),
                                    port_op.SUM)
            assert q.complete  # immediate blocking execution
            return q.result.tolist()

        assert _port(2, fn)[0] == [0, 2, 4, 6]


def test_large_payload_bypasses_fusion():
    """Above coll_device_fusion_threshold the op runs unfused
    immediately (bandwidth-dominated; coalescing buys nothing), and so
    does a payload of a type the kernel does not take."""
    b0 = fusion._pv_batches.read()

    def fn(comm):
        big = torch.ones(65536 // 4 + 1)
        q = comm.iallreduce_arr(big, port_op.SUM)
        assert q.complete
        odd = torch.zeros(4, dtype=torch.float8_e4m3fn)
        assert comm.ibcast_arr(odd, 0).complete
        return float(q.result[0])

    assert _port(2, fn) == [2.0, 2.0]
    assert fusion._pv_batches.read() == b0


def test_fused_numpy_payload_moves_to_the_device():
    """A host buffer enqueues like a tensor (it moves to the comm's
    device at enqueue) and comes back as a tensor."""
    def fn(comm):
        q = comm.ibcast_arr(np.arange(3, dtype=np.int32) + comm.rank, 1)
        q.wait()
        return q.result

    for out in _port(2, fn):
        assert isinstance(out, torch.Tensor)
        assert out.tolist() == [1, 2, 3]


def test_fused_flush_at_finalize():
    """A batch enqueued and never waited on must flush at
    MPI_Finalize (the finalize hook), not die with the rank."""
    reqs = {}

    def fn(comm):
        reqs[comm.rank] = comm.iallreduce_arr(
            torch.arange(8, dtype=torch.int32), port_op.SUM)
        return comm.rank

    _port(4, fn)
    exp = (np.arange(8, dtype=np.int32) * 4).tobytes()
    for r, q in reqs.items():
        assert q.complete, f"rank {r} not flushed at finalize"
        assert _np(q.result).tobytes() == exp


def test_fused_batch_mismatch_is_clear_error():
    """Divergent batches across ranks (an SPMD bug) must raise a
    diagnosable error on every rank, never deadlock; every request of
    the failed batch carries the error."""
    def fn(comm):
        qs = []
        if comm.rank == 0:
            qs.append(comm.iallreduce_arr(torch.tensor(1), port_op.SUM))
        qs.append(comm.iallreduce_arr(torch.arange(4, dtype=torch.int32),
                                      port_op.SUM))
        with pytest.raises(RuntimeError, match="batch mismatch"):
            comm.flush_arr()
        for q in qs:
            with pytest.raises(RuntimeError, match="batch mismatch"):
                q.wait()
        return True

    assert _port(2, fn) == [True, True]


def test_dispatcher_drains_rejects_and_revives():
    """coll_device_dispatcher on: every meeting computes on the
    dispatcher thread; the last rank's finalize drains and closes it,
    a late submit is rejected, and a fresh world revives it."""
    with knobs({"coll_device_dispatcher": True}):
        res = _port(2, lambda c: int(c.allreduce_arr(
            torch.tensor(1, dtype=torch.int32), port_op.SUM)))
        assert res == [2, 2]
    d = device._dispatcher_singleton
    assert d is not None and d.closed  # last finalize drained it
    with pytest.raises(RuntimeError, match="closed"):
        d.submit(lambda: None)
    with pytest.raises(RuntimeError, match="finalize"):
        device._dispatcher()
    # a fresh world in the same process revives the plane
    res = _port(2, lambda c: int(c.allreduce_arr(
        torch.tensor(3, dtype=torch.int32), port_op.SUM)))
    assert res == [6, 6]


def test_fused_outputs_are_each_ranks_own():
    """Torch tensors are mutable: every rank gets its own output of
    every slot (the reference hands all ranks one immutable array), so
    a rank writing into its result never changes a peer's."""
    def fn(comm):
        q = comm.iallreduce_arr(torch.ones(4), port_op.SUM)
        p = comm.ibcast_arr(torch.full((3,), float(comm.rank)), 0)
        comm.flush_arr()
        outs = (q.result, p.result)
        comm.Barrier()
        if comm.rank == 0:
            for o in outs:
                o.fill_(-7.0)
        comm.Barrier()
        return [o.tolist() for o in outs]

    res = _port(3, fn)
    assert res[1] == res[2] == [[3.0] * 4, [0.0] * 3]
    assert res[0] == [[-7.0] * 4, [-7.0] * 3]


def test_mesh_mode_fusion_raises_not_implemented():
    """A comm whose members partly share devices (4 ranks on 2) has no
    fusion mode: its nonblocking calls run the blocking path, which
    refuses the comm, naming the mesh tier.  (Pairwise-distinct
    devices fuse in mesh mode: tests/test_torch_mesh.py.)"""
    def fn(comm):
        assert comm.coll.providers["allreduce_arr"] == "tpu"
        with pytest.raises(NotImplementedError, match="mesh"):
            comm.iallreduce_arr(torch.ones(2), port_op.SUM).wait()
        return True

    assert port_run_ranks(
        4, fn, device_map=lambda r: torch.device("cpu", r % 2)) \
        == [True] * 4


def test_fused_group_plan_matches_reference_groups():
    """_group_plan groups exactly as the reference's does for the
    ops it reduces natively (SUM/MAX/MIN, bcast joining SUM); the
    port's K3 folds the other ops in groups of their own where the
    reference gathers and folds them slot by slot."""
    from ompi_tpu.coll import fusion as ref_fusion
    sig = (("allreduce", (16,), "i4", "MPI_SUM"),
           ("allreduce", (8,), "f4", "MPI_MAX"),
           ("bcast", (5,), "i4", 1),
           ("allreduce", (1,), "i4", "MPI_PROD"),
           ("allreduce", (3,), "f4", "MPI_MAX"),
           ("allreduce", (2,), "i4", "MPI_PROD"))
    ref_groups, ref_folds = ref_fusion._group_plan(sig)
    port_groups = fusion._group_plan(sig)
    assert port_groups[:len(ref_groups)] == ref_groups
    assert port_groups[len(ref_groups):] == (("MPI_PROD", "i4", (3, 5)),)
    assert ref_folds == (3, 5)

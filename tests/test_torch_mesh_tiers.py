"""The mesh tier's large-message tiers through both packages: the plan
(coll/plan.mesh_reduce: native, segring and segrd lowerings), the
pipelined segments (coll/pipeline: _mesh_seg_reduce with
coll_plan_enable=0, _mesh_seg_bcast, _mesh_seg_alltoall) and their
selection (coll/tuned.device_algorithm).

The same rank programs run on the reference (jax on the CPU, one rank
a virtual device: its coll/tpu) and on the port (one rank a logical
CPU device, the kernels' plain versions), with the same knobs set in
both registries: coll_pipeline_min_bytes and coll_seg_size shrunk so
that test-sized arrays take the tiers, several segments a call, ragged
tails included.  Mirrors the mesh cases of tests/test_coll_pipeline.py
and tests/test_coll_plan.py.

Tolerance: byte for byte.  The workloads' inputs are small integers
(exact under any fold order).  The segring and segrd schedules are
also held byte for byte on RANDOM float32 inputs: the port's K6 folds
every element in the reference's order, one IEEE operation a step, so
even float SUM is the reference's bytes there (only the native psum
lowering, whose order XLA picks, is a band).
"""

import jax
import numpy as np
import pytest
import torch

import ompi_tpu.coll.pipeline  # noqa: F401  (registers the tier knobs)
import ompi_tpu.coll.plan  # noqa: F401
from ompi_tpu.coll import tuned as ref_tuned
from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import convert
from ompi_tpu_torch.coll import device, pipeline, plan, tuned
from ompi_tpu_torch.mca.params import registry as port_registry
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import logical_devices
from ompi_tpu_torch.testing import run_ranks as port_run_ranks

# everything >= 2 KiB takes the tiers, in 4 KiB segments
PLAN_ON = {"coll_pipeline_enable": True, "coll_pipeline_min_bytes": 2048,
           "coll_seg_size": 4096, "coll_pipeline_rd_max_bytes": 0,
           "coll_hier_enable": False, "coll_plan_enable": True}
PIPE_ON = dict(PLAN_ON, coll_plan_enable=False)
FUSED = {"coll_pipeline_enable": False, "coll_hier_enable": False}
RD = {"coll_pipeline_rd_max_bytes": 1 << 30}
HOP = {"coll_plan_native_reduce": False}


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


def _ref(n, fn):
    """fn(comm, put, op) on the reference's coll/tpu (one virtual
    device a rank)."""
    return ref_run_ranks(
        n, lambda c: fn(c, lambda a: jax.device_put(a, c.device), ref_op),
        devices=True)


def _port(n, fn):
    return port_run_ranks(
        n, lambda c: fn(c, lambda a: convert.to_torch(a, c.device),
                        port_op),
        device_map=logical_devices("cpu"))


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return convert.to_numpy(x).tobytes()
    return np.asarray(x).tobytes()


def _mixed_ops(comm, put, op):
    """The segmented workload of test_coll_pipeline: allreduce / bcast
    / alltoall over sizes that leave tails, exact-representable values.
    Returns (rank-symmetric result bytes, this rank's alltoall bytes)."""
    r, size = comm.rank, comm.size
    out = []
    base = (np.arange(4099, dtype=np.float32) % 11).astype(np.float32)
    out.append(_bytes(comm.allreduce_arr(put(base + r), op.SUM)))
    xi = put((np.arange(3072, dtype=np.int32) % 17) * (r + 1))
    out.append(_bytes(comm.allreduce_arr(xi, op.MAX)))
    xb = put(np.full(2048 + 1, 0xFF ^ (1 << r), np.uint32))
    out.append(_bytes(comm.allreduce_arr(xb, op.BAND)))
    out.append(_bytes(comm.bcast_arr(put(base * (r + 1)),
                                     root=min(2, size - 1))))
    m = 1031 * size  # an odd per-rank block
    a2a = _bytes(comm.alltoall_arr(put(np.arange(m, dtype=np.int32)
                                       + 100000 * r)))
    return b"".join(out), a2a


def _reduce_ops(comm, put, op):
    """Allreduces whose counts leave count % seg at 0, +1 and -1, over
    float32, int32, float16 and uint32 with SUM, MAX, PROD and BAND —
    all values exact at any fold order.  Returns the result bytes."""
    r = comm.rank
    out = []
    for n in (4096, 4097, 4095):
        out.append(_bytes(comm.allreduce_arr(
            put((np.arange(n, dtype=np.float32) % 11) + r), op.SUM)))
        out.append(_bytes(comm.allreduce_arr(
            put(((np.arange(n) % 17) * (r + 1)).astype(np.int32)), op.MAX)))
    xh = put((np.arange(3072) % 7).astype(np.float16) + r)
    out.append(_bytes(comm.allreduce_arr(xh, op.MAX)))
    xp = put(((np.arange(4099) % 5) + 1).astype(np.float32))
    out.append(_bytes(comm.allreduce_arr(xp, op.PROD)))
    xb = put(np.full(2048 + 1, 0xFF ^ (1 << r), np.uint32))
    out.append(_bytes(comm.allreduce_arr(xb, op.BAND)))
    return b"".join(out)


def test_segmented_mesh_byte_identical():
    """coll_plan_enable=0: segring / segbcast / sega2a segments
    through the asynchronous rendezvous, byte for byte the reference's
    and the port's own single dispatch; the tier engaged (pvars moved,
    several segments an op) and every rank agrees."""
    def fn(comm, put, op):
        ops0, segs0 = pipeline.pv_ops.read(), pipeline.pv_segments.read()
        common, a2a = _mixed_ops(comm, put, op)
        comm.Barrier()
        return common, a2a, pipeline.pv_ops.read() - ops0, \
            pipeline.pv_segments.read() - segs0

    with knobs(PIPE_ON):
        port = _port(4, fn)
        ref = _ref(4, lambda c, p, o: _mixed_ops(c, p, o))
    with knobs(FUSED):
        single = _port(4, lambda c, p, o: _mixed_ops(c, p, o))
    assert len({c for c, *_ in port}) == 1
    for (pc, pa, dops, dsegs), rr, ss in zip(port, ref, single):
        assert (pc, pa) == tuple(rr) == tuple(ss)
        assert dops >= 5 * 4 and dsegs > dops  # 5 ops on each of 4 ranks


def test_segmented_mesh_mixed_dtypes():
    """Odd dtypes through the segments' ragged tails: float16 MAX,
    int32 PROD, uint32 BOR — bytewise the reference's."""
    def fn(comm, put, op):
        r = comm.rank
        h = put(((np.arange(2050) % 8) + r).astype(np.float16))
        p = put(((np.arange(1500) % 3) + (r % 2)).astype(np.int32))
        b = put((np.arange(1025, dtype=np.uint32) << (r % 4)))
        return (_bytes(comm.allreduce_arr(h, op.MAX)),
                _bytes(comm.allreduce_arr(p, op.PROD)),
                _bytes(comm.allreduce_arr(b, op.BOR)))

    with knobs(PIPE_ON):
        port = _port(4, fn)
        ref = _ref(4, fn)
    assert port == [tuple(r) for r in ref]
    assert len(set(port)) == 1


def test_recursive_doubling_window():
    """A power-of-two comm inside the rd window picks segrd (not
    segring) in both packages, and its segments are the reference's
    bytes."""
    def fn(comm, put, op):
        x = put((np.arange(4099, dtype=np.float32) % 11) + comm.rank)
        nbytes = 4099 * 4
        pick = (tuned if op is port_op else ref_tuned).device_algorithm
        return (_bytes(comm.allreduce_arr(x, op.SUM)),
                pick(comm, "allreduce", nbytes))

    with knobs(dict(PIPE_ON, **RD)):
        port = _port(4, fn)
        ref = _ref(4, fn)
    assert [a for _, a in port] == [a for _, a in ref] == ["segrd"] * 4
    assert [b for b, _ in port] == [b for b, _ in ref]
    assert len({b for b, _ in port}) == 1


def test_plan_mesh_byte_identical_mixed_dtypes():
    """Plan-path mesh allreduce (native SUM/MAX, segring for PROD and
    BAND): bytes equal to the reference's across dtypes and ragged
    tails, every rank agreeing, plans built on first use and hit on
    the second pass."""
    def fn(comm, put, op):
        b0, h0 = plan.pv_builds.read(), plan.pv_hits.read()
        out = _reduce_ops(comm, put, op)
        again = _reduce_ops(comm, put, op)
        comm.Barrier()
        return out, again, plan.pv_builds.read() - b0, \
            plan.pv_hits.read() - h0

    with knobs(PLAN_ON):
        port = _port(4, fn)
        ref = _ref(4, lambda c, p, o: _reduce_ops(c, p, o))
    assert len({b for b, *_ in port}) == 1
    for (pb, pb2, builds, hits), rb in zip(port, ref):
        assert pb == pb2 == rb
        assert builds > 0 and hits > 0


@pytest.mark.parametrize("extra", [RD, HOP, dict(RD, **HOP)],
                         ids=["segrd", "segring-hop", "segrd-hop"])
def test_plan_segrd_and_hop_explicit_byte_identical(extra):
    """The recursive-doubling pick and the hop-explicit (native off)
    lowering of both schedules: the reference's bytes."""
    with knobs(dict(PLAN_ON, **extra)):
        port = _port(4, _reduce_ops)
        ref = _ref(4, _reduce_ops)
    assert port == ref


@pytest.mark.parametrize("tier", ["plan", "pipe"])
@pytest.mark.parametrize("alg", ["segring", "segrd"])
def test_schedules_float_sum_byte_exact(alg, tier):
    """RANDOM float32 SUM (not exact at any order) through the segring
    and segrd schedules, native lowering off: the port's K6 folds each
    element in the reference's order, so the bytes are the
    reference's — n = 4 and 8, ragged tails."""
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal(4099).astype(np.float32) for _ in range(8)]

    def fn(comm, put, op):
        return _bytes(comm.allreduce_arr(put(xs[comm.rank]), op.SUM))

    vals = dict(PLAN_ON if tier == "plan" else PIPE_ON, **HOP)
    if alg == "segrd":
        vals.update(RD)
    for n in (4, 8):
        with knobs(vals):
            port = _port(n, fn)
            ref = _ref(n, fn)
        assert port == ref
        assert len(set(port)) == 1


def _gens(fn):
    """fn(comm) -> number of ops; returns (ops, rendezvous generations
    those ops took) per rank.  The closing Barrier is one generation of
    the same rendezvous (a thread world's Barrier meets in coll/sm)."""
    def wrapped(comm):
        rv = device._get_rendezvous(comm)
        comm.Barrier()
        g0 = rv.gen
        ops = fn(comm)
        comm.Barrier()
        return ops, rv.gen - g0 - 1
    return port_run_ranks(4, wrapped, device_map=logical_devices("cpu"))


def _three_allreduces(comm):
    for n in (4096, 4097, 6144):  # multi-segment sizes
        comm.allreduce_arr(torch.arange(n, dtype=torch.float32) % 11
                           + comm.rank, port_op.SUM)
    return 3


def test_plan_mesh_one_rendezvous_per_op():
    """On the mesh plan path an N-segment collective is ONE meeting
    (the Rendezvous generation advances once per op); with plans off it
    is one meeting per segment."""
    with knobs(PLAN_ON):
        for ops, gens in _gens(_three_allreduces):
            assert gens == ops == 3
    with knobs(PIPE_ON):
        # 4 KiB segments of float32: 4, 5 and 6 segments
        for ops, gens in _gens(_three_allreduces):
            assert (ops, gens) == (3, 4 + 5 + 6)


def test_mesh_segments_write_the_callers_output():
    """The mesh segments need neither the identity pad nor a final
    concatenation: the segmented allreduce, bcast and alltoall return
    tensors of the payload's exact size and shape (2-D included)."""
    def fn(comm):
        r = comm.rank
        x = (torch.arange(4099 * 2, dtype=torch.float32) % 7 + r
             ).reshape(4099, 2)
        a = torch.arange(1031 * 4 * 3, dtype=torch.int32).reshape(
            1031 * 4, 3) + 1000 * r
        y = comm.allreduce_arr(x, port_op.SUM)
        b = comm.bcast_arr(x, 1)
        z = comm.alltoall_arr(a)
        return y, b, z

    with knobs(PIPE_ON):
        res = port_run_ranks(4, fn, device_map=logical_devices("cpu"))
    base = torch.arange(4099 * 2, dtype=torch.float32) % 7
    for k, (y, b, z) in enumerate(res):
        assert y.shape == b.shape == (4099, 2)
        assert torch.equal(y.reshape(-1), 4 * base + 6)
        assert torch.equal(b.reshape(-1), base + 1)
        want = torch.cat([(torch.arange(1031 * 4 * 3, dtype=torch.int32)
                           .reshape(4, 1031, 3)[k] + 1000 * j)
                          for j in range(4)])
        assert torch.equal(z, want)

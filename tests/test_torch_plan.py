"""coll/hbm's large-message tiers through both packages: the compiled
plan (coll/plan.hbm_reduce) and the pipelined segments
(coll/pipeline: _hbm_seg_reduce with coll_plan_enable=0,
_hbm_seg_alltoall), their selection (coll/tuned.device_algorithm,
coll/calibrate) and the pad identities (coll/pipeline._pad_value).

The same rank programs run on the reference (jax on the CPU, every
rank on one device: its coll/hbm) and on the port (every rank on
torch.device("cpu"), the stacked kernels' plain versions), with the
same knobs set in both registries: coll_pipeline_min_bytes and
coll_seg_size shrunk so that test-sized arrays take the tiers, several
segments a call, ragged tails included.  Mirrors the hbm cases of
tests/test_coll_plan.py and tests/test_coll_pipeline.py.

Tolerance: byte for byte.  The inputs are small integers (in float32,
float16 and int32), exact under any fold order, so even float SUM and
PROD compare as bytes; int8 and float64 stay out (the reference
promotes int8 sums and computes float64 in float32 with x64 off).
"""

import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import ompi_tpu.coll.pipeline as ref_pipeline
import ompi_tpu.coll.plan  # noqa: F401  (registers the plan knobs)
from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import convert
from ompi_tpu_torch.coll import calibrate, device, pipeline, plan, tuned
from ompi_tpu_torch.mca.params import registry as port_registry
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import run_ranks as port_run_ranks

CPU = torch.device("cpu")

# everything >= 2 KiB takes the tiers, in 4 KiB segments
PLAN_ON = {"coll_pipeline_enable": True, "coll_pipeline_min_bytes": 2048,
           "coll_seg_size": 4096, "coll_pipeline_rd_max_bytes": 0,
           "coll_hier_enable": False, "coll_plan_enable": True}
PIPE_ON = dict(PLAN_ON, coll_plan_enable=False)
FUSED = {"coll_pipeline_enable": False, "coll_hier_enable": False}


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
    """fn(comm, put, op) on the reference's coll/hbm (one device)."""
    return ref_run_ranks(
        n, lambda c: fn(c, lambda a: jax.device_put(a, c.device), ref_op),
        device_map=lambda r: jax.devices()[0])


def _port(n, fn):
    return port_run_ranks(
        n, lambda c: fn(c, lambda a: convert.to_torch(a, c.device),
                        port_op),
        device_map=lambda r: CPU)


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return convert.to_numpy(x).tobytes()
    return np.asarray(x).tobytes()


def _reduce_ops(comm, put, op):
    """Allreduces whose counts leave count % seg at 0, +1 and -1,
    over float32, int32 and float16 with SUM, MAX and PROD — all
    values exact at any fold order.  Returns the result bytes."""
    r = comm.rank
    out = []
    for n in (4096, 4097, 4095):
        x = put((np.arange(n, dtype=np.float32) % 11) + r)
        out.append(_bytes(comm.allreduce_arr(x, op.SUM)))
        xi = put(((np.arange(n) % 17) * (r + 1)).astype(np.int32))
        out.append(_bytes(comm.allreduce_arr(xi, op.MAX)))
    xh = put((np.arange(3072) % 7).astype(np.float16) + r)
    out.append(_bytes(comm.allreduce_arr(xh, op.MAX)))
    xp = put(((np.arange(4099) % 5) + 1).astype(np.float32))
    out.append(_bytes(comm.allreduce_arr(xp, op.PROD)))
    xb = put(np.full(2048 + 1, 0xFF ^ (1 << r), np.uint32))
    out.append(_bytes(comm.allreduce_arr(xb, op.BAND)))
    return b"".join(out)


def _seg_ops(comm, put, op):
    """The hbm segmentation workload of test_coll_pipeline: a ragged
    float32 allreduce and an int32 alltoall with odd blocks."""
    r = comm.rank
    x = put((np.arange(5003, dtype=np.float32) % 7) + r)
    a = put(np.arange(1009 * comm.size, dtype=np.int32) + 1000 * r)
    return (_bytes(comm.allreduce_arr(x, op.SUM)),
            _bytes(comm.alltoall_arr(a)))


def test_plan_hbm_byte_identical():
    """Plan path over the one-card module: the port equals the
    reference byte for byte, equals its own single-dispatch path, and
    resolves plans (coll_plan_builds rises) on first use."""
    def fn(comm, put, op):
        b0 = plan.pv_builds.read() if op is port_op else 0
        out = _reduce_ops(comm, put, op)
        comm.Barrier()
        return out, (plan.pv_builds.read() - b0 if op is port_op else 0)

    with knobs(PLAN_ON):
        port = _port(4, fn)
        ref = _ref(4, fn)
    with knobs(FUSED):
        single = _port(4, fn)
    for (pb, builds), (rb, _), (sb, _) in zip(port, ref, single):
        assert pb == rb == sb
        assert builds > 0


def test_segmented_hbm_byte_identical():
    """coll_plan_enable=0: per-segment stacked kernels through the
    asynchronous rendezvous, and the segmented alltoall, byte for byte
    the reference's and the single-dispatch path's."""
    with knobs(PIPE_ON):
        port = _port(4, _seg_ops)
        ref = _ref(4, _seg_ops)
    with knobs(FUSED):
        single = _port(4, _seg_ops)
    assert port == ref == single
    assert len({ar for ar, _ in port}) == 1  # allreduce: rank-symmetric


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
    return port_run_ranks(4, wrapped, device_map=lambda r: CPU)


def _three_allreduces(comm):
    for n in (4096, 4097, 6144):  # multi-segment sizes
        comm.allreduce_arr(torch.arange(n, dtype=torch.float32) % 11
                           + comm.rank, port_op.SUM)
    return 3


def test_plan_one_rendezvous_per_op():
    """THE structural claim: on the plan path an N-segment collective
    is ONE meeting (the Rendezvous generation advances once per op);
    with plans off it is one meeting per segment."""
    with knobs(PLAN_ON):
        for ops, gens in _gens(_three_allreduces):
            assert gens == ops == 3
    with knobs(PIPE_ON):
        # 4 KiB segments of float32: 4, 5 and 6 segments
        for ops, gens in _gens(_three_allreduces):
            assert (ops, gens) == (3, 4 + 5 + 6)


def test_plan_cache_builds_then_hits():
    """A plan is resolved once per (geometry, dtype, op) and rank;
    later ops of the same shape only hit."""
    def fn(comm):
        x = torch.arange(4099, dtype=torch.float32) % 11
        for _ in range(3):
            comm.allreduce_arr(x, port_op.SUM)
        comm.Barrier()
        return len(comm.__dict__["_coll_plans"])

    with knobs(PLAN_ON):
        b0, h0 = plan.pv_builds.read(), plan.pv_hits.read()
        assert port_run_ranks(4, fn, device_map=lambda r: CPU) == [1] * 4
        assert plan.pv_builds.read() - b0 == 4
        assert plan.pv_hits.read() - h0 == 8


def test_plan_segments_match_reference():
    """_plan_segments: sub-segment payloads quantize to the next
    power of two (a multiple of the comm size), larger ones count
    whole segments."""
    from ompi_tpu.coll import plan as ref_plan

    class C:
        def __init__(self, size):
            self.size = size

    for size in (2, 3, 4, 8):
        for seg in (1024, 262144):
            for n in (1, 5, 1000, 1023, 1024, 1025, 262143, 262144,
                      2 ** 21 + 3):
                assert plan._plan_segments(C(size), n, seg) == \
                    ref_plan._plan_segments(C(size), n, seg)


BF16 = np.dtype(ml_dtypes.bfloat16)
PAD_DTYPES = [np.bool_, np.int8, np.uint8, np.int16, np.uint16, np.int32,
              np.uint32, np.int64, np.uint64, np.float16, np.float32,
              np.float64, np.complex64, np.complex128, BF16]
PAD_OPS = [None, "MPI_SUM", "MPI_PROD", "MPI_MAX", "MPI_MIN", "MPI_LAND",
           "MPI_BAND", "MPI_LOR", "MPI_BOR", "MPI_LXOR", "MPI_BXOR"]


@pytest.mark.parametrize("dt", PAD_DTYPES, ids=lambda d: np.dtype(d).name)
def test_pad_value_matches_reference(dt):
    """B5's last piece: the identity each op pads a tail segment with,
    for every op (None: data movement) on every dtype, as the bytes
    of one element of that dtype."""
    dt = np.dtype(dt)
    for opname in PAD_OPS:
        want = np.asarray(ref_pipeline._pad_value(opname, dt)).astype(dt)
        got = pipeline._pad_value(opname, convert.torch_dtype(dt))
        t = torch.full((1,), got, dtype=convert.torch_dtype(dt))
        assert convert.to_numpy(t).tobytes() == want.tobytes(), opname


def test_device_algorithm_matches_reference():
    """coll/tuned.device_algorithm: the same pick for every kind and
    size as the reference (its hierarchical branch off), static knobs
    and a measured profile alike; cached per comm."""
    from ompi_tpu.coll import tuned as ref_tuned

    class C:
        def __init__(self, size):
            self.size = size

    sizes = (1, 2047, 2048, 4096, 1 << 20, (8 << 20) - 1, 8 << 20)
    vals = dict(PLAN_ON, coll_pipeline_rd_max_bytes=8 << 20)
    with knobs(vals):
        for size in (2, 3, 4, 8):
            for kind in ("allreduce", "bcast", "alltoall"):
                pc, rc = C(size), C(size)
                for nb in sizes:
                    assert tuned.device_algorithm(pc, kind, nb, "MPI_SUM") \
                        == ref_tuned.device_algorithm(rc, kind, nb,
                                                      "MPI_SUM"), \
                        (size, kind, nb)
                assert "_pipeline_pick" in pc.__dict__


def _profile(tmp_path, **fields):
    prof = {"host": "test", "backend": "cpu", "source": "test",
            "host_alpha_us": 5.0, "host_gbs": 10.0, "dispatch_us": 600.0,
            "crossover_bytes": {"allreduce": 1 << 20}}
    prof.update(fields)
    p = tmp_path / "profile.json"
    p.write_text(json.dumps(prof))
    return str(p)


def test_calibrate_readers_match_reference(tmp_path):
    """The selection readers read one profile file the same way in
    both packages; with measured rules off (the default) each returns
    its static value."""
    from ompi_tpu.coll import calibrate as ref_cal
    path = _profile(tmp_path, seg_bytes=65536,
                    seg_crossover_bytes={"allreduce": 131072},
                    hier_min_bytes=77777)
    readers = [
        lambda m: m.segment_bytes(8, 1 << 20),
        lambda m: m.segmented_crossover("allreduce", 8, 4 << 20),
        lambda m: m.segmented_crossover("alltoall", 8, 4 << 20),
        lambda m: m.hier_min_bytes(8, 1 << 20),
        lambda m: m.measured_threshold("allreduce_small", 8, 10000),
        lambda m: m.measured_threshold("bcast_pipeline", 8, 262144),
        lambda m: m.measured_threshold("alltoall_bruck", 8, 1024),
        lambda m: m.crossover_bytes("allreduce", 8),
    ]
    try:
        with knobs({"coll_tuned_profile_path": path}):
            calibrate.reset_cache()
            ref_cal.reset_cache()
            assert not calibrate.use_measured_rules()
            statics = [r(calibrate) for r in readers[:7]]
            assert statics == [1 << 20, 4 << 20, 4 << 20, 1 << 20, 10000,
                               262144, 1024]
            with knobs({"coll_tuned_use_measured_rules": True}):
                port = [r(calibrate) for r in readers]
                ref = [r(ref_cal) for r in readers]
            assert port == ref
            assert port[:4] == [65536, 131072, 4 << 20, 77777]
    finally:
        calibrate.reset_cache()
        ref_cal.reset_cache()


def test_measured_segment_size_drives_the_plan(tmp_path):
    """With measured rules on, the profile's segment size and
    crossover replace coll_seg_size and coll_pipeline_min_bytes: a
    2 KiB segment splits a 4099-float allreduce into 9 segments
    through the pipeline, byte-identical to the single dispatch."""
    path = _profile(tmp_path, seg_bytes=2048,
                    seg_crossover_bytes={"allreduce": 4096})
    vals = dict(PIPE_ON, coll_pipeline_min_bytes=1 << 30,
                coll_tuned_profile_path=path,
                coll_tuned_use_measured_rules=True)

    def fn(comm):
        x = torch.arange(4099, dtype=torch.float32) % 11 + comm.rank
        return _bytes(comm.allreduce_arr(x, port_op.SUM))

    try:
        with knobs(vals):
            calibrate.reset_cache()
            s0 = pipeline.pv_segments.read()
            got = port_run_ranks(4, fn, device_map=lambda r: CPU)
            assert pipeline.pv_segments.read() - s0 == 4 * 9
    finally:
        calibrate.reset_cache()
    with knobs(FUSED):
        want = port_run_ranks(4, fn, device_map=lambda r: CPU)
    assert got == want


@pytest.mark.parametrize("kind", ["allreduce", "alltoall"])
def test_below_the_crossover_is_one_meeting_one_call(kind, monkeypatch):
    """Under coll_pipeline_min_bytes an allreduce or alltoall is the
    single dispatch: one meeting and ONE stacked-kernel call (K1 or
    K2), no plan and no segment, and the bytes of the reference."""
    from ompi_tpu_torch.kernels import stacked
    name = "stacked_reduce" if kind == "allreduce" else "stacked_copy"
    real, calls = getattr(stacked, name), []

    def counting(*a, **k):
        calls.append(a[1])
        return real(*a, **k)

    monkeypatch.setattr(stacked, name, counting)

    def fn(comm, put, op):
        x = put((np.arange(128 * comm.size, dtype=np.float32) % 13)
                + comm.rank)  # 2 KiB a rank at 4 ranks: under 4 KiB
        rv = device._get_rendezvous(comm) if op is port_op else None
        comm.Barrier()
        g0, s0, b0 = (rv.gen, pipeline.pv_segments.read(),
                      plan.pv_builds.read()) if rv else (0, 0, 0)
        y = comm.allreduce_arr(x, op.SUM) if kind == "allreduce" \
            else comm.alltoall_arr(x)
        comm.Barrier()
        if rv is None:
            return _bytes(y), None
        # the closing Barrier meets at the same rendezvous (coll/sm)
        return _bytes(y), (rv.gen - g0 - 1,
                           pipeline.pv_segments.read() - s0,
                           plan.pv_builds.read() - b0)

    with knobs(dict(PLAN_ON, coll_pipeline_min_bytes=4096)):
        port = _port(4, fn)
        ref = _ref(4, fn)
    assert [b for b, _ in port] == [b for b, _ in ref]
    assert [g for _, g in port] == [(1, 0, 0)] * 4
    assert calls == ["MPI_SUM" if kind == "allreduce" else "alltoall"]


def test_tiers_skip_small_and_divisor_free_calls():
    """Below coll_pipeline_min_bytes, or with coll_pipeline_enable
    off, no call enters the tiers; an alltoall the size does not
    divide raises on every member, as the single dispatch does."""
    def fn(comm):
        o0 = pipeline.pv_ops.read()
        comm.allreduce_arr(torch.ones(100), port_op.SUM)
        comm.Barrier()
        return pipeline.pv_ops.read() - o0

    with knobs(PLAN_ON):
        assert port_run_ranks(2, fn, device_map=lambda r: CPU) == [0, 0]

        def bad(comm):
            with pytest.raises(RuntimeError, match="not divisible"):
                comm.alltoall_arr(torch.ones(1025))
            return True

        assert port_run_ranks(2, bad, device_map=lambda r: CPU) \
            == [True, True]

"""The hierarchical allreduce tier (coll/pipeline ``hier``) through both
packages: the same rank programs, the same numpy inputs (made from a
seed), compared.

The reference runs under jax on the CPU with one rank a virtual device
(``run_ranks(8, fn, devices=True)``); the port runs with one rank a
logical CPU device (``device_map=logical_devices("cpu")``), where the
kernels' wrappers take their plain versions and the leader hop stages
through ``aligned_empty``'s numpy buffers.  The knobs are those of
tests/test_coll_pipeline.py's ``test_hierarchical_allreduce``, set in
both registries: slices of 4 ranks, everything from 1 KiB on takes the
tier, 4 KiB segments.

Tolerance: byte for byte for int32 SUM, float32 MAX and float32 SUM of
small integers (exactly representable sums); random float32 SUM within
|port - ref| <= 4 * n * 2**-24 * sum(|x_i|) (tests/test_torch_mesh.py):
the reference's intra-slice psum and the port's K6 may add in
different orders.  Within the port every rank gets the same bytes.

Pinned divergence: the port's leader hop stages explicitly (one D2H
into a pinned stage, the host allreduce into a second pinned stage,
one H2D); the reference hands a jax array to its host module.  The
bytes are the reference's; on a card a stage that cannot be pinned
raises, and the host module still refuses card tensors.
"""

import jax
import numpy as np
import pytest
import torch

import ompi_tpu.coll.pipeline as ref_pipeline
from ompi_tpu.coll import tuned as ref_tuned
from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu.obs import health as ref_health
from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu.topo import topo as ref_topo
from ompi_tpu_torch import convert
from ompi_tpu_torch.coll import autotune, device, pipeline, tuned
from ompi_tpu_torch.mca.params import registry as port_registry
from ompi_tpu_torch.obs import health as port_health
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.runtime import staging
from ompi_tpu_torch.testing import logical_devices
from ompi_tpu_torch.testing import run_ranks as port_run_ranks
from ompi_tpu_torch.topo import topo as port_topo

CPU = torch.device("cpu")
SEED = 20261018
# tests/test_coll_pipeline.py:213-216
HIER = {"coll_pipeline_enable": True, "coll_hier_enable": True,
        "coll_hier_slice_size": 4, "coll_hier_min_bytes": 1024,
        "coll_pipeline_min_bytes": 2048, "coll_seg_size": 4096}


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


class degraded:
    """Hold host ``node``'s bit in both packages' degraded masks (the
    health plane's leader-reroute gate); clear both on exit."""

    def __init__(self, node: int) -> None:
        self.mask = 1 << node

    def __enter__(self):
        ref_health.set_degraded_mask(self.mask)
        port_health.set_degraded_mask(self.mask)

    def __exit__(self, *exc):
        ref_health.set_degraded_mask(0)
        port_health.set_degraded_mask(0)


def _np(x):
    if isinstance(x, torch.Tensor):
        return convert.to_numpy(x)
    return np.asarray(x)


def both(n, fn, port_map=None, ref_map=None):
    """fn(comm, put, op_module, pkg) through the port (one logical CPU
    device a rank, or ``port_map``) and the reference (one virtual
    device a rank, or ``ref_map``); returns (port results, reference
    results)."""
    port = port_run_ranks(
        n, lambda c: fn(c, lambda a: convert.to_torch(a, c.device),
                        port_op, "port"),
        device_map=port_map or logical_devices("cpu"))
    ref = ref_run_ranks(
        n, lambda c: fn(c, lambda a: jax.device_put(a, c.device), ref_op,
                        "ref"),
        devices=ref_map is None, device_map=ref_map)
    return port, ref


PV = {"port": pipeline.pv_hier, "ref": ref_pipeline.pv_hier}
ELIGIBLE = {"port": pipeline.hier_eligible, "ref": ref_pipeline.hier_eligible}


def _hier_op(xs, opname):
    """fn for ``both``: one allreduce of this rank's input, its bytes,
    and the tier's pvar move (every member has added once a barrier
    after the op: no rank adds before every rank has entered)."""
    def fn(comm, put, op, pkg):
        h0 = PV[pkg].read()
        out = comm.allreduce_arr(put(xs[comm.rank]), getattr(op, opname[4:]))
        comm.Barrier()
        return _np(out).tobytes(), PV[pkg].read() - h0
    return fn


def _inputs(n, length, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return [rng.standard_normal(length).astype(np.float32)
                for _ in range(n)]
    if kind == "exact":  # small integers: every partial sum exact in f32
        return [rng.integers(-50, 50, length).astype(np.float32)
                for _ in range(n)]
    return [rng.integers(-1000, 1000, length).astype(np.int32)
            for _ in range(n)]


CASES = [("f32_sum_random", "random", "MPI_SUM"),
         ("f32_sum_exact", "exact", "MPI_SUM"),
         ("i32_sum", "int", "MPI_SUM"),
         ("f32_max", "random", "MPI_MAX")]


@pytest.mark.parametrize("length", [3001, 1 << 18], ids=["ragged", "2^18"])
@pytest.mark.parametrize("name,kind,opname", CASES,
                         ids=[c[0] for c in CASES])
def test_hier_allreduce_matches_reference(name, kind, opname, length):
    """8 ranks in 2 slices of 4: the tier engages on every rank in both
    packages (coll_hier_ops moves by exactly 8 an op, one a rank), every
    port rank gets the same bytes, and they are the reference's — byte
    for byte but for random float SUM, which is within the band."""
    n = 8
    xs = _inputs(n, length, kind, SEED + length + len(name))
    with knobs(HIER):
        port, ref = both(n, _hier_op(xs, opname))
    assert [d for _, d in port] == [n] * n
    assert [d for _, d in ref] == [n] * n
    assert len({b for b, _ in port}) == 1
    dtype = xs[0].dtype
    p = np.frombuffer(port[0][0], dtype)
    r = np.frombuffer(ref[0][0], dtype)
    assert p.shape == (length,)
    if kind == "random" and opname == "MPI_SUM":
        absum = np.sum([np.abs(x.astype(np.float64)) for x in xs], 0)
        tol = 4 * n * 2.0 ** -24 * absum
        assert (np.abs(p.astype(np.float64) - r) <= tol).all()
    else:
        assert port[0][0] == ref[0][0]
        assert len({b for b, _ in ref}) == 1


NOT_ELIGIBLE = {
    # ranks sharing one device: an hbm comm never takes the tier
    "hbm": (8, 4, lambda r: CPU, lambda r: jax.devices()[0]),
    "three_ranks": (3, 1, None, None),
    "one_slice": (8, 8, None, None),
    "one_rank_slices": (8, 1, None, None),
}


@pytest.mark.parametrize("case", sorted(NOT_ELIGIBLE))
def test_hier_not_eligible(case):
    """With the tier's knobs on, neither package takes it on an hbm
    comm, on a comm of fewer than 4 ranks, on one slice, or on slices of
    one rank: hier_eligible is False, coll_hier_ops does not move, and
    the result is the reference's byte for byte."""
    n, slice_size, port_map, ref_map = NOT_ELIGIBLE[case]
    xs = _inputs(n, 3001, "int", SEED + n + slice_size)
    op_fn = _hier_op(xs, "MPI_SUM")

    def fn(comm, put, op, pkg):
        return op_fn(comm, put, op, pkg), ELIGIBLE[pkg](comm)

    with knobs(dict(HIER, coll_hier_slice_size=slice_size)):
        port, ref = both(n, fn, port_map, ref_map)
    for res in (port, ref):
        assert [(d, ok) for (_, d), ok in res] == [(0, False)] * n
    assert [b for (b, _), _ in port] == [b for (b, _), _ in ref]


@pytest.mark.parametrize("layout", ["blocks", "interleaved"])
def test_slice_groups_auto_from_modex(layout):
    """``coll_hier_slice_size`` 0: each rank publishes its node id in
    the modex, ``slice_groups`` derives the same groups in both
    packages, and the tier runs on them with the reference's bytes."""
    n = 8
    node = (lambda r: r // 4) if layout == "blocks" else (lambda r: r % 2)
    xs = _inputs(n, 3001, "int", SEED + 7)
    op_fn = _hier_op(xs, "MPI_SUM")
    topo = {"port": port_topo, "ref": ref_topo}

    def fn(comm, put, op, pkg):
        comm.state.rte.modex_put("node_id", node(comm.rank))
        comm.Barrier()
        groups = topo[pkg].slice_groups(comm, 0)
        return groups, op_fn(comm, put, op, pkg)

    with knobs(dict(HIER, coll_hier_slice_size=0)):
        port, ref = both(n, fn)
    want = [[r for r in range(n) if node(r) == k] for k in range(2)]
    assert [g for g, _ in port] == [g for g, _ in ref] == [want] * n
    assert [res for _, res in port] == [res for _, res in ref]
    assert [d for _, (_, d) in port] == [n] * n


def test_leader_reroute_off_degraded_node():
    """Ranks 0 and 1 live on node 0, which the health plane holds
    degraded: their split keys sort past every healthy rank's, so slice
    0's leader is rank 2 in both packages (slice 1's stays rank 4), and
    the result is the one of a healthy fleet."""
    n = 8
    xs = _inputs(n, 3001, "int", SEED + 11)
    op_fn = _hier_op(xs, "MPI_SUM")
    plan = {"port": pipeline._hier_plan, "ref": ref_pipeline._hier_plan}

    def fn(comm, put, op, pkg):
        comm.state.rte.node_id = comm.rank // 2
        res = op_fn(comm, put, op, pkg)
        intra, lead = plan[pkg](comm)
        return (intra.group[0], lead is not None), res[0]

    with knobs(HIER):
        healthy_port, healthy_ref = both(n, fn)
        with degraded(0):
            port, ref = both(n, fn)
    assert [p for p, _ in port] == [p for p, _ in ref]
    assert [p for p, _ in port] == [(2, r == 2) if r < 4 else (4, r == 4)
                                    for r in range(n)]
    assert [p for p, _ in healthy_port] == [(0, r == 0) if r < 4
                                            else (4, r == 4)
                                            for r in range(n)]
    assert [b for _, b in port] == [b for _, b in healthy_port] == \
        [b for _, b in ref] == [b for _, b in healthy_ref]


TRACE = {"trace_enable": 1, "trace_phase_enable": 1,
         "trace_sample_auto": 0}
HOP = ("ph_hop_d2h", "ph_hop_host", "ph_hop_h2d")


def hop_spans(comm):
    """This rank's leader-hop spans, oldest first: (name, args)."""
    return [(e["name"], e["args"]) for e in comm.state.tracer.snapshot()
            if e["name"] in HOP]


def test_leader_hop_stages_through_aligned_empty_on_the_cpu(monkeypatch):
    """On the CPU the hop's two stages are ``aligned_empty``'s numpy
    buffers (64-byte aligned, the payload's bytes).  Under phase
    tracing each leader records one D2H, one host allreduce and one H2D
    span an op, in that order, with the payload's bytes and no pinned
    stage; the other ranks stage nothing and record no hop span."""
    n, length = 8, 3001
    xs = _inputs(n, length, "int", SEED + 13)
    stages = []
    empty = staging.aligned_empty

    def aligned_empty(nbytes, device="cpu"):
        stage = empty(nbytes, device)
        stages.append(stage)
        return stage

    monkeypatch.setattr(staging, "aligned_empty", aligned_empty)

    def fn(comm):
        x = convert.to_torch(xs[comm.rank], comm.device)
        out = _np(comm.allreduce_arr(x, port_op.SUM)).tobytes()
        return out, hop_spans(comm)

    saved = {k: port_registry.get(k) for k in TRACE}
    try:
        for k, v in TRACE.items():
            port_registry.set(k, v)
        with knobs(HIER):
            res = port_run_ranks(n, fn, device_map=logical_devices("cpu"))
    finally:
        for k, v in saved.items():
            port_registry.set(k, v)
    assert len({o for o, _ in res}) == 1
    want = [(name, dict(cid=0, nbytes=length * 4,
                        **({} if name == "ph_hop_host" else {"pinned": 0})))
            for name in HOP]
    for r, (_, spans) in enumerate(res):
        assert [(nm, dict(a, cid=0)) for nm, a in spans] == \
            (want if r in (0, 4) else []), r
    assert len(stages) == 4
    for stage in stages:
        assert isinstance(stage, np.ndarray)
        assert stage.ctypes.data % staging.STAGE_ALIGN == 0
        assert stage.nbytes == length * 4


def test_leader_hop_without_a_pinned_allocator_raises():
    """A card's stage is pinned or the hop raises: with no pinned
    allocator (this CPU-only build, a meta tensor standing in for a
    card's) ``_leader_hop`` raises before any leader meets, and nothing
    falls back to a pageable copy; the host module still refuses the
    tensor itself."""
    y = torch.ones(1024, device="meta")
    with pytest.raises(RuntimeError):
        pipeline._leader_hop(None, y, port_op.SUM)
    with pytest.raises(NotImplementedError, match="does not stage"):
        device._host_arr_fallback()._np(y)


def test_host_module_allreduce_into_matches_allreduce_arr():
    """``HostArrModule.allreduce_into`` (the hop's host step, numpy in
    and out) gives ``allreduce_arr``'s bytes on host buffers."""
    n = 4
    xs = _inputs(n, 3001, "int", SEED + 19)

    def fn(comm):
        fb = device._host_arr_fallback()
        a = xs[comm.rank].reshape(-1)
        r = np.empty_like(a)
        fb.allreduce_into(comm, a, r, port_op.SUM)
        return r.tobytes(), fb.allreduce_arr(comm, a, port_op.SUM).tobytes()

    res = port_run_ranks(n, fn)
    assert len({b for pair in res for b in pair}) == 1


def test_device_algorithm_pick_matches_reference():
    """``device_algorithm``'s per-kind (seg_min, hier_min) pair and its
    pick — hier first for an allreduce at or above coll_hier_min_bytes
    on an eligible comm, the segmented picks below it — equal the
    reference's at every size; the autotune window's thresholds carry
    the same pair."""
    n = 8
    sizes = [512, 1024, 2048, 4096, 1 << 20]
    tun = {"port": tuned, "ref": ref_tuned}

    def fn(comm, put, op, pkg):
        picks = [(kind, nb, tun[pkg].device_algorithm(comm, kind, nb,
                                                      "MPI_SUM"))
                 for kind in ("allreduce", "bcast", "alltoall")
                 for nb in sizes]
        tbl = {k: v for k, v in comm.__dict__["_pipeline_pick"].items()}
        return picks, tbl

    with knobs(dict(HIER, coll_hier_min_bytes=4096)):
        port, ref = both(n, fn)
    assert port == ref
    picks = dict(((k, nb), a) for k, nb, a in port[0][0])
    assert picks[("allreduce", 4096)] == "hier"
    assert picks[("allreduce", 2048)] == "segrd"
    assert port[0][1]["allreduce"] == (2048, 4096)
    with knobs(HIER):
        tbl = autotune.Autotuner._compute_thresholds(
            type("C", (), {"size": n})(), 0)
    assert tbl == {"__win": 0, "allreduce": (2048, 1024),
                   "bcast": (2048, 1024), "alltoall": (2048, 1024)}

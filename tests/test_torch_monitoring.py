"""pml/monitoring through the port (ompi_tpu_torch/pml/monitoring.py:
the interposed ``MonitoringPml``, its traffic matrix and pvars,
``dump``, ``profile2mat``, the finalize-time dump and aggregation, and
``count_offload``, which counts every deposit into a device meeting),
with the reference beside it.

The analogs of tests/test_mpit.py's monitoring tests that need no
``mpit`` (``counts_traffic``, ``dump``, ``disabled_no_wrap``,
``anytag_irecv_counts_as_user``); the ones that read the counters
through ``mpit`` handles are in tests/test_torch_mpit.py.  Each
program runs through both packages on the same numpy inputs made from
a seed, and the matrix rows are compared: byte for byte for
point-to-point traffic, and for the device collectives on the routes
both packages take (the hbm route, every rank on one device, and the
mesh route, one device a rank).  Tolerance: exact counts.

A thread world's host collectives meet in coll/sm in both packages
and count one offloaded message to every other member
(``test_host_barrier_counts_one_offload_a_member``).

Pinned divergences, each with the test named after it:
  * the finalize-time dump also writes the internal traffic's
    matrices (``{path}_filtered_*.mat``), where the reference writes
    the user traffic's only
    (``test_divergence_finalize_dumps_filtered_matrices``);
  * a segmented mesh bcast / alltoall deposits (operand, output)
    pairs, which count 0 bytes as a tuple value does in the reference,
    where the reference deposits its segment arrays
    (``test_divergence_mesh_segment_pairs_count_zero_bytes``).
"""

import jax
import numpy as np
import pytest
import torch

from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu.op import op as ref_op
from ompi_tpu.pml import monitoring as ref_mon
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import convert
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.pml import monitoring as mon
from ompi_tpu_torch.testing import logical_devices
from ompi_tpu_torch.testing import run_ranks as port_run_ranks

SEED = 20261018
CPU = torch.device("cpu")


def _set(name, value):
    registry.set(name, value)
    ref_registry.set(name, value)


@pytest.fixture
def monitoring():
    _set("pml_monitoring_enable", True)
    yield
    _set("pml_monitoring_enable", False)


def both(n, fn, route=None):
    """fn(comm, put, op) through the port and the reference; ``route``
    None: host worlds; "hbm": every rank on one device; "mesh": one
    device a rank.  Returns (port results, reference results)."""
    if route is None:
        return (port_run_ranks(n, lambda c: fn(c, None, port_op)),
                ref_run_ranks(n, lambda c: fn(c, None, ref_op)))
    pput = lambda c: (lambda a: convert.to_torch(a, c.device))  # noqa
    rput = lambda c: (lambda a: jax.device_put(a, c.device))  # noqa
    if route == "hbm":
        port = port_run_ranks(n, lambda c: fn(c, pput(c), port_op),
                              device_map=lambda r: CPU)
        ref = ref_run_ranks(n, lambda c: fn(c, rput(c), ref_op),
                            device_map=lambda r: jax.devices()[0])
    else:
        port = port_run_ranks(n, lambda c: fn(c, pput(c), port_op),
                              device_map=logical_devices("cpu"))
        ref = ref_run_ranks(n, lambda c: fn(c, rput(c), ref_op),
                            devices=True)
    return port, ref


def test_monitoring_counts_traffic(monitoring):
    x = np.random.default_rng(SEED).standard_normal(64)

    def fn(comm, put, op):
        r = np.empty_like(x)
        if comm.rank == 0:
            comm.Send(x, dest=1, tag=5)
        elif comm.rank == 1:
            comm.Recv(r, source=0, tag=5)
        comm.Barrier()
        return comm.state.pml.matrix_rows()

    port, ref = both(2, fn)
    for rows in (port, ref):
        # rank 0 sent one user message of 512 bytes to peer 1
        assert rows[0]["sent_msgs"][1] == 1
        assert rows[0]["sent_bytes"][1] == 512
        # barrier traffic is internal (tag < 0): filtered
        assert rows[0]["sent_filtered_msgs"][1] >= 1
        # rank 1 received the user payload
        assert rows[1]["recv_bytes"][0] >= 512
        # user and internal streams kept separate
        assert rows[0]["sent_msgs"][0] == 0
    # user traffic: the same rows in both packages
    for key in ("sent_msgs", "sent_bytes", "recv_msgs", "recv_bytes"):
        assert [r[key] for r in port] == [r[key] for r in ref], key


def test_monitoring_dump(monitoring, tmp_path):
    def fn(comm, put, op):
        if comm.rank == 0:
            comm.Send(np.zeros(8, dtype=np.int64), dest=1, tag=0)
        else:
            comm.Recv(np.empty(8, dtype=np.int64), source=0, tag=0)
        path = str(tmp_path / f"{type(op).__module__}.prof.{comm.rank}")
        comm.state.pml.dump(path)
        return path

    port, ref = both(2, fn)
    assert open(port[0]).read() == open(ref[0]).read() == "0 1 1 64\n"
    assert open(port[1]).read() == open(ref[1]).read() == ""


def test_monitoring_disabled_no_wrap():
    def fn(comm, put, op):
        return hasattr(comm.state.pml, "matrix_rows")

    assert both(2, fn) == ([False, False], [False, False])


def test_monitoring_anytag_irecv_counts_as_user(monitoring):
    def fn(comm, put, op):
        if comm.rank == 0:
            comm.Send(np.zeros(16, dtype=np.float64), dest=1, tag=9)
            return None
        r = np.empty(16, dtype=np.float64)
        comm.Irecv(r, source=0).wait()   # default tag = ANY_TAG
        return comm.state.pml.matrix_rows()

    port, ref = both(2, fn)
    assert port[1] == ref[1]
    assert port[1]["recv_bytes"][0] == 128   # user, not filtered


def test_monitoring_p2p_rows_match_reference(monitoring):
    """A seeded pattern of blocking, nonblocking and persistent sends among 4 ranks: every row of every rank equal."""
    rng = np.random.default_rng(SEED)
    plan = [(int(rng.integers(4)), int(rng.integers(4)),
             int(rng.integers(1, 600)), int(rng.integers(3)))
            for _ in range(24)]
    plan = [(s, d, n, k) for s, d, n, k in plan if s != d]

    def fn(comm, put, op):
        for i, (s, d, n, kind) in enumerate(plan):
            if comm.rank == s:
                x = np.arange(n, dtype=np.float32)
                if kind == 0:
                    comm.Send(x, dest=d, tag=i)
                elif kind == 1:
                    comm.Isend(x, dest=d, tag=i).wait()
                else:
                    req = comm.Send_init(x, dest=d, tag=i)
                    req.start()
                    req.wait()
            elif comm.rank == d:
                comm.Recv(np.empty(n, dtype=np.float32), source=s, tag=i)
        rows = comm.state.pml.matrix_rows()
        return {k: v for k, v in rows.items() if "filtered" not in k}

    port, ref = both(4, fn)
    assert port == ref


def test_profile2mat_matches_reference(tmp_path):
    """The same seeded .prof files through both packages' profile2mat:
    the three matrices, returned and written, are identical."""
    rng = np.random.default_rng(SEED)
    n = 5
    for pkg in ("port", "ref"):
        for src in range(n):
            with open(tmp_path / f"{pkg}.{src}.prof", "w") as fh:
                for dst in range(n):
                    if dst != src and rng.random() < 0.7:
                        m = int(rng.integers(1, 50))
                        fh.write(f"{src} {dst} {m} "
                                 f"{m * int(rng.integers(1, 4096))}\n")
        rng = np.random.default_rng(SEED)  # same files for both
    got = mon.profile2mat(str(tmp_path / "port"))
    want = ref_mon.profile2mat(str(tmp_path / "ref"))
    assert got == want
    for suffix in ("_msg", "_size", "_avg"):
        assert (tmp_path / f"port{suffix}.mat").read_text() == \
            (tmp_path / f"ref{suffix}.mat").read_text()


def test_monitoring_finalize_dump_and_aggregate(monitoring, tmp_path):
    """With ``pml_monitoring_dump_path`` set, each rank writes its
    .prof before finalize's fence and rank 0 aggregates the three
    matrices after it: the same files from both packages."""
    def fn(comm, put, op):
        right = (comm.rank + 1) % comm.size
        left = (comm.rank - 1) % comm.size
        req = comm.Irecv(np.empty(100 + left, np.int16), left, 1)
        comm.Send(np.zeros(100 + comm.rank, np.int16), right, 1)
        req.wait()
        return True

    paths = {}
    for pkg, run in (("port", port_run_ranks), ("ref", ref_run_ranks)):
        paths[pkg] = str(tmp_path / pkg)
        _set("pml_monitoring_dump_path", paths[pkg])
        try:
            assert all(run(3, lambda c: fn(c, None, None)))
        finally:
            _set("pml_monitoring_dump_path", "")
    for suffix in ("_msg.mat", "_size.mat", "_avg.mat"):
        got = open(paths["port"] + suffix).read()
        assert got == open(paths["ref"] + suffix).read(), suffix
    assert open(paths["port"] + "_size.mat").read().split("\n")[0] == \
        "0 200 0"


COLLS = ("allreduce", "allgather", "bcast", "reduce_scatter", "alltoall")


def _coll_program(nelem, which):
    """One device collective of ``nelem`` float32 a rank (seeded
    values); returns the sent rows it added on each rank."""
    xs = [np.random.default_rng(SEED + r).standard_normal(nelem)
          .astype(np.float32) for r in range(8)]

    def fn(comm, put, op):
        n = comm.size
        x = put(xs[comm.rank])
        before = comm.state.pml.matrix_rows()
        if which == "allreduce":
            comm.allreduce_arr(x, op.SUM)
        elif which == "allgather":
            comm.allgather_arr(x)
        elif which == "bcast":
            comm.bcast_arr(x, 0)
        elif which == "reduce_scatter":
            comm.reduce_scatter_arr(put(xs[comm.rank].reshape(n, -1)),
                                    op.SUM)
        else:
            comm.alltoall_arr(put(xs[comm.rank].reshape(n, -1)))
        after = comm.state.pml.matrix_rows()
        return {k: [b - a for a, b in zip(before[k], after[k])]
                for k in after}
    return fn


@pytest.mark.parametrize("route", ["hbm", "mesh"])
@pytest.mark.parametrize("which", COLLS)
def test_count_offload_matches_reference(monitoring, route, which):
    """Each device collective on 4 ranks: every rank counts one
    internal message of its deposit's bytes to each other member, the
    same rows as the reference's, and nothing of it is user traffic."""
    nelem = 1 << 12
    port, ref = both(4, _coll_program(nelem, which), route)
    assert port == ref
    for r, rows in enumerate(port):
        assert rows["sent_filtered_msgs"] == [0 if p == r else 1
                                              for p in range(4)]
        assert rows["sent_filtered_bytes"] == [0 if p == r else 4 * nelem
                                               for p in range(4)]
        assert rows["sent_msgs"] == rows["sent_bytes"] == [0] * 4


def test_count_offload_costs_nothing_when_off():
    """Monitoring off: the pml is ob1 itself and a device collective
    leaves no matrix anywhere (count_offload returns at its isinstance
    check)."""
    def fn(comm, put, op):
        comm.allreduce_arr(put(np.ones(64, np.float32)), op.SUM)
        return type(comm.state.pml).__name__

    port, ref = both(2, fn, "hbm")
    assert port == ["PmlOb1", "PmlOb1"]


def test_host_barrier_counts_one_offload_a_member(monitoring):
    """Barrier on a 4-rank thread world meets in coll/sm in both
    packages: one 0-byte offloaded message to every other member."""
    def fn(comm, put, op):
        before = comm.state.pml.matrix_rows()
        comm.Barrier()
        after = comm.state.pml.matrix_rows()
        return {k: [b - a for a, b in zip(before[k], after[k])]
                for k in ("sent_filtered_msgs", "sent_filtered_bytes")}

    port, ref = both(4, fn, "hbm")
    assert port == ref == [
        {"sent_filtered_msgs": [0 if p == r else 1 for p in range(4)],
         "sent_filtered_bytes": [0] * 4} for r in range(4)]


@pytest.mark.parametrize("which", ["bcast", "alltoall"])
def test_divergence_mesh_segment_pairs_count_zero_bytes(monitoring, which):
    """With the segment knobs scaled down, a mesh bcast / alltoall of
    64 KiB a rank runs as 8 segment meetings in both packages: the
    messages agree, the bytes do not (the port's deposits are (operand,
    output) pairs)."""
    nelem = 1 << 14
    saved = {k: registry.get(k) for k in ("coll_pipeline_min_bytes",
                                          "coll_seg_size")}
    _set("coll_pipeline_min_bytes", 16384)
    _set("coll_seg_size", 8192)
    try:
        port, ref = both(4, _coll_program(nelem, which), "mesh")
    finally:
        for k, v in saved.items():
            _set(k, v)
    for r in range(4):
        others = [p for p in range(4) if p != r]
        assert [port[r]["sent_filtered_msgs"][p] for p in others] == \
            [ref[r]["sent_filtered_msgs"][p] for p in others] == [8] * 3
        assert [ref[r]["sent_filtered_bytes"][p] for p in others] == \
            [4 * nelem] * 3
        assert port[r]["sent_filtered_bytes"] == [0] * 4


def test_divergence_finalize_dumps_filtered_matrices(monitoring, tmp_path):
    """3 ranks on one device, 4 allreduce_arr of 1024 float32: the
    port's finalize writes {path}_filtered_*.mat holding the offloaded
    bytes (4 x 4096 to every peer); the reference writes none."""
    for pkg in ("port", "ref"):
        _set("pml_monitoring_dump_path", str(tmp_path / pkg))
        try:
            if pkg == "port":
                port_run_ranks(3, lambda c: [c.allreduce_arr(
                    torch.ones(1024), port_op.SUM) for _ in range(4)],
                    device_map=lambda r: CPU)
            else:
                ref_run_ranks(3, lambda c: [c.allreduce_arr(
                    jax.device_put(np.ones(1024, np.float32), c.device),
                    ref_op.SUM) for _ in range(4)],
                    device_map=lambda r: jax.devices()[0])
        finally:
            _set("pml_monitoring_dump_path", "")
    assert (tmp_path / "ref_size.mat").exists()
    assert not (tmp_path / "ref_filtered_size.mat").exists()
    assert (tmp_path / "port_size.mat").read_text() == \
        (tmp_path / "ref_size.mat").read_text()
    assert (tmp_path / "port_filtered_size.mat").read_text() == \
        "0 16384 16384\n16384 0 16384\n16384 16384 0\n"
    assert (tmp_path / "port_filtered_msg.mat").read_text() == \
        "0 4 4\n4 0 4\n4 4 0\n"

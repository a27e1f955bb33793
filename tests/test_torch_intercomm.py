"""Intercommunicators and dynamic process management through the port
(ompi_tpu_torch/comm/intercomm.py, coll/inter.py, comm/dpm.py and
mpirun's spawn event), with the reference beside it.

The analogs of tests/test_intercomm.py's 14 tests.  The thread-world
programs run through both packages on the same inputs (each rank's
values are its rank, as in the reference's tests, or numpy draws from
a seed) and their results are compared exactly: an intercomm moves
and reduces host buffers, so every result is byte for byte the
reference's.  The jobs (connect/accept, spawn, the spawn loop, join)
run under the port's mpirun and print the reference programs' lines.
Further: gather, scatter and reduce_scatter_block across the bridge,
the merged communicator's ``allreduce_arr`` on the CPU device path,
and a ``*_arr`` call on an intercomm, which raises in both packages.
"""

import os
import types

import numpy as np
import pytest
import torch

from ompi_tpu.comm import intercomm as ref_inter
from ompi_tpu.comm.communicator import UNDEFINED as REF_UNDEFINED
from ompi_tpu.datatype import engine as ref_dt
from ompi_tpu.op import op as ref_op
from ompi_tpu.pml.request import PROC_NULL as REF_PROC_NULL
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch.comm import intercomm as port_inter
from ompi_tpu_torch.comm.communicator import UNDEFINED as PORT_UNDEFINED
from ompi_tpu_torch.datatype import engine as port_dt
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.pml.request import PROC_NULL as PORT_PROC_NULL
from ompi_tpu_torch.testing import mpirun_run
from ompi_tpu_torch.testing import run_ranks as port_run_ranks

SEED = 20261018
CPU = torch.device("cpu")
EXAMPLES = os.path.join("ompi_tpu_torch", "examples")

PORT = types.SimpleNamespace(
    name="port", inter=port_inter, op=port_op, dt=port_dt,
    PROC_NULL=PORT_PROC_NULL, UNDEFINED=PORT_UNDEFINED,
    run_ranks=port_run_ranks)
REF = types.SimpleNamespace(
    name="ref", inter=ref_inter, op=ref_op, dt=ref_dt,
    PROC_NULL=REF_PROC_NULL, UNDEFINED=REF_UNDEFINED,
    run_ranks=ref_run_ranks)


def both(n, fn):
    """fn(comm, pkg) on n thread-ranks of each package; asserts the
    two packages' results equal and returns the port's."""
    port = PORT.run_ranks(n, lambda c: fn(c, PORT))
    ref = REF.run_ranks(n, lambda c: fn(c, REF))
    assert _plain(port) == _plain(ref)
    return port


def _plain(x):
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.tolist())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def _mk_inter(comm, half, pkg, tag=9):
    """Split world into [0,half) and [half,n); bridge leaders 0 and
    half over comm."""
    low = comm.rank < half
    local = comm.split(0 if low else 1)
    inter = pkg.inter.intercomm_create(local, 0, comm,
                                       half if low else 0, tag=tag)
    return inter, local, low


def test_create_sizes_and_groups():
    def fn(comm, pkg):
        inter, local, low = _mk_inter(comm, 2, pkg)
        assert inter.is_inter and not comm.is_inter
        assert inter.size == local.size
        assert inter.remote_size == comm.size - local.size
        assert inter.mesh() is None
        locals_ = inter.local_group_obj().ranks
        remotes = inter.remote_group_obj().ranks
        assert sorted(locals_ + remotes) == list(range(comm.size))
        return inter.rank, inter.size, inter.remote_size, locals_, remotes

    both(5, fn)


def test_p2p_across_bridge():
    def fn(comm, pkg):
        inter, local, low = _mk_inter(comm, 3, pkg)
        pml = comm.state.pml
        got = None
        if local.rank < min(inter.size, inter.remote_size):
            x = np.array([comm.rank], dtype=np.int64)
            y = np.empty(1, dtype=np.int64)
            s = pml.isend(x, 1, pkg.dt.INT64_T, local.rank, -60, inter)
            pml.recv(y, 1, pkg.dt.INT64_T, local.rank, -60, inter)
            s.wait()
            got = int(y[0])
            assert got == (comm.rank + 3 if low else comm.rank - 3)
        inter.Barrier()
        return got

    both(6, fn)


def test_rooted_bcast_and_reduce():
    def fn(comm, pkg):
        ROOT = pkg.inter.ROOT
        inter, local, low = _mk_inter(comm, 2, pkg)
        # bcast: global rank 0 (low leader) -> high group
        buf = np.array([7.5 if comm.rank == 0 else 0.0])
        if low:
            inter.Bcast(buf,
                        root=ROOT if comm.rank == 0 else pkg.PROC_NULL)
        else:
            inter.Bcast(buf, root=0)
            assert buf[0] == 7.5
        # reduce: high group's data lands at low leader
        s = np.array([float(comm.rank)])
        r = np.zeros(1)
        if low:
            inter.Reduce(s, r, pkg.op.SUM,
                         root=ROOT if comm.rank == 0 else pkg.PROC_NULL)
            if comm.rank == 0:
                assert r[0] == sum(range(2, comm.size))
        else:
            inter.Reduce(s, None, pkg.op.SUM, root=0)
        return buf, r

    both(5, fn)


def test_allreduce_exchanges_groups():
    def fn(comm, pkg):
        inter, local, low = _mk_inter(comm, 3, pkg)
        s = np.array([float(comm.rank + 1)])
        r = np.empty(1)
        inter.Allreduce(s, r, pkg.op.SUM)
        low_sum = sum(range(1, 4))
        high_sum = sum(range(4, comm.size + 1))
        assert r[0] == (high_sum if low else low_sum)
        # a seeded int32 vector under a non-commutative-safe op
        x = np.random.default_rng(SEED + comm.rank).integers(
            -1000, 1000, 64).astype(np.int32)
        y = np.empty_like(x)
        inter.Allreduce(x, y, pkg.op.MAX)
        return r, y

    both(6, fn)


def test_allgather_and_alltoall():
    def fn(comm, pkg):
        inter, local, low = _mk_inter(comm, 2, pkg)
        rs = inter.remote_size
        s = np.array([float(comm.rank)], dtype=np.float64)
        r = np.empty(rs, dtype=np.float64)
        inter.Allgather(s, r)
        remote = inter.remote_group_obj().ranks
        assert list(r) == [float(g) for g in remote]
        # alltoall: block i goes to remote rank i
        sb = np.array([comm.rank * 10.0 + i for i in range(rs)])
        rb = np.empty(rs)
        inter.Alltoall(sb, rb)
        for i, g in enumerate(remote):
            assert rb[i] == g * 10.0 + local.rank
        return r, rb

    both(4, fn)


def test_gather_scatter_reduce_scatter_block():
    """coll/inter's other rooted and reducing collectives: gather to
    and scatter from the low leader (ROOT / PROC_NULL on its side),
    called on the module as the communicator's rooted methods address
    an intracomm root, and reduce_scatter_block of the other group's
    seeded vectors."""
    def fn(comm, pkg):
        ROOT = pkg.inter.ROOT
        I64 = pkg.dt.INT64_T
        inter, local, low = _mk_inter(comm, 2, pkg)
        rs = inter.remote_size
        root = (ROOT if comm.rank == 0 else pkg.PROC_NULL) if low else 0
        g = np.zeros(rs, np.int64)
        mine = np.array([comm.rank * 3], np.int64)
        inter.coll.gather(inter, mine, 1, I64, g, 1, I64, root)
        sc = np.arange(rs, dtype=np.int64) + 100
        out = np.full(1, -1, np.int64)
        inter.coll.scatter(inter, sc, 1, I64, out, 1, I64, root)
        if not low:
            assert out[0] == 100 + local.rank
        x = np.random.default_rng(SEED + comm.rank).integers(
            0, 50, 2 * local.size).astype(np.int64)
        y = np.empty(2, np.int64)
        inter.Reduce_scatter_block(x, y, pkg.op.SUM)
        return g, out, y

    # reduce_scatter_block's leaders exchange equal-sized reductions:
    # groups of one size
    both(4, fn)


def test_merge_orders_low_first():
    def fn(comm, pkg):
        inter, local, low = _mk_inter(comm, 2, pkg)
        merged = inter.merge(high=not low)
        assert merged.size == comm.size
        assert merged.rank == comm.rank
        assert not merged.is_inter
        r = np.empty(1)
        merged.Allreduce(np.array([1.0]), r, pkg.op.SUM)
        assert r[0] == comm.size
        return merged.rank, merged.group, r

    both(4, fn)


def test_merged_comm_device_path_and_arr_on_intercomm_raises():
    """The merged comm is an ordinary comm: its ``allreduce_arr`` takes
    the hbm route among thread-ranks (K1's plain version on the CPU)
    with a fresh rendezvous and sequence counter; a ``*_arr`` call on
    the intercomm itself raises, as the reference's does."""
    n = 1 << 10

    def fn(comm):
        from ompi_tpu_torch.coll import device
        inter, local, low = _mk_inter(comm, 2, PORT)
        try:
            inter.allreduce_arr(torch.ones(4), port_op.SUM)
            raised = None
        except AttributeError as e:
            raised = type(e).__name__
        merged = inter.merge(high=not low)
        assert merged._dev_seq == 0 and \
            "_device_rv" not in merged.__dict__
        x = torch.as_tensor(np.random.default_rng(SEED + comm.rank)
                            .integers(0, 1000, n).astype(np.float32))
        y = merged.allreduce_arr(x, port_op.SUM)
        assert merged.__dict__["_device_rv"] is not \
            comm.__dict__.get("_device_rv")
        assert isinstance(merged.coll.providers, dict) and \
            merged.coll.providers["allreduce_arr"] == "hbm"
        assert device._get_rendezvous(merged).size == comm.size
        return raised, y.numpy()

    res = port_run_ranks(4, fn, device_map=lambda r: CPU)

    def ref_fn(comm):
        inter, local, low = _mk_inter(comm, 2, REF)
        try:
            inter.allreduce_arr(np.ones(4, np.float32), ref_op.SUM)
        except AttributeError as e:
            return type(e).__name__
        return None

    ref = REF.run_ranks(4, ref_fn)
    want = sum(np.random.default_rng(SEED + r).integers(0, 1000, n)
               .astype(np.float32) for r in range(4))
    for raised, y in res:
        np.testing.assert_array_equal(y, want)  # small integers: exact
    assert [r for r, _ in res] == ref == ["AttributeError"] * 4


def test_icreate_wire_tag_block_isolated():
    """The intercomm_create wire tag lives in a dedicated negative
    block — never colliding with the small internal tags,
    create_group's [-400,-1399], nbc's <=-2000, or non-negative user
    tag space, for ANY user tag — and equals the reference's."""
    for tag in (0, 5, 7, 8, 17, 25, 26, 400, 999, 2**20):
        wt = port_inter._icreate_wire_tag(tag)
        assert -1999 <= wt <= -1500
        assert wt == ref_inter._icreate_wire_tag(tag)


def test_create_with_colliding_user_tags():
    """User tags that collide with internal protocol tags (5 ->
    TAG_GATHER, 7 -> TAG_SPLIT, 8 -> TAG_CID) must work."""
    def fn(comm, pkg):
        low = comm.rank < 2
        local = comm.split(0 if low else 1)
        sizes = []
        for tag in (5, 7, 8, 30):
            inter = pkg.inter.intercomm_create(local, 0, comm,
                                               2 if low else 0, tag=tag)
            assert inter.remote_size == comm.size - local.size
            sizes.append(inter.remote_size)
            inter.free()
        local.free()
        return sizes

    both(4, fn)


def test_intercomm_split_pairs_colors_across_sides():
    """MPI_Comm_split on an intercommunicator: same color on both
    sides pairs up; one-sided colors get COMM_NULL (MPI-3.1 §6.4.2)."""
    def fn(comm, pkg):
        inter, local, low = _mk_inter(comm, 3, pkg)
        # colors: local side {0: ranks 0,1; 1: rank 2};
        # remote side (3 ranks) {0: ranks 0,1; 7: rank 2}
        color = 0 if local.rank < 2 else (1 if low else 7)
        sub = inter.split(color, key=local.rank)
        if color != 0:
            assert sub is None  # one-sided colors -> COMM_NULL
            return None
        assert sub is not None and sub.is_inter
        assert sub.size == 2 and sub.remote_size == 2
        pml = comm.state.pml
        x = np.array([comm.rank], dtype=np.int64)
        y = np.empty(1, dtype=np.int64)
        s = pml.isend(x, 1, pkg.dt.INT64_T, sub.rank, -61, sub)
        pml.recv(y, 1, pkg.dt.INT64_T, sub.rank, -61, sub)
        s.wait()
        assert int(y[0]) == (comm.rank + 3 if low else comm.rank - 3)
        return sub.rank, sub.group, int(y[0])

    both(6, fn)


def test_intercomm_split_undefined_returns_null():
    def fn(comm, pkg):
        inter, local, low = _mk_inter(comm, 2, pkg)
        if local.rank == 0:
            sub = inter.split(0, key=0)
            assert sub is not None
            assert sub.size == 1 and sub.remote_size == 1
            return sub.group
        assert inter.split(pkg.UNDEFINED) is None
        return None

    both(4, fn)


def _job(np_, prog, *args, timeout=60):
    r = mpirun_run(np_, os.path.join(EXAMPLES, prog), *args,
                   timeout=timeout + 30, job_timeout=timeout)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return r.stdout.decode()


def test_connect_accept_same_job():
    """Two halves of one job rendezvous through a named port, twice
    on the same port (the second pair gets another bridge cid)."""
    assert _job(4, "connect_accept_prog.py").count("ok") == 4


def test_spawn_under_mpirun():
    """spawn_parent.py's lines, and with ``--device cpu`` the merged
    comm's staged ``allreduce_arr`` on every rank of both jobs, each
    digest equal to the numpy sum of the four inputs."""
    out = _job(3, "spawn_parent.py")
    assert out.count("merged size 5") == 3
    assert "worker 1: merged rank 4/5" in out
    out = _job(2, "spawn_parent.py", "--device", "cpu")
    assert out.count("merged size 4 total 204.0") == 2
    assert "worker 1: merged rank 3/4" in out
    import hashlib
    i = np.arange(1 << 18, dtype=np.int64)
    want = sum(((i * 2654435761 + r * 97) % 1000003).astype(np.float32)
               for r in range(4))
    sha = hashlib.sha256(want.astype(np.float32).tobytes()).hexdigest()
    cards = sorted(ln for ln in out.splitlines() if ln.startswith("CARD"))
    assert cards == [f"CARD rank={r} device=cpu {sha}" for r in range(4)]


def test_spawn_loop_under_mpirun():
    """Repeated spawns extend the universe each time (loop_spawn.c
    analog, small loop)."""
    assert "loop-spawn done 3 rounds" in _job(2, "loop_spawn_prog.py",
                                              timeout=90)


def test_comm_join_over_socket():
    """MPI_Comm_join builds a 1-1 intercomm from a raw connected
    socket (ref: ompi/mpi/c/comm_join.c)."""
    assert "join ok" in _job(2, "join_prog.py")


@pytest.mark.parametrize("call", ["open_port", "publish_lookup",
                                  "get_parent"])
def test_package_dpm_calls_no_longer_raise(call):
    """The package's get_parent, open_port, publish_name and
    lookup_name: in a world with no launcher, open_port gives a port
    name, get_parent None, and the name service needs the launcher's
    KV server (as in the reference)."""
    import ompi_tpu
    import ompi_tpu_torch

    def fn(pkg, comm):
        if call == "open_port":
            return pkg.open_port().startswith("tpumpi-port-0-")
        if call == "get_parent":
            return pkg.get_parent()
        try:
            pkg.publish_name("svc", "p")
        except RuntimeError as e:
            return "launcher" in str(e)
        return False

    # mpi_init makes each rank-thread's state its current one
    got = [run(1, lambda comm, pkg=pkg: fn(pkg, comm))
           for pkg, run in ((ompi_tpu_torch, port_run_ranks),
                            (ompi_tpu, ref_run_ranks))]
    assert got[0] == got[1] == [None if call == "get_parent" else True]

"""The flat MPI_* surface through both packages: ompi_tpu.mpi and its
port, ompi_tpu_torch.mpi — Pack/Unpack (native and external32), CYCLIC
darray, idup/create_group, Sendrecv_replace, the v-variant
i-collectives, alltoallw, dynamic and shared windows,
dist_graph_create, generalized requests, test_any/test_some, the error
class registry, handle conversion, the f90 type helpers, get_elements,
type envelopes, the w-variant nonblocking collectives,
Register_datarep, the cart reorder by device order, and the flat
ring / collectives / window programs with their PMPI aliases.

The analogs of tests/test_mpi_surface.py's 24 tests and
tests/test_persistent.py's three ``test_flat_mpi_*`` tests.  Each test
body runs once through each package (ids ``port`` and ``ref``) on the
same inputs — the reference's fixed values, or numpy draws from a
seed — and both are held to the same expected values.  Host buffers
throughout; the reorder test runs the port on logical CPU devices (the
mesh tier's analog of the reference's 8 virtual CPU devices).  Port
only: ompi_tpu_torch.testing.flat's rank programs (the card's phase
18) on CPU rank-threads, and ``import ompi_tpu_torch.mpi`` loading no
torch.

Tolerance: exact (bytes) — every payload is an integer or a float that
travels unchanged, and every SUM is of small integers.
"""

import importlib
import os
import tempfile
import types

import numpy as np
import pytest

SEED = 20261018


def _pkg(name):
    def imp(sub):
        return importlib.import_module(f"{name}.{sub}")

    return types.SimpleNamespace(
        name=name, imp=imp, mpi=imp("mpi"), dt=imp("datatype.engine"),
        Convertor=imp("datatype.convertor").Convertor,
        op=imp("op.op"), run_ranks=imp("testing").run_ranks)


@pytest.fixture(params=["port", "ref"])
def pkg(request):
    return _pkg("ompi_tpu_torch" if request.param == "port"
                else "ompi_tpu")


# ---- pack/unpack ----------------------------------------------------

def test_pack_unpack_roundtrip(pkg):
    mpi = pkg.mpi
    src = np.random.default_rng(SEED).standard_normal(10)
    out = np.zeros(200, dtype=np.uint8)
    pos = mpi.MPI_Pack(src, 10, mpi.MPI_DOUBLE, out, 200, 0)
    assert pos == 80 == mpi.MPI_Pack_size(10, mpi.MPI_DOUBLE)
    ints = np.array([7, 8, 9], dtype=np.int32)
    pos2 = mpi.MPI_Pack(ints, 3, mpi.MPI_INT32_T, out, 200, pos)
    assert out[:80].tobytes() == src.tobytes()
    assert out[80:92].tobytes() == ints.tobytes()
    d_out = np.zeros(10, dtype=np.float64)
    i_out = np.zeros(3, dtype=np.int32)
    p = mpi.MPI_Unpack(out, 200, 0, d_out, 10, mpi.MPI_DOUBLE)
    p = mpi.MPI_Unpack(out, 200, p, i_out, 3, mpi.MPI_INT32_T)
    assert p == pos2 == 92
    assert d_out.tobytes() == src.tobytes() and (i_out == ints).all()


def test_pack_overflow_rejected(pkg):
    mpi = pkg.mpi
    src = np.arange(8, dtype=np.float64)
    out = np.zeros(16, dtype=np.uint8)
    with pytest.raises(mpi.MPIException):
        mpi.MPI_Pack(src, 8, mpi.MPI_DOUBLE, out, 16, 0)


def test_pack_derived_type(pkg):
    mpi, dt = pkg.mpi, pkg.dt
    vec = dt.vector(3, 1, 2, dt.INT32_T)  # every other int
    src = np.arange(6, dtype=np.int32)
    out = np.zeros(64, dtype=np.uint8)
    pos = mpi.MPI_Pack(src, 1, vec, out, 64, 0)
    assert pos == 12
    assert out[:12].view(np.int32).tolist() == [0, 2, 4]
    back = np.zeros(6, dtype=np.int32)
    mpi.MPI_Unpack(out, 64, 0, back, 1, vec)
    assert back.tolist() == [0, 0, 2, 0, 4, 0]


def test_pack_external32_big_endian(pkg):
    mpi = pkg.mpi
    src = np.array([1, -2], dtype=np.int32)
    out = np.zeros(8, dtype=np.uint8)
    mpi.MPI_Pack_external("external32", src, 2, mpi.MPI_INT32_T,
                          out, 8, 0)
    assert out.tolist() == [0, 0, 0, 1, 255, 255, 255, 254]
    back = np.zeros(2, dtype=np.int32)
    mpi.MPI_Unpack_external("external32", out, 8, 0, back, 2,
                            mpi.MPI_INT32_T)
    assert back.tolist() == [1, -2]


# ---- darray CYCLIC --------------------------------------------------

def test_darray_cyclic(pkg):
    dt, Convertor = pkg.dt, pkg.Convertor
    a = np.arange(10, dtype=np.int32)
    t0 = dt.darray(2, 0, [10], [dt.DISTRIBUTE_CYCLIC], [2], [2],
                   dt.ORDER_C, dt.INT32_T)
    got = np.frombuffer(Convertor(t0, 1, a).pack(), dtype=np.int32)
    assert got.tolist() == [0, 1, 4, 5, 8, 9]
    # the four ranks of a 2x2 cyclic(1) grid tile 4x4 exactly once
    g = np.arange(16, dtype=np.int32)
    per_rank = []
    for r in range(4):
        tr = dt.darray(4, r, [4, 4], [dt.DISTRIBUTE_CYCLIC] * 2,
                       [dt.DISTRIBUTE_DFLT_DARG] * 2, [2, 2],
                       dt.ORDER_C, dt.INT32_T)
        per_rank.append(np.frombuffer(Convertor(tr, 1, g).pack(),
                                      dtype=np.int32).tolist())
    assert per_rank[0] == [0, 2, 8, 10]
    assert sorted(sum(per_rank, [])) == list(range(16))


# ---- communicator extras --------------------------------------------

def test_idup_and_create_group(pkg):
    Group = pkg.imp("comm.communicator").Group

    def fn(comm):
        d, req = comm.idup()
        req.wait()
        assert d.size == comm.size and d.cid != comm.cid
        evens = Group([g for i, g in enumerate(comm.group)
                       if i % 2 == 0])
        if comm.rank % 2 == 0:
            sub = comm.create_group(evens, tag=3)
            r = np.empty(1)
            sub.Allreduce(np.array([comm.rank + 1.0]), r, pkg.op.SUM)
            return (sub.size, float(r[0]))
        # odd ranks do NOT call create_group at all
        return None

    assert pkg.run_ranks(5, fn) == [(3, 9.0), None, (3, 9.0), None,
                                    (3, 9.0)]


def test_sendrecv_replace_ring(pkg):
    vals = np.random.default_rng(SEED).standard_normal(4)

    def fn(comm):
        buf = vals[comm.rank:comm.rank + 1].copy()
        comm.Sendrecv_replace(buf, (comm.rank + 1) % comm.size, 5,
                              (comm.rank - 1) % comm.size, 5)
        return buf.tobytes()

    assert pkg.run_ranks(4, fn) == [vals[(r - 1) % 4:(r - 1) % 4 + 1]
                                    .tobytes() for r in range(4)]


def test_cart_reorder_by_device_order(pkg):
    """reorder=True orders cart ranks by device (treematch analog with
    the device order as the distance metric): the reference on 4 of
    its virtual CPU devices, the port on 4 logical CPU devices."""
    if pkg.name == "ompi_tpu":
        def key(comm):
            return comm.device.id
        kw = {"devices": True}
    else:
        from ompi_tpu_torch.runtime.init import device_key
        from ompi_tpu_torch.testing import logical_devices

        def key(comm):
            return device_key(comm.state)
        # ranks on the slots in reverse, so the reorder has work to do
        dmap = logical_devices("cpu")
        kw = {"device_map": lambda r: dmap(3 - r)}

    def fn(comm):
        cart = comm.Create_cart([comm.size], [True], reorder=True)
        return (cart.rank, key(comm))

    res = pkg.run_ranks(4, fn, **kw)
    by_dev = sorted(range(4), key=lambda r: res[r][1])
    assert [res[r][0] for r in by_dev] == [0, 1, 2, 3]


# ---- v-variant i-collectives + alltoallw ----------------------------

def test_igatherv_iscatterv(pkg):
    def fn(comm):
        n = comm.size
        rcounts = [i + 1 for i in range(n)]
        displs = [sum(rcounts[:i]) for i in range(n)]
        sarr = np.full(comm.rank + 1, float(comm.rank), dtype=np.float64)
        gathered = None
        if comm.rank == 0:
            rbuf = np.zeros(sum(rcounts), dtype=np.float64)
            comm.Igatherv(sarr, rbuf, rcounts, displs, root=0).wait()
            gathered = rbuf.tolist()
        else:
            comm.Igatherv(sarr, None, rcounts, displs, root=0).wait()
        rbuf2 = np.zeros(comm.rank + 1, dtype=np.float64)
        if comm.rank == 0:
            sbuf = np.concatenate([np.full(i + 1, 10.0 + i)
                                   for i in range(n)])
            comm.Iscatterv(sbuf, rcounts, displs, rbuf2, root=0).wait()
        else:
            comm.Iscatterv(None, rcounts, displs, rbuf2, root=0).wait()
        return gathered, rbuf2.tolist()

    res = pkg.run_ranks(4, fn)
    assert res[0][0] == [0.0, 1.0, 1.0, 2.0, 2.0, 2.0, 3.0, 3.0, 3.0, 3.0]
    assert [r[1] for r in res] == [[10.0 + r] * (r + 1) for r in range(4)]


def test_alltoallw_mixed_types(pkg):
    mpi = pkg.mpi

    def fn(comm):
        n = comm.size
        # one float64 to each peer, addressed by byte displacements
        sbuf = np.array([comm.rank * 10.0 + p for p in range(n)])
        rbuf = np.zeros(n, dtype=np.float64)
        counts = [1] * n
        displs = [8 * p for p in range(n)]
        types_ = [mpi.MPI_DOUBLE] * n
        mpi.MPI_Alltoallw(sbuf, counts, displs, types_, rbuf, counts,
                          displs, types_, comm)
        return rbuf.tolist()

    assert pkg.run_ranks(3, fn) == [[p * 10.0 + r for p in range(3)]
                                    for r in range(3)]


# ---- windows: dynamic + shared --------------------------------------

def test_dynamic_window_attach_put(pkg):
    mpi, oscmod = pkg.mpi, pkg.imp("osc.window")

    def fn(comm):
        win = oscmod.create_dynamic(comm)
        region = np.zeros(4, dtype=np.int64)
        win.attach(region)
        addr = mpi.MPI_Get_address(region)
        addrs = np.zeros(comm.size, dtype=np.int64)
        comm.Allgather(np.array([addr], dtype=np.int64), addrs)
        win.lock_all()
        right = (comm.rank + 1) % comm.size
        win.put(np.array([comm.rank + 1], dtype=np.int64), right,
                disp=int(addrs[right]))
        win.flush_all()
        comm.Barrier()
        got = region.tolist()
        win.unlock_all()
        win.detach(region)
        win.free()
        return got

    assert pkg.run_ranks(3, fn) == [[(r - 1) % 3 + 1, 0, 0, 0]
                                    for r in range(3)]


def test_shared_window_direct_store(pkg):
    oscmod = pkg.imp("osc.window")

    def fn(comm):
        win = oscmod.allocate_shared(comm, 8)
        win.memory.view(np.int64)[0] = comm.rank + 100
        comm.Barrier()
        # direct load of a PEER's segment, no RMA call at all
        n, du, peer_seg = oscmod.shared_query(
            win, (comm.rank + 1) % comm.size)
        got = (n, int(peer_seg.view(np.int64)[0]))
        comm.Barrier()
        win.free()
        return got

    assert pkg.run_ranks(3, fn) == [(8, (r + 1) % 3 + 100)
                                    for r in range(3)]


# ---- dist_graph_create general form ---------------------------------

def test_dist_graph_create_general(pkg):
    dist_graph_create = pkg.imp("topo.topo").dist_graph_create

    def fn(comm):
        # rank 0 declares the whole ring; everyone else declares none
        if comm.rank == 0:
            sources = list(range(comm.size))
            degrees = [1] * comm.size
            dests = [(s + 1) % comm.size for s in range(comm.size)]
        else:
            sources, degrees, dests = [], [], []
        g = dist_graph_create(comm, sources, degrees, dests)
        return (g.topo.out_neighbors(g.rank), g.topo.in_neighbors(g.rank))

    assert pkg.run_ranks(4, fn) == [([(r + 1) % 4], [(r - 1) % 4])
                                    for r in range(4)]


# ---- requests + misc -------------------------------------------------

def test_grequest_lifecycle(pkg):
    mpi = pkg.mpi

    def fn(comm):
        log = []
        req = mpi.MPI_Grequest_start(
            query_fn=lambda extra, st: log.append(("q", extra)),
            free_fn=lambda extra: log.append(("f", extra)),
            extra_state="xs")
        before = req.complete
        mpi.MPI_Grequest_complete(req)
        after = req.complete
        req.free()
        return before, after, log

    assert pkg.run_ranks(1, fn) == [(False, True, [("q", "xs"),
                                                   ("f", "xs")])]


def test_testany_testsome_and_get_status(pkg):
    mpi, request = pkg.mpi, pkg.imp("pml.request")

    def fn(comm):
        if comm.rank == 0:
            reqs = [comm.Irecv(np.zeros(1), 1, t) for t in (1, 2)]
            empty = request.test_any([])
            comm.Send(np.zeros(0), 1, 9)  # release peer
            while len(request.test_some(reqs)) != 2:
                comm.state.progress.progress()
            flag, st = mpi.MPI_Request_get_status(reqs[0])
            return empty, flag, st.tag, st.source
        comm.Recv(np.zeros(0), 0, 9)
        comm.Send(np.ones(1), 0, 1)
        comm.Send(np.ones(1), 0, 2)
        return None

    assert pkg.run_ranks(2, fn) == [((-1, None), True, 1, 1), None]


def test_reduce_local_and_op_bindings(pkg):
    mpi = pkg.mpi
    a = np.array([1.0, 5.0])
    b = np.array([4.0, 2.0])
    mpi.MPI_Reduce_local(a, b, 2, mpi.MPI_DOUBLE, mpi.MPI_MAX)
    assert b.tolist() == [4.0, 5.0]
    x = np.array([3, 12], dtype=np.int32)
    y = np.array([5, 10], dtype=np.int32)
    mpi.MPI_Reduce_local(x, y, 2, mpi.MPI_INT32_T, mpi.MPI_BAND)
    assert y.tolist() == [1, 8]
    myop = mpi.MPI_Op_create(lambda u, v: u + v * 2, commute=False)
    assert not mpi.MPI_Op_commutative(myop)
    assert mpi.MPI_Op_commutative(mpi.MPI_SUM)


def test_error_class_registry(pkg):
    mpi = pkg.mpi
    c = mpi.MPI_Add_error_class()
    assert c > mpi.MPI_ERR_LASTCODE
    assert mpi.MPI_Error_string(c) == f"user error class {c}"
    mpi.MPI_Add_error_string(c, "my custom failure")
    assert mpi.MPI_Error_string(c) == "my custom failure"
    code = mpi.MPI_Add_error_code(c)
    assert code == c + 1
    assert mpi.MPI_Error_string(code) == "my custom failure"


def test_handle_conversion_roundtrip(pkg):
    mpi = pkg.mpi
    inf = mpi.MPI_Info_create()
    h = mpi.MPI_Info_c2f(inf)
    assert mpi.MPI_Info_f2c(h) is inf
    assert mpi.MPI_Info_c2f(inf) == h  # stable
    with pytest.raises(ValueError):
        mpi.MPI_Comm_f2c(999999)


def test_f90_and_match_size(pkg):
    mpi = pkg.mpi
    assert mpi.MPI_Type_match_size(mpi.MPI_TYPECLASS_REAL, 8) \
        is mpi.MPI_DOUBLE
    assert mpi.MPI_Type_create_f90_real(6, 30) is mpi.MPI_FLOAT
    assert mpi.MPI_Type_create_f90_integer(15) is mpi.MPI_INT64_T


def test_get_elements_partial(pkg):
    mpi, dt = pkg.mpi, pkg.dt
    st = pkg.imp("pml.request").Status()
    pair = dt.contiguous(2, dt.INT32_T)
    got = []
    for count in (10, 16, 4):
        st.count = count
        got.append(mpi.MPI_Get_elements(st, pair))
    assert got == [2, 4, 1]


def test_type_envelope_contents(pkg):
    mpi, dt = pkg.mpi, pkg.dt
    v = dt.vector(3, 2, 4, dt.INT32_T)
    comb, ints, addrs, dts = mpi.MPI_Type_get_envelope(v)
    assert comb == "VECTOR"
    assert mpi.MPI_Type_get_envelope(dt.INT32_T)[0] == \
        mpi.MPI_COMBINER_NAMED
    with pytest.raises(ValueError):
        mpi.MPI_Type_get_contents(dt.INT32_T)


def test_version_and_misc(pkg):
    mpi = pkg.mpi
    assert mpi.MPI_Get_version() == (3, 1)
    assert "ompi_tpu" in mpi.MPI_Get_library_version()
    assert mpi.MPI_Wtick() > 0
    assert mpi.MPI_Aint_add(100, 8) == 108
    mem = mpi.MPI_Alloc_mem(64)
    assert mem.nbytes == 64
    mpi.MPI_Free_mem(mem)


def test_ialltoallw_and_ineighbor_alltoallw(pkg):
    mpi = pkg.mpi

    def fn(comm):
        n = comm.size
        sbuf = np.array([comm.rank * 10.0 + p for p in range(n)])
        rbuf = np.zeros(n, dtype=np.float64)
        counts = [1] * n
        displs = [8 * p for p in range(n)]
        types_ = [mpi.MPI_DOUBLE] * n
        mpi.MPI_Ialltoallw(sbuf, counts, displs, types_, rbuf,
                           counts, displs, types_, comm).wait()
        # ring cart: one double to each of left/right
        cart = comm.Create_cart([n], periods=[True])
        nbrs = cart.topo.in_neighbors(cart.rank)
        k = len(nbrs)
        s2 = np.array([cart.rank + 100.0 * i for i in range(k)])
        r2 = np.zeros(k, dtype=np.float64)
        cnt = [1] * k
        dsp = [8 * i for i in range(k)]
        tps = [mpi.MPI_DOUBLE] * k
        mpi.MPI_Ineighbor_alltoallw(s2, cnt, dsp, tps, r2, cnt, dsp,
                                    tps, cart).wait()
        # each neighbor sent us the slot addressed to us in its
        # out-neighbor order
        want = [src + 100.0 * cart.topo.out_neighbors(src).index(
            cart.rank) for src in nbrs]
        return rbuf.tolist(), r2.tolist(), want

    for r, (a2a, got, want) in enumerate(pkg.run_ranks(4, fn)):
        assert a2a == [p * 10.0 + r for p in range(4)]
        assert got == want


def test_register_datarep_roundtrip(pkg):
    """MPI_Register_datarep: user representation applied on the file
    byte path; duplicate names rejected; the bytes on disk are the
    converted ones."""
    mpi, iof = pkg.mpi, pkg.imp("io.file")
    x = np.random.default_rng(SEED).standard_normal(8)

    def fn(comm):
        def enc(raw, dt, count, extra):
            return bytes(b ^ extra for b in raw)

        name = f"xor_rep_{pkg.name}_{comm.state.rank}"
        mpi.MPI_Register_datarep(name, read_conversion_fn=enc,
                                 write_conversion_fn=enc,
                                 extra_state=0x5A)
        with pytest.raises(ValueError):
            mpi.MPI_Register_datarep(name)
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "f.dat")
            self_comm = comm.Split(comm.rank)  # per-rank file
            fh = iof.open(self_comm, path,
                          iof.MODE_CREATE | iof.MODE_RDWR)
            fh.set_view(0, datarep=name)
            fh.write_at(0, x)
            got = np.zeros_like(x)
            fh.read_at(0, got)
            fh.close()
            disk = np.fromfile(path, dtype=np.uint8)
        return got.tobytes(), disk.tobytes()

    for got, disk in pkg.run_ranks(2, fn):
        assert got == x.tobytes()
        assert (np.frombuffer(disk, np.uint8) ^ 0x5A).tobytes() \
            == x.tobytes()


# ---- the flat ring / collectives / window programs ------------------

def test_flat_mpi_ring(pkg):
    MPI = pkg.mpi

    def fn(comm):
        rank = MPI.MPI_Comm_rank(comm)
        size = MPI.MPI_Comm_size(comm)
        token = np.array([rank * 1.0])
        if rank == 0:
            MPI.MPI_Send(token, 1, MPI.MPI_DOUBLE, 1 % size, 0, comm)
            st = MPI.MPI_Recv(token, 1, MPI.MPI_DOUBLE,
                              (size - 1) % size, 0, comm)
            return (float(token[0]), st.source)
        MPI.MPI_Recv(token, 1, MPI.MPI_DOUBLE, rank - 1, 0, comm)
        token[0] += 1
        MPI.MPI_Send(token, 1, MPI.MPI_DOUBLE, (rank + 1) % size, 0, comm)
        return float(token[0])

    assert pkg.run_ranks(4, fn) == [(3.0, 3), 1.0, 2.0, 3.0]


def test_flat_mpi_collectives_and_pmpi(pkg):
    MPI = pkg.mpi
    # PMPI aliases exist and are the same callables
    assert MPI.PMPI_Allreduce is MPI.MPI_Allreduce
    assert MPI.PMPI_Send is MPI.MPI_Send
    xs = np.random.default_rng(SEED).integers(-1000, 1000, (4, 8))

    def fn(comm):
        x = xs[comm.rank].astype(np.float64)
        r = np.empty(8)
        MPI.MPI_Allreduce(x, r, 8, MPI.MPI_DOUBLE, MPI.MPI_SUM, comm)
        m = np.empty(8, np.int64)
        MPI.PMPI_Allreduce(xs[comm.rank], m, 8, MPI.MPI_INT64_T,
                           MPI.MPI_MAX, comm)
        dims = MPI.MPI_Dims_create(comm.size, 2)
        cart = MPI.MPI_Cart_create(comm, 2, dims, [True, True])
        coords = MPI.MPI_Cart_coords(cart, cart.rank)
        return (r.tobytes(), m.tobytes(), tuple(dims), tuple(coords))

    res = pkg.run_ranks(4, fn)
    for rank, (total, mx, dims, coords) in enumerate(res):
        assert total == xs.sum(axis=0).astype(np.float64).tobytes()
        assert mx == xs.max(axis=0).tobytes()
        assert dims == (2, 2)
        assert coords == (rank // 2, rank % 2)


def test_flat_mpi_win(pkg):
    MPI = pkg.mpi

    def fn(comm):
        mem = np.zeros(4, dtype=np.int64)
        win = MPI.MPI_Win_create(mem, comm=comm)
        MPI.MPI_Win_fence(0, win)
        if comm.rank == 0:
            val = np.array([77], dtype=np.int64)
            MPI.MPI_Put(val, 1, MPI.MPI_INT64_T, 1, 2, 1,
                        MPI.MPI_INT64_T, win)
        MPI.MPI_Win_fence(0, win)
        out = mem.tolist()
        win.free()
        return out

    assert pkg.run_ranks(2, fn) == [[0, 0, 0, 0], [0, 0, 77, 0]]


# ---- the card's flat programs, on the CPU ---------------------------

def test_flat_card_programs_on_cpu():
    """ompi_tpu_torch.testing.flat's rank programs (chip_smoke.py's
    phase 18) on 8 CPU rank-threads, the tier knobs scaled so the
    32 KiB allreduce_arr takes the plan tier as 8 MiB does on the card:
    the copy function once a rank, the MPI_T deltas (8 plan builds,
    152 hits, 20 monitored deposits to each other rank), host
    (P)MPI_Allreduce equal to numpy; the memchecker's two catches; the
    user errhandler's one call a rank and the delete function at
    free.  Launches are the card's to count."""
    import torch

    from ompi_tpu_torch.mca.params import registry
    from ompi_tpu_torch.testing import flat, run_ranks
    cpu = torch.device("cpu")
    n, kib = 8192, 1 << 10
    knobs = {"coll_pipeline_min_bytes": 16 * kib, "coll_seg_size": 4 * kib,
             "coll_pipeline_rd_max_bytes": 32 * kib}
    saved = {k: registry.get(k) for k in (*knobs, "pml_monitoring_enable",
                                          "opal_memchecker_enable")}
    try:
        for k, v in knobs.items():
            registry.set(k, v)
        registry.set("pml_monitoring_enable", True)
        res = run_ranks(8, flat.headline(cpu, n, 20, (8, 32 * kib)),
                        device_map=lambda r: cpu)
        registry.set("pml_monitoring_enable", False)
        xs = [flat.values(r, n, cpu).double() for r in range(8)]
        for r, out in enumerate(res):
            other = [0 if p == r else 1 for p in range(8)]
            assert out["copies"] == [r] and out["attr"] == (True, r + 1)
            assert out["pvars"] == {
                "pml_monitoring_filtered_count": [20 * o for o in other],
                "pml_monitoring_filtered_size": [20 * 4 * n * o
                                                 for o in other],
                "coll_plan_builds": 8, "coll_plan_hits": 152}
            err = (out["y"].double() - sum(xs)).abs()
            assert bool((err <= 8 * 2.0 ** -24
                         * sum(x.abs() for x in xs)).all())
            for (a, b), nb in zip(out["host"], (8, 32 * kib)):
                assert a == b == flat.host_sum(8, nb)
        registry.set("opal_memchecker_enable", True)
        (err, sent), (kind, got, posted, done) = run_ranks(
            2, flat.memcheck(cpu, n, 1 << 20), device_map=lambda r: cpu)
        registry.set("opal_memchecker_enable", False)
        assert (kind, got) == ("cpu", sent)
        assert err.startswith("memchecker: send buffer of rendezvous ")
        assert (posted, done) == (b"\xcb", b"\x00")
        res = run_ranks(8, flat.errhandlers(cpu, n),
                        device_map=lambda r: cpu)
        assert [(c, d) for c, _, _, d in res] == [
            ([(True, 16)], [100 + r]) for r in range(8)]
    finally:
        for k, v in saved.items():
            registry.set(k, v)


def test_importing_the_flat_surface_imports_no_torch():
    """In a fresh interpreter ``import ompi_tpu_torch.mpi`` loads no
    torch (nor jax, nor the reference); the handles whose modules need
    torch resolve at first use, to the same objects."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "from ompi_tpu_torch import mpi as MPI\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'ompi_tpu')))\n"
            "from ompi_tpu_torch.coll.buffers import IN_PLACE\n"
            "from ompi_tpu_torch import io\n"
            "print(MPI.MPI_IN_PLACE is IN_PLACE, MPI.MPI_SEEK_SET == "
            "io.SEEK_SET, MPI.MPI_MODE_RDWR == io.MODE_RDWR, "
            "'MPI_MODE_CREATE' in dir(MPI))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=repo, timeout=120,
                         env=dict(os.environ, PYTHONPATH=repo))
    assert res.returncode == 0, res.stderr
    assert res.stdout.split("\n")[:2] == ["[]", "True True True True"]

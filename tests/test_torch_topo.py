"""Process topologies and neighbour collectives through both packages:
every case of tests/test_topo.py runs as the same rank program through
the reference (``ompi_tpu``) and the port (``ompi_tpu_torch``), and the
two give equal results (and the values the reference test expects).
The device cases (``shift_arr``) run the reference on the conftest's
virtual CPU devices and the port on both tiers: one rank a logical CPU
device (the mesh tier) and every rank co-located on the CPU (coll/hbm).

``neighbor_allgather_arr``, which the reference's tests never call, is
held byte for byte against the reference's own on 8 virtual CPU
devices: a 1-D periodic 8-ring, the 2x4 periodic grid and the 2x2x2
open grid (PROC_NULL blocks are zeros), in float32, int32 and float64,
on both tiers and on the host path.  The reference keeps x64 off, so
its float64 result is float32: the float64 inputs are float32 values,
and the port's float64 result is compared with the reference's cast up.
The port meets once a call (one K2 peer launch a member on the card)
where the reference holds one ppermute a (dim, direction): results
match, routes differ.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ompi_tpu.topo as ref_topo
import ompi_tpu_torch.topo as port_topo
from ompi_tpu.datatype import engine as ref_dt
from ompi_tpu.pml.request import PROC_NULL as REF_PROC_NULL
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import convert
from ompi_tpu_torch.datatype import engine as port_dt
from ompi_tpu_torch.kernels import stacked
from ompi_tpu_torch.pml.request import PROC_NULL
from ompi_tpu_torch.testing import logical_devices
from ompi_tpu_torch.testing import run_ranks as port_run_ranks
from ompi_tpu_torch.topo import topo as port_topo_mod

CPU = torch.device("cpu")
PORT_MAPS = {"mesh": logical_devices("cpu"), "hbm": lambda r: CPU,
             "host": None}

REF = types.SimpleNamespace(topo=ref_topo, dt=ref_dt, PROC_NULL=REF_PROC_NULL)
PORT = types.SimpleNamespace(topo=port_topo, dt=port_dt, PROC_NULL=PROC_NULL)


def _np(x):
    if isinstance(x, torch.Tensor):
        return convert.to_numpy(x)
    return np.asarray(x)


def _plain(v):
    """Results as plain Python / numpy, comparable across packages."""
    if isinstance(v, (list, tuple)):
        return [_plain(e) for e in v]
    if v is None or isinstance(v, (str, bool, int, float)):
        return v
    if isinstance(v, (np.integer, np.floating)):
        return v.item()
    return _np(v)


def _equal(a, b):
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


def both(n, fn):
    """fn(comm, pkg) through both packages on host-only worlds; the
    two results must be equal.  Returns the port's."""
    port = _plain(port_run_ranks(n, lambda c: fn(c, PORT)))
    ref = _plain(ref_run_ranks(n, lambda c: fn(c, REF)))
    _equal(port, ref)
    return port


def both_devices(n, fn, tier):
    """fn(comm, put): the reference with one virtual device a rank, the
    port on ``tier``; results equal.  Returns the port's."""
    port = _plain(port_run_ranks(
        n, lambda c: fn(c, lambda a: convert.to_torch(a, c.device)
                        if c.device is not None else np.asarray(a)),
        device_map=PORT_MAPS[tier]))
    ref = _plain(ref_run_ranks(
        n, lambda c: fn(c, lambda a: jax.device_put(jnp.asarray(a),
                                                    c.device)),
        devices=True))
    _equal(port, ref)
    return port


# -- dims_create and CartTopo (pure) ---------------------------------------

@pytest.mark.parametrize("n,nd,exp", [
    (6, 2, [3, 2]), (7, 2, [7, 1]), (8, 3, [2, 2, 2]), (12, 2, [4, 3]),
    (16, 2, [4, 4]), (60, 3, [5, 4, 3]), (1, 2, [1, 1]),
])
def test_dims_create(n, nd, exp):
    assert port_topo.dims_create(n, nd) == ref_topo.dims_create(n, nd) == exp


def test_dims_create_fixed():
    for pkg in (port_topo, ref_topo):
        assert pkg.dims_create(12, 2, [0, 4]) == [3, 4]
        assert pkg.dims_create(12, 3, [2, 0, 3]) == [2, 2, 3]
        with pytest.raises(ValueError):
            pkg.dims_create(10, 2, [4, 0])


def test_cart_coords_roundtrip():
    t = port_topo.CartTopo([3, 4], [True, False], 0)
    r = ref_topo.CartTopo([3, 4], [True, False], 0)
    for k in range(12):
        assert t.coords_to_rank(t.rank_to_coords(k)) == k
        assert t.rank_to_coords(k) == r.rank_to_coords(k)
    assert t.rank_to_coords(7) == [1, 3]
    assert t.coords_to_rank([2, 1]) == 9
    with pytest.raises(ValueError):
        t.rank_to_coords(12)


def test_cart_shift_periodic_vs_edge():
    for pkg, null in ((port_topo, PROC_NULL), (ref_topo, REF_PROC_NULL)):
        t = pkg.CartTopo([4], [False], 0)
        assert t.shift(0, 1, 0) == (null, 1)
        assert t.shift(0, 1, 3) == (2, null)
        tp = pkg.CartTopo([4], [True], 0)
        assert tp.shift(0, 1, 0) == (3, 1)
        assert tp.shift(0, 1, 3) == (2, 0)
        assert tp.shift(0, 2, 1) == (3, 3)


def test_cart_neighbors_order():
    for pkg in (port_topo, ref_topo):
        t = pkg.CartTopo([2, 2], [True, True], 0)
        assert t.neighbors(0) == [2, 2, 1, 1]


@pytest.mark.parametrize("dims,periods", [
    ([8], [True]), ([2, 4], [True, True]), ([2, 2, 2], [False] * 3),
    ([3, 2], [False, True]), ([1, 4], [True, False])])
def test_shift_perm_and_neighbors_match_reference(dims, periods):
    n = int(np.prod(dims))
    t = port_topo.CartTopo(dims, periods, 0)
    r = ref_topo.CartTopo(dims, periods, 0)
    for d in range(len(dims)):
        for disp in (1, -1, 2):
            assert t.shift_perm(d, disp, n) == r.shift_perm(d, disp, n)
    for k in range(n):
        assert t.neighbors(k) == r.neighbors(k)


# -- communicator-attached topologies --------------------------------------

def test_cart_create_and_queries():
    def fn(comm, pkg):
        cart = comm.Create_cart([2, 2], periods=[True, False])
        assert cart.Topo_test() == pkg.topo.CART
        dims, periods, coords = cart.Get_topo()
        assert dims == [2, 2] and periods == [True, False]
        assert cart.Get_cart_rank(coords) == cart.rank
        src, dst = cart.Shift(0, 1)
        return (cart.rank, coords, src, dst)

    for rank, coords, src, dst in both(4, fn):
        assert coords == [rank // 2, rank % 2]
        assert src == (rank + 2) % 4 and dst == (rank + 2) % 4


def test_cart_create_excess_ranks_get_null():
    def fn(comm, pkg):
        cart = comm.Create_cart([2], periods=[True])
        return None if cart is None else cart.size

    res = both(3, fn)
    assert res.count(None) == 1 and res.count(2) == 2


def test_cart_sub_splits_grid():
    def fn(comm, pkg):
        cart = comm.Create_cart([2, 3])
        row = cart.Sub([False, True])   # keep dim 1 → rows of 3
        col = cart.Sub([True, False])   # keep dim 0 → cols of 2
        return (cart.rank, row.size, row.rank, col.size, col.rank,
                row.Get_topo(), col.Get_topo())

    for rank, rsize, rrank, csize, crank, rt, ct in both(6, fn):
        assert rsize == 3 and rrank == rank % 3
        assert csize == 2 and crank == rank // 3
        assert rt[0] == [3] and ct[0] == [2]


def test_topo_test_undefined_without_topo():
    def fn(comm, pkg):
        return comm.Topo_test()

    assert both(2, fn) == [port_topo.UNDEFINED_TOPO] * 2


# -- neighbor collectives (host buffers) -------------------------------------

def test_neighbor_allgather_ring():
    def fn(comm, pkg):
        cart = comm.Create_cart([4], periods=[True])
        s = np.array([cart.rank * 10], dtype=np.int64)
        r = np.zeros(2, dtype=np.int64)
        cart.Neighbor_allgather(s, r)
        return list(r)

    for rank, r in enumerate(both(4, fn)):
        assert r == [((rank - 1) % 4) * 10, ((rank + 1) % 4) * 10]


def test_neighbor_allgather_nonperiodic_edges():
    def fn(comm, pkg):
        cart = comm.Create_cart([3], periods=[False])
        s = np.array([cart.rank + 1], dtype=np.int64)
        r = np.full(2, -1, dtype=np.int64)
        cart.Neighbor_allgather(s, r)
        return list(r)

    assert both(3, fn) == [[-1, 2], [1, 3], [2, -1]]


def test_neighbor_alltoall_ring_directional():
    def fn(comm, pkg):
        cart = comm.Create_cart([4], periods=[True])
        s = np.array([cart.rank * 100, cart.rank * 100 + 1],
                     dtype=np.int64)
        r = np.zeros(2, dtype=np.int64)
        cart.Neighbor_alltoall(s, r)
        return list(r)

    for rank, r in enumerate(both(4, fn)):
        left, right = (rank - 1) % 4, (rank + 1) % 4
        assert r == [left * 100 + 1, right * 100]


def test_neighbor_alltoall_two_rank_periodic_duplicate_neighbors():
    def fn(comm, pkg):
        cart = comm.Create_cart([2], periods=[True])
        s = np.array([cart.rank * 10, cart.rank * 10 + 1], dtype=np.int64)
        r = np.zeros(2, dtype=np.int64)
        cart.Neighbor_alltoall(s, r)
        return list(r)

    assert both(2, fn) == [[10, 11], [0, 1]]


def test_neighbor_alltoall_2d_grid():
    def fn(comm, pkg):
        cart = comm.Create_cart([2, 2], periods=[True, True])
        nbrs = cart.topo.neighbors(cart.rank)
        s = np.array([cart.rank * 10 + j for j in range(4)],
                     dtype=np.int64)
        r = np.zeros(4, dtype=np.int64)
        cart.Neighbor_alltoall(s, r)
        return (nbrs, list(r))

    for rank, (nbrs, r) in enumerate(both(4, fn)):
        for i, src in enumerate(nbrs):
            assert r[i] == src * 10 + i


def test_neighbor_allgatherv():
    def fn(comm, pkg):
        cart = comm.Create_cart([3], periods=[True])
        s = np.full(cart.rank + 1, cart.rank, dtype=np.int64)
        left, right = (cart.rank - 1) % 3, (cart.rank + 1) % 3
        rcounts = [left + 1, right + 1]
        displs = [0, left + 1]
        r = np.full(sum(rcounts), -1, dtype=np.int64)
        cart.Neighbor_allgatherv(s, r, rcounts, displs)
        return (list(r), rcounts)

    for rank, (r, rc) in enumerate(both(3, fn)):
        left, right = (rank - 1) % 3, (rank + 1) % 3
        assert r[:rc[0]] == [left] * (left + 1)
        assert r[rc[0]:] == [right] * (right + 1)


def test_neighbor_alltoallv_dist_graph():
    def fn(comm, pkg):
        srcs = [comm.rank - 1] if comm.rank > 0 else []
        dsts = [comm.rank + 1] if comm.rank < comm.size - 1 else []
        g = comm.Create_dist_graph_adjacent(srcs, dsts)
        assert g.Topo_test() == pkg.topo.DIST_GRAPH
        sbuf = np.full(3, comm.rank * 7, dtype=np.int64)
        rbuf = np.full(3, -1, dtype=np.int64)
        g.Neighbor_alltoallv(sbuf, [3] * len(dsts), [0] * len(dsts),
                             rbuf, [3] * len(srcs), [0] * len(srcs))
        return list(rbuf)

    assert both(3, fn) == [[-1, -1, -1], [0, 0, 0], [7, 7, 7]]


def test_graph_create_neighbors():
    def fn(comm, pkg):
        index = [2, 4, 6, 8]
        edges = [1, 3, 0, 2, 1, 3, 0, 2]
        g = comm.Create_graph(index, edges)
        assert g.Topo_test() == pkg.topo.GRAPH
        s = np.array([g.rank], dtype=np.int64)
        r = np.full(2, -1, dtype=np.int64)
        g.Neighbor_allgather(s, r)
        return list(r)

    for rank, r in enumerate(both(4, fn)):
        assert sorted(r) == sorted([(rank - 1) % 4, (rank + 1) % 4])


def test_ineighbor_allgather_overlap():
    def fn(comm, pkg):
        cart = comm.Create_cart([4], periods=[True])
        s1 = np.array([cart.rank], dtype=np.int64)
        s2 = np.array([cart.rank * 1000], dtype=np.int64)
        r1 = np.zeros(2, dtype=np.int64)
        r2 = np.zeros(2, dtype=np.int64)
        q1 = cart.Ineighbor_allgather(s1, r1)
        q2 = cart.Ineighbor_allgather(s2, r2)
        q2.wait()
        q1.wait()
        return (list(r1), list(r2))

    for rank, (r1, r2) in enumerate(both(4, fn)):
        left, right = (rank - 1) % 4, (rank + 1) % 4
        assert r1 == [left, right]
        assert r2 == [left * 1000, right * 1000]


def test_ineighbor_alltoall():
    def fn(comm, pkg):
        cart = comm.Create_cart([3], periods=[True])
        s = np.array([cart.rank * 10, cart.rank * 10 + 1], dtype=np.int64)
        r = np.zeros(2, dtype=np.int64)
        cart.Ineighbor_alltoall(s, r).wait()
        return list(r)

    for rank, r in enumerate(both(3, fn)):
        left, right = (rank - 1) % 3, (rank + 1) % 3
        assert r == [left * 10 + 1, right * 10]


def test_ineighbor_allgatherv_and_alltoallv():
    def fn(comm, pkg):
        cart = comm.Create_cart([3], periods=[True])
        s = np.full(2, cart.rank, dtype=np.int64)
        r = np.full(4, -1, dtype=np.int64)
        cart.Ineighbor_allgatherv(s, r, [2, 2], [0, 2]).wait()
        s2 = np.array([cart.rank * 10, cart.rank * 10 + 1], dtype=np.int64)
        r2 = np.full(2, -1, dtype=np.int64)
        cart.Ineighbor_alltoallv(s2, [1, 1], [0, 1], r2, [1, 1],
                                 [0, 1]).wait()
        return (list(r), list(r2))

    for rank, (r, r2) in enumerate(both(3, fn)):
        left, right = (rank - 1) % 3, (rank + 1) % 3
        assert r == [left, left, right, right]
        assert r2 == [left * 10 + 1, right * 10]


def test_neighbor_allgather_derived_datatype():
    def fn(comm, pkg):
        cart = comm.Create_cart([3], periods=[True])
        pair = pkg.dt.contiguous(2, pkg.dt.DOUBLE)
        s = np.array([cart.rank * 1.0, cart.rank + 0.5])
        r = np.full(4, -1.0)
        cart.Neighbor_allgather((s, 1, pair), (r, 2, pair))
        return list(r)

    for rank, r in enumerate(both(3, fn)):
        left, right = (rank - 1) % 3, (rank + 1) % 3
        assert r == [left * 1.0, left + 0.5, right * 1.0, right + 0.5]


def test_dup_carries_topology():
    def fn(comm, pkg):
        cart = comm.Create_cart([2, 2])
        d = cart.dup()
        return (d.Topo_test(), d.Get_coords())

    for rank, (kind, coords) in enumerate(both(4, fn)):
        assert kind == port_topo.CART and coords == [rank // 2, rank % 2]


def test_topo_guards():
    def fn(comm, pkg):
        try:
            comm.Get_coords()
            return "no-error"
        except ValueError:
            pass
        try:
            comm.Neighbor_allgather(np.zeros(1), np.zeros(2))
            return "no-error"
        except ValueError:
            return "ok"

    assert both(2, fn) == ["ok", "ok"]


def test_cart_create_bad_periods_length():
    def fn(comm, pkg):
        try:
            comm.Create_cart([2, 2], periods=[True])
            return "no-error"
        except ValueError:
            return "ok"

    assert both(4, fn) == ["ok"] * 4


def test_dist_graph_create_general_form():
    """MPI_Dist_graph_create: every rank declares edges for any source;
    each rank ends with its own in- and out-neighbours."""
    def fn(comm, pkg):
        # rank 0 declares the whole ring 0→1→2→0, the others nothing
        if comm.rank == 0:
            g = pkg.topo.topo.dist_graph_create(
                comm, [0, 1, 2], [1, 1, 1], [1, 2, 0])
        else:
            g = pkg.topo.topo.dist_graph_create(comm, [], [], [])
        return (g.topo.in_neighbors(g.rank), g.topo.out_neighbors(g.rank))

    assert both(3, fn) == [[[2], [1]], [[0], [2]], [[1], [0]]]


def test_cart_and_graph_reorder_by_device():
    """reorder=True orders ranks by device: the port keys the order by
    runtime.init.device_key (card and logical slot) where the reference
    keys it by device id.  Devices in rank order give the reference's
    ranks (the graph's are its BFS embedding); logical devices given in
    reverse order reverse the cart's ranks."""
    rev = lambda r: logical_devices("cpu")(7 - r)  # noqa: E731

    def fn(comm):
        cart = comm.Create_cart([2, 4], periods=[True, True], reorder=True)
        g = comm.Create_graph([2, 4, 6, 8, 10, 12, 14, 16],
                              [1, 7, 0, 2, 1, 3, 2, 4, 3, 5, 4, 6, 5, 7,
                               6, 0], reorder=True)
        return cart.rank, g.rank

    res = port_run_ranks(8, fn, device_map=rev)
    assert [c for c, _ in res] == [7 - r for r in range(8)]
    assert sorted(g for _, g in res) == list(range(8))
    port = port_run_ranks(8, fn, device_map=logical_devices("cpu"))
    assert port == ref_run_ranks(8, fn, devices=True)
    assert [c for c, _ in port] == list(range(8))


def test_device_mesh_in_grid_order():
    def fn(comm):
        cart = comm.Create_cart([2, 2, 2])
        m = cart.topo.device_mesh(cart)
        assert cart.topo.device_mesh(cart) is m  # cached on the comm
        return m

    res = port_run_ranks(8, fn, device_map=logical_devices("cpu"))
    assert res[0] == [[[CPU, CPU], [CPU, CPU]], [[CPU, CPU], [CPU, CPU]]]
    # co-located ranks share one device: no mesh
    assert port_run_ranks(8, fn, device_map=lambda r: CPU) == [None] * 8


def test_slice_groups():
    def fn(comm, pkg):
        return (pkg.topo.topo.slice_groups(comm, 3),
                pkg.topo.topo.slice_groups(comm))

    assert both(5, fn)[0] == [[[0, 1, 2], [3, 4]], [[0, 1, 2, 3, 4]]]


# -- device path -------------------------------------------------------------

@pytest.mark.parametrize("tier", ["mesh", "hbm"])
def test_shift_arr_ring_on_devices(tier):
    def fn(comm, put):
        cart = comm.Create_cart([comm.size], periods=[True])
        x = put(np.full((4,), float(cart.rank), np.float32))
        return _np(cart.shift_arr(x, 0, 1))

    for rank, y in enumerate(both_devices(4, fn, tier)):
        np.testing.assert_array_equal(y, np.full(4, (rank - 1) % 4,
                                                 np.float32))


@pytest.mark.parametrize("tier", ["mesh", "hbm"])
def test_shift_arr_nonperiodic_edge_zeros(tier):
    def fn(comm, put):
        cart = comm.Create_cart([comm.size], periods=[False])
        x = put(np.full((2,), float(cart.rank + 1), np.float32))
        return _np(cart.shift_arr(x, 0, 1))

    res = both_devices(4, fn, tier)
    np.testing.assert_array_equal(res[0], np.zeros(2, np.float32))
    for rank in range(1, 4):
        np.testing.assert_array_equal(res[rank], np.full(2, rank,
                                                         np.float32))


@pytest.mark.parametrize("tier", ["mesh", "hbm"])
def test_shift_arr_2d_both_dims_both_directions(tier):
    def fn(comm, put):
        cart = comm.Create_cart([2, 4], periods=[True, True])
        x = put(np.arange(6, dtype=np.int32) + 100 * cart.rank)
        return [_np(cart.shift_arr(x, d, s)) for d in (0, 1)
                for s in (1, -1)]

    both_devices(8, fn, tier)


GRIDS = {"ring8": ([8], [True]), "grid2x4": ([2, 4], [True, True]),
         "open2x2x2": ([2, 2, 2], [False, False, False])}


def _halo_input(rank, dtype):
    rng = np.random.default_rng(1000 + rank)
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal((3, 5)).astype(np.float32).astype(dtype)
    return rng.integers(-2 ** 31, 2 ** 31 - 1, (3, 5)).astype(dtype)


@pytest.mark.parametrize("tier", sorted(PORT_MAPS))
@pytest.mark.parametrize("dtype", ["float32", "int32", "float64"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_neighbor_allgather_arr_matches_reference(grid, dtype, tier):
    dims, periods = GRIDS[grid]

    def fn(comm, put):
        cart = comm.Create_cart(dims, periods=periods)
        y = cart.neighbor_allgather_arr(put(_halo_input(cart.rank, dtype)))
        return _np(y), cart.topo.neighbors(cart.rank)

    port = _plain(port_run_ranks(
        8, lambda c: fn(c, lambda a: convert.to_torch(a, c.device)
                        if c.device is not None else a),
        device_map=PORT_MAPS[tier]))
    ref = _plain(ref_run_ranks(
        8, lambda c: fn(c, lambda a: jax.device_put(a, c.device)),
        devices=True))
    for rank, ((p, nbrs), (r, rnbrs)) in enumerate(zip(port, ref)):
        assert nbrs == [s if s != REF_PROC_NULL else PROC_NULL
                        for s in rnbrs]
        assert p.dtype == np.dtype(dtype)
        assert p.shape == (2 * len(dims), 3, 5)
        assert p.tobytes() == r.astype(dtype).tobytes()
        for i, s in enumerate(nbrs):
            want = np.zeros((3, 5), dtype) if s == PROC_NULL \
                else _halo_input(s, dtype)
            assert p[i].tobytes() == want.tobytes()


def test_neighbor_allgather_arr_one_meeting_one_launch_a_member():
    """The port's route: one meeting for the whole gather, and on the
    card one K2 peer launch a member (here, with the wrapper counting
    its launches on the CPU too, one peer_copy call a member)."""
    calls = []
    orig = stacked.peer_copy

    def counting(srcs, out, block, **kw):
        calls.append(sum(s is None for s in srcs))
        return orig(srcs, out, block, **kw)

    def fn(comm):
        cart = comm.Create_cart([2, 2, 2])
        return _np(cart.neighbor_allgather_arr(torch.full((4,), cart.rank)))

    stacked.peer_copy = counting
    try:
        for dm in (logical_devices("cpu"), lambda r: CPU):
            calls.clear()
            port_run_ranks(8, fn, device_map=dm)
            # every member of the open 2x2x2 grid has 3 null sources
            assert calls == [3] * 8
    finally:
        stacked.peer_copy = orig


def test_neighbor_allgather_arr_refusals():
    def fn(comm):
        out = []
        g = comm.Create_dist_graph_adjacent([], [])
        for c in (comm, g):
            try:
                c.neighbor_allgather_arr(torch.ones(2))
                out.append("no-error")
            except ValueError:
                out.append("ok")
        return out

    assert port_run_ranks(2, fn, device_map=logical_devices("cpu")) == \
        [["ok", "ok"]] * 2


def test_neighbor_allgather_arr_partly_shared_devices_refused():
    def fn(comm):
        cart = comm.Create_cart([4], periods=[True])
        try:
            cart.neighbor_allgather_arr(torch.ones(2))
            return "no-error"
        except NotImplementedError:
            return "refused"

    res = port_run_ranks(4, fn, device_map=lambda r: torch.device("cpu",
                                                                  r % 2))
    assert res == ["refused"] * 4


def test_topo_module_imports_nothing_of_the_reference():
    import ompi_tpu_torch.topo.neighbor as nb
    for mod in (port_topo_mod, nb):
        src = open(mod.__file__).read()
        assert "import jax" not in src and "from ompi_tpu." not in src

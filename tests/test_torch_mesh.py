"""coll/tpu, the mesh tier, through both packages: the same rank
programs, the same numpy inputs (made from a seed), compared.

The reference runs under jax on the CPU with one rank a virtual device
(the conftest's 8 host-platform devices, ``run_ranks(devices=True)``);
the port runs with one rank a logical device of the CPU
(``testing.logical_devices("cpu")``), where the kernels' wrappers take
their plain versions.  Mirrors the coll/tpu cases of
tests/test_coll_device.py and the mesh case of tests/test_coll_fusion.py.

Tolerance: byte for byte, except float SUM on random (not integer)
inputs, within the band of test_torch_kernels: |port - ref| <= 4 * N *
2**-24 * sum(|x_i|) (the reference's psum and the port's rank-order
fold may add in different orders).  Integer, MAX / MIN, bitwise and
logical results and all data movement are exact.

Known divergences, pinned here: a communicator whose members partly
share devices is refused (the reference host-stages it); every op of a
fused batch rides a group of its own (the reference gathers and folds
the non-native ops slot by slot).
"""

import jax
import numpy as np
import pytest
import torch

from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import convert
from ompi_tpu_torch.coll import device
from ompi_tpu_torch.mca.params import registry as port_registry
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.runtime.state import LogicalDevice
from ompi_tpu_torch.testing import logical_devices
from ompi_tpu_torch.testing import run_ranks as port_run_ranks

CPU = torch.device("cpu")
OPS = ["MPI_SUM", "MPI_PROD", "MPI_MAX", "MPI_MIN", "MPI_LAND",
       "MPI_BAND", "MPI_LOR", "MPI_BOR", "MPI_LXOR", "MPI_BXOR"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return convert.to_numpy(x)
    return np.asarray(x)


def _conv(v):
    if isinstance(v, (list, tuple)):
        return type(v)(_conv(e) for e in v)
    return v if v is None or isinstance(v, (str, int, float, bool)) \
        else _np(v)


def both(n, fn, device_map=None):
    """fn(comm, put, op_module) through the reference (one virtual
    device a rank) and the port (one logical CPU device a rank);
    returns (port results, reference results) as numpy."""
    port = port_run_ranks(
        n, lambda c: fn(c, lambda a: convert.to_torch(a, c.device),
                        port_op),
        device_map=device_map or logical_devices("cpu"))
    ref = ref_run_ranks(
        n, lambda c: fn(c, lambda a: jax.device_put(a, c.device), ref_op),
        devices=True)
    return _conv(port), _conv(ref)


def _inputs(n, length, dtype, seed, lo=-50, hi=50):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return [rng.standard_normal(length).astype(dtype)
                for _ in range(n)]
    return [rng.integers(lo, hi, length).astype(dtype) for _ in range(n)]


def _band(p, r, xs):
    absum = np.sum([np.abs(x.astype(np.float64)) for x in xs], 0)
    tol = 4 * len(xs) * 2.0 ** -24 * absum
    assert p.dtype == r.dtype and p.shape == r.shape
    assert (np.abs(p.astype(np.float64) - r) <= tol).all()


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------

def test_logical_devices_select_the_mesh_tier():
    """n ranks on n logical devices of one torch device: pairwise-
    distinct keys, so every *_arr entry is coll/tpu (as on the
    reference's virtual devices) and mesh() lists the devices; ranks
    sharing the device without slots keep coll/hbm."""
    names = ("allreduce_arr", "reduce_scatter_block_arr", "allgather_arr",
             "alltoall_arr", "bcast_arr", "reduce_arr", "ppermute_arr")

    def fn(comm, put, op):
        mesh = comm.mesh()  # a jax Mesh, or the port's tuple of devices
        return ([comm.coll.providers[k] for k in names],
                len(getattr(mesh, "devices", mesh).reshape(-1)
                    if hasattr(mesh, "devices") else mesh))

    port, ref = both(4, fn)
    assert port == ref == [(["tpu"] * len(names), 4)] * 4
    hbm = port_run_ranks(4, lambda c: (c.coll.providers["allreduce_arr"],
                                       c.mesh()),
                         device_map=lambda r: CPU)
    assert hbm == [("hbm", None)] * 4


@pytest.mark.parametrize("n", [2, 4, 8])
def test_mesh_allreduce_sum(n):
    """Random float32 SUM within the band, the offload pvar moving on
    every rank, every rank's bytes the same."""
    xs = _inputs(n, 37, np.float32, n)

    offload = port_registry.register_pvar("coll", "tpu",
                                          "offloaded_collectives")

    def fn(comm, put, op):
        before = offload.read()
        out = comm.allreduce_arr(put(xs[comm.rank]), op.SUM)
        return out, (offload.read() - before if op is port_op else 1)

    port, ref = both(n, fn)
    for (p, moved), (r, _) in zip(port, ref):
        _band(p, r, xs)
        assert moved >= 1
        assert p.tobytes() == port[0][0].tobytes()


@pytest.mark.parametrize("opname", OPS)
def test_mesh_allreduce_every_op(opname):
    """All ten ops on int32 at n = 4 (the reference's psum / pmax /
    pmin and its all_gather + fold), exact; MAX and MIN on float32,
    exact."""
    n = 4
    lo, hi = (-3, 4) if opname == "MPI_PROD" else (-50, 50)
    xs = _inputs(n, 29, np.int32, OPS.index(opname), lo, hi)
    fs = _inputs(n, 29, np.float32, OPS.index(opname))

    def fn(comm, put, op):
        o = getattr(op, opname[4:])
        out = [comm.allreduce_arr(put(xs[comm.rank]), o)]
        if opname in ("MPI_MAX", "MPI_MIN"):
            out.append(comm.allreduce_arr(put(fs[comm.rank]), o))
        return out

    port, ref = both(n, fn)
    for p, r in zip(port, ref):
        for a, b in zip(p, r):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_mesh_bcast():
    def fn(comm, put, op):
        val = comm.rank * 100.0 if comm.rank == 3 else 0.0
        return comm.bcast_arr(put(np.full(8, val, np.float32)), root=3)

    port, ref = both(8, fn)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p, r)
        assert p.tolist() == [300.0] * 8


def test_mesh_reduce_scatter():
    """SUM of random float32 within the band, MAX exact."""
    n = 4
    xs = _inputs(n, n * 3, np.float32, 41)

    def fn(comm, put, op):
        x = put(xs[comm.rank])
        return (comm.reduce_scatter_arr(x, op.SUM),
                comm.reduce_scatter_arr(x, op.MAX))

    port, ref = both(n, fn)
    for k, ((ps, pm), (rs, rm)) in enumerate(zip(port, ref)):
        _band(ps, rs, [x[3 * k:3 * (k + 1)] for x in xs])
        np.testing.assert_array_equal(pm, rm)


def test_mesh_allgather_alltoall():
    n = 8

    def fn(comm, put, op):
        ag = comm.allgather_arr(put(np.array([comm.rank * 2], np.int32)))
        a2a = comm.alltoall_arr(put(np.arange(n, dtype=np.int32)
                                    + comm.rank * 10))
        return ag, a2a

    port, ref = both(n, fn)
    for k, ((pag, pa), (rag, ra)) in enumerate(zip(port, ref)):
        np.testing.assert_array_equal(pag, rag)
        np.testing.assert_array_equal(pa, ra)
        assert pa.tolist() == [i * 10 + k for i in range(n)]


def test_mesh_ppermute_ring():
    """The ring-attention primitive, and an open ring (the rank no
    source maps to gets zeros)."""
    n = 8

    def fn(comm, put, op):
        x = put(np.array([comm.rank + 1], np.int32))
        ring = comm.ppermute_arr(x, [(i, (i + 1) % n) for i in range(n)])
        open_ = comm.ppermute_arr(x, [(i, i + 1) for i in range(n - 1)])
        return ring, open_

    port, ref = both(n, fn)
    assert [(a.tolist(), b.tolist()) for a, b in port] == \
        [(a.tolist(), b.tolist()) for a, b in ref]
    assert [a.tolist()[0] for a, _ in port] == [(k - 1) % n + 1
                                                for k in range(n)]


def test_mesh_subcomm():
    """A split comm maps onto a sub-mesh and stays on the mesh tier."""
    def fn(comm, put, op):
        sub = comm.split(comm.rank % 2)
        r = sub.allreduce_arr(put(np.array([float(comm.rank)],
                                           np.float32)), op.SUM)
        return sub.coll.providers["allreduce_arr"], r

    port, ref = both(8, fn)
    assert [(p, r.tolist()) for p, r in port] == \
        [(p, r.tolist()) for p, r in ref]
    assert [r.tolist() for _, r in port] == [[12.0], [16.0]] * 4


def test_mesh_user_op_takes_the_host_path():
    """A user-defined op has no kernel: both packages route it to the
    host path, which serves host buffers (here, CPU tensors)."""
    def fn(comm, put, op):
        fold = op.create(lambda a, b, _: np.copyto(b, np.maximum(a, b)),
                         commute=True)
        return comm.allreduce_arr(put(np.full(4, float(comm.rank),
                                              np.float32)), fold)

    port, ref = both(4, fn)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p, r)
        assert p.tolist() == [3.0] * 4


def test_mesh_user_op_refuses_device_tensors():
    """The port's host path never stages a device tensor: a user-op
    allreduce of a tensor that is not on the CPU (a meta tensor stands
    in for a card's here) raises on every member."""
    def fn(comm):
        fold = port_op.create(lambda a, b, _: None, commute=True)
        with pytest.raises(NotImplementedError, match="does not stage"):
            comm.allreduce_arr(torch.empty(4, device="meta"), fold)
        return comm.coll.providers["allreduce_arr"]

    assert port_run_ranks(4, fn, device_map=logical_devices("cpu")) \
        == ["tpu"] * 4


def test_mesh_bf16_and_scalars():
    """bf16 SUM and 0-d (a loss value) SUM: the shape comes back 0-d."""
    import ml_dtypes

    def fn(comm, put, op):
        b = comm.allreduce_arr(put(np.full(16, comm.rank + 1,
                                           ml_dtypes.bfloat16)), op.SUM)
        s = comm.allreduce_arr(put(np.array(comm.rank + 1.0, np.float32)),
                               op.SUM)
        return b, s

    port, ref = both(4, fn)
    for (pb, ps), (rb, rs) in zip(port, ref):
        assert pb.astype(np.float32).tolist() == \
            rb.astype(np.float32).tolist() == [10.0] * 16
        assert ps.shape == rs.shape == ()
        assert float(ps) == float(rs) == 10.0


def test_mesh_shapes_match_reference():
    """allgather / alltoall / reduce_scatter of a 2-D input: the same
    shapes and bytes as the reference's mesh path."""
    n = 4
    xs = _inputs(n, n * 2 * 3, np.int32, 5)

    def fn(comm, put, op):
        x = put(xs[comm.rank].reshape(n * 2, 3))
        return (comm.allgather_arr(x), comm.alltoall_arr(x),
                comm.reduce_scatter_arr(x, op.MAX))

    port, ref = both(n, fn)
    for p, r in zip(port, ref):
        for a, b in zip(p, r):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_mesh_numpy_input_moves_to_the_device():
    """Mixed residency: rank 0 passes a numpy array, the others device
    tensors.  Eligibility does not diverge (no deadlock); the port
    moves the stray buffer to the rank's device at the deposit, as the
    reference moves a stray shard in _assemble."""
    def fn(comm, put, op):
        x = np.full(8, 1.0, np.float32)
        return comm.allreduce_arr(x if comm.rank == 0 else put(x), op.SUM)

    port, ref = both(4, fn)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p, r)
        assert p.tolist() == [4.0] * 8


def test_mesh_refusals_reach_every_member():
    """A pair the kernels do not take (BAND on float32) meets and
    raises on every member, naming the pair; nothing is staged."""
    def fn(comm):
        with pytest.raises(RuntimeError, match="MPI_BAND"):
            comm.allreduce_arr(torch.ones(4), port_op.BAND)
        return True

    assert port_run_ranks(3, fn, device_map=logical_devices("cpu")) \
        == [True] * 3


# ---------------------------------------------------------------------------
# known divergences
# ---------------------------------------------------------------------------

def test_divergence_partly_shared_devices_refused():
    """4 ranks on 2 devices (two ranks each): the reference's mesh()
    is None and its *_arr calls host-stage; the port refuses every
    call on every member instead of copying device data through the
    host."""
    def ref_fn(comm):
        return np.asarray(comm.allreduce_arr(
            jax.device_put(np.ones(4, np.float32), comm.device),
            ref_op.SUM)).tolist()

    ref = ref_run_ranks(4, ref_fn,
                        device_map=lambda r: jax.devices()[r % 2])
    assert ref == [[4.0] * 4] * 4

    def fn(comm):
        assert comm.mesh() is None
        with pytest.raises(NotImplementedError, match="partly share"):
            comm.allreduce_arr(torch.ones(4), port_op.SUM)
        with pytest.raises(NotImplementedError, match="partly share"):
            comm.iallreduce_arr(torch.ones(4), port_op.SUM)
        return comm.coll.providers["allreduce_arr"]

    dmap = lambda r: LogicalDevice(CPU, r % 2)  # noqa: E731
    assert port_run_ranks(4, fn, device_map=dmap) == ["tpu"] * 4


def test_divergence_fused_mesh_groups_every_op():
    """Mesh-mode fusion: the reference psums SUM/MAX/MIN groups and
    gathers + folds the other slots one by one; the port packs every
    (op, dtype) group (K7) and reduces it as one mesh allreduce.  The
    results are the reference's bytes either way (integers)."""
    def fn(comm, put, op):
        r = comm.rank
        qs = [comm.iallreduce_arr(put(np.arange(6, dtype=np.int32)
                                      + r), op.PROD),
              comm.iallreduce_arr(put(np.full(3, r + 1, np.int32)),
                                  op.SUM),
              comm.iallreduce_arr(put(np.array([r, 1], np.int32)),
                                  op.BOR),
              comm.iallreduce_arr(put(np.array([2 + r], np.int32)),
                                  op.PROD)]
        for q in qs:
            q.wait()
        return [q.result for q in qs]

    port, ref = both(4, fn)
    for p, r in zip(port, ref):
        for a, b in zip(p, r):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# fused batches (mesh mode) and the stream fence
# ---------------------------------------------------------------------------

def _interleaved(comm, put, op):
    """The canonical fused batch of tests/test_coll_fusion.py: mixed
    kinds, ops, dtypes and a scalar; fused results and the blocking
    path's."""
    r = comm.rank
    a = put(np.arange(16, dtype=np.int32) * (r + 1))
    b_ = np.ones(8, np.float32) * (r + 1)
    b_[0] = -r
    b = put(b_)
    c = put(np.full(5, r * 3 + 1, np.int32))
    d = put(np.array(r + 2, np.int32))
    qs = [comm.iallreduce_arr(a, op.SUM), comm.iallreduce_arr(b, op.MAX),
          comm.ibcast_arr(c, 1 % comm.size),
          comm.iallreduce_arr(d, op.PROD)]
    for q in qs:
        q.wait()
    unfused = [comm.allreduce_arr(a, op.SUM), comm.allreduce_arr(b, op.MAX),
               comm.bcast_arr(c, 1 % comm.size),
               comm.allreduce_arr(d, op.PROD)]
    return ([q.result for q in qs], unfused,
            comm.coll.providers["iallreduce_arr"])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_fused_byte_identical_mesh(n):
    """The interleaved batch fused (K7 packs, one mesh allreduce a
    group) equals the blocking path byte for byte, in the port and in
    the reference, and the two packages agree."""
    from ompi_tpu_torch.coll import fusion
    b0 = fusion._pv_batches.read()
    port, ref = both(n, _interleaved)
    assert fusion._pv_batches.read() - b0 == n  # one batch a rank
    for (pf, pu, pprov), (rf, ru, rprov) in zip(port, ref):
        assert pprov == rprov == "nbc"
        for a, b, c, d in zip(pf, pu, rf, ru):
            assert a.tobytes() == b.tobytes() == c.tobytes() == d.tobytes()
            assert a.shape == c.shape


def test_fused_mesh_outputs_are_each_ranks_own():
    """Each rank's fused outputs are views of its own reduced buffer:
    one rank writing into its result never changes a peer's."""
    def fn(comm):
        q = comm.iallreduce_arr(torch.ones(4), port_op.SUM)
        p = comm.ibcast_arr(torch.full((3,), float(comm.rank)), 0)
        q.wait()
        p.wait()
        comm.Barrier()
        if comm.rank == 0:
            q.result.fill_(-7.0)
            p.result.fill_(-7.0)
        comm.Barrier()
        return q.result.tolist(), p.result.tolist()

    res = port_run_ranks(3, fn, device_map=logical_devices("cpu"))
    assert res[1] == res[2] == ([3.0] * 4, [0.0] * 3)
    assert res[0] == ([-7.0] * 4, [-7.0] * 3)


class _Stream:
    def __init__(self, dev, log):
        self.device, self.log = dev, log

    def wait_event(self, ev):
        self.log.append(("wait", self.device, ev.name))


class _Event:
    count = 0
    log: list = []

    def __init__(self):
        _Event.count += 1
        self.name = f"done{_Event.count}"

    def record(self, stream):
        _Event.log.append(("record", stream.device, self.name))


def test_fence_orders_every_device(monkeypatch):
    """The mesh fence, on two devices the CPU can tell apart (cpu and
    meta stand in for two cards): the body's stream on EACH device
    waits on EVERY deposit's event before the launches, each device
    records its own done event after them, and each member waits on
    the done event of its own output's device."""
    log = []
    streams = {}

    def current_stream(dev=None):
        return streams.setdefault(dev, _Stream(dev, log))

    _Event.log = log
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda self, s: log.append(("keep", s.device, None)))
    a, b = torch.ones(2), torch.empty(2, device="meta")

    class Dep:  # a deposit's event
        def __init__(self, name):
            self.name = name

    fn = device._fence(lambda vals: [vals[1], vals[0]])
    outs = fn([(a, Dep("dep0")), (b, Dep("dep1"))])
    waits = {(d, e) for k, d, e in log if k == "wait"}
    devs = {a.device, b.device}
    assert waits == {(d, e) for d in devs for e in ("dep0", "dep1")}
    records = {d: e for k, d, e in log if k == "record"}
    assert set(records) == devs
    # output 0 lies on meta: its done event is meta's
    assert outs[0][1].name == records[b.device]
    assert outs[1][1].name == records[a.device]
    log.clear()
    device._collect(outs[0])
    assert ("wait", b.device, records[b.device]) in log


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, at run time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_mesh_on_card_with_side_streams(cuda_device):
    """8 logical devices on the card, each rank thread working on a
    side stream of its own: the fence must order the body's launches
    after every depositor's stream and each rank's reads after the
    body.  Exact against the plain fold (integers)."""
    n = 8

    def fn(comm):
        s = torch.cuda.Stream(cuda_device)
        with torch.cuda.stream(s):
            x = torch.arange(1 << 16, device=cuda_device,
                             dtype=torch.int32) * (comm.rank + 1)
            torch.cuda._sleep(1 << 20)  # the deposit lands late
            x += 1
            y = comm.allreduce_arr(x, port_op.SUM)
            z = comm.alltoall_arr(x)
            out = (y.cpu(), z.cpu())
        return out

    res = port_run_ranks(n, fn, device_map=logical_devices("cuda:0"))
    base = torch.arange(1 << 16, dtype=torch.int32)
    want = sum(base * (r + 1) + 1 for r in range(n))
    for k, (y, z) in enumerate(res):
        assert torch.equal(y, want)
        blk = (1 << 16) // n
        for j in range(n):
            assert torch.equal(z[j * blk:(j + 1) * blk],
                               (base * (j + 1) + 1)[k * blk:(k + 1) * blk])

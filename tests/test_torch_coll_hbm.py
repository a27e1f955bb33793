"""coll/hbm through both packages: the same rank programs, the same
numpy inputs (made from a seed), compared.

The reference runs under jax on the CPU with every rank on one
virtual device (the conftest's host platform); the port runs with
every rank on ``torch.device("cpu")``, where the stacked kernels'
wrappers take their plain versions.  Mirrors the hbm cases of
tests/test_coll_device.py.

Tolerance: byte for byte, except float SUM/PROD within the band of
test_torch_kernels (|port - ref| <= 4 * N * 2**-24 * sum(|x_i|)),
and the reference's small-integer promotion, compared after a cast
to the input dtype.
"""

import jax
import numpy as np
import pytest
import torch

from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import convert
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import RankError
from ompi_tpu_torch.testing import run_ranks as port_run_ranks

CPU = torch.device("cpu")
OPS = ["MPI_SUM", "MPI_PROD", "MPI_MAX", "MPI_MIN", "MPI_LAND",
       "MPI_BAND", "MPI_LOR", "MPI_BOR", "MPI_LXOR", "MPI_BXOR"]


def _ref_world(n, fn):
    """Run fn(comm, put) on the reference, every rank on one jax
    device; put moves a numpy array onto it."""
    def wrapped(comm):
        return fn(comm, lambda a: jax.device_put(a, comm.device))
    return ref_run_ranks(n, wrapped, device_map=lambda r: jax.devices()[0])


def _port_world(n, fn):
    """Run fn(comm, put) on the port, every rank on the CPU device."""
    def wrapped(comm):
        return fn(comm, lambda a: convert.to_torch(a, comm.device))
    return port_run_ranks(n, wrapped, device_map=lambda r: CPU)


def _np(x):
    if isinstance(x, torch.Tensor):
        return convert.to_numpy(x)
    return np.asarray(x)


def both(n, fn):
    """fn(comm, put, op_module) -> nested lists/tuples of arrays, run
    through both packages; returns (port results, reference results)
    as numpy."""
    def conv(v):
        if isinstance(v, (list, tuple)):
            return type(v)(conv(e) for e in v)
        return v if v is None or isinstance(v, (str, int, float, bool)) \
            else _np(v)
    port = _port_world(n, lambda c, put: fn(c, put, port_op))
    ref = _ref_world(n, lambda c, put: fn(c, put, ref_op))
    return conv(port), conv(ref)


def _inputs(n, length, dtype, seed, lo=-50, hi=50):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return [rng.standard_normal(length).astype(dtype)
                for _ in range(n)]
    return [rng.integers(lo, hi, length).astype(dtype) for _ in range(n)]


def _same(p, r, dtype, band_n=None, absum=None):
    assert p.dtype == np.dtype(dtype)
    assert p.shape == r.shape
    r = r.astype(dtype)
    if band_n is None:
        np.testing.assert_array_equal(p, r)
    else:
        tol = 4 * band_n * 2.0 ** -24 * absum
        assert (np.abs(p.astype(np.float64) - r) <= tol).all()


def test_hbm_selected_in_both():
    def fn(comm, put, op):
        return comm.coll.providers["allreduce_arr"], \
            comm.coll.providers["alltoall_arr"]
    port, ref = both(4, fn)
    assert port == ref == [("hbm", "hbm")] * 4


@pytest.mark.parametrize("opname", OPS)
def test_hbm_allreduce_every_op(opname):
    """All ten ops on int32 (the reference's small-int promotion does
    not apply), plus the four float ops on float32."""
    n = 4
    dtypes = [np.int32] + ([np.float32] if opname in OPS[:4] else [])
    for dtype in dtypes:
        lo, hi = (-3, 4) if opname == "MPI_PROD" else (-50, 50)
        xs = _inputs(n, 37, dtype, OPS.index(opname), lo, hi)

        def fn(comm, put, op):
            return comm.allreduce_arr(put(xs[comm.rank]),
                                      getattr(op, opname[4:]))

        port, ref = both(n, fn)
        absum = np.sum([np.abs(x.astype(np.float64)) for x in xs], 0)
        float_band = np.dtype(dtype).kind == "f" and \
            opname in ("MPI_SUM", "MPI_PROD")
        for p, r in zip(port, ref):
            if float_band and opname == "MPI_PROD":
                _same(p, r, dtype, n, np.abs(r.astype(np.float64)))
            else:
                _same(p, r, dtype, n if float_band else None, absum)


@pytest.mark.parametrize("dtype", [np.int16, np.uint16, np.uint32,
                                   np.uint64, np.complex64],
                         ids=lambda d: np.dtype(d).name)
def test_hbm_allreduce_whole_dtype_table(dtype):
    """The types the reference's hbm path reduces on the device beyond
    the headline ones: the port's kernel takes them too (nothing is
    staged through the host).  Complex SUM is within the float32 band
    of |x_i|; the integers are exact (after the reference's small-int
    promotion is cast back)."""
    n = 3
    rng = np.random.default_rng(17)
    if np.dtype(dtype).kind == "c":
        xs = [(rng.standard_normal(29) + 1j * rng.standard_normal(29)
               ).astype(dtype) for _ in range(n)]
        ops = ["MPI_SUM"]
    else:
        xs = [rng.integers(0, 1 << 12, 29).astype(dtype) for _ in range(n)]
        ops = ["MPI_SUM", "MPI_MAX", "MPI_BXOR"]

    def fn(comm, put, op):
        return [comm.allreduce_arr(put(xs[comm.rank]), getattr(op, o[4:]))
                for o in ops]

    port, ref = both(n, fn)
    absum = np.sum([np.abs(x) for x in xs], 0)
    for p_rank, r_rank in zip(port, ref):
        for o, p, r in zip(ops, p_rank, r_rank):
            assert p.dtype == np.dtype(dtype) and p.shape == r.shape
            if np.dtype(dtype).kind == "c":
                assert (np.abs(p - r) <= 4 * n * 2.0 ** -24 * absum).all()
            else:
                np.testing.assert_array_equal(p, r.astype(dtype), err_msg=o)


def test_hbm_refusals_reach_every_member():
    """A call the kernels do not take (an op/type pair MPI does not
    admit, a leading dimension the size does not divide) raises on
    every member instead of going to the host."""
    def fn(comm, call):
        try:
            call(comm)
        except RuntimeError as e:
            return type(e.__cause__).__name__
        return "returned"

    calls = [
        lambda c: c.allreduce_arr(torch.ones(8), port_op.BAND),
        lambda c: c.allreduce_arr(torch.ones(8, dtype=torch.complex64),
                                  port_op.MAX),
        lambda c: c.reduce_scatter_arr(torch.ones(7), port_op.SUM),
        lambda c: c.alltoall_arr(torch.ones(7)),
    ]
    want = ["TypeError", "TypeError", "ValueError", "ValueError"]
    for call, w in zip(calls, want):
        got = port_run_ranks(3, lambda c: fn(c, call),
                             device_map=lambda r: CPU, timeout=30)
        assert got == [w] * 3


def test_host_path_refuses_device_tensors():
    """arr_host works on host buffers only: a tensor that is not on the
    CPU (a meta tensor stands in for a card's here) is refused, not
    copied to the host and back — in a world without devices and for a
    user-defined op on a device world alike."""
    user = port_op.create(lambda a, b, dt: np.add(a, b, out=b), True)

    def fn(comm, op):
        x = torch.ones(4, device="meta")
        with pytest.raises(NotImplementedError, match="does not stage"):
            comm.allreduce_arr(x, op)
        return comm.coll.providers["allreduce_arr"]

    assert port_run_ranks(2, lambda c: fn(c, port_op.SUM)) == \
        ["arr_host"] * 2
    assert port_run_ranks(2, lambda c: fn(c, user),
                          device_map=lambda r: CPU) == ["hbm"] * 2


@pytest.mark.parametrize("opname,dtype", [("MPI_SUM", np.float32),
                                          ("MPI_MAX", np.float32),
                                          ("MPI_BXOR", np.int32),
                                          ("MPI_SUM", np.int8)])
def test_hbm_reduce_scatter(opname, dtype):
    n = 4
    xs = _inputs(n, n * 6, dtype, 5)

    def fn(comm, put, op):
        return comm.reduce_scatter_arr(put(xs[comm.rank]),
                                       getattr(op, opname[4:]))

    port, ref = both(n, fn)
    absum = np.sum([np.abs(x.astype(np.float64)) for x in xs], 0)
    band = n if np.dtype(dtype).kind == "f" and opname == "MPI_SUM" \
        else None
    for k, (p, r) in enumerate(zip(port, ref)):
        assert p.shape == (6,)
        _same(p, r, dtype, band, absum[k * 6:(k + 1) * 6])


@pytest.mark.parametrize("shape", [(8,), (8, 3), (4, 2, 5)],
                         ids=["1d", "2d", "3d"])
def test_hbm_alltoall(shape):
    n = 4
    xs = [x.reshape(shape) for x in
          _inputs(n, int(np.prod(shape)), np.float32, 9)]

    def fn(comm, put, op):
        return comm.alltoall_arr(put(xs[comm.rank]))

    port, ref = both(n, fn)
    for p, r in zip(port, ref):
        _same(p, r, np.float32)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_hbm_allgather_bcast_reduce(dtype):
    n = 4
    xs = _inputs(n, 5, dtype, 13)

    def fn(comm, put, op):
        x = put(xs[comm.rank])
        return (comm.allgather_arr(x), comm.bcast_arr(x, root=2),
                comm.reduce_arr(x, op.MAX, root=1))

    port, ref = both(n, fn)
    for k, (p, r) in enumerate(zip(port, ref)):
        for i in (0, 1):
            _same(p[i], r[i], dtype)
        if k == 1:
            _same(p[2], r[2], dtype)
        else:
            assert p[2] is None and r[2] is None


def test_divergence_hbm_scalar_allgather():
    """Known divergence, pinned: the reference's hbm allgather_arr does
    not normalise a 0-d input (its mesh and host paths do), and its
    stacked concatenate raises.  The port normalises it as those paths
    do: every rank gets shape (N,)."""
    n = 3

    def fn(comm, put, op):
        return comm.allgather_arr(put(np.float32(comm.rank)))

    port = _port_world(n, lambda c, put: fn(c, put, port_op))
    for p in port:
        np.testing.assert_array_equal(_np(p), np.arange(n, dtype=np.float32))
    with pytest.raises(Exception, match="Zero-dimensional"):
        _ref_world(n, lambda c, put: fn(c, put, ref_op))


def test_hbm_ppermute_ring_and_open():
    n = 4
    xs = _inputs(n, 6, np.int32, 17)

    def fn(comm, put, op):
        x = put(xs[comm.rank])
        ring = comm.ppermute_arr(x, [(i, (i + 1) % n) for i in range(n)])
        # an open shift: rank 0 has no source and gets zeros
        shift = comm.ppermute_arr(x, [(i, i + 1) for i in range(n - 1)])
        return ring, shift

    port, ref = both(n, fn)
    for p, r in zip(port, ref):
        _same(p[0], r[0], np.int32)
        _same(p[1], r[1], np.int32)
    np.testing.assert_array_equal(port[0][1], np.zeros(6, np.int32))


def test_hbm_scalar_and_numpy_deposit():
    """0-d inputs keep their shape; a rank that passes numpy instead
    of a device tensor is moved to the device (mixed residency)."""
    def fn(comm, put, op):
        s = comm.allreduce_arr(put(np.float32(comm.rank + 1)), op.SUM)
        x = np.full(4, 1.0, np.float32)
        m = comm.allreduce_arr(x if comm.rank == 0 else put(x), op.SUM)
        return s, m

    port, ref = both(4, fn)
    for p, r in zip(port, ref):
        assert p[0].shape == r[0].shape == ()
        assert float(p[0]) == float(r[0]) == 10.0
        _same(p[1], r[1], np.float32)


def test_hbm_outputs_do_not_alias():
    """The reference hands every rank the SAME immutable array; torch
    tensors are mutable, so the port gives each rank its own: rank 0
    writing into its result in place leaves every peer's unchanged."""
    n = 4

    def fn(comm):
        x = torch.arange(6, dtype=torch.float32) + comm.rank
        outs = [comm.allreduce_arr(x, port_op.SUM),
                comm.allgather_arr(x),
                comm.bcast_arr(x, root=0),
                comm.ppermute_arr(x, [(i, (i + 1) % n) for i in range(n)])]
        comm.Barrier()
        if comm.rank == 0:
            for o in outs:
                o.add_(1000)
        comm.Barrier()
        return [o.clone() for o in outs], x

    res = port_run_ranks(n, fn, device_map=lambda r: CPU)
    base = torch.arange(6, dtype=torch.float32)
    for k in range(1, n):
        ar, ag, bc, pp = res[k][0]
        torch.testing.assert_close(ar, 4 * base + 6)
        torch.testing.assert_close(ag, torch.cat([base + r
                                                  for r in range(n)]))
        torch.testing.assert_close(bc, base)
        torch.testing.assert_close(pp, base + (k - 1))
        torch.testing.assert_close(res[k][1], base + k)  # input intact
    torch.testing.assert_close(res[0][0][0], 4 * base + 6 + 1000)


def test_hbm_peer_abort_unblocks_rendezvous():
    """A rank dying before the rendezvous must not hang the others."""
    def fn(comm):
        if comm.rank == 1:
            raise ValueError("dead rank")
        comm.allreduce_arr(torch.ones(4), port_op.SUM)
        return True

    with pytest.raises(Exception, match="dead rank|aborted"):
        port_run_ranks(3, fn, device_map=lambda r: CPU, timeout=30)


def test_distinct_devices_raise_not_implemented():
    """Members on distinct devices that are not pairwise distinct (4
    ranks on 2 devices) fit neither coll/hbm nor the mesh tier: the
    *_arr surface says so instead of host-staging.  (Pairwise-distinct
    devices take the mesh tier: tests/test_torch_mesh.py.)"""
    def fn(comm):
        assert comm.coll.providers["allreduce_arr"] == "tpu"
        return comm.allreduce_arr(torch.ones(4), port_op.SUM)

    with pytest.raises(RankError) as ei:
        port_run_ranks(4, fn,
                       device_map=lambda r: torch.device("cpu", r % 2),
                       timeout=30)
    assert isinstance(ei.value.exc, NotImplementedError)
    assert "partly share devices" in str(ei.value.exc)


def test_host_worlds_stage_through_the_host():
    """No devices: the *_arr surface is host-staged (arr_host) and
    returns numpy, in both packages."""
    xs = _inputs(3, 4, np.float64, 21)

    def fn(comm, op):
        return (comm.coll.providers["allreduce_arr"],
                comm.allreduce_arr(xs[comm.rank], op.SUM))

    port = port_run_ranks(3, lambda c: fn(c, port_op))
    ref = ref_run_ranks(3, lambda c: fn(c, ref_op))
    for p, r in zip(port, ref):
        assert p[0] == r[0] == "arr_host"
        np.testing.assert_array_equal(p[1], r[1])

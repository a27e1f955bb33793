"""The port's device RMA window (osc/device, ompi_tpu_torch/osc/device.py)
through both packages, from the same numpy seeds, byte for byte.

The reference runs its device window under jax on the CPU, one rank a
virtual device (``run_ranks(devices=True)`` on the conftest's 8 host
devices); the port runs one rank a logical device of the CPU
(``testing.logical_devices("cpu")``), where the shards are CPU tensors
and the RMA kernels' wrappers (K8 rma_copy, K9 rma_acc, K10 rma_cas)
take their plain versions.  Mirrors tests/test_osc_device.py: the
promoted rma_counter and halo_stencil workloads (port pt2pt, port
device with numpy and with tensor origins, reference device), framework
selection, the DMA and kernel lowerings, the typed accumulate ops.

Known divergences, pinned by the tests named after them:
  * ``memory`` (and ``read_local``) return a tensor on the rank's
    device, where the reference returns a host copy;
  * every op is one launch (or one copy) whatever its size, where the
    reference chunks by segment (its test_large_transfers_chunked_by_
    segment counts chunks);
  * accumulate with a (dtype, op) pair Op.valid_for rejects raises
    TypeError, where the reference's host path computes numpy's answer
    for some (LAND on float, MAX on complex);
  * complex PROD rounds each product and sum on its own, where numpy
    (the reference's accumulate) may fuse one product into the sum;
  * the ULFM cases (death, shrink) are in tests/test_torch_osc_ft.py.
"""

import numpy as np
import pytest
import torch

from ompi_tpu import osc as ref_osc
# the device modules register osc_device_dma, which with_knob sets
from ompi_tpu.osc import device as _ref_device  # noqa: F401
from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import osc as port_osc
from ompi_tpu_torch.kernels import rma
from ompi_tpu_torch.mca.params import registry as port_registry
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.osc import device as _port_device  # noqa: F401
from ompi_tpu_torch.osc import window as port_window
from ompi_tpu_torch.testing import logical_devices
from ompi_tpu_torch.testing import run_ranks as port_run_ranks
from ompi_tpu_torch.testing.rma import (Buffers, counter_workload,
                                        expected_halo, halo_workload, host)

CPU = torch.device("cpu")
NUMPY, TENSORS = Buffers(False), Buffers(True)
WIRE = [np.dtype(t) for t in (
    np.uint8, np.int8, np.int16, np.uint16, np.int32, np.uint32,
    np.int64, np.uint64, np.float32, np.float64, np.complex64,
    np.complex128, np.bool_)]
ACC_OPS = ["MPI_SUM", "MPI_PROD", "MPI_MAX", "MPI_MIN", "MPI_LAND",
           "MPI_BAND", "MPI_LOR", "MPI_BOR", "MPI_LXOR", "MPI_BXOR",
           "MPI_REPLACE", "MPI_NO_OP"]


def port_dev(n, fn):
    return port_run_ranks(n, fn, device_map=logical_devices("cpu"))


def ref_dev(n, fn):
    return ref_run_ranks(n, fn, devices=True)


def with_knob(name, value, run):
    """run() with the MCA variable ``name`` set to ``value`` in both
    registries, restored after (ranks are threads: set it around the
    run, never inside a rank)."""
    saved = (port_registry.get(name), ref_registry.get(name))
    port_registry.set(name, value)
    ref_registry.set(name, value)
    try:
        return run()
    finally:
        port_registry.set(name, saved[0])
        ref_registry.set(name, saved[1])


# ---- promoted example workloads ---------------------------------------

@pytest.mark.parametrize("workload", ["rma_counter", "halo_stencil"])
def test_promoted_examples_byte_identical(workload):
    """The same bytes from the port's pt2pt window, the port's device
    window with numpy origins and with tensor origins, and the
    reference's device window."""
    def wl(osc, ops, bufs):
        return counter_workload(osc, ops, bufs) \
            if workload == "rma_counter" else halo_workload(osc, bufs)

    n = 4
    runs = {
        "port pt2pt": port_run_ranks(n, wl(port_osc, port_op, NUMPY)),
        "port device": port_dev(n, wl(port_osc, port_op, NUMPY)),
        "port device, tensor origins": port_dev(
            n, wl(port_osc, port_op, TENSORS)),
        "reference device": ref_dev(n, wl(ref_osc, ref_op, NUMPY)),
    }
    kinds = {k: {r["component"] for r in v} for k, v in runs.items()}
    assert kinds == {"port pt2pt": {"Window"},
                     "port device": {"DeviceWindow"},
                     "port device, tensor origins": {"DeviceWindow"},
                     "reference device": {"DeviceWindow"}}
    want = runs["reference device"]
    for name, res in runs.items():
        for r in range(n):
            for k in want[r]:
                if k != "component":
                    assert res[r][k] == want[r][k], (name, r, k)
    if workload == "halo_stencil":
        for r in range(n):
            assert want[r]["halo"] == expected_halo(r, n)


# ---- framework selection ---------------------------------------------

def test_osc_select_device_vs_pt2pt():
    """Win_create commits to the devices only for tensor memory; --mca
    osc pt2pt overrides the verdict.  The device window's shard is a
    tensor on the rank's device."""
    def fn(comm):
        host_win = port_osc.create(comm, np.zeros(8, dtype=np.int64))
        dev_win = port_osc.create(comm, torch.zeros(8, dtype=torch.int32))
        alloc = port_osc.allocate(comm, 64)
        kinds = (type(host_win).__name__, type(dev_win).__name__,
                 type(alloc).__name__)
        shard = alloc._tab.arrs[comm.rank]
        on_dev = (shard.device == comm.device and shard.dtype == torch.uint8
                  and shard.numel() == 64)
        for w in (host_win, dev_win, alloc):
            w.free()
        port_registry.set("osc", "pt2pt")
        comm.__dict__.pop("_osc_pick", None)
        try:
            forced = port_osc.allocate(comm, 64, name="forced")
            forced_kind = type(forced).__name__
            forced.free()
        finally:
            port_registry.set("osc", "")
            comm.__dict__.pop("_osc_pick", None)
        return kinds + (forced_kind, on_dev)

    res = port_dev(2, fn)
    assert all(r == ("Window", "DeviceWindow", "DeviceWindow", "Window",
                     True) for r in res)


def test_no_mesh_falls_back_to_pt2pt():
    def fn(comm):
        win = port_osc.allocate(comm, 32)
        kind = type(win).__name__
        win.free()
        return kind

    assert port_run_ranks(2, fn) == ["Window", "Window"]
    # ranks sharing one device have no mesh either
    assert port_run_ranks(2, fn, device_map=lambda r: CPU) \
        == ["Window", "Window"]


# ---- data plane -------------------------------------------------------

def _lowering_sequence(osc, ops, tag):
    """tests/test_osc_device.py's lowering-equivalence sequence: puts at
    odd offsets, a wholesale put, accumulate, CAS, get_accumulate."""
    def fn(comm):
        rank, size = comm.rank, comm.size
        win = osc.allocate(comm, 256, disp_unit=1, name=f"eq-{tag}")
        win.fence()
        win.put(np.arange(7, dtype=np.uint8) + rank, (rank + 1) % size,
                disp=3)
        win.fence()
        snap = host(win.memory).view(np.uint8)[3:10].copy()
        comm.Barrier()
        whole = np.full(256, rank + 10, dtype=np.uint8)
        whole[3:10] = snap
        win.put(whole, (rank + 2) % size)
        win.fence()
        win.accumulate(np.full(4, rank + 1, dtype=np.int32), 0,
                       disp=16, op=ops.SUM)
        win.fence()
        old = np.empty(1, dtype=np.int32)
        win.lock(0, osc.LOCK_SHARED)
        if rank == 1:
            win.compare_and_swap(np.int32(0), np.int32(rank + 1), old, 0,
                                 disp=32)
        res = np.empty(4, dtype=np.int32)
        win.get_accumulate(np.full(4, 2, dtype=np.int32), res, 0,
                           disp=16, op=ops.NO_OP)
        win.unlock(0)
        win.fence()
        mem = host(win.memory).tobytes()
        win.free()
        return {"mem": mem, "res": res.tobytes()}
    return fn


def test_dma_and_kernel_lowerings_byte_identical():
    """osc_device_dma 1 (copy-engine copies) and 0 (K8 launches) give
    the same window bytes, and the reference's."""
    n = 4
    via_dma = port_dev(n, _lowering_sequence(port_osc, port_op, "dma"))
    via_krn = with_knob("osc_device_dma", "0", lambda: port_dev(
        n, _lowering_sequence(port_osc, port_op, "krn")))
    ref = ref_dev(n, _lowering_sequence(ref_osc, ref_op, "ref"))
    assert via_dma == via_krn == ref


def _values(rng, n, dt):
    """n random values of a wire dtype: floats with NaN, signed zeros
    and infinities sprinkled in, bool as 0/1."""
    if dt == np.bool_:
        return rng.integers(0, 2, n).astype(np.bool_)
    if dt.kind == "f":
        x = rng.standard_normal(n).astype(dt)
        k = max(2, n // 8)
        x[rng.integers(0, n, k)] = rng.choice(
            np.array([np.nan, 0.0, -0.0, np.inf, -np.inf], dtype=dt), k)
        return x
    if dt.kind == "c":
        return (rng.standard_normal(n)
                + 1j * rng.standard_normal(n)).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)


def _ops_for(dt):
    return [o for o in ACC_OPS if port_op.PREDEFINED[o].valid_for(dt)]


def _acc_sequence(osc, ops, dt, count, opnames, tensors=False):
    """For each op: every rank accumulates into its right neighbour at
    an aligned byte offset and get_accumulates into it at a misaligned
    one (disp_unit 1), one origin a target and region, so the result
    does not depend on arrival order; then the window's bytes."""
    isz = dt.itemsize
    a_off, m_off = 0, count * isz + 17
    nbytes = m_off + count * isz + 7

    def fn(comm):
        rank, size = comm.rank, comm.size
        bufs = TENSORS if tensors else NUMPY
        rng = np.random.default_rng(1000 * WIRE.index(dt) + rank)
        win = osc.allocate(comm, nbytes, disp_unit=1, name="acc")
        init = np.zeros(nbytes, dtype=np.uint8)
        init[a_off:a_off + count * isz] = _values(rng, count, dt).view(
            np.uint8)
        init[m_off:m_off + count * isz] = _values(rng, count, dt).view(
            np.uint8)
        win.fence()
        win.put(init, rank)
        win.fence()
        right = (rank + 1) % size
        out = {}
        for name in opnames:
            op = ops.PREDEFINED[name]
            win.accumulate(bufs.origin(comm, _values(rng, count, dt)),
                           right, disp=a_off, op=op)
            res = bufs.result(comm, count, dt)
            win.get_accumulate(bufs.origin(comm, _values(rng, count, dt)),
                               res, right, disp=m_off, op=op)
            win.fence()
            out[name] = (host(win.memory).tobytes(), host(res).tobytes())
            comm.Barrier()  # no rank writes the next op before all read
        win.free()
        return out
    return fn


@pytest.mark.parametrize("dt", WIRE, ids=str)
def test_accumulate_every_dtype_and_op(dt):
    """Every wire dtype x every op Op.valid_for admits, accumulate and
    get_accumulate, aligned and misaligned: the reference's bytes
    (complex PROD: see test_divergence_complex_prod_rounding).  The
    port takes exactly the pairs Op.valid_for admits."""
    opnames = _ops_for(dt)
    tdt = torch.from_numpy(np.empty(0, dt)).dtype
    assert [o for o in ACC_OPS if rma.acc_supported(tdt, o)] == opnames
    if dt.kind == "c":
        opnames = [o for o in opnames if o != "MPI_PROD"]
    count = 37
    port = port_dev(4, _acc_sequence(port_osc, port_op, dt, count, opnames))
    ref = ref_dev(4, _acc_sequence(ref_osc, ref_op, dt, count, opnames))
    for r in range(4):
        for name in opnames:
            assert port[r][name] == ref[r][name], (r, name)


def test_accumulate_tensor_origins_and_kernel_mode():
    """Tensor origins and results, and osc_device_dma 0, give the same
    bytes as numpy buffers (float32, int64, complex128, bool)."""
    for dt in (np.dtype(np.float32), np.dtype(np.int64),
               np.dtype(np.complex128), np.dtype(np.bool_)):
        opnames = _ops_for(dt)
        a = port_dev(4, _acc_sequence(port_osc, port_op, dt, 9, opnames))
        b = port_dev(4, _acc_sequence(port_osc, port_op, dt, 9, opnames,
                                      tensors=True))
        c = with_knob("osc_device_dma", "0", lambda: port_dev(
            4, _acc_sequence(port_osc, port_op, dt, 9, opnames)))
        assert a == b == c, dt


def _prod_once(osc, ops, w, s):
    """Rank 0 puts w into rank 1's window at a misaligned offset and
    accumulates s into it with PROD; rank 1's window bytes there."""
    def fn(comm):
        win = osc.allocate(comm, w.nbytes + 3, disp_unit=1)
        win.fence()
        if comm.rank == 0:
            win.put(w, 1, disp=3)
            win.flush(1)
            win.accumulate(s, 1, disp=3, op=ops.PROD)
        win.fence()
        mem = host(win.memory)[3:3 + w.nbytes].tobytes()
        win.free()
        return mem
    return fn


def test_divergence_complex_prod_rounding():
    """Pinned divergence: complex PROD accumulate computes (ac - bd,
    ad + bc) with each product and sum rounded on its own, as K1's op
    table does (reduce_ops.cuh); the reference applies numpy's multiply,
    which a numpy built with FMA fuses (one product into the sum), so
    the two may differ in the last bits of a part."""
    rng = np.random.default_rng(77)
    for dt, rt in ((np.dtype(np.complex64), np.float32),
                   (np.dtype(np.complex128), np.float64)):
        w, s = _values(rng, 64, dt), _values(rng, 64, dt)
        port = port_dev(2, _prod_once(port_osc, port_op, w, s))[1]
        ref = ref_dev(2, _prod_once(ref_osc, ref_op, w, s))[1]
        want = np.empty(64, dt)
        want.real = s.real * w.real - s.imag * w.imag
        want.imag = s.real * w.imag + s.imag * w.real
        assert port == want.tobytes(), dt
        assert ref == np.multiply(s, w).tobytes(), dt
        np.testing.assert_allclose(
            np.frombuffer(port, dt), np.frombuffer(ref, dt),
            rtol=4 * np.finfo(rt).eps, atol=0)


def test_divergence_invalid_pairs_raise():
    """Pinned divergence: a (dtype, op) pair that Op.valid_for rejects
    raises TypeError on the port's device window (the reference's host
    path computes numpy's LAND on floats and MAX on complex); MAXLOC
    raises in both, as in the reference."""
    def fn(comm):
        win = port_osc.allocate(comm, 64)
        raised = []
        for arr, op in ((np.ones(2, np.float32), port_op.LAND),
                        (np.ones(2, np.complex64), port_op.MAX),
                        (np.ones(2, np.float64), port_op.BAND),
                        (np.ones(2, np.int32), port_op.MAXLOC)):
            try:
                win.accumulate(arr, 0, op=op)
            except TypeError:
                raised.append(op.name)
        win.fence()
        win.free()
        return raised

    assert port_dev(2, fn) == [["MPI_LAND", "MPI_MAX", "MPI_BAND",
                                "MPI_MAXLOC"]] * 2


def _cas_values(osc, ops, tensors=False):
    """Rank 0 runs K10's value cases on rank 1's window, one slot a
    case: (window value, compare, new) by dtype."""
    nan = np.nan
    cases = [
        (np.float32, -0.0, 0.0, 5.0), (np.float32, nan, nan, 5.0),
        (np.float64, 0.0, -0.0, 3.0), (np.float64, nan, nan, 1.0),
        (np.float64, 1.5, 2.5, 7.0),
        (np.complex64, 1 + 2j, 1 + 2j, 3 - 1j),
        (np.complex64, 1 + 2j, 1 - 2j, 5j),
        (np.complex128, complex(-0.0, 0.0), complex(0.0, -0.0), 7 + 0j),
        (np.complex128, complex(nan, 0.0), complex(nan, 0.0), 1 + 0j),
        (np.bool_, True, True, False), (np.bool_, False, True, True),
        (np.uint64, 2 ** 64 - 1, 2 ** 64 - 1, 1), (np.int8, -5, -5, 7),
        (np.int16, 5, 6, 1),
    ]

    def fn(comm):
        bufs = TENSORS if tensors else NUMPY
        win = osc.allocate(comm, 16 * len(cases) + 1, disp_unit=1)
        win.fence()
        olds = []
        if comm.rank == 0:
            for k, (dt, wv, cv, nv) in enumerate(cases):
                off = 16 * k + (k % 3)  # some slots misaligned
                win.put(np.array([wv], dtype=dt), 1, disp=off)
                win.flush(1)
                old = bufs.result(comm, 1, dt)
                win.compare_and_swap(dt(cv), dt(nv), old, 1, disp=off)
                olds.append(host(old).tobytes())
        win.fence()
        mem = host(win.memory).tobytes()
        win.free()
        return mem, olds
    return fn


def test_compare_and_swap_value_cases():
    """CAS compares by value in the dtype: -0.0 equals 0.0, NaN equals
    nothing, complex compares both parts, bool its 0/1 value, unsigned
    64-bit its full range — the reference's bytes, numpy and tensor
    results alike."""
    port = port_dev(2, _cas_values(port_osc, port_op))
    tens = port_dev(2, _cas_values(port_osc, port_op, tensors=True))
    ref = ref_dev(2, _cas_values(ref_osc, ref_op))
    assert port == tens == ref
    mem = np.frombuffer(port[1][0], dtype=np.uint8)
    assert mem[0:4].view(np.float32)[0] == 5.0  # -0.0 matched 0.0
    assert np.isnan(mem[17:21].copy().view(np.float32)[0])  # NaN: no swap


def test_tensor_values_for_fetch_and_op_and_cas():
    """fetch_and_op takes its value, compare_and_swap its compare and
    new values, as tensors on the origin rank's device too: the same
    bytes as host values."""
    def fn(comm, tensors):
        win = port_osc.allocate(comm, 16, disp_unit=8)
        win.fence()
        old = torch.empty(1, dtype=torch.int64)
        prev = torch.empty(1, dtype=torch.int64)
        if tensors:
            win.fetch_and_op(torch.tensor(5), old, 0, op=port_op.SUM)
        else:
            win.fetch_and_op(5, old, 0, op=port_op.SUM)
        win.fence()
        if comm.rank == 1:
            c, n = (torch.tensor([5 * comm.size]), torch.tensor([-1])) \
                if tensors else (5 * comm.size, -1)
            win.compare_and_swap(c, n, prev, 0, disp=0)
        win.fence()
        mem = host(win.memory).tobytes()
        win.free()
        return int(old[0]) % 5, int(prev[0]) if comm.rank == 1 else None, \
            mem

    a = port_dev(3, lambda c: fn(c, False))
    b = port_dev(3, lambda c: fn(c, True))
    assert a == b
    assert a[1][1] == 15
    assert np.frombuffer(a[0][2], np.int64).tolist() == [-1, 0]


def test_one_launch_an_op_at_any_size(monkeypatch):
    """Pinned divergence from the reference's segment chunking
    (tests/test_osc_device.py:169 counts chunks): with
    osc_device_dma 0 a 40001-byte put at an odd displacement and its get
    are one K8 call each, an accumulate one K9 call, a CAS one K10
    call, whatever the size; bytes exact.  With dma 1 put and get launch
    no K8.  (On the CPU the wrappers run their plain versions and count
    no launches, so the calls are counted here.)"""
    calls = {"rma_copy": 0, "rma_acc": 0, "rma_cas": 0}
    for name in calls:
        orig = getattr(rma, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(rma, name, counted)

    def fn(comm):
        win = port_osc.allocate(comm, 1 << 17, name="big")
        rng = np.random.default_rng(100 + comm.rank)
        blob = rng.integers(0, 256, 40001, dtype=np.uint8)
        win.fence()
        comm.Barrier()
        before = dict(calls)
        puts0 = port_window.pv_puts.read()
        comm.Barrier()
        if comm.rank == 0:
            win.put(blob, 1, disp=13)
            win.flush(1)
            back = np.empty(40001, dtype=np.uint8)
            win.get(back, 1, disp=13)
            win.accumulate(np.ones(9000, np.int32), 1, disp=41000)
            old = np.empty(1, np.int64)
            win.compare_and_swap(0, 1, old, 1, disp=80000)
            ok = bool(np.array_equal(back, blob))
        comm.Barrier()
        delta = {k: calls[k] - before[k] for k in calls}
        puts = port_window.pv_puts.read() - puts0
        win.fence()
        win.free()
        return (ok if comm.rank == 0 else None), delta, puts

    krn = with_knob("osc_device_dma", "0", lambda: port_dev(2, fn))
    dma = port_dev(2, fn)
    assert krn[0][0] and dma[0][0]
    assert krn[0][1] == {"rma_copy": 2, "rma_acc": 1, "rma_cas": 1}
    assert dma[0][1] == {"rma_copy": 0, "rma_acc": 1, "rma_cas": 1}
    assert krn[0][2] == dma[0][2] == 1


def test_divergence_memory_is_a_tensor():
    """Pinned divergence: ``memory`` returns a copy of the live window
    on the rank's device, a tensor of the creation dtype and shape (the
    reference returns a host numpy copy); ``read_local`` a uint8
    tensor.  Window_create over a tensor copies it: the window does not
    alias the caller's tensor."""
    def fn(comm):
        mine = torch.arange(6, dtype=torch.int32).reshape(2, 3) \
            + 10 * comm.rank
        win = port_osc.create(comm, mine)
        win.fence()
        win.put(torch.full((2,), -1, dtype=torch.int32),
                (comm.rank + 1) % comm.size, disp=1)
        win.fence()
        mem = win.memory
        mem.fill_(99)  # a copy: the window is unchanged
        again = win.memory
        local = win.read_local(4, 8)
        out = (type(mem).__name__, mem.dtype, tuple(mem.shape),
               mem.device == comm.device, again.tolist(), mine.tolist(),
               local.dtype, local.view(torch.int32).tolist(),
               win.disp_unit)
        win.free()
        return out

    res = port_dev(3, fn)
    for r, (kind, dt, shape, on_dev, again, mine, ldt, local, du) in \
            enumerate(res):
        assert (kind, dt, shape, on_dev, ldt, du) == (
            "Tensor", torch.int32, (2, 3), True, torch.uint8, 4)
        assert again == [[10 * r, -1, -1], [10 * r + 3, 10 * r + 4,
                                            10 * r + 5]]
        assert mine == [[10 * r, 10 * r + 1, 10 * r + 2],
                        [10 * r + 3, 10 * r + 4, 10 * r + 5]]
        assert local == [-1, -1]


def test_refusals():
    """Out-of-range spans, bad targets, buffers on another device (a
    meta tensor stands in) and mismatched result dtypes raise."""
    def fn(comm):
        win = port_osc.allocate(comm, 32, disp_unit=4)
        raised = []
        for call in (
                lambda: win.put(np.zeros(2, np.int32), 0, disp=7),
                lambda: win.put(np.zeros(2, np.int32), 5),
                lambda: win.put(torch.zeros(2, device="meta"), 0),
                lambda: win.get(torch.zeros(2, device="meta"), 0),
                lambda: win.get_accumulate(np.zeros(2, np.int32),
                                           np.zeros(2, np.int64), 0),
                lambda: win.accumulate(np.zeros(2, np.float16), 0)):
            try:
                call()
                raised.append(None)
            except (ValueError, TypeError) as e:
                raised.append(type(e).__name__)
        win.fence()
        win.free()
        return raised

    assert port_dev(2, fn) == [["ValueError", "ValueError", "ValueError",
                                "ValueError", "TypeError",
                                "TypeError"]] * 2


def test_passive_counter_is_atomic_under_contention():
    """Every rank hammers rank 0's counter with fetch_and_op under no
    lock, in both lowerings: each ticket is handed out once (the table
    lock serialises the read-modify-writes)."""
    def fn(comm):
        win = port_osc.allocate(comm, 8, disp_unit=8)
        win.fence()
        tickets = []
        for _ in range(25):
            old = np.empty(1, np.int64)
            win.fetch_and_op(1, old, 0, op=port_op.SUM)
            tickets.append(int(old[0]))
        win.fence()
        total = int(host(win.memory).view(np.int64)[0])
        win.free()
        return tickets, total

    for res in (port_dev(6, fn), with_knob("osc_device_dma", "0",
                                           lambda: port_dev(6, fn))):
        assert res[0][1] == 150
        assert sorted(t for ts, _ in res for t in ts) == list(range(150))


@pytest.fixture
def cuda_device():
    """The first card, or a skip: decided when the test runs, never
    when the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the RMA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_side_stream_origin_arrives_whole(cuda_device):
    """Each rank writes its origin tensor on a side stream of its own
    behind a sleeping kernel, then puts it (both lowerings) and
    accumulates it: the window's stream waits for that write, so the
    bytes arrive whole; a card-tensor get_accumulate result is read on
    the caller's stream after the op."""
    def fn(comm):
        win = port_osc.allocate(comm, 4 << 20, disp_unit=4)
        win.fence()
        n = 1 << 20
        with torch.cuda.stream(torch.cuda.Stream(cuda_device)):
            x = torch.zeros(n, dtype=torch.float32, device=cuda_device)
            torch.cuda._sleep(1 << 22)
            x += comm.rank + 1
            win.put(x, (comm.rank + 1) % comm.size)
            win.fence()
            got = win.memory
            res = torch.empty(n, dtype=torch.float32, device=cuda_device)
            win.get_accumulate(x, res, (comm.rank + 1) % comm.size)
            ok_res = bool((res == comm.rank + 1).all())
            win.fence()
            ok = bool((got == (comm.rank - 1) % comm.size + 1).all())
        torch.cuda.synchronize()
        win.free()
        return ok, ok_res

    for knob in ("1", "0"):
        res = with_knob("osc_device_dma", knob, lambda: port_run_ranks(
            4, fn, device_map=logical_devices(cuda_device)))
        assert all(a and b for a, b in res), (knob, res)


@pytest.mark.gpu
def test_device_window_workloads_on_card(cuda_device):
    """The promoted workloads on logical devices of the card, tensor
    origins, both lowerings: the port pt2pt window's bytes."""
    for wl in (lambda o, p, b: counter_workload(o, p, b),
               lambda o, p, b: halo_workload(o, b)):
        want = port_run_ranks(4, wl(port_osc, port_op, NUMPY))
        for knob in ("1", "0"):
            got = with_knob("osc_device_dma", knob, lambda: port_run_ranks(
                4, wl(port_osc, port_op, TENSORS),
                device_map=logical_devices(cuda_device)))
            for r in range(4):
                assert {k: v for k, v in got[r].items() if k != "component"} \
                    == {k: v for k, v in want[r].items()
                        if k != "component"}

"""On-device datatype packing (ompi_tpu_torch/datatype/device.py, K4
index_gather and K5 index_scatter) against the reference's
datatype/device.py and the host convertor: vector, indexed and
contiguous types; the refusal of mixed structs; and BASELINE config 5's
path at a small size — device_pack through a stride-2 vector, then
reduce_scatter MAX on the packed stream, then device_unpack into a
stride-2 receive layout.

The reference runs under jax on the CPU (config 5 on its coll/hbm,
every rank on one device); the port on torch.device("cpu"), where the
wrappers take their plain versions.

Tolerance: byte for byte everywhere (gathers, scatters and MAX are
exact).  float32 and int32 against the reference, which keeps x64 off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ompi_tpu.datatype import device as ref_dev
from ompi_tpu.datatype import engine as ref_dt
from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import convert
from ompi_tpu_torch.datatype import convertor as port_cv
from ompi_tpu_torch.datatype import device as port_dev
from ompi_tpu_torch.datatype import engine as port_dt
from ompi_tpu_torch.kernels import index
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import run_ranks as port_run_ranks

CPU = torch.device("cpu")


def _t(a):
    return convert.to_torch(np.asarray(a), CPU)


def _types(dt):
    """(name, port type, reference type, count, buffer elements): the
    vector, indexed and contiguous shapes of test_datatype.py, and a
    vector with a count above one."""
    P, R = port_dt, ref_dt
    base_p = P.FLOAT if dt == np.float32 else P.INT
    base_r = R.FLOAT if dt == np.float32 else R.INT
    return [
        ("vector", P.vector(5, 2, 3, base_p).commit(),
         R.vector(5, 2, 3, base_r).commit(), 2, 40),
        ("indexed", P.indexed([2, 3], [7, 0], base_p).commit(),
         R.indexed([2, 3], [7, 0], base_r).commit(), 1, 16),
        ("contiguous", P.contiguous(6, base_p).commit(),
         R.contiguous(6, base_r).commit(), 3, 20),
        ("vector_stride2", P.vector(64, 1, 2, base_p).commit(),
         R.vector(64, 1, 2, base_r).commit(), 1, 128),
    ]


@pytest.mark.parametrize("dt", [np.float32, np.int32],
                         ids=["float32", "int32"])
def test_device_pack_matches_reference_and_convertor(dt):
    rng = np.random.default_rng(17)
    for name, pt, rt, count, nbuf in _types(dt):
        buf = (rng.standard_normal(nbuf) * 100).astype(dt)
        assert port_dev.is_device_packable(pt, count)
        host = np.frombuffer(port_cv.pack(pt, count, buf), dtype=dt)
        ref = np.asarray(ref_dev.device_pack(rt, count, jnp.asarray(buf)))
        got = convert.to_numpy(port_dev.device_pack(pt, count, _t(buf)))
        assert got.dtype == dt
        assert got.tobytes() == ref.tobytes() == host.tobytes(), name
        assert np.array_equal(port_dev.element_indices(pt, count),
                              ref_dev.element_indices(rt, count))


@pytest.mark.parametrize("dt", [np.float32, np.int32],
                         ids=["float32", "int32"])
def test_device_unpack_matches_reference_and_convertor(dt):
    """The scatter lands where the reference's and the convertor's
    unpack put the elements; every other element keeps its value."""
    rng = np.random.default_rng(18)
    for name, pt, rt, count, nbuf in _types(dt):
        packed = (rng.standard_normal(
            port_dev.element_indices(pt, count).size) * 100).astype(dt)
        fill = np.full(nbuf, 7, dt)
        ref = np.asarray(ref_dev.device_unpack(
            rt, count, jnp.asarray(packed), jnp.asarray(fill)))
        host = fill.copy()
        port_cv.unpack(pt, count, host, packed.tobytes())
        out = _t(fill)
        got = port_dev.device_unpack(pt, count, _t(packed), out)
        assert got is out
        assert convert.to_numpy(out).tobytes() == ref.tobytes() \
            == host.tobytes(), name


def test_divergence_unpack_writes_in_place():
    """The one intended divergence, pinned: MPI unpack writes the
    receive buffer, so the port's device_unpack writes ``out`` in
    place and returns it; the reference (immutable jax arrays)
    returns a new array and leaves its ``out`` argument as it was."""
    vp = port_dt.vector(3, 1, 2, port_dt.INT).commit()
    vr = ref_dt.vector(3, 1, 2, ref_dt.INT).commit()
    packed = np.array([1, 2, 3], np.int32)
    r_out = jnp.zeros(6, jnp.int32)
    r_res = ref_dev.device_unpack(vr, 1, jnp.asarray(packed), r_out)
    assert np.asarray(r_out).tolist() == [0] * 6
    p_out = torch.zeros(6, dtype=torch.int32)
    p_res = port_dev.device_unpack(vp, 1, _t(packed), p_out)
    assert p_res is p_out
    assert p_out.tolist() == np.asarray(r_res).tolist() \
        == [1, 0, 2, 0, 3, 0]


def test_device_pack_rejects_mixed_structs_and_bad_buffers():
    st = port_dt.struct([1, 1], [0, 8], [port_dt.INT, port_dt.DOUBLE]
                        ).commit()
    st_r = ref_dt.struct([1, 1], [0, 8], [ref_dt.INT, ref_dt.DOUBLE]
                         ).commit()
    assert not port_dev.is_device_packable(st, 1)
    assert not ref_dev.is_device_packable(st_r, 1)
    with pytest.raises(ValueError, match="not device-packable"):
        port_dev.device_pack(st, 1, torch.zeros(4, dtype=torch.int32))
    vec = port_dt.vector(5, 2, 3, port_dt.FLOAT).commit()
    with pytest.raises(ValueError, match="does not match"):
        port_dev.device_pack(vec, 1, torch.zeros(40, dtype=torch.int32))
    with pytest.raises(IndexError, match="outside"):
        port_dev.device_pack(vec, 1, torch.zeros(12))  # span is 14
    with pytest.raises(ValueError, match="contiguous"):
        port_dev.device_unpack(vec, 1, torch.zeros(10),
                               torch.zeros(14, 2)[:, 0])


def test_index_wrappers_check_before_they_launch():
    iv = index.IndexVector(np.array([0, 5, 2]), CPU)
    assert (iv.n, iv.lo, iv.hi) == (3, 0, 5)
    src = torch.arange(6, dtype=torch.int16)
    assert index.index_gather(src, iv).tolist() == [0, 5, 2]
    with pytest.raises(IndexError):
        index.index_gather(torch.arange(5), iv)
    with pytest.raises(IndexError):
        index.index_gather(src, index.IndexVector(np.array([-1]), CPU))
    with pytest.raises(ValueError, match="packed"):
        index.index_scatter(torch.zeros(2, dtype=torch.int16), iv,
                            torch.zeros(6, dtype=torch.int16))
    with pytest.raises(ValueError, match="dtype"):
        index.index_scatter(torch.zeros(3), iv,
                            torch.zeros(6, dtype=torch.int16))
    with pytest.raises(ValueError, match="contiguous"):
        index.index_gather(torch.zeros(12)[::2], iv)
    before = (index.index_gather.launches.value,
              index.index_scatter.launches.value)
    out = index.index_scatter(torch.tensor([9, 8, 7], dtype=torch.int16),
                              iv, torch.zeros(6, dtype=torch.int16))
    assert out.tolist() == [9, 0, 7, 0, 0, 8]
    assert (index.index_gather.launches.value,
            index.index_scatter.launches.value) == before


def _config5(comm, put, op, pack, unpack, dtmod, n):
    """BASELINE config 5 at a small size: n blocks of 1 element,
    stride 2 (the packed stream is the even elements), then
    reduce_scatter MAX, then the result unpacked into a stride-2
    receive layout."""
    r = comm.rank
    base = dtmod.FLOAT
    vec = dtmod.vector(n, 1, 2, base).commit()
    raw = np.stack([np.arange(n, dtype=np.float32) % 13 + r,
                    np.full(n, -1.0, np.float32)], axis=1).reshape(-1)
    packed = pack(vec, 1, put(raw))
    res = comm.reduce_scatter_arr(packed, op.MAX)
    m = n // comm.size
    rvec = dtmod.vector(m, 1, 2, base).commit()
    recv = put(np.full(2 * m, -5.0, np.float32))
    got = unpack(rvec, 1, res, recv)
    return np.asarray(convert.to_numpy(got) if isinstance(got, torch.Tensor)
                      else got).tobytes()


def test_config5_pack_reduce_scatter_unpack_matches_reference():
    n, size = 96, 4

    def port_fn(comm):
        return _config5(comm, lambda a: convert.to_torch(a, comm.device),
                        port_op, port_dev.device_pack,
                        port_dev.device_unpack, port_dt, n)

    def ref_fn(comm):
        return _config5(comm, lambda a: jax.device_put(a, comm.device),
                        ref_op, ref_dev.device_pack, ref_dev.device_unpack,
                        ref_dt, n)

    port = port_run_ranks(size, port_fn, device_map=lambda r: CPU)
    ref = ref_run_ranks(size, ref_fn, device_map=lambda r: jax.devices()[0])
    assert port == ref
    m = n // size
    for r, b in enumerate(port):
        got = np.frombuffer(b, np.float32)
        want = np.full(2 * m, -5.0, np.float32)
        want[0::2] = np.arange(r * m, (r + 1) * m) % 13 + size - 1
        assert np.array_equal(got, want)


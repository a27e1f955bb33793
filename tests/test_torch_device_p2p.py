"""Device p2p (btl/tpu, the thread-world half) through both packages:
the thread-world cases of tests/test_device_p2p.py run as the same
rank program through the reference (``run_ranks(devices=True)`` on the
conftest's virtual CPU devices) and through the port, once with one
rank a logical CPU device (``logical_devices("cpu")``) and once with
every rank co-located on the CPU.  Results are equal byte for byte.

The port's own guarantees, which the reference's immutable arrays give
for free, are held here too: the receiver always gets a copy of its own
(a sender that writes into its tensor right after ``send_arr`` does not
change what arrives), and a peer outside the process gets host bytes
staged through pinned memory only: where a card's stage cannot be
pinned the send raises instead of bouncing through pageable memory
(the process cases themselves are in test_torch_device_p2p_procs.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import convert
from ompi_tpu_torch.btl.tpu import DeviceArrayPayload
from ompi_tpu_torch.testing import logical_devices
from ompi_tpu_torch.testing import run_ranks as port_run_ranks

CPU = torch.device("cpu")
PORT_MAPS = {"mesh": logical_devices("cpu"), "hbm": lambda r: CPU}


def _np(x):
    if isinstance(x, torch.Tensor):
        return convert.to_numpy(x)
    return np.asarray(x)


def _ref(n, fn):
    return ref_run_ranks(
        n, lambda c: fn(c, lambda a: jax.device_put(jnp.asarray(a),
                                                    c.device)),
        devices=True)


def _port(n, fn, tier):
    return port_run_ranks(
        n, lambda c: fn(c, lambda a: convert.to_torch(np.asarray(a),
                                                      c.device)),
        device_map=PORT_MAPS[tier])


def _same(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        if isinstance(r, tuple):
            _same(list(p), list(r))
        elif r is None or isinstance(r, (bool, int, float)):
            assert p == r
        else:
            p, r = _np(p), _np(r)
            assert p.dtype == r.dtype and p.shape == r.shape
            assert p.tobytes() == r.tobytes()


def _roundtrip(comm, put):
    x = put(np.full((64,), float(comm.rank + 1), np.float32))
    nxt = (comm.rank + 1) % comm.size
    prv = (comm.rank - 1) % comm.size
    got = comm.sendrecv_arr(x, nxt, prv, tag=4)
    # the result lives on MY device and carries the neighbour's value
    assert got.device == comm.state.device
    assert float(got[0]) == float(prv + 1)
    return _np(got)


def _lands_on_peer(comm, put):
    out = None
    if comm.rank == 0:
        comm.send_arr(put(np.arange(8, dtype=np.float32)), 1, tag=9)
    elif comm.rank == 1:
        # peek at the raw payload before recv_arr converts
        msg = comm.state.pml.recv_obj(0, 9, comm)
        payload = msg.payload
        assert type(payload).__name__ == "DeviceArrayPayload"
        arr = payload.arr
        assert arr.device == comm.state.device  # placed by the sender
        out = _np(arr)
        assert float(out[3]) == 3.0
    comm.Barrier()
    return out


def _interleaved(comm, put):
    got = []
    if comm.rank == 0:
        comm.Send(np.array([7], np.int64), 1, tag=1)
        comm.send_arr(put(np.ones(4, np.float32)), 1, tag=1)
        comm.Send(np.array([8], np.int64), 1, tag=1)
    else:
        y = np.empty(1, np.int64)
        comm.Recv(y, 0, tag=1)
        got.append(y.copy())
        got.append(_np(comm.recv_arr(0, tag=1)))
        comm.Recv(y, 0, tag=1)
        got.append(y.copy())
        assert [int(got[0][0]), float(got[1][0]), int(got[2][0])] == \
            [7, 1.0, 8]
    comm.Barrier()
    return tuple(got)


def _halo(comm, put):
    cart = comm.Create_cart([2, 2], periods=[True, True])
    left, right = cart.Shift(1, 1)
    tile = put(np.full((4,), float(cart.rank), np.float32))
    halo = cart.sendrecv_arr(tile, right, left, tag=2)
    assert float(halo[0]) == float(left)
    return (left, right, _np(halo))


CASES = {"roundtrip": (4, _roundtrip), "lands_on_peer": (2, _lands_on_peer),
         "interleaved": (2, _interleaved), "halo": (4, _halo)}


@pytest.mark.parametrize("tier", sorted(PORT_MAPS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_thread_world_case_matches_reference(case, tier):
    n, fn = CASES[case]
    _same(_port(n, fn, tier), _ref(n, fn))


def test_payload_is_the_ports_own_class():
    def fn(comm):
        if comm.rank == 0:
            comm.send_arr(torch.arange(4.0), 1, tag=3)
            return None
        msg = comm.state.pml.recv_obj(0, 3, comm)
        assert isinstance(msg.payload, DeviceArrayPayload)
        assert len(msg.payload) == 16 and msg.payload.event is None
        return _np(msg.payload.arr)

    for tier in PORT_MAPS:
        res = port_run_ranks(2, fn, device_map=PORT_MAPS[tier])
        assert res[1].tolist() == [0.0, 1.0, 2.0, 3.0]


@pytest.mark.parametrize("tier", sorted(PORT_MAPS) + ["host"])
def test_reuse_after_send_does_not_reach_the_receiver(tier):
    """The sender writes into its buffer right after send_arr: the
    receiver still gets the bytes of the send (the port always hands
    over a copy; a torch tensor is mutable, unlike a jax array)."""
    def fn(comm):
        if comm.rank == 0:
            x = torch.arange(16, dtype=torch.int32) if tier != "host" \
                else np.arange(16, dtype=np.int32)
            comm.send_arr(x, 1, tag=5)
            x[:] = -1
            comm.send_arr(x, 1, tag=5)
            return None
        first = _np(comm.recv_arr(0, tag=5))
        second = _np(comm.recv_arr(0, tag=5))
        return first.tolist(), second.tolist()

    dm = PORT_MAPS.get(tier)
    res = port_run_ranks(2, fn, device_map=dm)
    assert res[1] == (list(range(16)), [-1] * 16)


def test_send_to_a_peer_outside_the_process_raises():
    """A peer that is not a thread of this process (rank 1 made to look
    remote to rank 0, and the payload pickled as btl/shm and btl/tcp do
    on the wire): a tensor's payload crosses as host bytes and arrives
    as the receiver's own copy on its device; a card tensor (a meta
    tensor standing in for one: no pinned allocator here) raises at the
    send instead of bouncing through pageable memory."""
    import pickle

    def fn(comm):
        comm.Barrier()
        msg = None
        pml = comm.state.pml
        if comm.rank == 0:
            world = comm.state.rte.world
            world.is_local = lambda r: r == 0
            wire = pml.isend_obj
            pml.isend_obj = lambda obj, dst, tag, c: wire(
                pickle.loads(pickle.dumps(obj)), dst, tag, c)
            try:
                x = torch.arange(4.0)
                comm.send_arr(x, 1, tag=6)
                x.fill_(-1.0)
                try:
                    comm.send_arr(torch.ones(4, device="meta"), 1, tag=7)
                except RuntimeError as e:
                    msg = str(e)
            finally:
                del world.is_local
                del pml.isend_obj
        got = comm.recv_arr(0, tag=6) if comm.rank == 1 else None
        comm.Barrier()
        return msg, None if got is None else (
            got.device.type, _np(got).tolist())

    res = port_run_ranks(2, fn, device_map=logical_devices("cpu"))
    assert res[0][0] is not None and "pin" in res[0][0].lower(), res[0]
    assert res[1][1] == ("cpu", [0.0, 1.0, 2.0, 3.0])


def test_proc_null_ends_are_no_ops():
    """PROC_NULL ends (cart.Shift edges) are no-ops: nothing is sent,
    a receive gives None, and sendrecv_arr still receives its source's
    message."""
    def fn(comm):
        from ompi_tpu_torch.pml.request import PROC_NULL
        comm.send_arr(torch.full((2,), 3.0), comm.rank, tag=1)
        got = comm.sendrecv_arr(torch.ones(2), PROC_NULL, comm.rank, tag=1)
        return comm.recv_arr(PROC_NULL), _np(got).tolist()

    res = port_run_ranks(2, fn, device_map=logical_devices("cpu"))
    assert res == [(None, [3.0, 3.0])] * 2


def test_poll_obj_any_pops_a_buffered_object_message():
    """The object channel's non-blocking poll (the hook of the
    cross-process pull protocol): it takes an object message of the
    tag from any communicator's unexpected queue, never a byte one."""
    def fn(comm):
        if comm.rank == 0:
            comm.Send(np.array([5], np.int64), 1, tag=7)
            comm.send_arr(torch.arange(3), 1, tag=7)
        comm.Barrier()
        if comm.rank == 0:
            return None
        pml = comm.state.pml
        assert pml.poll_obj_any(8) is None
        m = pml.poll_obj_any(7)
        assert pml.poll_obj_any(7) is None
        y = np.empty(1, np.int64)
        comm.Recv(y, 0, tag=7)
        return _np(m.payload.arr).tolist(), int(y[0])

    assert port_run_ranks(2, fn)[1] == ([0, 1, 2], 5)

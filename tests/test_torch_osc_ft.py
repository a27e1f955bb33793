"""The port's one-sided windows across a rank's death (the ULFM epoch
hygiene of tests/test_osc_device.py's "epoch hygiene (ULFM)" cases),
through the port with the reference beside it.

The port's device window runs one rank a logical device of the CPU
(``logical_devices("cpu")``: CPU shards, the RMA kernels' plain
versions); the reference's on the conftest's virtual CPU devices.
Tolerance: bytes — the counter workload's ring, counter and election
results compare exactly.  Kills are ``kill_now``, after a
``comm.agree(True)``: a sync point that cannot half-complete (a victim
leaving a p2p barrier early could strand a survivor inside it, which
is ULFM's semantics but not what these cases test); survivors wait for
the failure record by polling.

The reference's shrink also evicts its compiled RMA kernels of the old
mesh; the port has none to evict (test_torch_ulfm.py's
``test_divergence_no_compiled_program_cache``): here the shrink is held
to dropping the window shard tables of the dead comm and its osc
component pick.
"""

import time

import numpy as np
import pytest

from ompi_tpu import osc as ref_osc
from ompi_tpu.op import op as ref_op
from ompi_tpu.osc import device as _ref_device  # noqa: F401 (knobs)
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import errhandler as eh
from ompi_tpu_torch import osc
from ompi_tpu_torch.ft import ulfm
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.osc import device as _port_device  # noqa: F401
from ompi_tpu_torch.testing import logical_devices, run_ranks
from ompi_tpu_torch.testing.rma import Buffers, counter_workload

FT = (eh.ERR_PROC_FAILED, eh.ERR_PROC_FAILED_PENDING, eh.ERR_REVOKED)
MESH = logical_devices("cpu")


def wait_failed(comm, grank, timeout=10.0):
    u = comm.state.ulfm
    deadline = time.monotonic() + timeout
    while True:
        u.poll()
        if grank in u.failed:
            return
        assert time.monotonic() < deadline, "failure never detected"
        time.sleep(0.001)


@pytest.mark.parametrize("dm", [None, MESH], ids=["pt2pt", "device"])
def test_fence_raises_after_peer_death(dm):
    """A fence on a window whose comm lost a rank raises, not hangs
    (host window and device window)."""
    def fn(comm):
        win = osc.allocate(comm, 64, name="chaos-fence")
        win.fence()
        comm.agree(True)
        if comm.rank == 0:
            ulfm.kill_now(comm.state)
        wait_failed(comm, 0)
        try:
            for _ in range(100):
                win.fence()
            return "no-raise"
        except eh.MPIException as e:
            assert e.code in FT, e.code
            win.abandon()
            return type(win).__name__

    r = run_ranks(4, fn, device_map=dm, allow_failures=True)
    want = "DeviceWindow" if dm else "Window"
    assert r[0] is None and all(x == want for x in r[1:]), r


@pytest.mark.parametrize("dm", [None, MESH], ids=["pt2pt", "device"])
def test_lock_raises_after_peer_death(dm):
    """A passive-target lock of a dead rank completes with
    ERR_PROC_FAILED instead of spinning forever."""
    def fn(comm):
        win = osc.allocate(comm, 64, name="chaos-lock")
        win.fence()
        comm.agree(True)
        if comm.rank == 1:
            ulfm.kill_now(comm.state)
        wait_failed(comm, 1)
        try:
            for _ in range(100):
                win.lock(1, osc.LOCK_EXCLUSIVE)
                win.put(np.zeros(4, dtype=np.uint8), 1)
                win.unlock(1)
            return "no-raise"
        except eh.MPIException as e:
            assert e.code in FT, e.code
            win.abandon()
            return "raised"

    r = run_ranks(3, fn, device_map=dm, allow_failures=True)
    assert r[1] is None and r[0] == r[2] == "raised", r


def test_reply_wait_raises_when_the_target_dies():
    """An origin parked on a fetch reply from a target that dies gets
    ERR_PROC_FAILED out of the window's reply wait (the pml drains the
    reply receive with an error status)."""
    def fn(comm):
        win = osc.allocate(comm, 64, name="reply")
        win.fence()
        comm.agree(True)
        if comm.rank == 1:
            ulfm.kill_now(comm.state)  # dies without serving anything
        res = np.zeros(1, dtype=np.int64)
        win.lock(0, osc.LOCK_SHARED)
        win.unlock(0)
        with pytest.raises(eh.MPIException) as ei:
            win.lock(1, osc.LOCK_SHARED)
            win.fetch_and_op(np.int64(1), res, 1, op=port_op.SUM)
            win.unlock(1)
        win.abandon()
        return ei.value.code

    r = run_ranks(2, fn, allow_failures=True)
    assert r[1] is None and r[0] in FT, r


def test_shrink_purges_window_tables_and_selection():
    """ULFM shrink re-decides osc selection (``_osc_pick``) and purges
    the device window shard tables of the old comm from the world
    table — in both packages."""
    def fn(comm, pkg):
        mod = osc if pkg == "port" else ref_osc
        u = ulfm if pkg == "port" else __import__(
            "ompi_tpu.ft.ulfm", fromlist=["x"])
        win = mod.allocate(comm, 256, name="purge")
        win.fence()
        win.put(np.arange(8, dtype=np.uint8), (comm.rank + 1) % comm.size)
        win.fence()
        world = comm.state.rte.world

        def tables():
            with world.shared_lock:
                return sum(1 for k in world.shared
                           if isinstance(k, tuple) and k
                           and k[0] == "osc_devwin" and k[1] == comm.cid)
        before = tables()
        comm.agree(True)
        if comm.rank == 0:
            u.kill_now(comm.state)
        wait_failed(comm, 0)
        comm.shrink()
        return (before, "_osc_pick" not in comm.__dict__, tables())

    port = run_ranks(4, lambda c: fn(c, "port"), device_map=MESH,
                     allow_failures=True)
    ref = ref_run_ranks(4, lambda c: fn(c, "ref"), devices=True,
                        allow_failures=True)
    assert port[1:] == ref[1:] == [(1, True, 0)] * 3, (port, ref)


def test_counter_byte_identity_across_shrink():
    """Survivors shrink after a death and the counter workload on the
    shrunk device comm is byte-identical to a fresh 3-rank world's, in
    the port and in the reference."""
    wl = counter_workload(osc, port_op, Buffers(False))

    def chaos(comm):
        comm.agree(True)
        if comm.rank == 0:
            ulfm.kill_now(comm.state)
        work = comm
        while work is comm:
            try:
                work.Barrier()
            except eh.MPIException as e:
                assert e.code in FT, e.code
                work = work.shrink(name="survivors")
        return wl(work)

    got = run_ranks(4, chaos, device_map=MESH, allow_failures=True)
    fresh = run_ranks(3, wl, device_map=MESH)
    ref = ref_run_ranks(3, counter_workload(ref_osc, ref_op,
                                            Buffers(False)), devices=True)
    assert got[0] is None
    for i in range(1, 4):
        assert got[i] == fresh[i - 1], i
        assert got[i]["component"] == "DeviceWindow"
        assert {k: v for k, v in got[i].items() if k != "component"} == \
            {k: v for k, v in ref[i - 1].items() if k != "component"}, i

"""pml/vprotocol pessimist through the port (ompi_tpu_torch/pml/
vprotocol.py with ob1's VACK / MSEG frames and replay wants, and
``cr.checkpoint_local`` / ``restore_local``), with the reference beside
it.

The analogs of tests/test_vprotocol.py's seven tests: the in-process
ones run through both packages (ids ``port`` and ``ref``) on the same
numpy payloads; the two process jobs run the port's programs
(``ompi_tpu_torch/examples/vproto_prog.py`` and ``vproto_big_prog.py``,
the reference's ``tests/_vproto_prog.py`` and ``_vproto_big_prog.py``)
through the port's mpirun, the restart job also with a 5 MiB tensor
past ``btl_tpu_chunk_bytes`` (the chunked pull, whose parked snapshot
the uncoordinated checkpoint holds), held to plain torch's digest.

The port's own cases: the sender log's snapshot of a ``send_arr``
payload (the receiver's copy is never referenced by the log; a replay
hands the receiver a fresh copy on its device — a tensor, never a
numpy array, never an alias of the log; numpy for a rank with no
device; a dtype numpy lacks), and ULFM's sweep reaching ob1 through
both interposers.  The card's snapshot (a pinned stage filled by a
queued D2H) is tests/test_torch_vprotocol_card.py.
"""

import hashlib
import os
import types

import numpy as np
import pytest
import torch

from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.pml import vprotocol
from ompi_tpu_torch.testing import mpirun_run, run_ranks

SEED = 20261018
CPU = torch.device("cpu")
VPROTO = os.path.join("ompi_tpu_torch", "examples", "vproto_prog.py")
VBIG = os.path.join("ompi_tpu_torch", "examples", "vproto_big_prog.py")
MCA = (("pml_vprotocol", "pessimist"),)


def _pkg(name):
    if name == "port":
        from ompi_tpu_torch import cr
        from ompi_tpu_torch.op import op
        from ompi_tpu_torch.pml.vprotocol import find
        from ompi_tpu_torch.testing import run_ranks as rr
    else:
        from ompi_tpu import cr
        from ompi_tpu.op import op
        from ompi_tpu.pml.vprotocol import find
        from ompi_tpu.testing import run_ranks as rr
    return types.SimpleNamespace(name=name, cr=cr, op=op, find=find,
                                 run_ranks=rr)


def _set(name, value):
    registry.set(name, value)
    ref_registry.set(name, value)


@pytest.fixture
def pessimist():
    _set("pml_vprotocol", "pessimist")
    yield
    _set("pml_vprotocol", "")


@pytest.fixture(params=["port", "ref"])
def pkg(request, pessimist):
    return _pkg(request.param)


def test_log_and_replay_redelivers_in_flight(pkg):
    """The core protocol, in-process: a message consumed into the
    unexpected queue at the cut is dropped from the snapshot and
    exactly redelivered by the sender-log replay."""
    pay = np.random.default_rng(SEED).standard_normal(4)

    def fn(comm):
        v = pkg.find(comm.state.pml)
        assert v is not None
        base = v._base
        if comm.rank == 0:
            comm.Send(pay, dest=1, tag=7)
            comm.Barrier()
            # peer simulated restart: replay everything logged
            comm.Barrier()
            v.replay()
            comm.Barrier()
            return True
        # rank 1: let the message land in the unexpected queue
        while not base._unexpected.get(comm.cid):
            comm.state.progress.progress()
        comm.Barrier()
        want = base.cr_capture_lenient()
        assert len(want) >= 1
        # simulate the restart cut: drop the unconsumed message, keep
        # the counters, arm replay_want
        vlog = v.cr_capture_vlog()
        base._unexpected[comm.cid].clear()
        v.cr_restore_vlog(vlog)
        base._replay_want = {tuple(w) for w in want}
        comm.Barrier()  # sender replays now
        got = np.empty(4)
        comm.Recv(got, source=0, tag=7)
        assert not base._replay_want
        comm.Barrier()
        return got

    got = pkg.run_ranks(2, fn)[1]
    np.testing.assert_array_equal(got, pay)


def test_duplicate_replay_is_dropped(pkg):
    """Replaying the whole log twice must deliver once: consumed
    sequence numbers are dropped, not re-matched."""
    def fn(comm):
        v = pkg.find(comm.state.pml)
        if comm.rank == 0:
            comm.Send(np.full(2, 5.0), dest=1, tag=3)
            comm.Barrier()
            v.replay()   # gratuitous full replay
            v.replay()
            comm.Barrier()
        else:
            got = np.empty(2)
            comm.Recv(got, source=0, tag=3)
            comm.Barrier()
            comm.Barrier()
            # the replays must not create matchable duplicates
            comm.state.progress.progress()
            assert comm.Iprobe(source=0, tag=3) in (False, None), \
                "duplicate redelivery"
        return True

    assert all(pkg.run_ranks(2, fn))


def test_replay_segments_large_payloads(pkg):
    """A logged payload larger than the btl's eager limit replays as
    MSEG segments (8 MiB > inproc's 4 MiB max_send_size) and is
    reassembled and redelivered exactly."""
    N = 1024 * 1024
    data = np.random.default_rng(SEED).standard_normal(N)

    def fn(comm):
        v = pkg.find(comm.state.pml)
        base = v._base
        if comm.rank == 0:
            # Isend: the RNDV is never ACKed (rank 1 drops it to
            # simulate the restart cut), so the request is abandoned
            # like a real restart abandons the pre-crash pml
            comm.Isend(data, dest=1, tag=9)
            comm.Barrier()
            comm.Barrier()
            v.replay()
            comm.Barrier()
            return True
        while not base._unexpected.get(comm.cid):
            comm.state.progress.progress()
        comm.Barrier()
        want = base.cr_capture_lenient()
        base._unexpected[comm.cid].clear()
        base._replay_want = {tuple(w) for w in want}
        comm.Barrier()  # sender replays now
        got = np.empty(N)
        comm.Recv(got, source=0, tag=9)
        assert not base._mseg, "leaked partial reassembly"
        comm.Barrier()
        return got

    np.testing.assert_array_equal(pkg.run_ranks(2, fn)[1], data)


def test_replay_larger_than_shm_ring():
    """mpirun process ranks over the shm btl: replay of a 12 MiB
    payload (more than the 8 MiB ring) rides MSEG segments, and the
    assembled duplicate is dropped."""
    r = mpirun_run(2, VBIG, mca=MCA, timeout=150, job_timeout=120)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert b"vproto big ok" in r.stdout, \
        r.stdout.decode()[-1000:] + r.stderr.decode()[-2000:]


def test_coordinated_checkpoint_gc_clears_log(pkg, tmp_path):
    """The coordinated checkpoint clears the log at its quiesce point:
    every user message logged before it is gone.  The checkpoint's own
    collectives past that point (its sequence Bcast and Barriers) meet
    in coll/sm in both packages' thread worlds, so the log is empty."""
    def fn(comm):
        v = pkg.find(comm.state.pml)
        x = np.full(4, comm.rank + 1.0)
        r = np.empty(4)
        comm.Allreduce(x, r, pkg.op.SUM)
        comm.Send(x, dest=1 - comm.rank, tag=2)
        comm.Recv(r, source=1 - comm.rank, tag=2)
        assert v.log_bytes >= 32 and v.log
        pkg.cr.checkpoint(comm, {"x": 1}, store_dir=str(tmp_path))
        left = [e for es in v.log.values() for e in es]
        assert all(e[1] < 0 for e in left), left
        assert v.log_bytes == sum(len(e[4]) for e in left) <= 8
        return len(left)

    assert pkg.run_ranks(2, fn) == [0, 0]


def test_receiver_ack_gc_log_plateaus(pkg, tmp_path):
    """Soak: stream 3x the sender-log cap with periodic LOCAL
    snapshots on the receiver.  Receiver acks (snapshot-durable
    watermarks) trim the sender log in steady state: no MemoryError,
    and the log plateaus under the cap."""
    import time as _time

    _set("vprotocol_pessimist_log_max_mb", "2")
    _set("vprotocol_pessimist_ack_interval_s", "0.02")
    store = str(tmp_path / "store")
    CHUNK = 16384       # 128 KiB float64
    TOTAL = 48          # 6 MB in all > the 2 MB cap
    try:
        def fn(comm):
            v = pkg.find(comm.state.pml)
            data = np.zeros(CHUNK, np.float64)
            if comm.rank == 0:
                peak = 0
                for _ in range(TOTAL):
                    # flow control: wait for receiver acks to trim the
                    # log before exceeding ~75% of the cap — without
                    # GC this wait never resolves
                    deadline = _time.monotonic() + 60
                    while v.log_bytes + data.nbytes > (3 << 19):
                        comm.state.progress.progress()
                        _time.sleep(0.002)
                        assert _time.monotonic() < deadline, \
                            "sender log never trimmed (GC dead)"
                    comm.Send(data, dest=1, tag=5)
                    peak = max(peak, v.log_bytes)
                comm.Barrier()
                assert peak <= (2 << 20), f"log exceeded cap: {peak}"
                return peak
            buf = np.empty(CHUNK)
            for i in range(TOTAL):
                comm.Recv(buf, source=0, tag=5)
                if i % 4 == 3:
                    pkg.cr.checkpoint_local(comm, {"i": i},
                                            store_dir=store)
            comm.Barrier()
            return 0

        assert pkg.run_ranks(2, fn)[0] > 0  # traffic flowed via the log
    finally:
        _set("vprotocol_pessimist_log_max_mb", "256")
        _set("vprotocol_pessimist_ack_interval_s", "0.25")


def _card_sha(mib: int) -> str:
    """vproto_prog.py's ``card_values`` of ``mib`` MiB, by plain torch."""
    i = torch.arange(mib * (1 << 18), dtype=torch.int64)
    t = ((i * 2654435761) % 1000003).to(torch.float32)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def test_uncoordinated_checkpoint_restart_e2e(tmp_path):
    """mpirun e2e: snapshot with messages IN FLIGHT (no quiesce) — the
    reference's 8 doubles and a 5 MiB tensor through the chunked pull
    — crash, restart: the sender log replays them and the job
    completes, the tensor's digest plain torch's."""
    store = str(tmp_path / "store")
    args = ("--device", "cpu", "--mib", "5")
    env = {**os.environ, "VPROTO_CRASH": "1"}
    r1 = mpirun_run(2, VPROTO, *args, mca=MCA, extra=("--ckpt-dir", store),
                    timeout=150, job_timeout=120, env=env)
    assert r1.returncode != 0  # rank 1 died after its snapshot
    assert b"vproto ok" not in r1.stdout
    r2 = mpirun_run(2, VPROTO, *args, mca=MCA, extra=("--restart", store),
                    timeout=150, job_timeout=120)
    assert r2.returncode == 0, r2.stderr.decode()[-2000:]
    out = r2.stdout.decode()
    assert "vproto ok" in out
    assert f"CARD {_card_sha(5)}" in out, out


# ---- the port's own: device payloads in the sender log ---------------

def _cut_and_replay(comm, v, tag):
    """Rank 1's half of the simulated cut (see the first test): the
    unconsumed message of ``tag`` is dropped and wanted back from the
    replay (only it: a peer's early Barrier message stays queued)."""
    base = v._base

    def mine():
        return [m for m in base._unexpected.get(comm.cid, [])
                if m.tag == tag and m.src == 0]
    while not mine():
        comm.state.progress.progress()
    drop = mine()
    base._unexpected[comm.cid] = [m for m in base._unexpected[comm.cid]
                                  if m not in drop]
    base._replay_want = {(comm.cid, m.src, m.seq) for m in drop}
    comm.Barrier()  # rank 0 overwrites and replays now
    comm.Barrier()
    return comm.recv_arr(0, tag=tag)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int16,
                                   torch.bfloat16])
def test_send_arr_logged_snapshot_replays(pessimist, dtype):
    """A send_arr payload is logged as the log's own snapshot: rank 0
    overwrites its source tensor AND rank 1 would own the delivered
    copy; the replay still delivers the pre-overwrite bytes, as a
    tensor on rank 1's device that aliases nothing of the log.
    ``log_bytes`` counts the snapshot."""
    g = torch.Generator().manual_seed(SEED)
    src = torch.randint(-999, 999, (257, 3), generator=g).to(dtype)
    want = src.clone()

    def fn(comm):
        v = vprotocol.find(comm.state.pml)
        if comm.rank == 0:
            x = src.clone()
            before = v.log_bytes
            comm.send_arr(x, 1, tag=4)
            logged = v.log_bytes - before
            comm.Barrier()
            x.fill_(0)  # the sender writes on
            v.replay()
            comm.Barrier()
            return logged
        y = _cut_and_replay(comm, v, 4)
        same = torch.equal(y, want)
        y.fill_(7)  # the receiver owns its copy: the log must not see it
        entries = [e for es in v.log.values() for e in es]
        return (same, y.device, y.dtype, entries)

    logged, (same, where, dt, _) = run_ranks(
        2, fn, device_map=lambda r: CPU)
    assert same and where == CPU and dt == dtype
    assert logged == want.numel() * want.element_size()


def test_send_arr_replay_does_not_alias_log(pessimist):
    """Two replays of one logged tensor: the receiver writes into the
    first delivery, and the log's snapshot still holds the original
    bytes (each replay hands over a fresh copy)."""
    src = torch.arange(64, dtype=torch.float32)

    def fn(comm):
        v = vprotocol.find(comm.state.pml)
        if comm.rank == 0:
            comm.send_arr(src.clone(), 1, tag=6)
            comm.Barrier()
            v.replay()
            comm.Barrier()
            comm.Barrier()
            snap = [e[4] for es in v.log.values() for e in es
                    if e[3] == "obj"][0]
            return torch.from_numpy(snap.payload().copy())
        y = _cut_and_replay(comm, v, 6)
        y.fill_(-1)
        comm.Barrier()
        return None

    logged = run_ranks(2, fn, device_map=lambda r: CPU)[0]
    assert torch.equal(logged, src)


def test_send_arr_host_rank_replay_gets_numpy(pessimist):
    """A rank with no device: the log copies the numpy payload and the
    replay delivers a fresh numpy array."""
    src = np.random.default_rng(SEED).standard_normal(33)

    def fn(comm):
        v = vprotocol.find(comm.state.pml)
        if comm.rank == 0:
            x = src.copy()
            comm.send_arr(x, 1, tag=2)
            comm.Barrier()
            x[:] = 0
            v.replay()
            comm.Barrier()
            return None
        y = _cut_and_replay(comm, v, 2)
        return y

    y = run_ranks(2, fn)[1]
    assert isinstance(y, np.ndarray)
    np.testing.assert_array_equal(y, src)


def test_checkpoint_local_round_trip_restores_tensors(pessimist, tmp_path):
    """checkpoint_local / restore_local in a thread world: the payload's
    tensor comes back on the rank's device, the log and sequence maps
    with it; a restore without the restart flag is None."""
    from ompi_tpu_torch import cr
    store = str(tmp_path / "store")

    def snap(comm):
        t = torch.full((5,), float(comm.rank + 1))
        comm.send_arr(t, 1 - comm.rank, tag=1)
        got = comm.recv_arr(1 - comm.rank, tag=1)
        seq = cr.checkpoint_local(comm, {"t": t, "got": got},
                                  store_dir=store)
        assert cr.restore_local(comm, store_dir=store) is None
        return seq

    assert run_ranks(2, snap, device_map=lambda r: CPU) == [0, 0]
    os.environ[cr.ENV_RESTART] = "1"
    try:
        def back(comm):
            out = cr.restore_local(comm, store_dir=store)
            v = vprotocol.find(comm.state.pml)
            return (out["t"].tolist(), out["got"].tolist(),
                    str(out["t"].device), v.log_bytes)
        res = run_ranks(2, back, device_map=lambda r: CPU)
    finally:
        os.environ.pop(cr.ENV_RESTART, None)
    for r, (t, got, where, nbytes) in enumerate(res):
        assert t == [float(r + 1)] * 5 and got == [float(2 - r)] * 5
        assert where == "cpu" and nbytes >= 20


def test_ulfm_sweep_reaches_ob1_through_both_wrappers():
    """vprotocol over monitoring over ob1: the stack reference order;
    ULFM's sweep, the matrix and the log each reach their layer, and
    (as in the reference) the offload count sees only a monitoring
    layer on top, so a device collective counts nothing here."""
    from ompi_tpu_torch.op import op as port_op
    from ompi_tpu_torch.pml import monitoring
    from ompi_tpu_torch.pml.ob1 import PmlOb1
    _set("pml_monitoring_enable", True)
    _set("pml_vprotocol", "pessimist")
    try:
        def fn(comm):
            pml = comm.state.pml
            assert isinstance(pml, vprotocol.VprotocolPessimist)
            assert isinstance(pml._pml, monitoring.MonitoringPml)
            assert isinstance(pml._base, PmlOb1)
            assert pml.ulfm_sweep.__self__ is pml._base
            assert monitoring._find_monitor(comm.state) is pml._pml
            comm.Send(np.zeros(4), dest=1 - comm.rank, tag=1)
            comm.Recv(np.empty(4), source=1 - comm.rank, tag=1)
            comm.allreduce_arr(torch.ones(8), port_op.SUM)
            rows = pml.matrix_rows()
            return rows["sent_bytes"], rows["sent_filtered_bytes"], \
                pml.log_bytes
        res = run_ranks(2, fn, device_map=lambda r: CPU)
    finally:
        _set("pml_monitoring_enable", False)
        _set("pml_vprotocol", "")
    for r, (sent, filtered, logged) in enumerate(res):
        assert sent[1 - r] == 32 and filtered == [0, 0] and logged >= 32
